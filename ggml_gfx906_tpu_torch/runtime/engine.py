"""Continuous-batching serving engine — the port of ggml_gfx906_tpu/
runtime/engine.py::Engine.

ref: examples/gpt-2/main-batched.cpp — request batching with interleaved
admission (:407-430).

A fixed pool of B slots over a preallocated batched KV cache: dense, int8
(config kv_quant) or a paged pool (`paged_pages`, runtime/paged_kv.py).
Admission first tries a FLOOD (`_admit_batch`, reference :586-711): when no
chunked request is pending, at least 2 slots are free and at least 2
single-chunk prompts head the queue, up to one per free slot are prefilled
in ONE eager `forward_batch` at M = r·s_pad into a temp cache (r rows: the
n admitted prompts, raised with pad rows only as far as every product keeps
the route of the max_batch block, `_flood_rows`), their first tokens
sampled on the device, and row i installed into the live cache in place at
its slot (`batched_kv.absorb_temp`, or through the slot's page-table row).
Otherwise it prefills one request at a time in fixed-size chunks (each
padded to a bucket), interleaved with decode steps, so a long prompt never
stalls the active slots for more than one chunk; below half occupancy
several chunks run per step (ramp mode). Every decode step runs ONE batched
decode for all slots (inactive slots compute masked garbage) over the
smallest attention-window bucket that covers the longest active slot, with
the per-request seeded top-k/top-p sampling inside the step.

The decode loop is device-resident (reference :493-561, :843-1059). Decode
steps are CUDA graphs (runtime/graphs.py), captured once per (window
bucket, depth, flow) and replayed after that:
- `run` dispatches windows of `engine_harvest_depth` steps that chain on
  the device through the token vector and the cache lengths, and reads
  window k back only after window k+1 is dispatched (a copy into pinned
  memory behind an event, `graphs.HostCopy`); depth 1 is the per-step
  loop of `step`;
- when no admission can happen mid-window, a window is ONE replay of the
  graph of `depth` chained steps (`engine_scan_window`); on the paged pool
  that graph gathers the window into a dense view, runs the steps on it
  and scatters the window's rows back; under `engine_window_delta` its
  steps write their K/V rows into a per-window delta and attend the cache
  and the delta in plain torch (ops/attention.py::causal_attn_delta), and
  the window is absorbed once at its end, inside the same graph;
  otherwise each step is one replay of the one-step graph, after one
  admission chunk; steps dispatched past a request's end are discarded at
  harvest by the slot→rid snapshots;
- admission samples first tokens on the device (counter 0) and they are
  read back with the next harvest, a flood's as one vector: no host read
  at admission; a flood's per-slot vectors are built on the host and
  uploaded through pinned memory (utils/device.py);
- the per-slot state the graphs read (token vector, active mask, lengths,
  temperatures, top-k, top-p, Gumbel noise, the page table) lives in
  static device buffers written in place (`copy_`, `fill_`, pinned
  uploads) and never rebound;
- `abort.check()` is polled once per window (once per step in the
  per-step path); an abort mid-window harvests the dispatched steps, then
  raises.

Ported: flood and chunked admission (reference :569-788, the dense, paged
and quantized branches), the per-step and windowed pipelined `run`
(:493-561), scan windows with the paged gather (:938-1059), the
window-delta body (:242-267), the paged pool's page bookkeeping (:404-424,
:790-841), first tokens on the device (:32-41, :887-918), and the mesh
branches (:310-357, :372-437, :687-692, :962-980): `Engine(mesh=)` runs
the chunked prefill, the flood and the window bodies through
parallel/tp.py on this rank's heads and slots, with one paged pool group
per dp rank. Every rank of the mesh runs this host logic on the same
inputs, in lockstep, and sees every slot's tokens (all-gathered over dp).
There is no fallback: on the card a failed flood, absorb, collective,
capture or replay raises, and an exhausted pool raises the reference's
RuntimeError.

Streams: with engine_window_delta False they equal the reference engine's
at the same setting, at any depth, on every cache flavour (the delta
formulation changes bits: attention's reduction order and the bf16 delta).
A request's stream equals `generate`'s when both prefill it on one matmul
route: a flood's products take the routes of M = B·s_pad, so on files
with an int8 route (Q4_K, Q8_0, Q4_0 tensors) a flooded prompt shorter
than int8_min_m prefills on K3 / K5-i8 / K6-i8 where `generate` takes the
f32 kernel, as in the reference; the rows of both bodies are bit-equal
across M, so on one route the streams are equal.

Deliberate differences: the graphs belong to an Engine instance, because
they hold its KV buffers' addresses; the reference shares its jitted
programs across instances (its tests/test_engine.py:264-285). The port's
engine_window_delta defaults to False, the reference's to True: on the
H100 the delta window is slower than the strict one (168 against 141 ms a
depth-8 window of a 32-layer 7B-width model at attention window 256) and
changes every stream's bits. A flood runs eagerly, not as a captured
program. A flood computes the rows of the requests it admits
(`_flood_rows`), where the reference's `_prefill_batch` computes every
slot's row; a row's bits depend neither on the rows beside it nor on M
within one route, so the streams are the same (a mesh Engine keeps the
full block). On a gloo mesh the windows run uncaptured (a CUDA graph
cannot hold a gloo collective; chosen by the mesh's backend,
`graphs.captured`), on an NCCL mesh they are captured with the
collectives inside.

Sampling: token j of a request draws its Gumbel noise under the key
fold_in(PRNGKey(seed), j), bit for bit the reference's (runtime/sampling.py):
the first token at counter 0 on admission (reference :38), decode steps
from 1 on, each slot's counter set to 1 at install and raised by every
dispatched step (:706, :781, :883). A window's noise (depth, B, 64) is
built on the host once per window (`gumbel_noise`) and copied into its
graph's noise buffer; zeros when no slot samples. So a request samples the
same tokens alone or batched, at any depth, and the same tokens as in the
reference engine.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.cuda import dispatch
from ..utils import abort, config, trace
from ..utils.device import resolve, to_device, tree_device, upload
from .batched_kv import BatchedKVCache, WindowDelta, absorb_temp
from .graphs import GraphCache, HostCopy
from .paged_kv import PagedKVCache
from .sampling import gumbel_noise, sample_batch

MAX_K = 64


def _timing():
    return field(default=0, compare=False, repr=False)


@dataclass
class Request:
    """A request and, once served, its host timestamps (time.perf_counter_ns:
    submit, admission — the start of its flood or first chunk —, the harvest
    of its first token, finish) and how it was admitted ("flood" or
    "chunk"); the timings take no part in equality."""
    rid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    temp: float = 0.0            # 0 → greedy
    top_k: int = 40
    top_p: float = 0.9
    seed: int = 0
    out: list[int] = field(default_factory=list)
    done: bool = False
    t_submit: int = _timing()
    t_admit: int = _timing()
    t_first: int = _timing()
    t_finish: int = _timing()
    admitted_by: str | None = field(default=None, compare=False, repr=False)


def _trace_request(r: Request):
    """A finished request's lifetime into the span recorder: `request` and
    its three phases under it, all keyed by its rid."""
    sid = trace.record(trace.REQUEST, r.t_submit, r.t_finish, rid=r.rid)
    times = (r.t_submit, r.t_admit, r.t_first, r.t_finish)
    for name, a, b in zip(trace.REQUEST_PHASES, times, times[1:]):
        trace.record(name, a, b, parent=sid, rid=r.rid)


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


@dataclass
class _Pending:
    """A request whose prompt is being prefilled chunk by chunk."""
    req: Request
    kv: object                   # single-sequence KVCache being filled
    done_tokens: int = 0
    first: torch.Tensor | None = None   # its first token, once prefilled (install
    #                                     may wait for the paged pool)


class _Firsts:
    """First tokens sampled on the device at admission — a flood's (B,)
    vector or one request's — copied to the host once and read at the next
    harvest by every request they belong to (reference :73-96)."""

    def __init__(self, t: torch.Tensor):
        self._copy = HostCopy(t.reshape(-1))
        self._np = None

    def item(self, j: int) -> int:
        if self._np is None:
            self._np = self._copy.numpy()
        return int(self._np[j])


def decode_window(fb, kv, tok, active, noise, temps, top_ks, top_ps, window: int,
                  depth: int, flow: str = "scan", delta: WindowDelta | None = None,
                  slots: slice = slice(None), gather=None) -> torch.Tensor:
    """The body of the engine's decode programs: `depth` chained decode
    steps over the slots, each step decoding every slot, sampling, advancing
    the lengths by the active mask and feeding the sampled tokens back
    through `tok`; returns the (depth, B) token stack.

    fb(tokens (b, 1), kv, start, attn_window=, window_delta=) → (logits,
    kv or delta): the model's forward_batch with its cfg and params bound.
    tok, active, temps, top_ks, top_ps: the (B,) per-slot buffers, noise
    (depth, B, k) the steps' Gumbel draws. slots: the slots of those
    buffers that kv holds (a mesh rank's data-parallel share; all of them
    by default) and gather: their sampled tokens → all B (the
    data-parallel all-gather), so `tok` gets every slot's token.

    flow "step" runs on the cache as it is (the per-step path); "scan" and
    "delta" are scan windows: on the paged pool they run on the window
    gathered into a dense view and scatter its rows back at the end, and
    "delta" writes the steps' K/V rows into `delta` and absorbs it once
    (reference :235-278)."""
    def sample(i, logits):
        nxt = sample_batch(logits[:, 0, :], noise[i][slots], temps[slots], top_ks[slots],
                           top_ps[slots])
        if gather is not None:
            nxt = gather(nxt)
        tok.copy_(nxt)
        return nxt

    def strict(c):
        outs = []
        for i in range(depth):
            logits, _ = fb(tok[slots, None], c, c.lengths, attn_window=window)
            outs.append(sample(i, logits))
            c.lengths.add_(active[slots])
        return outs

    def windowed(c):
        len0 = c.lengths.clone()
        d = delta.zero_()
        outs = []
        for i in range(depth):
            logits, d = fb(tok[slots, None], c, len0 + i, attn_window=window,
                           window_delta=(d, i, len0))
            outs.append(sample(i, logits))
        c.absorb_delta(d, len0, active[slots], depth)
        return outs

    steps = windowed if flow == "delta" else strict
    if flow == "step" or not isinstance(kv, PagedKVCache):
        return torch.stack(steps(kv))
    dense = kv.gather_window(window)
    starts = dense.lengths.clone()
    outs = steps(dense)
    kv.absorb(dense, starts, depth)
    return torch.stack(outs)


def prefill_batch(fb, toks, temp, starts, plens, noise, temps, top_ks, top_ps,
                  slots: slice = slice(None), gather=None) -> tuple:
    """A flood's prefill (reference :586-711): every row of the (R, s_pad)
    token block at `starts` into the temp cache (R rows), one forward_batch
    at attention window s_pad, each row's first token sampled on the device
    from its logits at plen − 1 (noise (R, k) under the counter-0 keys), the
    temp cache's lengths set to plens. fb, slots and gather as in
    `decode_window`. Returns (the (R,) first tokens, temp)."""
    t = toks[slots]
    logits, temp = fb(t, temp, starts[slots], attn_window=t.shape[1])
    pl = plens[slots]
    rows = logits[torch.arange(t.shape[0], device=t.device),
                  torch.clamp(pl - 1, min=0).to(torch.int64)]
    firsts = sample_batch(rows, noise[slots], temps[slots], top_ks[slots], top_ps[slots])
    temp.lengths.copy_(pl)
    return (firsts if gather is None else gather(firsts)), temp


class Engine:
    """Continuous batching over a model module exposing forward /
    forward_batch / make_cache (models/llama.py, moe.py, gpt2.py)."""

    def __init__(self, model_mod, cfg, params, max_batch: int = 8,
                 max_seq: int = 1024, chunk_size: int | None = None,
                 device=None, paged_pages: int | None = None, mesh=None):
        """paged_pages: the size in pages (of config kv_page_size positions)
        of a paged KV pool (runtime/paged_kv.py) in place of the dense
        max_batch × max_seq cache: device memory then scales with live
        tokens. Admission waits (active slots keep decoding) while the pool
        is full. Config kv_quant makes the caches int8.

        mesh: a dp × tp mesh (parallel/mesh.py) of which this process is one
        rank; every rank builds its Engine with the same arguments and runs
        the same host logic, in lockstep. params come from
        parallel/tp.py::shard_llama_params (models/llama.py only); decode,
        the flood and the chunked prefill run through tp.py's programs on
        this rank's heads (KV heads / tp) and slots (max_batch / dp, the
        slots of its dp coordinate), with the sampled tokens all-gathered
        over dp into the (max_batch,) token vector every rank holds. The
        paged pool factors into dp groups (reference :372-437): this rank's
        pool is its group, paged_pages / dp pages with its own scratch page,
        and slot b takes its pages from group b // (max_batch / dp)'s free
        list. On an NCCL mesh the windows are captured with their
        collectives inside; on a gloo mesh (a CUDA graph cannot hold a gloo
        collective) the same window bodies run uncaptured, which
        `graphs.captured` reports."""
        self.mesh = mesh
        dev = resolve(device) if mesh is None else mesh.device
        self.device = dev
        dev_p = tree_device(params)
        if dev_p.type != dev.type:
            raise ValueError(f"params live on {dev_p}, engine asked for {dev}")
        self.m = model_mod
        self.cfg = cfg
        self.params = params
        self.max_batch = B = max_batch
        self.max_seq = max_seq
        self.chunk_size = chunk_size or int(config.get("engine_chunk_size"))
        self.kv_quant = bool(config.get("kv_quant"))
        kvh = getattr(cfg, "n_kv_head", None) or cfg.n_head
        dp = 1 if mesh is None else mesh.size("dp")
        tp = 1 if mesh is None else mesh.size("tp")
        if B % dp or kvh % tp:
            raise ValueError(f"max_batch {B} and n_kv_head {kvh} must divide by dp {dp} "
                             f"and tp {tp}")
        # this rank's slots of the (B,) per-slot vectors (all of them without a mesh)
        self._bl = B // dp
        lo = 0 if mesh is None else mesh.index("dp") * self._bl
        self._slots = slice(lo, lo + self._bl)
        self._kvh = kvh // tp
        self._bind_programs()
        self.paged = paged_pages is not None
        if self.paged:
            if paged_pages % dp:
                raise ValueError(f"paged_pages {paged_pages} must divide by dp {dp}")
            self.page_size = int(config.get("kv_page_size"))
            self.kv = PagedKVCache.create(cfg.n_layer, self._bl, max_seq, self._kvh,
                                          cfg.head_dim, total_pages=paged_pages // dp,
                                          page_size=self.page_size, dtype=cfg.compute_dtype,
                                          quant=self.kv_quant, device=dev)
            # host-side, deterministic free lists of group-local page ids,
            # one per dp group (the same lists on every rank)
            self._free_pages = [list(range(paged_pages // dp)) for _ in range(dp)]
            self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        else:
            self.kv = BatchedKVCache.create(cfg.n_layer, self._bl, max_seq, self._kvh,
                                            cfg.head_dim, dtype=cfg.compute_dtype, device=dev,
                                            quant=self.kv_quant)
        self.slots: list[Request | None] = [None] * B
        # host view of each slot's length INCLUDING dispatched steps (the
        # device lengths lag by the unharvested window): the window bucket
        self.host_len = np.zeros(B, np.int32)
        self.counters = np.zeros(B, np.int64)     # sampling key counters
        self.temps = np.zeros(B, np.float32)
        self.top_ks = np.ones(B, np.int32)
        self.top_ps = np.ones(B, np.float32)
        self.queue: list[Request] = []
        self.pending: _Pending | None = None
        self.finished: list[Request] = []
        self._rid = itertools.count()
        # the static device state the captured steps read; uploaded when a
        # slot is (un)installed, in place
        self._tok = torch.zeros(B, dtype=torch.int64, device=dev)
        self._active = torch.zeros(B, dtype=torch.int32, device=dev)
        self._temps = torch.zeros(B, dtype=torch.float32, device=dev)
        self._top_ks = torch.ones(B, dtype=torch.int32, device=dev)
        self._top_ps = torch.ones(B, dtype=torch.float32, device=dev)
        self._noise: dict[int, torch.Tensor] = {}    # depth → (depth, B, k)
        self._noise_live: set[int] = set()           # depths holding draws
        self._delta: dict[int, WindowDelta] = {}     # depth → window-delta buffers
        self._state_dirty = True
        # a flood's temp caches, one per s_pad bucket, and its start vector
        self._temp_kv: dict[int, BatchedKVCache] = {}
        self._zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        # first tokens sampled at admission, read back with the next
        # harvest: (rid, slot, _Firsts, index into it)
        self._first_pending: list[tuple[int, int, _Firsts, int]] = []
        self.graphs = GraphCache(dev, capture=mesh is None or mesh.capturable)
        # per-window wall times of the last run(): (seconds, tokens harvested)
        self.window_log: list[tuple[float, int]] = []

    # -- public API -------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int,
               eos_id: int | None = None, temp: float = 0.0,
               top_k: int = 40, top_p: float = 0.9, seed: int = 0) -> int:
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_seq:
            raise ValueError(f"prompt length {len(prompt)} >= max_seq {self.max_seq}")
        r = Request(next(self._rid), list(prompt), max_new_tokens, eos_id,
                    temp, top_k, top_p, seed)
        r.t_submit = time.perf_counter_ns()
        self.queue.append(r)
        return r.rid

    def _working(self) -> bool:
        return bool(self.queue or self.pending or any(s is not None for s in self.slots))

    @torch.inference_mode()
    def run(self, on_finish=None) -> list[Request]:
        """Run until all submitted requests complete; returns them.
        on_finish(req) streams each completed request as soon as its window
        is harvested. Up to `engine_harvest_depth` steps chain on the device
        per window, and window k is harvested only after window k+1 is
        dispatched, so the read-back overlaps window k+1's device work.
        Token streams are bit-identical to depth 1 (reference :493-561)."""
        n_streamed = 0
        self.window_log = []

        def flush():
            nonlocal n_streamed
            if on_finish is not None:
                while n_streamed < len(self.finished):
                    on_finish(self.finished[n_streamed])
                    n_streamed += 1

        depth = max(1, int(config.get("engine_harvest_depth")))
        if depth == 1:
            while self._working():
                t0 = time.perf_counter()
                n = self.step()
                self.window_log.append((time.perf_counter() - t0, n))
                flush()
            out, self.finished = self.finished, []
            return out
        prev = None
        carry_n = 0   # first tokens harvested before any window was logged
        t_win = time.perf_counter()
        while True:
            # the iteration's span is recorded only: a profiler's range over
            # it would cover every idle gap of the trace
            with trace.named_scope("engine.window", mirror=False):
                work = self._working()
                cur, aborted = self._dispatch_window(depth) if work else (None, None)
                if prev:
                    n = carry_n + self._harvest(prev)
                    carry_n = 0
                    now = time.perf_counter()
                    self.window_log.append((now - t_win, n))
                    t_win = now
                elif self._first_pending:
                    carry_n += self._harvest([])
                flush()
                prev = cur
                if aborted is not None:
                    # tokens already dispatched are not lost: harvest the
                    # partial window, then propagate
                    if prev:
                        self._harvest(prev)
                    raise aborted
            if cur is None and not work:
                break
        out, self.finished = self.finished, []
        return out

    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration: one admission chunk (more in ramp mode),
        one batched decode step (one replay), immediate harvest (the
        depth-1 cadence: one token per active slot). Returns the number of
        tokens harvested."""
        with trace.named_scope("engine.window", mirror=False):
            abort.check()   # cooperative-cancel poll point (utils/abort.py)
            self._advance_admission()
            d = self._dispatch()
            return 0 if d is None else self._harvest([d])

    # -- engine internals -------------------------------------------------

    def _bind_programs(self):
        """The model programs: the chunked prefill, the flood's prefill and
        the decode window body, the model's own without a mesh, tp.py's on
        one (reference :197-363)."""
        import functools

        if self.mesh is None:
            fb = functools.partial(self.m.forward_batch, self.cfg, self.params)
            self._prefill_chunk = functools.partial(self.m.forward, self.cfg, self.params)
            self._prefill_flood = functools.partial(prefill_batch, fb)
            self._window_body = functools.partial(decode_window, fb)
            return
        if not self.m.__name__.endswith("models.llama"):
            raise ValueError("a mesh Engine serves models/llama.py (parallel/tp.py)")
        from ..parallel import tp

        args = (self.mesh, self.cfg, self.params)
        self._prefill_chunk = functools.partial(tp.tp_forward, *args)
        self._prefill_flood = functools.partial(tp.tp_prefill_batch, *args)
        self._window_body = functools.partial(tp.tp_decode_window, *args)

    def _local(self, b: int) -> int | None:
        """Slot b's row in this rank's caches, None where another rank
        holds it."""
        lb = b - self._slots.start
        return lb if 0 <= lb < self._bl else None

    def _group(self, b: int) -> int:
        """The paged pool group (dp coordinate) of slot b."""
        return b // self._bl

    def _free_slot(self) -> int | None:
        for b, s in enumerate(self.slots):
            if s is None:
                return b
        return None

    def _advance_admission(self):
        """A flood when one is eligible; else ONE prefill chunk per step at
        healthy occupancy, RAMP MODE below half occupancy (up to 8 chunks
        per step)."""
        if self._admit_batch():
            return
        for _ in range(8):
            self._advance_admission_once()
            occ = sum(s is not None for s in self.slots)
            if occ * 2 >= self.max_batch:
                break
            if self.pending is None and not self.queue:
                break

    def _install(self, b: int, r: Request, firsts: _Firsts, j: int):
        """Host bookkeeping of request r installed into slot b, its first
        token at index j of `firsts`."""
        self.slots[b] = r
        self.temps[b], self.top_ks[b], self.top_ps[b] = r.temp, r.top_k, r.top_p
        self.counters[b] = 1
        self.host_len[b] = len(r.prompt)
        self._first_pending.append((r.rid, b, firsts, j))
        self._state_dirty = True

    def _take_pages(self, b: int, n: int) -> list[int]:
        free = self._free_pages[self._group(b)]
        pages = [free.pop() for _ in range(n)]
        self._slot_pages[b] = pages
        return pages

    def _temp_cache(self, s_pad: int, rows: int) -> BatchedKVCache:
        """The flood's temp cache of s_pad positions and `rows` rows: a view
        of the first rows of the bucket's cache (this rank's slots and
        heads), made once per bucket. It needs no zeroing: a flood's forward
        writes every position [0, s_pad) of every row (and every scale when
        quantized) before its attention reads them."""
        temp = self._temp_kv.get(s_pad)
        if temp is None:
            temp = self._temp_kv[s_pad] = BatchedKVCache.create(
                self.cfg.n_layer, self._bl, s_pad, self._kvh, self.cfg.head_dim,
                dtype=self.cfg.compute_dtype, device=self.device, quant=self.kv_quant)
        return temp.rows(rows)

    def _flood_rows(self, n: int, s_pad: int) -> int:
        """The rows of a flood of n prompts at s_pad: n, raised with pad rows
        as far as every product of the block needs to take the route it
        takes in the max_batch block. A route changes with M alone
        (ops/cuda/dispatch.py::route; a flood's M is never 1, K10's): the
        block's products run at M = rows·s_pad, an expert stack's at C =
        rows·s_pad·n_expert_used (ops/recurrent.py::mul_mat_id). M grows with
        the rows, so the search ends at max_batch at the latest. A mesh keeps
        the full block: each dp rank prefills its own slots."""
        B = self.max_batch
        if self.mesh is not None:
            return B
        us = {1, int(getattr(self.cfg, "n_expert_used", 1))}
        types = sorted(dispatch.INT8_TYPES)

        def routes(r):
            return [dispatch.route(r * s_pad * u, t) for u in us for t in types]

        full, r = routes(B), n
        while r < B and routes(r) != full:
            r += 1
        return r

    def _admit_batch(self) -> bool:
        """Admit up to one single-chunk prompt per free slot in ONE batched
        prefill (the weights stream once per flood, not once per request;
        reference :586-711). Eligible when nothing is pending, at least 2
        slots are free and at least 2 prompts of at most chunk_size tokens
        head the queue, taken strictly FIFO (on the paged pool, as many as
        the free pages seat): a pure function of host state. The flood
        prefills an (r, s_pad) token block at starts 0 into the temp cache,
        row i the i-th admitted request (rows past them, `_flood_rows`'
        pad, are dropped), samples the admitted rows' first tokens on the
        device at counter 0 from the row at plen − 1 (the keys of the
        single-request path), and installs the admitted rows' K/V [0, s_pad)
        and lengths into their slots of the live cache in place, ordered on
        the stream after any dispatched replay. A mesh Engine prefills the
        (max_batch, s_pad) block, row b slot b. Runs eagerly; raises on any
        failure."""
        if self.pending is not None:
            return False
        free = [b for b, s in enumerate(self.slots) if s is None]
        if len(free) < 2:
            return False
        n = 0
        while (n < min(len(free), len(self.queue))
               and len(self.queue[n].prompt) <= self.chunk_size):
            n += 1
        if self.paged:
            # every admitted request needs its pages up front, from its
            # slot's group; the flood is trimmed to what the free lists seat
            seated, budget = 0, [len(f) for f in self._free_pages]
            for b, r in zip(free, self.queue[:n]):
                need = -(-len(r.prompt) // self.page_size)
                if budget[self._group(b)] < need:
                    break
                budget[self._group(b)] -= need
                seated += 1
            n = seated
        if n < 2:
            return False
        with trace.named_scope("engine.flood") as span:
            reqs, self.queue[:n] = self.queue[:n], []
            for r in reqs:
                r.t_admit, r.admitted_by = span.t0, "flood"
            self._flood(reqs, free[:n], span)
        return True

    def _flood(self, reqs: list[Request], slots: list[int], span: trace.Span):
        """The flood of `reqs` into `slots` (`_admit_batch`), its counts on
        `span`: the requests, their prompt tokens, the rows of the block
        (`batch`) and the rows computed (batch × s_pad, pad rows included)."""
        # prompts are < max_seq (submit), so min() keeps them whole
        s_pad = min(_bucket(max(len(r.prompt) for r in reqs)), self.chunk_size, self.max_seq)
        dev, mesh, n = self.device, self.mesh is not None, len(reqs)
        R = self._flood_rows(n, s_pad)
        # the block row of each request: its slot on a mesh, its index otherwise
        rows = slots if mesh else list(range(n))
        span.set(requests=n, tokens=sum(len(r.prompt) for r in reqs), rows=R * s_pad, batch=R)
        k = min(MAX_K, self.cfg.n_vocab)
        toks = np.zeros((R, s_pad), np.int64)
        # per-row vectors, uploaded as one: admitted, plen, temp, top_k, top_p,
        # and this rank's cache rows of the admitted slots (all exact in f64)
        local = [lb for lb in map(self._local, slots) if lb is not None]
        vec = np.zeros((6, R), np.float64)
        vec[3], vec[4] = 1, 1
        seeds = [0] * R
        for j, r in zip(rows, reqs):
            toks[j, :len(r.prompt)] = r.prompt
            vec[:5, j] = (1, len(r.prompt), r.temp, r.top_k, r.top_p)
            seeds[j] = r.seed
        vec[5, :len(local)] = local
        noise = (gumbel_noise(seeds, [0] * R, k, dev) if any(r.temp > 0 for r in reqs)
                 else torch.zeros((R, k), device=dev))
        toks_d, vec_d = to_device(toks, dev), to_device(vec, dev)
        admitted = vec_d[0] > 0 if mesh else None
        plens = vec_d[1].to(torch.int32)
        idx = vec_d[5, :len(local)].to(torch.int64)
        temp = self._temp_cache(s_pad, R)
        firsts, temp = self._prefill_flood(toks_d, temp, self._zeros[:R], plens, noise,
                                           vec_d[2].float(), vec_d[3].to(torch.int32),
                                           vec_d[4].float())
        if self.paged:
            pt = np.full((len(local), self.kv.page_table.shape[1]), self.kv.scratch_page,
                         np.int32)
            i = 0
            for b, r in zip(slots, reqs):
                pages = self._take_pages(b, -(-len(r.prompt) // self.page_size))
                if self._local(b) is not None:
                    pt[i, :len(pages)] = pages
                    i += 1
            if local:
                self.kv.page_table[idx] = to_device(pt, dev)
            if not mesh:
                self.kv.absorb(temp.rows(n), self._zeros[:n], s_pad, slots=idx)
            else:
                from ..parallel.tp import tp_absorb_temp_paged

                tp_absorb_temp_paged(self.mesh, self.kv, temp, admitted, s_pad)
        elif local:
            absorb_temp(self.kv, temp, idx, rows=idx if mesh else None)
        # the captured graphs read this very buffer: updated in place
        if mesh:
            self._tok.copy_(torch.where(admitted, firsts.to(self._tok.dtype), self._tok))
        else:
            self._tok.index_copy_(0, idx, firsts[:n].to(self._tok.dtype))
        shared = _Firsts(firsts)
        for b, j, r in zip(slots, rows, reqs):
            self._install(b, r, shared, j)

    def _first_token(self, logits_row: torch.Tensor, r: Request) -> torch.Tensor:
        """A request's first token, sampled on the device under its
        counter-0 key (reference :32-41): no host read."""
        dev = logits_row.device
        k = min(MAX_K, logits_row.shape[-1])
        noise = (gumbel_noise([r.seed], [0], k, dev) if r.temp > 0
                 else torch.zeros((1, k), device=dev))

        def full(v, dt):
            return torch.full((1,), v, dtype=dt, device=dev)

        return sample_batch(logits_row[None], noise, full(r.temp, torch.float32),
                            full(r.top_k, torch.int32), full(r.top_p, torch.float32))[0]

    def _advance_admission_once(self):
        """Process at most ONE prefill chunk; install the request when its
        prompt is complete, its first token sampled on the device. On the
        paged pool the install waits while the pool lacks the request's
        pages (active slots keep decoding; completions free pages), and
        raises when no slot is active to free any."""
        if self.pending is None and (not self.queue or self._free_slot() is None):
            return
        if self.pending is not None and self.pending.first is not None:
            self._install_pending()      # prefilled, waiting for pages
            return
        with trace.named_scope("engine.chunk") as span:
            if self.pending is None:
                r = self.queue.pop(0)
                r.t_admit, r.admitted_by = span.t0, "chunk"
                kv = self.m.make_cache(self.cfg, self.max_seq, device=self.device,
                                       quant=self.kv_quant)
                if self.mesh is not None:
                    from ..parallel.tp import shard_kv

                    kv = shard_kv(self.mesh, kv, batched=False)
                self.pending = _Pending(r, kv)
            p = self.pending
            r = p.req
            chunk = r.prompt[p.done_tokens:p.done_tokens + self.chunk_size]
            padded = np.zeros(min(_bucket(len(chunk)), self.chunk_size), np.int64)
            padded[:len(chunk)] = chunk
            span.rid = r.rid
            span.set(tokens=len(chunk))
            logits, p.kv = self._prefill_chunk(to_device(padded, self.device), p.kv,
                                               p.done_tokens)
            p.done_tokens += len(chunk)
            if p.done_tokens < len(r.prompt):
                return
            p.first = self._first_token(logits[len(chunk) - 1], r)
            self._install_pending()

    def _install_pending(self):
        """Install the prefilled pending request into a free slot; on the
        paged pool only once the pool has its pages."""
        p = self.pending
        r = p.req
        toks = r.prompt
        b = self._free_slot()
        lb = self._local(b)
        if self.paged:
            need = -(-len(toks) // self.page_size)
            free = self._free_pages[self._group(b)]
            if len(free) < need:
                if not any(s is not None for s in self.slots):
                    raise RuntimeError(
                        f"paged KV pool too small: request needs {need} pages, its group "
                        f"has {len(free)} free and no slot is active")
                return
            pages = self._take_pages(b, need)
            if lb is not None:
                self.kv.set_slot(lb, to_device(np.asarray(pages, np.int64), self.device),
                                 p.kv.k, p.kv.v, len(toks), p.kv.k_d, p.kv.v_d)
        elif lb is not None:
            self.kv.set_slot(lb, p.kv.k, p.kv.v, len(toks), p.kv.k_d, p.kv.v_d)
        # device-ordered after the dispatched steps, before the next one:
        # the new slot's first input token
        self._tok[b:b + 1].copy_(p.first)
        self._install(b, r, _Firsts(p.first), 0)
        self.pending = None

    def _check_done(self, b: int):
        r = self.slots[b]
        if r is None:
            return
        if (len(r.out) >= r.max_new_tokens
                or (r.eos_id is not None and r.out and r.out[-1] == r.eos_id)
                or len(r.prompt) + len(r.out) >= self.max_seq):
            r.done = True
            r.t_finish = time.perf_counter_ns()
            _trace_request(r)
            self.finished.append(r)
            self.slots[b] = None
            self.host_len[b] = 0
            self._state_dirty = True
            lb = self._local(b)
            if lb is not None:
                self.kv.lengths[lb:lb + 1].fill_(0)
            if self.paged:
                # recycle the pages; the row points at the scratch page again
                # (inactive slots still issue masked decode writes)
                self._free_pages[self._group(b)].extend(self._slot_pages[b])
                self._slot_pages[b] = []
                if lb is not None:
                    self.kv.page_table[lb].fill_(self.kv.scratch_page)

    def _ensure_pages(self, active: np.ndarray, lookahead: int = 1):
        """Give every active slot pages for this dispatch's write positions
        (host_len[b] .. host_len[b] + lookahead - 1), capped at the
        request's own last position: steps dispatched past its end write
        through the table's unallocated tail to the scratch page and take
        no page. Host-side and deterministic; one small upload only when a
        slot crosses a page boundary."""
        ps = self.page_size
        ups = []
        for b in np.nonzero(active)[0]:
            r = self.slots[b]
            cap = min(len(r.prompt) + r.max_new_tokens, self.max_seq) - 1
            need = min(int(self.host_len[b]) + lookahead - 1, cap) // ps + 1
            free = self._free_pages[self._group(b)]
            while len(self._slot_pages[b]) < need:
                if not free:
                    raise RuntimeError(f"paged KV pool group {self._group(b)} exhausted "
                                       "mid-decode (size the pool for the most live tokens)")
                pg = free.pop()
                if self._local(b) is not None:
                    ups.append((self._local(b), len(self._slot_pages[b]), pg))
                self._slot_pages[b].append(pg)
        if ups:
            t = to_device(np.ascontiguousarray(np.asarray(ups, np.int64).T), self.device)
            self.kv.page_table[t[0], t[1]] = t[2].to(torch.int32)

    def _upload_state(self, active: np.ndarray):
        """Refresh the static per-slot buffers after a slot was
        (un)installed (reference :843-858), in place."""
        if not self._state_dirty:
            return
        for dst, src in ((self._active, active.astype(np.int32)), (self._temps, self.temps),
                         (self._top_ks, self.top_ks), (self._top_ps, self.top_ps)):
            upload(dst, src)
        self._state_dirty = False

    def _load_noise(self, depth: int) -> torch.Tensor:
        """The noise buffer of the `depth`-step programs, row i holding the
        slots' Gumbel draws at their counters + i; zeros when no slot
        samples."""
        B, k = self.max_batch, min(MAX_K, self.cfg.n_vocab)
        buf = self._noise.get(depth)
        if buf is None:
            buf = self._noise[depth] = torch.zeros((depth, B, k), device=self.device)
        if any(r is not None and r.temp > 0 for r in self.slots):
            seeds = [r.seed if r is not None else 0 for r in self.slots] * depth
            ctr = (self.counters[None, :] + np.arange(depth)[:, None]).reshape(-1)
            upload(buf, gumbel_noise(seeds, ctr.tolist(), k).reshape(depth, B, k))
            self._noise_live.add(depth)
        elif depth in self._noise_live:
            buf.zero_()
            self._noise_live.discard(depth)
        return buf

    def _graph(self, window: int, depth: int, flow: str = "step"):
        """The captured program of `depth` chained decode steps at
        attention window `window` (`decode_window`, on a mesh
        tp.tp_decode_window); its output is the (depth, B) token stack."""
        noise = self._noise[depth]

        def body():
            return self._window_body(self.kv, self._tok, self._active, noise, self._temps,
                                     self._top_ks, self._top_ps, window, depth, flow,
                                     self._delta.get(depth))

        key = ("engine", id(self.params), self.kv.k[0].data_ptr(), self.max_batch, 1,
               window, depth, self.cfg, flow)
        return self.graphs.get(key, body, state=(self._tok, self.kv.lengths))

    def _window(self, n: int) -> int:
        """The attention-window bucket covering n positions."""
        return min(self.max_seq, max(int(config.get("engine_min_window")), _bucket(n)))

    def _replay(self, active: np.ndarray, depth: int, window: int, flow: str = "step"):
        """Replay the `depth`-step program; returns (HostCopy of its token
        stack, slot→rid snapshots)."""
        with trace.named_scope("engine.replay"):
            if self.paged:
                self._ensure_pages(active, depth)
            self._upload_state(active)
            self._load_noise(depth)
            if flow == "delta" and depth not in self._delta:
                self._delta[depth] = WindowDelta.create(self.cfg.n_layer, self._bl, self._kvh,
                                                        depth, self.cfg.head_dim,
                                                        device=self.device)
            out = self._graph(window, depth, flow).replay()[0]
            rows = HostCopy(out)    # before the next replay overwrites it
        self.counters += depth
        self.host_len += active.astype(np.int32) * depth
        return rows, [[r.rid if r is not None else None for r in self.slots]] * depth

    def _dispatch(self):
        """One batched decode step over every slot (one replay, no host
        sync) chained through the device token vector; returns (HostCopy
        of the tokens (1, B), [slot→rid snapshot]) or None when no slot is
        active."""
        active = np.array([s is not None for s in self.slots], bool)
        if not active.any():
            return None
        return self._replay(active, 1, self._window(int(self.host_len[active].max()) + 1))

    def _dispatch_scan(self, depth: int):
        """One `depth`-step window as ONE replay (reference :938-991). Only
        called when no admission can occur mid-window, so the strict
        window's streams equal the per-step path's (keys chain on (seed,
        counter); the wider attention window only adds exactly-masked
        reads). Under engine_window_delta the window is the delta flow."""
        active = np.array([s is not None for s in self.slots], bool)
        if not active.any():
            return None
        flow = "delta" if bool(config.get("engine_window_delta")) else "scan"
        return self._replay(active, depth,
                            self._window(int(self.host_len[active].max()) + depth), flow)

    def _dispatch_window(self, depth: int):
        """Dispatch up to `depth` chained decode steps (one admission chunk
        before each); returns (dispatched | None, aborted exception | None)
        where dispatched lists (HostCopy, snapshots) — an abort is captured,
        not raised, so the caller can harvest the dispatched steps
        (reference :993-1059). Admission runs first; when none can happen
        mid-window the window is one replay (`_dispatch_scan`)."""
        if self.pending is not None or (self.queue and self._free_slot() is not None):
            self._advance_admission()
        if (bool(config.get("engine_scan_window")) and self.pending is None
                and not (self.queue and self._free_slot() is not None)
                and any(s is not None for s in self.slots)):
            try:
                abort.check()
            except abort.Aborted as e:
                return None, e
            return [self._dispatch_scan(depth)], None
        inflight = []
        aborted = None
        for _ in range(depth):
            try:
                abort.check()
            except abort.Aborted as e:
                aborted = e
                break
            self._advance_admission()
            d = self._dispatch()
            if d is None:
                break
            inflight.append(d)
        return inflight or None, aborted

    def _harvest(self, dispatched) -> int:
        """Apply dispatched token rows to the host bookkeeping; returns the
        number of tokens accepted. First tokens drain before the rows (a
        slot's first token precedes its decode rows; rows dispatched before
        its installation carry the previous occupant's rid). Rows of a slot
        whose request completed earlier (rid mismatch or freed slot) are
        discarded, so the outputs match depth 1 exactly (reference
        :887-918)."""
        with trace.named_scope("engine.harvest"):
            n = 0
            firsts, self._first_pending = self._first_pending, []
            for rid, b, tok, j in firsts:
                r = self.slots[b]
                if r is not None and r.rid == rid:
                    r.out.append(tok.item(j))
                    r.t_first = time.perf_counter_ns()
                    n += 1
                    self._check_done(b)
            for rows, snaps in dispatched:
                for row, snap in zip(rows.numpy(), snaps):
                    for b, rid in enumerate(snap):
                        r = self.slots[b]
                        if r is not None and r.rid == rid:
                            r.out.append(int(row[b]))
                            n += 1
                            self._check_done(b)
        return n
