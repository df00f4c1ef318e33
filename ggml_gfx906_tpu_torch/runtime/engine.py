"""Continuous-batching serving engine — the port of ggml_gfx906_tpu/
runtime/engine.py::Engine.

ref: examples/gpt-2/main-batched.cpp — request batching with interleaved
admission (:407-430).

A fixed pool of B slots over a preallocated batched KV cache. Admission
prefills one request at a time in fixed-size chunks (each padded to a
bucket), interleaved with decode steps, so a long prompt never stalls the
active slots for more than one chunk; below half occupancy several chunks
run per step (ramp mode). Every decode step runs ONE batched decode for all
slots (inactive slots compute masked garbage) over the smallest
attention-window bucket that covers the longest active slot, with the
per-request seeded top-k/top-p sampling inside the step.

The decode loop is device-resident (reference :493-561, :843-1059). Decode
steps are CUDA graphs (runtime/graphs.py), captured once per (window
bucket, depth) and replayed after that:
- `run` dispatches windows of `engine_harvest_depth` steps that chain on
  the device through the token vector and the cache lengths, and reads
  window k back only after window k+1 is dispatched (a copy into pinned
  memory behind an event, `graphs.HostCopy`); depth 1 is the per-step
  loop of `step`;
- when no admission can happen mid-window, a window is ONE replay of the
  graph of `depth` chained steps (`engine_scan_window`); otherwise each
  step is one replay of the one-step graph, after one admission chunk;
  steps dispatched past a request's end are discarded at harvest by the
  slot→rid snapshots;
- admission samples a request's first token on the device (counter 0) and
  it is read back with the next harvest: no host read at admission;
- the per-slot state the graphs read (token vector, active mask, lengths,
  temperatures, top-k, top-p, Gumbel noise) lives in static device buffers
  written in place (`copy_`, `fill_`, pinned uploads) and never rebound;
- `abort.check()` is polled once per window (once per step in the
  per-step path); an abort mid-window harvests the dispatched steps, then
  raises.

Ported: per-request chunked admission (reference :569-585, :712-788
without the batched flood and paged branches), the per-step and windowed
pipelined `run` (:493-561), scan windows (:938-1059) and first tokens on
the device (:32-41, :887-918). Streams therefore equal the reference
engine's with engine_window_delta=False, at any depth. Later slices:
batched flood admission, window delta, the paged pool, int8 KV, meshes.

Deliberate difference: the graphs belong to an Engine instance, because
they hold its KV buffers' addresses; the reference shares its jitted
programs across instances (its tests/test_engine.py:264-285). A second
Engine captures its own.

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

from ..utils import abort, config
from ..utils.device import resolve, to_device, upload
from .batched_kv import BatchedKVCache
from .graphs import GraphCache, HostCopy
from .sampling import gumbel_noise, sample_batch

MAX_K = 64


@dataclass
class Request:
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


class Engine:
    """Continuous batching over a model module exposing forward /
    forward_batch / make_cache (models/llama.py)."""

    def __init__(self, model_mod, cfg, params, max_batch: int = 8,
                 max_seq: int = 1024, chunk_size: int | None = None,
                 device=None):
        # read so that an unported value set through the environment raises
        config.get("kv_quant")
        config.get("engine_window_delta")
        self.device = dev = resolve(device)
        dev_p = params["out_norm"].device
        if dev_p.type != dev.type:
            raise ValueError(f"params live on {dev_p}, engine asked for {dev}")
        self.m = model_mod
        self.cfg = cfg
        self.params = params
        self.max_batch = B = max_batch
        self.max_seq = max_seq
        self.chunk_size = chunk_size or int(config.get("engine_chunk_size"))
        kvh = getattr(cfg, "n_kv_head", None) or cfg.n_head
        self.kv = BatchedKVCache.create(cfg.n_layer, B, max_seq, kvh,
                                        cfg.head_dim, dtype=cfg.compute_dtype,
                                        device=dev)
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
        self._state_dirty = True
        # first tokens sampled at admission, read back with the next
        # harvest: (rid, slot, HostCopy)
        self._first_pending: list[tuple[int, int, HostCopy]] = []
        self.graphs = GraphCache(dev)
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
        abort.check()   # cooperative-cancel poll point (utils/abort.py)
        self._advance_admission()
        d = self._dispatch()
        if d is None:
            return 0
        return self._harvest([d])

    # -- engine internals -------------------------------------------------

    def _free_slot(self) -> int | None:
        for b, s in enumerate(self.slots):
            if s is None:
                return b
        return None

    def _advance_admission(self):
        """ONE prefill chunk per step at healthy occupancy; RAMP MODE below
        half occupancy (up to 8 chunks per step)."""
        for _ in range(8):
            self._advance_admission_once()
            occ = sum(s is not None for s in self.slots)
            if occ * 2 >= self.max_batch:
                break
            if self.pending is None and not self.queue:
                break

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
        prompt is complete, its first token sampled on the device."""
        if self.pending is None:
            if not self.queue or self._free_slot() is None:
                return
            r = self.queue.pop(0)
            self.pending = _Pending(r, self.m.make_cache(self.cfg, self.max_seq,
                                                         device=self.device))
        p = self.pending
        r = p.req
        toks = r.prompt
        chunk = toks[p.done_tokens:p.done_tokens + self.chunk_size]
        padded = np.zeros(min(_bucket(len(chunk)), self.chunk_size), np.int64)
        padded[:len(chunk)] = chunk
        logits, p.kv = self.m.forward(self.cfg, self.params,
                                      to_device(padded, self.device), p.kv, p.done_tokens)
        p.done_tokens += len(chunk)
        if p.done_tokens < len(toks):
            return
        first = self._first_token(logits[len(chunk) - 1], r)
        b = self._free_slot()
        self.kv.set_slot(b, p.kv.k, p.kv.v, len(toks))
        self.slots[b] = r
        self.temps[b], self.top_ks[b], self.top_ps[b] = r.temp, r.top_k, r.top_p
        self.counters[b] = 1
        self.host_len[b] = len(toks)
        # device-ordered after the dispatched steps, before the next one:
        # the new slot's first input token
        self._tok[b:b + 1].copy_(first)
        self._first_pending.append((r.rid, b, HostCopy(first)))
        self._state_dirty = True
        self.pending = None

    def _check_done(self, b: int):
        r = self.slots[b]
        if r is None:
            return
        if (len(r.out) >= r.max_new_tokens
                or (r.eos_id is not None and r.out and r.out[-1] == r.eos_id)
                or len(r.prompt) + len(r.out) >= self.max_seq):
            r.done = True
            self.finished.append(r)
            self.slots[b] = None
            self.host_len[b] = 0
            self._state_dirty = True
            self.kv.lengths[b:b + 1].fill_(0)

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

    def _graph(self, window: int, depth: int):
        """The captured program of `depth` chained decode steps at
        attention window `window`: each step decodes every slot, samples,
        advances the lengths by the active mask and feeds the sampled
        tokens back; its output is the (depth, B) token stack."""
        noise = self._noise[depth]

        def body():
            outs = []
            for i in range(depth):
                logits, _ = self.m.forward_batch(self.cfg, self.params, self._tok[:, None],
                                                 self.kv, self.kv.lengths, attn_window=window)
                nxt = sample_batch(logits[:, 0, :], noise[i], self._temps, self._top_ks,
                                   self._top_ps)
                self.kv.lengths.add_(self._active)
                self._tok.copy_(nxt)
                outs.append(nxt)
            return torch.stack(outs)

        key = ("engine", id(self.params), self.kv.k[0].data_ptr(), self.max_batch, 1,
               window, depth, self.cfg)
        return self.graphs.get(key, body, state=(self._tok, self.kv.lengths))

    def _window(self, n: int) -> int:
        """The attention-window bucket covering n positions."""
        return min(self.max_seq, max(int(config.get("engine_min_window")), _bucket(n)))

    def _replay(self, active: np.ndarray, depth: int, window: int):
        """Replay the `depth`-step program; returns (HostCopy of its token
        stack, slot→rid snapshots)."""
        self._upload_state(active)
        self._load_noise(depth)
        out = self._graph(window, depth).replay()[0]
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
        called when no admission can occur mid-window, so the streams equal
        the per-step path's (keys chain on (seed, counter); the wider
        attention window only adds exactly-masked reads)."""
        active = np.array([s is not None for s in self.slots], bool)
        if not active.any():
            return None
        return self._replay(active, depth,
                            self._window(int(self.host_len[active].max()) + depth))

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
        n = 0
        firsts, self._first_pending = self._first_pending, []
        for rid, b, tok in firsts:
            r = self.slots[b]
            if r is not None and r.rid == rid:
                r.out.append(int(tok.numpy()))
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
