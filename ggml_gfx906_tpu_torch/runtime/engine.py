"""Continuous-batching serving engine — the port of ggml_gfx906_tpu/
runtime/engine.py::Engine, in its strict per-step formulation.

ref: examples/gpt-2/main-batched.cpp — request batching with interleaved
admission (:407-430).

A fixed pool of B slots over a preallocated batched KV cache. Admission
prefills one request at a time in fixed-size chunks (each padded to a
bucket), interleaved with decode steps, so a long prompt never stalls the
active slots for more than one chunk; below half occupancy several chunks
run per step (ramp mode). Every engine step runs ONE batched decode for all
slots (inactive slots compute masked garbage) over the smallest
attention-window bucket that covers the longest active slot, then harvests
the tokens (depth 1).

Ported: per-request chunked admission (reference engine.py:569-585,
712-788 without the batched flood and paged branches), the per-step
batched decode with the window bucket (:860-885, :920-930) and the depth-1
`run` loop (:519-528). Streams therefore equal the reference engine's with
engine_window_delta=False. Later slices: batched flood admission, harvest
depth > 1 and scan windows, window delta, the paged pool, int8 KV, meshes.

Sampling: token j of a request draws its Gumbel noise under the key
fold_in(PRNGKey(seed), j), bit for bit the reference's (runtime/sampling.py):
the first token at counter 0 on admission (reference :38), decode steps
from 1 on, each slot's counter set to 1 at install and raised by every
dispatch (:706, :781, :883). So a request samples the same tokens alone or
batched, and the same tokens as in the reference engine.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import config
from ..utils.device import resolve
from .batched_kv import BatchedKVCache
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
        self.device = resolve(device)
        dev_p = params["out_norm"].device
        if dev_p.type != self.device.type:
            raise ValueError(f"params live on {dev_p}, engine asked for {self.device}")
        self.m = model_mod
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.chunk_size = chunk_size or int(config.get("engine_chunk_size"))
        kvh = getattr(cfg, "n_kv_head", None) or cfg.n_head
        self.kv = BatchedKVCache.create(cfg.n_layer, max_batch, max_seq, kvh,
                                        cfg.head_dim, dtype=cfg.compute_dtype,
                                        device=self.device)
        self.slots: list[Request | None] = [None] * max_batch
        self.host_len = np.zeros(max_batch, np.int32)
        self.counters = np.zeros(max_batch, np.int64)     # sampling key counters
        self.queue: list[Request] = []
        self.pending: _Pending | None = None
        self.finished: list[Request] = []
        self._rid = itertools.count()
        self._tok = torch.zeros(max_batch, dtype=torch.int64, device=self.device)
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

    @torch.inference_mode()
    def run(self, on_finish=None) -> list[Request]:
        """Run until all submitted requests complete; returns them.
        on_finish(req) is called for each request as it completes."""
        config.get("engine_harvest_depth")   # the depth-1 loop; other values raise
        self.window_log = []
        n_streamed = 0
        while self.queue or self.pending or any(s is not None for s in self.slots):
            t0 = time.perf_counter()
            n = self.step()
            self.window_log.append((time.perf_counter() - t0, n))
            if on_finish is not None:
                while n_streamed < len(self.finished):
                    on_finish(self.finished[n_streamed])
                    n_streamed += 1
        out, self.finished = self.finished, []
        return out

    @torch.inference_mode()
    def step(self) -> int:
        """One admission chunk (more in ramp mode), one batched decode, and
        the harvest of its tokens. Returns the number of tokens harvested."""
        n = self._advance_admission()
        d = self._dispatch()
        if d is None:
            return n
        nxt, snap = d
        return n + self._harvest(nxt.tolist(), snap)

    # -- engine internals -------------------------------------------------

    def _free_slot(self) -> int | None:
        for b, s in enumerate(self.slots):
            if s is None:
                return b
        return None

    def _advance_admission(self) -> int:
        """ONE prefill chunk per step at healthy occupancy; RAMP MODE below
        half occupancy (up to 8 chunks per step). Returns the number of
        first tokens produced."""
        n = 0
        for _ in range(8):
            n += self._advance_admission_once()
            occ = sum(s is not None for s in self.slots)
            if occ * 2 >= self.max_batch:
                break
            if self.pending is None and not self.queue:
                break
        return n

    def _sample_one(self, logits_row: torch.Tensor, r: Request) -> torch.Tensor:
        """A request's first token, under its counter-0 key."""
        noise = self._noise([r], [0], logits_row)
        return sample_batch(
            logits_row[None], noise,
            torch.tensor([r.temp], dtype=torch.float32),
            torch.tensor([r.top_k], dtype=torch.int32),
            torch.tensor([r.top_p], dtype=torch.float32))[0]

    @staticmethod
    def _noise(reqs, counters, logits: torch.Tensor) -> torch.Tensor:
        """(len(reqs), k) Gumbel rows on the logits' device, row b under
        (reqs[b].seed, counters[b]), built on the host (`gumbel_noise`);
        zeros (unused) when no request samples."""
        k = min(MAX_K, logits.shape[-1])
        if not any(r is not None and r.temp > 0 for r in reqs):
            return torch.zeros((len(reqs), k), device=logits.device)
        seeds = [r.seed if r is not None else 0 for r in reqs]
        return gumbel_noise(seeds, list(counters), k, logits.device)

    def _advance_admission_once(self) -> int:
        """Process at most ONE prefill chunk; install the request when its
        prompt is complete. Returns 1 if a first token was produced."""
        if self.pending is None:
            if not self.queue or self._free_slot() is None:
                return 0
            r = self.queue.pop(0)
            self.pending = _Pending(r, self.m.make_cache(self.cfg, self.max_seq,
                                                         device=self.device))
        p = self.pending
        r = p.req
        toks = r.prompt
        chunk = toks[p.done_tokens:p.done_tokens + self.chunk_size]
        pad_len = min(_bucket(len(chunk)), self.chunk_size)
        padded = torch.zeros(pad_len, dtype=torch.int64)
        padded[:len(chunk)] = torch.as_tensor(chunk, dtype=torch.int64)
        logits, p.kv = self.m.forward(self.cfg, self.params,
                                      padded.to(self.device), p.kv, p.done_tokens)
        p.done_tokens += len(chunk)
        if p.done_tokens < len(toks):
            return 0
        first = int(self._sample_one(logits[len(chunk) - 1], r))
        b = self._free_slot()
        self.kv.set_slot(b, p.kv.k, p.kv.v, len(toks))
        self.slots[b] = r
        self.host_len[b] = len(toks)
        self.counters[b] = 1
        self._tok[b] = first
        self.pending = None
        r.out.append(first)
        self._check_done(b)
        return 1

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
            self.kv.lengths[b] = 0

    def _dispatch(self):
        """One batched decode step over every slot; returns (next tokens
        (B,), slot→rid snapshot) or None when no slot is active."""
        active = np.array([s is not None for s in self.slots], bool)
        if not active.any():
            return None
        window = min(self.max_seq,
                     max(int(config.get("engine_min_window")),
                         _bucket(int(self.host_len[active].max()) + 1)))
        logits, self.kv = self.m.forward_batch(
            self.cfg, self.params, self._tok[:, None], self.kv,
            self.kv.lengths, attn_window=window)
        reqs = self.slots
        nxt = sample_batch(
            logits[:, 0, :], self._noise(reqs, self.counters, logits),
            torch.tensor([r.temp if r else 0.0 for r in reqs], dtype=torch.float32),
            torch.tensor([r.top_k if r else 1 for r in reqs], dtype=torch.int32),
            torch.tensor([r.top_p if r else 1.0 for r in reqs], dtype=torch.float32))
        self.kv.lengths += torch.as_tensor(active, device=self.device).to(torch.int32)
        self.host_len += active
        self.counters += 1
        self._tok = nxt.to(torch.int64)
        return nxt, [r.rid if r is not None else None for r in reqs]

    def _harvest(self, row, snap) -> int:
        """Append each active slot's token; completed requests leave."""
        n = 0
        for b, rid in enumerate(snap):
            r = self.slots[b]
            if r is not None and r.rid == rid:
                r.out.append(int(row[b]))
                n += 1
                self._check_done(b)
        return n
