"""Captured static-shape programs: the port's counterpart of the
reference's jitted decode programs and their program cache
(ggml_gfx906_tpu/runtime/engine.py:197-363, models/llama.py:286-456).

A `StepGraph` owns one callable that reads static input buffers (tokens,
positions, the active mask, sampling state, noise; the KV buffers) and
returns static outputs. On the card it is captured once as a CUDA graph
and replayed after that:

- warm-up: the callable runs once eagerly on a side stream, so that nvcc
  builds, the ctypes bindings, `cudaFuncSetAttribute` and every cache
  (the rope tables, `_sm_count`) happen outside the capture; the `state`
  tensors the callable advances in place are restored afterwards (its KV
  writes are idempotent: the replay writes the same rows again);
- capture with `torch.cuda.graph` on the owner's memory pool (the owner's
  graphs never run concurrently, and every graph keeps its outputs alive);
- replay. There is no fallback: a capture or replay error raises.

On the CPU (device="cpu", as the tests run) the capture and replay are a
direct call of the callable whose results are copied into the first
call's outputs, so the static-buffer plumbing around it is the same.

The kernels' launch counters (ops/cuda/__init__.py) rise in the wrappers,
which run at warm-up and at capture but not at a replay: a graph records
each kernel's launches at capture, takes them back out of the counters
and adds them at every replay, so a replay counts what it launches.

A `GraphCache` holds an owner's graphs under keys that name everything the
capture bakes in — the caller's part (the params' identity, the KV
buffers' address, B, S, the window bucket, the depth, the config with its
compute dtype) plus every config knob that the traced code reads
(`config_key`) — so a knob flipped after a capture captures anew instead
of replaying a stale program (the reference's key, engine.py:205-206).
"""
from __future__ import annotations

import gc
import time

import torch

from ..ops import cuda as kernels
from ..utils import config, trace

# the config knobs that the traced decode code reads
TRACED_KNOBS = ("attn_impl", "qmm_pipeline", "int8_min_m", "weights_layout", "int8_tile",
                "kv_attn_int8_dot")


def config_key() -> tuple:
    return tuple(config.get(k) for k in TRACED_KNOBS)


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class StepGraph:
    """One captured program: `fn()` returns a tensor or a tuple of tensors
    (the static outputs) and may advance the `state` tensors in place."""

    def __init__(self, fn, device: torch.device, state=(), pool=None, stream=None,
                 capture: bool = True):
        self.fn = fn
        self.graph = None
        self.outputs: tuple | None = None
        self.launches: list = []        # (Kernel, launches per replay)
        self.capture_s = 0.0
        if device.type == "cuda" and capture:
            self._capture(tuple(state), pool, stream or torch.cuda.Stream(device))

    def _capture(self, state, pool, stream):
        saved = [t.clone() for t in state]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.fn()
        torch.cuda.current_stream().wait_stream(stream)
        for t, v in zip(state, saved):
            t.copy_(v)
        before = [k.launches for k in kernels.KERNELS]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a dead cycle that holds
        # a CUDA graph (an engine and its programs' closures) destroyed
        # there would invalidate it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                self.outputs = _as_tuple(self.fn())
        finally:
            if collecting:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        for k, n in zip(kernels.KERNELS, before):
            if k.launches != n:
                self.launches.append((k, k.launches - n))
                k.launches = n
        self.graph = graph

    def replay(self) -> tuple:
        """Run the program; returns its static outputs, which the next
        replay overwrites."""
        if self.graph is None:
            out = _as_tuple(self.fn())
            if self.outputs is None:
                self.outputs = out
            else:
                for dst, src in zip(self.outputs, out):
                    dst.copy_(src)
            return self.outputs
        self.graph.replay()
        for k, n in self.launches:
            k.launches += n
        return self.outputs


class GraphCache:
    """The captured programs of one owner (an Engine, a KVCache), on one
    memory pool and one warm-up stream. capture=False keeps every program
    a direct call on the card too: an Engine on a gloo mesh
    (parallel/mesh.py), whose collectives a CUDA graph cannot hold, runs
    its window bodies so, uncaptured; `captured` says which. Each new
    program is made inside a `graphs.capture` span (utils/trace.py)."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = device
        self.captured = device.type == "cuda" and capture
        self.graphs: dict[tuple, StepGraph] = {}
        self._pool = None
        self._stream = None

    def get(self, key: tuple, fn, state=()) -> StepGraph:
        """The graph of `key` + the traced knobs, captured from `fn` (with
        `state` restored after its warm-up) if it is new."""
        key = tuple(key) + config_key()
        g = self.graphs.get(key)
        if g is None:
            with trace.named_scope("graphs.capture"):
                if self.captured and self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                    self._stream = torch.cuda.Stream(self.device)
                g = self.graphs[key] = StepGraph(fn, self.device, state, self._pool,
                                                 self._stream, self.captured)
        return g

    def capture_s(self) -> float:
        return sum(g.capture_s for g in self.graphs.values())

    def pool_bytes(self) -> int | None:
        """Bytes the allocator holds in this cache's pool (None on the CPU,
        or where the allocator's snapshot does not name pools)."""
        if self._pool is None:
            return None
        segs = torch.cuda.memory_snapshot()
        if not segs or "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))


class HostCopy:
    """A device tensor's value on the host, copied now and read later: on
    the card a copy into pinned memory ordered on the current stream, with
    an event that `numpy()` waits on (so a read waits for the work queued
    before the copy, not for the work queued after it), inside a
    `graphs.wait` span."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.detach().clone()

    def numpy(self):
        with trace.named_scope("graphs.wait"):
            if self._event is not None:
                self._event.synchronize()
            return self._host.numpy()
