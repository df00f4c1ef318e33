"""Driving the port's Engine through its public API: a proxy of the model
module that marks the eager prefill calls, the warm-up that captures every
window the cell's traffic reaches, and the closed loop whose middle is the
measured window.

The clock of the loop is the engine's own poll point: `Engine.run` calls
the abort callback (utils/abort.py) once per dispatched window, where the
harness opens the window, starts and stops the trace, and finally closes
the window by returning True, so that the run ends with no drain."""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ggml_gfx906_tpu_torch.ops import cuda as kernels
from ggml_gfx906_tpu_torch.utils import abort

from . import traffic
from .traffic import Mix

# the attention-window and flood buckets are powers of two (and max_seq):
# the warm-up puts one request just past each boundary the traffic reaches
BOUNDS = tuple(2 ** i for i in range(4, 16))


class ModelProxy:
    """The model module as the Engine sees it, with each eager prefill
    (`forward`: a chunk; `forward_batch` over more than one position: a
    flood) marked by a profiler span and logged with its token tensor (its
    real rows counted after the run: the engine pads with 0, which the
    traffic never draws)."""

    def __init__(self, mod):
        self._mod = mod
        self.__name__ = mod.__name__
        self.prefills: list[tuple[float, str, torch.Tensor]] = []

    def __getattr__(self, k):
        return getattr(self._mod, k)

    def forward(self, cfg, params, tokens, kv, start, **kw):
        self.prefills.append((time.perf_counter(), "chunk", tokens))
        with torch.profiler.record_function("port_bench.chunk"):
            return self._mod.forward(cfg, params, tokens, kv, start, **kw)

    def forward_batch(self, cfg, params, tokens, kv, start, **kw):
        if tokens.shape[1] == 1:          # a decode body, run at capture only
            return self._mod.forward_batch(cfg, params, tokens, kv, start, **kw)
        self.prefills.append((time.perf_counter(), "flood", tokens))
        with torch.profiler.record_function("port_bench.flood"):
            return self._mod.forward_batch(cfg, params, tokens, kv, start, **kw)


def _lengths_between(lo: int, hi: int, max_seq: int) -> list[int]:
    """One length just past each bucket boundary in (lo, hi]: a request
    of that length lands in the bucket above the boundary."""
    edges = sorted({b for b in BOUNDS if b < max_seq} | {max_seq})
    return [b + 1 for b in edges if lo <= b + 1 <= hi]


def warm(eng, mix: dict, vocab: int, seed: int) -> int:
    """Run the engine over requests that reach every attention-window
    bucket of the traffic in both window flows (a step dispatched while a
    prompt is admitted, a scan window when none is); returns the requests
    run. Engine.step admits a request and dispatches one step at its
    length + 1, Engine.run then finishes it in scan windows. Floods run
    eagerly and capture nothing; the loop's ramp runs them before the
    window opens."""
    rng = np.random.default_rng([seed, 99])
    max_seq = eng.max_seq
    pairs = traffic.pool(mix)
    lo = min(p for p, _ in pairs)
    top = min(max_seq - 1, max(p + o for p, o in pairs) + 16)
    n = 0
    for length in [lo] + _lengths_between(lo, top, max_seq):
        length = min(length, max_seq - 12)
        eng.submit(rng.integers(1, vocab, length).tolist(), 10)
        while eng.queue or eng.pending is not None:
            eng.step()
        eng.run()
        n += 1
    return n


@dataclass
class Done:
    client: int
    rid: int
    prompt: list
    out: list
    t_submit: float
    t_finish: float


@dataclass
class LoopResult:
    t_open: float
    t_close: float
    harvests: list                  # (t_end, seconds, tokens) of each harvested window
    done: list                      # Done, every completed request
    attempted: int                  # requests submitted
    opened_by: str                  # "completions" or "timeout"
    trace_span: tuple | None = None
    k2_span: tuple | None = None    # K2 launches at the traced slice's two ends
    captures_in_window: int = 0


class ClosedLoop:
    """`clients` clients, each submitting its next request from on_finish;
    the window opens after `warm_completions` completions (a point the
    deterministic engine reaches with the same requests in flight on every
    run of a seed), lasts `seconds`, and optionally traces its last
    `trace_seconds` (the profiler's stop, which processes the trace, comes
    after the close; where the polls are further apart than the slice, the
    close waits for the poll after the trace's start)."""

    def __init__(self, eng, mix: Mix, seconds: float, tracer=None, open_timeout: float = 240.0):
        self.eng = eng
        self.mix = mix
        m = mix.mix
        self.clients = int(m["clients"])
        self.warm_completions = int(m["warm_completions"])
        self.seconds = float(seconds)
        self.trace_seconds = min(float(m.get("trace_seconds", seconds)), self.seconds)
        self.tracer = tracer
        if tracer is not None:
            tracer.prepare()
        self.open_timeout = open_timeout
        self.meta: dict[int, tuple] = {}
        self.done: list[Done] = []
        self.next_index = [0] * self.clients
        self.state = "ramp"
        self.t_open = self.t_close = None
        self.opened_by = None
        self.trace_span = None
        self.k2 = []
        self.graphs_at_open = 0

    def submit(self, c: int):
        r = self.mix.request(c, self.next_index[c])
        self.next_index[c] += 1
        rid = self.eng.submit(r.prompt, r.max_new)
        self.meta[rid] = (c, r.prompt, time.perf_counter())

    def on_finish(self, req):
        now = time.perf_counter()
        with torch.profiler.record_function("port_bench.on_finish"):
            c, prompt, t0 = self.meta.pop(req.rid)
            self.done.append(Done(c, req.rid, prompt, list(req.out), t0, now))
            if self.state != "closed":
                self.submit(c)

    def tick(self) -> bool:
        now = time.perf_counter()
        if self.state == "ramp":
            if len(self.done) >= self.warm_completions or now - self.t_loop > self.open_timeout:
                self.opened_by = "completions" if len(self.done) >= self.warm_completions \
                    else "timeout"
                self.state = "open"
                self.graphs_at_open = len(self.eng.graphs.graphs)
                self.t_open = time.perf_counter()
            return False
        if self.state == "open":
            t_end = self.t_open + self.seconds
            if self.tracer is not None and not self.tracer.active and self.trace_span is None \
                    and now >= t_end - self.trace_seconds:
                self.k2.append(kernels.K2.launches)
                self.t_trace0 = time.perf_counter()
                self.tracer.start()
                self.trace_span = (self.t_trace0, None)
                return False        # the slice holds at least one engine window
            if now >= t_end:
                self.t_close = now
                self.state = "closed"
                self.captures = len(self.eng.graphs.graphs) - self.graphs_at_open
                if self.tracer is not None and self.tracer.active:
                    self.k2.append(kernels.K2.launches)
                    self.trace_span = (self.t_trace0, now)
                    self.tracer.stop()
                return True
        return self.state == "closed"

    def run(self) -> LoopResult:
        for c in range(self.clients):
            self.submit(c)
        self.t_loop = time.perf_counter()
        abort.set_abort_callback(self.tick)
        t_call = time.perf_counter()
        try:
            self.eng.run(on_finish=self.on_finish)
        except abort.Aborted:
            pass
        finally:
            abort.set_abort_callback(None)
        if self.state != "closed":
            raise RuntimeError("the engine ran out of work before the window closed")
        ends = t_call + np.cumsum([d for d, _ in self.eng.window_log])
        harvests = [(float(t), d, n) for t, (d, n) in zip(ends, self.eng.window_log)]
        return LoopResult(self.t_open, self.t_close, harvests, self.done,
                          attempted=sum(self.next_index), opened_by=self.opened_by,
                          trace_span=self.trace_span,
                          k2_span=tuple(self.k2) if len(self.k2) == 2 else None,
                          captures_in_window=self.captures)
