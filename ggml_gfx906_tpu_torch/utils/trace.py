"""Tracing and profiling (the port of ggml_gfx906_tpu/utils/trace.py):
named scopes recorded as spans, a device trace, a host-side section timer
and a graph dump.

- `named_scope(name, mirror=True, **attrs)`: a span (the
  reference's jax.named_scope): name, start and end on
  `time.perf_counter_ns`, the span it opened inside, a request id and
  attributes (the counts of the work it covers, set on entry or through
  `Span.set` before it ends), appended when it ends to `RECORDER`, the
  process's ring of the last `CAPACITY` spans (the oldest dropped). While a
  profiler runs, a span with `mirror` is also a
  torch.profiler.record_function of its name, a labelled range in the
  trace; with none running it makes no call into torch.
  `record(name, t0, t1, ...)` appends a span whose times are already known
  (a request's lifetime), and `to_trace_ns(t)` puts a span time on the
  profiler's clock (Unix-epoch ns: one offset per process).
- `profile(logdir)`: torch.profiler over the CPU and, where there is a
  card, CUDA activities; writes a Chrome trace (`*.pt.trace.json`, opened
  by chrome://tracing, Perfetto or TensorBoard's profiler plugin) under
  logdir, with the ring's spans of the profiled interval on their own
  track and the request spans as async events keyed by request id.
- `SectionTimer`: cumulative host-side section times (the ggml_graph_print
  analogue); `sync=True` waits for the card at the end of a section.
- `dump_graph(fn, *args, stage=...)`: "fx" is the aten graph of fn(*args)
  by make_fx, on the plain path (the CPU: make_fx cannot trace a kernel's
  ctypes launch); "kernels" lists the device kernels one call of fn(*args)
  launches on the card, in order, from torch.profiler (the ggml_graph_print
  analogue on the card). The reference's "jaxpr", "hlo" and "optimized"
  stages are XLA's and raise here.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, record_function

CAPACITY = 1 << 16
# a request's lifetime and, under it, its phases: submit → admission, →
# its first token's harvest, → finish (runtime/engine.py)
REQUEST = "request"
REQUEST_PHASES = ("request.queued", "request.prefill", "request.decode")


class Span:
    """One recorded range: times in `time.perf_counter_ns`, `sid` its id
    (from 1), `parent` the id of the span it opened inside (0: none), `rid`
    the request it belongs to (None: none), `attrs` its counts."""

    __slots__ = ("name", "t0", "t1", "sid", "parent", "rid", "attrs")

    def __init__(self, name: str, t0: int = 0, t1: int = 0, sid: int = 0, parent: int = 0,
                 rid: int | None = None, attrs: dict | None = None):
        self.name, self.t0, self.t1 = name, t0, t1
        self.sid, self.parent, self.rid = sid, parent, rid
        self.attrs = attrs if attrs is not None else {}

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __repr__(self):
        return (f"Span({self.name!r}, {self.t0}, {self.t1}, sid={self.sid}, "
                f"parent={self.parent}, rid={self.rid}, attrs={self.attrs})")


class _Open(threading.local):
    def __init__(self):
        self.stack: list[Span] = []


class Recorder:
    """A ring of the last `capacity` spans, in the order they ended (a
    record()ed span: when it was recorded). `lost_until` is the latest end
    of a span the ring has dropped (None: none), so the ring holds every
    span that ended after it. `offset_ns` relates the two clocks:
    time.time_ns() − time.perf_counter_ns(), sampled back to back."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: deque[Span] = deque(maxlen=capacity)
        self.lost_until: int | None = None
        self._ids = itertools.count(1)
        self._open = _Open()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()

    def add(self, span: Span):
        if len(self.spans) == self.spans.maxlen:
            t = self.spans[0].t1
            self.lost_until = t if self.lost_until is None else max(self.lost_until, t)
        self.spans.append(span)

    def lost(self, t: int) -> bool:
        """Whether the ring has dropped a span that ended at or after t."""
        return self.lost_until is not None and self.lost_until >= t

    def overlapping(self, t0: int, t1: int) -> list[Span]:
        """The spans the ring holds that overlap [t0, t1] (ns)."""
        return [s for s in self.spans if s.t0 <= t1 and s.t1 >= t0]

    def window(self, t0: int, t1: int) -> list[Span] | None:
        """Every span that overlaps [t0, t1] (ns), or None when the ring has
        dropped a span that ended at or after t0."""
        return None if self.lost(t0) else self.overlapping(t0, t1)

    def requests(self, rids, since: int) -> dict | None:
        """{rid: {name: Span}} of the request spans of `rids` (`REQUEST` and
        its phases, the latest of each); None when the ring has dropped a
        span that ended at or after `since` (ns) or lacks one of them."""
        if self.lost(since):
            return None
        out = {r: {} for r in rids}
        for s in self.spans:
            if s.rid in out and s.name.startswith(REQUEST):
                out[s.rid][s.name] = s
        names = {REQUEST, *REQUEST_PHASES}
        return out if all(names <= v.keys() for v in out.values()) else None


RECORDER = Recorder()


def to_trace_ns(t: int) -> int:
    """A span time (perf_counter ns) on the profiler's clock (Unix-epoch ns)."""
    return t + RECORDER.offset_ns


class named_scope:
    """`with named_scope("engine.flood", requests=3) as span: ...` records
    a span (see the module's docstring); `span.set(k=v)` adds attributes
    before it ends."""

    __slots__ = ("span", "mirror", "_rf", "_rec")

    def __init__(self, name: str, *, mirror: bool = True, **attrs):
        self.span = Span(name, attrs=attrs)
        self.mirror = mirror
        self._rf = None

    def __enter__(self) -> Span:
        rec = self._rec = RECORDER
        sp = self.span
        stack = rec._open.stack
        sp.parent = stack[-1].sid if stack else 0
        sp.sid = next(rec._ids)
        stack.append(sp)
        sp.t0 = time.perf_counter_ns()
        if self.mirror and torch.autograd._profiler_enabled():
            self._rf = record_function(sp.name)
            self._rf.__enter__()
        return sp

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        sp = self.span
        sp.t1 = time.perf_counter_ns()
        self._rec._open.stack.pop()
        self._rec.add(sp)
        return False


def record(name: str, t0: int, t1: int, *, parent: int = 0, rid: int | None = None,
           **attrs) -> int:
    """Append a span whose times are known (perf_counter ns); returns its id."""
    rec = RECORDER
    sid = next(rec._ids)
    rec.add(Span(name, t0, t1, sid, parent, rid, attrs))
    return sid


def _chrome_events(spans, base_ns: int) -> list[dict]:
    """The spans as Chrome trace events on the profiler's clock (µs after
    base_ns): complete events on a track of their own, the request spans
    as async events keyed by request id."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "spans (utils/trace.py)"}}]

    def us(t):
        return (to_trace_ns(t) - base_ns) / 1e3

    for s in spans:
        args = dict(s.attrs, sid=s.sid, parent=s.parent)
        if s.rid is not None:
            args["rid"] = s.rid
        args = {k: list(v) if isinstance(v, tuple) else v for k, v in args.items()}
        if s.name == REQUEST or s.name in REQUEST_PHASES:
            for ph, t in (("b", s.t0), ("e", s.t1)):
                out.append({"ph": ph, "cat": REQUEST, "name": s.name, "id": s.rid, "pid": pid,
                            "tid": 0, "ts": us(t), "args": args})
        else:
            out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": 0,
                        "ts": us(s.t0), "dur": (s.t1 - s.t0) / 1e3, "args": args})
    return out


DEFAULT_LOGDIR = Path(__file__).resolve().parents[2] / "build" / "torch_trace"
STAGES = ("fx", "kernels")


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile(logdir: str | Path = DEFAULT_LOGDIR):
    """`with trace.profile(d) as path: step()` writes the trace of the block
    to `path` (a file under d) when the block ends, with the recorder's
    spans that overlap the block."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    t0 = time.perf_counter_ns()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        prof.stop()
        prof.export_chrome_trace(str(path))
        data = json.loads(path.read_text())
        data["traceEvents"] += _chrome_events(RECORDER.overlapping(t0, t1),
                                              int(data.get("baseTimeNanoseconds", 0)))
        path.write_text(json.dumps(data))


class SectionTimer:
    """Host-side cumulative section timing (ggml_graph_print analogue:
    per-section totals printed on demand)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()    # the device work launched in the section is done
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["section                     total_ms     calls   avg_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name] * 1e3, self.counts[name]
            lines.append(f"{name:26s} {t:10.2f} {c:9d} {t / c:8.3f}")
        return "\n".join(lines)


def device_kernels(fn, *args) -> list[str]:
    """The names of the device kernels one call of fn(*args) runs on the
    card, in the order they started."""
    if not torch.cuda.is_available():
        raise RuntimeError("stage 'kernels' lists device kernels: it needs a CUDA device")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    return [e.name for e in sorted(kern, key=lambda e: e.time_range.start)]


def dump_graph(fn, *args, path: str | None = None, stage: str = "fx") -> str:
    """The graph of `fn(*args)` as text — the ggml_graph_dump_dot /
    ggml_graph_print analogue (ref src/ggml.c:6728, 6802). stage: "fx" (the
    aten graph by make_fx, CPU tensors) or "kernels" (the device kernels one
    call launches on the card, one per line, in order). Writes the text to
    `path` when given."""
    if stage == "fx":
        from torch.fx.experimental.proxy_tensor import make_fx

        text = make_fx(fn)(*args).print_readable(print_output=False)
    elif stage == "kernels":
        text = "\n".join(device_kernels(fn, *args))
    else:
        raise ValueError(f"stage {stage!r}: the port's stages are {STAGES} (the "
                         "reference's jaxpr / hlo / optimized are XLA's)")
    if path:
        Path(path).write_text(text)
    return text
