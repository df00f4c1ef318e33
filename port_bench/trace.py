"""The traced slice of a `--trace 1` run: torch.profiler with CPU and CUDA
activities over a marked slice of the window, reduced to device busy time
(the union of kernel, copy and set intervals inside the slice), busy time
by kernel name, the longest idle gaps named by the host event that covers
most of each, and each kernel's launch kind: kernels whose launch is a
`cudaGraphLaunch` (the engine's captured decode windows) against kernels
launched one by one (eager floods and chunks)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MARK = "port_bench.traced_window"
NAMED_GAPS = 200          # the longest gaps named one by one


@dataclass
class Kernel:
    name: str
    start: float           # seconds, on the trace's clock
    end: float
    graph: bool | None     # launched by a graph replay; None: launch not found


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)
    gaps: list = field(default_factory=list)           # [(host name, seconds)], longest first
    by_name: list = field(default_factory=list)        # [(name, seconds)], busiest first
    launches_found: int = 0

    def time_in(self, pred) -> float:
        return sum(k.end - k.start for k in self.kernels if pred(k))


class Tracer:
    """prepare() at set-up (the profiler's own start-up, outside the
    window), start() and stop() around the traced slice from the harness's
    callbacks; stop() comes after the window has closed, so the profiler's
    processing never falls inside it. summary() after the run."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.mark = None
        self.active = False

    def prepare(self):
        self.prof.prepare_trace()

    def start(self):
        self.prof.start_trace()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()
        self.active = True

    def stop(self):
        self.mark.__exit__(None, None, None)
        self.prof.stop_trace()
        self.active = False

    def summary(self) -> Summary:
        return reduce(self.prof.profiler.kineto_results.events())


def _union(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events) -> Summary:
    """Kineto events → Summary over the MARK span."""
    cpu, dev, w0, w1 = [], [], None, None
    events = list(events)
    # a CPU span's mirror on the device timeline (a user annotation) has a
    # CPU event of its name; kernels, copies and sets have none
    cpu_names = {e.name() for e in events if e.device_type() != torch.autograd.DeviceType.CUDA}
    for e in events:
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if d > 0 and e.name() not in cpu_names:
                dev.append((e.name(), s, s + d, e.correlation_id(), e.linked_correlation_id()))
        elif e.name() == MARK:
            w0, w1 = s, s + d
        else:
            cpu.append((e.name(), s, s + d, e.correlation_id()))
    if w0 is None:
        raise RuntimeError("the profiler's trace holds no traced-window mark")
    launch = {c: n for n, _, _, c in cpu if n.startswith("cu") and c}
    kernels, found = [], 0
    for name, s, e, corr, linked in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        api = launch.get(linked) or launch.get(corr)
        found += api is not None
        kernels.append(Kernel(name, s, e, None if api is None else "GraphLaunch" in api))
    busy = _union([(k.start, k.end) for k in kernels])
    by = {}
    for k in kernels:
        by[k.name] = by.get(k.name, 0.0) + (k.end - k.start)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                   reverse=True)
    host = [(n, s, e) for n, s, e, _ in cpu if not n.startswith("cu")]
    hn = [n for n, _, _ in host]
    hs = np.array([s for _, s, _ in host] or [0.0])
    he = np.array([e for _, _, e in host] or [0.0])
    merged = {}
    for i, (g, a, b) in enumerate(spans):
        name = "host: other (shorter gaps)"
        if i < NAMED_GAPS:
            ov = np.minimum(b, he) - np.maximum(a, hs)
            k = int(ov.argmax())
            name = "host: " + hn[k] if host and ov[k] > 0 else "host: none"
        merged[name] = merged.get(name, 0.0) + g
    return Summary(window_s=w1 - w0, busy_s=sum(e - s for s, e in busy), kernels=kernels,
                   gaps=sorted(merged.items(), key=lambda kv: -kv[1]),
                   by_name=sorted(by.items(), key=lambda kv: -kv[1]), launches_found=found)
