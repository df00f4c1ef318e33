"""Tracing and profiling (the port of ggml_gfx906_tpu/utils/trace.py):
named scopes, a device trace, a host-side section timer and a graph dump.

- `named_scope(name)`: torch.profiler.record_function (the reference's
  jax.named_scope): a labelled range in the trace.
- `profile(logdir)`: torch.profiler over the CPU and, where there is a
  card, CUDA activities; writes a Chrome trace (`*.pt.trace.json`, opened
  by chrome://tracing, Perfetto or TensorBoard's profiler plugin) under
  logdir.
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
import os
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, record_function

named_scope = record_function

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
    to `path` (a file under d) when the block ends."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(path))


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
