"""Device timing the autotuner reads (the counterpart of
ggml_gfx906_tpu/utils/perf.py::measure_hbm_bw and _time_fn).

Both time the card with CUDA events and raise off it: a number taken on
the CPU is never a device rate.
"""
from __future__ import annotations

import torch

_MEASURED_BW: dict[str, float] = {}      # per process and device


def _card(device) -> torch.device:
    """`device` (None: cuda) when it is a CUDA device that exists; raises
    otherwise."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device timing needs a CUDA device, got {device}")
    return device


def measure_hbm_bw(device=None, nbytes: int = 1 << 31) -> float:
    """Effective HBM read rate (bytes/s): one library reduction
    (`torch.sum`) over an `nbytes` f32 device buffer, 40× the card's L2,
    best of five calls between CUDA events after a warm call; cached per
    process and device. The reference's xor chain, slope method and fresh
    buffers (:44-103) guard against XLA hoisting or simplifying the read,
    memoizing identical dispatches and a dispatch tunnel's latency; eager
    torch runs each reduction as called, and the events time the device
    alone."""
    device = _card(device)
    key = str(device)
    if key not in _MEASURED_BW:
        buf = torch.empty(nbytes // 4, dtype=torch.float32, device=device).uniform_()
        torch.sum(buf)
        best = float("inf")
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.sum(buf)
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        del buf
        _MEASURED_BW[key] = nbytes / best
    return _MEASURED_BW[key]


def _time_fn(fn, xs, iters: int = 12, rounds: int = 2) -> float:
    """Seconds per call of fn(x) on the card: xs holds (rounds + 1) ·
    iters inputs, each used once; the first iters calls warm up, then each
    round times iters calls between two CUDA events, and the best round's
    mean is returned. The interval holds the host's launch gaps where the
    device waits for them, as a decode step does."""
    if len(xs) < (rounds + 1) * iters:
        raise ValueError(f"{len(xs)} inputs for {rounds + 1} × {iters} calls")
    _card(xs[0].device)
    for x in xs[:iters]:
        fn(x)
    best = float("inf")
    for r in range(1, rounds + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for x in xs[r * iters:(r + 1) * iters]:
            fn(x)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3 / iters)
    return best
