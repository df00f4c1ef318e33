"""Device timing and op microbenchmarks on the card (the port of
ggml_gfx906_tpu/utils/perf.py): `measure_hbm_bw` and `_time_fn`, which the
autotuner reads, and the per-op benchmarks `bench_qmm`, `bench_dequant`,
`bench_attention` and `bench_softmax` over the reference's op table `ALL`.

    python -m ggml_gfx906_tpu_torch.utils.perf [--op qmm_q4_K ...]

Everything here times the card with CUDA events and raises off it: a number
taken on the CPU is never a device rate. The op benchmarks time the device's
work alone (a spin kernel ahead of each timed round hides the host's
dispatch, which exceeds a small product's device time), with warm L2. The rooflines are the H100 SXM's
(HBM3 3.35 TB/s, f32 FMA 67 TFLOP/s; the reference's constants are a TPU's
and do not apply): `pct_hbm` is a share of the rate `measure_hbm_bw`
measures on this card, `pct_f32_peak` a share of the f32 peak (the port's
kernels and matmuls never use TF32).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

HBM_BPS_SPEC = 3.35e12          # H100 SXM HBM3 bytes/s
F32_FLOPS = 67e12               # H100 SXM f32 FMA peak

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


SPIN_CYCLES = 10_000_000        # ~6 ms of a spin kernel at H100 clocks


def _time_fn(fn, xs, iters: int = 12, rounds: int = 2, spin: bool = False) -> float:
    """Seconds per call of fn(x) on the card: xs holds (rounds + 1) ·
    iters inputs, each used once; the first iters calls warm up, then each
    round times iters calls between two CUDA events, and the best round's
    mean is returned. Without `spin` the interval holds the host's launch
    gaps where the device waits for them, as a decode step does (the
    autotuner's question); with it a spin kernel ahead of each round keeps
    the device busy while the host enqueues the round, so the interval
    holds the device's work alone (the op benchmarks' question)."""
    if len(xs) < (rounds + 1) * iters:
        raise ValueError(f"{len(xs)} inputs for {rounds + 1} × {iters} calls")
    _card(xs[0].device)
    for x in xs[:iters]:
        fn(x)
    best = float("inf")
    for r in range(1, rounds + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for x in xs[r * iters:(r + 1) * iters]:
            fn(x)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3 / iters)
    return best


def _random_qt(rng, qtype, n: int, k: int, device):
    """A random weight in the kernel layout, its fields drawn directly
    (timing does not depend on the values; Q4_K, Q8_0 and Q4_0), or
    quantized from a Gaussian on the card (the other types)."""
    from ..ops.quantized import QuantTensor
    from ..quant.types import GGMLType

    if qtype == GGMLType.Q4_K:
        fields = {"qs": rng.integers(0, 256, (n, k // 2), dtype=np.uint8),
                  "scm": rng.integers(0, 64, (n, k // 16), dtype=np.uint8),
                  "dd": rng.random((n, k // 128), dtype=np.float32) * 0.01}
    elif qtype == GGMLType.Q8_0:
        fields = {"qs": rng.integers(-127, 128, (n, k)).astype(np.int8),
                  "d": rng.random((n, k // 32), dtype=np.float32) * 0.01}
    elif qtype == GGMLType.Q4_0:
        fields = {"qs": rng.integers(0, 256, (n, k // 2), dtype=np.uint8),
                  "d": rng.random((n, k // 32), dtype=np.float32) * 0.01}
    else:
        return QuantTensor.quantize(qtype, rng.standard_normal((n, k)).astype(np.float32),
                                    device=device)
    return QuantTensor(qtype, (n, k), {f: torch.from_numpy(a).to(device)
                                       for f, a in fields.items()}, "kernel")


def _inputs(rng, count: int, *shape, device) -> list:
    return list(torch.from_numpy(rng.standard_normal((count, *shape)).astype(np.float32))
                .to(device).unbind(0))


def bench_qmm(qtype_name: str, m: int, n: int, k: int, device=None) -> dict:
    """x (m, k) @ W(qtype, (n, k)).T through `qmatmul` (the type's kernel
    by ops/cuda/dispatch.py::route)."""
    from ..ops.quantized import qmatmul
    from ..quant.types import GGMLType

    device = _card(device)
    rng = np.random.default_rng(0)
    iters = 8
    qt = _random_qt(rng, GGMLType[qtype_name], n, k, device)
    dt = _time_fn(lambda a: qmatmul(a, qt), _inputs(rng, 3 * iters, m, k, device=device),
                  iters=iters, spin=True)
    bytes_ = qt.nbytes + 4 * (m * k + m * n)
    return {"op": f"qmm_{qtype_name}", "shape": f"{m}x{k}·{n}", "ms": dt * 1e3,
            "gflops": 2 * m * n * k / dt / 1e9, "gbs": bytes_ / dt / 1e9,
            "pct_hbm": 100 * bytes_ / dt / measure_hbm_bw(device)}


def bench_dequant(qtype_name: str, n: int, k: int, device=None) -> dict:
    """The whole weight dequantized to f32 (ops/quantized.py::dequant, plain
    torch on the card)."""
    from ..ops.quantized import dequant
    from ..quant.types import GGMLType

    device = _card(device)
    rng = np.random.default_rng(0)
    iters = 20
    qt = _random_qt(rng, GGMLType[qtype_name], n, k, device)
    probe = next(iter(qt.fields.values()))
    dt = _time_fn(lambda _: dequant(qt), [probe] * (3 * iters), iters=iters, spin=True)
    bytes_ = qt.nbytes + 4 * n * k
    return {"op": f"dequant_{qtype_name}", "shape": f"{n}x{k}", "ms": dt * 1e3,
            "gbs": bytes_ / dt / 1e9, "pct_hbm": 100 * bytes_ / dt / measure_hbm_bw(device)}


def bench_attention(b: int, h: int, n: int, m: int, d: int, device=None) -> dict:
    """ops.flash_attn_ext (ggml's explicit-mask attention; plain torch f32
    matmuls and softmax, as the reference's is XLA's)."""
    from .. import ops

    device = _card(device)
    rng = np.random.default_rng(0)
    iters = 5
    k = torch.from_numpy(rng.standard_normal((b, h, m, d)).astype(np.float32)).to(device)
    v = torch.from_numpy(rng.standard_normal((b, h, m, d)).astype(np.float32)).to(device)
    dt = _time_fn(lambda q: ops.flash_attn_ext(q, k, v),
                  _inputs(rng, 3 * iters, b, h, n, d, device=device), iters=iters, spin=True)
    flops = 4 * b * h * n * m * d
    return {"op": "flash_attn", "shape": f"b{b}h{h} {n}x{m}x{d}", "ms": dt * 1e3,
            "gflops": flops / dt / 1e9, "pct_f32_peak": 100 * flops / dt / F32_FLOPS}


def bench_softmax(rows: int, cols: int, device=None) -> dict:
    from .. import ops

    device = _card(device)
    rng = np.random.default_rng(0)
    iters = 5
    dt = _time_fn(lambda a: ops.soft_max_ext(a[None]),
                  _inputs(rng, 3 * iters, rows, cols, device=device), iters=iters, spin=True)
    bytes_ = 2 * 4 * rows * cols
    return {"op": "softmax", "shape": f"{rows}x{cols}", "ms": dt * 1e3,
            "gbs": bytes_ / dt / 1e9, "pct_hbm": 100 * bytes_ / dt / measure_hbm_bw(device)}


ALL = {
    "qmm_q4_K": lambda: bench_qmm("Q4_K", 1, 4096, 4096),
    "qmm_q4_K_gemm": lambda: bench_qmm("Q4_K", 512, 4096, 4096),
    "qmm_q8_0": lambda: bench_qmm("Q8_0", 1, 4096, 4096),
    "qmm_q4_0": lambda: bench_qmm("Q4_0", 1, 4096, 4096),
    "dequant_q4_K": lambda: bench_dequant("Q4_K", 4096, 4096),
    "dequant_q8_0": lambda: bench_dequant("Q8_0", 4096, 4096),
    "flash_attn": lambda: bench_attention(1, 32, 1024, 1024, 128),
    "softmax": lambda: bench_softmax(4096, 4096),
}


def main(argv=None, out: list | None = None) -> int:
    """The CLI; `out`, when given, receives each op's result dict."""
    ap = argparse.ArgumentParser(description="per-op microbenchmarks on the card")
    ap.add_argument("--op", action="append", help="subset of ops to run")
    args = ap.parse_args(argv)
    names = args.op or list(ALL)
    unknown = [n for n in names if n not in ALL]
    if unknown:
        print(f"unknown op {unknown}; have {list(ALL)}", file=sys.stderr)
        return 1
    device = _card(None)
    print(f"device: {torch.cuda.get_device_name(device)}; measured HBM read "
          f"{measure_hbm_bw(device) / 1e9:.1f} GB/s (spec {HBM_BPS_SPEC / 1e9:.0f}), f32 "
          f"peak {F32_FLOPS / 1e12:.0f} TFLOP/s", file=sys.stderr)
    for name in names:
        r = ALL[name]()
        if out is not None:
            out.append(r)
        parts = [f"{r['op']:18s}", f"{r['shape']:>18s}", f"{r['ms']:8.3f} ms"]
        for key in ("gflops", "gbs", "pct_hbm", "pct_f32_peak"):
            if key in r:
                parts.append(f"{key}={r[key]:.1f}")
        print("  ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
