"""Measured choice of the execution layout and the attention
implementation (the counterpart of ggml_gfx906_tpu/utils/autotune.py).

`choose(device)` answers config weights_layout="auto": "kernel" (the
types' matmul kernels K1-K10) or "int8" (ops/quantized.py's int8
execution layout). `choose_attn(device)` answers attn_impl: "pallas"
(kernel K2) or "xla" (the plain attention). Both probe K11
(`dma_gbs`), the card's kernel memory stream, against the library's
(`utils/perf.py::measure_hbm_bw`), and the decisions are pure functions of
the measured numbers (`decide_layout`, `decide_attn`). Off the card they
answer "kernel" / "pallas" without probing, as the reference does off the
TPU (:33-34, :226-227).

Deliberate differences: the reference's probe returns 0.0 when its kernel
fails (:189-192), which then reads as a pathological stream; here a kernel
that fails to build or launch raises. The reference's `probe_int4_dot`
(:77-123) compiles an int4 XLA:TPU `dot_general` to learn whether its
runtime could stream a 4-bit execution layout; the port has no int4
execution layout, and its 4-bit weights already stream at wire density
through the types' kernels, so it has no such probe.

    from ggml_gfx906_tpu_torch.utils import autotune
    autotune.choose("cuda")              # 'kernel' | 'int8' (cached)
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda import build
from .device import resolve
from .perf import _card, _time_fn, measure_hbm_bw

# K11's rate below this share of the library's marks a pathological kernel
# memory stream (reference :42, :233)
PATHOLOGICAL = 0.25
_MEASURED: dict[tuple, dict] = {}       # measure(): per process, device and shape


def _cache_path() -> Path:
    root = os.environ.get("GGML_TORCH_CACHE",
                          os.path.expanduser("~/.cache/ggml_gfx906_tpu_torch"))
    return Path(root) / "autotune.json"


def _cache_key(device: torch.device) -> str:
    """Card, torch, CUDA and K11's build: a rewritten kernel is measured
    again."""
    return (f"{torch.cuda.get_device_name(device)}|{torch.__version__}|{torch.version.cuda}"
            f"|{build.digest('dma_copy')}")


def _read_cache() -> dict:
    try:
        return json.loads(_cache_path().read_text())
    except (OSError, ValueError):
        return {}


def _write_cache(key: str, entry: dict) -> None:
    """Best effort: a cache that cannot be written is measured again."""
    try:
        path = _cache_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        data = _read_cache()
        data[key] = entry
        path.write_text(json.dumps(data))
    except OSError:
        pass


def _measure_dma(device: torch.device) -> float:
    """K11 on a (4096, 4096) f32 array: one warm call, then three calls
    between CUDA events; 2·bytes over the best, in GB/s."""
    from ..ops.cuda.dma_copy import dma_copy

    x = torch.randn((4096, 4096), device=device, generator=torch.Generator(device).manual_seed(0))
    out = torch.empty_like(x)
    dma_copy(x, out)
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dma_copy(x, out)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    if not torch.equal(out, x):
        raise RuntimeError("K11 dma_copy: the copy differs from its input")
    return 2 * x.numel() * x.element_size() / best / 1e9


def dma_gbs(device=None) -> float:
    """K11's streaming rate (GB/s, read + write; `_measure_dma`), the
    counterpart of the reference's pallas_dma_gbs (:141-209). The value is a
    property of the card and the software (`_cache_key`), so it is cached
    on disk in $GGML_TORCH_CACHE or
    ~/.cache/ggml_gfx906_tpu_torch/autotune.json and measured again only for
    a new key."""
    device = _card(device)
    key = _cache_key(device)
    cached = _read_cache().get(key, {}).get("dma_gbs")
    if cached is not None:
        return float(cached)
    gbs = _measure_dma(device)
    _write_cache(key, {"dma_gbs": gbs})
    return gbs


def decide_layout(dma_gbs: float, hbm_gbs: float, t_kernel_s: float | None = None,
                  t_int8_s: float | None = None) -> str:
    """K11 below PATHOLOGICAL × the library's rate (both GB/s): "int8"
    without timing the two layouts; otherwise the faster of the M = 1
    products (seconds). Takes `measure`'s numbers as keywords."""
    if dma_gbs < PATHOLOGICAL * hbm_gbs:
        return "int8"
    return "int8" if t_int8_s < t_kernel_s else "kernel"


def decide_attn(dma_gbs: float, hbm_gbs: float) -> str:
    return "pallas" if dma_gbs >= PATHOLOGICAL * hbm_gbs else "xla"


def _log(msg: str):
    print(f"autotune: {msg}", file=sys.stderr)


def measure(device=None, n: int = 2048, k: int = 2048) -> dict:
    """What `choose` decides on, measured once per process, device and
    shape (reference :24-74): {"dma_gbs": K11's rate, "hbm_gbs": the
    library's} and, unless K11 is pathological, {"t_kernel_s", "t_int8_s"}:
    an M = 1 `qmatmul` on random Q4_K fields (n × k) through K1 and
    through the same weight in the int8 layout. Returns a copy."""
    from ..ops.quantized import QuantTensor, qmatmul, to_int8_layout
    from ..quant.types import GGMLType

    device = _card(device)
    key = (str(device), n, k)
    if key not in _MEASURED:
        m = {"dma_gbs": dma_gbs(device), "hbm_gbs": measure_hbm_bw(device) / 1e9}
        if m["dma_gbs"] >= PATHOLOGICAL * m["hbm_gbs"]:
            rng = np.random.default_rng(0)
            sb = k // 256
            fields = {"qs": rng.integers(0, 256, (n, sb * 128), dtype=np.uint8),
                      "scm": rng.integers(0, 64, (n, sb * 16), dtype=np.uint8),
                      "dd": rng.random((n, sb * 2), dtype=np.float32) * 0.002}
            qt = QuantTensor(GGMLType.Q4_K, (n, k),
                             {f: torch.from_numpy(a).to(device) for f, a in fields.items()})
            qt8 = to_int8_layout(qt)
            iters = 12
            xs = torch.from_numpy(
                rng.standard_normal((3 * iters, 1, k)).astype(np.float32)).to(device)
            m["t_kernel_s"] = _time_fn(lambda x: qmatmul(x, qt), xs, iters=iters, rounds=2)
            m["t_int8_s"] = _time_fn(lambda x: qmatmul(x, qt8), xs, iters=iters, rounds=2)
        _log(", ".join(f"{name}={v:.6g}" for name, v in m.items()))
        _MEASURED[key] = m
    return dict(_MEASURED[key])


def choose(device=None, n: int = 2048, k: int = 2048) -> str:
    """'kernel' | 'int8' for the quantized matmuls on `device`:
    `decide_layout` on `measure`'s numbers. Off the card: 'kernel' without
    probing."""
    device = resolve(device)
    if device.type != "cuda":
        return "kernel"            # the CPU keeps the bit-exact kernel layout
    return decide_layout(**measure(device, n, k))


def choose_attn(device=None) -> str:
    """'pallas' | 'xla' for causal attention on `device` (reference
    :212-237): kernel K2 while K11 streams at no less than PATHOLOGICAL ×
    the library's rate. Off the card: 'pallas' without probing."""
    device = resolve(device)
    if device.type != "cuda":
        return "pallas"
    return decide_attn(dma_gbs(device), measure_hbm_bw(device) / 1e9)
