"""Q2_K and Q3_K matmul kernel K9 (f32, every M: neither has an int8 twin).

Kernel source: csrc/qmm_q23k.cu (fuller notes there). One template over
the high-bit plane, two entry points:

- `qmm_q2_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q2_K;
- `qmm_q3_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q3_K.

Bound on the H100: bytes at decode — the weights (2.75 bits per weight for
Q2_K, 3.625 for Q3_K) are read once — and the f32 FMAs (2·M flops per
weight) from M ≈ 4 on. Design: K8's — each lane reads 16 qs bytes (64
weights in four 2-bit planes; for Q3_K also the 16 hmask bytes that hold
their high bits) per step, forms the f32 weights in registers one plane at
a time and FMAs them against up to 8 activation rows; a fixed xor-shuffle
reduction per output.

Weight layout (ggml wire order, struct of arrays; see ops/quantized.py):
Q2_K qs (N, K/4) u8, scales (N, K/16) u8, d and dmin (N, K/256) f32; Q3_K
qs (N, K/4) u8, hmask (N, K/8) u8, sc (N, K/16) i8 (unpacked signed), d
(N, K/256) f32. The superblock axis is not padded, and hmask is not
duplicated per 128-element half: the reference's pad to an even count and
its hmask copies (qmm.py:1093-1133) serve its two-superblock, 128-lane
chunks, which the port does not have.
"""
from __future__ import annotations

import torch

from ...quant import dequant_math as dqm
from . import K9_Q2_K, K9_Q3_K
from .qmm import check_fields, launch_f32

# field → (elements of K per byte or value, dtype)
_FIELD = {"qs": (4, torch.uint8), "scales": (16, torch.uint8), "hmask": (8, torch.uint8),
          "sc": (16, torch.int8), "d": (256, torch.float32), "dmin": (256, torch.float32)}


def _blocks(t, width):
    return t.reshape(t.shape[0], -1, width)


def dequant_q2_K(qs, scales, d, dmin):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    return dqm.dequant_q2_K(d, dmin, _blocks(scales, 16), _blocks(qs, 64)).reshape(qs.shape[0], -1)


def dequant_q3_K(qs, hmask, sc, d):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    return dqm.dequant_q3_K_unpacked(d, _blocks(hmask, 32), _blocks(sc, 16),
                                     _blocks(qs, 64)).reshape(qs.shape[0], -1)


def qmm_q2_K_plain(x, qs, scales, d, dmin):
    """Plain PyTorch K9 (Q2_K): dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant_q2_K(qs, scales, d, dmin).T


def qmm_q3_K_plain(x, qs, hmask, sc, d):
    """Plain PyTorch K9 (Q3_K): dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant_q3_K(qs, hmask, sc, d).T


def qmm_q2_K(x, qs, scales, d, dmin):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q2_K layout."""
    check_fields(x, _FIELD, qs=qs, scales=scales, d=d, dmin=dmin)
    if not qs.is_cuda:
        return qmm_q2_K_plain(x, qs, scales, d, dmin)
    return launch_f32("qmm_q2k_f32", K9_Q2_K, x, qs, scales, d, dmin)


def qmm_q3_K(x, qs, hmask, sc, d):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q3_K layout."""
    check_fields(x, _FIELD, qs=qs, hmask=hmask, sc=sc, d=d)
    if not qs.is_cuda:
        return qmm_q3_K_plain(x, qs, hmask, sc, d)
    return launch_f32("qmm_q3k_f32", K9_Q3_K, x, qs, hmask, sc, d)
