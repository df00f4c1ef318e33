"""Q2_K and Q3_K matmul kernel K9 (f32, every M: neither has an int8 twin).

Kernel source: csrc/qmm_q23k.cu, two format structs on the body it shares
with K4, K7 and K8, csrc/qmm_f32_tiled.cuh (fuller notes there):

- `qmm_q2_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q2_K;
- `qmm_q3_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q3_K.

16 qs bytes of a 128-element half hold four 2-bit planes of 16
consecutive elements; each such group is two chunks of the body (planes
0 and 1, then planes 2 and 3), and Q3_K brings the 16 hmask bytes that
hold their high bits. The C entry point picks the kernel by M. M <= 8
(decode): lanes over the chunks, 2 weight rows per warp, x staged in
shared memory per 32 chunks; bound by the weight bytes (2.75 bits per
weight for Q2_K, 3.625 for Q3_K, read once) and, from M of about 4, by the
f32 FMAs. M > 8 (prefill): a block dequantizes a 16- or 32-row weight tile
once into shared memory for 64 or 32 activation rows, or, at M > 32 where
64 x 64 tiles keep more than half of the SMs busy, a lanes-as-outputs 64 x
64 tile; bound by the f32 FMA rate, then shared memory and the L2 traffic
of x.

Reduction order: 32 slots over the chunks (chunk c in slot c mod 32,
ascending, each chunk's 16 elements of its first plane, then the 16 of
its second), then the xor-butterfly tree; fixed by K alone, so a row's
bits are the same at every M and in every variant (engine streams equal
`generate`'s). No TF32, no atomics.

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
