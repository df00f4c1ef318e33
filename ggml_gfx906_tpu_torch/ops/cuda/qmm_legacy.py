"""Q4_1, Q5_0 and Q5_1 matmul kernel K8 (f32, every M: none of the three
has an int8 twin).

Kernel source: csrc/qmm_legacy.cu, three format structs on the body it
shares with K4, K7 and K9, csrc/qmm_f32_tiled.cuh (fuller notes there):

- `qmm_q4_1` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_1;
- `qmm_q5_0` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q5_0;
- `qmm_q5_1` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q5_1.

A 32-element block is one chunk of the body (its 16 low nibbles, then its
16 high nibbles); Q5_0 and Q5_1 bring the block's 4-byte qh word with it,
Q4_1 no high bits. The C entry point picks the kernel by M. M <= 8
(decode): lanes over the blocks, 2 weight rows per warp, x staged in
shared memory per 32 blocks; bound by the weight bytes (6 bits per weight
for Q4_1 and Q5_0, 7 for Q5_1, read once), then latency. M > 8 (prefill):
a block dequantizes a 16- or 32-row weight tile once into shared memory
for 64 or 32 activation rows, or, at M > 32 where 64 x 64 tiles keep more
than half of the SMs busy, a lanes-as-outputs 64 x 64 tile; bound by the
f32 FMA rate, then shared memory and the L2 traffic of x.

Reduction order: 32 slots over the blocks (block c in slot c mod 32,
ascending, each block's 16 low then 16 high elements), then the
xor-butterfly tree; fixed by K alone, so a row's bits are the same at
every M and in every variant (engine streams equal `generate`'s). No
TF32, no atomics.

Weight layout (ggml wire order, struct of arrays; see ops/quantized.py):
qs (N, K/2) u8, qh (N, K/8) u8 (Q5 only: four wire bytes per block), d (N,
K/32) f32, m (N, K/32) f32 (Q4_1 and Q5_1 only). The block axis is not
padded: the reference's pad to a multiple of 32 blocks (qmm.py:981-1004)
serves its 32-block chunks, which the port does not have.
"""
from __future__ import annotations

import torch

from ...quant import dequant_math as dqm
from . import K8_Q4_1, K8_Q5_0, K8_Q5_1
from .qmm import check_fields, launch_f32

# field → (elements of K per byte or value, dtype)
_FIELD = {"qs": (2, torch.uint8), "qh": (8, torch.uint8),
          "d": (32, torch.float32), "m": (32, torch.float32)}


def _blocks(t, width):
    return t.reshape(t.shape[0], -1, width)


def dequant_q4_1(qs, d, m):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    return dqm.dequant_q4_1(d, m, _blocks(qs, 16)).reshape(qs.shape[0], -1)


def dequant_q5_0(qs, qh, d):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    return dqm.dequant_q5_0(d, _blocks(qh, 4), _blocks(qs, 16)).reshape(qs.shape[0], -1)


def dequant_q5_1(qs, qh, d, m):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    return dqm.dequant_q5_1(d, m, _blocks(qh, 4), _blocks(qs, 16)).reshape(qs.shape[0], -1)


def qmm_q4_1_plain(x, qs, d, m):
    """Plain PyTorch K8 (Q4_1): dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant_q4_1(qs, d, m).T


def qmm_q5_0_plain(x, qs, qh, d):
    """Plain PyTorch K8 (Q5_0): dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant_q5_0(qs, qh, d).T


def qmm_q5_1_plain(x, qs, qh, d, m):
    """Plain PyTorch K8 (Q5_1): dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant_q5_1(qs, qh, d, m).T


def qmm_q4_1(x, qs, d, m):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q4_1 layout."""
    check_fields(x, _FIELD, qs=qs, d=d, m=m)
    if not qs.is_cuda:
        return qmm_q4_1_plain(x, qs, d, m)
    return launch_f32("qmm_q4_1_f32", K8_Q4_1, x, qs, d, m)


def qmm_q5_0(x, qs, qh, d):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q5_0 layout."""
    check_fields(x, _FIELD, qs=qs, qh=qh, d=d)
    if not qs.is_cuda:
        return qmm_q5_0_plain(x, qs, qh, d)
    return launch_f32("qmm_q5_0_f32", K8_Q5_0, x, qs, qh, d)


def qmm_q5_1(x, qs, qh, d, m):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q5_1 layout."""
    check_fields(x, _FIELD, qs=qs, qh=qh, d=d, m=m)
    if not qs.is_cuda:
        return qmm_q5_1_plain(x, qs, qh, d, m)
    return launch_f32("qmm_q5_1_f32", K8_Q5_1, x, qs, qh, d, m)
