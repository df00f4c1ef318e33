"""Q8_0 matmul kernels K5 (f32, M < int8_min_m) and K5-i8 (int8, M >= it).

Kernel source: csrc/qmm_q8_0.cu (fuller notes there).

- K5 `qmm_q8_0` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q8_0.
  Bound on the H100: bytes — the weights (9 bits per weight) are read once.
  Design: K1's — each lane reads 16 elements of a row (half a 32-element
  block) at a time, forms f32 weights q·d in registers and FMAs them
  against up to 8 activation rows; a fixed xor-shuffle reduction per
  output.
- K5-i8 `qmm_q8_0_i8` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::
  qmm_q8_0_i8 (_qd_i8_kernel with nblk=4). K3's design for one 128-element
  tile per step: 64×64 output tiles, each block expands its weight tile to
  int8 in shared memory, dp4a integer dots, the reference's f32 epilogue
  order. Operand preparation — per-(row, 128-tile) int8 activations
  (`quantize_x_tiles`) and the block scales folded by the per-tile bound
  (`tile_fold` with dm None, qmax 127) — runs as plain torch ops around the
  kernel, as it ran as XLA ops around the Pallas kernel.

Weight layout (ggml wire order, struct of arrays; see ops/quantized.py):
qs (N, K) i8, d (N, K/32) f32. The int8 tiles are the natural 128-element
tiles of K: the reference's q8_split_x only permutes lanes inside a tile,
so its tiles hold the same elements and its ex and dw equal these bit for
bit.
"""
from __future__ import annotations

import torch

from ...quant.dequant_math import dequant_q8_0
from . import K5, K5_I8, build
from .qmm import (aligned_x, check_cuda, check_shapes, check_x,
                  quantize_x_tiles, tile_fold)


def _check_weights(qs, d, k):
    n = qs.shape[0]
    check_shapes({"qs": (qs, (n, k), torch.int8),
                  "d": (d, (n, k // 32), torch.float32)})


def dequant(qs, d):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    n = qs.shape[0]
    return dequant_q8_0(d, qs.reshape(n, -1, 32)).reshape(n, -1)


# ------------------------------------------------------------------ K5

def qmm_q8_0_plain(x, qs, d):
    """Plain PyTorch K5: dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant(qs, d).T


def qmm_q8_0(x, qs, d):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q8_0 layout."""
    m, k = check_x(x, 128)
    _check_weights(qs, d, k)
    if not qs.is_cuda:
        return qmm_q8_0_plain(x, qs, d)
    x = aligned_x(x)
    y = torch.empty((m, qs.shape[0]), dtype=torch.float32, device=qs.device)
    check_cuda(x, qs, d)
    build.call("qmm_q8_0_f32", x.data_ptr(), qs.data_ptr(), d.data_ptr(),
               y.data_ptr(), m, qs.shape[0], k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K5.launches += 1
    return y


# ------------------------------------------------------------------ K5-i8

def prepare_i8(x, d):
    """The operands K5-i8 takes besides qs: (qx, ex, dsc_f, dw)."""
    qx, ex = quantize_x_tiles(x.float())
    dsc_f, _, dw = tile_fold(d, None, 4, 127.0)
    return qx, ex, dsc_f, dw


def expand_w8(qs, dsc_f):
    """int8 weights (N, K) with the folded scales: round_half_even(q·dsc')
    clipped to ±127 (qmm.py::_round_i8 on _qd_i8_kernel's expansion)."""
    n = qs.shape[0]
    w = qs.reshape(n, -1, 32).float() * dsc_f.reshape(n, -1, 1)
    return torch.clamp(torch.round(w), -127.0, 127.0).to(torch.int8).reshape(n, -1)


def qmm_q8_0_i8_plain(qs, qx, ex, dsc_f, dw):
    """Plain PyTorch K5-i8 on prepared operands. Each tile's integer dot
    runs as an f32 product of int8 values: every partial sum is an integer
    below 2^24, so it is exact in f32 whatever the summation order."""
    m, n = qx.shape[0], qs.shape[0]
    kt = ex.shape[1]
    w = expand_w8(qs, dsc_f).reshape(n, kt, 128).float()
    xq = qx.reshape(m, kt, 128).float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=qs.device)
    for t in range(kt):
        acc = acc + (xq[:, t] @ w[:, t].T) * ex[:, t:t + 1] * dw[None, :, t]
    return acc


def qmm_q8_0_i8(x, qs, d):
    """Integer Q8_0 matmul (prefill route): x (M, K) → (M, N) f32."""
    _, k = check_x(x, 128)
    _check_weights(qs, d, k)
    ops = prepare_i8(x, d)
    if not qs.is_cuda:
        return qmm_q8_0_i8_plain(qs, *ops)
    return launch_i8(qs, *ops)


def launch_i8(qs, qx, ex, dsc_f, dw):
    """Launch K5-i8 on prepared operands (CUDA tensors)."""
    qx, ex, dsc_f, dw = (t.contiguous() for t in (qx, ex, dsc_f, dw))
    check_cuda(qs, qx, ex, dsc_f, dw)
    m, (n, k) = qx.shape[0], qs.shape
    y = torch.empty((m, n), dtype=torch.float32, device=qs.device)
    build.call("qmm_q8_0_i8", qx.data_ptr(), ex.data_ptr(), qs.data_ptr(),
               dsc_f.data_ptr(), dw.data_ptr(), y.data_ptr(), m, n, k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K5_I8.launches += 1
    return y
