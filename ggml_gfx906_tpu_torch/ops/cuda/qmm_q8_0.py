"""Q8_0 matmul kernels K5 (f32, M < int8_min_m) and K5-i8 (int8, M >= it).

Kernel source: csrc/qmm_q8_0.cu (fuller notes there).

- K5 `qmm_q8_0` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q8_0.
  Bound on the H100: bytes at decode (the weights, 9 bits per weight, are
  read once), the f32 FMA rate at larger M. Design: the format `Q80` on the
  shared f32 body (csrc/qmm_f32_tiled.cuh, as K1, K4, K6, K7, K8 and K9): a
  32-element block is one body chunk, its quants 0..15 the lo run and
  16..31 the hi run; the body picks its kernel by M and sums every output
  in one order fixed by K alone, so a row's bits do not depend on M.
- K5-i8 `qmm_q8_0_i8` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::
  qmm_q8_0_i8 (_qd_i8_kernel with nblk=4). Bound on the H100: the weight
  bytes at M≈128, operations (int8) at large M, with the weights'
  expansion on the CUDA cores between them. Two launches per call, as K3's
  (qmm.py): one kernel quantizes x per (row, 128-element tile) (the bits
  of `quantize_x_tiles`), then the int8 body (csrc/qmm_i8_tiled.cuh,
  format Q80I8) folds the block scales by the per-tile bound and expands
  the quants to int8 in shared memory (the bits of `tile_fold` with dm
  None, qmax 127, and `expand_w8`), takes the integer dots on the int8
  tensor cores (mma.sync) and adds the f32 epilogue in the reference's
  order. So its output has the bits of its plain version's order of
  operations at every M. `prepare_i8` forms the same operands in plain
  torch for the plain version.

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
from .qmm import (aligned_x, check_cuda, check_shapes, check_x, kernel_x,
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
    """The plain version's operands besides qs, in plain torch: (qx, ex,
    dsc_f, dw); on the card the kernels form the same bits themselves."""
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


def quantize_x(x):
    """x (M, K) → (qx, ex), K5-i8's activation operands: on the card one
    kernel, on the CPU `quantize_x_tiles` (the same bits)."""
    m, k = check_x(x, 128)
    if not x.is_cuda:
        return quantize_x_tiles(x.float())
    x = kernel_x(x)
    qx = torch.empty((m, k), dtype=torch.int8, device=x.device)
    ex = torch.empty((m, k // 128), dtype=torch.float32, device=x.device)
    build.call("qmm_q8_0_i8_quant_x", x.data_ptr(), int(x.dtype == torch.bfloat16),
               qx.data_ptr(), ex.data_ptr(), m, k,
               torch.cuda.current_stream(x.device).cuda_stream)
    return qx, ex


def qmm_q8_0_i8(x, qs, d):
    """Integer Q8_0 matmul (prefill route): x (M, K) → (M, N) f32."""
    _, k = check_x(x, 128)
    _check_weights(qs, d, k)
    if not qs.is_cuda:
        return qmm_q8_0_i8_plain(qs, *prepare_i8(x, d))
    return launch_i8(qs, d, *quantize_x(x))


def launch_i8(qs, d, qx, ex):
    """Launch K5-i8's product on quantized x (CUDA tensors; quantize_x's
    output) and the Q8_0 weights as K5 takes them."""
    m, (n, k) = qx.shape[0], qs.shape
    _check_weights(qs, d, k)
    check_shapes({"qx": (qx, (m, k), torch.int8),
                  "ex": (ex, (m, k // 128), torch.float32)})
    check_cuda(qs, d, qx, ex)
    y = torch.empty((m, n), dtype=torch.float32, device=qs.device)
    build.call("qmm_q8_0_i8", qx.data_ptr(), ex.data_ptr(), qs.data_ptr(), d.data_ptr(),
               y.data_ptr(), m, n, k, torch.cuda.current_stream(qs.device).cuda_stream)
    K5_I8.launches += 1
    return y
