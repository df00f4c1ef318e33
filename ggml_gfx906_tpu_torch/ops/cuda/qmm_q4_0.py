"""Q4_0 matmul kernels K6 (f32, M < int8_min_m) and K6-i8 (int8, M >= it).

Kernel sources: csrc/qmm_legacy.cu (K6: the format Legacy<false, false> on
the shared f32 body csrc/qmm_f32_tiled.cuh, beside K8's formats) and
csrc/qmm_q4_0.cu (K6-i8); fuller notes there.

- K6 `qmm_q4_0` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_0.
  The C entry point picks the body's kernel by M: at M <= 8 (decode) lanes
  over the 32-element blocks with x staged in shared memory, bound by the
  weight bytes (5 bits per weight, read once); at larger M a block forms
  the weights (q − 8)·d of a tile once in shared memory for 32 or 64
  activation rows, bound by the f32 FMA rate. One summation order at
  every M (32 slots over the blocks, then the xor-butterfly tree), so a
  row's bits do not depend on M.
- K6-i8 `qmm_q4_0_i8` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::
  qmm_q4_0_i8 (_q40_i8_kernel). Bound on the H100: the weight bytes at
  M≈128, operations (int8) at large M, with the weights' expansion on the
  CUDA cores between them. Two launches per call, as K3's (qmm.py): one
  kernel splits and quantizes x per (row, 128-element tile) (the bits of
  `split_x` + `quantize_x_tiles`), then the int8 body
  (csrc/qmm_i8_tiled.cuh, format Q40I8) folds the block scales by the
  per-span bound and expands the nibbles to int8 in shared memory (the
  bits of `tile_fold` with dm None, 8 blocks per tile, qmax 8, and
  `expand_w8`), takes the integer dots on the int8 tensor cores
  (mma.sync) and adds the f32 epilogue in the reference's order. So its
  output has the bits of its plain version's order of operations at every
  M. `prepare_i8` forms the same operands in plain torch for the plain
  version.

Weight layout (ggml wire order, struct of arrays; see ops/quantized.py):
qs (N, K/2) u8, d (N, K/32) f32.

The int8 tiles group the same elements as the reference's: tile (lo, t) is
the first 16 elements of each of the 8 blocks of 256-span t, tile (hi, t)
their last 16 (qmm.py::q40_split_x) — the low and the high nibbles of qs
bytes [128t, 128t + 128). Here each tile is laid out in qs byte order, so
ex, the folded scales and the expanded int8 weights equal the reference's
bit for bit and qx equals it up to the order inside a tile.
"""
from __future__ import annotations

import torch

from ...quant.dequant_math import dequant_q4_0
from . import K6, K6_I8, build
from .qmm import (aligned_x, check_cuda, check_shapes, check_x, kernel_x,
                  quantize_x_tiles, tile_fold)


def _check_weights(qs, d, k):
    n = qs.shape[0]
    check_shapes({"qs": (qs, (n, k // 2), torch.uint8),
                  "d": (d, (n, k // 32), torch.float32)})


def dequant(qs, d):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    n = qs.shape[0]
    return dequant_q4_0(d, qs.reshape(n, -1, 16)).reshape(n, -1)


# ------------------------------------------------------------------ K6

def qmm_q4_0_plain(x, qs, d):
    """Plain PyTorch K6: dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant(qs, d).T


def qmm_q4_0(x, qs, d):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q4_0 layout."""
    m, k = check_x(x, 256)
    _check_weights(qs, d, k)
    if not qs.is_cuda:
        return qmm_q4_0_plain(x, qs, d)
    x = aligned_x(x)
    y = torch.empty((m, qs.shape[0]), dtype=torch.float32, device=qs.device)
    check_cuda(x, qs, d)
    build.call("qmm_q4_0_f32", x.data_ptr(), qs.data_ptr(), d.data_ptr(),
               y.data_ptr(), m, qs.shape[0], k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K6.launches += 1
    return y


# ------------------------------------------------------------------ K6-i8

def split_x(x):
    """x (M, K) → x_lo, x_hi (M, K/2): per 32-element block its first and
    its last 16 elements, in qs byte order (byte 16b + j of a span ↔
    element 32b + j, + 16 for hi)."""
    m, k = x.shape
    xr = x.reshape(m, k // 32, 2, 16)
    return xr[:, :, 0].reshape(m, k // 2), xr[:, :, 1].reshape(m, k // 2)


def prepare_i8(x, d):
    """The plain version's operands besides qs, in plain torch: (qxlo,
    exlo, qxhi, exhi, dsc_f, dw); on the card the kernels form the same
    bits themselves."""
    xlo, xhi = split_x(x.float())
    qxlo, exlo = quantize_x_tiles(xlo)
    qxhi, exhi = quantize_x_tiles(xhi)
    dsc_f, _, dw = tile_fold(d, None, 8, 8.0)
    return qxlo, exlo, qxhi, exhi, dsc_f, dw


def expand_w8(qs, dsc_f, high: bool):
    """Packed nibbles → int8 weights (N, K/2) in qs byte order, with the
    folded scales: round_half_even((q − 8)·dsc') clipped to ±127
    (qmm.py::_round_i8 on _q40_i8_kernel's expansion)."""
    n = qs.shape[0]
    q = (qs >> 4) if high else (qs & 0xF)
    w = (q.reshape(n, -1, 16).float() - 8.0) * dsc_f.reshape(n, -1, 1)
    return torch.clamp(torch.round(w), -127.0, 127.0).to(torch.int8).reshape(n, -1)


def qmm_q4_0_i8_plain(qs, qxlo, exlo, qxhi, exhi, dsc_f, dw):
    """Plain PyTorch K6-i8 on prepared operands. Each tile's integer dot
    runs as an f32 product of int8 values: every partial sum is an integer
    below 2^24, so it is exact in f32 whatever the summation order."""
    m, n = qxlo.shape[0], qs.shape[0]
    kt = exlo.shape[1]
    wlo = expand_w8(qs, dsc_f, False).reshape(n, kt, 128).float()
    whi = expand_w8(qs, dsc_f, True).reshape(n, kt, 128).float()
    xlo = qxlo.reshape(m, kt, 128).float()
    xhi = qxhi.reshape(m, kt, 128).float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=qs.device)
    for t in range(kt):
        acc = acc + (xlo[:, t] @ wlo[:, t].T) * exlo[:, t:t + 1] * dw[None, :, t]
        acc = acc + (xhi[:, t] @ whi[:, t].T) * exhi[:, t:t + 1] * dw[None, :, t]
    return acc


def quantize_x(x):
    """x (M, K) → (qxlo, exlo, qxhi, exhi), K6-i8's activation operands: on
    the card one kernel, on the CPU `split_x` + `quantize_x_tiles` (the
    same bits)."""
    m, k = check_x(x, 256)
    if not x.is_cuda:
        xlo, xhi = split_x(x.float())
        return (*quantize_x_tiles(xlo), *quantize_x_tiles(xhi))
    x = kernel_x(x)
    qx = torch.empty((2, m, k // 2), dtype=torch.int8, device=x.device)
    exlo, exhi = (torch.empty((m, k // 256), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    build.call("qmm_q4_0_i8_quant_x", x.data_ptr(), int(x.dtype == torch.bfloat16),
               qx[0].data_ptr(), exlo.data_ptr(), qx[1].data_ptr(), exhi.data_ptr(),
               m, k, torch.cuda.current_stream(x.device).cuda_stream)
    return qx[0], exlo, qx[1], exhi


def qmm_q4_0_i8(x, qs, d):
    """Integer Q4_0 matmul (prefill route): x (M, K) → (M, N) f32."""
    _, k = check_x(x, 256)
    _check_weights(qs, d, k)
    if not qs.is_cuda:
        return qmm_q4_0_i8_plain(qs, *prepare_i8(x, d))
    return launch_i8(qs, d, *quantize_x(x))


def launch_i8(qs, d, qxlo, exlo, qxhi, exhi):
    """Launch K6-i8's product on quantized x (CUDA tensors; quantize_x's
    output) and the Q4_0 weights as K6 takes them."""
    m, n, k = qxlo.shape[0], qs.shape[0], qs.shape[1] * 2
    _check_weights(qs, d, k)
    check_shapes({"qxlo": (qxlo, (m, k // 2), torch.int8), "qxhi": (qxhi, (m, k // 2), torch.int8),
                  "exlo": (exlo, (m, k // 256), torch.float32),
                  "exhi": (exhi, (m, k // 256), torch.float32)})
    check_cuda(qs, d, qxlo, exlo, qxhi, exhi)
    y = torch.empty((m, n), dtype=torch.float32, device=qs.device)
    build.call("qmm_q4_0_i8", qxlo.data_ptr(), exlo.data_ptr(), qxhi.data_ptr(),
               exhi.data_ptr(), qs.data_ptr(), d.data_ptr(), y.data_ptr(), m, n, k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K6_I8.launches += 1
    return y
