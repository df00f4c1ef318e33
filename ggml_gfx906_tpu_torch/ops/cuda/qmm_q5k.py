"""Q5_K matmul kernel K7 (f32, every M: Q5_K has no int8 twin).

Kernel source: csrc/qmm_q5k.cu on the body it shares with K4,
csrc/qmm_f32_tiled.cuh (fuller notes there).

- K7 `qmm_q5_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q5_K.
  The C entry point picks the kernel by M. M <= 8 (decode): lanes over
  the K chunks, 2 weight rows per warp, x staged in shared memory per 32
  chunks; bound by the packed weight bytes (5.75 bits per weight, read
  once), then latency. M > 8 (prefill): a block dequantizes a 16- or
  32-row weight tile once into shared memory for 64 or 32 activation rows
  (128 accumulators per lane, 224 / 160 KB of shared memory), or, at
  M > 32 where 64 x 64 tiles keep more than half of the SMs busy, a
  lanes-as-outputs 64 x 64 tile (64 KB); bound by the f32 FMA rate, then
  shared memory and the L2 traffic of x. The ptxas lines chip_smoke.py
  prints give the registers.
- Reduction order: 32 slots over the K chunks (c ≡ slot mod 32, ascending,
  each chunk's 16 low then 16 high elements), then the xor-butterfly tree;
  fixed by K alone, so a row's bits are the same at every M and in every
  variant (engine streams equal `generate`'s). No TF32, no atomics.

Weight layout (ggml wire order, struct of arrays; see ops/quantized.py):
qs (N, K/2) u8, qh (N, K/8) u8, scm (N, K/16) u8 = unpacked [sc0..7 |
m0..7] per superblock, dd (N, K/128) f32 = [d, dmin] per superblock. The
superblock axis is not padded: the reference's pad to a multiple of four
(qmm.py:854-878) serves its four-superblock chunks, which the port does
not have.
"""
from __future__ import annotations

import torch

from ...quant.dequant_math import dequant_q5_K_unpacked
from . import K7, build
from .qmm import aligned_x, check_cuda, check_shapes, check_x


def _check_weights(qs, qh, scm, dd, k):
    n, nb = qs.shape[0], k // 256
    check_shapes({"qs": (qs, (n, nb * 128), torch.uint8),
                  "qh": (qh, (n, nb * 32), torch.uint8),
                  "scm": (scm, (n, nb * 16), torch.uint8),
                  "dd": (dd, (n, nb * 2), torch.float32)})


def dequant(qs, qh, scm, dd):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    n = qs.shape[0]
    s = scm.reshape(n, -1, 16)
    d = dd.reshape(n, -1, 2)
    return dequant_q5_K_unpacked(d[..., 0], d[..., 1], s[..., 0:8], s[..., 8:16],
                                 qh.reshape(n, -1, 32),
                                 qs.reshape(n, -1, 128)).reshape(n, -1)


def qmm_q5_K_plain(x, qs, qh, scm, dd):
    """Plain PyTorch K7: dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant(qs, qh, scm, dd).T


def qmm_q5_K(x, qs, qh, scm, dd):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q5_K layout."""
    m, k = check_x(x, 256)
    _check_weights(qs, qh, scm, dd, k)
    if not qs.is_cuda:
        return qmm_q5_K_plain(x, qs, qh, scm, dd)
    x = aligned_x(x)
    y = torch.empty((m, qs.shape[0]), dtype=torch.float32, device=qs.device)
    check_cuda(x, qs, qh, scm, dd)
    build.call("qmm_q5k_f32", x.data_ptr(), qs.data_ptr(), qh.data_ptr(),
               scm.data_ptr(), dd.data_ptr(), y.data_ptr(), m, qs.shape[0], k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K7.launches += 1
    return y
