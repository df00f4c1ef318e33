"""Q6_K matmul kernel K4 (f32, every M: Q6_K has no int8 twin).

Kernel source: csrc/qmm_q6k.cu on the body it shares with K7,
csrc/qmm_f32_tiled.cuh (fuller notes there).

- K4 `qmm_q6_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q6_K.
  The C entry point picks the kernel by M. M <= 8 (decode): lanes over
  the K chunks, 2 weight rows per warp, x staged in shared memory per 32
  chunks; bound by the packed weight bytes (6.625 bits per weight, read
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
ql (N, K/2) u8, qh (N, K/4) u8, sc (N, K/16) i8, d (N, K/256) f32. The
superblock axis is not padded: the reference's pad to an even count
(qmm.py:734-746) serves its two-superblock chunks, which the port does not
have.
"""
from __future__ import annotations

import torch

from ...quant.dequant_math import dequant_q6_K
from . import K4, build
from .qmm import aligned_x, check_cuda, check_shapes, check_x


def _check_weights(ql, qh, sc, d, k):
    n, nb = ql.shape[0], k // 256
    check_shapes({"ql": (ql, (n, nb * 128), torch.uint8),
                  "qh": (qh, (n, nb * 64), torch.uint8),
                  "sc": (sc, (n, nb * 16), torch.int8),
                  "d": (d, (n, nb), torch.float32)})


def dequant(ql, qh, sc, d):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    n = ql.shape[0]
    return dequant_q6_K(d, ql.reshape(n, -1, 128), qh.reshape(n, -1, 64),
                        sc.reshape(n, -1, 16)).reshape(n, -1)


def qmm_q6_K_plain(x, ql, qh, sc, d):
    """Plain PyTorch K4: dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant(ql, qh, sc, d).T


def qmm_q6_K(x, ql, qh, sc, d):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q6_K layout."""
    m, k = check_x(x, 256)
    _check_weights(ql, qh, sc, d, k)
    if not ql.is_cuda:
        return qmm_q6_K_plain(x, ql, qh, sc, d)
    x = aligned_x(x)
    y = torch.empty((m, ql.shape[0]), dtype=torch.float32, device=ql.device)
    check_cuda(x, ql, qh, sc, d)
    build.call("qmm_q6k_f32", x.data_ptr(), ql.data_ptr(), qh.data_ptr(),
               sc.data_ptr(), d.data_ptr(), y.data_ptr(), m, ql.shape[0], k,
               torch.cuda.current_stream(ql.device).cuda_stream)
    K4.launches += 1
    return y
