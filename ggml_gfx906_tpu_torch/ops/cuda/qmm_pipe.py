"""Q4_K single-stream decode matvec K10 (`qmm_pipeline`, M = 1).

Kernel source: csrc/qmm_q4k_pipe.cu (fuller notes there).

- K10 `qmm_q4_K_pipelined` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::
  qmm_q4_K_pipelined. Bound on the H100: bytes — the packed weights (~0.59
  B per weight) are read once. Design: the counterpart of the reference's
  DMA ring. One persistent block per SM owns a contiguous, even share of
  the rows; a producer warp streams them in tiles of 16 rows (8 from K =
  10240, 2 above K = 16896), three 1-D bulk copies a tile (qs, scm, dd), into a
  two-stage ring in shared memory guarded by mbarriers; consumer warps, two
  rows each (one in the 2-row tiles), sum from there against x, staged once
  per block as bf16 values in f32 with its 16-element f32 sums, and apply
  the scales to per-(row, group) partial sums, in the order of the
  earlier register-load design (the same bits). On the card N must be
  even and K at most 34816.

It is not K1's function: x is rounded to bf16 (round half to even) for the
sums of nibble · x, as the reference's MXU dots take it, and the min term
uses the f32 x:

    y[n] = Σ_g d·(sc_2g·S_lo[g] + sc_2g+1·S_hi[g])
         − Σ_g dmin·(m_2g·X_lo[g] + m_2g+1·X_hi[g])

with S the per-(row, 32-group) sums of q · bf16(x) in f32 and X the group
sums of x in f32. The kernel computes the min term in the same pass (the
reference computes it outside its kernel, qmm.py:371-376); the plain
version keeps the reference's order: both sums, then the difference. When
x holds bf16 values the rounding is exact and K10 differs from K1 only in
summation order; a model's activations reach it in f32 (its f32 norm
weights promote them), so there the two differ by the rounding.

Weight layout: the port's Q4_K fields (ops/cuda/qmm.py).
"""
from __future__ import annotations

import torch

from . import K10, build
from .qmm import aligned_x, check_cuda, check_q4k_weights, check_x


def qmm_q4_K_pipelined_plain(x, qs, scm, dd):
    """Plain PyTorch K10: the per-(row, group) sums, scaled, minus the min
    term, in the reference's order."""
    n, k = qs.shape[0], x.shape[1]
    nb = k // 256
    xf = x.float().reshape(nb, 4, 2, 32)                 # (sb, g, half, j)
    xb = x.to(torch.bfloat16).float().reshape(nb, 4, 2, 32)
    q = qs.reshape(n, nb, 4, 32)
    s_lo = ((q & 0xF).float() * xb[:, :, 0]).sum(-1)     # (n, sb, g)
    s_hi = ((q >> 4).float() * xb[:, :, 1]).sum(-1)
    s = scm.reshape(n, nb, 16).float()
    d = dd.reshape(n, nb, 2)
    main = (d[..., 0:1] * (s[..., 0:8:2] * s_lo + s[..., 1:8:2] * s_hi)).sum((-1, -2))
    dml = s[..., 8::2] * d[..., 1:2]
    dmh = s[..., 9::2] * d[..., 1:2]
    mn = ((dml * xf[:, :, 0].sum(-1)).sum((-1, -2))
          + (dmh * xf[:, :, 1].sum(-1)).sum((-1, -2)))
    return (main - mn)[None, :]


def qmm_q4_K_pipelined(x, qs, scm, dd):
    """x (1, K) @ W(N, K).T → (1, N) f32, W in the port's Q4_K layout."""
    m, k = check_x(x, 256)
    if m != 1:
        raise ValueError(f"the pipelined decode matvec takes one row, got M={m}")
    check_q4k_weights(qs, scm, dd, k)
    if not qs.is_cuda:
        return qmm_q4_K_pipelined_plain(x, qs, scm, dd)
    n = qs.shape[0]
    if n % 2:
        raise ValueError(f"the pipelined decode matvec streams row pairs, got N={n}")
    x = aligned_x(x)
    y = torch.empty((1, n), dtype=torch.float32, device=qs.device)
    check_cuda(x, qs, scm, dd)
    build.call("qmm_q4k_pipe", x.data_ptr(), qs.data_ptr(), scm.data_ptr(),
               dd.data_ptr(), y.data_ptr(), n, k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K10.launches += 1
    return y
