"""Q4_K unpack and dequantization as torch functions.

The counterpart of ggml_gfx906_tpu/quant/dequant_math.py:85-110, which is
written against an `xp` array module that torch does not satisfy. The
arithmetic is the same, step for step, so the f32 results are bit-identical
to the JAX package's and to ggml's dequantize_row_q4_K: w = q·(d·sc) − dmin·m,
with each product and the difference rounded separately (never fused).
"""
from __future__ import annotations

import torch


def unpack_scale_min_k4(scales: torch.Tensor):
    """(..., 12) uint8 → (sc (..., 8), m (..., 8)) uint8 6-bit values.
    ref: get_scale_min_k4 src/ggml-quants.c:703-711."""
    s03 = scales[..., 0:4] & 63
    m03 = scales[..., 4:8] & 63
    s47 = (scales[..., 8:12] & 0xF) | ((scales[..., 0:4] >> 6) << 4)
    m47 = (scales[..., 8:12] >> 4) | ((scales[..., 4:8] >> 6) << 4)
    return torch.cat([s03, s47], dim=-1), torch.cat([m03, m47], dim=-1)


def dequant_q4_K(d, dmin, scales, qs) -> torch.Tensor:
    """d/dmin: (..., nb) f16/f32, scales: (..., nb, 12) u8, qs: (..., nb, 128)
    u8 → (..., nb*256) f32."""
    sc, m = unpack_scale_min_k4(scales)
    return dequant_q4_K_unpacked(d, dmin, sc, m, qs)


def dequant_q4_K_unpacked(d, dmin, sc, m, qs) -> torch.Tensor:
    """As dequant_q4_K, from already-unpacked 6-bit sc/m (..., nb, 8)."""
    d_j = d.float()[..., None] * sc.float()          # (..., nb, 8)
    m_j = dmin.float()[..., None] * m.float()
    q = qs.reshape(*qs.shape[:-1], 4, 32)
    lo = (q & 0xF).float()
    hi = (q >> 4).float()
    qf = torch.stack([lo, hi], dim=-2)  # (..., nb, 4, 2, 32); subblock 2g+half
    y = (qf * d_j.reshape(*d_j.shape[:-1], 4, 2, 1)
         - m_j.reshape(*m_j.shape[:-1], 4, 2, 1))
    return y.reshape(*y.shape[:-4], -1)
