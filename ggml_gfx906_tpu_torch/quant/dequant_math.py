"""Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_0, Q8_1 and
Q8_K unpack and dequantization as torch functions.

The counterpart of ggml_gfx906_tpu/quant/dequant_math.py:19-178,
which is written against an `xp` array module that torch does not
satisfy. The arithmetic is the same, step for step, so the f32 results are
bit-identical to the JAX package's and to ggml's dequantize_row_*:

- Q4_0: w = (q − 8)·d; q − 8 is exact, so the one product rounds once;
- Q4_1, Q5_1: w = q·d + m; q (at most 5 bits) times d (an f16) is exact in
  f32, so w rounds once, at the sum, fused or not;
- Q5_0: w = (q − 16)·d, exact in f32;
- Q4_K: w = q·(d·sc) − dmin·m, each product and the difference rounded
  separately (never fused);
- Q5_K: as Q4_K with a fifth bit; d·sc, q·(d·sc) and dmin·m are all exact
  in f32 (f16 times 6 bits times 5 bits), so w rounds only at the
  difference, fused or not;
- Q6_K: w = (q − 32)·(d·sc); d (f16) times the int8 sc is exact in f32, so
  the one product rounds once whatever the order;
- Q8_0, Q8_1: w = q·d, exact in f32; Q8_K: w = q·d with an f32 d, one
  rounding;
- Q2_K: w = q·(d·(sc & 15)) − dmin·(sc >> 4); d·sc and dmin·m (f16 times
  4 bits) and q·(d·sc) (2 bits more) are exact in f32, so w rounds once,
  at the difference, fused or not;
- Q3_K: w = (q − 4·(1 − hbit))·(d·sc6), sc6 the signed 6-bit scale (the
  12-byte packing, minus 32); d·sc6 and the product are exact in f32.
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


def dequant_q4_0(d, qs) -> torch.Tensor:
    """d: (..., nb) f16/f32, qs: (..., nb, 16) u8 → (..., nb*32) f32. Byte j
    of a block holds element j in its low nibble, element j + 16 in its
    high nibble."""
    lo = (qs & 0xF).float() - 8.0
    hi = (qs >> 4).float() - 8.0
    y = torch.cat([lo, hi], dim=-1) * d.float()[..., None]
    return y.reshape(*y.shape[:-2], -1)


def dequant_q4_1(d, m, qs) -> torch.Tensor:
    """d/m: (..., nb) f16/f32, qs: (..., nb, 16) u8 → (..., nb*32) f32, in
    Q4_0's byte order."""
    q = torch.cat([(qs & 0xF).float(), (qs >> 4).float()], dim=-1)
    y = q * d.float()[..., None] + m.float()[..., None]
    return y.reshape(*y.shape[:-2], -1)


def _q5_high_bits(qh) -> torch.Tensor:
    """(..., nb, 4) u8 → (..., nb, 32) u8: element j's fifth bit at bit 4.
    The four bytes are one little-endian word whose bit j belongs to element
    j (the low nibbles of qs[j] for j < 16, the high nibbles of qs[j − 16]
    above); assembled byte by byte, as u32_from_bytes does, in int64 so that
    bit 31 does not sign-extend."""
    b = qh.to(torch.int64)
    word = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    j = torch.arange(32, dtype=torch.int64, device=qh.device)
    return (((word[..., None] >> j) & 1) << 4).to(torch.uint8)


def dequant_q5_0(d, qh, qs) -> torch.Tensor:
    """d: (..., nb) f16/f32, qh: (..., nb, 4) u8, qs: (..., nb, 16) u8 →
    (..., nb*32) f32."""
    xh = _q5_high_bits(qh)
    lo = ((qs & 0xF) | xh[..., :16]).to(torch.int32) - 16
    hi = ((qs >> 4) | xh[..., 16:]).to(torch.int32) - 16
    y = torch.cat([lo, hi], dim=-1).float() * d.float()[..., None]
    return y.reshape(*y.shape[:-2], -1)


def dequant_q5_1(d, m, qh, qs) -> torch.Tensor:
    """d/m: (..., nb) f16/f32, qh: (..., nb, 4) u8, qs: (..., nb, 16) u8 →
    (..., nb*32) f32."""
    xh = _q5_high_bits(qh)
    q = torch.cat([(qs & 0xF) | xh[..., :16], (qs >> 4) | xh[..., 16:]], dim=-1)
    y = q.float() * d.float()[..., None] + m.float()[..., None]
    return y.reshape(*y.shape[:-2], -1)


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


def dequant_q5_K(d, dmin, scales, qh, qs) -> torch.Tensor:
    """d/dmin: (..., nb) f16/f32, scales: (..., nb, 12) u8, qh: (..., nb, 32)
    u8, qs: (..., nb, 128) u8 → (..., nb*256) f32."""
    sc, m = unpack_scale_min_k4(scales)
    return dequant_q5_K_unpacked(d, dmin, sc, m, qh, qs)


def dequant_q5_K_unpacked(d, dmin, sc, m, qh, qs) -> torch.Tensor:
    """As dequant_q5_K, from already-unpacked 6-bit sc/m (..., nb, 8). qs
    byte 32g + l holds element 64g + l (low nibble, sub-block 2g) and 64g +
    32 + l (high nibble, sub-block 2g + 1); qh byte l holds their fifth bits
    at bits 2g and 2g + 1."""
    d_j = d.float()[..., None] * sc.float()          # (..., nb, 8)
    m_j = dmin.float()[..., None] * m.float()
    q = qs.reshape(*qs.shape[:-1], 4, 32)
    qhb = qh.reshape(*qh.shape[:-1], 1, 32)
    g = torch.arange(4, dtype=torch.uint8, device=qs.device)[:, None]
    q0 = ((q & 0xF) + ((qhb >> (2 * g)) & 1) * 16).float()
    q1 = ((q >> 4) + ((qhb >> (2 * g + 1)) & 1) * 16).float()
    qf = torch.stack([q0, q1], dim=-2)  # (..., nb, 4, 2, 32); subblock 2g+half
    y = (qf * d_j.reshape(*d_j.shape[:-1], 4, 2, 1)
         - m_j.reshape(*m_j.shape[:-1], 4, 2, 1))
    return y.reshape(*y.shape[:-4], -1)


def _shifts(device) -> torch.Tensor:
    """The 2-bit field shifts (0, 2, 4, 6) as a (4, 1) u8 column, built on
    `device` by a kernel (a host tensor copied there would cost every
    dequantization a transfer, and cannot be captured in a CUDA graph)."""
    return torch.arange(0, 8, 2, dtype=torch.uint8, device=device)[:, None]


def dequant_q6_K(d, ql, qh, scales) -> torch.Tensor:
    """d: (..., nb) f16/f32, ql: (..., nb, 128) u8, qh: (..., nb, 64) u8,
    scales: (..., nb, 16) i8 → (..., nb*256) f32. Element h*128 + 32*i + l
    of a superblock (half h, quarter i) takes the low (i = 0, 1) or high
    (i = 2, 3) nibble of ql byte h*64 + 32*(i % 2) + l and bits 2i..2i+1 of
    qh byte h*32 + l; its scale is scales[element // 16]."""
    qlr = ql.reshape(*ql.shape[:-1], 2, 2, 32)      # [half][byte-half][l]
    qhr = qh.reshape(*qh.shape[:-1], 2, 32)
    nib = torch.stack([qlr[..., 0, :] & 0xF, qlr[..., 1, :] & 0xF,
                       qlr[..., 0, :] >> 4, qlr[..., 1, :] >> 4], dim=-2)
    shift = _shifts(ql.device)
    bits = (qhr[..., None, :] >> shift) & 3            # (..., nb, 2, 4, 32)
    q = (nib | (bits << 4)).to(torch.int32) - 32
    dsc = d.float()[..., None] * scales.float()        # (..., nb, 16)
    y = (q.float().reshape(*q.shape[:-1], 2, 16)
         * dsc.reshape(*dsc.shape[:-1], 2, 4, 2, 1))   # [half][quarter][16-group]
    return y.reshape(*y.shape[:-5], -1)


def dequant_q8_0(d, qs) -> torch.Tensor:
    """d: (..., nb) f16/f32, qs: (..., nb, 32) i8 → (..., nb*32) f32. Also
    Q8_1's values (its block sum s is not read) and Q8_K's, with qs (...,
    nb, 256) and an f32 d (its bsums are not read)."""
    y = qs.float() * d.float()[..., None]
    return y.reshape(*y.shape[:-2], -1)


def dequant_q2_K(d, dmin, scales, qs) -> torch.Tensor:
    """d/dmin: (..., nb) f16/f32, scales: (..., nb, 16) u8 (scale in the low
    nibble, min in the high), qs: (..., nb, 64) u8 → (..., nb*256) f32. qs
    byte 32h + l holds element 128h + 32t + l at bits 2t..2t+1; element e's
    scale byte is scales[e // 16]."""
    dl = d.float()[..., None] * (scales & 0xF).float()      # (..., nb, 16)
    ml = dmin.float()[..., None] * (scales >> 4).float()
    q = qs.reshape(*qs.shape[:-1], 2, 1, 32)
    shift = _shifts(qs.device)
    qv = ((q >> shift) & 3).float()                          # (..., nb, 2, 4, 32)
    pre = qv.shape[:-3]
    y = (qv.reshape(*pre, 2, 4, 2, 16) * dl.reshape(*pre, 2, 4, 2, 1)
         - ml.reshape(*pre, 2, 4, 2, 1))
    return y.reshape(*y.shape[:-5], -1)


def unpack_q3_scales(scales: torch.Tensor) -> torch.Tensor:
    """(..., 12) u8 → (..., 16) int32 signed scales in [-32, 31]: the low
    nibbles of bytes 0..7, then their high nibbles, each with two high bits
    from byte 8 + j % 4 at bits 2·(j // 4)."""
    s = scales.to(torch.int32)
    low = torch.cat([s[..., 0:8] & 0xF, s[..., 0:8] >> 4], dim=-1)
    j = torch.arange(16, device=scales.device)
    hi = (s[..., 8 + j % 4] >> (2 * (j // 4)).to(torch.int32)) & 3
    return (low | (hi << 4)) - 32


def dequant_q3_K(d, hmask, scales, qs) -> torch.Tensor:
    """d: (..., nb) f16/f32, hmask: (..., nb, 32) u8, scales: (..., nb, 12)
    u8 packed, qs: (..., nb, 64) u8 → (..., nb*256) f32."""
    return dequant_q3_K_unpacked(d, hmask, unpack_q3_scales(scales), qs)


def dequant_q3_K_unpacked(d, hmask, sc, qs) -> torch.Tensor:
    """As dequant_q3_K, from unpacked signed scales sc (..., nb, 16). qs as
    Q2_K's; bit 4h + t of hmask byte l is element 128h + 32t + l's high
    bit, and q − 4 where it is clear."""
    dl = d.float()[..., None] * sc.float()                   # (..., nb, 16)
    q = qs.reshape(*qs.shape[:-1], 2, 1, 32)
    shift = _shifts(qs.device)
    qv = ((q >> shift) & 3).to(torch.int32)                  # (..., nb, 2, 4, 32)
    hm = hmask.reshape(*hmask.shape[:-1], 1, 1, 32)
    bit = (torch.arange(2, device=qs.device)[:, None] * 4
           + torch.arange(4, device=qs.device)[None, :]).reshape(2, 4, 1).to(torch.uint8)
    has_high = ((hm >> bit) & 1).to(torch.int32)
    qsigned = (qv - (1 - has_high) * 4).float()
    pre = qsigned.shape[:-3]
    y = qsigned.reshape(*pre, 2, 4, 2, 16) * dl.reshape(*pre, 2, 4, 2, 1)
    return y.reshape(*y.shape[:-5], -1)
