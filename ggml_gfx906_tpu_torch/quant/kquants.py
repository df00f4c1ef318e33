"""K-quant superblock codecs: Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_K (QK_K = 256),
on tensors.

The port of ggml_gfx906_tpu/quant/kquants.py (ggml's quantize_row_q2_K_ref
:714, q3_K :1052, q4_K :1280, q5_K :1467, q6_K :1692, q8_K :2555; the
scale searches make_qx_quants :451, make_q3_quants :520, make_qkx2_quants
:622, make_qp_quants :899; the imatrix paths quantize_row_q*_K_impl
:972-1890 of src/ggml-quants.c). Every sum the reference accumulates in
order is a left-to-right f32 loop (numerics.seq_sum), every scalar
constant is rounded to f32 on the host exactly as numpy rounds it, and
every division is tensor by tensor, so the wire bytes equal the
reference's on the CPU and on the card. A quantizer takes f32 (..., n)
and returns (..., n/256, block bytes) uint8; a dequantizer takes such
blocks and returns (..., n) f32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import blocks, dequant_math as dqm
from .numerics import (const, f16_bytes, f16_from_bytes, fp16_round, min0, nearest_int,
                       seq_sum, signed_absmax, sqrt)
from .types import (BLOCK_Q2_K, BLOCK_Q3_K, BLOCK_Q4_K, BLOCK_Q5_K, BLOCK_Q6_K,
                    BLOCK_Q8_K, GROUP_MAX_EPS, QK_K)

_EPS = float(GROUP_MAX_EPS)


def _f32(v) -> float:
    """A host scalar rounded to f32 (numpy's np.float32 arithmetic)."""
    return float(np.float32(v))


def _rows(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    if x.shape[-1] % QK_K:
        raise ValueError(f"last dim {x.shape[-1]} is not a multiple of {QK_K}")
    return x.reshape(-1, QK_K)


def _out(x: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    return blk.reshape(*x.shape[:-1], x.shape[-1] // QK_K, blk.shape[-1])


# ------------------------------------------------------------------ helpers

def make_qx_quants(x, nmax: int, weights=None):
    """Weighted scale search, rmse_type = 1 (w = weights, or x² when None).
    x: (R, n) f32. Returns (scale (R,), L (R, n) f32 integers in [0,
    2·nmax − 1]). ref: make_qx_quants :451-518."""
    mx = signed_absmax(x)
    dead = torch.abs(mx) < _EPS
    w = x * x if weights is None else weights
    wx = w * x
    # |iscale·x| ≤ nmax wherever the row is alive (dead rows are reset below)
    L = torch.clamp(torch.round((const(-nmax, x) / mx)[:, None] * x), -nmax, nmax - 1)
    sumlx = seq_sum(wx * L)
    suml2 = seq_sum(w * L * L)
    scale = torch.where(suml2 != 0, sumlx / suml2, 0.0)
    best = scale * sumlx
    for is_ in range(-9, 10):
        if is_ == 0:
            continue
        num = _f32(-(np.float32(nmax) + np.float32(0.1) * np.float32(is_)))
        l2 = torch.clamp(torch.round((const(num, x) / mx)[:, None] * x), -nmax, nmax - 1)
        slx = seq_sum(wx * l2)
        sl2 = seq_sum(w * l2 * l2)
        upd = (sl2 > 0) & (slx * slx > best * sl2)
        L = torch.where(upd[:, None], l2, L)
        scale = torch.where(upd, slx / torch.where(upd, sl2, 1.0), scale)
        best = torch.where(upd, scale * slx, best)
    L = torch.where(dead[:, None], 0.0, L + nmax)
    return torch.where(dead, 0.0, scale), L


def _descend(x, w, L, sumlx, suml2, lo: int, hi: int, need_sl2: bool):
    """Five sweeps of per-element coordinate descent over the columns, each
    update feeding the running sums of the next element (make_q3_quants
    :540-571, make_qp_quants :938-965). Columns are contiguous rows here."""
    xt, wt, Lt = x.T.contiguous(), w.T.contiguous(), L.T.contiguous()
    for _ in range(5):
        for i in range(xt.shape[0]):
            wi, xi, li = wt[i], xt[i], Lt[i]
            slx = sumlx - wi * xi * li
            sl2 = suml2 - wi * li * li
            new_l = nearest_int(xi * sl2 / torch.where(slx > 0, slx, 1.0))
            new_l = torch.clamp(new_l, max=hi) if lo is None else torch.clamp(new_l, lo, hi)
            cand_slx = slx + wi * xi * new_l
            cand_sl2 = sl2 + wi * new_l * new_l
            ok = (slx > 0) & (new_l != li) \
                & ((sl2 > 0) if need_sl2 else (cand_sl2 > 0)) \
                & (cand_slx * cand_slx * suml2 > sumlx * sumlx * cand_sl2)
            Lt[i] = torch.where(ok, new_l, li)
            sumlx = torch.where(ok, cand_slx, sumlx)
            suml2 = torch.where(ok, cand_sl2, suml2)
    scale = torch.where(suml2 > 0, sumlx / torch.where(suml2 > 0, suml2, 1.0), 0.0)
    return scale, Lt.T


def make_q3_quants(x, nmax: int):
    """Scale search with per-element coordinate descent (do_rmse = true).
    x: (R, n). Returns (scale (R,), L (R, n) in [0, 2·nmax − 1]).
    ref: make_q3_quants :520-577."""
    mx = signed_absmax(x)
    dead = torch.abs(mx) < _EPS
    L = torch.clamp(nearest_int((const(-nmax, x) / mx)[:, None] * x), -nmax, nmax - 1)
    w = x * x
    sumlx = seq_sum(w * x * L)
    suml2 = seq_sum(w * L * L)
    scale, L = _descend(x, w, L, sumlx, suml2, -nmax, nmax - 1, need_sl2=False)
    L = torch.where(dead[:, None], 0.0, L + nmax)
    return torch.where(dead, 0.0, scale), L


def make_qkx2_quants(x, weights, nmax: int, rmin: float, rdelta: float, nstep: int,
                     use_mad: bool):
    """Affine (scale + min) grid search. x, weights: (R, n). Returns (scale
    (R,), the_min (R,), L (R, n) in [0, nmax]). `min` runs: a winning
    candidate's min feeds the next step's grid, as in the reference.
    ref: make_qkx2_quants :622-701."""
    xmin = x.amin(-1)
    mx = x.amax(-1)
    sum_w = seq_sum(weights)
    sum_x = seq_sum(weights * x)
    mn = min0(xmin)
    dead = mx == mn

    def error(scale, min_, lf):
        diff = scale[:, None] * lf + min_[:, None] - x
        return seq_sum(weights * (torch.abs(diff) if use_mad else diff * diff))

    # |iscale·(x − min)| ≤ nmax + 1: torch.round needs no int32 emulation
    span = torch.where(dead, 1.0, mx - mn)
    iscale = const(nmax, x) / span
    scale = const(1.0, x) / iscale
    L = torch.clamp(torch.round(iscale[:, None] * (x - mn[:, None])), 0, nmax)
    best_error = error(scale, mn, L)
    for is_ in range(nstep + 1):
        span = torch.where(dead, 1.0, mx - mn)
        num = _f32(np.float32(rmin) + np.float32(rdelta) * np.float32(is_) + np.float32(nmax))
        laux = torch.clamp(torch.round((const(num, x) / span)[:, None] * (x - mn[:, None])),
                           0, nmax)
        wl = weights * laux
        sum_l = seq_sum(wl)
        sum_l2 = seq_sum(wl * laux)
        sum_xl = seq_sum(wl * x)
        D = sum_w * sum_l2 - sum_l * sum_l
        Dd = torch.where(D > 0, D, 1.0)
        this_scale = (sum_w * sum_xl - sum_x * sum_l) / Dd
        this_min = (sum_l2 * sum_x - sum_l * sum_xl) / Dd
        pos = this_min > 0
        this_min = torch.where(pos, 0.0, this_min)
        this_scale = torch.where(pos, sum_xl / torch.where(sum_l2 != 0, sum_l2, 1.0),
                                 this_scale)
        cur_error = error(this_scale, this_min, laux)
        upd = (D > 0) & (cur_error < best_error)
        L = torch.where(upd[:, None], laux, L)
        best_error = torch.where(upd, cur_error, best_error)
        scale = torch.where(upd, this_scale, scale)
        mn = torch.where(upd, this_min, mn)
    L = torch.where(dead[:, None], 0.0, L)
    the_min = torch.where(dead, -min0(xmin), -mn)
    return torch.where(dead, 0.0, scale), the_min, L


def make_qp_quants(x, weight, nmax: int):
    """Weighted non-negative scale fit: a sweep of candidate scales, then up
    to five greedy coordinate-descent sweeps (a sweep that changes nothing
    is a fixed point, so five always match the early break). x, weight:
    (R, n), x ≥ 0. Returns (scale (R,), L (R, n) in [0, nmax]).
    ref: make_qp_quants :899-970."""
    maxv = x.amax(-1)
    dead = maxv < _EPS
    safe_max = torch.where(dead, 1.0, maxv)
    one = const(1.0, x)
    iscale = const(nmax, x) / safe_max
    diff = x - (one / iscale)[:, None] * nearest_int(iscale[:, None] * x)
    best_mse = seq_sum(weight * diff * diff)
    for is_ in range(-4, 5):
        if is_ == 0:
            continue
        isc = const(_f32(np.float32(0.1) * np.float32(is_) + np.float32(nmax)), x) / safe_max
        l = torch.clamp(nearest_int(isc[:, None] * x), max=nmax)
        diff = x - (one / isc)[:, None] * l
        mse = seq_sum(weight * diff * diff)
        upd = mse < best_mse
        best_mse = torch.where(upd, mse, best_mse)
        iscale = torch.where(upd, isc, iscale)
    L = torch.clamp(nearest_int(iscale[:, None] * x), max=nmax)
    sumlx = seq_sum(weight * x * L)
    suml2 = seq_sum(weight * L * L)
    scale, L = _descend(x, weight, L, sumlx, suml2, None, nmax, need_sl2=True)
    return torch.where(dead, 0.0, scale), torch.where(dead[:, None], 0.0, L)


def pack_scale_min_k4(ls, lm):
    """Pack 8 6-bit scales + 8 6-bit mins (..., 8) into 12 bytes: scale and
    min j < 4 in bytes j and j + 4 (low 6 bits), j ≥ 4 split into byte j + 4
    (low nibbles) and the top 2 bits of bytes j − 4 and j.
    ref: quantize_row_q4_K_ref packing :1312-1326. Numpy in, numpy out."""
    if isinstance(ls, np.ndarray):
        return pack_scale_min_k4(torch.from_numpy(np.asarray(ls, np.int64)),
                                 torch.from_numpy(np.asarray(lm, np.int64))).numpy()
    s, m = blocks.u8(ls), blocks.u8(lm)
    return torch.cat([s[..., :4] | ((s[..., 4:] >> 4) << 6),
                      m[..., :4] | ((m[..., 4:] >> 4) << 6),
                      (s[..., 4:] & 0xF) | ((m[..., 4:] & 0xF) << 4)], dim=-1)


def pack_q3_scales(sc):
    """Pack (..., 16) signed 6-bit scales (−32..31) into Q3_K's 12 bytes: the
    low nibbles of scales j and j + 8 in byte j (j < 8), the two high bits of
    scale j at bits 2·(j // 4) of byte 8 + j % 4. ref: the packing in
    quantize_row_q3_K_ref :1052-1126. Numpy in, numpy out."""
    if isinstance(sc, np.ndarray):
        return pack_q3_scales(torch.from_numpy(np.asarray(sc, np.int64))).numpy()
    lv = blocks.u8(sc + 32)
    low = (lv[..., :8] & 0xF) | ((lv[..., 8:] & 0xF) << 4)
    hi = (lv >> 4).reshape(*lv.shape[:-1], 4, 4)            # [j // 4][j % 4]
    top = hi[..., 0, :] | (hi[..., 1, :] << 2) | (hi[..., 2, :] << 4) | (hi[..., 3, :] << 6)
    return torch.cat([low, top], dim=-1)


def _requant_affine(x, d_dec, dm_dec, L, qmax: int, sub: int):
    """Requantize against the decoded scales; keep the search's L where a
    decoded scale is zero (the reference's `if (!d) continue;`)."""
    nb = x.shape[0]
    xs = x.reshape(nb, -1, sub)
    l = torch.clamp(nearest_int((xs + dm_dec[..., None])
                                / torch.where(d_dec != 0, d_dec, 1.0)[..., None]), 0, qmax)
    return torch.where((d_dec == 0)[..., None], L.reshape(nb, -1, sub), l).reshape(nb, -1)


def _requant_signed(xr, d_dec, L, lo: int, hi: int, sub: int):
    """As _requant_affine for the symmetric types: clip(round(x / d), lo,
    hi) − lo; L where d is zero."""
    nb = xr.shape[0]
    xs = xr.reshape(nb, -1, sub)
    l = torch.clamp(nearest_int(xs / torch.where(d_dec != 0, d_dec, 1.0)[..., None]),
                    lo, hi) - lo
    return torch.where((d_dec == 0)[..., None], L.reshape(nb, -1, sub), l).reshape(nb, -1)


def _pack_2bit(L):
    """(nb, 256) 2-bit values → (nb, 64) bytes: element 128h + 32t + l at
    bits 2t of byte 32h + l."""
    g = blocks.u8(L).reshape(L.shape[0], 2, 4, 32)
    return (g[:, :, 0] | (g[:, :, 1] << 2) | (g[:, :, 2] << 4)
            | (g[:, :, 3] << 6)).reshape(L.shape[0], 64)


def _pack_q45(L, nmax: int):
    """(nb, 256) values → Q4_K/Q5_K qs (nb, 128) (and Q5_K's qh (nb, 32)):
    per 64-group g, elements l and 32 + l in the low and high nibble of byte
    32g + l, their fifth bits at bits 2g and 2g + 1 of qh byte l."""
    nb = L.shape[0]
    g = blocks.u8(L).reshape(nb, 4, 2, 32)
    hi = (g > 15).to(torch.uint8) if nmax > 15 else torch.zeros_like(g)
    lo = g - 16 * hi
    qs = (lo[:, :, 0] | (lo[:, :, 1] << 4)).reshape(nb, 128)
    shift = torch.arange(8, dtype=torch.uint8, device=L.device).reshape(4, 2, 1)
    qh = (hi << shift).to(torch.int32).sum((1, 2)).to(torch.uint8)
    return qs, qh


def _hmask(L):
    """(nb, 256) Q3_K values → the high bits (L > 3) at bit e // 32 of
    byte e % 32, and the low two bits."""
    nb = L.shape[0]
    high = (L > 3).to(torch.int32)
    bits = torch.arange(8, dtype=torch.int32, device=L.device)[None, :, None]
    hm = (high.reshape(nb, 8, 32) << bits).sum(1).to(torch.uint8)
    return hm, L - 4 * high


def _scale_min_decode(d16, dmin16, packed):
    sc, m = dqm.unpack_scale_min_k4(packed)
    return (fp16_round(d16)[:, None] * sc.to(torch.float32),
            fp16_round(dmin16)[:, None] * m.to(torch.float32))


def _inv63(v):
    return torch.where(v > 0, const(63.0, v) / torch.where(v > 0, v, 1.0), 0.0)


# ------------------------------------------------------------------ Q4_K / Q5_K

def _quantize_q45_K(x, nmax: int, rmin: float, nstep: int, dtype):
    """ref: quantize_row_q4_K_ref :1280-1350, quantize_row_q5_K_ref
    :1467-1552 (they differ in nmax, the search grid and the packing)."""
    xr = _rows(x)
    nb = xr.shape[0]
    sb = xr.reshape(nb * 8, 32)
    av_x = sqrt(seq_sum(sb * sb) / const(32.0, sb))
    scales, mins, L = make_qkx2_quants(sb, av_x[:, None] + torch.abs(sb), nmax, rmin, 0.1,
                                       nstep, False)
    scales, mins = scales.reshape(nb, 8), mins.reshape(nb, 8)
    max_scale = scales.amax(-1) + 0.0     # + 0.0 turns −0 into +0 (C's strict > from 0)
    max_min = mins.amax(-1) + 0.0
    ls = torch.clamp(nearest_int(_inv63(max_scale)[:, None] * scales), max=63)
    lm = torch.clamp(nearest_int(_inv63(max_min)[:, None] * mins), max=63)
    packed = pack_scale_min_k4(ls, lm)
    d = max_scale / const(63.0, xr)
    dmin = max_min / const(63.0, xr)
    d_dec, dm_dec = _scale_min_decode(d, dmin, packed)
    L = _requant_affine(xr, d_dec, dm_dec, L.reshape(nb, 256), nmax, 32)
    return _join_q45(x, dtype, nmax, d, dmin, packed, L)


def _join_q45(x, dtype, nmax, d, dmin, packed, L):
    qs, qh = _pack_q45(L, nmax)
    f = {"d": f16_bytes(d), "dmin": f16_bytes(dmin), "scales": packed, "qs": qs}
    if nmax > 15:
        f["qh"] = qh
    return _out(x, blocks.join(dtype, **f))


def quantize_q4_K(x):
    return _quantize_q45_K(x, 15, -1.0, 20, BLOCK_Q4_K)


def quantize_q5_K(x):
    return _quantize_q45_K(x, 31, -0.5, 15, BLOCK_Q5_K)


def dequantize_q4_K(raw):
    f = blocks.split(raw, BLOCK_Q4_K)
    return dqm.dequant_q4_K(f16_from_bytes(f["d"]), f16_from_bytes(f["dmin"]), f["scales"],
                            f["qs"])


def dequantize_q5_K(raw):
    f = blocks.split(raw, BLOCK_Q5_K)
    return dqm.dequant_q5_K(f16_from_bytes(f["d"]), f16_from_bytes(f["dmin"]), f["scales"],
                            f["qh"], f["qs"])


# ------------------------------------------------------------------ Q6_K

def quantize_q6_K(x):
    """ref: quantize_row_q6_K_ref :1692-1760."""
    return _quantize_q6_K_rows(x, _rows(x), None)


def _quantize_q6_K_rows(x, xr, weights16):
    """Shared core: weights16 None (the unweighted path) or the raw
    importance row per 16-group ((R·16, 16), the imatrix path :1793-1878)."""
    nb = xr.shape[0]
    scales, L = make_qx_quants(xr.reshape(nb * 16, 16), 32, weights16)
    scales = scales.reshape(nb, 16)
    max_scale = signed_absmax(scales)
    dead = torch.abs(max_scale) < _EPS
    iscale = const(-128.0, xr) / torch.where(dead, 1.0, max_scale)
    d = const(1.0, xr) / iscale
    sc8 = torch.clamp(nearest_int(iscale[:, None] * scales), max=127)
    d_dec = fp16_round(d)[:, None] * sc8
    L = _requant_signed(xr, d_dec, L, -32, 31, 16)
    d = torch.where(dead, 0.0, fp16_round(d))
    sc8 = torch.where(dead[:, None], 0.0, sc8)
    Lh = blocks.u8(torch.where(dead[:, None], 0.0, L)).reshape(nb, 2, 4, 32)
    ql = torch.cat([(Lh[:, :, 0] & 0xF) | ((Lh[:, :, 2] & 0xF) << 4),
                    (Lh[:, :, 1] & 0xF) | ((Lh[:, :, 3] & 0xF) << 4)], dim=-1)
    qh = ((Lh[:, :, 0] >> 4) | ((Lh[:, :, 1] >> 4) << 2) | ((Lh[:, :, 2] >> 4) << 4)
          | ((Lh[:, :, 3] >> 4) << 6))
    return _out(x, blocks.join(BLOCK_Q6_K, ql=ql.reshape(nb, 128), qh=qh.reshape(nb, 64),
                               scales=blocks.u8(sc8), d=f16_bytes(d)))


def dequantize_q6_K(raw):
    f = blocks.split(raw, BLOCK_Q6_K)
    return dqm.dequant_q6_K(f16_from_bytes(f["d"]), f["ql"], f["qh"],
                            f["scales"].contiguous().view(torch.int8))


# ------------------------------------------------------------------ Q2_K

def _join_q2(x, d, dmin, scales, L):
    nb = L.shape[0]
    return _out(x, blocks.join(BLOCK_Q2_K, scales=scales, qs=_pack_2bit(L),
                               d=f16_bytes(d), dmin=f16_bytes(dmin)).reshape(nb, -1))


def quantize_q2_K(x):
    """ref: quantize_row_q2_K_ref :714-782."""
    xr = _rows(x)
    nb = xr.shape[0]
    sb = xr.reshape(nb * 16, 16)
    scales, mins, L = make_qkx2_quants(sb, torch.abs(sb), 3, -0.5, 0.1, 15, True)
    scales, mins = scales.reshape(nb, 16), mins.reshape(nb, 16)
    max_scale = scales.amax(-1) + 0.0
    max_min = mins.amax(-1) + 0.0
    q4 = const(15.0, xr)

    def code(mx, v):
        pos = mx > 0
        c = torch.where(pos[:, None],
                        nearest_int((q4 / torch.where(pos, mx, 1.0))[:, None] * v), 0.0)
        return blocks.u8(c), torch.where(pos, fp16_round(mx / q4), 0.0)

    sc4, d = code(max_scale, scales)
    lm4, dmin = code(max_min, mins)
    packed = sc4 | (lm4 << 4)
    d_dec = d[:, None] * (packed & 0xF).to(torch.float32)
    dm_dec = dmin[:, None] * (packed >> 4).to(torch.float32)
    L = _requant_affine(xr, d_dec, dm_dec, L.reshape(nb, 256), 3, 16)
    return _join_q2(x, d, dmin, packed, L)


def dequantize_q2_K(raw):
    f = blocks.split(raw, BLOCK_Q2_K)
    return dqm.dequant_q2_K(f16_from_bytes(f["d"]), f16_from_bytes(f["dmin"]), f["scales"],
                            f["qs"])


# ------------------------------------------------------------------ Q3_K

def _join_q3(x, xr, d16, Ls, L, signed_offset: int):
    """Pack the 6-bit scales Ls (0..63), requantize against the decoded
    scales, pack hmask and qs. L is the search's result (signed_offset = 4
    where it was stored as signed −4..3)."""
    nb = xr.shape[0]
    packed = pack_q3_scales(Ls - 32)
    d_dec = d16[:, None] * dqm.unpack_q3_scales(packed).to(torch.float32)
    L = _requant_signed(xr, d_dec, L + signed_offset, -4, 3, 16)
    hm, lo = _hmask(L)
    return _out(x, blocks.join(BLOCK_Q3_K, hmask=hm, qs=_pack_2bit(lo), scales=packed,
                               d=f16_bytes(d16)).reshape(nb, -1))


def quantize_q3_K(x):
    """ref: quantize_row_q3_K_ref :1052-1126."""
    xr = _rows(x)
    nb = xr.shape[0]
    scales, L = make_q3_quants(xr.reshape(nb * 16, 16), 4)
    scales = scales.reshape(nb, 16)
    max_scale = signed_absmax(scales)
    alive = torch.abs(max_scale) != 0
    iscale = const(-32.0, xr) / torch.where(alive, max_scale, 1.0)
    l6 = torch.clamp(nearest_int(iscale[:, None] * scales), -32, 31) + 32
    l6 = torch.where(alive[:, None], l6, 0.0)
    d16 = torch.where(alive, fp16_round(const(1.0, xr) / iscale), 0.0)
    return _join_q3(x, xr, d16, l6, (L - 4).reshape(nb, 256), 4)


def dequantize_q3_K(raw):
    f = blocks.split(raw, BLOCK_Q3_K)
    return dqm.dequant_q3_K(f16_from_bytes(f["d"]), f["hmask"], f["scales"], f["qs"])


# ------------------------------------------------------------------ Q8_K

def quantize_q8_K(x):
    """ref: quantize_row_q8_K_ref :2555-2593."""
    xr = _rows(x)
    nb = xr.shape[0]
    mx = signed_absmax(xr)
    alive = torch.abs(mx) != 0
    iscale = const(-127.0, xr) / torch.where(alive, mx, 1.0)
    qs = torch.where(alive[:, None],
                     torch.clamp(nearest_int(iscale[:, None] * xr), max=127), 0.0)
    d = torch.where(alive, const(1.0, xr) / iscale, 0.0)
    bsums = qs.reshape(nb, 16, 16).sum(-1)           # integers: exact in any order
    return _out(x, blocks.join(BLOCK_Q8_K, d=d.unsqueeze(-1).view(torch.uint8),
                               qs=blocks.u8(qs),
                               bsums=blocks.le_bytes(bsums, 2).reshape(nb, 32)))


def dequantize_q8_K(raw):
    f = blocks.split(raw, BLOCK_Q8_K)
    d = f["d"].contiguous().view(torch.float32)[..., 0]
    return dqm.dequant_q8_0(d, f["qs"].contiguous().view(torch.int8))


# ------------------------------------------------------- imatrix variants
#
# With an importance row every type switches to a weighted scale search
# (quantize_row_q*_K_impl, src/ggml-quants.c:972-1890); every tensor row
# reuses the same importance row, as the reference's chunk API does.

def _qw_superblocks(x, quant_weights):
    """(xr (R, 256), qwr (R, 256)): each superblock's slice of the row."""
    xr = _rows(x)
    n = x.shape[-1]
    qw = quant_weights.to(device=x.device, dtype=torch.float32).reshape(-1)
    if qw.numel() != n:
        raise ValueError(f"importance row of {qw.numel()} for rows of {n}")
    qwr = qw.reshape(1, n // QK_K, QK_K).expand(xr.shape[0] * QK_K // n, -1, -1)
    return xr, qwr.reshape(-1, QK_K)


def _sigma_weights(xr, qwr, sigma2, sub: int):
    """weight[l] = qw[l] · sqrt(sigma2 + x[l]²) per `sub`-wide group →
    (groups (R·256/sub, sub), weights, group sums (R, 256/sub))."""
    g = QK_K // sub
    sb = xr.reshape(-1, sub)
    weights = qwr.reshape(-1, sub) * sqrt(sigma2.repeat_interleave(g)[:, None] + sb * sb)
    return sb, weights, seq_sum(weights).reshape(-1, g)


def _sigma2(xr, factor: float):
    s = seq_sum(xr * xr)
    if factor != 1.0:
        s = const(factor, xr) * s
    return s / const(float(QK_K), xr)


def quantize_q2_K_imatrix(x, quant_weights):
    """ref: quantize_row_q2_K_impl :972-1032."""
    xr, qwr = _qw_superblocks(x, quant_weights)
    nb = xr.shape[0]
    sb, weights, sw = _sigma_weights(xr, qwr, _sigma2(xr, 1.0), 16)
    scales, mins, L = make_qkx2_quants(sb, weights, 3, -0.9, 0.05, 36, False)
    dm, Ls = make_qp_quants(scales.reshape(nb, 16), sw, 15)
    mm, Lm = make_qp_quants(mins.reshape(nb, 16), sw, 15)
    packed = blocks.u8(Ls) | (blocks.u8(Lm) << 4)
    d, dmin = fp16_round(dm), fp16_round(mm)
    d_dec = d[:, None] * (packed & 0xF).to(torch.float32)
    dm_dec = dmin[:, None] * (packed >> 4).to(torch.float32)
    L = _requant_affine(xr, d_dec, dm_dec, L.reshape(nb, 256), 3, 16)
    return _join_q2(x, d, dmin, packed, L)


def quantize_q3_K_imatrix(x, quant_weights):
    """ref: quantize_row_q3_K_impl :1178-1260."""
    xr, qwr = _qw_superblocks(x, quant_weights)
    nb = xr.shape[0]
    sb, weights, sw = _sigma_weights(xr, qwr, _sigma2(xr, 2.0), 16)
    scales, L = make_qx_quants(sb, 4, weights)
    d_block, Ls = make_qx_quants(scales.reshape(nb, 16), 32, sw)
    return _join_q3(x, xr, fp16_round(d_block), Ls, L.reshape(nb, 256), 0)


def _quantize_q45_K_imatrix(x, quant_weights, nmax: int, dtype):
    """ref: quantize_row_q4_K_impl :1376-1448, quantize_row_q5_K_impl
    :1580-1672."""
    xr, qwr = _qw_superblocks(x, quant_weights)
    nb = xr.shape[0]
    sb, weights, sw = _sigma_weights(xr, qwr, _sigma2(xr, 2.0), 32)
    scales, mins, L = make_qkx2_quants(sb, weights, nmax, -0.9, 0.05, 36, False)
    d_block, Ls = make_qp_quants(scales.reshape(nb, 8), sw, 63)
    m_block, Lm = make_qp_quants(mins.reshape(nb, 8), sw, 63)
    packed = pack_scale_min_k4(Ls, Lm)
    d_dec, dm_dec = _scale_min_decode(d_block, m_block, packed)
    L = _requant_affine(xr, d_dec, dm_dec, L.reshape(nb, 256), nmax, 32)
    return _join_q45(x, dtype, nmax, d_block, m_block, packed, L)


def quantize_q4_K_imatrix(x, quant_weights):
    return _quantize_q45_K_imatrix(x, quant_weights, 15, BLOCK_Q4_K)


def quantize_q5_K_imatrix(x, quant_weights):
    return _quantize_q45_K_imatrix(x, quant_weights, 31, BLOCK_Q5_K)


def quantize_q6_K_imatrix(x, quant_weights):
    """ref: quantize_row_q6_K_impl :1793-1878: the unweighted path with the
    raw importance row as make_qx_quants' weights."""
    xr, qwr = _qw_superblocks(x, quant_weights)
    return _quantize_q6_K_rows(x, xr, qwr.reshape(-1, 16))
