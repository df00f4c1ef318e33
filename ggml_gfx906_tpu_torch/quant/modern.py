"""MXFP4, ternary (TQ1_0 / TQ2_0) and IQ4 non-linear codecs, on tensors.

The port of ggml_gfx906_tpu/quant/modern.py (ggml: MXFP4 src/ggml-quants.c
:260-306 and :417-432 with the e8m0 helpers of src/ggml-impl.h:430-470;
TQ1_0 / TQ2_0 :2103-2270; IQ4_NL / IQ4_XS quantize_row_iq4_nl_impl
:4638-4812), the same f32 operations in the same order. A quantizer takes
f32 (..., n) and returns (..., n/block, block bytes) uint8; a dequantizer
takes such blocks and returns (..., n) f32.
"""
from __future__ import annotations

import functools

import torch

from . import blocks
from .numerics import (const, f16_bytes, f16_from_bytes, nearest_int, seq_sum, signed_absmax,
                       sqrt)
from .types import (BLOCK_IQ4_NL, BLOCK_IQ4_XS, BLOCK_MXFP4, BLOCK_TQ1_0, BLOCK_TQ2_0,
                    GROUP_MAX_EPS, QK_K, QK_MXFP4, QK4_NL)

# e2m1 values doubled (OCP MX spec): 8 positives, then their negatives
KVALUES_MXFP4 = (0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12)
# the non-linear 4-bit codebook, ascending
KVALUES_IQ4NL = (-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113)


@functools.cache
def _table(values: tuple, device: torch.device) -> torch.Tensor:
    """A codebook as f32 on `device` (copied there once)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _blocked(x: torch.Tensor, qk: int) -> torch.Tensor:
    x = x.to(torch.float32)
    if x.shape[-1] % qk:
        raise ValueError(f"last dim {x.shape[-1]} is not a multiple of {qk}")
    return x.reshape(-1, qk)


def _out(x: torch.Tensor, qk: int, blk: torch.Tensor) -> torch.Tensor:
    return blk.reshape(*x.shape[:-1], x.shape[-1] // qk, blk.shape[-1])


def _raw(raw: torch.Tensor, dtype, qk: int) -> tuple[dict, tuple]:
    """(the blocks' fields, one block a row; the output's shape: the rows
    of raw (..., nb, bytes) as nb·qk values, zero rows included)."""
    return (blocks.split(raw.reshape(-1, dtype.itemsize), dtype),
            (*raw.shape[:-2], raw.shape[-2] * qk))


# ------------------------------------------------------------------ MXFP4

def e8m0_to_fp32_half(e: torch.Tensor) -> torch.Tensor:
    """0.5 · 2^(e − 127), with the reference's denormal patterns for e < 2."""
    e = e.to(torch.int32)
    bits = torch.where(e < 2, 0x00200000 << e, (e - 1) << 23)
    return bits.view(torch.float32)


def mxfp4_exponent(amax: torch.Tensor) -> torch.Tensor:
    """The shared exponent byte (uint8(floorf(log2f(amax)) − 2 + 127), 0
    where amax is 0). log2 is taken in float64 and rounded once to f32: the
    correctly rounded log2f, which an f32 log2 on the card (≈ 1 ulp) misses
    just under a power of two."""
    pos = amax > 0
    lg = torch.log2(torch.where(pos, amax, 1.0).to(torch.float64)).to(torch.float32)
    ef = torch.floor(lg) - 2.0 + 127.0
    return torch.where(pos, ef.to(torch.int64) & 0xFF, 0).to(torch.uint8)


def quantize_mxfp4(x):
    xb = _blocked(x, QK_MXFP4)
    e = mxfp4_exponent(xb.abs().amax(-1))
    d = e8m0_to_fp32_half(e)
    kv = _table(KVALUES_MXFP4, xb.device)
    # nearest codebook value, the first index on ties (the C scan's strict <)
    idx = torch.argmin(torch.abs(kv * d[:, None, None] - xb[:, :, None]), dim=-1)
    idx = idx.to(torch.uint8)
    qs = idx[:, :16] | (idx[:, 16:] << 4)
    return _out(x, QK_MXFP4, blocks.join(BLOCK_MXFP4, e=e[:, None], qs=qs))


def dequantize_mxfp4(raw):
    f, shape = _raw(raw, BLOCK_MXFP4, QK_MXFP4)
    d = e8m0_to_fp32_half(f["e"][:, 0])[:, None]
    kv = _table(KVALUES_MXFP4, raw.device)
    qs = f["qs"].to(torch.int64)
    y = torch.cat([kv[qs & 0xF] * d, kv[qs >> 4] * d], dim=-1)
    return y.reshape(shape)


# ---------------------------------------------------------------- ternary

def _tq_trits(xb):
    """Per 256-block: (d = amax, trits (nb, 256) int32 in {0, 1, 2})."""
    amax = xb.abs().amax(-1)
    nz = amax != 0
    inv = torch.where(nz, const(1.0, xb) / torch.where(nz, amax, 1.0), 0.0)
    t = xb * inv[:, None]
    # lroundf: half away from zero
    return amax, (torch.sign(t) * torch.floor(torch.abs(t) + 0.5)).to(torch.int32) + 1


def _base3(seg):
    """(nb, k, w) digits → (nb, w): the base-3 number of the k digits, the
    first most significant."""
    q = torch.zeros_like(seg[:, 0])
    for n in range(seg.shape[1]):
        q = q * 3 + seg[:, n]
    return q


def _pow3_byte(q):
    """A base-3 number < 243 as a byte: ceil(q · 256 / 243)."""
    return torch.div(q * 256 + 242, 243, rounding_mode="floor").to(torch.uint8)


def quantize_tq1_0(x):
    xb = _blocked(x, QK_K)
    d, xi = _tq_trits(xb)
    nb = xb.shape[0]
    qs = torch.cat([_pow3_byte(_base3(xi[:, :160].reshape(nb, 5, 32))),    # 32-byte stride
                    _pow3_byte(_base3(xi[:, 160:240].reshape(nb, 5, 16)))], dim=-1)
    # the last 16: four per byte, shifted to the most significant trits
    qh = _pow3_byte(_base3(xi[:, 240:].reshape(nb, 4, 4)) * 3)
    return _out(x, QK_K, blocks.join(BLOCK_TQ1_0, qs=qs, qh=qh, d=f16_bytes(d)))


def _unpack5(qbytes, ntrits: int):
    """(nb, w) bytes → (nb, ntrits, w) digits in {0, 1, 2} (the reference's
    pow3 trick: q = byte · 3^n mod 256, digit = q · 3 >> 8)."""
    b = qbytes.to(torch.int32)
    return torch.stack([(((b * 3 ** n) & 0xFF) * 3) >> 8 for n in range(ntrits)], dim=1)


def dequantize_tq1_0(raw):
    f, shape = _raw(raw, BLOCK_TQ1_0, QK_K)
    d = f16_from_bytes(f["d"])[:, None]
    nb = d.shape[0]
    y = torch.cat([(_unpack5(f["qs"][:, :32], 5).reshape(nb, 160) - 1) * d,
                   (_unpack5(f["qs"][:, 32:48], 5).reshape(nb, 80) - 1) * d,
                   (_unpack5(f["qh"], 4).reshape(nb, 16) - 1) * d], dim=-1)
    return y.reshape(shape)


def quantize_tq2_0(x):
    xb = _blocked(x, QK_K)
    d, xi = _tq_trits(xb)
    nb = xb.shape[0]
    seg = (xi & 3).reshape(nb, 2, 4, 32)
    qs = seg[:, :, 0] | (seg[:, :, 1] << 2) | (seg[:, :, 2] << 4) | (seg[:, :, 3] << 6)
    return _out(x, QK_K, blocks.join(BLOCK_TQ2_0, qs=blocks.u8(qs.reshape(nb, 64)),
                                     d=f16_bytes(d)))


def dequantize_tq2_0(raw):
    f, shape = _raw(raw, BLOCK_TQ2_0, QK_K)
    d = f16_from_bytes(f["d"])[:, None, None, None]
    qs = f["qs"].reshape(-1, 2, 1, 32).to(torch.int32)
    shift = torch.arange(0, 8, 2, dtype=torch.int32, device=raw.device)[None, None, :, None]
    y = (((qs >> shift) & 3) - 1) * d
    return y.reshape(shape)


# ------------------------------------------------------------ IQ4 family

def best_index_iq4nl(x):
    """Nearest IQ4_NL codebook index, ties to the upper one
    (best_index_int8, src/ggml-quants.c:24-33)."""
    vals = _table(KVALUES_IQ4NL, x.device)
    mu = torch.clamp(torch.searchsorted(vals, x.contiguous(), right=True), 1, 15)
    lo, hi = vals[mu - 1], vals[mu]
    idx = torch.where((x - lo) < (hi - x), mu - 1, mu)
    idx = torch.where(x <= vals[0], 0, idx)
    return torch.where(x >= vals[15], 15, idx)


def _iq4_search_block(xb, weight, ntry: int):
    """Per 32-block scale search (xb (R, 32)) → (scales, L of the first
    fit, dead): the initial codebook fit, the least-squares refit d =
    Σw·q·x / Σw·q², then 2·ntry + 1 grid restarts keeping the best d by
    Σ(w·q·x)² / Σw·q² (quantize_row_iq4_nl_impl's inner loop)."""
    kv = _table(KVALUES_IQ4NL, xb.device)
    amax = xb.abs().amax(-1)
    dead = amax < float(GROUP_MAX_EPS)
    safe_max = torch.where(dead, 1.0, signed_absmax(xb))
    v0 = const(-127.0, xb)
    d0 = (-safe_max / v0) if ntry > 0 else (safe_max / v0)
    L = best_index_iq4nl((const(1.0, xb) / d0)[:, None] * xb)
    wq = weight * kv[L]
    sumqx = seq_sum(wq * xb)
    sumq2 = seq_sum(wq * kv[L])
    d = sumqx / sumq2
    best = d * sumqx
    for itry in range(-ntry, ntry + 1):
        qt = kv[best_index_iq4nl((const(itry - 127.0, xb) / safe_max)[:, None] * xb)]
        wq = weight * qt
        sqx = seq_sum(wq * xb)
        sq2 = seq_sum(wq * qt)
        better = (sq2 > 0) & (sqx * sqx > best * sq2)
        d = torch.where(better, sqx / sq2, d)
        best = torch.where(better, d * sqx, best)
    return torch.where(dead, 0.0, d), L, dead


def _row_weights(quant_weights, like, qk: int):
    """The importance row (n,) applied to every row of `like` (its rows of
    n as qk-blocks) → (like.numel() / qk, qk). The reference's IQ4 paths
    take the row only for a single row of x (their broadcast fails on
    more); every row reusing the row is what its other types and ggml's
    chunk API do."""
    qw = quant_weights.to(device=like.device, dtype=torch.float32).reshape(1, -1, qk)
    return qw.expand(like.numel() // (qw.shape[1] * qk), -1, -1).reshape(-1, qk)


def quantize_iq4_nl(x, quant_weights=None):
    """Single-scale 32-blocks. Without weights the _ref path (ntry = −1, L
    kept from the first fit); with weights the chunk path (ntry = 7, L
    refit with the final scale). ref :4749-4786."""
    xb = _blocked(x, QK4_NL)
    if quant_weights is None:
        ntry, weight = -1, xb * xb
    else:
        ntry = 7
        sigma2 = const(2.0 / QK4_NL, xb) * seq_sum(xb * xb)
        weight = _row_weights(quant_weights, xb, QK4_NL) * sqrt(sigma2[:, None] + xb * xb)
    scales, L, dead = _iq4_search_block(xb, weight, ntry)
    if ntry > 0:
        nz = scales != 0
        inv = torch.where(nz, const(1.0, xb) / torch.where(nz, scales, 1.0), 0.0)
        L = best_index_iq4nl(inv[:, None] * xb)
    L = torch.where(dead[:, None], best_index_iq4nl(torch.zeros_like(xb)), L).to(torch.uint8)
    return _out(x, QK4_NL, blocks.join(BLOCK_IQ4_NL, d=f16_bytes(scales),
                                       qs=L[:, :16] | (L[:, 16:] << 4)))


def dequantize_iq4_nl(raw):
    f, shape = _raw(raw, BLOCK_IQ4_NL, QK4_NL)
    d = f16_from_bytes(f["d"])[:, None]
    kv = _table(KVALUES_IQ4NL, raw.device)
    qs = f["qs"].to(torch.int64)
    y = torch.cat([kv[qs & 0xF] * d, kv[qs >> 4] * d], dim=-1)
    return y.reshape(shape)


def quantize_iq4_xs(x, quant_weights=None):
    """256-superblocks of 32-blocks with 6-bit super-scales; both the ref
    entry and the chunk API search with ntry = 7. ref :4787-4812."""
    xs = _blocked(x, QK_K)
    R = xs.shape[0]
    xb = xs.reshape(R * 8, 32)
    if quant_weights is None:
        weight = xb * xb
    else:
        sigma2 = const(2.0 / QK_K, xs) * seq_sum(xs * xs)
        weight = _row_weights(quant_weights, xs, QK_K).reshape(R * 8, 32) \
            * sqrt(sigma2.repeat_interleave(8)[:, None] + xb * xb)
    scales, _, _ = _iq4_search_block(xb, weight, 7)
    scales = scales.reshape(R, 8)
    # the super-scale: the block scale of largest |.| (the first on ties)
    d = -signed_absmax(scales) / const(32.0, xs)
    nz = d != 0
    inv_d = torch.where(nz, const(1.0, xs) / torch.where(nz, d, 1.0), 0.0)
    l = torch.clamp(nearest_int(inv_d[:, None] * scales), -32, 31)
    dl = d[:, None] * l
    nz = dl != 0
    idl = torch.where(nz, const(1.0, xs) / torch.where(nz, dl, 1.0), 0.0)
    L = best_index_iq4nl(idl.reshape(R * 8, 1) * xb).reshape(R, 8, 2, 16).to(torch.uint8)
    ls = (l + 32).to(torch.int32)
    scales_l = (ls[:, 0::2] & 0xF) | ((ls[:, 1::2] & 0xF) << 4)
    shift = 2 * torch.arange(8, dtype=torch.int32, device=xs.device)
    scales_h = (((ls >> 4) & 3) << shift).sum(-1)
    return _out(x, QK_K, blocks.join(
        BLOCK_IQ4_XS, d=f16_bytes(d), scales_h=blocks.le_bytes(scales_h, 2),
        scales_l=blocks.u8(scales_l), qs=(L[:, :, 0] | (L[:, :, 1] << 4)).reshape(R, 128)))


def dequantize_iq4_xs(raw):
    f, shape = _raw(raw, BLOCK_IQ4_XS, QK_K)
    d = f16_from_bytes(f["d"])
    ib = torch.arange(8, device=raw.device)
    ls_l = (f["scales_l"][:, ib // 2].to(torch.int32) >> (4 * (ib % 2)).to(torch.int32)) & 0xF
    ls_h = (blocks.le_int(f["scales_h"])[:, None] >> (2 * ib)) & 3
    dl = d[:, None] * ((ls_l | (ls_h << 4)) - 32).to(torch.float32)
    kv = _table(KVALUES_IQ4NL, raw.device)
    qs = f["qs"].reshape(-1, 8, 16).to(torch.int64)
    y = torch.cat([kv[qs & 0xF], kv[qs >> 4]], dim=-1) * dl[:, :, None]
    return y.reshape(shape)
