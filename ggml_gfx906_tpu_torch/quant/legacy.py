"""Legacy block-32 codecs: Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q8_1, on tensors.

The port of ggml_gfx906_tpu/quant/legacy.py (ggml's quantize_row_*_ref,
src/ggml-quants.c:36-258, dequantize_row_* :307-415, and the imatrix
paths quantize_row_*_impl :1893-2089), the same f32 operations in the same
order. A quantizer takes f32 (..., n) and returns its wire blocks as
(..., n/32, block bytes) uint8; a dequantizer takes such blocks and returns
(..., n) f32. Both run on the device of their input.
"""
from __future__ import annotations

import torch

from . import blocks, dequant_math as dq
from .numerics import (const, f16_bytes, f16_from_bytes, roundf_c, safe_div, seq_sum,
                       signed_absmax, sqrt, trunc_i)
from .types import (BLOCK_Q4_0, BLOCK_Q4_1, BLOCK_Q5_0, BLOCK_Q5_1, BLOCK_Q8_0,
                    BLOCK_Q8_1, QK4_0)


def _blocked(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    if x.shape[-1] % QK4_0:
        raise ValueError(f"last dim {x.shape[-1]} is not a multiple of {QK4_0}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // QK4_0, QK4_0)


def _nibbles(xi: torch.Tensor) -> torch.Tensor:
    """(..., 32) values → (..., 16) uint8: element j low, j + 16 high."""
    xi = blocks.u8(xi)
    return (xi[..., :16] & 0xF) | ((xi[..., 16:] & 0xF) << 4)


def _pack_qh(xi: torch.Tensor) -> torch.Tensor:
    """Bit 4 of 32 5-bit values as one little-endian word (bit j ↔ element
    j) in 4 bytes: (..., 32) → (..., 4) uint8."""
    bits = (xi.to(torch.int64) >> 4) & 1
    j = torch.arange(32, dtype=torch.int64, device=xi.device)
    return blocks.le_bytes((bits << j).sum(-1), 4)


def _symmetric(x, dtype, divisor: float, offset: float, qmax: int, five: bool):
    """Q4_0 / Q5_0: d = (signed absmax) / divisor, q = min(qmax, (int)(x/d +
    offset)). ref :36-71, :110-152."""
    xb = _blocked(x)
    d = signed_absmax(xb) / const(divisor, xb)
    q = xb * safe_div(const(1.0, xb), d)[..., None]
    xi = torch.clamp_max(trunc_i(q + offset), qmax)
    f = {"d": f16_bytes(d), "qs": _nibbles(xi)}
    if five:
        f["qh"] = _pack_qh(xi)
    return blocks.join(dtype, **f)


def _affine(x, dtype, steps: float, qmax: int | None, five: bool):
    """Q4_1 / Q5_1: d = (max − min) / steps, m = min, q = (int)((x − m)/d +
    0.5), clamped to qmax where the reference clamps. ref :73-108, :154-197."""
    xb = _blocked(x)
    mn = xb.amin(-1)
    d = (xb.amax(-1) - mn) / const(steps, xb)
    q = (xb - mn[..., None]) * safe_div(const(1.0, xb), d)[..., None]
    xi = trunc_i(q + 0.5)
    if qmax is not None:
        xi = torch.clamp_max(xi, qmax)
    f = {"d": f16_bytes(d), "m": f16_bytes(mn), "qs": _nibbles(xi)}
    if five:
        f["qh"] = _pack_qh(xi)
    return blocks.join(dtype, **f)


def quantize_q4_0(x):
    return _symmetric(x, BLOCK_Q4_0, -8.0, 8.5, 15, False)


def quantize_q5_0(x):
    return _symmetric(x, BLOCK_Q5_0, -16.0, 16.5, 31, True)


def quantize_q4_1(x):
    return _affine(x, BLOCK_Q4_1, 15.0, 15, False)


def quantize_q5_1(x):
    return _affine(x, BLOCK_Q5_1, 31.0, None, True)   # no clamp in the reference


def _q8(x, dtype, with_sum: bool):
    """ref :199-258: d = absmax / 127, q = roundf(x / d); Q8_1 also stores
    s = d · Σq."""
    xb = _blocked(x)
    d = xb.abs().amax(-1) / const(127.0, xb)
    qs = roundf_c(xb * safe_div(const(1.0, xb), d)[..., None])
    f = {"d": f16_bytes(d), "qs": qs.to(torch.int8)}
    if with_sum:
        f["s"] = f16_bytes(qs.to(torch.int32).sum(-1).to(torch.float32) * d)
    return blocks.join(dtype, **f)


def quantize_q8_0(x):
    return _q8(x, BLOCK_Q8_0, False)


def quantize_q8_1(x):
    return _q8(x, BLOCK_Q8_1, True)


def dequantize_q4_0(raw):
    f = blocks.split(raw, BLOCK_Q4_0)
    return dq.dequant_q4_0(f16_from_bytes(f["d"]), f["qs"])


def dequantize_q4_1(raw):
    f = blocks.split(raw, BLOCK_Q4_1)
    return dq.dequant_q4_1(f16_from_bytes(f["d"]), f16_from_bytes(f["m"]), f["qs"])


def dequantize_q5_0(raw):
    f = blocks.split(raw, BLOCK_Q5_0)
    return dq.dequant_q5_0(f16_from_bytes(f["d"]), f["qh"], f["qs"])


def dequantize_q5_1(raw):
    f = blocks.split(raw, BLOCK_Q5_1)
    return dq.dequant_q5_1(f16_from_bytes(f["d"]), f16_from_bytes(f["m"]), f["qh"], f["qs"])


def dequantize_q8_0(raw):
    f = blocks.split(raw, BLOCK_Q8_0)
    return dq.dequant_q8_0(f16_from_bytes(f["d"]), f["qs"].contiguous().view(torch.int8))


def dequantize_q8_1(raw):
    f = blocks.split(raw, BLOCK_Q8_1)
    return dq.dequant_q8_0(f16_from_bytes(f["d"]), f["qs"].contiguous().view(torch.int8))


# ------------------------------------------------------- imatrix variants
#
# With an importance row, the block-32 types switch to the weighted scale
# searches make_qx_quants / make_qkx2_quants with weight[j] = qw[j] ·
# sqrt(sigma2 + x[j]²), sigma2 over the whole row (ref :1893-2089). Q8_0
# ignores the weights upstream (:2091-2096).

def _imatrix_blocks(x, quant_weights, qk: int):
    """(xb (R·nb, qk), weight (R·nb, qk)) with sigma2 per row."""
    x = x.to(torch.float32)
    n = x.shape[-1]
    qw = quant_weights.to(device=x.device, dtype=torch.float32).reshape(-1)
    if qw.numel() != n or n % qk:
        raise ValueError(f"importance row of {qw.numel()} for rows of {n}")
    rows = x.reshape(-1, n)
    sigma2 = seq_sum(rows * rows) / const(n, rows)
    xb = rows.reshape(rows.shape[0], n // qk, qk)
    weight = qw.reshape(n // qk, qk) * sqrt(sigma2[:, None, None] + xb * xb)
    return xb.reshape(-1, qk), weight.reshape(-1, qk)


def _imatrix_out(x, dtype, **fields):
    return blocks.join(dtype, **fields).reshape(*x.shape[:-1], x.shape[-1] // QK4_0,
                                               dtype.itemsize)


def quantize_q4_0_imatrix(x, quant_weights):
    """ref: quantize_row_q4_0_impl :1893-1918."""
    from .kquants import make_qx_quants

    xb, weight = _imatrix_blocks(x, quant_weights, QK4_0)
    d, L = make_qx_quants(xb, 8, weight)
    return _imatrix_out(x, BLOCK_Q4_0, d=f16_bytes(d), qs=_nibbles(L))


def quantize_q4_1_imatrix(x, quant_weights):
    """ref: quantize_row_q4_1_impl :1935-1964."""
    from .kquants import make_qkx2_quants

    xb, weight = _imatrix_blocks(x, quant_weights, QK4_0)
    d, the_min, L = make_qkx2_quants(xb, weight, 15, -0.9, 0.05, 36, False)
    return _imatrix_out(x, BLOCK_Q4_1, d=f16_bytes(d), m=f16_bytes(-the_min),
                        qs=_nibbles(L))


def quantize_q5_0_imatrix(x, quant_weights):
    """ref: quantize_row_q5_0_impl :1982-2021."""
    from .kquants import make_qx_quants

    xb, weight = _imatrix_blocks(x, quant_weights, QK4_0)
    d, L = make_qx_quants(xb, 16, weight)
    return _imatrix_out(x, BLOCK_Q5_0, d=f16_bytes(d), qh=_pack_qh(L), qs=_nibbles(L))


def quantize_q5_1_imatrix(x, quant_weights):
    """ref: quantize_row_q5_1_impl :2036-2073."""
    from .kquants import make_qkx2_quants

    xb, weight = _imatrix_blocks(x, quant_weights, QK4_0)
    d, the_min, L = make_qkx2_quants(xb, weight, 31, -0.9, 0.05, 36, False)
    return _imatrix_out(x, BLOCK_Q5_1, d=f16_bytes(d), m=f16_bytes(-the_min),
                        qh=_pack_qh(L), qs=_nibbles(L))
