"""Activation quantization to int8 blocks, on the device of its input.

The port of ggml_gfx906_tpu/ops/act_quant.py (ggml's src/ggml-cuda/
quantize.cu, activations quantized to q8_1 on the fly): the scale rule of
quantize_row_q8_0 / q8_1 (d = absmax / 127) and C roundf (half away from
zero); d is not rounded to f16, since activations never reach the wire.
"""
from __future__ import annotations

import torch

from ..quant.numerics import const, roundf_c


def quantize_q8(x: torch.Tensor, block: int = 32):
    """x (..., K) → (qs int8 (..., K), d f32 (..., K/block))."""
    k = x.shape[-1]
    if k % block:
        raise ValueError(f"last dim {k} is not a multiple of {block}")
    xb = x.to(torch.float32).reshape(*x.shape[:-1], k // block, block)
    d = xb.abs().amax(-1) / const(127.0, xb)
    pos = d > 0
    inv = torch.where(pos, const(1.0, xb) / torch.where(pos, d, 1.0), 0.0)
    qs = roundf_c(xb * inv[..., None]).to(torch.int8)
    return qs.reshape(x.shape), d


def quantize_q8_with_sums(x: torch.Tensor, block: int = 32):
    """Also the per-block sums d · Σqs (block_q8_1's s, q8_K's bsums), which
    the affine-quant integer dot paths need."""
    qs, d = quantize_q8(x, block)
    k = x.shape[-1]
    sums = qs.reshape(*x.shape[:-1], k // block, block).to(torch.int32).sum(-1)
    return qs, d, d * sums.to(torch.float32)


def dequantize_q8(qs: torch.Tensor, d: torch.Tensor, block: int = 32) -> torch.Tensor:
    k = qs.shape[-1]
    y = qs.to(torch.float32).reshape(*qs.shape[:-1], k // block, block) * d[..., None]
    return y.reshape(qs.shape)
