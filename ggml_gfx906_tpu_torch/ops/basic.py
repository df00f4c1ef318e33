"""Elementwise ops and norms the llama path needs (ggml_gfx906_tpu/ops/
basic.py: silu :43-45, rms_norm :162-165)."""
from __future__ import annotations

import torch


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving (zero-padded to a power
    of two), keepdim. The order of additions depends only on the row
    length, never on how many rows there are or on the device's reduction
    heuristics, so a row gives the same bits alone or inside a batch — the
    engine-vs-generate stream equality relies on it."""
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x


def rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = row_sum(xf * xf) / xf.shape[-1]
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)
