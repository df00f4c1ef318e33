"""Codebook i-quants IQ2_XXS / IQ2_XS / IQ2_S, IQ3_XXS / IQ3_S, IQ1_S /
IQ1_M: the dequantizers, on tensors.

The port of ggml_gfx906_tpu/quant/iquants.py:52-234 (ggml's
dequantize_row_iq*, src/ggml-quants.c:2275-2505: grid lookups, the
ksigns sign expansion and 4- or 3-bit block scales), the same f32
operations in the same order, so that a file of any of these types loads.
The grid tables are the port's own copy, data/iq_grids.npz. The
quantizers, grid searches over those lattices, are not ported yet: the
registry refuses them (quant/registry.py).

A dequantizer takes (..., nb, block bytes) uint8 wire blocks and returns
(..., nb·256) f32 on their device.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import blocks
from .numerics import f16_from_bytes
from .types import (BLOCK_IQ1_M, BLOCK_IQ1_S, BLOCK_IQ2_S, BLOCK_IQ2_XS, BLOCK_IQ2_XXS,
                    BLOCK_IQ3_S, BLOCK_IQ3_XXS, QK_K)

IQ1_DELTA = 0.125           # IQ1S_DELTA == IQ1M_DELTA, exact in f32
_DATA = os.path.join(os.path.dirname(__file__), "data", "iq_grids.npz")


@functools.cache
def _tables() -> dict:
    with np.load(_DATA) as t:
        return dict(t)


@functools.cache
def grid_u8(name: str, device: torch.device) -> torch.Tensor:
    """A dequant lattice as (grid_size, 8 | 4) f32 on `device`: its packed
    words' bytes, unsigned (iq1s_grid signed)."""
    t = _tables()[name]
    g = t.view(np.uint8).reshape(len(t), t.dtype.itemsize)
    if name == "iq1s_grid":
        g = g.view(np.int8)
    return torch.from_numpy(g.astype(np.float32)).to(device)


@functools.cache
def ksigns(device: torch.device) -> torch.Tensor:
    """ksigns_iq2xs (src/ggml-common.h): a 7-bit sign word → 8 bits with
    odd parity in bit 7, as int64 on `device`."""
    i = np.arange(128)
    pc = ((i[:, None] >> np.arange(7)) & 1).sum(1) & 1
    return torch.from_numpy(i | (pc << 7)).to(device)


def _sign_pm1(sign_bytes: torch.Tensor) -> torch.Tensor:
    """(...) sign bytes → (..., 8) of ±1 f32 (bit j set → −1)."""
    j = torch.arange(8, device=sign_bytes.device)
    bits = (sign_bytes.to(torch.int64)[..., None] >> j) & 1
    return torch.where(bits.bool(), -1.0, 1.0)


def _fields(raw, dtype):
    """(the blocks' fields, one block a row; the output's shape, zero rows
    included; the f16 scale d as f32, where the block has one)."""
    f = blocks.split(raw.reshape(-1, dtype.itemsize), dtype)
    return (f, (*raw.shape[:-2], raw.shape[-2] * QK_K),
            f16_from_bytes(f["d"]) if "d" in f else None)


def _db(d, code, half: float):
    """Block scales (d · (0.5 + code)) · half, each product rounded."""
    return (d * (0.5 + code.to(torch.float32))) * half


def dequantize_iq2_xxs(raw):
    f, shape, d = _fields(raw, BLOCK_IQ2_XXS)
    dev = raw.device
    aux = blocks.le_words(f["qs"], 4).reshape(-1, 8, 2)
    a, s = aux[..., 0], aux[..., 1]                                # (nb, 8)
    db = _db(d[:, None], s >> 28, 0.25)
    k4 = torch.arange(4, device=dev)
    grid = grid_u8("iq2xxs_grid", dev)[(a[..., None] >> (8 * k4)) & 0xFF]   # (nb, 8, 4, 8)
    signs = _sign_pm1(ksigns(dev)[(s[..., None] >> (7 * k4)) & 127])
    return ((db[:, :, None, None] * grid) * signs).reshape(shape)


def _dl_nibbles(d, scales):
    """IQ2_XS / IQ2_S: per 32-block the two nibble scales, as each of its
    four 8-groups takes them (0, 0, 1, 1) → (nb, 8, 4)."""
    sc = scales.to(torch.int32)
    db = _db(d[:, None, None], torch.stack([sc & 0xF, sc >> 4], dim=-1), 0.25)
    return db[:, :, [0, 0, 1, 1]]


def dequantize_iq2_xs(raw):
    f, shape, d = _fields(raw, BLOCK_IQ2_XS)
    dev = raw.device
    qs = blocks.le_words(f["qs"], 2).reshape(-1, 8, 4)
    grid = grid_u8("iq2xs_grid", dev)[qs & 511]
    signs = _sign_pm1(ksigns(dev)[qs >> 9])
    dl = _dl_nibbles(d, f["scales"])
    return ((dl[..., None] * grid) * signs).reshape(shape)


def dequantize_iq2_s(raw):
    f, shape, d = _fields(raw, BLOCK_IQ2_S)
    dev = raw.device
    qs = f["qs"][:, :32].reshape(-1, 8, 4).to(torch.int64)
    sgn = f["qs"][:, 32:].reshape(-1, 8, 4)
    qh = f["qh"].to(torch.int64)
    sh = 8 - 2 * torch.arange(4, device=dev)
    grid = grid_u8("iq2s_grid", dev)[qs | ((qh[..., None] << sh) & 0x300)]
    dl = _dl_nibbles(d, f["scales"])
    return ((dl[..., None] * grid) * _sign_pm1(sgn)).reshape(shape)


def dequantize_iq3_xxs(raw):
    f, shape, d = _fields(raw, BLOCK_IQ3_XXS)
    dev = raw.device
    qs = f["qs"][:, :64].reshape(-1, 8, 8).to(torch.int64)          # grid bytes
    aux = blocks.le_words(f["qs"][:, 64:], 4)                       # (nb, 8)
    db = _db(d[:, None], aux >> 28, 0.5)
    grid = grid_u8("iq3xxs_grid", dev)[qs]                           # (nb, 8, 8, 4)
    k4 = torch.arange(4, device=dev)
    signs = _sign_pm1(ksigns(dev)[(aux[..., None] >> (7 * k4)) & 127])   # (nb, 8, 4, 8)
    # grid pairs qs[2l], qs[2l + 1] give elements 0-3 / 4-7 of sign word l
    y = db[:, :, None, None] * grid.reshape(-1, 8, 4, 8)
    return (y * signs).reshape(shape)


def dequantize_iq3_s(raw):
    f, shape, d = _fields(raw, BLOCK_IQ3_S)
    dev = raw.device
    nb = d.shape[0]
    qs = f["qs"].reshape(nb, 4, 2, 8).to(torch.int64)      # (pair of 32-blocks, half, 2l)
    qh = f["qh"].reshape(nb, 4, 2).to(torch.int64)
    sc = f["scales"].to(torch.int32)
    # C order: d · (1 + 2·nibble)
    db = d[:, None, None] * torch.stack([1.0 + 2.0 * (sc & 0xF).to(torch.float32),
                                         1.0 + 2.0 * (sc >> 4).to(torch.float32)], dim=-1)
    l2 = torch.arange(8, device=dev)
    shifts = torch.where(l2 % 2 == 0, 8 - (l2 // 2) * 2, 7 - (l2 // 2) * 2)
    grid = grid_u8("iq3s_grid", dev)[qs | ((qh[..., None] << shifts) & 256)]   # (nb,4,2,8,4)
    y = db[:, :, :, None, None] * grid.reshape(nb, 4, 2, 4, 8)
    return (y * _sign_pm1(f["signs"].reshape(nb, 4, 2, 4))).reshape(shape)


def dequantize_iq1_s(raw):
    f, shape, d = _fields(raw, BLOCK_IQ1_S)
    dev = raw.device
    qs = f["qs"].reshape(-1, 8, 4).to(torch.int64)
    qh = blocks.le_words(f["qh"], 2)                                  # (nb, 8)
    dl = d[:, None] * (2.0 * ((qh >> 12) & 7).to(torch.float32) + 1.0)
    delta = torch.where((qh & 0x8000) != 0, -IQ1_DELTA, IQ1_DELTA)
    k4 = torch.arange(4, device=dev)
    grid = grid_u8("iq1s_grid", dev)[qs | (((qh[..., None] >> (3 * k4)) & 7) << 8)]
    return (dl[..., None, None] * (grid + delta[..., None, None])).reshape(shape)


def dequantize_iq1_m(raw):
    f, shape, _ = _fields(raw, BLOCK_IQ1_M)
    dev = raw.device
    sc = blocks.le_words(f["scales"], 2)                              # (nb, 4)
    nb = sc.shape[0]
    du16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
            | (sc[:, 3] & 0xF000))
    d = f16_from_bytes(blocks.le_bytes(du16, 2))
    qs = f["qs"].reshape(nb, 8, 4).to(torch.int64)
    qh = f["qh"].reshape(nb, 8, 2).to(torch.int64)
    ib = torch.arange(8, device=dev)
    word = sc[:, ib // 2]
    sh = 6 * (ib % 2)
    dl = torch.stack([(word >> sh) & 7, (word >> (sh + 3)) & 7], dim=-1)
    dl = d[:, None, None] * (dl.to(torch.float32) * 2.0 + 1.0)       # (nb, 8, 2)
    idx = torch.stack([qs[..., 0] | ((qh[..., 0] << 8) & 0x700),
                       qs[..., 1] | ((qh[..., 0] << 4) & 0x700),
                       qs[..., 2] | ((qh[..., 1] << 8) & 0x700),
                       qs[..., 3] | ((qh[..., 1] << 4) & 0x700)], dim=-1)
    hb = torch.stack([qh[..., 0] & 0x08, qh[..., 0] & 0x80,
                      qh[..., 1] & 0x08, qh[..., 1] & 0x80], dim=-1)
    delta = torch.where(hb != 0, -IQ1_DELTA, IQ1_DELTA)
    grid = grid_u8("iq1s_grid", dev)[idx]                            # (nb, 8, 4, 8)
    dsel = dl[:, :, [0, 0, 1, 1]]
    return (dsel[..., None] * (grid + delta[..., None])).reshape(shape)
