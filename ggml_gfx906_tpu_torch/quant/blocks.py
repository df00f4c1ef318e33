"""Wire blocks as uint8 tensors: split a (..., nb, type_size) byte tensor
into its fields by the block's numpy dtype (quant/types.py), join fields
back in the dtype's order, and the little-endian integer views the codecs
need. Every function runs on its input's device."""
from __future__ import annotations

import numpy as np
import torch


def _layout(dtype: np.dtype):
    """[(name, byte offset, byte size)] of a packed block dtype."""
    return [(name, off, dt.itemsize) for name, (dt, off) in dtype.fields.items()]


def split(raw: torch.Tensor, dtype: np.dtype) -> dict:
    """(..., nb, dtype.itemsize) uint8 → {field: (..., nb, size) uint8}."""
    if raw.shape[-1] != dtype.itemsize:
        raise ValueError(f"blocks of {raw.shape[-1]} bytes, the dtype has {dtype.itemsize}")
    return {name: raw[..., off:off + size] for name, off, size in _layout(dtype)}


def join(dtype: np.dtype, **fields) -> torch.Tensor:
    """Fields (..., nb, size) uint8 (any integer dtype of the right bytes,
    viewed as uint8) → (..., nb, dtype.itemsize) uint8 blocks."""
    parts = []
    for name, _, size in _layout(dtype):
        f = fields[name]
        if f.dtype != torch.uint8:
            f = f.contiguous().view(torch.uint8)
        if f.shape[-1] != size:
            raise ValueError(f"field {name}: {f.shape[-1]} bytes, the block has {size}")
        parts.append(f)
    return torch.cat(parts, dim=-1)


def u8(v: torch.Tensor) -> torch.Tensor:
    """Integer-valued f32 or any integer tensor → uint8 keeping the low
    byte, as numpy's int32 → uint8 cast wraps (a float → uint8 cast of a
    negative value is undefined in C and differs between the CPU and the
    card)."""
    if v.is_floating_point():
        v = v.to(torch.int32)
    return (v & 0xFF).to(torch.uint8)


def le_bytes(v: torch.Tensor, n: int) -> torch.Tensor:
    """(...) integer values → (..., n) uint8, little-endian, low n bytes."""
    v = v.to(torch.int64)
    return torch.stack([(v >> (8 * i)) & 0xFF for i in range(n)], dim=-1).to(torch.uint8)


def le_int(b: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 → (...) int64, little-endian unsigned."""
    b = b.to(torch.int64)
    out = b[..., 0]
    for i in range(1, b.shape[-1]):
        out = out | (b[..., i] << (8 * i))
    return out


def le_words(b: torch.Tensor, width: int) -> torch.Tensor:
    """(..., k·width) uint8 → (..., k) int64: consecutive little-endian
    unsigned words of `width` bytes."""
    return le_int(b.reshape(*b.shape[:-1], -1, width))
