"""Single-sequence KV cache, optionally int8-quantized: the counterpart of
ggml_gfx906_tpu/runtime/kv_cache.py::KVCache (:44-128) and its
`quantize_rows` (:30-41).

Per-layer (n_kv_head, max_seq, head_dim) tensors in attention order, from
one allocation. Unlike the reference's donated functional carry, the port
updates the buffers IN PLACE (no copy of the cache per token);
`update_layer` and `advance` return the same object so call sites read as
in the reference. A cache also holds the CUDA graphs of the decode steps
that write into it (`graphs`).

Quantized mode (`quant=True`, config "kv_quant" in the engine) stores rows
int8 with one f32 absmax scale per (head, position) vector, as the
reference does: K2 folds the scales into its score columns and P.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


def clamp_start(start, s: int, max_seq: int):
    """Write position of an S-row update: the reference's
    dynamic_update_slice clamps the start so the update fits
    (kv_cache.py:121-122); the port reproduces the clamp."""
    if s > max_seq:
        raise ValueError(f"{s} rows do not fit a cache of {max_seq}")
    if isinstance(start, torch.Tensor):
        return torch.clamp(start, 0, max_seq - s)
    return max(0, min(int(start), max_seq - s))


def quantize_rows(x: torch.Tensor):
    """x (..., D) f32/bf16 → (int8 (..., D), f32 scale (...,)), bit for bit
    the reference's: d = amax / 127 (a division), the rows multiplied by
    1/d (0 where d == 0) and rounded half away from zero (C roundf), not
    half to even. Divisions are tensor by tensor: a CUDA tensor divided by
    a Python scalar is multiplied by its reciprocal."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    d = amax / torch.full_like(amax, 127.0)
    pos = d > 0
    inv = torch.where(pos, torch.ones_like(d) / torch.where(pos, d, torch.ones_like(d)),
                      torch.zeros_like(d))
    s = xf * inv[..., None]
    return (torch.sign(s) * torch.floor(s.abs() + 0.5)).to(torch.int8), d


@dataclass
class KVCache:
    k: list      # per layer: (n_kv_head, max_seq, head_dim), int8 when quantized
    v: list
    length: int = 0
    k_d: list = field(default_factory=list)   # per layer: (n_kv_head, max_seq) f32, or []
    v_d: list = field(default_factory=list)
    # the captured decode steps that write into these buffers
    # (models/llama.py::decode_step / decode_chunk / decode_scan)
    graphs: object = field(default=None, repr=False, compare=False)

    @classmethod
    def create(cls, n_layer: int, max_seq: int, n_kv_head: int, head_dim: int,
               dtype=torch.float32, device="cpu", quant: bool = False) -> "KVCache":
        buf = torch.zeros((2 * n_layer, n_kv_head, max_seq, head_dim),
                          dtype=torch.int8 if quant else dtype, device=device)
        kd = vd = []
        if quant:
            dbuf = torch.zeros((2 * n_layer, n_kv_head, max_seq), dtype=torch.float32,
                               device=device)
            kd, vd = list(dbuf[:n_layer]), list(dbuf[n_layer:])
        return cls(list(buf[:n_layer]), list(buf[n_layer:]), 0, kd, vd)

    @property
    def quantized(self) -> bool:
        return len(self.k_d) > 0

    @property
    def n_layer(self) -> int:
        return len(self.k)

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]

    def layer_kv(self, layer: int):
        """(k, v, k_scale, v_scale) for attention; scales None if dense."""
        if self.quantized:
            return self.k[layer], self.v[layer], self.k_d[layer], self.v_d[layer]
        return self.k[layer], self.v[layer], None, None

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     start) -> "KVCache":
        """Write (S, n_kv_head, hd) at positions [start, start+S) of layer
        (quantized per row when the cache is). `start` is a host int or a
        one-element int tensor on the cache's device; a tensor start is
        written by `index_copy_` at device-side positions, so no host read
        or copy happens (a captured decode step reads its position from a
        device buffer)."""
        s = k_new.shape[0]
        kn, vn = k_new.transpose(0, 1), v_new.transpose(0, 1)
        bufs = [(self.k[layer], kn), (self.v[layer], vn)]
        if self.quantized:
            (kn, kd), (vn, vd) = quantize_rows(kn), quantize_rows(vn)
            bufs = [(self.k[layer], kn), (self.v[layer], vn),
                    (self.k_d[layer], kd), (self.v_d[layer], vd)]
        if isinstance(start, torch.Tensor):
            cols = (clamp_start(start.reshape(()).to(torch.int64), s, self.max_seq)
                    + torch.arange(s, device=start.device))
            for buf, new in bufs:
                buf.index_copy_(1, cols, new.to(buf.dtype))
            return self
        s0 = clamp_start(start, s, self.max_seq)
        for buf, new in bufs:
            buf[:, s0:s0 + s] = new.to(buf.dtype)
        return self

    def advance(self, n: int) -> "KVCache":
        self.length += int(n)
        return self
