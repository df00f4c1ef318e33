"""Single-sequence KV cache (dense), the counterpart of ggml_gfx906_tpu/
runtime/kv_cache.py::KVCache (:44-128).

Per-layer (n_kv_head, max_seq, head_dim) tensors in attention order, from
one allocation. Unlike the reference's donated functional carry, the port
updates the buffers IN PLACE (no copy of the cache per token);
`update_layer` and `advance` return the same object so call sites read as
in the reference. A cache also holds the CUDA graphs of the decode steps
that write into it (`graphs`). The int8 cache is a later slice.
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


@dataclass
class KVCache:
    k: list      # per layer: (n_kv_head, max_seq, head_dim)
    v: list
    length: int = 0
    # the captured decode steps that write into these buffers
    # (models/llama.py::decode_step / decode_chunk / decode_scan)
    graphs: object = field(default=None, repr=False, compare=False)

    @classmethod
    def create(cls, n_layer: int, max_seq: int, n_kv_head: int, head_dim: int,
               dtype=torch.float32, device="cpu") -> "KVCache":
        buf = torch.zeros((2 * n_layer, n_kv_head, max_seq, head_dim),
                          dtype=dtype, device=device)
        return cls(list(buf[:n_layer]), list(buf[n_layer:]), 0)

    @property
    def n_layer(self) -> int:
        return len(self.k)

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]

    def layer_kv(self, layer: int):
        """(k, v, k_scale, v_scale) for attention; scales None (dense)."""
        return self.k[layer], self.v[layer], None, None

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     start) -> "KVCache":
        """Write (S, n_kv_head, hd) at positions [start, start+S) of layer.
        `start` is a host int or a one-element int tensor on the cache's
        device; a tensor start is written by `index_copy_` at device-side
        positions, so no host read or copy happens (a captured decode step
        reads its position from a device buffer)."""
        s = k_new.shape[0]
        kn = k_new.transpose(0, 1).to(self.k[layer].dtype)
        vn = v_new.transpose(0, 1).to(self.v[layer].dtype)
        if isinstance(start, torch.Tensor):
            cols = (clamp_start(start.reshape(()).to(torch.int64), s, self.max_seq)
                    + torch.arange(s, device=start.device))
            self.k[layer].index_copy_(1, cols, kn)
            self.v[layer].index_copy_(1, cols, vn)
            return self
        s0 = clamp_start(start, s, self.max_seq)
        self.k[layer][:, s0:s0 + s] = kn
        self.v[layer][:, s0:s0 + s] = vn
        return self

    def advance(self, n: int) -> "KVCache":
        self.length += int(n)
        return self
