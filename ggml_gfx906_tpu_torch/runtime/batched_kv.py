"""Slot-based batched KV cache for the serving engine (dense), the
counterpart of ggml_gfx906_tpu/runtime/batched_kv.py::BatchedKVCache.

Each request owns a slot b of per-layer (B, n_kv_head, max_seq, head_dim)
buffers; per-slot lengths (a (B,) int32 tensor on the device) drive the
attention masks. Updates are IN PLACE, and the methods return the same
object so call sites read as in the reference. `WindowDelta` and the int8
cache are later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .kv_cache import clamp_start


@dataclass
class BatchedKVCache:
    k: list            # per layer: (B, n_kv_head, max_seq, head_dim)
    v: list
    lengths: torch.Tensor   # (B,) int32 valid positions per slot

    @classmethod
    def create(cls, n_layer: int, max_batch: int, max_seq: int, n_kv_head: int,
               head_dim: int, dtype=torch.float32, device="cpu") -> "BatchedKVCache":
        buf = torch.zeros((2 * n_layer, max_batch, n_kv_head, max_seq, head_dim),
                          dtype=dtype, device=device)
        return cls(list(buf[:n_layer]), list(buf[n_layer:]),
                   torch.zeros(max_batch, dtype=torch.int32, device=device))

    @property
    def max_batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[2]

    def with_lengths(self, lengths: torch.Tensor) -> "BatchedKVCache":
        """Set the lengths IN PLACE: the engine's captured decode programs
        read this very tensor, so it is never rebound."""
        self.lengths.copy_(lengths)
        return self

    def layer_kv(self, layer: int, window: int | None = None):
        """(k, v, None, None) for attention, optionally windowed to cache
        positions [0, window) — a view, no copy."""
        kc, vc = self.k[layer], self.v[layer]
        if window is not None:
            kc, vc = kc[:, :, :window], vc[:, :, :window]
        return kc, vc, None, None

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     start: torch.Tensor) -> "BatchedKVCache":
        """Write (B, S, n_kv_head, hd) at per-slot positions start (B,),
        each clamped so its S rows fit (as dynamic_update_slice does)."""
        B, S = k_new.shape[:2]
        s0 = clamp_start(start.to(torch.int64), S, self.max_seq)
        cols = s0[:, None] + torch.arange(S, device=s0.device)[None, :]   # (B, S)
        rows = torch.arange(B, device=s0.device)[:, None].expand(B, S)
        self.k[layer][rows, :, cols] = k_new.to(self.k[layer].dtype)
        self.v[layer][rows, :, cols] = v_new.to(self.v[layer].dtype)
        return self

    def set_slot(self, b: int, k_slot, v_slot, length: int) -> "BatchedKVCache":
        """Install a prefilled single-sequence cache (per-layer (H, S, D))
        into slot b (admission)."""
        for kb, kn in zip(self.k, k_slot):
            kb[b, :, :kn.shape[1]] = kn.to(kb.dtype)
        for vb, vn in zip(self.v, v_slot):
            vb[b, :, :vn.shape[1]] = vn.to(vb.dtype)
        self.lengths[b:b + 1].fill_(length)
        return self
