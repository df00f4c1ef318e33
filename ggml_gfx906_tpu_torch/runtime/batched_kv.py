"""Slot-based batched KV cache for the serving engine, the counterpart of
ggml_gfx906_tpu/runtime/batched_kv.py (BatchedKVCache, WindowDelta).

Each request owns a slot b of per-layer (B, n_kv_head, max_seq, head_dim)
buffers; per-slot lengths (a (B,) int32 tensor on the device) drive the
attention masks. Quantized mode (`quant=True`) stores int8 rows with a
(B, n_kv_head, max_seq) f32 scale per layer, as KVCache does. Updates are
IN PLACE, and the methods return the same object so call sites read as in
the reference.

`WindowDelta` holds a scan window's fresh K/V rows (the window-delta
decode of config "engine_window_delta"): each step writes its rows at a
uniform column of a small per-window buffer, attention merges the big
cache and the delta at score level (ops/attention.py::causal_attn_delta),
and `absorb_delta` installs the window's rows into the cache once.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .kv_cache import clamp_start, quantize_rows


@dataclass
class WindowDelta:
    """Per-window fresh K/V rows: per-layer (B, n_kv_head, depth, head_dim)."""
    k: list
    v: list

    @classmethod
    def create(cls, n_layer: int, max_batch: int, n_kv_head: int, depth: int,
               head_dim: int, dtype=torch.bfloat16, device="cpu") -> "WindowDelta":
        buf = torch.zeros((2 * n_layer, max_batch, n_kv_head, depth, head_dim), dtype=dtype,
                          device=device)
        return cls(list(buf[:n_layer]), list(buf[n_layer:]))

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
              step: int) -> "WindowDelta":
        """Write (B, 1, H, D) rows at delta column `step`, in place."""
        self.k[layer][:, :, step] = k_new[:, 0].to(self.k[layer].dtype)
        self.v[layer][:, :, step] = v_new[:, 0].to(self.v[layer].dtype)
        return self

    def zero_(self) -> "WindowDelta":
        for t in self.k + self.v:
            t.zero_()
        return self


@dataclass
class BatchedKVCache:
    k: list            # per layer: (B, n_kv_head, max_seq, head_dim), int8 when quantized
    v: list
    k_d: list          # per layer: (B, n_kv_head, max_seq) f32 scales, or [] when dense
    v_d: list
    lengths: torch.Tensor   # (B,) int32 valid positions per slot

    @classmethod
    def create(cls, n_layer: int, max_batch: int, max_seq: int, n_kv_head: int,
               head_dim: int, dtype=torch.float32, device="cpu",
               quant: bool = False) -> "BatchedKVCache":
        shape = (max_batch, n_kv_head, max_seq, head_dim)
        buf = torch.zeros((2 * n_layer,) + shape, dtype=torch.int8 if quant else dtype,
                          device=device)
        kd = vd = []
        if quant:
            dbuf = torch.zeros((2 * n_layer,) + shape[:3], dtype=torch.float32, device=device)
            kd, vd = list(dbuf[:n_layer]), list(dbuf[n_layer:])
        return cls(list(buf[:n_layer]), list(buf[n_layer:]), kd, vd,
                   torch.zeros(max_batch, dtype=torch.int32, device=device))

    @property
    def quantized(self) -> bool:
        return len(self.k_d) > 0

    @property
    def max_batch(self) -> int:
        return self.k[0].shape[0]

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[2]

    def rows(self, n: int) -> "BatchedKVCache":
        """The cache of its first n slots: views of its buffers and lengths
        (itself where n covers every slot)."""
        if n >= self.max_batch:
            return self
        return BatchedKVCache([t[:n] for t in self.k], [t[:n] for t in self.v],
                              [t[:n] for t in self.k_d], [t[:n] for t in self.v_d],
                              self.lengths[:n])

    def with_lengths(self, lengths: torch.Tensor) -> "BatchedKVCache":
        """Set the lengths IN PLACE: the engine's captured decode programs
        read this very tensor, so it is never rebound."""
        self.lengths.copy_(lengths)
        return self

    def layer_kv(self, layer: int, window: int | None = None):
        """(k, v, k_scale, v_scale) for attention, optionally windowed to
        cache positions [0, window) — views, no copy; scales None when
        dense."""
        out = [self.k[layer], self.v[layer]]
        out += [self.k_d[layer], self.v_d[layer]] if self.quantized else [None, None]
        if window is not None:
            out = [t if t is None else t[:, :, :window] for t in out]
        return tuple(out)

    def make_delta(self, depth: int, dtype=torch.bfloat16) -> WindowDelta:
        """Zeroed per-window delta buffers: (B, H, depth, D) per layer, bf16
        by default whatever the cache's type (the reference's default,
        which the parity tests pin), always dense: a quantized cache
        quantizes the window's rows once, at absorb."""
        B, H, _, D = self.k[0].shape
        return WindowDelta.create(len(self.k), B, H, depth, D, dtype, self.lengths.device)

    def absorb_delta(self, delta: WindowDelta, len0: torch.Tensor, active: torch.Tensor,
                     depth: int) -> "BatchedKVCache":
        """Install a window's delta rows at positions len0[b] ..
        len0[b]+depth-1 (the start clamped to max_seq - depth, as the
        per-step writes clamp), every slot; lengths advance by depth for
        active slots only (inactive slots' rows sit beyond their length)."""
        start = torch.clamp(len0.to(torch.int64), max=self.max_seq - depth)
        cols = start[:, None] + torch.arange(depth, device=start.device)[None, :]  # (B, depth)
        rows = torch.arange(cols.shape[0], device=start.device)[:, None].expand_as(cols)
        for li in range(len(self.k)):
            news = [(self.k[li], delta.k[li]), (self.v[li], delta.v[li])]
            if self.quantized:
                (kq, kd), (vq, vd) = quantize_rows(delta.k[li]), quantize_rows(delta.v[li])
                news = [(self.k[li], kq), (self.v[li], vq),
                        (self.k_d[li], kd), (self.v_d[li], vd)]
            for buf, new in news:
                # new (B, H, depth[, D]) → (B, depth, H[, D]) at (row, :, col)
                buf[rows, :, cols] = new.transpose(1, 2).to(buf.dtype)
        self.lengths.copy_(len0 + depth * active.to(torch.int32))
        return self

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     start: torch.Tensor) -> "BatchedKVCache":
        """Write (B, S, n_kv_head, hd) at per-slot positions start (B,),
        each clamped so its S rows fit (as dynamic_update_slice does);
        quantized per row when the cache is."""
        B, S = k_new.shape[:2]
        s0 = clamp_start(start.to(torch.int64), S, self.max_seq)
        cols = s0[:, None] + torch.arange(S, device=s0.device)[None, :]   # (B, S)
        rows = torch.arange(B, device=s0.device)[:, None].expand(B, S)
        news = [(self.k[layer], k_new), (self.v[layer], v_new)]
        if self.quantized:
            (kq, kd), (vq, vd) = quantize_rows(k_new), quantize_rows(v_new)
            news = [(self.k[layer], kq), (self.v[layer], vq),
                    (self.k_d[layer], kd), (self.v_d[layer], vd)]
        for buf, new in news:
            buf[rows, :, cols] = new.to(buf.dtype)
        return self

    def set_slot(self, b: int, k_slot, v_slot, length: int, k_d=(), v_d=()) -> "BatchedKVCache":
        """Install a prefilled single-sequence cache (per-layer (H, S, D),
        plus (H, S) scales when quantized) into slot b (admission)."""
        pairs = list(zip(self.k, k_slot)) + list(zip(self.v, v_slot))
        if self.quantized:
            pairs += list(zip(self.k_d, k_d)) + list(zip(self.v_d, v_d))
        for buf, new in pairs:
            buf[b, :, :new.shape[1]] = new.to(buf.dtype)
        self.lengths[b:b + 1].fill_(length)
        return self


def absorb_temp(kv: BatchedKVCache, temp: BatchedKVCache, slots: torch.Tensor,
                rows: torch.Tensor | None = None) -> BatchedKVCache:
    """Install a flood's prefill (runtime/engine.py::_admit_batch): the
    positions [0, S) and the length of temp row rows[i] into live slot
    slots[i] (device index vectors; rows by default the temp cache's first
    len(slots) rows), in place; no other slot is written (the reference's
    `_absorb_temp`, engine.py:143-168, where temp row b is slot b)."""
    S = temp.max_seq
    pairs = list(zip(kv.k + kv.v, temp.k + temp.v))
    if kv.quantized:
        pairs += list(zip(kv.k_d + kv.v_d, temp.k_d + temp.v_d))

    def take(t):
        return t[:slots.shape[0]] if rows is None else t.index_select(0, rows)

    for buf, t in pairs:
        buf[slots, :, :S] = take(t).to(buf.dtype)
    kv.lengths[slots] = take(temp.lengths)
    return kv
