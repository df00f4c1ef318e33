"""Paged KV pool: fixed-size pages + per-slot page tables, the counterpart
of ggml_gfx906_tpu/runtime/paged_kv.py::PagedKVCache. One pool is one of
the reference's pool groups: a dp × tp mesh engine (runtime/engine.py)
holds one pool per data-parallel rank, page ids group-local, where the
reference holds the dp groups in one pool sharded on its page axis.

The dense BatchedKVCache reserves max_batch × max_seq positions per layer
up front. Here the pool holds `total_pages` pages of `page_size` positions
shared by all slots, plus one scratch page (the last id); each slot owns a
page-table row, so device memory scales with live tokens. The page table
is a (B, max_pages) int32 tensor on the device, written in place, so the
engine's captured programs read its current rows at every replay. Page
allocation is host-side and deterministic (the engine's free list); the
device only sees the table. Every table entry starts at the scratch page:
inactive slots still issue masked decode writes, which must not land in a
page another slot owns, and the engine resets a freed slot's row to it.

Drop-in for BatchedKVCache in the decode path: `update_layer` (a scatter
to (page, offset)) and `layer_kv` (a page gather to a windowed dense
view). The engine's scan windows instead gather the window once
(`gather_window`), run the dense window program on that view and scatter
the window's rows back (`absorb`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .batched_kv import BatchedKVCache
from .kv_cache import quantize_rows


@dataclass
class PagedKVCache:
    k: list                 # per layer: (total_pages + 1, n_kv_head, page, head_dim)
    v: list
    k_d: list               # per layer: (total_pages + 1, n_kv_head, page) f32, or []
    v_d: list
    page_table: torch.Tensor   # (B, max_pages) int32 page ids
    lengths: torch.Tensor      # (B,) int32 valid positions per slot
    page_size: int

    @classmethod
    def create(cls, n_layer: int, max_batch: int, max_seq: int, n_kv_head: int,
               head_dim: int, total_pages: int, page_size: int = 64,
               dtype=torch.float32, quant: bool = False, device="cpu") -> "PagedKVCache":
        if max_seq % page_size:
            raise ValueError(f"max_seq {max_seq} is not a multiple of the page size "
                             f"{page_size}")
        shape = (total_pages + 1, n_kv_head, page_size, head_dim)
        buf = torch.zeros((2 * n_layer,) + shape, dtype=torch.int8 if quant else dtype,
                          device=device)
        kd = vd = []
        if quant:
            dbuf = torch.zeros((2 * n_layer,) + shape[:3], dtype=torch.float32, device=device)
            kd, vd = list(dbuf[:n_layer]), list(dbuf[n_layer:])
        pt = torch.full((max_batch, max_seq // page_size), total_pages, dtype=torch.int32,
                        device=device)
        return cls(list(buf[:n_layer]), list(buf[n_layer:]), kd, vd, pt,
                   torch.zeros(max_batch, dtype=torch.int32, device=device), page_size)

    @property
    def quantized(self) -> bool:
        return len(self.k_d) > 0

    @property
    def max_batch(self) -> int:
        return self.page_table.shape[0]

    @property
    def max_seq(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def total_pages(self) -> int:
        return self.k[0].shape[0] - 1          # usable, the scratch page excluded

    @property
    def scratch_page(self) -> int:
        return self.total_pages

    def with_lengths(self, lengths: torch.Tensor) -> "PagedKVCache":
        self.lengths.copy_(lengths)
        return self

    def _pools(self, layer: int):
        pools = [self.k[layer], self.v[layer]]
        return pools + ([self.k_d[layer], self.v_d[layer]] if self.quantized else [])

    def layer_kv(self, layer: int, window: int | None = None):
        """The windowed dense (B, H, W, D) view by page gather (a copy),
        with (B, H, W) scales when quantized. W is `window` rounded up to a
        page multiple; positions past a slot's length gather stale or
        scratch rows that the attention masks."""
        ps = self.page_size
        n = (self.page_table.shape[1] if window is None
             else -(-min(window, self.max_seq) // ps))
        pt = self.page_table[:, :n].to(torch.int64)          # (B, n)
        B = pt.shape[0]

        def dense(pool):     # (P, H, ps[, D]) → (B, H, n·ps[, D])
            g = pool[pt].transpose(1, 2)                    # (B, H, n, ps[, D])
            return g.reshape((B, g.shape[1], n * ps) + tuple(g.shape[4:]))

        out = [dense(p) for p in self._pools(layer)]
        return tuple(out) if self.quantized else (out[0], out[1], None, None)

    def gather_window(self, window: int) -> BatchedKVCache:
        """The pool's first `window` positions as a dense BatchedKVCache
        (the scan window's working cache) sharing this pool's `lengths`
        tensor, so steps that advance the view's lengths advance the
        pool's."""
        views = [self.layer_kv(li, window) for li in range(len(self.k))]
        kd = [t[2] for t in views] if self.quantized else []
        vd = [t[3] for t in views] if self.quantized else []
        return BatchedKVCache([t[0] for t in views], [t[1] for t in views], kd, vd,
                              self.lengths)

    def absorb(self, dense: BatchedKVCache, starts: torch.Tensor, depth: int,
               mask: torch.Tensor | None = None,
               slots: torch.Tensor | None = None) -> "PagedKVCache":
        """Scatter positions starts[b] .. starts[b]+depth-1 (clamped to
        max_seq - 1) of every layer of `dense` back through the page table,
        in place. mask (B,) bool: when given, only masked slots' rows land
        in their pages (the others on the scratch page) and only their
        lengths are taken from `dense` (a mesh flood's install); slots (R,)
        int64: dense's row i is slot slots[i], each row lands in its slot's
        pages and gives it its length (the flood's install); with neither
        `dense` is the scan window's view, whose lengths are the pool's."""
        ps = self.page_size
        pos = starts.to(torch.int64)[:, None] + torch.arange(depth, device=starts.device)
        pos = torch.clamp(pos, max=self.max_seq - 1)                          # (R, depth)
        table = self.page_table if slots is None else self.page_table[slots]
        pages = torch.gather(table.to(torch.int64), 1, pos // ps)
        if mask is not None:
            pages = torch.where(mask[:, None], pages, torch.full_like(pages, self.scratch_page))
        offs = pos % ps
        rows = torch.arange(pos.shape[0], device=pos.device)[:, None].expand_as(pos)
        srcs = [dense.k, dense.v] + ([dense.k_d, dense.v_d] if self.quantized else [])
        for li in range(len(self.k)):
            for pool, src in zip(self._pools(li), srcs):
                # (B, H, W[, D]) at (row, :, pos) → (B, depth, H[, D])
                pool[pages, :, offs] = src[li][rows, :, pos].to(pool.dtype)
        if slots is not None:
            self.lengths[slots] = dense.lengths
        elif mask is not None:
            self.lengths.copy_(torch.where(mask, dense.lengths, self.lengths))
        return self

    def update_layer(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                     start: torch.Tensor) -> "PagedKVCache":
        """Decode write: (B, 1, H, D) rows at per-slot positions start (B,),
        each to (page_table[b, start // ps], start % ps)."""
        B, S = k_new.shape[:2]
        if S != 1:
            raise ValueError("the paged cache takes single-token decode writes")
        ps = self.page_size
        start = start.to(torch.int64)
        pages = self.page_table[torch.arange(B, device=start.device), start // ps].to(torch.int64)
        offs = start % ps
        news = [k_new[:, 0], v_new[:, 0]]
        if self.quantized:
            (kq, kd), (vq, vd) = quantize_rows(news[0]), quantize_rows(news[1])
            news = [kq, vq, kd, vd]
        for pool, new in zip(self._pools(layer), news):
            pool[pages, :, offs] = new.to(pool.dtype)
        return self

    def set_slot(self, b: int, pages: torch.Tensor, k_slot, v_slot, length: int,
                 k_d=(), v_d=()) -> "PagedKVCache":
        """Install a prefilled single-sequence cache into slot b: its first
        n·page_size positions of per-layer (H, S, D) K/V (and (H, S) scales
        when quantized) into the pages `pages` (n,) int64 on the device,
        the page-table row's first n entries, and the slot's length."""
        ps = self.page_size
        n = pages.shape[0]
        srcs = [k_slot, v_slot] + ([k_d, v_d] if self.quantized else [])
        for li in range(len(self.k)):
            for pool, src in zip(self._pools(li), srcs):
                t = src[li][:, :n * ps]
                c = t.reshape((t.shape[0], n, ps) + tuple(t.shape[2:])).transpose(0, 1)
                pool[pages] = c.to(pool.dtype)
        self.page_table[b, :n] = pages.to(torch.int32)
        self.lengths[b:b + 1].fill_(length)
        return self
