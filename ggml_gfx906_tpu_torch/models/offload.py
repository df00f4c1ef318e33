"""Layer offload split, the `-ngl` analogue — the port of
ggml_gfx906_tpu/models/offload.py.

Layers [0, n_dev) and the embedding run on `device` (the card), layers
[n_dev, L), the final norm and the head on `host_device` (the CPU), with one
hidden-state copy at the boundary. The host side runs the kernels' plain
versions because the caller placed those layers on the CPU: that is the
split asked for, not a fallback. Each side keeps the KV cache of its own
layers.

    split = OffloadSplit.build(cfg, params, n_device_layers=24)
    kvs = split.make_caches(max_seq)
    logits, kvs = split.forward(tokens, kvs, start)    # logits on the host

Dense llama params and the expert llama's (models/moe.py) are split alike:
the caller of an expert llama passes its FFN sublayer,
`OffloadSplit.build(cfg, params, n, ffn=moe.block_ffn(cfg))`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.quantized import QuantTensor, embed_rows
from ..runtime.kv_cache import KVCache
from ..utils.device import resolve
from . import llama as llama_mod


def _place(tree, device):
    """A copy of a params tree on `device` (QuantTensor fields included)."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(v, device) for v in tree]
    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.qtype, tree.shape,
                           {k: v.to(device) for k, v in tree.fields.items()}, tree.layout)
    return tree.to(device)


@dataclass
class OffloadSplit:
    """A llama (dense or expert) split over two devices: layers [0, n_dev)
    and the embedding on `device`, layers [n_dev, L) and the head on
    `host_device`."""

    cfg: object
    n_dev: int
    dev_params: dict
    host_params: dict
    device: torch.device
    host_device: torch.device
    ffn: object

    @classmethod
    def build(cls, cfg, params: dict, n_device_layers: int, device=None,
              host_device="cpu", ffn=llama_mod._block_ffn) -> "OffloadSplit":
        """device: the card unless asked (raises without one); host_device:
        the CPU unless asked; ffn: each block's residual FFN sublayer, as
        in llama._layers (the dense SwiGLU unless given; models/moe.py's
        block_ffn(cfg) for an expert llama). A head tied to the embedding
        needs lm_head in params: the host side holds no embedding
        (reference :116-118)."""
        device, host_device = resolve(device), resolve(host_device)
        if "lm_head" not in params:
            raise ValueError("tied embeddings need lm_head on the host side; pass params "
                             "with lm_head")
        n_dev = min(n_device_layers, cfg.n_layer)
        dev_p = _place({"wte": params["wte"], "blocks": params["blocks"][:n_dev]}, device)
        host_p = _place({"out_norm": params["out_norm"], "lm_head": params["lm_head"],
                         "blocks": params["blocks"][n_dev:]}, host_device)
        return cls(cfg, n_dev, dev_p, host_p, device, host_device, ffn)

    def make_caches(self, max_seq: int) -> tuple[KVCache, KVCache]:
        """(the device side's cache of n_dev layers, the host side's of the
        rest)."""
        cfg = self.cfg

        def mk(n, dev):
            return KVCache.create(n, max_seq, cfg.n_kv_head, cfg.head_dim, cfg.compute_dtype,
                                  device=dev)
        return mk(self.n_dev, self.device), mk(cfg.n_layer - self.n_dev, self.host_device)

    @torch.inference_mode()
    def forward(self, tokens, kvs, start: int):
        """tokens (S,) at positions [start, start+S) → (logits (S, V) f32 on
        the host, (kv_dev, kv_host)). One hidden-state copy crosses the
        boundary."""
        cfg, ffn = self.cfg, self.ffn
        kv_dev, kv_host = kvs
        toks = torch.as_tensor(tokens).to(self.device)
        pos_b, pos = llama_mod._positions(toks, start)
        x = embed_rows(self.dev_params["wte"], toks).to(cfg.compute_dtype)
        x = llama_mod._layers(cfg, self.dev_params["blocks"], x, kv_dev, start, pos_b, pos, ffn)
        x = x.to(self.host_device)                       # the boundary copy
        pos_b, pos = pos_b.to(self.host_device), pos.to(self.host_device)
        x = llama_mod._layers(cfg, self.host_params["blocks"], x, kv_host, start, pos_b, pos,
                              ffn)
        S = toks.shape[0]
        return llama_mod._head(cfg, self.host_params, x), (kv_dev.advance(S), kv_host.advance(S))


def _tree_bytes(tree) -> int:
    """Bytes of a params tree as held on its device (QuantTensor fields at
    their stored size)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, QuantTensor):
        return tree.nbytes
    return tree.numel() * tree.element_size()


def auto_split(cfg, params: dict, max_seq: int, device=None, budget_bytes: int | None = None,
               headroom: float = 0.85) -> int:
    """The largest n_device_layers whose weights and KV fit `headroom` ×
    the device's free memory (torch.cuda.mem_get_info on the card;
    `budget_bytes` where given, and required for the CPU): the embedding
    is charged to the device side first, then each layer's tensors and its
    KV at max_seq, in order (reference :132-171)."""
    device = resolve(device)
    if budget_bytes is None:
        if device.type != "cuda":
            raise ValueError("the device reports no free memory; pass budget_bytes")
        budget_bytes = torch.cuda.mem_get_info(device)[0]
    budget = int(budget_bytes * headroom)
    itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
    kv_layer = 2 * max_seq * cfg.n_kv_head * cfg.head_dim * itemsize
    fixed = _tree_bytes(params["wte"])
    n = 0
    for blk in params["blocks"]:
        need = _tree_bytes(blk) + kv_layer
        if fixed + need > budget:
            break
        fixed += need
        n += 1
    return n
