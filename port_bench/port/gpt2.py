"""GPT-2-large on the port: models/gpt2.py over the seeded Q4_K_M blocks
(ref/gpt2.py's matrices), bf16 compute, the head tied to token_embd."""
from __future__ import annotations

import torch

from ggml_gfx906_tpu_torch.models import gpt2

from .. import quant
from ..ref import gpt2 as ref
from .common import matrix, ones


def build(hp: dict, seed: int, device, compute_dtype=torch.bfloat16):
    """(model module, config, params) as gpt2.load would give them."""
    s = ref.sizes(hp)
    D = s["D"]
    cfg = gpt2.GPT2Config(n_vocab=s["V"], n_ctx=s["P"], n_embd=D, n_head=s["H"],
                          n_layer=s["L"], ln_eps=s["eps"], compute_dtype=compute_dtype)
    m = {(li, name.split(".")[-2]): matrix(seed, name, qt, r, c, e, device)
         for name, li, r, c, e, qt in ref.matrices(hp)}

    def bias(li, name, k):
        return quant.dense(seed, f"blk.{li}.{name}", (k * D,), device)

    p = {"wte": m[None, "token_embd"],
         "wpe": quant.dense(seed, "position_embd.weight", (s["P"], D), device),
         "ln_f_g": ones(D, device), "ln_f_b": quant.dense(seed, "output_norm.bias", (D,), device),
         "blocks": []}
    for i in range(s["L"]):
        p["blocks"].append({
            "ln1_g": ones(D, device), "ln1_b": bias(i, "attn_norm.bias", 1),
            "qkv_w": m[i, "attn_qkv"], "qkv_b": bias(i, "attn_qkv.bias", 3),
            "proj_w": m[i, "attn_output"], "proj_b": bias(i, "attn_output.bias", 1),
            "ln2_g": ones(D, device), "ln2_b": bias(i, "ffn_norm.bias", 1),
            "up_w": m[i, "ffn_up"], "up_b": bias(i, "ffn_up.bias", 4),
            "down_w": m[i, "ffn_down"], "down_b": bias(i, "ffn_down.bias", 1)})
    return gpt2, cfg, p
