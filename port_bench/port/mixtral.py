"""Mixtral-8x7B on the port: models/moe.py over the seeded Q4_K_M blocks
(ref/mixtral.py's matrices), bf16 compute."""
from __future__ import annotations

import torch

from ggml_gfx906_tpu_torch.models import moe

from .. import quant
from ..ref import mixtral as ref
from .common import matrix, ones


def build(hp: dict, seed: int, device, compute_dtype=torch.bfloat16):
    """(model module, config, params) as moe.load would give them for a
    GGUF holding these blocks."""
    s = ref.sizes(hp)
    cfg = moe.MoEConfig(n_vocab=s["V"], n_ctx=hp["max_position_embeddings"], n_embd=s["D"],
                        n_head=s["H"], n_kv_head=s["KVH"], n_layer=s["L"], n_ff=s["FF"],
                        n_expert=s["E"], n_expert_used=s["U"], rms_eps=s["eps"],
                        rope_base=s["theta"], compute_dtype=compute_dtype)
    m = {(li, name.split(".")[-2]): matrix(seed, name, qt, r, c, e, device)
         for name, li, r, c, e, qt in ref.matrices(hp)}
    p = {"wte": m[None, "token_embd"], "lm_head": m[None, "output"],
         "out_norm": ones(s["D"], device), "blocks": []}
    for i in range(s["L"]):
        p["blocks"].append({
            "attn_norm": ones(s["D"], device), "ffn_norm": ones(s["D"], device),
            "wq": m[i, "attn_q"], "wk": m[i, "attn_k"], "wv": m[i, "attn_v"],
            "wo": m[i, "attn_output"],
            "gate_inp": quant.dense(seed, f"blk.{i}.ffn_gate_inp.weight", (s["E"], s["D"]),
                                    device),
            "gate_exps": m[i, "ffn_gate_exps"], "up_exps": m[i, "ffn_up_exps"],
            "down_exps": m[i, "ffn_down_exps"]})
    return moe, cfg, p
