"""Plain reference of Mixtral-8x7B (HF MixtralForCausalLM, mistralai/
Mixtral-8x7B-v0.1) over the benchmark's seeded Q4_K_M blocks, in float32.

The published layer: RMSNorm → q, k, v (GQA, NeoX rotary over the whole
head at θ = rope_theta) → causal softmax attention → o; RMSNorm → router
(softmax over the experts, top-k, the chosen weights renormalised; ties to
the lower index) → Σ w · down(silu(gate(x)) · up(x)) over the chosen
experts; final RMSNorm → the head. Norm gains are ones; the router is
~N(0, 0.02²), drawn from the seed like every matrix.

Matrix types: llama.cpp's LLAMA_FTYPE_MOSTLY_Q4_K_M without an importance
matrix for a model of 8 experts (llama_tensor_get_type): Q8_0 attn_k and
attn_v, Q5_K attn_output, Q6_K ffn_down_exps in the use_more_bits layers
and Q6_K output, Q4_K everything else (token_embd included)."""
from __future__ import annotations

import torch

from .. import quant
from .common import Arith, no_tf32, rms_norm, rope_neox, scored_rows


def use_more_bits(layer: int, n_layer: int) -> bool:
    """llama.cpp's use_more_bits: the first and last eighth of the layers
    and every third layer between."""
    e = n_layer // 8
    return layer < e or layer >= 7 * n_layer // 8 or (layer - e) % 3 == 2


def sizes(hp: dict) -> dict:
    return dict(V=hp["vocab_size"], D=hp["hidden_size"], L=hp["num_hidden_layers"],
                H=hp["num_attention_heads"], KVH=hp["num_key_value_heads"],
                FF=hp["intermediate_size"], E=hp["num_local_experts"],
                U=hp["num_experts_per_tok"], theta=float(hp["rope_theta"]),
                eps=float(hp["rms_norm_eps"]))


def matrices(hp: dict):
    """(name, layer or None, rows, cols, experts, type) of every quantized
    matrix; a stack of experts has rows per expert and experts > 0."""
    s = sizes(hp)
    D, FF, E, L = s["D"], s["FF"], s["E"], s["L"]
    kvd = s["KVH"] * (D // s["H"])
    yield "token_embd.weight", None, s["V"], D, 0, "Q4_K"
    yield "output.weight", None, s["V"], D, 0, "Q6_K"
    for i in range(L):
        b = f"blk.{i}."
        yield b + "attn_q.weight", i, D, D, 0, "Q4_K"
        yield b + "attn_k.weight", i, kvd, D, 0, "Q8_0"
        yield b + "attn_v.weight", i, kvd, D, 0, "Q8_0"
        yield b + "attn_output.weight", i, D, D, 0, "Q5_K"
        yield b + "ffn_gate_exps.weight", i, FF, D, E, "Q4_K"
        yield b + "ffn_up_exps.weight", i, FF, D, E, "Q4_K"
        yield b + "ffn_down_exps.weight", i, D, FF, E, \
            "Q6_K" if use_more_bits(i, L) else "Q4_K"


def _weights(hp: dict, seed: int, layer, device) -> dict:
    """Layer `layer`'s matrices (None: the embedding and the head),
    dequantized to f32; expert stacks as (E, rows, cols)."""
    out = {}
    for name, li, rows, cols, e, qt in matrices(hp):
        if li != layer:
            continue
        raw = quant.wire(seed, name, qt, rows * max(e, 1), cols, device)
        w = quant.dequantize(qt, raw, cols)
        out[name.split(".")[-2]] = w.reshape(e, rows, cols) if e else w
    return out


@torch.no_grad()
def logits(hp: dict, seed: int, seqs, device, low: bool = False, routes=None) -> torch.Tensor:
    """The reference's logits (f32) at every row that predicts a served
    token of `seqs` ([(prompt, served)], common.scored_rows' order), the
    whole sequences run through layer by layer. low: every product's
    operands rounded to float8 (the control). routes: a list that gets each
    layer's chosen experts (rows, U)."""
    no_tf32()
    s = sizes(hp)
    D, H, KVH, E, U = s["D"], s["H"], s["KVH"], s["E"], s["U"]
    HD = D // H
    ar = Arith(low)
    toks = [list(p) + list(o[:-1]) for p, o in seqs]
    lens = [len(t) for t in toks]
    ids = torch.tensor(sum(toks, []), device=device)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    top = _weights(hp, seed, None, device)
    x = top["token_embd"][ids]
    del top
    for li in range(s["L"]):
        w = _weights(hp, seed, li, device)
        h = rms_norm(x, s["eps"])
        q = rope_neox(ar.mm(h, w["attn_q"]).reshape(-1, H, HD), pos, s["theta"])
        k = rope_neox(ar.mm(h, w["attn_k"]).reshape(-1, KVH, HD), pos, s["theta"])
        v = ar.mm(h, w["attn_v"]).reshape(-1, KVH, HD)
        att = torch.cat([ar.attend(qs, ks, vs, HD ** -0.5) for qs, ks, vs in
                         zip(q.split(lens), k.split(lens), v.split(lens))])
        x = x + ar.mm(att, w["attn_output"])
        h2 = rms_norm(x, s["eps"])
        gate_inp = quant.dense(seed, f"blk.{li}.ffn_gate_inp.weight", (E, D), device)
        probs = torch.softmax(ar.mm(h2, gate_inp), dim=-1)
        pw, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        pw, idx = pw[:, :U], idx[:, :U]
        pw = pw / pw.sum(-1, keepdim=True)
        if routes is not None:
            routes.append(idx)
        y = torch.zeros_like(x)
        for e in range(E):
            t, j = torch.nonzero(idx == e, as_tuple=True)
            if t.numel() == 0:
                continue
            he = h2[t]
            a = torch.nn.functional.silu(ar.mm(he, w["ffn_gate_exps"][e])) \
                * ar.mm(he, w["ffn_up_exps"][e])
            y.index_add_(0, t, ar.mm(a, w["ffn_down_exps"][e]) * pw[t, j, None])
        x = x + y
        del w
    rows, _ = scored_rows(seqs)
    head = _weights(hp, seed, None, device)["output"]
    return ar.mm(rms_norm(x[rows], s["eps"]), head)


def products(hp: dict) -> list:
    """The matrices a forward multiplies by (the embedding is a row gather)."""
    return [m for m in matrices(hp) if m[0] != "token_embd.weight"]


def active_params(hp: dict) -> float:
    """Parameters a token's forward multiplies by: attention, U of E
    experts, the router and the head."""
    s = sizes(hp)
    n = 0.0
    for name, _, r, c, e, _ in products(hp):
        n += r * c * (s["U"] if e else 1)
    return n + s["L"] * s["E"] * s["D"]
