"""Plain reference of GPT-2-large (HF GPT2LMHeadModel, openai-community/
gpt2-large) over the benchmark's seeded Q4_K_M blocks, in float32.

The published block: LayerNorm → fused qkv with bias → causal softmax
attention → projection with bias; LayerNorm → up with bias → gelu (tanh)
→ down with bias; learned position embeddings; final LayerNorm; the head
tied to the token embedding. Norm gains are ones; biases, norm biases and
position embeddings are ~N(0, 0.02²), drawn from the seed.

Matrix types: llama.cpp's LLAMA_FTYPE_MOSTLY_Q4_K_M without an importance
matrix (llama_tensor_get_type): Q5_K attn_qkv, Q6_K token_embd (the tied
head), Q6_K ffn_down in the use_more_bits layers, Q4_K everything else."""
from __future__ import annotations

import torch

from .. import quant
from .common import Arith, gelu_tanh, layer_norm, no_tf32, scored_rows
from .mixtral import use_more_bits

# (name, shape in units of n_embd D) of the f32 tensors drawn ~N(0, 0.02²);
# the norms' gains are ones
BIASES = (("attn_norm.bias", 1), ("attn_qkv.bias", 3), ("attn_output.bias", 1),
          ("ffn_norm.bias", 1), ("ffn_up.bias", 4), ("ffn_down.bias", 1))


def sizes(hp: dict) -> dict:
    return dict(V=hp["vocab_size"], D=hp["n_embd"], L=hp["n_layer"], H=hp["n_head"],
                P=hp["n_positions"], eps=float(hp["layer_norm_epsilon"]))


def matrices(hp: dict):
    """(name, layer or None, rows, cols, experts (0), type) of every
    quantized matrix."""
    s = sizes(hp)
    D, L = s["D"], s["L"]
    yield "token_embd.weight", None, s["V"], D, 0, "Q6_K"
    for i in range(L):
        b = f"blk.{i}."
        yield b + "attn_qkv.weight", i, 3 * D, D, 0, "Q5_K"
        yield b + "attn_output.weight", i, D, D, 0, "Q4_K"
        yield b + "ffn_up.weight", i, 4 * D, D, 0, "Q4_K"
        yield b + "ffn_down.weight", i, D, 4 * D, 0, "Q6_K" if use_more_bits(i, L) else "Q4_K"


def _weights(hp: dict, seed: int, layer, device) -> dict:
    out = {}
    for name, li, rows, cols, _, qt in matrices(hp):
        if li == layer:
            raw = quant.wire(seed, name, qt, rows, cols, device)
            out[name.split(".")[-2]] = quant.dequantize(qt, raw, cols)
    return out


@torch.no_grad()
def logits(hp: dict, seed: int, seqs, device, low: bool = False) -> torch.Tensor:
    """As ref/mixtral.py's `logits`, for GPT-2."""
    no_tf32()
    s = sizes(hp)
    D, H = s["D"], s["H"]
    HD = D // H
    ar = Arith(low)
    toks = [list(p) + list(o[:-1]) for p, o in seqs]
    lens = [len(t) for t in toks]
    ids = torch.tensor(sum(toks, []), device=device)
    pos = torch.cat([torch.arange(n, device=device) for n in lens])
    wte = _weights(hp, seed, None, device)["token_embd"]
    wpe = quant.dense(seed, "position_embd.weight", (s["P"], D), device)
    x = wte[ids] + wpe[pos]
    ones = torch.ones(D, device=device)
    for li in range(s["L"]):
        w = _weights(hp, seed, li, device)
        b = {n.split(".")[0]: quant.dense(seed, f"blk.{li}.{n}", (k * D,), device)
             for n, k in BIASES}
        h = layer_norm(x, ones, b["attn_norm"], s["eps"])
        q, k, v = (ar.mm(h, w["attn_qkv"]) + b["attn_qkv"]).split(D, dim=-1)
        att = torch.cat([ar.attend(qs.reshape(-1, H, HD), ks.reshape(-1, H, HD),
                                   vs.reshape(-1, H, HD), HD ** -0.5)
                         for qs, ks, vs in zip(q.split(lens), k.split(lens), v.split(lens))])
        x = x + ar.mm(att, w["attn_output"]) + b["attn_output"]
        h2 = layer_norm(x, ones, b["ffn_norm"], s["eps"])
        x = x + ar.mm(gelu_tanh(ar.mm(h2, w["ffn_up"]) + b["ffn_up"]), w["ffn_down"]) \
            + b["ffn_down"]
        del w
    rows, _ = scored_rows(seqs)
    nb = quant.dense(seed, "output_norm.bias", (D,), device)
    return ar.mm(layer_norm(x[rows], ones, nb, s["eps"]), wte)


def products(hp: dict) -> list:
    """The matrices a forward multiplies by: every one, token_embd as the
    tied head."""
    return list(matrices(hp))


def active_params(hp: dict) -> float:
    return float(sum(r * c for _, _, r, c, _, _ in products(hp)))
