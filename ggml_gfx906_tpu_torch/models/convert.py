"""Model converters: Hugging Face state dicts → GGUF.

The port of ggml_gfx906_tpu/models/convert.py: llama.cpp-compatible GGUF
schemas written directly, with the per-tensor type policy of
ggml_common_quantize_0 (examples/common-ggml.cpp:41: only the 2-D matmul
weights are quantized; norms and biases stay f32; a row that is not whole
blocks of the type falls back to f16). Given the same state dict and
ftype, a file is byte-identical to the reference's.

The tensors stay on the device they are given until the writer takes
their bytes: F16 and F32 conversions run there, and a quantized ftype's
codecs run on `device` (the card unless device="cpu"; only a quantized
ftype asks for a device).
"""
from __future__ import annotations

import re

import torch

from ..gguf import GGUFWriter
from ..quant.types import GGMLType, TYPE_TRAITS
from ..utils.device import resolve

# tensor-name patterns eligible for quantization (ref: quantize.cpp's
# to_quant lists, the 2-D weight matrices)
QUANT_PATTERNS = [
    r"token_embd\.weight",
    r"output\.weight",
    r"blk\.\d+\.attn_qkv\.weight",
    r"blk\.\d+\.attn_output\.weight",
    r"blk\.\d+\.(attn_q|attn_k|attn_v)\.weight",
    r"blk\.\d+\.ffn_(up|down|gate)\.weight",
]


def _pick_type(name: str, arr, ftype: GGMLType) -> GGMLType:
    if ftype == GGMLType.F32 or arr.dim() != 2:
        return GGMLType.F32
    if not any(re.fullmatch(p, name) for p in QUANT_PATTERNS):
        return GGMLType.F32
    if arr.shape[-1] % TYPE_TRAITS[ftype].blck_size != 0:
        return GGMLType.F16  # the fallback of ggml's incompatible-ne[0] path
    return ftype


def _getter(state_dict):
    def t(name):
        return state_dict[name].detach().to(torch.float32)
    return t


def _writer(ftype: GGMLType, device):
    """A GGUFWriter and the device its quantized tensors go to: resolved
    (the card unless asked) only when ftype is quantized."""
    return GGUFWriter(), resolve(device) if TYPE_TRAITS[ftype].is_quantized else None


def _put(w: GGUFWriter, dev, name: str, arr, ttype: GGMLType):
    w.add_array_tensor(name, arr.to(dev) if TYPE_TRAITS[ttype].is_quantized else arr, ttype)


def _add(w: GGUFWriter, dev, name: str, arr, ftype: GGMLType):
    _put(w, dev, name, arr, _pick_type(name, arr, ftype))


def convert_llama(state_dict: dict, config, path, ftype: GGMLType = GGMLType.F32,
                  tokens: list[str] | None = None, scores: list[float] | None = None,
                  token_types: list[int] | None = None, device=None):
    """HF LlamaForCausalLM state_dict → llama GGUF. No q/k permutation:
    HF's rotate_half rotary is ggml's NEOX pairwise rotation, so weights map
    1:1."""
    t = _getter(state_dict)
    w, dev = _writer(ftype, device)
    w.set("general.architecture", "llama")
    w.set("general.name", "llama")
    w.set("llama.vocab_size", int(config.vocab_size))
    w.set("llama.context_length", int(config.max_position_embeddings))
    w.set("llama.embedding_length", int(config.hidden_size))
    w.set("llama.block_count", int(config.num_hidden_layers))
    w.set("llama.feed_forward_length", int(config.intermediate_size))
    w.set("llama.attention.head_count", int(config.num_attention_heads))
    w.set("llama.attention.head_count_kv", int(config.num_key_value_heads))
    w.set("llama.attention.layer_norm_rms_epsilon", float(config.rms_norm_eps))
    w.set("llama.rope.freq_base", float(getattr(config, "rope_theta", 10000.0)))
    if tokens is not None:
        w.set("tokenizer.ggml.model", "llama")
        w.set("tokenizer.ggml.tokens", tokens)
        if scores is not None:
            w.set("tokenizer.ggml.scores", [float(s) for s in scores])
        if token_types is not None:
            w.set("tokenizer.ggml.token_type", [int(x) for x in token_types])
        w.set("tokenizer.ggml.bos_token_id", 1)
        w.set("tokenizer.ggml.eos_token_id", 2)
        w.set("tokenizer.ggml.unknown_token_id", 0)

    _add(w, dev, "token_embd.weight", t("model.embed_tokens.weight"), ftype)
    _add(w, dev, "output_norm.weight", t("model.norm.weight"), ftype)
    if "lm_head.weight" in state_dict:
        _add(w, dev, "output.weight", t("lm_head.weight"), ftype)
    for i in range(config.num_hidden_layers):
        hf = f"model.layers.{i}."
        gg = f"blk.{i}."
        _add(w, dev, gg + "attn_norm.weight", t(hf + "input_layernorm.weight"), ftype)
        _add(w, dev, gg + "attn_q.weight", t(hf + "self_attn.q_proj.weight"), ftype)
        _add(w, dev, gg + "attn_k.weight", t(hf + "self_attn.k_proj.weight"), ftype)
        _add(w, dev, gg + "attn_v.weight", t(hf + "self_attn.v_proj.weight"), ftype)
        _add(w, dev, gg + "attn_output.weight", t(hf + "self_attn.o_proj.weight"), ftype)
        _add(w, dev, gg + "ffn_norm.weight", t(hf + "post_attention_layernorm.weight"), ftype)
        _add(w, dev, gg + "ffn_gate.weight", t(hf + "mlp.gate_proj.weight"), ftype)
        _add(w, dev, gg + "ffn_up.weight", t(hf + "mlp.up_proj.weight"), ftype)
        _add(w, dev, gg + "ffn_down.weight", t(hf + "mlp.down_proj.weight"), ftype)
    w.write(path)
    return path


def convert_gptj(state_dict: dict, config, path, ftype: GGMLType = GGMLType.F32,
                 tokens: list[str] | None = None, device=None):
    """HF GPTJForCausalLM state_dict → gptj GGUF. HF Linear is (out, in):
    no transpose (unlike gpt2's Conv1D). Rotary is interleaved (ggml NORMAL
    mode); weights map 1:1."""
    t = _getter(state_dict)
    w, dev = _writer(ftype, device)
    w.set("general.architecture", "gptj")
    w.set("gptj.vocab_size", int(config.vocab_size))
    w.set("gptj.context_length", int(config.n_positions))
    w.set("gptj.embedding_length", int(config.n_embd))
    w.set("gptj.block_count", int(config.n_layer))
    w.set("gptj.attention.head_count", int(config.n_head))
    w.set("gptj.rope.dimension_count", int(config.rotary_dim))
    w.set("gptj.attention.layer_norm_epsilon", float(config.layer_norm_epsilon))
    if tokens is not None:
        w.set("tokenizer.ggml.model", "gpt2")
        w.set("tokenizer.ggml.tokens", tokens)

    _add(w, dev, "token_embd.weight", t("transformer.wte.weight"), ftype)
    _add(w, dev, "output_norm.weight", t("transformer.ln_f.weight"), ftype)
    _add(w, dev, "output_norm.bias", t("transformer.ln_f.bias"), ftype)
    _add(w, dev, "output.weight", t("lm_head.weight"), ftype)
    _add(w, dev, "output.bias", t("lm_head.bias"), ftype)
    for i in range(config.n_layer):
        hf = f"transformer.h.{i}."
        gg = f"blk.{i}."
        _add(w, dev, gg + "attn_norm.weight", t(hf + "ln_1.weight"), ftype)
        _add(w, dev, gg + "attn_norm.bias", t(hf + "ln_1.bias"), ftype)
        _add(w, dev, gg + "attn_q.weight", t(hf + "attn.q_proj.weight"), ftype)
        _add(w, dev, gg + "attn_k.weight", t(hf + "attn.k_proj.weight"), ftype)
        _add(w, dev, gg + "attn_v.weight", t(hf + "attn.v_proj.weight"), ftype)
        _add(w, dev, gg + "attn_output.weight", t(hf + "attn.out_proj.weight"), ftype)
        _add(w, dev, gg + "ffn_up.weight", t(hf + "mlp.fc_in.weight"), ftype)
        _add(w, dev, gg + "ffn_up.bias", t(hf + "mlp.fc_in.bias"), ftype)
        _add(w, dev, gg + "ffn_down.weight", t(hf + "mlp.fc_out.weight"), ftype)
        _add(w, dev, gg + "ffn_down.bias", t(hf + "mlp.fc_out.bias"), ftype)
    w.write(path)
    return path


def convert_gpt2(state_dict: dict, config, path, ftype: GGMLType = GGMLType.F32,
                 tokens: list[str] | None = None, merges: list[str] | None = None,
                 device=None):
    """HF GPT2LMHeadModel state_dict → gpt2 GGUF. HF's Conv1D stores
    weights (in, out) and ggml's mul_mat wants (out, in): transposed here,
    as the reference converter does."""
    t = _getter(state_dict)
    w, dev = _writer(ftype, device)
    w.set("general.architecture", "gpt2")
    w.set("general.name", "gpt2")
    w.set("gpt2.vocab_size", int(config.vocab_size))
    w.set("gpt2.context_length", int(config.n_positions))
    w.set("gpt2.embedding_length", int(config.n_embd))
    w.set("gpt2.block_count", int(config.n_layer))
    w.set("gpt2.attention.head_count", int(config.n_head))
    w.set("gpt2.attention.layer_norm_epsilon", float(config.layer_norm_epsilon))
    if tokens is not None:
        w.set("tokenizer.ggml.model", "gpt2")
        w.set("tokenizer.ggml.tokens", tokens)
    if merges is not None:
        w.set("tokenizer.ggml.merges", merges)

    _add(w, dev, "token_embd.weight", t("transformer.wte.weight"), ftype)
    _add(w, dev, "position_embd.weight", t("transformer.wpe.weight"), ftype)
    _add(w, dev, "output_norm.weight", t("transformer.ln_f.weight"), ftype)
    _add(w, dev, "output_norm.bias", t("transformer.ln_f.bias"), ftype)
    for i in range(config.n_layer):
        hf = f"transformer.h.{i}."
        gg = f"blk.{i}."
        _add(w, dev, gg + "attn_norm.weight", t(hf + "ln_1.weight"), ftype)
        _add(w, dev, gg + "attn_norm.bias", t(hf + "ln_1.bias"), ftype)
        _add(w, dev, gg + "attn_qkv.weight", t(hf + "attn.c_attn.weight").T, ftype)
        _add(w, dev, gg + "attn_qkv.bias", t(hf + "attn.c_attn.bias"), ftype)
        _add(w, dev, gg + "attn_output.weight", t(hf + "attn.c_proj.weight").T, ftype)
        _add(w, dev, gg + "attn_output.bias", t(hf + "attn.c_proj.bias"), ftype)
        _add(w, dev, gg + "ffn_norm.weight", t(hf + "ln_2.weight"), ftype)
        _add(w, dev, gg + "ffn_norm.bias", t(hf + "ln_2.bias"), ftype)
        _add(w, dev, gg + "ffn_up.weight", t(hf + "mlp.c_fc.weight").T, ftype)
        _add(w, dev, gg + "ffn_up.bias", t(hf + "mlp.c_fc.bias"), ftype)
        _add(w, dev, gg + "ffn_down.weight", t(hf + "mlp.c_proj.weight").T, ftype)
        _add(w, dev, gg + "ffn_down.bias", t(hf + "mlp.c_proj.bias"), ftype)
    w.write(path)
    return path


def convert_mixtral(state_dict: dict, config, path, ftype: GGMLType = GGMLType.F32,
                    device=None):
    """HF MixtralForCausalLM state_dict → the Mixtral-convention GGUF
    (arch llama + llama.expert_count, stacked blk.N.ffn_*_exps tensors, the
    llama.cpp schema). An expert stack is quantized per 2-D expert slice
    (its rows quantize independently: the bytes of per-expert tensors)."""
    t = _getter(state_dict)
    w, dev = _writer(ftype, device)
    w.set("general.architecture", "llama")
    w.set("general.name", "mixtral")
    w.set("llama.vocab_size", int(config.vocab_size))
    w.set("llama.context_length", int(config.max_position_embeddings))
    w.set("llama.embedding_length", int(config.hidden_size))
    w.set("llama.block_count", int(config.num_hidden_layers))
    w.set("llama.feed_forward_length", int(config.intermediate_size))
    w.set("llama.attention.head_count", int(config.num_attention_heads))
    w.set("llama.attention.head_count_kv", int(config.num_key_value_heads))
    w.set("llama.attention.layer_norm_rms_epsilon", float(config.rms_norm_eps))
    w.set("llama.rope.freq_base", float(getattr(config, "rope_theta", 10000.0)))
    w.set("llama.expert_count", int(config.num_local_experts))
    w.set("llama.expert_used_count", int(config.num_experts_per_tok))

    def add_exps(name, arrs):
        stacked = torch.stack(arrs)                     # (E, n_out, K)
        if ftype != GGMLType.F32 and stacked.shape[-1] % TYPE_TRAITS[ftype].blck_size == 0:
            _put(w, dev, name, stacked, ftype)
        else:
            _put(w, dev, name, stacked, GGMLType.F32)

    _add(w, dev, "token_embd.weight", t("model.embed_tokens.weight"), ftype)
    _add(w, dev, "output_norm.weight", t("model.norm.weight"), ftype)
    if "lm_head.weight" in state_dict:
        _add(w, dev, "output.weight", t("lm_head.weight"), ftype)
    E = int(config.num_local_experts)
    for i in range(config.num_hidden_layers):
        hf = f"model.layers.{i}."
        gg = f"blk.{i}."
        _add(w, dev, gg + "attn_norm.weight", t(hf + "input_layernorm.weight"), ftype)
        for s, d in (("q", "attn_q"), ("k", "attn_k"), ("v", "attn_v"), ("o", "attn_output")):
            _add(w, dev, gg + d + ".weight", t(hf + f"self_attn.{s}_proj.weight"), ftype)
        _add(w, dev, gg + "ffn_norm.weight", t(hf + "post_attention_layernorm.weight"), ftype)
        _put(w, dev, gg + "ffn_gate_inp.weight", t(hf + "block_sparse_moe.gate.weight"),
             GGMLType.F32)
        moe = hf + "block_sparse_moe.experts."
        add_exps(gg + "ffn_gate_exps.weight", [t(moe + f"{e}.w1.weight") for e in range(E)])
        add_exps(gg + "ffn_down_exps.weight", [t(moe + f"{e}.w2.weight") for e in range(E)])
        add_exps(gg + "ffn_up_exps.weight", [t(moe + f"{e}.w3.weight") for e in range(E)])
    w.write(path)
    return path
