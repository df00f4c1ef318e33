"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same numpy inputs go through the JAX package and its PyTorch port."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.quant import quantize
from ggml_gfx906_tpu.quant.types import GGMLType


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Imported by a test file, runs its many small CPU ops on one torch
    thread: the tier-1 run shares the cores among its workers, where an
    intra-op thread pool per worker mostly waits on its own barriers.
    Restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(((got - ref) ** 2).mean() / max((ref ** 2).mean(), 1e-30))


def jax_params_to_numpy(params):
    """A JAX params pytree (any nesting of dicts and lists: the llama, moe,
    gpt2 and gptj trees) with numpy leaves; each QuantTensor as {"qtype",
    "shape", "layout", "fields"} (models/llama.params_from_numpy)."""
    if isinstance(params, JQuantTensor):
        return {"qtype": int(params.qtype), "shape": tuple(params.shape),
                "layout": params.layout,
                "fields": {k: np.asarray(v) for k, v in params.fields.items()}}
    if isinstance(params, dict):
        return {k: jax_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [jax_params_to_numpy(v) for v in params]
    return np.asarray(params)


def tiny_cfg(n_ctx: int = 128):
    """Tiny GQA llama whose matrix widths are multiples of 256 (Q4_K)."""
    return jllama.LlamaConfig(n_vocab=256, n_ctx=n_ctx, n_embd=256, n_head=4,
                              n_kv_head=2, n_layer=2, n_ff=512)


def port_cfg(jcfg):
    from ggml_gfx906_tpu_torch.models import llama as tllama

    return tllama.LlamaConfig(
        n_vocab=jcfg.n_vocab, n_ctx=jcfg.n_ctx, n_embd=jcfg.n_embd,
        n_head=jcfg.n_head, n_kv_head=jcfg.n_kv_head, n_layer=jcfg.n_layer,
        n_ff=jcfg.n_ff, rms_eps=jcfg.rms_eps, rope_base=jcfg.rope_base,
        rope_dims=jcfg.rope_dims, rope_freq_scale=jcfg.rope_freq_scale,
        compute_dtype=torch.float32)


def tiny_models(qtype=GGMLType.Q4_K, seed: int = 0, n_ctx: int = 128):
    """(jax cfg, jax params, port cfg, port params on the CPU)."""
    from ggml_gfx906_tpu_torch.models import llama as tllama

    jcfg = tiny_cfg(n_ctx)
    jp = jllama.random_params(jcfg, seed=seed, qtype=qtype)
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return jcfg, jp, port_cfg(jcfg), tp


# ---------------------------------------------------- llama file recipes
# A recipe maps (GGUF tensor name, layer or None, n_layer) to the tensor's
# type, as chip_smoke.RECIPES does for llama.cpp's file types.

PER_BLOCK = (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
             ("wo", "attn_output"), ("w_gate", "ffn_gate"), ("w_up", "ffn_up"),
             ("w_down", "ffn_down"))


def recipe_cfg(n_ff: int, n_layer: int = 2, n_ctx: int = 128, n_vocab: int = 256):
    """A tiny GQA llama whose matrix widths are multiples of 256."""
    return jllama.LlamaConfig(n_vocab=n_vocab, n_ctx=n_ctx, n_embd=256, n_head=4,
                              n_kv_head=2, n_layer=n_layer, n_ff=n_ff)


def recipe_matrices(cfg):
    """(port/JAX param key, GGUF name, layer, rows, cols) of every matrix."""
    D, V, FF = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    KVD = cfg.n_kv_head * cfg.head_dim
    shapes = {"attn_q": (D, D), "attn_k": (KVD, D), "attn_v": (KVD, D),
              "attn_output": (D, D), "ffn_gate": (FF, D), "ffn_up": (FF, D),
              "ffn_down": (D, FF)}
    yield "wte", "token_embd", None, V, D
    yield "lm_head", "output", None, V, D
    for i in range(cfg.n_layer):
        for key, name in PER_BLOCK:
            yield key, name, i, *shapes[name]


def recipe_weights(recipe, cfg, seed=0):
    """{(key, layer): (qtype, f32 matrix)} at ~N(0, 0.02), the recipe's types."""
    rng = np.random.default_rng(seed)
    return {(key, layer): (recipe(name, layer, cfg.n_layer),
                           (rng.standard_normal((r, c)) * 0.02).astype(np.float32))
            for key, name, layer, r, c in recipe_matrices(cfg)}


def recipe_jax_params(cfg, weights):
    """The JAX package's params of `weights` (quantized by its codecs), with
    norm weights of ones."""
    D = cfg.n_embd
    q = {k: JQuantTensor.quantize(t, w) for k, (t, w) in weights.items()}
    return {"wte": q[("wte", None)], "lm_head": q[("lm_head", None)],
            "out_norm": jnp.ones((D,)),
            "blocks": [dict({key: q[(key, i)] for key, _ in PER_BLOCK},
                            attn_norm=jnp.ones((D,)), ffn_norm=jnp.ones((D,)))
                       for i in range(cfg.n_layer)]}


def param_types(params):
    """{"wte" | "lm_head" | "<key>.<layer>": GGMLType} of a params tree of
    either package."""
    leaves = {"wte": params["wte"], "lm_head": params["lm_head"]}
    for i, b in enumerate(params["blocks"]):
        leaves.update({f"{k}.{i}": v for k, v in b.items() if k in dict(PER_BLOCK)})
    return {k: GGMLType(int(v.qtype)) for k, v in leaves.items()}


def recipe_logits(jcfg, jp, tcfg, tp, toks, max_seq: int = 128):
    """(port logits, JAX logits) of one prefill of `toks` (numpy int32). The
    reference runs jitted, as its generate does, which shares the compile
    with a generate prefill of the same length."""
    from ggml_gfx906_tpu_torch.models import llama as tllama

    ref, _ = jllama.forward_jit(jcfg, jp, jnp.asarray(toks), jllama.make_cache(jcfg, max_seq),
                                jnp.int32(0))
    got, _ = tllama.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                            tllama.make_cache(tcfg, max_seq, device="cpu"), 0)
    return got.numpy(), np.asarray(ref)


def write_recipe_gguf(path, cfg, weights, seed: int = 5, vocab: bool = False):
    """A llama GGUF of `weights` (blocks from the reference's quantizers),
    written by the port's writer, with norm weights 1 + N(0, 0.1); with
    vocab, the smoke's synthetic SentencePiece vocabulary of cfg.n_vocab
    tokens (chip_smoke.write_vocab)."""
    from ggml_gfx906_tpu_torch.gguf import GGUFWriter

    w = GGUFWriter()
    A = "llama"
    w.set("general.architecture", A)
    if vocab:
        import chip_smoke

        chip_smoke.write_vocab(w, cfg.n_vocab)
    for key, val in (("context_length", cfg.n_ctx), ("embedding_length", cfg.n_embd),
                     ("attention.head_count", cfg.n_head),
                     ("attention.head_count_kv", cfg.n_kv_head),
                     ("block_count", cfg.n_layer), ("feed_forward_length", cfg.n_ff)):
        w.set(f"{A}.{key}", val)
    w.set(f"{A}.attention.layer_norm_rms_epsilon", 1e-5)
    for key, name, layer, r, c in recipe_matrices(cfg):
        qtype, a = weights[(key, layer)]
        gname = f"{name}.weight" if layer is None else f"blk.{layer}.{name}.weight"
        w.add_tensor(gname, (c, r), qtype, quantize(qtype, a).reshape(-1).view(np.uint8))
    rng = np.random.default_rng(seed)
    w.add_array_tensor("output_norm.weight",
                       (1 + 0.1 * rng.standard_normal(cfg.n_embd)).astype(np.float32))
    for i in range(cfg.n_layer):
        for nm in ("attn_norm", "ffn_norm"):
            w.add_array_tensor(f"blk.{i}.{nm}.weight",
                               (1 + 0.1 * rng.standard_normal(cfg.n_embd)).astype(np.float32))
    w.write(path)


# ------------------------------------------- HF-style state dicts

# the widths of the HF-style state dicts (hf_llama_state, hf_gpt_state)
HF_D, HF_FF, HF_V, HF_L = 256, 512, 256, 2
D, FF, V, L = HF_D, HF_FF, HF_V, HF_L


def _randn(rng, *shape, scale=0.02):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def hf_llama_state(seed: int = 0, head: bool = True, experts: int = 0,
                   dims: tuple = (HF_D, HF_FF, HF_V, HF_L)):
    """(state dict, config) of a tiny HF LlamaForCausalLM, or with experts
    a MixtralForCausalLM, with seeded weights ~N(0, 0.02) and norm weights
    1 + N(0, 0.1), as models/convert.py takes them; dims = (width, ffn
    width, vocabulary, layers)."""
    D, FF, V, L = dims
    rng = np.random.default_rng(seed)
    sd = {"model.embed_tokens.weight": _randn(rng, V, D),
          "model.norm.weight": 1 + _randn(rng, D, scale=0.1)}
    if head:
        sd["lm_head.weight"] = _randn(rng, V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + _randn(rng, D, scale=0.1)
        sd[p + "post_attention_layernorm.weight"] = 1 + _randn(rng, D, scale=0.1)
        for s, r in (("q", D), ("k", D // 2), ("v", D // 2), ("o", D)):
            sd[p + f"self_attn.{s}_proj.weight"] = _randn(rng, r, D)
        if experts:
            sd[p + "block_sparse_moe.gate.weight"] = _randn(rng, experts, D)
            for e in range(experts):
                q = p + f"block_sparse_moe.experts.{e}."
                sd[q + "w1.weight"] = _randn(rng, FF, D)
                sd[q + "w2.weight"] = _randn(rng, D, FF)
                sd[q + "w3.weight"] = _randn(rng, FF, D)
        else:
            sd[p + "mlp.gate_proj.weight"] = _randn(rng, FF, D)
            sd[p + "mlp.up_proj.weight"] = _randn(rng, FF, D)
            sd[p + "mlp.down_proj.weight"] = _randn(rng, D, FF)
    cfg = types.SimpleNamespace(vocab_size=V, max_position_embeddings=128, hidden_size=D,
                                num_hidden_layers=L, intermediate_size=FF,
                                num_attention_heads=4, num_key_value_heads=2,
                                rms_norm_eps=1e-5, rope_theta=10000.0,
                                num_local_experts=experts, num_experts_per_tok=2)
    return sd, cfg


def tiny_iq_gguf(path):
    """A tiny F32 llama GGUF (width 64, ffn 256, one layer; the reference's
    converter) whose only matrix with rows of a multiple of 256 is
    ffn_down: the quantize tools quantize it and copy the rest, so the
    reference's IQ searches take seconds. Returns its imatrix, an
    importance row per matrix under the GGUF names."""
    from ggml_gfx906_tpu.models import convert as jconvert

    sd, cfg = hf_llama_state(seed=21, dims=(64, 256, 64, 1))
    jconvert.convert_llama(sd, cfg, path)
    rng = np.random.default_rng(22)
    im = {f"blk.0.{n}.weight": rng.uniform(0.01, 2.0, k).astype(np.float32)
          for n, k in (("attn_q", 64), ("attn_k", 64), ("attn_v", 64), ("attn_output", 64),
                       ("ffn_gate", 64), ("ffn_up", 64), ("ffn_down", 256))}
    im.update({n: rng.uniform(0.01, 2.0, 64).astype(np.float32)
               for n in ("token_embd.weight", "output.weight")})
    return im


def hf_gpt_state(arch: str, seed: int = 1):
    """(state dict, config) of a tiny HF GPT2LMHeadModel ("gpt2") or
    GPTJForCausalLM ("gptj"), seeded as hf_llama_state."""
    rng = np.random.default_rng(seed)
    sd = {"transformer.wte.weight": _randn(rng, V, D),
          "transformer.ln_f.weight": 1 + _randn(rng, D, scale=0.1),
          "transformer.ln_f.bias": _randn(rng, D)}
    for i in range(L):
        p = f"transformer.h.{i}."
        sd[p + "ln_1.weight"] = 1 + _randn(rng, D, scale=0.1)
        sd[p + "ln_1.bias"] = _randn(rng, D)
        if arch == "gpt2":
            sd[p + "ln_2.weight"] = 1 + _randn(rng, D, scale=0.1)
            sd[p + "ln_2.bias"] = _randn(rng, D)
            sd[p + "attn.c_attn.weight"] = _randn(rng, D, 3 * D)     # Conv1D: (in, out)
            sd[p + "attn.c_attn.bias"] = _randn(rng, 3 * D)
            sd[p + "attn.c_proj.weight"] = _randn(rng, D, D)
            sd[p + "attn.c_proj.bias"] = _randn(rng, D)
            sd[p + "mlp.c_fc.weight"] = _randn(rng, D, FF)
            sd[p + "mlp.c_fc.bias"] = _randn(rng, FF)
            sd[p + "mlp.c_proj.weight"] = _randn(rng, FF, D)
            sd[p + "mlp.c_proj.bias"] = _randn(rng, D)
        else:
            for s in ("q", "k", "v", "out"):
                sd[p + f"attn.{s}_proj.weight"] = _randn(rng, D, D)
            sd[p + "mlp.fc_in.weight"] = _randn(rng, FF, D)
            sd[p + "mlp.fc_in.bias"] = _randn(rng, FF)
            sd[p + "mlp.fc_out.weight"] = _randn(rng, D, FF)
            sd[p + "mlp.fc_out.bias"] = _randn(rng, D)
    if arch == "gpt2":
        sd["transformer.wpe.weight"] = _randn(rng, 64, D)
    else:
        sd["lm_head.weight"] = _randn(rng, V, D)
        sd["lm_head.bias"] = _randn(rng, V)
    cfg = types.SimpleNamespace(vocab_size=V, n_positions=64, n_embd=D, n_layer=L, n_head=4,
                                rotary_dim=32, layer_norm_epsilon=1e-5)
    return sd, cfg


# ------------------------------------------- vision models

def rand_yolo_gguf(path, rng):
    """The random-weight YOLOv3-tiny GGUF of the reference's test recipe
    (tests/test_vision_models.py::_rand_yolo_gguf; the smoke writes its
    files by the same function, chip_smoke.yolo_gguf)."""
    import chip_smoke

    chip_smoke.yolo_gguf(path, rng)


def sam_state(n_enc_state: int = 96, n_enc_layer: int = 4, n_enc_head: int = 12,
              n_img_size: int = 256, seed: int = 0) -> dict:
    """An HF SamModel state dict of seeded random weights with the keys
    from_hf reads (no transformers; chip_smoke.sam_state): the encoder at
    these widths, the published 256-wide decoder. The relative-position
    tables follow the port's sam.GLOBAL_ATTN at the call."""
    import chip_smoke

    return chip_smoke.sam_state(n_enc_state, n_enc_layer, n_enc_head, n_img_size, seed)


# ---------------------------------------------------- the mesh tests' model

def tp_cfg(n_vocab: int = 512, n_ctx: int = 128):
    """The reference tests/test_tp.py's CFG: 512 wide, 2 layers, GQA."""
    return jllama.LlamaConfig(n_vocab=n_vocab, n_ctx=n_ctx, n_embd=512, n_head=4,
                              n_kv_head=2, n_layer=2, n_ff=1024)


def tp_qparams(cfg, seed: int = 3, scale: float = 0.05):
    """The JAX params of tests/test_tp.py's fixture: every matrix Q4_K from
    numpy's generator at `seed` (scale `scale`), wte dense f32, norms ones."""
    rng = np.random.default_rng(seed)

    def q(n, k):
        return JQuantTensor.quantize(
            GGMLType.Q4_K, (rng.standard_normal((n, k)) * scale).astype(np.float32))

    D, FF, KVD = cfg.n_embd, cfg.n_ff, cfg.n_kv_head * cfg.head_dim
    p = {"wte": jnp.asarray(rng.standard_normal((cfg.n_vocab, D)) * scale, jnp.float32),
         "out_norm": jnp.ones((D,), jnp.float32), "blocks": []}
    for _ in range(cfg.n_layer):
        p["blocks"].append({
            "attn_norm": jnp.ones((D,), jnp.float32),
            "wq": q(D, D), "wk": q(KVD, D), "wv": q(KVD, D), "wo": q(D, D),
            "ffn_norm": jnp.ones((D,), jnp.float32),
            "w_gate": q(FF, D), "w_up": q(FF, D), "w_down": q(D, FF)})
    return p


def cfg_fields(cfg) -> dict:
    """A JAX LlamaConfig as the port's LlamaConfig keyword arguments (f32
    compute), picklable for the gloo ranks."""
    return dict(n_vocab=cfg.n_vocab, n_ctx=cfg.n_ctx, n_embd=cfg.n_embd, n_head=cfg.n_head,
                n_kv_head=cfg.n_kv_head, n_layer=cfg.n_layer, n_ff=cfg.n_ff,
                rms_eps=cfg.rms_eps, rope_base=cfg.rope_base, rope_dims=cfg.rope_dims,
                rope_freq_scale=cfg.rope_freq_scale)


def jax_shard_of(arr, jmesh, coords: dict):
    """The addressable shard of a JAX array on the device at a port rank's
    mesh coordinates, as numpy."""
    idx = tuple(coords.get(a, 0) for a in jmesh.axis_names)
    dev = jmesh.devices[idx]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)
