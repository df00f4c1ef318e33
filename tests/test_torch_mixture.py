"""Port parity for the slice as a whole: llama models whose matrices mix
quant types as llama.cpp's files do — the Q4_K_M and Q5_K_M recipes (Q4_K
or Q5_K, with Q6_K in output.weight and in attn_v/ffn_down of some layers),
Q8_0 throughout, and Q4_0 with a Q6_K head — against the JAX package. The
mixtures' n_ff of 768 gives layer 0's Q4_K or Q5_K ffn_down and layer 1's
Q6_K one three superblocks per row, which the reference pads to four (Q6_K
to an even count). Logits meet tests/test_llama.py's bound (nmse < 1e-9)
on the f32 route; greedy streams are equal with prompts shorter than
int8_min_m and longer (the int8 route for Q4_K, Q8_0 and Q4_0; K4 for Q6_K
and K7 for Q5_K at every length)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RECIPES as SMOKE_RECIPES
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.quant import quantize
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.gguf import GGUFWriter
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.runtime.engine import Engine

from _torch_port import jax_params_to_numpy, nmse, port_cfg

MAX_SEQ = 128
N_LAYER = 2
RECIPES = {r: SMOKE_RECIPES[r] for r in ("q4_k_m", "q8_0", "q5_k_m", "q4_0")}
# the matrices each recipe puts in Q6_K at two layers, and its other type
Q6K_AT = {"q4_k_m": ({"lm_head", "wv.1", "w_down.1"}, GGMLType.Q4_K),
          "q8_0": (set(), GGMLType.Q8_0),
          "q5_k_m": ({"lm_head", "wv.1", "w_down.1"}, GGMLType.Q5_K),
          "q4_0": ({"lm_head"}, GGMLType.Q4_0)}
_PER_BLOCK = (("wq", "attn_q"), ("wk", "attn_k"), ("wv", "attn_v"),
              ("wo", "attn_output"), ("w_gate", "ffn_gate"), ("w_up", "ffn_up"),
              ("w_down", "ffn_down"))


def _cfg(recipe):
    return jllama.LlamaConfig(n_vocab=256, n_ctx=MAX_SEQ, n_embd=256, n_head=4,
                              n_kv_head=2, n_layer=N_LAYER,
                              n_ff=768 if recipe.endswith("_k_m") else 512)


def _matrices(cfg):
    """(port/JAX param key, GGUF name, layer, rows, cols) of every matrix."""
    D, V, FF = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    KVD = cfg.n_kv_head * cfg.head_dim
    shapes = {"attn_q": (D, D), "attn_k": (KVD, D), "attn_v": (KVD, D),
              "attn_output": (D, D), "ffn_gate": (FF, D), "ffn_up": (FF, D),
              "ffn_down": (D, FF)}
    yield "wte", "token_embd", None, V, D
    yield "lm_head", "output", None, V, D
    for i in range(cfg.n_layer):
        for key, name in _PER_BLOCK:
            yield key, name, i, *shapes[name]


def _weights(recipe, seed=0):
    """{(key, layer): (qtype, f32 matrix)} at ~N(0, 0.02), the recipe's types."""
    rng = np.random.default_rng(seed)
    return {(key, layer): (RECIPES[recipe](name, layer, N_LAYER),
                           (rng.standard_normal((r, c)) * 0.02).astype(np.float32))
            for key, name, layer, r, c in _matrices(_cfg(recipe))}


def _jax_params(cfg, weights):
    D = cfg.n_embd
    q = {k: JQuantTensor.quantize(t, w) for k, (t, w) in weights.items()}
    return {"wte": q[("wte", None)], "lm_head": q[("lm_head", None)],
            "out_norm": jnp.ones((D,)),
            "blocks": [dict({key: q[(key, i)] for key, _ in _PER_BLOCK},
                            attn_norm=jnp.ones((D,)), ffn_norm=jnp.ones((D,)))
                       for i in range(cfg.n_layer)]}


@pytest.fixture(scope="module", params=list(RECIPES))
def models(request):
    jcfg = _cfg(request.param)
    jp = _jax_params(jcfg, _weights(request.param))
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return request.param, jcfg, jp, port_cfg(jcfg), tp


def _types(params):
    leaves = {"wte": params["wte"], "lm_head": params["lm_head"]}
    for i, b in enumerate(params["blocks"]):
        leaves.update({f"{k}.{i}": v for k, v in b.items() if k in dict(_PER_BLOCK)})
    return {k: GGMLType(int(v.qtype)) for k, v in leaves.items()}


def _logits(jcfg, jp, tcfg, tp, toks):
    ref, _ = jllama.forward(jcfg, jp, jnp.asarray(toks), jllama.make_cache(jcfg, MAX_SEQ),
                            jnp.int32(0))
    got, _ = tllama.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                            tllama.make_cache(tcfg, MAX_SEQ, device="cpu"), 0)
    return got.numpy(), np.asarray(ref)


def test_recipe_types(models):
    """The carried-across weights keep the recipe's types: the _K_M
    mixtures at two layers put Q6_K in the head and in layer 1's attn_v and
    ffn_down, Q4_0 in the head only, Q8_0 nowhere."""
    recipe, _, jp, _, tp = models
    types = _types(tp)
    assert types == _types(jp)
    q6k, other = Q6K_AT[recipe]
    assert {k for k, t in types.items() if t == GGMLType.Q6_K} == q6k
    assert {t for k, t in types.items() if k not in q6k} == {other}


def test_logits_match_reference(models):
    _, jcfg, jp, tcfg, tp = models
    toks = np.random.default_rng(7).integers(0, 256, 7).astype(np.int32)
    got, ref = _logits(jcfg, jp, tcfg, tp, toks)
    assert got.shape == ref.shape == (7, 256)
    assert nmse(got, ref) < 1e-9


@pytest.mark.parametrize("plen", [12, 70])
def test_generate_streams_equal(models, plen):
    _, jcfg, jp, tcfg, tp = models
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, 256, plen)]
    ref = jllama.generate(jcfg, jp, prompt, 8, max_seq=MAX_SEQ)
    got = tllama.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu")
    assert got == ref


def test_engine_matches_generate(models):
    """Engine streams equal generate's (the 70-token prompt is admitted in
    three 32-token chunks; K4 and the f32 kernels are row-invariant)."""
    _, _, _, tcfg, tp = models
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (5, 20, 70, 3)]
    eng = Engine(tllama, tcfg, tp, max_batch=3, max_seq=MAX_SEQ, chunk_size=32,
                 device="cpu")
    rids = [eng.submit(p, 6) for p in prompts]
    done = {r.rid: r.out for r in eng.run()}
    for rid, p in zip(rids, prompts):
        assert p + done[rid] == tllama.generate(tcfg, tp, p, 6, max_seq=MAX_SEQ,
                                                device="cpu")


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_same_gguf_same_logits(tmp_path, recipe):
    """One GGUF written by the port's writer (blocks from the reference's
    quantizers) and loaded by both packages' llama.load: the same type per
    tensor, the same logits."""
    jcfg = _cfg(recipe)
    path = tmp_path / f"{recipe}.gguf"
    w = GGUFWriter()
    A = "llama"
    w.set("general.architecture", A)
    for key, val in (("context_length", jcfg.n_ctx), ("embedding_length", jcfg.n_embd),
                     ("attention.head_count", jcfg.n_head),
                     ("attention.head_count_kv", jcfg.n_kv_head),
                     ("block_count", jcfg.n_layer), ("feed_forward_length", jcfg.n_ff)):
        w.set(f"{A}.{key}", val)
    w.set(f"{A}.attention.layer_norm_rms_epsilon", 1e-5)
    weights = _weights(recipe, seed=3)
    for key, name, layer, r, c in _matrices(jcfg):
        qtype, a = weights[(key, layer)]
        gname = f"{name}.weight" if layer is None else f"blk.{layer}.{name}.weight"
        w.add_tensor(gname, (c, r), qtype, quantize(qtype, a).reshape(-1).view(np.uint8))
    rng = np.random.default_rng(5)
    w.add_array_tensor("output_norm.weight",
                       (1 + 0.1 * rng.standard_normal(jcfg.n_embd)).astype(np.float32))
    for i in range(jcfg.n_layer):
        for nm in ("attn_norm", "ffn_norm"):
            w.add_array_tensor(f"blk.{i}.{nm}.weight",
                               (1 + 0.1 * rng.standard_normal(jcfg.n_embd)).astype(np.float32))
    w.write(path)
    jcfg2, jp = jllama.load(path)
    tcfg, tp = tllama.load(path, device="cpu")
    assert all(isinstance(v, QuantTensor) for v in (tp["wte"], tp["lm_head"]))
    assert _types(tp) == _types(jp)
    assert {t for t, _ in weights.values()} == set(_types(tp).values())
    toks = np.array([1, 50, 3, 99, 7], np.int32)
    got, ref = _logits(jcfg2, jp, tcfg, tp, toks)
    assert nmse(got, ref) < 1e-9
