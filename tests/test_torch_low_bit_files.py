"""Port parity for the slice as a whole: llama models in llama.cpp's Q2_K
and Q3_K_M file types against the JAX package. Q2_K puts Q3_K in attn_v,
attn_output and ffn_down and Q2_K everywhere else but the Q6_K head;
Q3_K_M puts Q5_K in the first two layers' attn_v, Q4_K in the other
attn_v, every attn_output and (at two layers, below n_layer / 16 = 0)
every ffn_down, and Q3_K everywhere else but the Q6_K head. n_ff of 768
gives ffn_down three superblocks per row, which the reference pads to
four. Q2_K and Q3_K have no int8 twin: the Q2_K file takes K9 and K4 at
every length and meets tests/test_llama.py's bound (nmse < 1e-9); the
Q3_K_M file's Q4_K matrices take K3 from int8_min_m rows on, so its logits
there are held to the int8 route's class (2e-4), and its greedy streams
are equal at prompt lengths below and above int8_min_m."""
import numpy as np
import pytest

from chip_smoke import RECIPES as SMOKE_RECIPES
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import (jax_params_to_numpy, nmse, param_types, port_cfg, recipe_cfg,
                         recipe_jax_params, recipe_logits, recipe_weights,
                         write_recipe_gguf)

MAX_SEQ = 128
RECIPES = ("q2_k", "q3_k_m")
CFG = recipe_cfg(n_ff=768, n_layer=2, n_ctx=MAX_SEQ)
# per recipe at two layers: {type: matrices}, every other matrix in the base type
TYPES = {"q2_k": ({GGMLType.Q6_K: {"lm_head"},
                   GGMLType.Q3_K: {f"{k}.{i}" for k in ("wv", "wo", "w_down") for i in (0, 1)}},
                  GGMLType.Q2_K),
         "q3_k_m": ({GGMLType.Q6_K: {"lm_head"}, GGMLType.Q5_K: {"wv.0", "wv.1"},
                     GGMLType.Q4_K: {f"{k}.{i}" for k in ("wo", "w_down") for i in (0, 1)}},
                    GGMLType.Q3_K)}
# the bound on 70-token logits: f32 route throughout, or K3 for Q4_K
BOUND_70 = {"q2_k": 1e-9, "q3_k_m": 2e-4}


def _weights(recipe, seed=0):
    return recipe_weights(SMOKE_RECIPES[recipe], CFG, seed)


@pytest.fixture(scope="module", params=RECIPES)
def models(request):
    jp = recipe_jax_params(CFG, _weights(request.param))
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return request.param, jp, port_cfg(CFG), tp


def test_recipe_types(models):
    """The carried-across weights keep the recipe's types."""
    recipe, jp, _, tp = models
    types = param_types(tp)
    assert types == param_types(jp)
    special, base = TYPES[recipe]
    for qtype, keys in special.items():
        assert {k for k, t in types.items() if t == qtype} == keys, qtype
    rest = {t for k, t in types.items() if not any(k in keys for keys in special.values())}
    assert rest == {base}
    assert types["wte"] == base


@pytest.mark.parametrize("n_tok", [12, 70])
def test_logits_match_reference(models, n_tok):
    """12 tokens: every matrix on its f32 kernel; 70: Q3_K_M's Q4_K ones on
    K3 (both packages' int8 route)."""
    recipe, jp, tcfg, tp = models
    toks = np.random.default_rng(7).integers(0, 256, n_tok).astype(np.int32)
    got, ref = recipe_logits(CFG, jp, tcfg, tp, toks, MAX_SEQ)
    assert got.shape == ref.shape == (n_tok, 256)
    assert nmse(got, ref) < (1e-9 if n_tok == 12 else BOUND_70[recipe])


@pytest.mark.parametrize("plen", [12, 70])
def test_generate_streams_equal(models, plen):
    _, jp, tcfg, tp = models
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, 256, plen)]
    ref = jllama.generate(CFG, jp, prompt, 8, max_seq=MAX_SEQ)
    got = tllama.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu")
    assert got == ref


def test_engine_matches_generate(models):
    """Engine streams equal generate's (the 70-token prompt is admitted in
    three 32-token chunks; K9, K7, K4 and K1 are row-invariant). The short
    prompts flood at M = 3·32, which crosses int8_min_m where generate's
    prefill does not, so both run the f32 route (int8_min_m=0; it changes
    nothing on a file whose types have no int8 route)."""
    _, _, tcfg, tp = models
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (5, 20, 70, 3)]
    tconfig.set("int8_min_m", 0)
    try:
        eng = Engine(tllama, tcfg, tp, max_batch=3, max_seq=MAX_SEQ, chunk_size=32,
                     device="cpu")
        rids = [eng.submit(p, 6) for p in prompts]
        done = {r.rid: r.out for r in eng.run()}
        for rid, p in zip(rids, prompts):
            assert p + done[rid] == tllama.generate(tcfg, tp, p, 6, max_seq=MAX_SEQ,
                                                    device="cpu")
    finally:
        tconfig.unset("int8_min_m")


@pytest.mark.parametrize("recipe", RECIPES)
def test_same_gguf_same_logits(tmp_path, recipe):
    """One GGUF written by the port's writer (blocks from the reference's
    quantizers) and loaded by both packages' llama.load: the same type per
    tensor, the same logits (12 tokens, the reference's compile shared with
    test_logits_match_reference)."""
    path = tmp_path / f"{recipe}.gguf"
    weights = _weights(recipe, seed=3)
    write_recipe_gguf(path, CFG, weights)
    jcfg, jp = jllama.load(path)
    tcfg, tp = tllama.load(path, device="cpu")
    assert all(isinstance(v, QuantTensor) for v in (tp["wte"], tp["lm_head"]))
    assert param_types(tp) == param_types(jp)
    assert set(param_types(tp).values()) == {t for t, _ in weights.values()}
    toks = np.random.default_rng(9).integers(0, 256, 12).astype(np.int32)
    got, ref = recipe_logits(jcfg, jp, tcfg, tp, toks, MAX_SEQ)
    assert nmse(got, ref) < 1e-9
