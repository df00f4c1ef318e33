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
N_LAYER = 2
RECIPES = {r: SMOKE_RECIPES[r] for r in ("q4_k_m", "q8_0", "q5_k_m", "q4_0")}
# the matrices each recipe puts in Q6_K at two layers, and its other type
Q6K_AT = {"q4_k_m": ({"lm_head", "wv.1", "w_down.1"}, GGMLType.Q4_K),
          "q8_0": (set(), GGMLType.Q8_0),
          "q5_k_m": ({"lm_head", "wv.1", "w_down.1"}, GGMLType.Q5_K),
          "q4_0": ({"lm_head"}, GGMLType.Q4_0)}


def _cfg(recipe):
    return recipe_cfg(768 if recipe.endswith("_k_m") else 512, N_LAYER, MAX_SEQ)


def _weights(recipe, seed=0):
    return recipe_weights(RECIPES[recipe], _cfg(recipe), seed)


@pytest.fixture(scope="module", params=list(RECIPES))
def models(request):
    jcfg = _cfg(request.param)
    jp = recipe_jax_params(jcfg, _weights(request.param))
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return request.param, jcfg, jp, port_cfg(jcfg), tp


def test_recipe_types(models):
    """The carried-across weights keep the recipe's types: the _K_M
    mixtures at two layers put Q6_K in the head and in layer 1's attn_v and
    ffn_down, Q4_0 in the head only, Q8_0 nowhere."""
    recipe, _, jp, _, tp = models
    types = param_types(tp)
    assert types == param_types(jp)
    q6k, other = Q6K_AT[recipe]
    assert {k for k, t in types.items() if t == GGMLType.Q6_K} == q6k
    assert {t for k, t in types.items() if k not in q6k} == {other}


def test_logits_match_reference(models):
    _, jcfg, jp, tcfg, tp = models
    toks = np.random.default_rng(7).integers(0, 256, 7).astype(np.int32)
    got, ref = recipe_logits(jcfg, jp, tcfg, tp, toks, MAX_SEQ)
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
    three 32-token chunks; K4 and the f32 kernels are row-invariant). The
    short prompts flood at M = 3·32, which crosses int8_min_m where
    generate's prefill does not, so both run the f32 route (int8_min_m=0; it
    changes nothing on a file whose types have no int8 route)."""
    _, _, _, tcfg, tp = models
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


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_same_gguf_same_logits(tmp_path, recipe):
    """One GGUF written by the port's writer (blocks from the reference's
    quantizers) and loaded by both packages' llama.load: the same type per
    tensor, the same logits."""
    jcfg = _cfg(recipe)
    path = tmp_path / f"{recipe}.gguf"
    weights = _weights(recipe, seed=3)
    write_recipe_gguf(path, jcfg, weights)
    jcfg2, jp = jllama.load(path)
    tcfg, tp = tllama.load(path, device="cpu")
    assert all(isinstance(v, QuantTensor) for v in (tp["wte"], tp["lm_head"]))
    assert param_types(tp) == param_types(jp)
    assert {t for t, _ in weights.values()} == set(param_types(tp).values())
    toks = np.array([1, 50, 3, 99, 7], np.int32)
    got, ref = recipe_logits(jcfg2, jp, tcfg, tp, toks, MAX_SEQ)
    assert nmse(got, ref) < 1e-9
