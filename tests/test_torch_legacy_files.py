"""Port parity for the slice as a whole: llama models in llama.cpp's legacy
Q4_1, Q5_0 and Q5_1 file types (every matrix, token_embd included, in the
base type, output.weight Q6_K) against the JAX package. n_ff of 768 gives
ffn_down 24 blocks per row, which the reference pads to 32 for Q5_0 and
Q5_1. None of the three types has an int8 twin, so every prompt length
takes K8 (and K4 for the head): logits meet tests/test_llama.py's bound
(nmse < 1e-9) and greedy streams are equal at prompt lengths below and
above int8_min_m."""
import numpy as np
import pytest

from chip_smoke import RECIPES as SMOKE_RECIPES
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.runtime.engine import Engine

from _torch_port import (jax_params_to_numpy, nmse, param_types, port_cfg, recipe_cfg,
                         recipe_jax_params, recipe_logits, recipe_weights,
                         write_recipe_gguf)

MAX_SEQ = 128
RECIPES = {"q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0, "q5_1": GGMLType.Q5_1}
CFG = recipe_cfg(n_ff=768, n_layer=2, n_ctx=MAX_SEQ)


def _weights(recipe, seed=0):
    return recipe_weights(SMOKE_RECIPES[recipe], CFG, seed)


@pytest.fixture(scope="module", params=list(RECIPES))
def models(request):
    jp = recipe_jax_params(CFG, _weights(request.param))
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return request.param, jp, port_cfg(CFG), tp


def test_recipe_types(models):
    """The carried-across weights keep the recipe's types: Q6_K in the head
    only, the base type everywhere else, token_embd included."""
    recipe, jp, _, tp = models
    types = param_types(tp)
    assert types == param_types(jp)
    assert {k for k, t in types.items() if t == GGMLType.Q6_K} == {"lm_head"}
    assert {t for k, t in types.items() if k != "lm_head"} == {RECIPES[recipe]}


def test_logits_match_reference(models):
    """12 tokens: the length of the shorter generate prompt below."""
    _, jp, tcfg, tp = models
    toks = np.random.default_rng(7).integers(0, 256, 12).astype(np.int32)
    got, ref = recipe_logits(CFG, jp, tcfg, tp, toks, MAX_SEQ)
    assert got.shape == ref.shape == (12, 256)
    assert nmse(got, ref) < 1e-9


@pytest.mark.parametrize("plen", [12, 70])
def test_generate_streams_equal(models, plen):
    _, jp, tcfg, tp = models
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, 256, plen)]
    ref = jllama.generate(CFG, jp, prompt, 8, max_seq=MAX_SEQ)
    got = tllama.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu")
    assert got == ref


def test_engine_matches_generate(models):
    """Engine streams equal generate's (the 70-token prompt is admitted in
    three 32-token chunks; K8 and K4 are row-invariant)."""
    _, _, tcfg, tp = models
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
    path = tmp_path / f"{recipe}.gguf"
    weights = _weights(recipe, seed=3)
    write_recipe_gguf(path, CFG, weights)
    jcfg, jp = jllama.load(path)
    tcfg, tp = tllama.load(path, device="cpu")
    assert all(isinstance(v, QuantTensor) for v in (tp["wte"], tp["lm_head"]))
    assert param_types(tp) == param_types(jp)
    assert set(param_types(tp).values()) == {RECIPES[recipe], GGMLType.Q6_K}
    toks = np.array([1, 50, 3, 99, 7], np.int32)
    got, ref = recipe_logits(jcfg, jp, tcfg, tp, toks, MAX_SEQ)
    assert nmse(got, ref) < 1e-9
