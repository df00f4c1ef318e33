"""Port parity: the int8 execution layout (ggml_gfx906_tpu/ops/quantized.py:
412-605) and the int8 load (models/llama.py:61-156). Requantized
values are held bit for bit against the reference, the tile scales at the
reference's own rtol 1e-5 (tests/test_int8_load.py:67-77), the product
against the reference at nmse < 1e-12 and against the dense product at
< 2e-4 (tests/test_qmm_int8.py:94-125), and a row's result against itself
at another M bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RECIPES as SMOKE_RECIPES
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.quant.registry import quantize as reg_quantize
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.quant.types import TYPE_TRAITS
from ggml_gfx906_tpu_torch.runtime.engine import Engine

from _torch_port import (jax_params_to_numpy, nmse, port_cfg, recipe_cfg, recipe_logits,
                         recipe_weights, write_recipe_gguf)

TYPES = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
         GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K]
MAX_SEQ = 64
ROWS = 16


def _pair(qtype, n, k, seed=0):
    """(reference QuantTensor, port QuantTensor) of one random matrix, each
    package in its default layout for the shape."""
    w = (np.random.default_rng(seed).standard_normal((n, k)) * 0.05).astype(np.float32)
    blocks = reg_quantize(qtype, w.reshape(-1, TYPE_TRAITS[qtype].blck_size)).reshape(n, -1)
    return jqz.QuantTensor.from_blocks(qtype, blocks), tqz.QuantTensor.from_blocks(qtype, blocks,
                                                                                   "cpu")


def _same_int8(got, ref):
    assert got.layout == "int8"
    np.testing.assert_array_equal(got.fields["w8t"].numpy(), np.asarray(ref.fields["w8t"]))
    np.testing.assert_allclose(got.fields["dwt"].numpy(), np.asarray(ref.fields["dwt"]),
                               rtol=1e-5)


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_to_int8_layout_matches_reference(qtype):
    jq, tq = _pair(qtype, ROWS, 512, seed=int(qtype))
    _same_int8(tqz.to_int8_layout(tq), jqz.to_int8_layout(jq))


@pytest.mark.parametrize("k,want", [(256, 128), (1024, 128), (4096, 512), (11008, 256)])
def test_choose_tile(k, want):
    assert tqz._choose_tile(k, None) == jqz._choose_tile(k, None) == want
    assert tqz._choose_tile(k, 512) == jqz._choose_tile(k, 512)


@pytest.fixture(scope="module")
def q4k_int8():
    """The Q4_K case of test_to_int8_layout_matches_reference again: the
    reference's programs for this shape are compiled once."""
    jq, tq = _pair(GGMLType.Q4_K, ROWS, 512, seed=int(GGMLType.Q4_K))
    return jq, tq, jqz.to_int8_layout(jq), tqz.to_int8_layout(tq)


@pytest.mark.parametrize("m", [1, 7, 64])
def test_int8_layout_matmul(q4k_int8, m):
    jq, tq, j8, t8 = q4k_int8
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    got = tqz.qmatmul(torch.from_numpy(x), t8).numpy()
    assert got.shape == (m, ROWS)
    assert nmse(got, np.asarray(jqz._int8_layout_matmul(jnp.asarray(x), j8))) < 1e-12
    assert nmse(got, x @ tqz.dequant(tq).numpy().T) < 2e-4
    # row invariance: the first row alone gives the same bits
    one = tqz.qmatmul(torch.from_numpy(x[:1]), t8).numpy()
    np.testing.assert_array_equal(got[:1], one)


def test_int8_layout_wide_tile():
    """A tile wider than 1024 (int8 values multiplied in f32 stay exact
    only to 1024): its 1024-wide parts are summed in integers."""
    jq, tq = _pair(GGMLType.Q8_0, 8, 4096, seed=5)
    j8, t8 = jqz.to_int8_layout(jq, tile=2048), tqz.to_int8_layout(tq, tile=2048)
    _same_int8(t8, j8)
    x = np.random.default_rng(2).standard_normal((3, 4096)).astype(np.float32) * 30
    got = tqz.qmatmul(torch.from_numpy(x), t8).numpy()
    assert nmse(got, np.asarray(jqz._int8_layout_matmul(jnp.asarray(x), j8))) < 1e-12


def test_int8_dequant_and_rows(q4k_int8):
    _, _, j8, t8 = q4k_int8
    dense = np.asarray(jqz.dequant(j8))
    np.testing.assert_array_equal(tqz.dequant(t8).numpy(), dense)
    ids = np.array([[5, 0, ROWS - 1], [5, 5, 1]])
    np.testing.assert_array_equal(tqz.embed_rows(t8, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jqz.embed_rows(j8, jnp.asarray(ids))))


def test_every_type_converts_from_the_wire():
    """Q8_1 and Q8_K, which only the wire layout holds, convert too."""
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((4, 512)) * 0.1).astype(np.float32)
    for qtype in (GGMLType.Q8_1, GGMLType.Q8_K):
        blocks = reg_quantize(qtype, w.reshape(-1, TYPE_TRAITS[qtype].blck_size))
        jq = jqz.QuantTensor.from_blocks(qtype, blocks.reshape(4, -1))
        tq = tqz.QuantTensor.from_blocks(qtype, blocks.reshape(4, -1), "cpu")
        assert tq.layout == "wire"
        _same_int8(tqz.to_int8_layout(tq), jqz.to_int8_layout(jq))


# a 2-layer Q4_K_M file (Q4_K and Q6_K)
CFG = recipe_cfg(n_ff=768, n_layer=2, n_ctx=MAX_SEQ)


@pytest.fixture(scope="module")
def int8_file(tmp_path_factory):
    """The file loaded once by each package in the int8 layout, and once by
    the port in the kernel layout."""
    path = tmp_path_factory.mktemp("int8") / "q4_k_m.gguf"
    write_recipe_gguf(path, CFG, recipe_weights(SMOKE_RECIPES["q4_k_m"], CFG, seed=1))
    tcfg, t8 = tllama.load(path, device="cpu", layout="int8")
    jcfg, j8 = jllama.load(path, layout="int8")
    _, tk = tllama.load(path, device="cpu", layout="kernel")
    return path, tcfg, t8, jcfg, j8, tk


def _matrices(p):
    yield "wte", p["wte"]
    yield "lm_head", p["lm_head"]
    for i, b in enumerate(p["blocks"]):
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            yield f"{key}.{i}", b[key]


def test_int8_load_is_the_two_pass_layout(int8_file):
    """Every matrix equals to_int8_layout of the kernel-layout load, bit for
    bit, and the reference's int8 load."""
    _, _, t8, _, j8, tk = int8_file
    want = dict(_matrices(tk))
    ref = dict(_matrices(j8))
    for name, t in _matrices(t8):
        two_pass = tqz.to_int8_layout(want[name])
        for f in ("w8t", "dwt"):
            assert torch.equal(t.fields[f], two_pass.fields[f]), (name, f)
        _same_int8(t, ref[name])


def test_int8_model_matches_reference(int8_file):
    """Logits against the JAX package's int8-layout load at nmse < 1e-9,
    equal greedy streams; the same through params_from_numpy."""
    _, tcfg, t8, jcfg, j8, _ = int8_file
    toks = np.random.default_rng(2).integers(0, 256, 11).astype(np.int32)
    got, ref = recipe_logits(jcfg, j8, tcfg, t8, toks, MAX_SEQ)
    assert nmse(got, ref) < 1e-9
    prompt = [int(t) for t in toks]
    stream = jllama.generate(jcfg, j8, prompt, 6, max_seq=MAX_SEQ)
    assert tllama.generate(tcfg, t8, prompt, 6, max_seq=MAX_SEQ, device="cpu") == stream
    carried = tllama.params_from_numpy(jax_params_to_numpy(j8), device="cpu")
    assert carried["blocks"][0]["w_down"].layout == "int8"
    got2, _ = recipe_logits(jcfg, j8, port_cfg(jcfg), carried, toks, MAX_SEQ)
    assert nmse(got2, ref) < 1e-9


def test_int8_engine_matches_generate(int8_file):
    """Row invariance end to end: the engine's batched decode and padded
    prefill chunks give generate's streams."""
    _, tcfg, t8, _, _, _ = int8_file
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (5, 20)]
    eng = Engine(tllama, tcfg, t8, max_batch=2, max_seq=MAX_SEQ, chunk_size=16, device="cpu")
    rids = [eng.submit(p, 4) for p in prompts]
    done = {r.rid: r.out for r in eng.run()}
    for rid, p in zip(rids, prompts):
        assert p + done[rid] == tllama.generate(tcfg, t8, p, 4, max_seq=MAX_SEQ, device="cpu")


def test_apply_weights_layout(int8_file):
    path, *_, tk = int8_file
    assert tqz.apply_weights_layout(tk, "kernel") is tk
    conv = tqz.apply_weights_layout(tk, "int8")
    assert {t.layout for _, t in _matrices(conv)} == {"int8"}
    assert torch.equal(conv["blocks"][1]["w_down"].fields["w8t"],
                       tqz.to_int8_layout(tk["blocks"][1]["w_down"]).fields["w8t"])
    assert torch.equal(conv["out_norm"], tk["out_norm"])
    for bad in ("wire", "int4"):
        with pytest.raises(ValueError):
            tqz.apply_weights_layout(tk, bad)
        with pytest.raises(ValueError):
            tllama.load(path, device="cpu", layout=bad)
