"""Port parity: the "wire" layout. Where the kernels do not take a shape (a
block-32 type whose rows are a multiple of 32 but not of 256, or of 128 for
Q8_0) and for Q8_1 and Q8_K, the port keeps the block fields, dequantizes
them and multiplies in f32, as the reference dequantizes its wire fields and
hands them to XLA (ggml_gfx906_tpu/ops/quantized.py:339-341, 628-639). A
llama whose n_ff is 288 loads and serves in both packages: its ffn_down rows
are 288 long (nine 32-blocks), the other matrices take their kernels."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.quant.registry import quantize as reg_quantize
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops import quantized as tqz

from _torch_port import (jax_params_to_numpy, nmse, port_cfg, recipe_cfg, recipe_logits,
                         recipe_weights, write_recipe_gguf)

MAX_SEQ = 64
TYPES = {"q4_0": GGMLType.Q4_0, "q8_0": GGMLType.Q8_0}
CFG = recipe_cfg(n_ff=288, n_layer=2, n_ctx=MAX_SEQ)


@pytest.fixture(scope="module", params=list(TYPES))
def models(request):
    qtype = TYPES[request.param]
    jp = jllama.random_params(CFG, seed=4, qtype=qtype)
    tp = tllama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    return qtype, jp, port_cfg(CFG), tp


def test_layouts(models):
    """ffn_down is "wire" in both packages; every other matrix "kernel"."""
    _, jp, _, tp = models
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            want = "wire" if key == "w_down" else "kernel"
            assert jb[key].layout == tb[key].layout == want, key
    np.testing.assert_array_equal(tqz.dequant(tp["blocks"][0]["w_down"]).numpy(),
                                  np.asarray(jqz.dequant(jp["blocks"][0]["w_down"])))


def test_logits_and_streams_match_reference(models):
    """Logits at tests/test_llama.py's f32 bound (nmse < 1e-9), greedy
    streams equal."""
    _, jp, tcfg, tp = models
    toks = np.random.default_rng(1).integers(0, 256, 9).astype(np.int32)
    got, ref = recipe_logits(CFG, jp, tcfg, tp, toks, MAX_SEQ)
    assert nmse(got, ref) < 1e-9
    prompt = [int(t) for t in toks]
    assert (tllama.generate(tcfg, tp, prompt, 6, max_seq=MAX_SEQ, device="cpu")
            == jllama.generate(CFG, jp, prompt, 6, max_seq=MAX_SEQ))


@pytest.mark.parametrize("name", list(TYPES))
def test_same_gguf_loads_and_matches(tmp_path, name):
    """One GGUF through both packages' llama.load: the port raised on it
    before it had the wire layout."""
    qtype = TYPES[name]
    path = tmp_path / f"{name}_ff288.gguf"
    write_recipe_gguf(path, CFG, recipe_weights(lambda *_: qtype, CFG, seed=2))
    jcfg, jp = jllama.load(path)
    tcfg, tp = tllama.load(path, device="cpu")
    assert tp["blocks"][1]["w_down"].layout == "wire"
    assert tp["blocks"][1]["w_up"].layout == "kernel"
    toks = np.array([3, 1, 4, 1, 5, 9, 2], np.int32)
    got, ref = recipe_logits(jcfg, jp, tcfg, tp, toks, MAX_SEQ)
    assert nmse(got, ref) < 1e-9


@pytest.mark.parametrize("qtype", [GGMLType.Q8_1, GGMLType.Q8_K, GGMLType.Q4_1,
                                   GGMLType.Q5_0, GGMLType.Q5_1])
def test_wire_dequant_matmul_and_rows(qtype):
    """Dequantization bit-identical to the reference's wire fields, the
    product at f32 precision, the row gather bit-identical."""
    rng = np.random.default_rng(int(qtype))
    n, k = 24, 288 if qtype != GGMLType.Q8_K else 512
    w = rng.standard_normal((n, k)).astype(np.float32)
    blocks = reg_quantize(qtype, w.reshape(-1, 256 if qtype == GGMLType.Q8_K else 32))
    blocks = blocks.reshape(n, -1)
    jq = jqz.QuantTensor.from_blocks(qtype, blocks, prefer_kernel=False)
    tq = tqz.QuantTensor.from_blocks(qtype, blocks, "cpu")
    assert jq.layout == tq.layout == "wire"
    dense = np.asarray(jqz.dequant(jq))
    np.testing.assert_array_equal(tqz.dequant(tq).numpy(), dense)
    x = rng.standard_normal((5, k)).astype(np.float32)
    assert nmse(tqz.qmatmul(torch.from_numpy(x), tq).numpy(),
                np.asarray(jqz.qmatmul(jnp.asarray(x), jq))) < 1e-12
    ids = torch.tensor([[3, 0], [23, 3]])
    np.testing.assert_array_equal(tqz.embed_rows(tq, ids).numpy(), dense[ids.numpy()])


def test_kernel_wrappers_still_reject_unaligned_rows():
    """The wire layout is a branch on shape in qmatmul; a kernel given rows
    it does not take still raises."""
    from ggml_gfx906_tpu_torch.ops.cuda import qmm_q4_0

    w = np.random.default_rng(0).standard_normal((8, 288)).astype(np.float32)
    tq = tqz.QuantTensor.from_blocks(GGMLType.Q4_0, reg_quantize(GGMLType.Q4_0, w.reshape(-1, 32))
                                     .reshape(8, -1), "cpu")
    with pytest.raises(ValueError):
        qmm_q4_0.qmm_q4_0(torch.zeros((1, 288)), tq.fields["qs"], tq.fields["d"])
