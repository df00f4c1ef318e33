"""Port parity: Q4_1, Q5_0 and Q5_1 dequantization, the matmul kernel K8
(`qmm_q4_1`, `qmm_q5_0`, `qmm_q5_1`) and its routing, against the JAX
package (its numpy oracle, its dequant, and its Pallas kernels in interpret
mode on the CPU). On the CPU the port runs each entry point's plain PyTorch
version; the CUDA kernel is held against the same plain versions on the
card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.ops.pallas import qmm as jqmm
from ggml_gfx906_tpu.quant import dequant_math as jdm
from ggml_gfx906_tpu.quant import quantize
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.ops.cuda import dispatch as tdispatch
from ggml_gfx906_tpu_torch.ops.cuda import qmm_legacy
from ggml_gfx906_tpu_torch.quant import dequant_math as tdm

from _torch_port import nmse

RNG = np.random.default_rng(41)
TYPES = (GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1)
# each type's wire fields in the order its dequant functions take them
WIRE = {GGMLType.Q4_1: ("d", "m", "qs"), GGMLType.Q5_0: ("d", "qh", "qs"),
        GGMLType.Q5_1: ("d", "m", "qh", "qs")}


def _weights(qtype, n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(qtype, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        qtype, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()}, "cpu")
    return w, jq, tq


def _fields(qt):
    return [qt.fields[f] for f in tdispatch.FIELDS[qt.qtype]]


# the reference pads the Q5 block axis to a multiple of 32 at K = 256, 768
# and 1280 (8, 24 and 40 blocks), not at 1024
@pytest.mark.parametrize("k", [256, 768, 1024, 1280])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dequant_bit_identical(qtype, k):
    """From wire blocks, from the JAX kernel layout (pad dropped) and
    through the torch dequant_math functions, bit-identical to the numpy
    oracle and to jqz.dequant, with the same fields either way."""
    n = 48
    w, jq, tq = _weights(qtype, n, k, seed=k)
    b = quantize(qtype, w)
    oracle = getattr(jdm, f"dequant_{qtype.name.lower()}")(
        np, *(b[f] for f in WIRE[qtype])).reshape(n, k)
    assert np.array_equal(np.asarray(jqz.dequant(jq)), oracle)
    assert np.array_equal(tqz.dequant(tq).numpy(), oracle)
    tw = tqz.QuantTensor.from_blocks(qtype, b, "cpu")
    assert np.array_equal(tqz.dequant(tw).numpy(), oracle)
    assert set(tq.fields) == set(tw.fields) == set(tdispatch.FIELDS[qtype])
    for f in tw.fields:
        assert torch.equal(tq.fields[f], tw.fields[f]), f
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = getattr(tdm, f"dequant_{qtype.name.lower()}")(*(t(b[f]) for f in WIRE[qtype]))
    assert np.array_equal(got.reshape(n, k).numpy(), oracle)


def test_q5_high_bit_31():
    """Bit 31 of the qh word is element 31's fifth bit: assembling the
    word must not sign-extend it."""
    qh = torch.tensor([[0, 0, 0, 0x80], [0xFF, 0xFF, 0xFF, 0xFF]], dtype=torch.uint8)
    hb = tdm._q5_high_bits(qh)
    assert hb[0].tolist() == [0] * 31 + [16]
    assert hb[1].tolist() == [16] * 32


# K8: the bound is tests/test_ops.py::test_qmatmul's (f32-expand kernels)
@pytest.mark.parametrize("m", [1, 8, 63, 128])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_k8_matches_reference(qtype, m):
    """At K = 768 (24 blocks per row, which the reference pads to 32 for
    Q5) against the interpret-mode Pallas kernel."""
    n, k = 96, 768
    _, jq, tq = _weights(qtype, n, k, seed=k + m)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    name = qtype.name.lower()
    ref = np.asarray(getattr(jqmm, f"qmm_{name}")(
        jnp.asarray(x), *(jq.fields[f] for f in jqz._KFIELDS[qtype])))
    got = getattr(qmm_legacy, f"qmm_{name}")(torch.from_numpy(x), *_fields(tq))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dispatch_routes_f32_at_every_m(qtype):
    """None of the three has an int8 twin (ops/pallas/dispatch.py:18): every
    M takes K8, and qmatmul matches jqz.qmatmul and the dense product."""
    min_m = jconfig.get("int8_min_m")
    n, k = 64, 256
    _, jq, tq = _weights(qtype, n, k, seed=9)
    dense = tqz.dequant(tq).numpy()
    assert qtype not in tdispatch.INT8_TYPES
    for m in (1, min_m, 2 * min_m):
        x = RNG.standard_normal((m, k)).astype(np.float32)
        assert tdispatch.route(m, qtype) == "f32"
        got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
        ref = np.asarray(jqz.qmatmul(jnp.asarray(x), jq))
        assert nmse(got, x @ dense.T) < 1e-10
        assert nmse(got, ref) < 1e-10


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_embed_rows_gathers_exact_rows(qtype):
    """A token_embd row gather dequantizes the gathered rows bit for bit."""
    _, _, tq = _weights(qtype, 40, 512, seed=5)
    ids = torch.tensor([[3, 0, 39], [3, 17, 8]])
    got = tqz.embed_rows(tq, ids)
    assert got.shape == (2, 3, 512)
    assert torch.equal(got, tqz.dequant(tq)[ids])


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_k8_rejects_bad_operands(qtype):
    """Shapes are checked before any kernel runs: K must be a multiple of
    256 and every field must match it."""
    _, _, tq = _weights(qtype, 32, 512, seed=2)
    fn = getattr(qmm_legacy, f"qmm_{qtype.name.lower()}")
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 384)), *_fields(tq))
    bad = _fields(tq)
    bad[-1] = bad[-1][:, :-1]
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 512)), *bad)
