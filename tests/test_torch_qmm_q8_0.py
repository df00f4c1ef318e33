"""Port parity: Q8_0 dequantization and the Q8_0 matmul kernels K5 (f32)
and K5-i8 (int8) and their routing, against the JAX package (its numpy
oracle, its dequant, and its Pallas kernels in interpret mode on the CPU).
On the CPU the port runs each kernel's plain PyTorch version; the CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py."""
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
from ggml_gfx906_tpu_torch.ops.cuda import qmm_q8_0
from ggml_gfx906_tpu_torch.quant import dequant_math as tdm
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import nmse

RNG = np.random.default_rng(8)
Q8 = GGMLType.Q8_0


def _weights(n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(Q8, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        Q8, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()}, "cpu")
    return w, jq, tq


def _tile_order(a, rows):
    """The reference's in-tile lane order (lane 4*j + b) → natural order
    (element 32*b + j) of each 128-element tile."""
    return np.asarray(a).reshape(rows, -1, 32, 4).transpose(0, 1, 3, 2).reshape(rows, -1)


@pytest.mark.parametrize("n,k", [(64, 256), (48, 768)])
def test_dequant_bit_identical(n, k):
    w, jq, tq = _weights(n, k, seed=k)
    b = quantize(Q8, w)
    oracle = jdm.dequant_q8_0(np, b["d"], b["qs"]).reshape(n, k)
    assert np.array_equal(np.asarray(jqz.dequant(jq)), oracle)
    assert np.array_equal(tqz.dequant(tq).numpy(), oracle)
    tw = tqz.QuantTensor.from_blocks(Q8, b, "cpu")
    assert np.array_equal(tqz.dequant(tw).numpy(), oracle)
    for f in ("qs", "d"):
        assert torch.equal(tq.fields[f], tw.fields[f]), f
    got = tdm.dequant_q8_0(torch.from_numpy(b["d"].copy()), torch.from_numpy(b["qs"].copy()))
    assert np.array_equal(got.reshape(n, k).numpy(), oracle)


# K5: the bound is tests/test_ops.py::test_qmatmul's (f32-expand kernels)
@pytest.mark.parametrize("m", [1, 8, 63])
@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("n", [64, 128])
def test_k5_matches_reference(m, k, n):
    _, jq, tq = _weights(n, k, seed=k + n)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jqmm.qmm_q8_0(jnp.asarray(x), jq.fields["qs"], jq.fields["d"]))
    got = qmm_q8_0.qmm_q8_0(torch.from_numpy(x), tq.fields["qs"], tq.fields["d"])
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("m", [64, 128])
def test_k5_i8_operands_bit_equal(m):
    """q8_split_x only permutes lanes inside a 128-tile, so the port's
    natural-order tiles give the same ex bit for bit and the same qx up to
    that permutation; the folded scales (_tile_fold with dm None, qmax 127)
    and the int8 weights (_round_i8(q·dsc')) are bit-equal too."""
    k, n = 768, 96
    _, jq, tq = _weights(n, k, seed=1)
    x = RNG.standard_normal((m, k)).astype(np.float32) * 3.0
    jqx, jex = jqmm.quantize_x_tiles(jqmm.q8_split_x(jnp.asarray(x)))
    qx, ex, dsc_f, dw = (o.numpy() for o in qmm_q8_0.prepare_i8(
        torch.from_numpy(x), tq.fields["d"]))
    assert np.array_equal(_tile_order(jqx, m), qx)
    assert np.array_equal(np.asarray(jex), ex)
    jdsc, jdm_f, jdw = jqmm._tile_fold(jq.fields["d"], None, 4, 127.0)
    assert jdm_f is None
    assert np.array_equal(np.asarray(jdsc), dsc_f) and np.array_equal(np.asarray(jdw), dw)
    # int8 weights: the reference's expansion in its lane order
    rep = np.tile(np.asarray(jdsc).reshape(n, -1, 4), (1, 1, 32)).reshape(n, k)
    w8_ref = np.asarray(jqmm._round_i8(
        jnp.asarray(np.asarray(jq.fields["qs"]).astype(np.float32)) * jnp.asarray(rep)))
    w8 = qmm_q8_0.expand_w8(tq.fields["qs"], torch.from_numpy(dsc_f)).numpy()
    assert np.array_equal(_tile_order(w8_ref, n), w8)


@pytest.mark.parametrize("m", [64, 128])
def test_k5_i8_matches_reference(m):
    """nmse < 1e-7 against the interpret-mode Pallas kernel, as for K3
    (tests/test_torch_qmm.py): the int8 operands are bit-equal, only the
    f32 epilogue's rounding can differ there."""
    k, n = 768, 128
    _, jq, tq = _weights(n, k, seed=3)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    got = qmm_q8_0.qmm_q8_0_i8(torch.from_numpy(x), tq.fields["qs"], tq.fields["d"]).numpy()
    ref = np.asarray(jqmm.qmm_q8_0_i8(jnp.asarray(x), jq.fields["qs"], jq.fields["d"]))
    assert got.shape == (m, n)
    assert nmse(got, ref) < 1e-7


@pytest.mark.parametrize("m", [64, 160])
def test_k5_i8_against_dense(m):
    """The int8 route's error class vs the exact dequantized product
    (tests/test_qmm_int8.py:37-48)."""
    n, k = 96, 512
    _, _, tq = _weights(n, k, seed=m)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    dense = tqz.dequant(tq).numpy()
    got = qmm_q8_0.qmm_q8_0_i8(torch.from_numpy(x), tq.fields["qs"], tq.fields["d"]).numpy()
    assert nmse(got, x @ dense.T) < 2e-4


def test_dispatch_routes_q8_0_by_m():
    """Q8_0 takes K5-i8 at M >= int8_min_m (> 0) and K5 below, as
    ops/pallas/dispatch.py routes it; int8_min_m = 0 disables the int8
    route; a type without a ported kernel still raises there, and loads
    into the int8 layout."""
    min_m = jconfig.get("int8_min_m")
    n, k = 64, 256
    _, jq, tq = _weights(n, k, seed=9)
    dense = tqz.dequant(tq).numpy()
    for m in (1, min_m - 1, min_m):
        x = RNG.standard_normal((m, k)).astype(np.float32)
        assert tdispatch.route(m, Q8) == ("i8" if m >= min_m else "f32")
        got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
        ref = np.asarray(jqz.qmatmul(jnp.asarray(x), jq))
        assert nmse(got, x @ dense.T) < (1e-10 if m < min_m else 2e-4)
        assert nmse(got, ref) < (1e-10 if m < min_m else 1e-7)
    tconfig.set("int8_min_m", 0)
    try:
        assert tdispatch.route(4096, Q8) == "f32"
    finally:
        tconfig.unset("int8_min_m")
    for qtype in (GGMLType.IQ4_NL, GGMLType.Q8_K):
        with pytest.raises(NotImplementedError):
            tdispatch.route(1, qtype)
    # IQ4_NL has no kernel: with the codecs it loads in the int8 layout
    iq = tqz.QuantTensor.from_wire(GGMLType.IQ4_NL, np.zeros(0, np.uint8), (0, 256), "cpu")
    assert iq.layout == "int8" and tuple(iq.fields["w8t"].shape) == (2, 0, 128)
    # Q8_K has no kernel in either package: it loads in the "wire" layout
    assert tqz.QuantTensor.from_wire(GGMLType.Q8_K, np.zeros(292, np.uint8), (1, 256),
                                     "cpu").layout == "wire"
