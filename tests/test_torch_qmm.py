"""Port parity: Q4_K matmul kernels K1 (f32) and K3 (int8) and their
routing, against the JAX package's Pallas kernels (interpret mode on the
CPU). On the CPU the port runs each kernel's plain PyTorch version; the
CUDA kernels are held against the same plain versions on the card by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.ops.pallas import qmm as jqmm
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.ops.cuda import dispatch as tdispatch
from ggml_gfx906_tpu_torch.ops.cuda import qmm as tqmm
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import nmse

RNG = np.random.default_rng(5)


def _weights(n, k, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(GGMLType.Q4_K, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        GGMLType.Q4_K, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()},
        "cpu")
    return jq, tq


def _kernel_order(a, m):
    """JAX kernel element order (lane 4*j + g) → the port's (32*g + j)."""
    return np.asarray(a).reshape(m, -1, 32, 4).transpose(0, 1, 3, 2).reshape(m, -1)


# K1: the bound is tests/test_ops.py::test_qmatmul's (f32-expand kernels)
@pytest.mark.parametrize("m", [1, 8, 63])
@pytest.mark.parametrize("k", [256, 768])
@pytest.mark.parametrize("n", [128, 384])
def test_k1_matches_reference(m, k, n):
    jq, tq = _weights(n, k, seed=k + n)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    f = jq.fields
    ref = np.asarray(jqmm.qmm_q4_K(jnp.asarray(x), f["qs"], f["scm"], f["dd"]))
    g = tq.fields
    got = tqmm.qmm_q4_K(torch.from_numpy(x), g["qs"], g["scm"], g["dd"])
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("m", [64, 128])
def test_k3_operands_bit_equal(m):
    """quantize_x_tiles groups the same elements as the reference (trouble
    spot: tiles are the lo/hi nibble halves of a superblock, in kernel
    element order there), and the folded scales and int8 weights equal the
    reference's math (_tile_fold, _round_i8 on q·dsc' − dm') bit for bit."""
    k, n = 768, 96
    jq, tq = _weights(n, k)
    x = RNG.standard_normal((m, k)).astype(np.float32) * 3.0
    xlo, xhi = jqmm.q4k_split_x(jnp.asarray(x))
    jqlo, jexlo = jqmm.quantize_x_tiles(xlo)
    jqhi, jexhi = jqmm.quantize_x_tiles(xhi)
    ops = [o.numpy() for o in tqmm.prepare_i8(torch.from_numpy(x),
                                              tq.fields["scm"], tq.fields["dd"])]
    qxlo, exlo, qxhi, exhi, dsclo_f, dschi_f, dmlo_f, dmhi_f, dwlo, dwhi = ops
    assert np.array_equal(_kernel_order(jqlo, m), qxlo)
    assert np.array_equal(_kernel_order(jqhi, m), qxhi)
    assert np.array_equal(np.asarray(jexlo), exlo)
    assert np.array_equal(np.asarray(jexhi), exhi)
    dsclo, dschi, dmlo, dmhi = jqmm.q4k_scale_arrays(jq.fields["scm"], jq.fields["dd"])
    for js, jm, ts, tm, tw, hi in ((dsclo, dmlo, dsclo_f, dmlo_f, dwlo, False),
                                   (dschi, dmhi, dschi_f, dmhi_f, dwhi, True)):
        jsf, jmf, jdw = (np.asarray(a) for a in jqmm._tile_fold(js, jm, 4, 15.0))
        assert np.array_equal(jsf, ts) and np.array_equal(jmf, tm)
        assert np.array_equal(jdw, tw)
        # int8 weights: the reference's expansion, one op at a time
        qs_k = np.asarray(jq.fields["qs"]).astype(np.int32)
        nib = ((qs_k >> 4) if hi else (qs_k & 0xF)).astype(np.float32)
        rep = lambda a: jnp.asarray(np.tile(a.reshape(n, -1, 4), (1, 1, 32)).reshape(n, -1))  # noqa: E731
        w8_ref = np.asarray(jqmm._round_i8(jnp.asarray(nib) * rep(jsf) - rep(jmf)))
        w8 = tqmm.expand_w8(tq.fields["qs"], torch.from_numpy(ts),
                            torch.from_numpy(tm), hi).numpy()
        assert np.array_equal(_kernel_order(w8_ref, n), w8)


def _k3_reference_math(x, jq):
    """The reference K3 computed op by op from its own helpers: exact
    integer tile dots, then acc += p·ex·dw in the kernel's order."""
    m = x.shape[0]
    n = jq.shape[0]
    f = jq.fields
    xlo, xhi = jqmm.q4k_split_x(jnp.asarray(x))
    acc = np.zeros((m, n), np.float32)
    dsclo, dschi, dmlo, dmhi = jqmm.q4k_scale_arrays(f["scm"], f["dd"])
    qs_k = np.asarray(f["qs"]).astype(np.int32)
    halves = []
    for xh, ds, dm, nib in ((xlo, dsclo, dmlo, qs_k & 0xF), (xhi, dschi, dmhi, qs_k >> 4)):
        qx, ex = (np.asarray(a) for a in jqmm.quantize_x_tiles(xh))
        dsf, dmf, dw = (np.asarray(a) for a in jqmm._tile_fold(ds, dm, 4, 15.0))
        rep = lambda a: jnp.asarray(np.tile(a.reshape(n, -1, 4), (1, 1, 32)).reshape(n, -1))  # noqa: E731
        w8 = np.asarray(jqmm._round_i8(jnp.asarray(nib.astype(np.float32)) * rep(dsf)
                                       - rep(dmf)))
        halves.append((qx, ex, w8, dw))
    for t in range(x.shape[1] // 256):
        for qx, ex, w8, dw in halves:
            s = slice(t * 128, (t + 1) * 128)
            p = (qx[:, s].astype(np.int64) @ w8[:, s].astype(np.int64).T).astype(np.float32)
            acc = acc + (p * ex[:, t:t + 1]) * dw[None, :, t]
    return acc


@pytest.mark.parametrize("m", [64, 128])
def test_k3_matches_reference(m):
    """rtol 1e-6 against the reference's K3 math: both sides round the same
    integers, so only the f32 epilogue order can differ (atol covers outputs
    that cancel to near zero). Against the interpret-mode Pallas kernel
    itself the bound is nmse < 1e-7: XLA's CPU compiler contracts q·dsc' −
    dm' into one FMA there, which flips a few int8 weight roundings per
    10^5 (measured nmse ~4e-9 at 384×768); the port rounds the product and
    the difference separately, as the reference's source is written."""
    k, n = 768, 384
    jq, tq = _weights(n, k, seed=3)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    g = tq.fields
    got = tqmm.qmm_q4_K_i8(torch.from_numpy(x), g["qs"], g["scm"], g["dd"]).numpy()
    ref = _k3_reference_math(x, jq)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    f = jq.fields
    pallas = np.asarray(jqmm.qmm_q4_K_i8(jnp.asarray(x), f["qs"], f["scm"], f["dd"]))
    assert nmse(got, pallas) < 1e-7


@pytest.mark.parametrize("m", [64, 160])
def test_k3_against_dense(m):
    """The int8 route's error class vs the exact dequantized product
    (tests/test_qmm_int8.py:48)."""
    n, k = 96, 512
    jq, tq = _weights(n, k, seed=m)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    dense = tqz.dequant(tq).numpy()
    g = tq.fields
    got = tqmm.qmm_q4_K_i8(torch.from_numpy(x), g["qs"], g["scm"], g["dd"]).numpy()
    assert nmse(got, x @ dense.T) < 2e-4


def test_dispatch_routes_by_m():
    """Same route as ops/pallas/dispatch.py for M below and at int8_min_m
    (mirrors tests/test_qmm_int8.py::test_dispatch_routes_by_m)."""
    min_m = jconfig.get("int8_min_m")
    assert tconfig.get("int8_min_m") == min_m
    n, k = 64, 256
    jq, tq = _weights(n, k, seed=9)
    dense = tqz.dequant(tq).numpy()
    for m in (1, min_m - 1, min_m):
        x = RNG.standard_normal((m, k)).astype(np.float32)
        assert tdispatch.route(m, GGMLType.Q4_K) == ("i8" if m >= min_m else "f32")
        got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
        ref = np.asarray(jqz.qmatmul(jnp.asarray(x), jq))
        bound = 1e-10 if m < min_m else 2e-4
        assert nmse(got, x @ dense.T) < bound
        assert nmse(got, ref) < (1e-10 if m < min_m else 1e-7)
    tconfig.set("int8_min_m", 0)           # 0 disables the int8 route
    try:
        assert tdispatch.route(4096, GGMLType.Q4_K) == "f32"
    finally:
        tconfig.unset("int8_min_m")


def test_unported_types_and_knobs_raise():
    """A type that has a kernel in neither package raises, as does a value
    qmm_pipeline does not take."""
    with pytest.raises(NotImplementedError):
        tdispatch.route(1, GGMLType.IQ4_NL)
    with pytest.raises(ValueError):
        tconfig.set("qmm_pipeline", "bogus")
    assert tconfig.get("qmm_pipeline") == "off"
