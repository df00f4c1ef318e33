"""Port parity: Q2_K and Q3_K dequantization, the matmul kernel K9
(`qmm_q2_K`, `qmm_q3_K`) and its routing, against the JAX package (its
numpy oracle, its dequant, its kernel layouts and its Pallas kernels in
interpret mode on the CPU). On the CPU the port runs each entry point's
plain PyTorch version; the CUDA kernel is held against the same plain
versions on the card by chip_smoke.py."""
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
from ggml_gfx906_tpu_torch.ops.cuda import qmm_q23k
from ggml_gfx906_tpu_torch.quant import dequant_math as tdm
from ggml_gfx906_tpu_torch.quant.kquants import pack_q3_scales
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import nmse

RNG = np.random.default_rng(43)
TYPES = (GGMLType.Q2_K, GGMLType.Q3_K)
# each type's wire fields in the order its dequant functions take them
WIRE = {GGMLType.Q2_K: ("d", "dmin", "scales", "qs"),
        GGMLType.Q3_K: ("d", "hmask", "scales", "qs")}


def _name(qtype):
    return qtype.name[:2].lower() + "_K"


def _weights(qtype, n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(qtype, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        qtype, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()}, "cpu")
    return w, jq, tq


def _fields(qt):
    return [qt.fields[f] for f in tdispatch.FIELDS[qt.qtype]]


# 1, 2 and 3 superblocks per row: the reference pads 1 and 3 to an even count
@pytest.mark.parametrize("k", [256, 512, 768])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dequant_bit_identical(qtype, k):
    """From wire blocks, from the JAX kernel layout (pad dropped) and
    through the torch dequant_math functions, bit-identical to the numpy
    oracle and to jqz.dequant, with the same fields either way."""
    n = 48
    w, jq, tq = _weights(qtype, n, k, seed=k)
    b = quantize(qtype, w)
    oracle = getattr(jdm, f"dequant_{_name(qtype)}")(
        np, *(b[f] for f in WIRE[qtype])).reshape(n, k)
    assert np.array_equal(np.asarray(jqz.dequant(jq)), oracle)
    assert np.array_equal(tqz.dequant(tq).numpy(), oracle)
    tw = tqz.QuantTensor.from_blocks(qtype, b, "cpu")
    assert np.array_equal(tqz.dequant(tw).numpy(), oracle)
    assert set(tq.fields) == set(tw.fields) == set(tdispatch.FIELDS[qtype])
    for f in tw.fields:
        assert torch.equal(tq.fields[f], tw.fields[f]), f
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = getattr(tdm, f"dequant_{_name(qtype)}")(*(t(b[f]) for f in WIRE[qtype]))
    assert np.array_equal(got.reshape(n, k).numpy(), oracle)


@pytest.mark.parametrize("k", [256, 512, 768])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_reference_layout_round_trip(qtype, k):
    """The port's fields hold no pad, and laid out again by the reference's
    own layout function they give back its kernel-layout fields exactly;
    the reference's two copies of each hmask byte (one per 128-element
    half) are equal, so keeping one loses nothing."""
    n, nb = 32, k // 256
    _, jq, tq = _weights(qtype, n, k, seed=k + 1)
    f = {name: np.asarray(a) for name, a in jq.fields.items()}
    assert f["qs"].shape[1] == (nb + nb % 2) * 64            # padded to even
    g = {name: t.numpy() for name, t in tq.fields.items()}
    assert g["qs"].shape == (n, nb * 64) and g["d"].shape == (n, nb)
    if qtype == GGMLType.Q2_K:
        back = jqmm.q2k_weight_layout(g["qs"].reshape(n, nb, 64),
                                      g["scales"].reshape(n, nb, 16), g["d"], g["dmin"])
        names = ("qs", "scm", "dq", "dm")
    else:
        lanes = f["hm"].reshape(n, -1, 16, 2, 2, 2)          # (chunk, jj, sb, h, s)
        assert np.array_equal(lanes[..., 0, :], lanes[..., 1, :])
        back = jqmm.q3k_weight_layout(g["qs"].reshape(n, nb, 64),
                                      g["hmask"].reshape(n, nb, 32),
                                      g["sc"].reshape(n, nb, 16), g["d"])
        names = ("qs", "hm", "sc", "dq")
    for name, a in zip(names, back):
        assert np.array_equal(a, f[name]), name


def test_q3k_element_255_high_bit():
    """Element 255 of a superblock takes bit 7 of hmask byte 31 (h = 1,
    t = 3, l = 31): with every quant 0, it alone is 0 and the rest are
    −4·d·sc."""
    qs = torch.zeros((1, 1, 64), dtype=torch.uint8)
    hmask = torch.zeros((1, 1, 32), dtype=torch.uint8)
    hmask[0, 0, 31] = 0x80
    scales = torch.from_numpy(pack_q3_scales(np.full((1, 1, 16), 3)))
    w = tdm.dequant_q3_K(torch.tensor([[0.5]]), hmask, scales, qs)[0]
    assert w[255].item() == 0.0
    assert torch.equal(w[:255], torch.full((255,), -6.0))
    oracle = jdm.dequant_q3_K(np, np.array([[0.5]], np.float32), hmask.numpy(),
                              scales.numpy(), qs.numpy())
    assert np.array_equal(w.numpy(), oracle.reshape(-1))


def test_pack_q3_scales_matches_reference_blocks():
    """chip_smoke.py builds Q3_K blocks with pack_q3_scales: it inverts the
    unpacking of the reference quantizer's scale bytes."""
    b = quantize(GGMLType.Q3_K, RNG.standard_normal((4, 512)).astype(np.float32))
    sc = tdm.unpack_q3_scales(torch.from_numpy(np.ascontiguousarray(b["scales"])))
    assert np.array_equal(pack_q3_scales(sc.numpy()), b["scales"])
    assert int(sc.min()) >= -32 and int(sc.max()) <= 31


# K9: the bound is tests/test_ops.py::test_qmatmul's (f32-expand kernels)
@pytest.mark.parametrize("m", [1, 8, 70])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_k9_matches_reference(qtype, m):
    """At K = 768 (3 superblocks per row, which the reference pads to 4)
    against the interpret-mode Pallas kernel."""
    n, k = 96, 768
    _, jq, tq = _weights(qtype, n, k, seed=k + m)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(getattr(jqmm, f"qmm_{_name(qtype)}")(
        jnp.asarray(x), *(jq.fields[f] for f in jqz._KFIELDS[qtype])))
    got = getattr(qmm_q23k, f"qmm_{_name(qtype)}")(torch.from_numpy(x), *_fields(tq))
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_dispatch_routes_f32_at_every_m(qtype):
    """Neither type has an int8 twin (ops/pallas/dispatch.py:18): every M
    takes K9 whatever int8_min_m is, and qmatmul matches jqz.qmatmul and
    the dense product."""
    min_m = jconfig.get("int8_min_m")
    n, k = 64, 256
    _, jq, tq = _weights(qtype, n, k, seed=9)
    dense = tqz.dequant(tq).numpy()
    assert qtype not in tdispatch.INT8_TYPES
    for m in (1, min_m, 2 * min_m):
        x = RNG.standard_normal((m, k)).astype(np.float32)
        assert tdispatch.route(m, qtype) == "f32"
        assert tdispatch.route(m, qtype, (n, k), cuda=True) == "f32"
        got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
        ref = np.asarray(jqz.qmatmul(jnp.asarray(x), jq))
        assert nmse(got, x @ dense.T) < 1e-10
        assert nmse(got, ref) < 1e-10
    for min_m in (0, 1):
        tconfig.set("int8_min_m", min_m)
        try:
            assert tdispatch.route(128, qtype) == "f32"
        finally:
            tconfig.unset("int8_min_m")


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_embed_rows_gathers_exact_rows(qtype):
    """A token_embd row gather dequantizes the gathered rows bit for bit."""
    _, _, tq = _weights(qtype, 40, 512, seed=5)
    ids = torch.tensor([[3, 0, 39], [3, 17, 8]])
    got = tqz.embed_rows(tq, ids)
    assert got.shape == (2, 3, 512)
    assert torch.equal(got, tqz.dequant(tq)[ids])


@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_k9_rejects_bad_operands(qtype):
    """Shapes are checked before any kernel runs: K must be a multiple of
    256 and every field must match it."""
    _, _, tq = _weights(qtype, 32, 512, seed=2)
    fn = getattr(qmm_q23k, f"qmm_{_name(qtype)}")
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 384)), *_fields(tq))
    bad = _fields(tq)
    bad[-1] = bad[-1][:, :-1]
    with pytest.raises(ValueError):
        fn(torch.zeros((2, 512)), *bad)
