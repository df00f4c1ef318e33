"""Port parity: the codecs (ggml_gfx906_tpu/quant/, ops/act_quant.py) and
the int8-layout load of the types without kernels. Every quantizer's wire
bytes equal the reference's exactly, with and without an importance row
(the IQ grid searches through their plain versions); every dequantizer's
f32 output equals the reference's bit for bit; activation quantization
likewise. The inputs are made from a seed with numpy, a few rows per type
(the reference's numpy searches are slow)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.ops import act_quant as jact
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.quant import registry as ref
from ggml_gfx906_tpu.quant.types import GGMLType, TYPE_TRAITS
from ggml_gfx906_tpu_torch.ops import act_quant as tact
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.ops.cuda import iq_search
from ggml_gfx906_tpu_torch.quant import registry as port
from ggml_gfx906_tpu_torch.quant.numerics import seq_sum

from _torch_port import one_torch_thread  # noqa: F401

N = 512
# every type the registry quantizes: supported_quant_types, and the three
# that only take an importance row (IQ2_XXS, IQ2_XS, IQ1_S)
QUANTIZED = sorted(set(port.supported_quant_types()) | set(port._QUANTIZE_IMATRIX))
WEIGHTED = [t for t in QUANTIZED if t in ref._QUANTIZE_IMATRIX or t in ref._IMATRIX_IGNORED]
SEARCHES = set(iq_search.ROUTES)


def _rows(seed: int) -> np.ndarray:
    """Gaussian rows of three scales, a row with all-zero blocks, constant
    blocks, one outlier per 32-block, a negative maximum per block, and a
    zero row."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((3, N)).astype(np.float32) * np.float32([[1.0], [1e-3], [30.0]])
    zero_blocks = g[:1].copy()
    zero_blocks[:, :64] = 0
    zero_blocks[:, 256:288] = 0
    const = np.repeat(rng.uniform(-1, 1, N // 32), 32)[None].astype(np.float32)
    outlier = (0.01 * rng.standard_normal((1, N))).astype(np.float32)
    outlier[:, rng.integers(0, 32) + 32 * np.arange(N // 32)] = 5.0
    negmax = g[:1].copy()
    negmax[:, 5::32] = -9.0
    return np.concatenate([g, zero_blocks, const, outlier, negmax,
                           np.zeros((1, N), np.float32)])


def _mxfp4_edges() -> np.ndarray:
    """Rows of 32-blocks whose absmax is 2^k(1 − 2^−24), 2^k or 2^k(1 +
    2^−23), k from −130 to 127: where floor(log2) flips."""
    amax = [np.float32(np.ldexp(f, k)) for k in range(-130, 128)
            for f in (1 - 2.0 ** -24, 1.0, 1 + 2.0 ** -23)]
    amax = np.array([a for a in amax if np.isfinite(a) and a > 0], np.float32)
    amax = np.resize(amax, (-(-len(amax) // 16)) * 16).reshape(-1, 16)
    x = np.zeros((amax.shape[0], 16, 32), np.float32)
    x[:, :, 3] = amax
    x[:, :, 7] = -amax * np.float32(0.37)
    return x.reshape(-1, N)


def _ref_bytes(t, x, qw=None) -> np.ndarray:
    """The reference's wire bytes, (rows, row size). Its IQ4 imatrix paths
    take the importance row for a single row only (their broadcast fails on
    more), and its IQ3 searches index it by super-block without wrapping,
    so those go row by row."""
    parts = [x[i:i + 1] for i in range(len(x))] \
        if qw is not None and t in (GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.IQ3_XXS,
                                    GGMLType.IQ3_S) else [x]
    return np.concatenate([np.ascontiguousarray(ref.quantize(t, p, qw)).view(np.uint8)
                           .reshape(len(p), -1) for p in parts])


def _weights(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.05, 3.0, N).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("qtype", QUANTIZED, ids=lambda t: t.name)
def test_quantizer_bytes_equal_reference(qtype, weighted):
    if not weighted and qtype not in port.supported_quant_types():
        # IQ2_XXS, IQ2_XS, IQ1_S: both refuse (the reference's table lookup
        # with KeyError)
        with pytest.raises(NotImplementedError, match="has no quantizer"):
            port.quantize(qtype, torch.zeros(1, N))
        with pytest.raises(KeyError):
            ref.quantize(qtype, np.zeros((1, N), np.float32))
        return
    if weighted and qtype not in WEIGHTED:
        with pytest.raises(NotImplementedError):
            port.quantize(qtype, torch.zeros(1, N), torch.ones(N))
        with pytest.raises(NotImplementedError):
            ref.quantize(qtype, np.zeros((1, N), np.float32), np.ones(N, np.float32))
        return
    x = _rows(int(qtype))
    if qtype == GGMLType.MXFP4:
        x = np.concatenate([x, _mxfp4_edges()])
    qw = _weights(int(qtype) + 1) if weighted else None
    got = port.quantize(qtype, torch.from_numpy(x), None if qw is None else torch.from_numpy(qw))
    assert got.dtype == torch.uint8 and got.shape == (len(x), TYPE_TRAITS[qtype].type_size
                                                      * N // TYPE_TRAITS[qtype].blck_size)
    np.testing.assert_array_equal(got.numpy(), _ref_bytes(qtype, x, qw))


def _random_blocks(qtype, rng, rows: int, nb: int) -> np.ndarray:
    """Random wire blocks with finite f16 scales."""
    dt = TYPE_TRAITS[qtype].block_dtype
    b = rng.integers(0, 256, (rows, nb * dt.itemsize), dtype=np.uint8).view(dt)
    if "d" in dt.names:
        b["d"] = rng.uniform(-0.05, 0.05, b.shape).astype(dt["d"].base)
    if "dmin" in dt.names:
        b["dmin"] = rng.uniform(-0.05, 0.05, b.shape).astype(dt["dmin"].base)
    if "m" in dt.names:
        b["m"] = rng.uniform(-0.05, 0.05, b.shape).astype(dt["m"].base)
    if qtype == GGMLType.IQ1_M:
        b["scales"][..., 7] &= 0xBF          # the f16 scale's top exponent bit: finite
    return b.reshape(rows, nb)


@pytest.mark.parametrize("qtype", sorted(ref._DEQUANTIZE), ids=lambda t: t.name)
def test_dequantizer_bits_equal_reference(qtype):
    """All 24 dequantizers: the reference's blocks where the port quantizes
    the type without a search, random blocks with finite scales otherwise
    (the searches' own blocks: test_torch_iq_search.py)."""
    tt = TYPE_TRAITS[qtype]
    rng = np.random.default_rng(100 + int(qtype))
    if qtype in QUANTIZED and qtype not in SEARCHES:
        blocks = ref.quantize(qtype, _rows(int(qtype)))
    else:
        blocks = _random_blocks(qtype, rng, 6, N // tt.blck_size)
    want = ref.dequantize(qtype, blocks).reshape(len(blocks), -1)
    raw = torch.from_numpy(np.ascontiguousarray(blocks).view(np.uint8).reshape(len(blocks), -1))
    got = port.dequantize(qtype, raw, N).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("width", [16, 32, 256])
def test_seq_sum_is_a_left_to_right_f32_loop(width):
    a = np.random.default_rng(width).standard_normal((1000, width)).astype(np.float32)
    want = np.cumsum(a, axis=-1, dtype=np.float32)[..., -1]
    np.testing.assert_array_equal(seq_sum(torch.from_numpy(a)).numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("block", [32, 64])
def test_act_quant_bits_equal_reference(block):
    x = np.random.default_rng(block).standard_normal((5, 512)).astype(np.float32)
    x[0, :block] = 0
    x[1, ::3] *= 100
    x[2, :block] = 0.5 * (2 * np.arange(block) - block + 1) / (block - 1) * 127  # .5 ties
    want = jact.quantize_q8_with_sums(jnp.asarray(x), block)
    got = tact.quantize_q8_with_sums(torch.from_numpy(x), block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint8), np.asarray(w).view(np.uint8))
    np.testing.assert_array_equal(
        tact.dequantize_q8(got[0], got[1], block).numpy().view(np.uint32),
        np.asarray(jact.dequantize_q8(want[0], want[1], block)).view(np.uint32))


@pytest.mark.parametrize("qtype", [GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.TQ2_0,
                                   GGMLType.MXFP4], ids=lambda t: t.name)
def test_int8_layout_load_matches_reference(qtype):
    """A type without kernels loads from its wire bytes into the int8
    layout with the reference's w8t and dwt (quantized.py:345-369), at two
    row lengths whose tiles _choose_tile cuts differently."""
    rng = np.random.default_rng(int(qtype))
    tt = TYPE_TRAITS[qtype]
    for k in (1024, 768):
        if qtype in QUANTIZED and qtype not in SEARCHES:
            blocks = ref.quantize(qtype, rng.standard_normal((8, k)).astype(np.float32) * 0.05)
        else:
            blocks = _random_blocks(qtype, rng, 8, k // tt.blck_size)
        want = jqz.QuantTensor.from_blocks(qtype, blocks)
        got = tqz.QuantTensor.from_wire(qtype, np.ascontiguousarray(blocks).view(np.uint8),
                                        (8, k), "cpu")
        assert want.layout == got.layout == "int8"
        for f in ("w8t", "dwt"):
            np.testing.assert_array_equal(got.fields[f].numpy(), np.asarray(want.fields[f]))
