"""Port parity: the IQ grid-search quantizers (ggml_gfx906_tpu/quant/
iquants.py:226-1238) and what rests on them. On the CPU the port runs the
plain versions of the search kernels S1-S3 (quant/iquants.py); their wire
bytes equal the reference's numpy searches' exactly, with and without an
importance row, on edge rows; make_qp_quants and the lattice builder
agree with the reference's; QuantTensor.quantize, a quantized file and
its greedy stream follow; csrc/iq_search.cu, compiled with g++ and run
thread by thread (scripts/torch_iq_emu.py), gives the plain versions'
bytes. Inputs are made from a seed with numpy, a few super-blocks each
(the reference takes 0.03-0.25 s per super-block)."""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.models import quantize_cli as jqcli
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.quant import iquants as jiq
from ggml_gfx906_tpu.quant import registry as ref
from ggml_gfx906_tpu.quant.types import TYPE_TRAITS, GGMLType
from ggml_gfx906_tpu_torch.models import llama, quantize_cli
from ggml_gfx906_tpu_torch.ops.cuda import build, iq_search
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.quant import iquants, kquants
from ggml_gfx906_tpu_torch.quant import registry as port

from _torch_port import one_torch_thread, tiny_iq_gguf  # noqa: F401

N = 256
SEARCHES = sorted(iq_search.ROUTES)
CASES = [(t, w) for t in SEARCHES for w in (False, True)
         if w or t not in iq_search.IMATRIX_REQUIRED]


def _edge_rows(seed: int) -> np.ndarray:
    """Gaussian rows of three scales, a row with a zero and a constant
    32-block (the iq1 sorts' ties), one outlier per 32-block, a negative
    maximum per block, -0.0 entries among +0.0 ones, and a zero row."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((3, N)).astype(np.float32) * np.float32([[1.0], [1e-3], [30.0]])
    mixed = g[:1].copy()
    mixed[:, :32] = 0
    mixed[:, 64:96] = np.float32(rng.uniform(-1, 1))
    outlier = (0.01 * rng.standard_normal((1, N))).astype(np.float32)
    outlier[:, rng.integers(0, 32) + 32 * np.arange(N // 32)] = 5.0
    negmax = g[:1].copy()
    negmax[:, 5::32] = -9.0
    zeros = g[1:2].copy()
    zeros[:, ::5] = 0.0
    zeros[:, ::7] = -0.0
    return np.concatenate([g, mixed, outlier, negmax, zeros, np.zeros((1, N), np.float32)])


def _importance(seed: int) -> np.ndarray:
    qw = np.random.default_rng(seed).uniform(0.05, 3.0, N).astype(np.float32)
    qw[::11] = 0
    return qw


def _ref_bytes(t, x, qw):
    """The reference's bytes. Its IQ3 searches index the importance row by
    super-block without wrapping (iquants.py:378, :508), so they take it
    for one row at a time; the port wraps it, as its other searches do."""
    parts = [x[i:i + 1] for i in range(len(x))] \
        if qw is not None and t in (GGMLType.IQ3_XXS, GGMLType.IQ3_S) else [x]
    return np.concatenate([np.ascontiguousarray(ref.quantize(t, p, qw)).view(np.uint8)
                           .reshape(len(p), -1) for p in parts])


@pytest.mark.parametrize("qtype,weighted", CASES,
                         ids=[f"{t.name}-{'imatrix' if w else 'plain'}" for t, w in CASES])
def test_search_bytes_equal_reference(qtype, weighted):
    x = _edge_rows(int(qtype))
    qw = _importance(int(qtype) + 1) if weighted else None
    got = port.quantize(qtype, torch.from_numpy(x), None if qw is None else torch.from_numpy(qw))
    assert got.shape == (len(x), TYPE_TRAITS[qtype].type_size)
    np.testing.assert_array_equal(got.numpy(), _ref_bytes(qtype, x, qw))


def test_make_qp_quants_is_the_reference_search_copy():
    """IQ2_XXS starts from the port's row-vectorised make_qp_quants
    (quant/kquants.py), whose bits equal iquants._make_qp_quants's, the
    copy the reference's iq2_xxs calls, on sign-folded rows (one negative
    entry, zero weights, constant rows)."""
    rng = np.random.default_rng(5)
    x = np.abs(rng.standard_normal((300, 32))).astype(np.float32)
    x[::3, 7] *= -1
    x[1::7] = np.float32(0.25)
    w = rng.uniform(0, 2, (300, 32)).astype(np.float32)
    w[::4, :5] = 0
    scale, L = kquants.make_qp_quants(torch.from_numpy(x), torch.from_numpy(w), 4)
    for i in range(len(x)):
        s_ref, l_ref = jiq._make_qp_quants(4, x[i], w[i])
        assert np.float32(scale[i]).view(np.uint32) == np.float32(s_ref).view(np.uint32), i
        np.testing.assert_array_equal(L[i].numpy().astype(np.int8),
                                      l_ref.astype(np.uint8).astype(np.int8))


@pytest.mark.parametrize("kind", ["iq3_256", "iq3_512", "iq2_xxs"])
def test_machinery_builder_reproduces_the_shipped_tables(kind):
    """The torch port of iq2xs_init_impl / iq3xs_init_impl gives the
    reference's files (the port ships copies of them); the smoke rebuilds
    all six on the card."""
    built = iquants.build_machinery(kind, "cpu")
    z = np.load(f"ggml_gfx906_tpu/quant/data/machinery_{kind}.npz")
    for f in ("grid", "kmap", "neigh"):
        np.testing.assert_array_equal(getattr(built, f).numpy(), z[f].astype(np.int64))
        np.testing.assert_array_equal(getattr(iquants.machinery(kind, "cpu"), f).numpy(),
                                      z[f].astype(np.int64))


@pytest.mark.parametrize("qtype", [GGMLType.IQ2_XXS, GGMLType.IQ1_M], ids=lambda t: t.name)
def test_quant_tensor_quantize_lands_in_the_int8_layout(qtype):
    """QuantTensor.quantize of a search type: the int8 layout, with the
    reference's w8t and dwt (its QuantTensor from the same blocks; IQ2_XXS
    with the importance row, which the reference's QuantTensor.quantize
    does not take)."""
    rng = np.random.default_rng(int(qtype))
    x = (rng.standard_normal((4, 512)) * 0.05).astype(np.float32)
    qw = np.tile(_importance(3), 2) if qtype == GGMLType.IQ2_XXS else None
    got = QuantTensor.quantize(qtype, x, "cpu", quant_weights=qw)
    want = jqz.QuantTensor.from_blocks(qtype, ref.quantize(qtype, x, qw), x.shape) \
        if qw is not None else jqz.QuantTensor.quantize(qtype, x)
    assert got.layout == want.layout == "int8"
    for f in ("w8t", "dwt"):
        np.testing.assert_array_equal(got.fields[f].numpy(), np.asarray(want.fields[f]))


def test_registry_tables_and_refusals():
    """supported_quant_types and the imatrix table are the reference's;
    the three types that need an importance row raise NotImplementedError
    without one (the reference's table lookup raises KeyError), and the
    wrapper raises ValueError."""
    assert port.supported_quant_types() == ref.supported_quant_types()
    assert set(port._QUANTIZE_IMATRIX) == set(ref._QUANTIZE_IMATRIX)
    x = torch.zeros(1, N)
    for t in sorted(iq_search.IMATRIX_REQUIRED):
        with pytest.raises(NotImplementedError, match="has no quantizer"):
            port.quantize(t, x)
        with pytest.raises(KeyError):
            ref.quantize(t, np.zeros((1, N), np.float32))
        with pytest.raises(ValueError, match="needs an importance row"):
            iq_search.quantize(t, x)
    with pytest.raises(ValueError, match="multiple of 256"):
        iq_search.quantize(GGMLType.IQ3_S, torch.zeros(1, 128))


@pytest.fixture(scope="module")
def tiny_f32(tmp_path_factory):
    path = tmp_path_factory.mktemp("iq") / "f32.gguf"
    return path, tiny_iq_gguf(path)


def test_iq2_xxs_file_is_byte_identical_and_decodes_the_reference_stream(tmp_path, tiny_f32):
    """quantize_cli.quantize_gguf to IQ2_XXS with the imatrix of a tiny
    file whose ffn_down alone is quantized (_torch_port.tiny_iq_gguf) ==
    the reference's file; both packages load it (ffn_down in the int8 layout,
    the port's w8t == the reference's) and greedy-decode the same stream."""
    src, im = tiny_f32
    want = jqcli.quantize_gguf(src, tmp_path / "ref.gguf", GGMLType.IQ2_XXS, verbose=False,
                               imatrix=im)
    got = quantize_cli.quantize_gguf(src, tmp_path / "port.gguf", GGMLType.IQ2_XXS,
                                     verbose=False, imatrix=im, device="cpu")
    assert got == want
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()
    jcfg, jp = jllama.load(tmp_path / "ref.gguf")
    tcfg, tp = llama.load(tmp_path / "port.gguf", device="cpu")
    down = tp["blocks"][0]["w_down"]
    assert (down.qtype, down.layout) == (GGMLType.IQ2_XXS, "int8")
    np.testing.assert_array_equal(down.fields["w8t"].numpy(),
                                  np.asarray(jp["blocks"][0]["w_down"].fields["w8t"]))
    prompt = [int(t) for t in np.random.default_rng(23).integers(1, 64, 12)]
    stream = jllama.generate(jcfg, jp, jnp.asarray(prompt), 8, max_seq=64)
    assert llama.generate(tcfg, tp, prompt, 8, max_seq=64, device="cpu") == \
        [int(t) for t in stream]


def test_kernel_source_gives_the_plain_bytes_emulated(tmp_path):
    """csrc/iq_search.cu up to its launchers, compiled with g++ (no FMA
    contraction, as --fmad=false) and run block by block, thread by thread
    (scripts/torch_iq_emu.py): every type's bytes equal the plain
    version's, with and without an importance row."""
    import importlib.util

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to emulate the kernels")
    spec = importlib.util.spec_from_file_location("torch_iq_emu", "scripts/torch_iq_emu.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    so = emu.build_emu(tmp_path)
    x = torch.from_numpy(_edge_rows(7))
    qw = torch.from_numpy(_importance(8))
    for t, weighted in CASES:
        w = qw if weighted else None
        assert torch.equal(emu.emu_quantize(so, t, x, w), iq_search.quantize_plain(t, x, w)), \
            (t.name, weighted)
    assert build.flags("iq_search")[-1] == "--fmad=false"
