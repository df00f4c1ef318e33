"""Port parity: the quantize tools (ggml_gfx906_tpu/models/convert.py,
quantize_cli.py, imatrix.py), llama.random_params, the GGUF reader's and
writer's codec paths, and a file of a type without kernels end to end.
Files are held byte for byte against the reference's on the same inputs
(made from a seed with numpy); the imatrix within a relative 1e-5 (its
column sums reduce in another order than XLA's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.gguf import GGUFReader as JReader
from ggml_gfx906_tpu.gguf import GGUFWriter as JWriter
from ggml_gfx906_tpu.models import convert as jconvert
from ggml_gfx906_tpu.models import imatrix as jimatrix
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.models import quantize_cli as jqcli
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.gguf import GGUFReader, GGUFWriter
from ggml_gfx906_tpu_torch.models import convert, imatrix, llama, quantize_cli
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor

from _torch_port import (HF_D, HF_FF, HF_L, HF_V, hf_gpt_state,  # noqa: F401
                         hf_llama_state, jax_params_to_numpy, nmse, one_torch_thread,
                         port_cfg, recipe_logits, tiny_cfg, tiny_iq_gguf)

D, FF, V, L = HF_D, HF_FF, HF_V, HF_L
_llama_state, _gpt_state = hf_llama_state, hf_gpt_state


CONVERTS = [("llama", GGMLType.F16), ("llama", GGMLType.Q4_K), ("gptj", GGMLType.F32),
            ("gptj", GGMLType.Q8_0), ("gpt2", GGMLType.F16), ("gpt2", GGMLType.Q5_0),
            ("mixtral", GGMLType.Q4_K), ("mixtral", GGMLType.F16)]


@pytest.mark.parametrize("arch,ftype", CONVERTS, ids=lambda v: getattr(v, "name", v))
def test_convert_is_byte_identical(tmp_path, arch, ftype):
    extra = {}
    if arch == "llama":
        sd, cfg = _llama_state()
        extra = dict(tokens=[f"t{i}" for i in range(V)], scores=[-0.5 * i for i in range(V)],
                     token_types=[1] * V)
    elif arch == "mixtral":
        sd, cfg = _llama_state(head=False, experts=2)
    else:
        sd, cfg = _gpt_state(arch)
        if arch == "gpt2":
            extra = dict(tokens=[f"t{i}" for i in range(V)], merges=["t t", "t0 t1"])
    fn = f"convert_{arch}"
    getattr(jconvert, fn)(sd, cfg, tmp_path / "ref.gguf", ftype=ftype, **extra)
    getattr(convert, fn)(sd, cfg, tmp_path / "port.gguf", ftype=ftype, device="cpu", **extra)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()


@pytest.fixture(scope="module")
def f32_file(tmp_path_factory):
    """A tiny F32 llama GGUF (with a head, ne[0] of 256 and 512) and an
    imatrix for it: positive importance rows under the GGUF names, as
    collect_llama makes them (test_collect_llama_matches_reference holds
    that function)."""
    path = tmp_path_factory.mktemp("q") / "f32.gguf"
    sd, cfg = _llama_state(seed=3)
    jconvert.convert_llama(sd, cfg, path)
    rng = np.random.default_rng(4)
    r = JReader(path)
    im = {name: rng.uniform(0.01, 2.0, ti.ne[0]).astype(np.float32)
          for name, ti in r.tensors.items() if len(ti.ne) == 2}
    return path, im


@pytest.mark.parametrize("ftype,with_im", [(GGMLType.Q4_K, False), (GGMLType.Q4_K, True),
                                           (GGMLType.Q8_0, False), (GGMLType.IQ4_XS, False),
                                           (GGMLType.Q6_K, True)],
                         ids=["q4_K", "q4_K-imatrix", "q8_0", "iq4_xs", "q6_K-imatrix"])
def test_quantize_gguf_is_byte_identical(tmp_path, f32_file, ftype, with_im):
    src, im = f32_file
    im = im if with_im else None
    want = jqcli.quantize_gguf(src, tmp_path / "ref.gguf", ftype, verbose=False, imatrix=im)
    got = quantize_cli.quantize_gguf(src, tmp_path / "port.gguf", ftype, verbose=False,
                                     imatrix=im, device="cpu")
    assert got == want
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()


def test_quantize_refusals(tmp_path, f32_file, capsys):
    """A type that needs an imatrix without one: ValueError in both
    packages, and the CLI exits 1 and writes no file. The grid searches,
    once refused, run: `iq2_xxs --imatrix` and `iq3_xxs` through the
    function and main write the reference's files (on a tiny file whose
    ffn_down alone is quantized, _torch_port.tiny_iq_gguf)."""
    src, im = f32_file
    dst = tmp_path / "out.gguf"
    for mod, kw in ((jqcli, {}), (quantize_cli, {"device": "cpu"})):
        with pytest.raises(ValueError, match="requires an imatrix"):
            mod.quantize_gguf(src, dst, GGMLType.IQ2_XXS, verbose=False, **kw)
    assert quantize_cli.main([str(src), str(dst), "iq2_xxs", "-q", "--device", "cpu"]) == 1
    assert "requires an imatrix" in capsys.readouterr().err and not dst.exists()
    tiny = tmp_path / "tiny.gguf"
    tim = tiny_iq_gguf(tiny)
    imf = tmp_path / "im.npz"
    imatrix.save(tim, imf)
    for qtype, imx, argv in ((GGMLType.IQ2_XXS, tim, ["--imatrix", str(imf)]),
                             (GGMLType.IQ3_XXS, None, [])):
        want = jqcli.quantize_gguf(tiny, tmp_path / "ref.gguf", qtype, verbose=False,
                                   imatrix=imx)
        assert quantize_cli.quantize_gguf(tiny, dst, qtype, verbose=False, imatrix=imx,
                                          device="cpu") == want
        assert dst.read_bytes() == (tmp_path / "ref.gguf").read_bytes()
        dst.unlink()
        assert quantize_cli.main([str(tiny), str(dst), qtype.name.lower(), *argv, "-q",
                                  "--device", "cpu"]) == 0
        assert dst.read_bytes() == (tmp_path / "ref.gguf").read_bytes()
        dst.unlink()


def test_quantize_cli_main_matches_reference(tmp_path, f32_file):
    src, im = f32_file
    imf = tmp_path / "im.npz"
    imatrix.save(im, imf)
    assert jimatrix.load(str(imf)).keys() == im.keys()
    argv = ["q5_K", "--imatrix", str(imf), "-q"]
    assert jqcli.main([str(src), str(tmp_path / "ref.gguf"), *argv]) == 0
    assert quantize_cli.main([str(src), str(tmp_path / "port.gguf"), *argv,
                              "--device", "cpu"]) == 0
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()


def test_collect_llama_matches_reference():
    """The imatrix of a tiny 2-layer model over two chunks, within a
    relative 1e-5 of the reference's: both accumulate Σx² in f32, in
    different orders."""
    jcfg = tiny_cfg()
    jp = jllama.random_params(jcfg, seed=6)
    tp = llama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    rng = np.random.default_rng(7)
    chunks = [rng.integers(1, V, 32), rng.integers(1, V, 32)]
    want = jimatrix.collect_llama(jcfg, jp, chunks)
    got = imatrix.collect_llama(port_cfg(jcfg), tp, chunks, device="cpu")
    assert got.keys() == want.keys() and len(got) == 7 * jcfg.n_layer + 2
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.IQ4_XS, None],
                         ids=["q4_K", "iq4_xs", "dense"])
def test_random_params_match_reference(qtype):
    """Equal seeds give the reference's weights: its blocks (Q4_K, in the
    kernel layout; IQ4_XS, in the int8 layout), or its dense matrices."""
    jcfg = tiny_cfg()
    jp = jllama.random_params(jcfg, seed=9, qtype=qtype)
    tp = llama.random_params(port_cfg(jcfg), seed=9, qtype=qtype, device="cpu")
    want = llama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")

    def leaves(p):
        return [p["wte"], p["out_norm"]] + [b[k] for b in p["blocks"] for k in sorted(b)]

    for g, w in zip(leaves(tp), leaves(want), strict=True):
        if isinstance(w, QuantTensor):
            assert (g.qtype, g.layout, g.shape) == (w.qtype, w.layout, w.shape)
            assert g.fields.keys() == w.fields.keys()
            for f in w.fields:
                assert torch.equal(g.fields[f], w.fields[f]), f
        else:
            assert torch.equal(g, w)


def test_reader_and_writer_codecs_match_reference(tmp_path):
    """GGUFWriter.add_array_tensor quantizes (numpy on the CPU, a tensor on
    its device) and GGUFReader.tensor_float dequantizes as the reference's
    do."""
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((8, 512)) * 0.1).astype(np.float32)
    qtypes = (GGMLType.Q4_K, GGMLType.Q5_1, GGMLType.IQ4_NL, GGMLType.TQ1_0, GGMLType.MXFP4)
    for path, W, conv in ((tmp_path / "ref.gguf", JWriter, np.asarray),
                          (tmp_path / "port.gguf", GGUFWriter, torch.from_numpy)):
        w = W()
        for i, t in enumerate(qtypes):
            w.add_array_tensor(f"t{i}", conv(a) if i % 2 else a, t)
        w.write(path)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()
    jr, tr = JReader(tmp_path / "ref.gguf"), GGUFReader(tmp_path / "ref.gguf")
    for i in range(len(qtypes)):
        np.testing.assert_array_equal(tr.tensor_float(f"t{i}").view(np.uint32),
                                      jr.tensor_float(f"t{i}").view(np.uint32))


@pytest.mark.parametrize("head", [True, False], ids=["head", "tied"])
def test_iq4_xs_file_decodes_the_reference_stream(tmp_path, head):
    """A tiny IQ4_XS llama GGUF (the reference's converter and registry,
    token_embd included, with its own head or tied) loads into the int8
    layout with the reference's w8t, gives the reference's prefill logits
    within the int8 layout tests' bound (tests/test_torch_int8_layout.py)
    and greedy-decodes the reference's stream."""
    sd, cfg = _llama_state(seed=12, head=head)
    path = tmp_path / "iq4_xs.gguf"
    jconvert.convert_llama(sd, cfg, path, ftype=GGMLType.IQ4_XS)
    jcfg, jp = jllama.load(path)
    tcfg, tp = llama.load(path, device="cpu")
    keys = [("wte",), ("blocks", 1, "w_down")] + ([("lm_head",)] if head else [])
    assert ("lm_head" in tp) == head
    for key in keys:
        got, want = tp, jp
        for k in key:
            got, want = got[k], want[k]
        assert (got.qtype, got.layout) == (GGMLType.IQ4_XS, "int8")
        np.testing.assert_array_equal(got.fields["w8t"].numpy(), np.asarray(want.fields["w8t"]))
    toks = np.random.default_rng(13).integers(1, V, 20).astype(np.int32)
    got, want = recipe_logits(jcfg, jp, tcfg, tp, toks)
    assert nmse(got, want) < 1e-9
    prompt = [int(t) for t in toks[:12]]
    ref = jllama.generate(jcfg, jp, jnp.asarray(prompt), 8, max_seq=64)
    assert llama.generate(tcfg, tp, prompt, 8, max_seq=64, device="cpu") == [int(t) for t in ref]
