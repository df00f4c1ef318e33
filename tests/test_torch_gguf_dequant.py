"""Port parity: GGUF reading/writing and Q4_K dequantization.

A GGUF written by the JAX package's writer is read by the port, and the
port's Q4_K dequantization must be bit-identical (np.array_equal) to
ggml_gfx906_tpu.ops.quantized.dequant — from wire blocks and from the
carried-across JAX kernel layout."""
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.gguf.format import GGUFReader as JReader, GGUFWriter as JWriter
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.quant import quantize
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.gguf import GGUFReader, GGUFWriter
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.quant import dequant_math as tdm
from ggml_gfx906_tpu_torch.quant.kquants import pack_scale_min_k4

RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def q4k_gguf(tmp_path_factory):
    w = (RNG.standard_normal((96, 768)) * 0.05).astype(np.float32)
    emb = RNG.standard_normal((8, 32)).astype(np.float32)
    path = tmp_path_factory.mktemp("gg") / "t.gguf"
    wr = JWriter()
    wr.set("general.architecture", "llama")
    wr.set("llama.block_count", 3)
    wr.set("test.float", 0.25)
    wr.set("test.list", [1, 2, 3])
    wr.set("test.strs", ["a", "bc"])
    wr.add_array_tensor("w", w, GGMLType.Q4_K)
    wr.add_array_tensor("emb", emb)
    wr.write(path)
    return path, w, emb


def test_reader_reads_reference_file(q4k_gguf):
    path, w, emb = q4k_gguf
    jr, tr = JReader(path), GGUFReader(path)
    assert tr.kv == jr.kv
    assert tr.kv_types == jr.kv_types
    assert set(tr.tensors) == set(jr.tensors)
    for name in tr.tensors:
        assert tr.tensors[name].shape == jr.tensors[name].shape
        assert tr.tensors[name].type == jr.tensors[name].type
        np.testing.assert_array_equal(tr.tensor_bytes(name), jr.tensor_bytes(name))
    np.testing.assert_array_equal(tr.tensor_float("emb"), emb)
    assert tr.tensor_blocks("w").shape == (96, 3)


def test_dequant_bit_identical_from_wire(q4k_gguf):
    path, _, _ = q4k_gguf
    jr, tr = JReader(path), GGUFReader(path)
    ref = np.asarray(jqz.dequant(jqz.QuantTensor.from_blocks(
        GGMLType.Q4_K, jr.tensor_blocks("w"), prefer_kernel=False)))
    qt = tqz.QuantTensor.from_blocks(GGMLType.Q4_K, tr.tensor_blocks("w"), "cpu")
    assert np.array_equal(tqz.dequant(qt).numpy(), ref)
    # the wire-field math itself, straight from the block struct
    b = tr.tensor_blocks("w")
    got = tdm.dequant_q4_K(torch.from_numpy(b["d"].copy()),
                           torch.from_numpy(b["dmin"].copy()),
                           torch.from_numpy(b["scales"].copy()),
                           torch.from_numpy(b["qs"].copy()))
    assert np.array_equal(got.reshape(96, 768).numpy(), ref)


@pytest.mark.parametrize("n,k", [(64, 256), (32, 1024)])
def test_dequant_bit_identical_from_kernel_layout(n, k):
    w = RNG.standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(GGMLType.Q4_K, w)
    assert jq.layout == "kernel"
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        GGMLType.Q4_K, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()},
        "cpu")
    assert np.array_equal(tqz.dequant(tq).numpy(), np.asarray(jqz.dequant(jq)))
    # and the kernel layout carries the same fields as the wire blocks
    tw = tqz.QuantTensor.from_blocks(GGMLType.Q4_K, quantize(GGMLType.Q4_K, w), "cpu")
    for f in ("qs", "scm", "dd"):
        assert torch.equal(tq.fields[f], tw.fields[f]), f


def test_pack_scale_min_roundtrip():
    sc = RNG.integers(0, 64, (50, 8)).astype(np.uint8)
    m = RNG.integers(0, 64, (50, 8)).astype(np.uint8)
    from ggml_gfx906_tpu.quant.kquants import pack_scale_min_k4 as jpack

    packed = pack_scale_min_k4(sc, m)
    np.testing.assert_array_equal(packed, jpack(sc, m))
    s2, m2 = tdm.unpack_scale_min_k4(torch.from_numpy(packed))
    np.testing.assert_array_equal(s2.numpy(), sc)
    np.testing.assert_array_equal(m2.numpy(), m)


def test_writer_read_by_reference(tmp_path):
    blocks = quantize(GGMLType.Q4_K, RNG.standard_normal((4, 512)).astype(np.float32))
    ones = np.ones(7, np.float32)
    wr = GGUFWriter()
    wr.set("general.architecture", "llama")
    wr.set("llama.context_length", 64)
    wr.add_tensor("q", (512, 4), GGMLType.Q4_K, blocks.view(np.uint8).reshape(-1))
    wr.add_array_tensor("n", ones)
    wr.write(tmp_path / "p.gguf")
    jr = JReader(tmp_path / "p.gguf")
    assert jr.kv["llama.context_length"] == 64
    np.testing.assert_array_equal(jr.tensor_blocks("q").view(np.uint8),
                                  blocks.view(np.uint8))
    np.testing.assert_array_equal(jr.tensor_float("n"), ones)
