"""Port parity: Q5_K dequantization and the Q5_K matmul kernel K7, against
the JAX package (its numpy oracle, its dequant, and its Pallas kernel in
interpret mode on the CPU). On the CPU the port runs K7's plain PyTorch
version; the CUDA kernel is held against the same plain version on the card
by chip_smoke.py. K = 256 and 768 are one and three superblocks: the
reference pads its superblock axis to a multiple of four there, the port
does not."""
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
from ggml_gfx906_tpu_torch.ops.cuda import qmm_q5k
from ggml_gfx906_tpu_torch.quant import dequant_math as tdm

from _torch_port import nmse

RNG = np.random.default_rng(5)
Q5 = GGMLType.Q5_K


def _weights(n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(Q5, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        Q5, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()}, "cpu")
    return w, jq, tq


@pytest.mark.parametrize("n,k", [(64, 256), (48, 768), (32, 1024)])
def test_dequant_bit_identical(n, k):
    """From wire blocks and from the JAX kernel layout (whose superblock
    axis is padded to a multiple of four at K = 256 and 768), bit-identical
    to the numpy oracle and to jqz.dequant, with the same fields either
    way: from_reference_kernel_layout drops the pad."""
    w, jq, tq = _weights(n, k, seed=k)
    nb = k // 256
    assert jq.fields["ql"].shape[1] == -(-nb // 4) * 4 * 128
    b = quantize(Q5, w)
    oracle = jdm.dequant_q5_K(np, b["d"], b["dmin"], b["scales"], b["qh"],
                              b["qs"]).reshape(n, k)
    assert np.array_equal(np.asarray(jqz.dequant(jq)), oracle)
    assert np.array_equal(tqz.dequant(tq).numpy(), oracle)
    tw = tqz.QuantTensor.from_blocks(Q5, b, "cpu")
    assert np.array_equal(tqz.dequant(tw).numpy(), oracle)
    want = {"qs": nb * 128, "qh": nb * 32, "scm": nb * 16, "dd": nb * 2}
    for f, width in want.items():
        assert tuple(tq.fields[f].shape) == (n, width), f
        assert torch.equal(tq.fields[f], tw.fields[f]), f
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = tdm.dequant_q5_K(t(b["d"]), t(b["dmin"]), t(b["scales"]), t(b["qh"]),
                           t(b["qs"]))
    assert np.array_equal(got.reshape(n, k).numpy(), oracle)


# the bound is tests/test_ops.py::test_qmatmul's (f32-expand kernels)
@pytest.mark.parametrize("m", [1, 8, 63, 128])
@pytest.mark.parametrize("k", [256, 768, 1024])
def test_k7_matches_reference(m, k):
    n = 64
    _, jq, tq = _weights(n, k, seed=k + m)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    f = jq.fields
    ref = np.asarray(jqmm.qmm_q5_K(jnp.asarray(x), f["ql"], f["qh"], f["scm"],
                                   f["d"], f["dmin"]))
    g = tq.fields
    got = qmm_q5k.qmm_q5_K(torch.from_numpy(x), g["qs"], g["qh"], g["scm"], g["dd"])
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert nmse(got.numpy(), ref) < 1e-10


def test_q5k_never_takes_the_int8_route():
    """Q5_K has no int8 twin (it is not in INT8_TYPES of either package): at
    M >= int8_min_m it stays on K7, as ops/pallas/dispatch.py routes it."""
    min_m = jconfig.get("int8_min_m")
    _, jq, tq = _weights(64, 512, seed=2)
    for m in (1, min_m, 2 * min_m):
        assert tdispatch.route(m, Q5) == "f32"
        x = RNG.standard_normal((m, 512)).astype(np.float32)
        got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
        assert nmse(got, np.asarray(jqz.qmatmul(jnp.asarray(x), jq))) < 1e-10
