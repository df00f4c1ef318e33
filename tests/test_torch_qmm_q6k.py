"""Port parity: Q6_K dequantization and the Q6_K matmul kernel K4, against
the JAX package (its numpy oracle, its dequant, and its Pallas kernel in
interpret mode on the CPU). On the CPU the port runs K4's plain PyTorch
version; the CUDA kernel is held against the same plain version on the card
by chip_smoke.py. K = 768 is three superblocks: the reference pads its
superblock axis to even there, the port does not."""
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
from ggml_gfx906_tpu_torch.ops.cuda import qmm_q6k
from ggml_gfx906_tpu_torch.quant import dequant_math as tdm

from _torch_port import nmse

RNG = np.random.default_rng(6)
Q6 = GGMLType.Q6_K


def _weights(n, k, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    jq = jqz.QuantTensor.quantize(Q6, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        Q6, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()}, "cpu")
    return w, jq, tq


@pytest.mark.parametrize("n,k", [(64, 256), (48, 768), (32, 1024)])
def test_dequant_bit_identical(n, k):
    """From wire blocks and from the JAX kernel layout (whose superblock
    axis is padded to even at K = 768), bit-identical to the numpy oracle
    and to jqz.dequant, with the same fields either way."""
    w, jq, tq = _weights(n, k, seed=k)
    b = quantize(Q6, w)
    oracle = jdm.dequant_q6_K(np, b["d"], b["ql"], b["qh"], b["scales"]).reshape(n, k)
    assert np.array_equal(np.asarray(jqz.dequant(jq)), oracle)
    assert np.array_equal(tqz.dequant(tq).numpy(), oracle)
    tw = tqz.QuantTensor.from_blocks(Q6, b, "cpu")
    assert np.array_equal(tqz.dequant(tw).numpy(), oracle)
    for f in ("ql", "qh", "sc", "d"):
        assert torch.equal(tq.fields[f], tw.fields[f]), f
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = tdm.dequant_q6_K(t(b["d"]), t(b["ql"]), t(b["qh"]), t(b["scales"]))
    assert np.array_equal(got.reshape(n, k).numpy(), oracle)


# the bound is tests/test_ops.py::test_qmatmul's (f32-expand kernels)
@pytest.mark.parametrize("m", [1, 8, 63, 128])
@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("n", [64, 128])
def test_k4_matches_reference(m, k, n):
    _, jq, tq = _weights(n, k, seed=k + n)
    x = RNG.standard_normal((m, k)).astype(np.float32)
    f = jq.fields
    ref = np.asarray(jqmm.qmm_q6_K(jnp.asarray(x), f["ql"], f["qh"], f["sc"], f["dq"]))
    g = tq.fields
    got = qmm_q6k.qmm_q6_K(torch.from_numpy(x), g["ql"], g["qh"], g["sc"], g["d"])
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert nmse(got.numpy(), ref) < 1e-10


def test_q6k_never_takes_the_int8_route():
    """Q6_K has no int8 twin (it is not in INT8_TYPES of either package): at
    M >= int8_min_m it stays on K4, as ops/pallas/dispatch.py routes it."""
    min_m = jconfig.get("int8_min_m")
    _, jq, tq = _weights(64, 512, seed=2)
    for m in (1, min_m, 2 * min_m):
        assert tdispatch.route(m, Q6) == "f32"
        x = RNG.standard_normal((m, 512)).astype(np.float32)
        got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
        assert nmse(got, np.asarray(jqz.qmatmul(jnp.asarray(x), jq))) < 1e-10
