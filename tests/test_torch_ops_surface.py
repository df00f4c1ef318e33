"""Port parity: the op surface (ops/basic.py name for name, ALiBi in
attention_ref and flash_attn_ext, mul_mat_id) against the JAX package's,
on seeded numpy inputs.

Bounds, per op: the index and sign ops exactly; the elementwise ops, the
norms and the softmaxes at nmse < 1e-12 (the bound of
tests/test_torch_ops.py); the sums whose output is a handful of values
(sum_, sum_rows, mean, cross_entropy_loss) at nmse < 1e-10, since row_sum
adds pairwise where XLA adds in its own order and one sum of a few
hundred f32 values differs by ~1e-6 relative. ALiBi attention at 1e-12;
mul_mat_id at 1e-12 dense and, with Q4_K experts, at 1e-9 on the f32
route (tests/test_torch_llama.py's bound) and 2e-4 on the int8 route (its
error class, tests/test_torch_qmm.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu import ops as jops
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch import ops as tops
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor

from _torch_port import nmse


def _x(seed, *shape, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _ids(seed, n, hi):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.int64)


X = _x(1, 3, 4, 16)              # (..., n_head, rows, cols) for the softmaxes
M = np.triu(np.full((4, 16), -np.inf, np.float32), 13)   # an additive mask
T = np.arange(7, dtype=np.float32) * 3.5

# name → (args as numpy, keyword arguments). Each call gets jnp arrays on
# the reference side and torch tensors on the port's.
CASES = {
    "abs_": ((X,), {}), "sgn": ((X,), {}), "neg": ((X,), {}), "step": ((X,), {}),
    "tanh": ((X,), {}), "elu": ((X,), {}), "relu": ((X,), {}), "sigmoid": ((X,), {}),
    "gelu": ((X,), {}), "gelu_quick": ((X,), {}), "silu": ((X,), {}),
    "hardswish": ((X,), {}), "hardsigmoid": ((X,), {}), "exp": ((X,), {}),
    "gelu_erf": ((X,), {}), "leaky_relu": ((X,), {"negative_slope": 0.2}),
    "reglu": ((X,), {}), "geglu": ((X,), {}), "swiglu": ((X,), {}),
    "geglu_erf": ((X,), {}), "geglu_quick": ((X, _x(2, 3, 4, 16)), {"swapped": True}),
    "swiglu_oai": ((_x(3, 5, 32, scale=5.0),), {}),
    "norm": ((_x(4, 6, 300),), {"eps": 1e-5}),
    "rms_norm": ((_x(5, 6, 300),), {"eps": 1e-6}),
    "group_norm": ((_x(6, 2, 8, 5, 5),), {"n_groups": 4}),
    "l2_norm": ((_x(7, 6, 100),), {}),
    "soft_max_ext": ((X, M), {"scale": 0.7, "max_bias": 8.0, "sinks": _x(8, 3)}),
    "soft_max": ((X,), {}),
    "diag_mask_inf": ((_x(9, 2, 5, 7),), {"n_past": 2}),
    "causal_mask": ((5, 9), {"n_past": 3}),
    "get_rows": ((_x(10, 12, 8), _ids(11, 5, 12)), {}),
    "set_rows": ((_x(12, 12, 8), _x(13, 3, 8), np.array([7, 0, 11])), {}),
    "argsort": ((np.round(_x(14, 4, 9)),), {"descending": True}),
    "argmax": ((_x(15, 4, 33),), {}),
    "count_equal": ((np.array([1, 2, 3, 4]), np.array([1, 0, 3, 4])), {}),
    "concat": ((_x(16, 2, 3), _x(17, 2, 5)), {"axis": -1}),
    "repeat": ((_x(18, 2, 3),), {"target_shape": (4, 9)}),
    "pad": ((_x(19, 2, 3),), {"paddings": [(1, 0), (2, 3)]}),
    "pad_reflect_1d": ((_x(20, 2, 6),), {"p0": 2, "p1": 3}),
    "roll": ((_x(21, 4, 5),), {"shifts": 2, "axes": 1}),
    "arange": ((0.5, 7.0, 0.75), {}),
    "timestep_embedding": ((T,), {"dim": 9}),
    "scale": ((X,), {"s": 0.3, "bias": -1.5}),
    "clamp": ((X,), {"lo": -1.0, "hi": 0.5}),
    "add1": ((X, np.float32(2.5).reshape(1)), {}),
    "acc": ((_x(22, 4, 6), _x(23, 5)), {"offset_elems": 7}),
    "out_prod": ((_x(24, 2, 6, 4), _x(25, 4, 6, 3)), {}),
    "sum_": ((_x(26, 7, 33),), {}),
    "sum_rows": ((_x(27, 7, 33),), {}),
    "mean": ((_x(28, 7, 33),), {}),
    "cross_entropy_loss": ((_x(29, 6, 10), np.abs(_x(30, 6, 10)) / 10), {}),
    "embedding": ((_x(31, 12, 8), _ids(32, 4, 12)), {}),
    "softcap": ((X * 20,), {"s": 30.0}),
}
# the sums with few outputs, at nmse < 1e-10 (module docstring)
FEW_SUMS = {"sum_", "sum_rows", "mean", "cross_entropy_loss"}
# the index ops, held exactly
EXACT = {"argsort", "argmax", "count_equal", "get_rows", "set_rows", "embedding",
         "concat", "repeat", "pad", "pad_reflect_1d", "roll", "causal_mask",
         "diag_mask_inf", "abs_", "sgn", "neg", "step", "relu", "clamp"}


def _jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _torch(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def test_every_name_is_covered():
    """The port exports the reference's basic ops name for name (and UNARY),
    and each one is held below."""
    import ggml_gfx906_tpu.ops.basic as jbasic

    names = {n for n in dir(jbasic) if not n.startswith("_") and callable(getattr(jbasic, n))
             and getattr(getattr(jbasic, n), "__module__", "") == jbasic.__name__}
    assert names == set(CASES) | {"alibi_slopes", "top_k"}
    for n in names | {"UNARY"}:
        assert hasattr(tops, n), n
    assert set(tops.UNARY) == set(jops.UNARY)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_reference(name):
    args, kw = CASES[name]
    ref = getattr(jops, name)(*map(_jax, args), **{k: _jax(v) for k, v in kw.items()})
    got = getattr(tops, name)(*map(_torch, args), **{k: _torch(v) for k, v in kw.items()})
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, ref)
    else:
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(fin, np.isfinite(got))
        assert nmse(got[fin], ref[fin]) < (1e-10 if name in FEW_SUMS else 1e-12)


@pytest.mark.parametrize("name", sorted(jops.UNARY))
def test_unary_table(name):
    x = _x(40, 3, 50)
    ref = np.asarray(jops.UNARY[name](jnp.asarray(x)))
    got = tops.UNARY[name](torch.from_numpy(x)).numpy()
    assert nmse(got, ref) < 1e-12


@pytest.mark.parametrize("n_head,max_bias", [(8, 8.0), (12, 8.0), (5, 2.5), (4, 0.0)])
def test_alibi_slopes(n_head, max_bias):
    ref = np.asarray(jops.alibi_slopes(n_head, max_bias))
    got = tops.alibi_slopes(n_head, max_bias).numpy()
    np.testing.assert_array_equal(got, ref)


def test_top_k_breaks_ties_lower_index_first():
    """Equal values come out lower index first, as jax.lax.top_k gives them
    (signed zeros aside: jax ranks +0 above -0, torch holds them equal;
    the router's probabilities are positive)."""
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.9], [1, 1, 1, 1, 1, 1]], np.float32)
    x = np.concatenate([x, np.round(_x(41, 30, 6)) + 0.0])
    for k in (1, 2, 3, 5):
        rv, ri = jops.top_k(jnp.asarray(x), k)
        gv, gi = tops.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("max_bias,hkv", [(0.0, 4), (8.0, 4), (8.0, 2)])
@pytest.mark.parametrize("entry", ["attention_ref", "flash_attn_ext"])
def test_alibi_attention(entry, max_bias, hkv):
    """ALiBi slopes scale the mask per head, with grouped K/V heads and
    sinks, against the reference's entry of the same name."""
    q, k, v = _x(50, 2, 4, 6, 32), _x(51, 2, hkv, 9, 32), _x(52, 2, hkv, 9, 32)
    rows, cols = np.arange(6)[:, None], np.arange(9)[None, :]
    mask = np.where(cols <= rows + 3, -np.abs(cols - rows - 3), -np.inf).astype(np.float32)
    sinks = _x(53, 4)
    kw = dict(scale=0.2, max_bias=max_bias, logit_softcap=20.0)
    ref = getattr(jops, entry)(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask),
                               sinks=jnp.asarray(sinks), **kw)
    got = getattr(tops, entry)(*map(torch.from_numpy, (q, k, v)),
                               mask=torch.from_numpy(mask), sinks=torch.from_numpy(sinks), **kw)
    assert nmse(got.numpy(), np.asarray(ref)) < 1e-12


# ---------------------------------------------------------------- mul_mat_id

def _routing(seed, T, U, E, drop: bool):
    ids = np.random.default_rng(seed).integers(0, E, (T, U))
    if drop:   # out-of-range ids: pre-dropped tokens
        ids[1, 0], ids[3, 1], ids[0, 1] = -1, E, E + 3
    return ids.astype(np.int32)


@pytest.mark.parametrize("capacity", [None, 3])
@pytest.mark.parametrize("drop", [False, True])
def test_mul_mat_id_dense(capacity, drop):
    """Dense (E, N, K) experts and the expert list alike, with and without
    capacity drops and out-of-range ids."""
    T, U, E, N, K = 9, 2, 4, 24, 40
    x, w = _x(60, T, U, K), _x(61, E, N, K, scale=0.1)
    ids = _routing(62, T, U, E, drop)
    ref = np.asarray(jops.mul_mat_id(jnp.asarray(w), jnp.asarray(x), jnp.asarray(ids),
                                     capacity=capacity))
    for experts in (torch.from_numpy(w), [torch.from_numpy(a) for a in w]):
        got = tops.mul_mat_id(experts, torch.from_numpy(x), torch.from_numpy(ids),
                              capacity=capacity).numpy()
        assert got.shape == (T, U, N)
        assert nmse(got, ref) < 1e-12
        np.testing.assert_array_equal(got == 0, ref == 0)     # the same rows dropped


@pytest.mark.parametrize("T,capacity", [(5, None), (40, None), (40, 12)])
def test_mul_mat_id_q4k_experts(T, capacity):
    """Q4_K experts carried from the reference's kernel layout: C = T·U = 10
    takes the f32 route (K1's plain version), C = 80 >= int8_min_m the int8
    route (K3's), on both sides; drops and out-of-range ids too."""
    U, E, N, K = 2, 3, 256, 512
    x = _x(70, T, U, K, scale=1.0)
    ids = _routing(71, T, U, E, drop=True)
    jexp = [JQuantTensor.quantize(GGMLType.Q4_K, _x(72 + e, N, K, scale=0.02))
            for e in range(E)]
    texp = [QuantTensor.from_reference_kernel_layout(
        GGMLType.Q4_K, j.shape, {f: np.asarray(a) for f, a in j.fields.items()}, "cpu")
        for j in jexp]
    ref = np.asarray(jops.mul_mat_id(jexp, jnp.asarray(x), jnp.asarray(ids), capacity=capacity))
    got = tops.mul_mat_id(texp, torch.from_numpy(x), torch.from_numpy(ids),
                          capacity=capacity).numpy()
    assert nmse(got, ref) < (1e-9 if T * U < 64 else 2e-4)
    np.testing.assert_array_equal(got == 0, ref == 0)


def test_mul_mat_id_static_shapes():
    """The dispatch uses no nonzero and no boolean indexing (the engine's
    graphs capture it): its outputs' shapes do not depend on the routing."""
    T, U, E, K = 6, 2, 4, 16
    x, w = torch.randn(T, U, K), torch.randn(E, 8, K)
    for ids in (torch.zeros(T, U, dtype=torch.int32), torch.full((T, U), -1),
                torch.randint(0, E, (T, U))):
        assert tops.mul_mat_id(w, x, ids).shape == (T, U, 8)


def test_op_surface_is_the_references_name_for_name():
    """ggml_gfx906_tpu_torch.ops exports every public name of the JAX
    package's ops/__init__.py (the conv, pooling, window, SSM, rope_multi
    and recurrent names among them) and one more: embed_rows."""
    import types

    def names(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert names(tops) - names(jops) == {"embed_rows"}
    assert names(jops) - names(tops) == set()
