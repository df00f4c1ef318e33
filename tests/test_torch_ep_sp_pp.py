"""Expert, sequence and pipeline parallelism (ggml_gfx906_tpu_torch/parallel/
ep.py, sp.py, pp.py) against the JAX package's on the reference tests'
models and bounds (tests/test_ep.py, test_sp.py, test_pp.py): the port's
ranks are gloo processes (tests/_torch_mesh.py, at most four, where the
reference's tests reach eight devices), the JAX side the conftest's
virtual CPU devices."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh as tm
from _torch_port import one_torch_thread  # noqa: F401
from _torch_port import cfg_fields, jax_params_to_numpy, nmse
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops.attention import attention_ref
from ggml_gfx906_tpu.ops.recurrent import mul_mat_id as jmul_mat_id
from ggml_gfx906_tpu.parallel.ep import ep_mul_mat_id as jep_mul_mat_id
from ggml_gfx906_tpu.parallel.ep import make_ep_mesh as jmake_ep_mesh
from ggml_gfx906_tpu.parallel.ep import shard_experts as jshard_experts
from ggml_gfx906_tpu.parallel.mesh import make_mesh as jmake_mesh
from ggml_gfx906_tpu.parallel.pp import make_pp_mesh as jmake_pp_mesh
from ggml_gfx906_tpu.parallel.pp import pp_forward as jpp_forward
from ggml_gfx906_tpu.parallel.pp import shard_pp as jshard_pp
from ggml_gfx906_tpu.parallel.pp import stack_blocks as jstack_blocks
from ggml_gfx906_tpu.parallel.sp import ring_self_attention as jring
from ggml_gfx906_tpu.parallel.sp import zigzag_perm as jzigzag_perm
from ggml_gfx906_tpu_torch.parallel.sp import zigzag_perm

PP_CFG = jllama.LlamaConfig(n_vocab=128, n_ctx=64, n_embd=64, n_head=4, n_kv_head=2,
                            n_layer=4, n_ff=128)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tm.start_pool(tmp_path_factory, 4)
    yield p
    p.close()


def _whole(results, n, key=None):
    """The mesh ranks' results (their `key` entry), all equal: every rank
    returns the whole."""
    assert all(r is None for r in results[n:])
    got = [r if key is None else r[key] for r in results[:n]]
    for r in got[1:]:
        np.testing.assert_array_equal(r, got[0])
    return got[0]


# ------------------------------------------------------------------------ ep

def _experts(rng, E, N, K, T, U):
    experts = (rng.standard_normal((E, N, K)) * 0.1).astype(np.float32)
    x = rng.standard_normal((T, U, K)).astype(np.float32)
    ids = rng.integers(0, E, (T, U)).astype(np.int32)
    return experts, x, ids


def _jax_ep(experts, x, ids, ep, dp, capacity=None):
    mesh = jmake_ep_mesh(ep=ep, dp=dp)
    fn = jax.jit(functools.partial(jep_mul_mat_id, mesh, capacity=capacity))
    return np.asarray(fn(jshard_experts(mesh, jnp.asarray(experts)), jnp.asarray(x),
                         jnp.asarray(ids)))


@pytest.mark.parametrize("ep,dp", [(2, 1), (4, 1), (2, 2)])
def test_ep_matches_jax(pool, ep, dp):
    rng = np.random.default_rng(ep + dp)
    experts, x, ids = _experts(rng, 2 * ep, 24, 16, 6 * dp, 2)
    got = _whole(pool.run(tm.ep_run, experts, x, ids, ep, dp), ep * dp)
    assert nmse(got, _jax_ep(experts, x, ids, ep, dp)) < 1e-12
    assert nmse(got, np.asarray(jmul_mat_id(jnp.asarray(experts), jnp.asarray(x),
                                            jnp.asarray(ids)))) < 1e-12


def test_ep_capacity_drops_match(pool):
    """A tight capacity drops the same tokens sharded and on one device
    (queues fill in arrival order on both)."""
    rng = np.random.default_rng(9)
    experts, x, _ = _experts(rng, 4, 8, 8, 16, 2)
    ids = rng.integers(0, 4, (16, 2)).astype(np.int32)
    got = _whole(pool.run(tm.ep_run, experts, x, ids, 4, 1, 3), 4)
    ref = np.asarray(jmul_mat_id(jnp.asarray(experts), jnp.asarray(x), jnp.asarray(ids),
                                 capacity=3))
    assert np.allclose(got, ref, atol=1e-6), np.abs(got - ref).max()
    assert nmse(got, _jax_ep(experts, x, ids, 4, 1, 3)) < 1e-12


def test_ep_capacity_is_per_dp_shard(pool):
    """dp > 1: each dp shard bounds its expert queues over its own T/dp
    tokens (the GShard local capacity), as in the JAX package."""
    rng = np.random.default_rng(21)
    experts, x, _ = _experts(rng, 4, 8, 8, 8, 2)
    ids = rng.integers(0, 4, (8, 2)).astype(np.int32)
    got = _whole(pool.run(tm.ep_run, experts, x, ids, 2, 2, 2), 4)
    half = 4
    ref = np.concatenate([np.asarray(jmul_mat_id(
        jnp.asarray(experts), jnp.asarray(x[s * half:(s + 1) * half]),
        jnp.asarray(ids[s * half:(s + 1) * half]), capacity=2)) for s in range(2)])
    assert nmse(got, ref) < 1e-12
    assert nmse(got, _jax_ep(experts, x, ids, 2, 2, 2)) < 1e-12


# ------------------------------------------------------------------------ sp

def _qkv(rng, B, H, KVH, S, D):
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, KVH, S, D)).astype(np.float32),
            rng.standard_normal((B, KVH, S, D)).astype(np.float32))


def _causal_ref(q, k, v, scale=None, softcap=0.0):
    S = q.shape[2]
    i = np.arange(S)
    mask = jnp.asarray(np.where(i[None, :] <= i[:, None], 0.0, -np.inf), jnp.float32)[None, None]
    return np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask, scale,
                                    logit_softcap=softcap))


def _jax_ring(q, k, v, sp, dp, **kw):
    """The JAX ring, jitted (one compile, where its eager shard_map runs op
    by op)."""
    mesh = jmake_mesh(dp=dp, tp=1, sp=sp)
    fn = jax.jit(functools.partial(jring, mesh, **kw))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("schedule", ["contiguous", "zigzag"])
@pytest.mark.parametrize("sp,dp", [(2, 1), (4, 1), (2, 2)])
def test_ring_matches_jax(pool, sp, dp, schedule):
    rng = np.random.default_rng(sp * 10 + dp)
    q, k, v = _qkv(rng, 2 * dp, 4, 4, 8 * sp, 16)
    got = _whole(pool.run(tm.sp_run, q, k, v, sp, dp, schedule), sp * dp, "out")
    assert nmse(got, _causal_ref(q, k, v)) < 1e-10
    assert nmse(got, _jax_ring(q, k, v, sp, dp, schedule=schedule)) < 1e-10


@pytest.mark.parametrize("schedule", ["contiguous", "zigzag"])
def test_ring_gqa_and_softcap(pool, schedule):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, 8, 2, 64, 16)
    got = _whole(pool.run(tm.sp_run, q, k, v, 4, 1, schedule, 0.21, 20.0), 4, "out")
    assert nmse(got, _causal_ref(q, k, v, scale=0.21, softcap=20.0)) < 1e-10
    assert nmse(got, _jax_ring(q, k, v, 4, 1, scale=0.21, logit_softcap=20.0,
                               schedule=schedule)) < 1e-10


@pytest.mark.parametrize("sp", [2, 4])
def test_zigzag_work_balance(pool, sp):
    """Every rank runs exactly 2sp+1 half-chunk updates."""
    rng = np.random.default_rng(sp)
    q, k, v = _qkv(rng, 1, 2, 2, 8 * sp, 8)
    res = pool.run(tm.sp_run, q, k, v, sp, 1, "zigzag", None, 0.0, True)
    counts = _whole(res, sp, "counts")
    assert counts.shape == (sp,) and (counts == 2 * sp + 1).all(), counts
    assert nmse(_whole(res, sp, "out"), _causal_ref(q, k, v)) < 1e-10


def test_zigzag_perm_matches_jax():
    perm, inv = zigzag_perm(48, 3)
    jperm, jinv = jzigzag_perm(48, 3)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    x = np.arange(48)
    assert (x[perm][inv] == x).all()
    # rank 0 owns half-chunks {0, 5}: rows 0-7 and 40-47
    assert (perm[:16] == np.r_[0:8, 40:48]).all()


def test_ring_bf16_io(pool):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 2, 2, 16, 8)
    res = pool.run(tm.sp_run, q, k, v, 2, 1, "zigzag", None, 0.0, False, True)
    assert [r["dtype"] for r in res[:2]] == ["torch.bfloat16"] * 2
    assert nmse(_whole(res, 2, "out"), _causal_ref(q, k, v)) < 1e-3


# ------------------------------------------------------------------------ pp

@pytest.fixture(scope="module")
def pp_params():
    return jllama.random_params(PP_CFG, seed=2)


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (2, 4), (4, 4)])
def test_pp_forward_matches_jax(pool, pp_params, pp, n_micro):
    B, S = n_micro * 2, 8
    toks = np.random.default_rng(0).integers(0, PP_CFG.n_vocab, (B, S)).astype(np.int64)
    mesh = jmake_pp_mesh(pp)
    want = np.asarray(jpp_forward(mesh, PP_CFG, jshard_pp(mesh, jstack_blocks(pp_params)),
                                  jnp.asarray(toks, jnp.int32), n_micro))
    res = pool.run(tm.pp_run, cfg_fields(PP_CFG), jax_params_to_numpy(pp_params), toks, pp,
                   n_micro)
    got = _whole(res, pp, "logits")
    assert got.shape == (B, S, PP_CFG.n_vocab)
    assert nmse(got, want) < 1e-9


def test_pp_requires_divisible_layers(pool, pp_params):
    """4 layers over 3 stages: the sharding rejects on every stage."""
    res = pool.run(tm.pp_run, cfg_fields(PP_CFG), jax_params_to_numpy(pp_params),
                   np.zeros((3, 4), np.int64), 3, 3)
    for r in res[:3]:
        assert "does not divide" in r["rejected"], r
    assert res[3] is None
