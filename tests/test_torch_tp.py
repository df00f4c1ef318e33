"""Tensor-parallel llama (ggml_gfx906_tpu_torch/parallel/tp.py) against the
JAX package's tp.py on the reference tests/test_tp.py's model (512 wide, 2
layers, Q4_K): the port's ranks are gloo processes (tests/_torch_mesh.py),
the JAX side the conftest's virtual CPU devices, the kernels their plain
versions on both. Bounds are the reference test's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh as tm
from _torch_port import one_torch_thread  # noqa: F401
from _torch_port import cfg_fields, jax_params_to_numpy, nmse, tp_cfg, tp_qparams
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.ops.quantized import to_int8_layout as j_to_int8
from ggml_gfx906_tpu.parallel import make_mesh as jmake_mesh
from ggml_gfx906_tpu.parallel import tp as jtp
from ggml_gfx906_tpu.runtime.batched_kv import BatchedKVCache as JBatchedKVCache

CFG = tp_cfg()
PROMPT = [5, 17, 80]
TOKS = [3, 100, 57, 501, 9]
N_STEPS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tm.start_pool(tmp_path_factory, 4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jparams():
    return tp_qparams(CFG)


@pytest.fixture(scope="module")
def tree(jparams):
    return jax_params_to_numpy(jparams)


def _jax_tp_run(params, toks, steps):
    """JAX tp_forward at tp = 2, then `steps` tp_decode_steps."""
    mesh = jmake_mesh(dp=1, tp=2)
    sp = jtp.shard_llama_params(mesh, params)
    logits, kv = jtp.tp_forward(mesh, CFG, sp, jnp.asarray(toks, jnp.int32),
                                jllama.make_cache(CFG, 128), jnp.int32(0))
    tok = jnp.argmax(logits[-1]).astype(jnp.int32)[None]
    got = [int(tok[0])]
    for i in range(steps):
        tok, kv = jtp.tp_decode_step(mesh, CFG, sp, tok, kv, jnp.int32(len(toks) + i))
        got.append(int(tok[0]))
    return np.asarray(logits), got


@pytest.fixture(scope="module")
def prompt_runs(pool, jparams, tree):
    """(port ranks' results, JAX's) of the 5-token prompt and the decode chain."""
    port = pool.run(tm.tp_forward_run, cfg_fields(CFG), tree, TOKS, N_STEPS)
    return port, _jax_tp_run(jparams, TOKS, N_STEPS)


def test_tp2_forward_matches_jax(prompt_runs, jparams):
    port, (jlogits, _) = prompt_runs
    ref, _ = jllama.forward(CFG, jparams, jnp.asarray(TOKS, jnp.int32),
                            jllama.make_cache(CFG, 128), jnp.int32(0))
    for r in port[:2]:
        assert r["length"] == len(TOKS) + N_STEPS
        assert r["kv_heads"] == CFG.n_kv_head // 2
        assert nmse(r["logits"], jlogits) < 1e-9
        assert nmse(r["logits"], np.asarray(ref)) < 1e-9
    np.testing.assert_array_equal(port[0]["logits"], port[1]["logits"])
    assert port[2] is None and port[3] is None      # off the 2-rank mesh


def test_tp2_greedy_decode_token_exact(pool, jparams, tree):
    port = pool.run(tm.tp_forward_run, cfg_fields(CFG), tree, PROMPT, N_STEPS)
    _, jtoks = _jax_tp_run(jparams, PROMPT, N_STEPS)
    kv = jllama.make_cache(CFG, 128)
    logits, kv = jllama.forward(CFG, jparams, jnp.asarray(PROMPT, jnp.int32), kv, jnp.int32(0))
    tok = jnp.argmax(logits[-1]).astype(jnp.int32)[None]
    single = [int(tok[0])]
    for i in range(N_STEPS):
        tok, kv = jllama.decode_step(CFG, jparams, tok, kv, jnp.int32(len(PROMPT) + i))
        single.append(int(tok[0]))
    assert jtoks == single
    assert port[0]["tokens"] == port[1]["tokens"] == jtoks


def test_dp_tp_batched_forward_matches_jax(pool, jparams, tree):
    B, S = 4, 6
    toks = np.random.default_rng(11).integers(0, CFG.n_vocab, (B, S)).astype(np.int64)
    mesh = jmake_mesh(dp=2, tp=2)
    sp = jtp.shard_llama_params(mesh, jparams)
    kv = JBatchedKVCache.create(CFG.n_layer, B, 128, CFG.n_kv_head, CFG.head_dim)
    ref, _ = jtp.tp_forward_batch(mesh, CFG, sp, jnp.asarray(toks, jnp.int32), kv,
                                  jnp.zeros((B,), jnp.int32))
    ref = np.asarray(ref)
    port = pool.run(tm.tp_batch_run, cfg_fields(CFG), tree, toks, 2, 2)
    for r in port:
        assert r["kv_shape"] == (B // 2, CFG.n_kv_head // 2, 128, CFG.head_dim)
        np.testing.assert_array_equal(r["lengths"], 0)
        assert nmse(r["logits"], ref) < 1e-9
        assert list(r["logits"][:, -1].argmax(-1)) == list(ref[:, -1].argmax(-1))


def test_tp2_int8_layout_forward_matches_jax(pool, jparams):
    """The int8 execution layout: rows on axis 1 of w8t / dwt, the column
    splits on the K-tiles."""
    p8 = jax.tree.map(lambda t: j_to_int8(t) if isinstance(t, JQuantTensor) else t,
                      jparams, is_leaf=lambda t: isinstance(t, JQuantTensor))
    jlogits, _ = _jax_tp_run(p8, TOKS, 0)
    ref, _ = jllama.forward(CFG, p8, jnp.asarray(TOKS, jnp.int32),
                            jllama.make_cache(CFG, 128), jnp.int32(0))
    port = pool.run(tm.tp_forward_run, cfg_fields(CFG), jax_params_to_numpy(p8), TOKS, 0)
    for r in port[:2]:
        assert nmse(r["logits"], jlogits) < 1e-9
        assert nmse(r["logits"], np.asarray(ref)) < 1e-9


@pytest.mark.parametrize("case,tp,match", [
    ("row", 3, "N % tp"),                 # 512 rows of wq over 3 ranks
    ("col", 4, "multiple of 256"),        # wo's K 512 / 4 = 128
    ("wire", 2, "column TP needs kernel layout"),
])
def test_split_checks_raise(pool, tree, case, tp, match):
    got = pool.run(tm.shard_rejects, cfg_fields(CFG), tree, tp, case)
    for r in got[:tp]:
        assert r is not None and match in r, r
    assert all(r is None for r in got[tp:])
