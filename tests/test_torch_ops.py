"""Port parity: rms_norm, silu and rope_ext against the JAX ops
(nmse < 1e-12, the bound of tests/test_ops.py's norm checks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu import ops as jops
from ggml_gfx906_tpu.runtime.kv_cache import KVCache as JKVCache
from ggml_gfx906_tpu_torch import ops as tops
from ggml_gfx906_tpu_torch.ops.basic import row_sum
from ggml_gfx906_tpu_torch.runtime.batched_kv import BatchedKVCache
from ggml_gfx906_tpu_torch.runtime.kv_cache import KVCache

from _torch_port import nmse

RNG = np.random.default_rng(3)


@pytest.mark.parametrize("width", [64, 256, 4096, 100])
def test_rms_norm(width):
    x = RNG.standard_normal((3, 5, width)).astype(np.float32) * 2.0
    ref = np.asarray(jops.rms_norm(jnp.asarray(x), 1e-5))
    got = tops.rms_norm(torch.from_numpy(x), 1e-5).numpy()
    assert nmse(got, ref) < 1e-12


def test_row_sum_is_batch_invariant():
    """A row's bits do not depend on the rows around it."""
    x = torch.from_numpy(RNG.standard_normal((9, 4096)).astype(np.float32))
    full = row_sum(x)
    for i in range(9):
        assert torch.equal(row_sum(x[i:i + 1]), full[i:i + 1])


def test_silu():
    x = RNG.standard_normal((4, 300)).astype(np.float32) * 4
    ref = np.asarray(jops.silu(jnp.asarray(x)))
    assert nmse(tops.silu(torch.from_numpy(x)).numpy(), ref) < 1e-12


@pytest.mark.parametrize("mode", [jops.ROPE_TYPE_NORMAL, jops.ROPE_TYPE_NEOX])
@pytest.mark.parametrize("kw", [
    {},
    {"freq_base": 500000.0, "freq_scale": 0.25},
    {"ext_factor": 1.0, "freq_scale": 0.5, "n_ctx_orig": 64, "attn_factor": 1.1},
])
def test_rope_ext(mode, kw):
    x = RNG.standard_normal((2, 11, 3, 64)).astype(np.float32)
    pos = RNG.integers(0, 40, (2, 11)).astype(np.int32)
    n_dims = 48
    ref = np.asarray(jops.rope_ext(jnp.asarray(x), jnp.asarray(pos), n_dims,
                                   mode=mode, **kw))
    got = tops.rope_ext(torch.from_numpy(x), torch.from_numpy(pos), n_dims,
                        mode=mode, **kw).numpy()
    assert nmse(got, ref) < 1e-12
    np.testing.assert_array_equal(got[..., n_dims:], x[..., n_dims:])


def test_kv_cache_write_clamps_near_max_seq():
    """A padded chunk written near max_seq lands where the reference's
    dynamic_update_slice puts it (start clamped so the rows fit)."""
    max_seq, kvh, hd, s = 16, 2, 4, 6
    k = RNG.standard_normal((s, kvh, hd)).astype(np.float32)
    v = RNG.standard_normal((s, kvh, hd)).astype(np.float32)
    for start in (0, 7, 12, 15):
        jkv = JKVCache.create(1, max_seq, kvh, hd).update_layer(
            0, jnp.asarray(k), jnp.asarray(v), jnp.int32(start))
        tkv = KVCache.create(1, max_seq, kvh, hd).update_layer(
            0, torch.from_numpy(k), torch.from_numpy(v), start)
        np.testing.assert_array_equal(tkv.k[0].numpy(), np.asarray(jkv.k[0]))
        np.testing.assert_array_equal(tkv.v[0].numpy(), np.asarray(jkv.v[0]))
    bkv = BatchedKVCache.create(1, 2, max_seq, kvh, hd)
    bkv.update_layer(0, torch.from_numpy(k[None]).expand(2, -1, -1, -1),
                     torch.from_numpy(v[None]).expand(2, -1, -1, -1),
                     torch.tensor([3, 14], dtype=torch.int32))
    np.testing.assert_array_equal(bkv.k[0][1].numpy(), np.asarray(
        JKVCache.create(1, max_seq, kvh, hd).update_layer(
            0, jnp.asarray(k), jnp.asarray(v), jnp.int32(14)).k[0]))
