"""Port parity: batched sampling. jax.random.categorical is argmax(logp +
Gumbel(key)); fed the same Gumbel noise, the port's sample_batch picks the
same tokens as the JAX one."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ggml_gfx906_tpu.runtime import sampling as jsampling
from ggml_gfx906_tpu_torch.runtime import sampling as tsampling


def test_sample_batch_matches_reference_with_its_noise():
    rng = np.random.default_rng(0)
    b, v, max_k = 6, 300, 64
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.9], np.float32)
    top_k = np.array([1, 5, 64, 40, 3, 64], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.95, 1.0, 0.3], np.float32)
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c))(
        jnp.arange(b, dtype=jnp.int32) + 7, jnp.full((b,), 3, jnp.int32))
    ref = np.asarray(jsampling.sample_batch(jnp.asarray(logits), keys,
                                            jnp.asarray(temp), jnp.asarray(top_k),
                                            jnp.asarray(top_p), max_k))
    noise = np.stack([np.asarray(jax.random.gumbel(k, (max_k,), jnp.float32))
                      for k in keys])
    got = tsampling.sample_batch(torch.from_numpy(logits), torch.from_numpy(noise),
                                 torch.from_numpy(temp), torch.from_numpy(top_k),
                                 torch.from_numpy(top_p), max_k)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0] == int(np.argmax(logits[0]))           # temp 0 → greedy


def test_gumbel_noise_is_seeded():
    g1 = tsampling.gumbel(torch.Generator().manual_seed(3), 64)
    g2 = tsampling.gumbel(torch.Generator().manual_seed(3), 64)
    assert torch.equal(g1, g2) and torch.isfinite(g1).all()
