"""Port parity: batched sampling and the reference's random numbers.
jax.random.categorical is argmax(logp + Gumbel(key)); the port computes the
reference's keys fold_in(PRNGKey(seed), counter), its threefry2x32 bits
and its Gumbel draws in torch integer ops, so fed the same seeds and
counters, the port's sample_batch picks the same tokens as the JAX one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.runtime import sampling as jsampling
from ggml_gfx906_tpu_torch.runtime import sampling as tsampling

SEEDS = [0, 1, 12345, 2 ** 31 - 1]
COUNTERS = range(8)


def _jax_keys(seed):
    return [jax.random.fold_in(jax.random.PRNGKey(seed), c) for c in COUNTERS]


def _port_keys(seed):
    return tsampling.fold_in(tsampling.prng_key(seed), torch.arange(8))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_keys_match_jax(seed):
    ref = np.stack([np.asarray(k) for k in _jax_keys(seed)]).astype(np.int64)
    np.testing.assert_array_equal(_port_keys(seed).numpy(), ref)
    np.testing.assert_array_equal(tsampling.prng_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits_match_jax(seed):
    ref = np.stack([np.asarray(jax.random.bits(k, (64,))) for k in _jax_keys(seed)])
    np.testing.assert_array_equal(tsampling.uniform_bits(_port_keys(seed), 64).numpy(),
                                  ref.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax(seed):
    """Within 1e-6: the bits and the uniforms are equal; the two logs may
    round differently in the last place."""
    ref = np.stack([np.asarray(jax.random.gumbel(k, (64,), jnp.float32))
                    for k in _jax_keys(seed)])
    got = tsampling.gumbel(_port_keys(seed), 64).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # seeded: the same (seed, counter) gives the same draws, batched or alone
    rows = tsampling.gumbel_noise([seed, 5, seed], [3, 3, 4], 64)
    assert torch.equal(rows[0], torch.from_numpy(got[3]))
    assert torch.equal(rows[2], torch.from_numpy(got[4]))


def test_sample_batch_matches_reference_with_its_noise():
    rng = np.random.default_rng(0)
    b, v, max_k = 6, 300, 64
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.9], np.float32)
    top_k = np.array([1, 5, 64, 40, 3, 64], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.95, 1.0, 0.3], np.float32)
    seeds = np.arange(b, dtype=np.int32) + 7
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c))(
        jnp.asarray(seeds), jnp.full((b,), 3, jnp.int32))
    ref = np.asarray(jsampling.sample_batch(jnp.asarray(logits), keys,
                                            jnp.asarray(temp), jnp.asarray(top_k),
                                            jnp.asarray(top_p), max_k))
    noise = tsampling.gumbel_noise(seeds.tolist(), [3] * b, max_k)
    got = tsampling.sample_batch(torch.from_numpy(logits), noise,
                                 torch.from_numpy(temp), torch.from_numpy(top_k),
                                 torch.from_numpy(top_p), max_k)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[0] == int(np.argmax(logits[0]))           # temp 0 → greedy
