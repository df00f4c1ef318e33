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


# ------------------------------------- the CLI's single-row sampler

def _keys(seed):
    return jax.random.PRNGKey(seed), tsampling.prng_key(seed)


@pytest.mark.parametrize("seed", range(50))
def test_split_and_categorical_match_jax(seed):
    """split: jax.random.split bit for bit (threefry partitionable: row i is
    fold_in(key, i)), chained as the CLI chains its key; categorical: the
    same index as jax.random.categorical on the same logits."""
    jk, tk = _keys(seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        pair = tsampling.split(tk)
        tk, tsub = pair[0], pair[1]
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
        np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub).astype(np.int64))
        logits = (rng.standard_normal(500) * 2).astype(np.float32)
        assert int(tsampling.categorical(tsub, torch.from_numpy(logits))) \
            == int(jax.random.categorical(jsub, jnp.asarray(logits)))
    np.testing.assert_array_equal(tsampling.split(tk, 5).numpy(),
                                  np.asarray(jax.random.split(jk, 5)).astype(np.int64))


@pytest.mark.parametrize("temp", [0.5, 1.0, 1.3])
@pytest.mark.parametrize("top_k", [0, 1, 40])
@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0])
def test_sample_top_k_top_p_matches_reference(temp, top_k, top_p):
    """The port's single-row sampler picks the reference's token on the same
    logits and key, for keys from 50 seeds (each split once, as the CLI's
    first token's key is)."""
    rng = np.random.default_rng(int(temp * 10) + top_k + int(top_p * 100))
    got, want = [], []
    for seed in range(50):
        jk, tk = _keys(seed)
        logits = (rng.standard_normal(320) * 3).astype(np.float32)
        want.append(int(jsampling.sample_top_k_top_p(jnp.asarray(logits), jax.random.split(jk)[1],
                                                      top_k, top_p, temp)))
        got.append(int(tsampling.sample_top_k_top_p(torch.from_numpy(logits),
                                                    tsampling.split(tk)[1], top_k, top_p, temp)))
    assert got == want
    if top_k == 1:
        assert len(set(got)) > 1      # the argmax of each row's logits
