"""The recurrent mixers and rope_multi of the port against the JAX
package's on the same seeded numpy inputs (a few tokens, 2 heads, head
dims 8–16), at nmse < 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nmse, one_torch_thread  # noqa: F401
from ggml_gfx906_tpu import ops as jops
from ggml_gfx906_tpu_torch import ops as tops

TOL = 1e-12


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check(name, *arrays, **kw):
    ref = jax.jit(lambda *xs: getattr(jops, name)(*xs, **kw))(*(jnp.asarray(a) for a in arrays))
    got = getattr(tops, name)(*(torch.from_numpy(a) for a in arrays), **kw)
    for r, g in zip(ref, got):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        assert nmse(g.numpy(), r) < TOL, (name, nmse(g.numpy(), r))


@pytest.mark.parametrize("T,D", [(1, 8), (5, 16)])
def test_rwkv_wkv6(T, D):
    rng = np.random.default_rng(T)
    B, H = 2, 2
    decay = np.exp(-np.exp(_rand(rng, B, T, H, D, scale=0.5))).astype(np.float32)
    _check("rwkv_wkv6", _rand(rng, B, T, H, D), _rand(rng, B, T, H, D), _rand(rng, B, T, H, D),
           _rand(rng, H, D), decay, _rand(rng, B, H, D, D, scale=0.1))


@pytest.mark.parametrize("T,D", [(1, 8), (6, 16)])
def test_rwkv_wkv7(T, D):
    rng = np.random.default_rng(10 + T)
    B, H = 1, 2
    w = np.exp(-np.exp(_rand(rng, B, T, H, D, scale=0.5))).astype(np.float32)
    k = _rand(rng, B, T, H, D)
    kk = k / np.linalg.norm(k, axis=-1, keepdims=True)
    _check("rwkv_wkv7", _rand(rng, B, T, H, D), w, k, _rand(rng, B, T, H, D), -kk,
           (kk * 0.5).astype(np.float32), _rand(rng, B, H, D, D, scale=0.1))


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_gated_linear_attn(scale):
    rng = np.random.default_rng(20)
    B, T, H, D = 2, 5, 2, 12
    g = np.exp(-np.abs(_rand(rng, B, T, H, D))).astype(np.float32)
    _check("gated_linear_attn", _rand(rng, B, T, H, D), _rand(rng, B, T, H, D),
           _rand(rng, B, T, H, D), g, _rand(rng, B, H, D, D, scale=0.1), scale=scale)


def _rope_multi(x, pos, n_dims, sections, **kw):
    ref = jax.jit(lambda a, p: jops.rope_multi(a, p, n_dims, sections, **kw))(
        jnp.asarray(x), jnp.asarray(pos))
    got = tops.rope_multi(torch.from_numpy(x), torch.from_numpy(pos), n_dims, sections, **kw)
    assert tuple(got.shape) == ref.shape
    assert nmse(got.numpy(), ref) < TOL, nmse(got.numpy(), ref)


@pytest.mark.parametrize("kw", [
    dict(), dict(forward=False), dict(freq_base=1e6, freq_scale=0.5),
    dict(ext_factor=1.0, n_ctx_orig=64, freq_scale=0.25, attn_factor=0.9),
])
def test_rope_multi_mrope(kw):
    """M-RoPE: sections over 8 of a 16-wide head's pairs (the rest pass
    through), the t/h/w/e position streams, YaRN and the inverse."""
    rng = np.random.default_rng(30)
    n_seq, H, hd = 7, 2, 16
    x = _rand(rng, n_seq, H, hd)
    pos = rng.integers(0, 50, (4, n_seq)).astype(np.int32)
    _rope_multi(x, pos, 12, (2, 2, 1, 1), mode=jops.ROPE_TYPE_MROPE, **kw)


@pytest.mark.parametrize("kw", [dict(), dict(freq_factors=np.linspace(
    1.0, 2.0, 8).astype(np.float32)), dict(ext_factor=0.5, n_ctx_orig=32)])
def test_rope_multi_vision(kw):
    """VISION: half-split pairs over the whole head, each sector's theta
    reset at its start; with per-pair frequency factors and with YaRN."""
    rng = np.random.default_rng(31)
    n_seq, H, hd = 6, 2, 16
    x = _rand(rng, 1, n_seq, H, hd)
    pos = rng.integers(0, 20, (4, n_seq)).astype(np.int32)
    _rope_multi(x, pos, hd // 2, (2, 2, 0, 0), mode=jops.ROPE_TYPE_VISION, **kw)


def test_rope_modes_match_the_reference():
    assert (tops.ROPE_TYPE_MROPE, tops.ROPE_TYPE_VISION) == (jops.ROPE_TYPE_MROPE,
                                                             jops.ROPE_TYPE_VISION) == (8, 24)
