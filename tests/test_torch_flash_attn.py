"""Port parity: causal flash attention K2 against the JAX package's Pallas
kernel (interpret mode on the CPU), over tests/test_flash_attn.py's cases.
On the CPU the port runs K2's plain version; the CUDA kernel is held
against it on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu import ops as jops
from ggml_gfx906_tpu.ops.pallas import flash_attn as jfa
from ggml_gfx906_tpu_torch import ops as tops
from ggml_gfx906_tpu_torch.ops.attention import _causal_ref
from ggml_gfx906_tpu_torch.ops.cuda import flash_attn as tfa

from _torch_port import nmse

CASES = [
    # (B, H, KVH, N, M, pos, softcap, dtype) — tests/test_flash_attn.py:36-46
    (1, 4, 4, 1, 256, 64, 0.0, "f32"),        # MHA decode
    (1, 8, 2, 1, 256, 200, 0.0, "f32"),       # GQA decode
    (1, 4, 4, 128, 256, 0, 0.0, "f32"),       # prefill from zero
    (1, 8, 2, 96, 256, 100, 0.0, "f32"),      # GQA chunked prefill
    (2, 4, 2, 5, 384, [3, 250], 0.0, "f32"),  # batched, ragged pos
    (1, 4, 4, 1, 256, 17, 30.0, "f32"),       # logit softcap (gemma)
    (1, 4, 1, 33, 256, 64, 0.0, "f32"),       # MQA, unaligned N
    (1, 4, 4, 1, 256, 64, 0.0, "bf16"),       # bf16 decode
    (1, 8, 2, 16, 128, 40, 0.0, "f32q_bf16kv"),  # f32 q, bf16 cache (main path)
]
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _mk(rng, b, h, kvh, n, m, d):
    return (rng.standard_normal((b, h, n, d)).astype(np.float32),
            rng.standard_normal((b, kvh, m, d)).astype(np.float32),
            rng.standard_normal((b, kvh, m, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,kvh,n,m,pos,softcap,dt", CASES)
def test_k2_matches_reference(b, h, kvh, n, m, pos, softcap, dt):
    """nmse < 1e-10 in f32 and < 2e-4 in bf16 (tests/test_flash_attn.py:73)."""
    rng = np.random.default_rng(b * 1000 + h * 100 + n + m)
    d = 64 if h == 8 else 128
    q, k, v = _mk(rng, b, h, kvh, n, m, d)
    qdt, kvdt = ("f32", "bf16") if dt == "f32q_bf16kv" else (dt, dt)
    jq, jk, jv = (jnp.asarray(q, _JDT[qdt]), jnp.asarray(k, _JDT[kvdt]),
                  jnp.asarray(v, _JDT[kvdt]))
    ref = np.asarray(jfa.causal_flash_attention(
        jq, jk, jv, jnp.asarray(pos, jnp.int32), None, softcap)).astype(np.float32)
    # identical inputs: the bf16 values JAX rounded to, handed to torch as f32 bits
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(_TDT[t])
                  for a, t in ((jq, qdt), (jk, kvdt), (jv, kvdt)))
    got = tops.causal_flash_attn(tq, tk, tv, torch.tensor(pos, dtype=torch.int32),
                                 logit_softcap=softcap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 1e-10 if qdt == "f32" else 2e-4
    assert nmse(got.float().numpy(), ref) < tol


@pytest.mark.parametrize("m,pos,n", [(200, 150, 1), (77, 10, 33), (40, 0, 40)])
def test_k2_any_cache_length(m, pos, n):
    """The port takes any M (fixed KV tile, masked tail); the reference's
    kernel gates on M % 128 == 0, so these compare with its XLA path."""
    rng = np.random.default_rng(m)
    q, k, v = _mk(rng, 1, 8, 2, n, m, 64)
    ref = np.asarray(jops.causal_flash_attn(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), jnp.int32(pos),
                                            force_ref=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tops.causal_flash_attn(tq, tk, tv, pos)
    assert nmse(got.numpy(), ref) < 1e-10
    # and the port's own materialized-mask path
    assert nmse(_causal_ref(tq, tk, tv, pos, 1.0 / 8.0, 0.0).numpy(), ref) < 1e-12


def test_k2_int8_kv():
    """int8 K/V with per-(head, pos) scales vs the reference kernel
    (tests/test_flash_attn.py:90)."""
    rng = np.random.default_rng(1)
    b, h, kvh, n, m, d = 1, 8, 4, 3, 256, 128
    q, kf, vf = _mk(rng, b, h, kvh, n, m, d)
    kd = (np.abs(kf).max(-1) / 127.0).astype(np.float32)
    vd = (np.abs(vf).max(-1) / 127.0).astype(np.float32)
    k8 = np.round(kf / kd[..., None]).astype(np.int8)
    v8 = np.round(vf / vd[..., None]).astype(np.int8)
    pos = m - n
    ref = np.asarray(jfa.causal_flash_attention(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.int32(pos),
        k_scale=jnp.asarray(kd), v_scale=jnp.asarray(vd)))
    got = tfa.causal_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8), pos,
        k_scale=torch.from_numpy(kd), v_scale=torch.from_numpy(vd))
    assert nmse(got.numpy(), ref) < 1e-10


def test_k2_padding_region_ignored():
    """Cache contents beyond pos+n must not affect the output (the engine
    leaves stale rows there)."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _mk(rng, 1, 4, 4, 1, 256, 128))
    out1 = tops.causal_flash_attn(q, k, v, 40)
    sel = torch.arange(256)[None, None, :, None] > 40
    junk = torch.from_numpy(rng.standard_normal(k.shape).astype(np.float32) * 100)
    out2 = tops.causal_flash_attn(q, torch.where(sel, junk, k),
                                  torch.where(sel, junk * 2, v), 40)
    assert torch.equal(out1, out2)


def test_k2_rejects_what_it_does_not_take():
    q = torch.zeros(1, 4, 1, 64)
    with pytest.raises(ValueError):
        tops.causal_flash_attn(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64), 0)
    with pytest.raises(ValueError):   # int8 K/V without scales
        tops.causal_flash_attn(q, torch.zeros(1, 4, 8, 64, dtype=torch.int8),
                               torch.zeros(1, 4, 8, 64, dtype=torch.int8), 0)


def test_attention_ref_with_mask_softcap_and_sinks():
    """The naive reference (explicit additive mask, softcap, sinks) against
    the JAX package's attention_ref."""
    rng = np.random.default_rng(4)
    q, k, v = _mk(rng, 2, 4, 2, 5, 24, 32)
    mask = np.where(rng.random((2, 1, 5, 24)) < 0.3, -np.inf, 0.0).astype(np.float32)
    mask[..., 0] = 0.0
    sinks = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(jops.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(mask), 0.2, 0.0, 20.0,
                                        jnp.asarray(sinks)))
    got = tops.attention_ref(*(torch.from_numpy(a) for a in (q, k, v, mask)), 0.2,
                             0.0, 20.0, torch.from_numpy(sinks))
    assert nmse(got.numpy(), ref) < 1e-12
