"""Attention (the counterpart of ggml_gfx906_tpu/ops/attention.py:
attention_ref, _causal_ref, causal_flash_attn).

Array convention (numpy order): q (B, H, N, D), k/v (B, H_kv, M, D) with
grouped-query broadcast when H > H_kv. `causal_flash_attn` is the hot path:
under config attn_impl="pallas" (the default) a CUDA tensor takes kernel K2
(ops/cuda/flash_attn.py), for any cache length, and a CPU tensor K2's plain
version; under "xla" every device takes the materialized-mask `_causal_ref`,
as the reference's does (ops/attention.py:269-270). The reference's
`force_ref` argument is not ported.
"""
from __future__ import annotations

import torch

from ..utils import config
from .cuda import flash_attn as _fa


def attention_ref(q, k, v, mask=None, scale: float | None = None,
                  max_bias: float = 0.0, logit_softcap: float = 0.0,
                  sinks=None):
    """Naive reference attention with an additive mask (f32 math)."""
    if max_bias != 0.0:
        raise NotImplementedError("ALiBi (max_bias) is not ported yet")
    B, H, N, D = q.shape
    Hkv = k.shape[1]
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = (q.float() @ k.float().transpose(-1, -2)) * _fa._f32(scale)
    if logit_softcap != 0.0:
        s = torch.tanh(s * _fa._f32(1.0 / logit_softcap)) * _fa._f32(logit_softcap)
    if mask is not None:
        s = s + mask.float()
    m = s.amax(-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, H, 1, 1)
        m = torch.maximum(m, sk)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True)
    if sinks is not None:
        denom = denom + torch.exp(sk - m)
    return ((e / denom) @ v.float()).to(q.dtype)


def _causal_ref(q, k, v, pos, scale, logit_softcap, k_scale=None,
                v_scale=None):
    """Materialized-mask path with pos-based causal semantics (int8 K/V are
    dequantized first)."""
    B, _, N, _ = q.shape
    M = k.shape[2]
    if k_scale is not None:
        k = k.float() * k_scale[..., None]
        v = v.float() * v_scale[..., None]
    pos = _fa._pos(pos, B, q.device)
    qpos = pos[:, None, None] + torch.arange(N, device=q.device)[None, :, None]
    cols = torch.arange(M, device=q.device)[None, None, :]
    mask = torch.where(cols <= qpos, 0.0, float("-inf"))[:, None]   # (B,1,N,M)
    return attention_ref(q, k, v, mask, scale, 0.0, logit_softcap, None)


def causal_flash_attn(q, k, v, pos, scale: float | None = None,
                      logit_softcap: float = 0.0, k_scale=None, v_scale=None):
    """Causal attention against a (possibly longer) KV cache: q (B, H, N, D)
    at absolute positions pos(B,)+n; k/v (B, KVH, M, D) (int8 with
    k_scale/v_scale (B, KVH, M) when the cache is quantized). Returns (B, H,
    N, D) in q.dtype."""
    if config.get("attn_impl") == "xla":
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        return _causal_ref(q, k, v, pos, scale, logit_softcap, k_scale, v_scale)
    return _fa.causal_flash_attention(q, k, v, pos, scale, logit_softcap, k_scale, v_scale)
