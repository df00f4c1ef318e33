"""Attention (the counterpart of ggml_gfx906_tpu/ops/attention.py:
attention_ref, flash_attn_ext, _causal_ref, _int8_score_dot, _causal_postscale,
causal_attn_delta, causal_flash_attn).

`attention_ref` and `flash_attn_ext` take an explicit additive mask, with
ALiBi slopes (max_bias) and sinks.

Array convention (numpy order): q (B, H, N, D), k/v (B, H_kv, M, D) with
grouped-query broadcast when H > H_kv. `causal_flash_attn` is the hot path:
under config attn_impl="pallas" (the default) a CUDA tensor takes kernel K2
(ops/cuda/flash_attn.py), for any cache length, and a CPU tensor K2's plain
version; under "xla" every device takes the materialized-mask `_causal_ref`,
as the reference's does (ops/attention.py:269-270), with int8 K/V taking
`_causal_postscale` (the scales on the dot outputs, the int8 score dot at
decode under config kv_attn_int8_dot). The reference takes its Pallas
kernel only where the cache length is a multiple of 128 and the postscale
path elsewhere; a CUDA tensor here always takes K2, int8 K/V included.
`causal_attn_delta` (window-delta decode) is plain torch, as the
reference's is XLA. The reference's `force_ref` argument is not ported.

The reference's einsums with preferred_element_type=f32 are f32 matmuls
here on operands rounded to the dot type first (bf16 at bf16 compute), so
products are exact and sums are f32, as there.
"""
from __future__ import annotations

import torch

from ..utils import config
from .basic import alibi_slopes
from .cuda import flash_attn as _fa


def attention_ref(q, k, v, mask=None, scale: float | None = None,
                  max_bias: float = 0.0, logit_softcap: float = 0.0,
                  sinks=None):
    """Naive reference attention with an additive mask (f32 math); the mask
    is scaled per head by the ALiBi slopes of max_bias (ones at 0)."""
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
        slope = alibi_slopes(H, max_bias, q.device).reshape(1, H, 1, 1)
        s = s + slope * mask.float()
    m = s.amax(-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, H, 1, 1)
        m = torch.maximum(m, sk)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True)
    if sinks is not None:
        denom = denom + torch.exp(sk - m)
    return ((e / denom) @ v.float()).to(q.dtype)


def flash_attn_ext(q, k, v, mask=None, scale: float | None = None,
                   max_bias: float = 0.0, logit_softcap: float = 0.0, sinks=None):
    """The public entry with ggml's explicit-mask semantics (reference
    :59-66): any mask, in plain torch, as the reference's runs XLA. The
    causal hot path is `causal_flash_attn` (K2), which takes positions
    instead of a mask."""
    return attention_ref(q, k, v, mask, scale, max_bias, logit_softcap, sinks)


def _causal_ref(q, k, v, pos, scale, logit_softcap, k_scale=None,
                v_scale=None):
    """Materialized-mask path with pos-based causal semantics; int8 K/V
    take `_causal_postscale`."""
    B, _, N, _ = q.shape
    M = k.shape[2]
    if k_scale is not None:
        return _causal_postscale(q, k, v, k_scale, v_scale, pos, scale, logit_softcap)
    pos = _fa._pos(pos, B, q.device)
    qpos = pos[:, None, None] + torch.arange(N, device=q.device)[None, :, None]
    cols = torch.arange(M, device=q.device)[None, None, :]
    mask = torch.where(cols <= qpos, 0.0, float("-inf"))[:, None]   # (B,1,N,M)
    return attention_ref(q, k, v, mask, scale, 0.0, logit_softcap, None)


def _dot(a, b, dot_t):
    """a (..., n, D) · b (..., m, D)ᵀ → (..., n, m) f32 from operands
    rounded to dot_t: the reference's einsum with
    preferred_element_type=f32."""
    return a.to(dot_t).float() @ b.to(dot_t).float().transpose(-1, -2)


def _div(a, c: float):
    """a / c as a division (a CUDA tensor divided by a Python scalar is
    multiplied by its reciprocal)."""
    return a / torch.full_like(a, c)


def _int8_score_dot(qg, k8, kd, scale):
    """Scores against an int8 K segment with the q rows quantized per
    (b, h, n) to int8 (half to even, as jnp.round), the reference's :83-96.
    The int8·int8 dot is carried in f32: each sum has at most D ≤ 512
    products of magnitude ≤ 127², so every partial sum stays below 2^24
    and is exact in any order. Returns (B, KVH, n, M) f32."""
    qf = qg.float()
    qd = _div(qf.abs().amax(-1, keepdim=True), 127.0)
    q8 = torch.round(qf / torch.clamp(qd, min=1e-30))
    s = q8 @ k8.float().transpose(-1, -2)
    return s * (qd * kd[:, :, None, :] * _fa._f32(scale))


def _causal_postscale(q, k8, v8, kd, vd, pos, scale, softcap):
    """Quantized-KV causal attention without a dequantized cache, the
    reference's :98-153: kd scales the score columns, vd is folded into
    the probabilities. The int8 score dot at decode (N == 1) for non-f32 q
    under config kv_attn_int8_dot.

    q (B, H, N, D); k8/v8 (B, KVH, M, D) int8; kd/vd (B, KVH, M) f32."""
    B, H, N, D = q.shape
    KVH, M = k8.shape[1], k8.shape[2]
    rep = H // KVH
    dot_t = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    # q head h uses kv head h // rep: (H, N) flattens to (KVH, rep·N) rows,
    # row j of a group at query offset j % N
    qg = q.reshape(B, KVH, rep * N, D)
    if N == 1 and q.dtype != torch.float32 and bool(config.get("kv_attn_int8_dot")):
        s = _int8_score_dot(qg, k8, kd, scale)
    else:
        s = _dot(qg, k8, dot_t) * (kd[:, :, None, :] * _fa._f32(scale))
    if softcap != 0.0:
        s = torch.tanh(s * _fa._f32(1.0 / softcap)) * _fa._f32(softcap)
    pos = _fa._pos(pos, B, q.device)
    qpos = pos[:, None] + torch.arange(rep * N, device=q.device) % N       # (B, rN)
    cols = torch.arange(M, device=q.device)
    mask = torch.where(cols[None, None, :] <= qpos[:, :, None], 0.0,
                       float("-inf"))[:, None]                              # (B,1,rN,M)
    p = torch.softmax(s + mask, dim=-1)
    out = _dot(p * vd[:, :, None, :], v8.transpose(-1, -2), dot_t)
    return out.reshape(B, H, N, D).to(q.dtype)


def causal_attn_delta(q, kc, vc, kd, vd, len0, dk, dv, step: int,
                      scale: float | None = None):
    """Decode attention over a big cache segment plus a small per-window
    delta segment, merged at score level (window-delta decode, config
    engine_window_delta; the reference's :156-226).

    q (B, H, 1, D) at per-slot positions len0(B,)+step; the big cache kc/vc
    (B, KVH, W, D) — or int8 with kd/vd (B, KVH, W) scales — holds rows
    [0, len0); the delta dk/dv (B, KVH, DEPTH, D) holds the window's fresh
    rows at positions len0+j, valid for j ≤ step. Both segments' scores
    go into ONE softmax, then out = P_big·V_big + P_delta·V_delta.
    Equivalent to writing the rows into the cache and attending
    [0, len0+step] up to reduction order; at bf16 compute the dots take
    bf16 operands (P and the fresh rows rounded to bf16)."""
    B, H, N, D = q.shape
    if N != 1:
        raise ValueError("delta attention is decode-only")
    KVH, W = kc.shape[1], kc.shape[2]
    DEPTH = dk.shape[2]
    rep = H // KVH
    dot_t = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    sc = _fa._f32(scale)
    qg = q.reshape(B, KVH, rep, D)
    quant = kd is not None
    if quant and q.dtype == torch.bfloat16 and bool(config.get("kv_attn_int8_dot")):
        s_big = _int8_score_dot(qg, kc, kd, scale)
    elif quant:
        s_big = _dot(qg, kc, dot_t) * (kd[:, :, None, :] * sc)
    else:
        s_big = _dot(qg, kc, dot_t) * sc
    s_dlt = _dot(qg, dk, dot_t) * sc
    len0 = torch.as_tensor(len0, dtype=torch.int32, device=q.device).reshape(-1)
    mask_big = torch.where(torch.arange(W, device=q.device)[None, :] < len0[:, None],
                           0.0, float("-inf"))[:, None, None]               # (B,1,1,W)
    mask_dlt = torch.where(torch.arange(DEPTH, device=q.device) <= step, 0.0,
                           float("-inf"))
    p = torch.softmax(torch.cat([s_big + mask_big, s_dlt + mask_dlt], dim=-1), dim=-1)
    p_big, p_dlt = p[..., :W], p[..., W:]
    if quant:
        p_big = p_big * vd[:, :, None, :]
    out = _dot(p_big, vc.transpose(-1, -2), dot_t) + _dot(p_dlt, dv.transpose(-1, -2), dot_t)
    return out.reshape(B, H, N, D).to(q.dtype)


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
