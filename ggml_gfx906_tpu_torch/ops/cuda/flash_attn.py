"""Causal flash attention kernel K2.

Replaces ggml_gfx906_tpu/ops/pallas/flash_attn.py::causal_flash_attention.
Kernel source: csrc/flash_attn.cu (fuller notes there). Bound on the H100:
bytes at decode (the K/V stream), operations for long prefill chunks.
Design: a row's causal range is cut into chunks of CHUNK positions at fixed
absolute places; each chunk's softmax partial is summed in an order fixed
by the chunk alone and a row's result is the left fold of its chunks, so
it does not depend on M (the window), N, B, its neighbours or the split.
Blocks take (batch·KV head, tile of GQA-folded rows, range of chunks); K/V
tiles stream by cp.async through a 4-deep ring. With more than one range
per row tile the blocks write per-chunk partials to a buffer allocated
here and a second kernel folds them; the wrapper picks the number of
ranges to fill the SMs. Any cache or window length M is taken (the
reference gates on M % 128 == 0).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import K2, build

# finite "minus infinity": exp(NEG_INF - NEG_INF) stays defined
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
MAX_D = 256
CHUNK = 128          # positions per chunk: csrc/flash_attn.cu FA_C
_KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def causal_flash_attention_plain(q, k, v, pos, scale: float | None = None,
                                 logit_softcap: float = 0.0,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch K2: the kernel's math on the materialized score matrix
    (f32; int8 K/V scale the score columns and P; l == 0 → 0)."""
    B, H, N, D = q.shape
    KVH, M = k.shape[1], k.shape[2]
    G = H // KVH
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    pos = _pos(pos, B, q.device)
    qg = q.float().reshape(B, KVH, G * N, D)
    s = qg @ k.float().transpose(-1, -2)                 # (B, KVH, G*N, M)
    if k_scale is not None:
        s = s * k_scale.float()[:, :, None, :]
    s = s * _f32(scale)
    if logit_softcap:
        s = torch.tanh(s * _f32(1.0 / logit_softcap)) * _f32(logit_softcap)
    qpos = pos[:, None] + torch.arange(G * N, device=q.device) % N   # (B, G*N)
    cols = torch.arange(M, device=q.device)
    s = torch.where(cols[None, None, None, :] <= qpos[:, None, :, None], s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, :]
    o = (p @ v.float()) / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, H, N, D).to(q.dtype)


def _pos(pos, b, device):
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device).reshape(-1)
    return pos.expand(b).contiguous() if pos.numel() == 1 else pos


def _slab_strides(t, name):
    """(B, KVH, M[, D]) view → stride between (b, kvh) slabs; each slab must
    be contiguous and the batch stride KVH slabs wide."""
    inner = t.shape[2] * (t.shape[3] if t.dim() == 4 else 1)
    contiguous_slab = (t.stride(-1) == 1 and
                       (t.dim() == 3 or t.stride(2) == t.shape[3]))
    if not contiguous_slab or t.stride(0) != t.shape[1] * t.stride(1) \
            or t.stride(1) < inner:
        raise ValueError(f"{name}: strides {t.stride()} are not (b, kvh) slabs "
                         "of contiguous rows")
    return t.stride(1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(blocks: int, nchunk: int, sms: int) -> int:
    """Chunk ranges per row tile: 1 when the (batch·KV head, row tile)
    blocks alone give two per SM, else enough for about eight per SM, at
    most one per chunk. No bit depends on it."""
    if blocks >= 2 * sms:
        return 1
    return max(1, min(nchunk, -(-8 * sms // blocks)))


def _kernel_operands(q, k, v, kv_stride):
    """q as contiguous f32 and K/V as the kernel reads them: D · element
    size a multiple of 16 bytes and 16-byte aligned slabs. Otherwise K/V
    are copied, with D zero-padded to that multiple where it falls short
    (zeros add nothing to a dot and the output is cut back)."""
    es = k.element_size()
    D = q.shape[-1]
    dp = -(-D // (16 // es)) * (16 // es)
    qf = q.float().contiguous()
    if dp == D and (kv_stride * es) % 16 == 0 and k.data_ptr() % 16 == 0 \
            and v.data_ptr() % 16 == 0:
        return qf, k, v, kv_stride, D
    if dp > D:
        pad = (0, dp - D)
        k, v, qf = F.pad(k, pad), F.pad(v, pad), F.pad(qf, pad)
    else:
        k, v = (t.clone(memory_format=torch.contiguous_format) for t in (k, v))
    return qf, k, v, k.stride(1), dp


def causal_flash_attention(q, k, v, pos, scale: float | None = None,
                           logit_softcap: float = 0.0, k_scale=None,
                           v_scale=None, *, _split: int | None = None):
    """softmax(q·kᵀ·scale + causal mask)·v with online softmax.

    q (B, H, N, D); k/v (B, KVH, M, D) f32/bf16, or int8 with k_scale/v_scale
    (B, KVH, M) f32. pos (B,) int32 or scalar: the absolute position of each
    batch's first query row; query row n attends to cache positions ≤ pos+n.
    Returns (B, H, N, D) in q.dtype. `_split` forces the number of chunk
    ranges per row tile (checks only; the result's bits do not depend on
    it)."""
    B, H, N, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not fit")
    if (k_scale is None) != (k.dtype != torch.int8) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V need k_scale and v_scale; float K/V take none")
    if not q.is_cuda:
        return causal_flash_attention_plain(q, k, v, pos, scale, logit_softcap,
                                            k_scale, v_scale)
    KVH, M = k.shape[1], k.shape[2]
    if D > MAX_D:
        raise ValueError(f"head_dim {D} > {MAX_D} is not supported by the kernel")
    if k.dtype not in _KV_TYPES or v.dtype != k.dtype:
        raise ValueError(f"K/V dtype {k.dtype}/{v.dtype} not supported")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q on the card, K/V not")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    kv_stride = _slab_strides(k, "k")
    if _slab_strides(v, "v") != kv_stride:
        raise ValueError("k and v strides differ")
    sc_stride = 0
    kd_ptr = vd_ptr = None
    if k_scale is not None:
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 \
                or tuple(k_scale.shape) != (B, KVH, M) or k_scale.shape != v_scale.shape:
            raise ValueError("k_scale/v_scale must be (B, KVH, M) f32")
        sc_stride = _slab_strides(k_scale, "k_scale")
        if _slab_strides(v_scale, "v_scale") != sc_stride:
            raise ValueError("k_scale and v_scale strides differ")
        kd_ptr, vd_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    qf, k, v, kv_stride, dk = _kernel_operands(q, k, v, kv_stride)
    posd = _pos(pos, B, q.device)
    out = torch.empty((B, H, N, dk), dtype=torch.float32, device=q.device)
    rows = N * (H // KVH)
    nchunk = -(-M // CHUNK)
    blocks = B * KVH * -(-rows // (4 if rows <= 4 else 16))
    split = splits(blocks, nchunk, _sm_count(q.device.index or 0)) if _split is None \
        else max(1, min(int(_split), nchunk))
    part = (torch.empty(B * KVH * rows * nchunk * (dk + 2), dtype=torch.float32,
                        device=q.device) if split > 1 else None)
    softcap = float(logit_softcap)
    build.call("flash_attn_fwd", qf.data_ptr(), k.data_ptr(), v.data_ptr(),
               kd_ptr, vd_ptr, posd.data_ptr(), out.data_ptr(),
               None if part is None else part.data_ptr(),
               B, H, KVH, N, M, dk, kv_stride, sc_stride,
               _f32(scale), _f32(softcap), _f32(1.0 / softcap) if softcap else 0.0,
               _KV_TYPES[k.dtype], split, torch.cuda.current_stream(q.device).cuda_stream)
    K2.launches += 1
    if dk != D:
        out = out[..., :D].contiguous()
    return out.to(q.dtype)
