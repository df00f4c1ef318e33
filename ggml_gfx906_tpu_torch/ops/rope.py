"""Rotary position embedding with ggml's parameter surface (the
counterpart of ggml_gfx906_tpu/ops/rope.py: rope_ext :81-127 and
rope_multi :130-192).

ref: ggml_rope_ext (include/ggml.h:1645-1740), CPU kernel
src/ggml-cpu/ops.cpp:6049-6330, YaRN correction dims src/ggml.c:4083-4098.

Modes: NORMAL rotates adjacent pairs (x[2i], x[2i+1]); NEOX rotates
half-split pairs (x[i], x[i + n_dims/2]). Dims beyond n_dims pass through.
The per-pair frequencies freq_base^(-2i/n_dims) are an f32 power, computed
as the reference computes them (numpy f32 on the host, not float64), once
per parameter set and device (`_rope_tables`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

ROPE_TYPE_NORMAL = 0
ROPE_TYPE_NEOX = 2
ROPE_TYPE_MROPE = 8    # multimodal (t/h/w/e position streams)
ROPE_TYPE_VISION = 24  # mrope + per-section theta reset + half-dim pairs


def yarn_corr_dims(n_dims: int, n_ctx_orig: int, freq_base: float,
                   beta_fast: float, beta_slow: float) -> tuple[float, float]:
    """ref: ggml_rope_yarn_corr_dims src/ggml.c:4088-4098."""

    def corr_dim(n_rot):
        return n_dims * math.log(n_ctx_orig / (n_rot * 2 * math.pi)) / (
            2 * math.log(freq_base))

    start = math.floor(corr_dim(beta_fast))
    end = math.ceil(corr_dim(beta_slow))
    return max(0.0, start), min(n_dims - 1.0, end)


@functools.lru_cache(maxsize=None)
def _rope_tables(n_dims, freq_base, ext_factor, beta_fast, beta_slow, n_ctx_orig,
                 device):
    """(theta_pow (n_dims/2,), YaRN ramp (n_dims/2,) or None) on `device`,
    built once per parameter set and device: a decode step reads them in
    every layer, and a host→device copy there would cost every step a
    transfer (and cannot be captured in a CUDA graph)."""
    half = n_dims // 2
    pair_idx = np.arange(half)
    theta_pow = _theta_pow(pair_idx, n_dims, freq_base)
    theta_pow = torch.from_numpy(theta_pow).to(device)
    if ext_factor == 0.0:
        return theta_pow, None
    ramp = _yarn_ramp(pair_idx, n_dims, freq_base, ext_factor, beta_fast, beta_slow,
                      n_ctx_orig)
    return theta_pow, torch.from_numpy(ramp).to(device)


def _theta_pow(expo: np.ndarray, n_dims: int, freq_base) -> np.ndarray:
    """freq_base^(-2·expo/n_dims), an f32 power on the host."""
    return np.ascontiguousarray(np.float32(freq_base) ** (
        -2.0 * expo.astype(np.float32) / n_dims), np.float32)


def _yarn_ramp(pair_idx: np.ndarray, n_dims: int, freq_base, ext_factor, beta_fast,
               beta_slow, n_ctx_orig) -> np.ndarray:
    """YaRN's per-pair extrapolation weight (f32, reference :51-54): pairs
    are indexed by their place in the head, whatever theta stream they
    read (rope_multi's sectors)."""
    low, high = yarn_corr_dims(n_dims, n_ctx_orig, freq_base, beta_fast, beta_slow)
    ramp_y = (pair_idx.astype(np.float32) - low) / max(0.001, high - low)
    return np.ascontiguousarray(
        (1.0 - np.clip(ramp_y.astype(np.float32), 0.0, 1.0)) * ext_factor, np.float32)


def _rope_cos_sin(pos, n_dims, freq_base, freq_scale, ext_factor, attn_factor,
                  beta_fast, beta_slow, n_ctx_orig):
    theta_pow, ramp = _rope_tables(n_dims, float(freq_base), float(ext_factor),
                                   float(beta_fast), float(beta_slow), int(n_ctx_orig),
                                   pos.device)
    return _yarn_cos_sin(pos.float()[..., None] * theta_pow, ramp, freq_scale, attn_factor)


def _yarn_cos_sin(theta_extrap, ramp, freq_scale, attn_factor):
    """rope_yarn on an extrapolation theta per pair (ref _yarn_cos_sin
    :37-66); ramp None without YaRN."""
    theta_interp = float(freq_scale) * theta_extrap
    mscale = np.float32(attn_factor)
    if ramp is not None:
        theta = theta_interp * (1 - ramp) + theta_extrap * ramp
        mscale = np.float32(mscale * np.float32(1.0 + 0.1 * math.log(1.0 / freq_scale)))
    else:
        theta = theta_interp
    return torch.cos(theta) * float(mscale), torch.sin(theta) * float(mscale)


def rope_ext(x, pos, n_dims: int, mode: int = ROPE_TYPE_NORMAL,
             freq_base: float = 10000.0, freq_scale: float = 1.0,
             ext_factor: float = 0.0, attn_factor: float = 1.0,
             beta_fast: float = 32.0, beta_slow: float = 1.0,
             n_ctx_orig: int = 0):
    """x: (..., n_seq, n_head, head_dim) — pos (int tensor) indexes the
    n_seq axis (-3). Returns x with the first n_dims of head_dim rotated.
    The reference's freq_factors and rope_back (forward=False) are not
    ported."""
    head_dim = x.shape[-1]
    if n_dims % 2 or n_dims > head_dim:
        raise ValueError(f"n_dims {n_dims} must be even and <= {head_dim}")
    n_ctx_orig = n_ctx_orig or 0
    if ext_factor != 0.0 and n_ctx_orig <= 0:
        raise ValueError("YaRN needs n_ctx_orig")
    cos, sin = _rope_cos_sin(pos, n_dims, freq_base, freq_scale, ext_factor,
                             attn_factor, beta_fast, beta_slow,
                             max(n_ctx_orig, 1))
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    xf = x.float()
    rot, rest = xf[..., :n_dims], xf[..., n_dims:]
    if mode & ROPE_TYPE_NEOX:
        h = n_dims // 2
        x0, x1 = rot[..., :h], rot[..., h:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        x0, x1 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                          dim=-1).reshape(rot.shape)
    return torch.cat([out, rest], dim=-1).to(x.dtype)


def rope_multi(x, pos, n_dims: int, sections, mode: int = ROPE_TYPE_MROPE,
               freq_base: float = 10000.0, freq_scale: float = 1.0,
               ext_factor: float = 0.0, attn_factor: float = 1.0,
               beta_fast: float = 32.0, beta_slow: float = 1.0,
               n_ctx_orig: int = 0, freq_factors=None, forward: bool = True):
    """Multimodal RoPE — ggml_rope_multi (include/ggml.h:1660; CPU kernel
    ggml_mrope_cache_init, src/ggml-cpu/ops.cpp:6089-6146).

    x: (..., n_seq, n_head, head_dim); pos (4, n_seq) int — the t/h/w/e
    position streams. sections[4] split the dim pairs cyclically into
    sectors; each sector's theta uses its stream's position. All four theta
    streams advance by theta_scale every pair; VISION mode also resets a
    stream at its sector start and rotates half-split pairs (i, i + n_dims)
    with n_dims == head_dim // 2 covering the whole head. freq_factors
    (per pair) divide theta; forward=False rotates back."""
    vision = mode == ROPE_TYPE_VISION
    head_dim = x.shape[-1]
    if pos.shape[0] != 4:
        raise ValueError(f"pos must hold 4 position streams, got {tuple(pos.shape)}")
    sections = list(sections)
    if len(sections) != 4 or sum(sections[:3]) <= 0:
        raise ValueError(f"bad sections {sections}")
    P = n_dims if vision else n_dims // 2   # rotated pairs
    if vision and n_dims != head_dim // 2:
        raise ValueError(f"vision mode needs n_dims == head_dim // 2, got {n_dims}, {head_dim}")

    cum = np.cumsum(sections)
    starts = np.concatenate([[0], cum[:-1]])
    ic = np.arange(P)
    sector = ic % sum(sections)
    kind = np.searchsorted(cum, sector, side="right")      # 0..3 per pair
    # pairs advance theta_scale per step from the stream base; vision
    # resets the stream at each sector start
    expo = sector - starts[kind] if vision else ic
    dev = x.device
    scale_pow = torch.from_numpy(_theta_pow(expo, n_dims, freq_base)).to(dev)
    psel = torch.as_tensor(pos, device=dev)[torch.from_numpy(kind).to(dev)]  # (P, n_seq)
    theta_extrap = psel.T.float() * scale_pow                                # (n_seq, P)
    if freq_factors is not None:
        ff = torch.as_tensor(freq_factors, dtype=torch.float32, device=dev)
        theta_extrap = theta_extrap / ff[torch.from_numpy(ic).to(dev)]
    ramp = None
    if ext_factor != 0.0:
        ramp = torch.from_numpy(_yarn_ramp(ic, n_dims, freq_base, ext_factor, beta_fast,
                                           beta_slow, max(n_ctx_orig or 0, 1))).to(dev)
    cos, sin = _yarn_cos_sin(theta_extrap, ramp, freq_scale, attn_factor)
    if not forward:
        sin = -sin
    cos, sin = cos[..., None, :], sin[..., None, :]      # head axis
    xf = x.float()
    rot, rest = xf[..., :2 * P], xf[..., 2 * P:]
    x0, x1 = rot[..., :P], rot[..., P:]
    out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return torch.cat([out, rest], dim=-1).to(x.dtype)
