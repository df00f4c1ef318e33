"""Core op surface: elementwise, unary, GLU, norms, softmax, rows, shapes,
reductions — the port of ggml_gfx906_tpu/ops/basic.py, name for name.

Arrays use numpy/C axis order (the last axis is ggml's ne0). Every
reduction over a row (the norms' means, softmax denominators, sum_rows,
mean, l2_norm, the losses) goes through `row_sum`, whose order of
additions depends only on the row length: a row keeps its bits alone or
inside a batch, on which the engine-vs-generate stream equality rests.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by pairwise halving (zero-padded to a power
    of two), keepdim. The order of additions depends only on the row
    length, never on how many rows there are or on the device's reduction
    heuristics, so a row gives the same bits alone or inside a batch — the
    engine-vs-generate stream equality relies on it."""
    n = x.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    return row_sum(x) / x.shape[-1]


# ---------------------------------------------------------------- unary
# (reference :14-101; ggml's unary-ops.cpp)

GELU_COEF_A = 0.044715
GELU_QUICK_COEF = -1.702
SQRT_2_OVER_PI = 0.79788456080286535587989211986876


def gelu(x):
    """tanh-approximated gelu, ggml's default, in the reference's own
    formula and order (f32)."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(SQRT_2_OVER_PI * xf * (1.0 + GELU_COEF_A * xf * xf)))
    return y.to(x.dtype)


def gelu_erf(x):
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def gelu_quick(x):
    xf = x.float()
    return (xf * torch.sigmoid(-GELU_QUICK_COEF * xf)).to(x.dtype)


def silu(x):
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def relu(x):
    return torch.clamp_min(x, 0)


def leaky_relu(x, negative_slope: float = 0.1):
    return torch.where(x > 0, x, x * negative_slope)


def elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


def sigmoid(x):
    return torch.sigmoid(x)


def hardswish(x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hardsigmoid(x):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def step(x):
    return (x > 0).to(x.dtype)


def abs_(x):
    return torch.abs(x)


def sgn(x):
    return torch.sign(x)


def neg(x):
    return -x


def tanh(x):
    return torch.tanh(x)


def exp(x):
    return torch.exp(x)


UNARY = {
    "abs": abs_, "sgn": sgn, "neg": neg, "step": step, "tanh": tanh,
    "elu": elu, "relu": relu, "sigmoid": sigmoid, "gelu": gelu,
    "gelu_quick": gelu_quick, "silu": silu, "hardswish": hardswish,
    "hardsigmoid": hardsigmoid, "exp": exp, "gelu_erf": gelu_erf,
}


# ---------------------------------------------------------------- GLU
# the last axis split in half (or a second tensor b): act(a) * g

def _glu(x, act, b=None, swapped: bool = False):
    a, g = torch.chunk(x, 2, dim=-1) if b is None else (x, b)
    if swapped:
        a, g = g, a
    return act(a) * g


def reglu(x, b=None, swapped=False):
    return _glu(x, relu, b, swapped)


def geglu(x, b=None, swapped=False):
    return _glu(x, gelu, b, swapped)


def swiglu(x, b=None, swapped=False):
    return _glu(x, silu, b, swapped)


def geglu_erf(x, b=None, swapped=False):
    return _glu(x, gelu_erf, b, swapped)


def geglu_quick(x, b=None, swapped=False):
    return _glu(x, gelu_quick, b, swapped)


def swiglu_oai(x, b=None, alpha: float = 1.702, limit: float = 7.0):
    """ggml_swiglu_oai, the clamped variant of gpt-oss."""
    a, g = torch.chunk(x, 2, dim=-1) if b is None else (x, b)
    a = torch.clamp_max(a, limit)
    g = torch.clamp(g, -limit, limit)
    return a * torch.sigmoid(alpha * a) * (g + 1.0)


# ---------------------------------------------------------------- norms

def norm(x, eps: float = 1e-5):
    """LayerNorm without affine parameters (GGML_OP_NORM)."""
    xf = x.float()
    xc = xf - _row_mean(xf)
    var = _row_mean(xc * xc)
    return (xc * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = row_sum(xf * xf) / xf.shape[-1]
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


def group_norm(x, n_groups: int, eps: float = 1e-6):
    """GGML_OP_GROUP_NORM over (channels in the group, spatial), channels
    on axis 1 as in ggml's conv layout (N, C, H, W)."""
    xf = x.reshape(x.shape[0], n_groups, -1).float()
    xc = xf - _row_mean(xf)
    var = _row_mean(xc * xc)
    return (xc * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)


def l2_norm(x, eps: float = 1e-12):
    xf = x.float()
    ss = row_sum(xf * xf)
    return (xf * torch.rsqrt(torch.clamp_min(ss, eps))).to(x.dtype)


# ---------------------------------------------------------------- softmax

def alibi_slopes(n_head: int, max_bias: float, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes (f32), ones when max_bias <= 0 (reference
    :189-202, ggml's soft_max)."""
    if max_bias <= 0.0:
        return torch.ones(n_head, dtype=torch.float32, device=device)
    n_head_log2 = 1 << int(math.floor(math.log2(n_head)))
    m0 = torch.tensor(2.0 ** (-max_bias / n_head_log2), dtype=torch.float32, device=device)
    m1 = torch.tensor(2.0 ** (-max_bias / 2.0 / n_head_log2), dtype=torch.float32,
                      device=device)
    h = torch.arange(n_head, device=device)
    return torch.where(h < n_head_log2, m0 ** (h + 1).float(),
                       m1 ** (2 * (h - n_head_log2) + 1).float())


def soft_max_ext(x, mask=None, scale: float = 1.0, max_bias: float = 0.0, sinks=None):
    """GGML_OP_SOFT_MAX with mask, ALiBi and attention sinks: x (...,
    n_head, n_rows, n_cols); the mask broadcasts over heads; a sink is a
    per-head logit in the denominator only."""
    xf = x.float() * scale
    if mask is not None:
        n_head = x.shape[-3]
        slope = alibi_slopes(n_head, max_bias, x.device).reshape(n_head, 1, 1)
        xf = xf + slope * mask.float()
    m = xf.amax(-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(-1, 1, 1)
        m = torch.maximum(m, sk)
    e = torch.exp(xf - m)
    denom = row_sum(e)
    if sinks is not None:
        denom = denom + torch.exp(sk - m)
    return (e / denom).to(x.dtype)


def soft_max(x):
    return soft_max_ext(x)


def diag_mask_inf(x, n_past: int = 0):
    """Entries with col > n_past + row set to -inf (GGML_OP_DIAG_MASK_INF)."""
    n_rows, n_cols = x.shape[-2], x.shape[-1]
    keep = (torch.arange(n_cols, device=x.device)[None, :]
            <= torch.arange(n_rows, device=x.device)[:, None] + n_past)
    return torch.where(keep, x, torch.full_like(x, float("-inf")))


def causal_mask(n_rows: int, n_cols: int, n_past: int = 0, dtype=torch.float32,
                device=None):
    """Additive causal mask (0 / -inf), as fed to soft_max_ext."""
    keep = (torch.arange(n_cols, device=device)[None, :]
            <= torch.arange(n_rows, device=device)[:, None] + n_past)
    return torch.where(keep, 0.0, float("-inf")).to(dtype)


# ---------------------------------------------------------------- rows / indexing

def get_rows(x, ids):
    """GGML_OP_GET_ROWS: rows of x (..., R, C) gathered along axis -2."""
    return x[..., ids, :]


def set_rows(x, rows, ids):
    """GGML_OP_SET_ROWS: a copy of x with rows written at `ids`."""
    out = x.clone()
    out[..., ids, :] = rows.to(x.dtype)
    return out


def argsort(x, descending: bool = False):
    """Stable ascending argsort; descending flips it, as the reference's does
    (so equal values come last index first)."""
    order = torch.argsort(x, dim=-1, stable=True)
    return torch.flip(order, (-1,)) if descending else order


def top_k(x, k: int):
    """(values, indices) of the k largest per row, equal values lower index
    first as jax.lax.top_k breaks ties (a stable descending sort:
    torch.topk does not promise the order). Unlike jax, -0 and +0 are
    equal here."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def argmax(x):
    return torch.argmax(x, dim=-1)


def count_equal(a, b):
    return (a == b).sum()


# ---------------------------------------------------------------- shapes / data movement

def concat(a, b, axis: int = -1):
    return torch.cat([a, b], dim=axis)


def repeat(x, target_shape):
    """GGML_OP_REPEAT: x tiled up to target_shape."""
    return x.repeat(*(t // s for t, s in zip(target_shape, x.shape)))


def pad(x, paddings):
    """GGML_OP_PAD: zero padding, paddings = [(lo, hi), ...] per axis."""
    flat = [v for lo_hi in reversed(list(paddings)) for v in lo_hi]
    return F.pad(x, flat)


def pad_reflect_1d(x, p0: int, p1: int):
    left = x[..., 1:p0 + 1].flip(-1)
    right = x[..., x.shape[-1] - 1 - p1:x.shape[-1] - 1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def roll(x, shifts, axes):
    return torch.roll(x, shifts, axes)


def arange(start: float, stop: float, step: float):
    return torch.arange(start, stop, step, dtype=torch.float32)


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """GGML_OP_TIMESTEP_EMBEDDING: the sinusoidal embedding, (N,) → (N, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def scale(x, s: float, bias: float = 0.0):
    """GGML_OP_SCALE (with its bias parameter)."""
    return x * s + bias


def clamp(x, lo: float, hi: float):
    return torch.clamp(x, lo, hi)


def add1(x, y):
    return x + y.reshape(())


def acc(x, src, offset_elems: int, target_shape=None):
    """GGML_OP_ACC: src added into a flattened-offset view of a copy of x."""
    flat = x.reshape(-1).clone()
    s = src.reshape(-1)
    flat[offset_elems:offset_elems + s.numel()] += s
    return flat.reshape(x.shape)


def out_prod(a, b):
    """GGML_OP_OUT_PROD: a (..., n, m), b (..., n, p) → (..., p, m) = bᵀ·a
    per batch in f32; a's leading dims broadcast up to b's multiples."""
    a, b = a.float(), b.float()
    if a.dim() > 2 and b.dim() == a.dim() and a.shape[:-2] != b.shape[:-2]:
        for ax, (bs, as_) in enumerate(zip(b.shape[:-2], a.shape[:-2])):
            if bs // as_ > 1:
                a = a.repeat_interleave(bs // as_, dim=ax)
    return torch.einsum("...nm,...np->...pm", a, b)


# ---------------------------------------------------------------- reductions

def sum_(x):
    return row_sum(x.reshape(-1))[0]


def sum_rows(x):
    return row_sum(x)


def mean(x):
    return _row_mean(x)


# ---------------------------------------------------------------- losses

def cross_entropy_loss(logits, labels):
    """GGML_OP_CROSS_ENTROPY_LOSS: the mean over rows of -Σ label·log_softmax
    (labels are probabilities)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    n_rows = logits.numel() // logits.shape[-1]
    return -row_sum((labels.float() * lsm).reshape(-1))[0] / n_rows


# ---------------------------------------------------------------- misc model ops

def embedding(table, ids):
    return get_rows(table, ids)


def softcap(x, s: float):
    """tanh softcap: tanh(x / s) · s."""
    return torch.tanh(x * (1.0 / s)) * s
