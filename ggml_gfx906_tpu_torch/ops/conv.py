"""Convolution, pooling, resampling, SAM's window ops and the Mamba SSM ops
— the port of ggml_gfx906_tpu/ops/conv.py, name for name.

ref: include/ggml.h conv ops :1775-2010; CPU kernels
src/ggml-cpu/ops.cpp im2col/conv/pool; CUDA src/ggml-cuda/{im2col,
conv2d-dw,conv-transpose-1d,pool2d}.cu.

Layouts follow ggml's numpy-order shapes: 1d data (N, C, L), 2d data
(N, C, H, W); 1d kernels (OC, IC, K), 2d kernels (OC, IC, KH, KW); the
transpose convolutions keep torch's (IC, OC, K...) weight layout.

The convolutions run through F.conv*d / F.conv_transpose*d (cuDNN on the
card) in full f32, as the reference's HIGHEST-precision convolutions do:
cuDNN rounds f32 operands through TF32 unless told not to, and its
process-wide flag allows that by default, so each convolution turns it off
around its own call (`_f32_convs`) whatever the caller set.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def _tup(v, n: int) -> tuple:
    return (v,) * n if isinstance(v, int) else tuple(v)


@contextlib.contextmanager
def _f32_convs():
    """cuDNN's TF32 flag off for the enclosed convolutions, restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d}


def _conv(x, w, stride, padding, dilation, groups: int = 1):
    dims = x.ndim - 2
    with _f32_convs():
        return _CONV[dims](x.float(), w.float(), stride=_tup(stride, dims),
                           padding=_tup(padding, dims), dilation=_tup(dilation, dims),
                           groups=groups)


def conv_1d(x, w, stride: int = 1, padding: int = 0, dilation: int = 1):
    """ggml_conv_1d: x (N, C, L), w (OC, IC, K) → (N, OC, L_out)."""
    return _conv(x, w, stride, padding, dilation)


def conv_1d_dw(x, w, stride: int = 1, padding: int = 0, dilation: int = 1):
    """depthwise: w (C, 1, K)."""
    return _conv(x, w, stride, padding, dilation, groups=x.shape[1])


def conv_2d(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """ggml_conv_2d: x (N, C, H, W), w (OC, IC, KH, KW)."""
    return _conv(x, w, stride, padding, dilation)


def conv_3d(x, w, stride=(1, 1, 1), padding=(0, 0, 0), dilation=(1, 1, 1)):
    """ggml_conv_3d (include/ggml.h:1866): x (N, C, D, H, W),
    w (OC, IC, KD, KH, KW) → (N, OC, D_out, H_out, W_out)."""
    return _conv(x, w, stride, padding, dilation)


def conv_2d_dw(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """depthwise 2d: w (C, 1, KH, KW)."""
    return _conv(x, w, stride, padding, dilation, groups=x.shape[1])


def _conv_t(x, w, stride, dilation=1):
    """The full transposed convolution. Where the dilated kernel is shorter
    than the stride, the reference's output (lax.conv_transpose, VALID) is
    in·s long, stride - kernel more than torch's (in-1)·s + kernel: the
    missing tail is zeros, appended here."""
    dims = x.ndim - 2
    s, d = _tup(stride, dims), _tup(dilation, dims)
    with _f32_convs():
        out = _CONV_T[dims](x.float(), w.float(), stride=s, dilation=d)
    tail = [max(s[i] - ((w.shape[2 + i] - 1) * d[i] + 1), 0) for i in range(dims)]
    if any(tail):
        out = F.pad(out, [p for t in reversed(tail) for p in (0, t)])
    return out


def conv_transpose_1d(x, w, stride: int = 1, padding: int = 0, dilation: int = 1):
    """ggml_conv_transpose_1d: x (N, C, L), w (IC, OC, K); the full output
    of length (L-1)*s + (K-1)*d + 1, cropped by `padding` at both ends."""
    out = _conv_t(x, w, stride, dilation)
    if padding:
        out = out[..., padding:-padding]
    return out


def conv_transpose_2d(x, w, stride: int = 1):
    """ggml_conv_transpose_2d_p0: w (IC, OC, KH, KW)."""
    return _conv_t(x, w, stride)


def im2col(x, kh: int, kw: int, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    """GGML_OP_IM2COL (2d): x (N, C, H, W) → (N, OH, OW, C*KH*KW) with
    ggml's column order (c, kh, kw), fastest last."""
    s, p, d = _tup(stride, 2), _tup(padding, 2), _tup(dilation, 2)
    n, c, h, w = x.shape
    xp = F.pad(x, (p[1], p[1], p[0], p[0]))
    oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    dev = x.device
    i = (torch.arange(oh, device=dev) * s[0])[:, None] + (torch.arange(kh, device=dev) * d[0])[None, :]
    j = (torch.arange(ow, device=dev) * s[1])[:, None] + (torch.arange(kw, device=dev) * d[1])[None, :]
    patches = xp[:, :, i[:, None, :, None], j[None, :, None, :]]   # (n, c, oh, ow, kh, kw)
    return patches.permute(0, 2, 3, 1, 4, 5).reshape(n, oh, ow, c * kh * kw)


def pool_1d(x, op: str, k: int, stride: int, padding: int = 0):
    return pool_2d(x[..., None, :], op, (1, k), (1, stride), (0, padding))[..., 0, :]


def pool_2d(x, op: str, k=(2, 2), stride=(2, 2), padding=(0, 0)):
    """GGML_OP_POOL_2D: x (N, C, H, W); op in {"max", "avg"}. max pads
    with -inf; avg pads with zeros and divides by kh*kw (count_include_pad,
    as the reference does)."""
    kh, kw = _tup(k, 2)
    sh, sw = _tup(stride, 2)
    ph, pw = _tup(padding, 2)
    xf = x.float()
    if op == "max":
        xp = F.pad(xf, (pw, pw, ph, ph), value=float("-inf"))
        return F.max_pool2d(xp, (kh, kw), (sh, sw))
    if op == "avg":
        xp = F.pad(xf, (pw, pw, ph, ph))
        return F.avg_pool2d(xp, (kh, kw), (sh, sw))
    raise ValueError(op)


def upscale_nearest(x, scale_h: int, scale_w: int):
    """GGML_OP_UPSCALE nearest mode: x (N, C, H, W)."""
    return x.repeat_interleave(scale_h, dim=-2).repeat_interleave(scale_w, dim=-1)


def interpolate_bilinear(x, out_h: int, out_w: int, align_corners: bool = False):
    """GGML_OP_UPSCALE bilinear mode (ref: ggml_interpolate), the
    reference's four-corner formula in its order."""
    n, c, h, w = x.shape
    dev = x.device
    if align_corners and out_h > 1 and out_w > 1:
        ys = torch.linspace(0.0, h - 1.0, out_h, device=dev)
        xs = torch.linspace(0.0, w - 1.0, out_w, device=dev)
    else:
        ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (h / out_h) - 0.5
        xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (w / out_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[None, None, :, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, None, None, :]
    xf = x.float()
    a = xf[:, :, y0][:, :, :, x0]
    b = xf[:, :, y0][:, :, :, x1]
    cq = xf[:, :, y1][:, :, :, x0]
    d = xf[:, :, y1][:, :, :, x1]
    return (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
            + cq * wy * (1 - wx) + d * wy * wx)


# ---------------------------------------------------------------- SAM window ops
# ref: ggml_win_part / ggml_win_unpart / get_rel_pos / add_rel_pos
# (include/ggml.h:2180-2230, used by examples/sam/sam.cpp)

def win_part(x, w: int):
    """x (B, H, W, C) → (B*nWh*nWw, w, w, C) with zero padding."""
    b, h, ww, c = x.shape
    ph, pw = (-h) % w, (-ww) % w
    xp = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, ww + pw
    xp = xp.reshape(b, hp // w, w, wp // w, w, c)
    return xp.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def win_unpart(x, h: int, ww: int, w: int):
    hp, wp = h + (-h) % w, ww + (-ww) % w
    b = x.shape[0] // ((hp // w) * (wp // w))
    c = x.shape[-1]
    xp = x.reshape(b, hp // w, wp // w, w, w, c)
    xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return xp[:, :h, :ww, :]


def get_rel_pos(rel_pos, qh: int, kh: int):
    """ref: ggml_get_rel_pos — the relative-position embeddings of query
    and key sizes. rel_pos: (2*max-1, C) → (qh, kh, C)."""
    dev = rel_pos.device
    idx = (torch.arange(qh, device=dev)[:, None] - torch.arange(kh, device=dev)[None, :]
           + (kh - 1))
    return rel_pos[idx]


def add_rel_pos(attn, rel_w, rel_h, qh: int, qw: int, kh: int, kw: int):
    """ref: ggml_add_rel_pos — attn (..., qh*qw, kh*kw) plus decomposed
    relative position terms rel_h (..., qh*qw, kh) and rel_w (..., qh*qw, kw)."""
    pre = attn.shape[:-2]
    a = attn.reshape(*pre, qh, qw, kh, kw)
    a = a + rel_h.reshape(*pre, qh, qw, kh, 1) + rel_w.reshape(*pre, qh, qw, 1, kw)
    return a.reshape(attn.shape)


# ---------------------------------------------------------------- SSM (Mamba)

def ssm_conv(x, c):
    """GGML_OP_SSM_CONV: causal depthwise conv over a pre-windowed input.
    x (B, C_in, L + K - 1), c (C_in, K) → (B, C_in, L)."""
    k = c.shape[-1]
    l = x.shape[-1] - k + 1
    i = torch.arange(l, device=x.device)[:, None] + torch.arange(k, device=x.device)[None, :]
    win = x[..., i]  # (B, C, L, K)
    return (win.float() * c.float()[None, :, None, :]).sum(-1)


def ssm_scan(s, x, dt, A, B, C):
    """GGML_OP_SSM_SCAN (Mamba selective scan, ref src/ggml-cpu/ops.cpp
    ssm_scan): sequential state update
        s_t = s_{t-1} * exp(dt_t * A) + B_t * (dt_t * x_t)
        y_t = C_t · s_t
    s: (B, D, N) initial state; x: (B, L, D); dt: (B, L, D) before its
    softplus; A: (D, N); B, C: (B, L, N). Returns (y (B, L, D), s_final).
    A loop over L, where the reference runs lax.scan."""
    dtf = dt.float()
    dtf = torch.logaddexp(dtf, torch.zeros_like(dtf))     # softplus, as jax.nn's
    A = A.float()
    x, B, C = x.float(), B.float(), C.float()
    state = s.float()
    ys = []
    for t in range(x.shape[1]):
        dtt = dtf[:, t]
        dA = torch.exp(dtt[..., None] * A[None])            # (B, D, N)
        dBx = B[:, t, None, :] * (dtt * x[:, t])[..., None]  # (B, D, N)
        state = state * dA + dBx
        ys.append((state * C[:, t, None, :]).sum(-1))       # (B, D)
    return torch.stack(ys, dim=1), state
