"""Pieces the plain references share: float32 products with TF32 off, an
optional float8 (e4m3, per-row scale) rounding of every product's operands
(the control that `correct` must refuse), causal attention per sequence,
the norms and NeoX rotary embedding, and the logit-gap reading."""
from __future__ import annotations

import torch

F8_MAX = 448.0


def no_tf32():
    """Full float32 products (the card would otherwise take TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale per row (last axis), back in f32."""
    s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Arith:
    """The arithmetic of one reference run: f32, or f32 on operands rounded
    to float8 (`low=True`)."""

    def __init__(self, low: bool = False):
        self.low = low

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return f8(t) if self.low else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (N, K).T in f32."""
        return self.op(x) @ self.op(w).T

    def attend(self, q, k, v, scale: float) -> torch.Tensor:
        """Causal attention of one sequence: q (S, H, D), k and v (S, KVH, D)
        → (S, H·D); head h reads KV head h // (H / KVH)."""
        S, H, D = q.shape
        g = H // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", self.op(q), self.op(k)) * scale
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        return torch.einsum("hqk,khd->qhd", self.op(p), self.op(v)).reshape(S, H * D)


def rms_norm(x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)


def layer_norm(x, g, b, eps):
    xc = x - x.mean(-1, keepdim=True)
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * g + b


def rope_neox(x: torch.Tensor, pos: torch.Tensor, base: float) -> torch.Tensor:
    """NeoX rotary embedding over the whole head: x (S, H, D), pair (i, i +
    D/2) turned by pos · base^(-2i/D)."""
    D = x.shape[-1]
    half = D // 2
    inv = base ** (-torch.arange(half, dtype=torch.float64, device=x.device) * 2 / D)
    th = pos.double()[:, None] * inv[None]
    cos, sin = th.cos().float()[:, None], th.sin().float()[:, None]
    x0, x1 = x[..., :half], x[..., half:]
    return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))


def scored_rows(seqs) -> tuple[list[int], list[int]]:
    """For (prompt, served) pairs: the row of the concatenated sequences
    (prompt + served[:-1]) whose logits predict each served token, and that
    token."""
    rows, toks, off = [], [], 0
    for prompt, served in seqs:
        n = len(prompt) + len(served) - 1
        rows += [off + len(prompt) - 1 + i for i in range(len(served))]
        toks += list(served)
        off += n
    return rows, toks


def gaps(logits: torch.Tensor, toks) -> torch.Tensor:
    """Per scored row: the reference's best logit less the logit of the
    token read there."""
    t = torch.as_tensor(toks, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]
