"""Token sampling: greedy and batched top-k/top-p with temperature (the
counterpart of ggml_gfx906_tpu/runtime/sampling.py).

The reference draws from jax.random.categorical, i.e. argmax(logp + Gumbel
noise); torch cannot reproduce jax.random's bits, so the port's
`sample_batch` takes the Gumbel noise as an argument. The engine draws it
from a torch.Generator seeded per request (`gumbel`).

ref: gpt_sample_top_k_top_p examples/common.cpp:113-121.
"""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def gumbel(generator: torch.Generator, n: int) -> torch.Tensor:
    """n Gumbel(0, 1) draws (f32, CPU) from `generator`, as jax.random.gumbel
    forms them: -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(n, generator=generator, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_batch(logits, noise, temp, top_k, top_p, max_k: int = 64):
    """Batched per-slot sampling.

    logits (B, V); noise (B, min(max_k, V)) f32 Gumbel draws (ignored for
    greedy slots); temp/top_p (B,) f32; top_k (B,) int32 in [1, max_k].
    temp == 0 selects greedy for that slot. Returns (B,) int32."""
    b, v = logits.shape
    max_k = min(max_k, v)
    lf = logits.float()
    temp = temp.to(lf.device)
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    vals, idx = torch.topk(lf / safe_t[:, None], max_k, dim=-1)
    kk = torch.clamp(top_k.to(lf.device), 1, max_k)
    in_k = torch.arange(max_k, device=lf.device)[None, :] < kk[:, None]
    probs = torch.softmax(torch.where(in_k, vals, torch.full_like(vals, float("-inf"))),
                          dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=lf.device),
                      csum[:, :-1] < top_p.to(lf.device)[:, None]], dim=1)
    probs = torch.where(keep & in_k, probs, torch.zeros_like(probs))
    logp = torch.log(torch.clamp(probs / probs.sum(-1, keepdim=True), min=1e-30))
    choice = torch.argmax(logp + noise.to(lf.device), dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0]
    return torch.where(temp > 0, sampled, torch.argmax(lf, dim=-1)).to(torch.int32)
