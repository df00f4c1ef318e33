"""Token sampling: greedy and batched top-k/top-p with temperature (the
counterpart of ggml_gfx906_tpu/runtime/sampling.py), and the reference's
random numbers.

The reference draws from jax.random.categorical, i.e. argmax(logp + Gumbel
noise), with the key fold_in(PRNGKey(seed), counter) (runtime/engine.py:
38, 216-217). Its threefry2x32 generator is integer arithmetic, so the port
computes the same keys and bits in torch integer ops (uint32 values held in
int64 and masked to 32 bits) and forms the Gumbel draws as jax.random.gumbel
does. `sample_batch` takes the noise as an argument; the engine builds it
with `gumbel_noise` on the host and copies it into its captured programs'
noise buffer. The single-sequence sampler of the CLI (`sample_top_k_top_p`,
with `split` and `categorical`) draws the reference's tokens from the same
keys.

ref: gpt_sample_top_k_top_p examples/common.cpp:113-121.
"""
from __future__ import annotations

import torch

from ..utils.device import to_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash (20 rounds) as jax computes it (jax/_src/
    prng.py::_threefry2x32_lowering): int64 tensors of uint32 values in,
    the two hashed words out."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for int32 seeds: (..., 2) int64 [0, seed
    mod 2^32]. `seed` is an int or an integer tensor of seeds."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the count [0, data] under
    the key. key (..., 2); data an int or a tensor broadcastable to key's
    leading shape."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num) with jax_threefry_partitionable on: the
    hash of the counts [0, i] for i < num, i.e. row i is fold_in(key, i).
    key (2,) → (num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def uniform_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,)) with jax_threefry_partitionable on (jax's
    default): the xor of the two hashed words of the counts 0..n-1. key
    (..., 2) → (..., n) int64 values below 2^32."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo)
    return b0 ^ b1


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.gumbel(key, (n,), float32): u uniform in [tiny, 1) from the
    top 23 bits (jax/_src/random.py::_uniform), then -log(-log(u)) in f32.
    key (..., 2) → (..., n) f32."""
    tiny = torch.finfo(torch.float32).tiny
    mant = (uniform_bits(key, n) >> 9) | 0x3F800000        # below 2^31: fits int32
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f + tiny, min=tiny)     # f·(1 − tiny) + tiny; 1 − tiny is 1 in f32
    return -torch.log(-torch.log(u))


def gumbel_noise(seeds, counters, n: int, device=None) -> torch.Tensor:
    """(B, n) Gumbel draws of B requests, row b under the key
    fold_in(PRNGKey(seeds[b]), counters[b]), as the reference engine keys
    its token counters[b] (runtime/engine.py:38, 216-217). Computed on the
    host, where the hash's few hundred small integer ops cost no kernel
    launches, and copied to `device` once, without a host wait
    (utils/device.py::to_device); device=None keeps them on the host."""
    key = fold_in(prng_key(seeds), torch.as_tensor(counters))
    g = gumbel(key, n)
    return g if device is None else to_device(g, device)


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


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits) of one row: the argmax of
    logits + gumbel(key, n). The draws are made where the key lives (the
    host, for the CLI's keys) and copied to the logits' device."""
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(to_device(g, logits.device) + logits, dim=-1)


def sample_top_k_top_p(logits: torch.Tensor, key: torch.Tensor, top_k: int = 40,
                       top_p: float = 0.9, temp: float = 1.0) -> torch.Tensor:
    """logits (n_vocab,) → int32 token id, as the reference's single-row
    sampler (runtime/sampling.py:17-33): 1/temp, top-k, softmax, nucleus
    keep with the first token always kept, renormalise, categorical over
    log(max(p, 1e-30)). The temperature divides tensor by tensor (a CUDA
    tensor divided by a Python scalar is multiplied by its reciprocal)."""
    lf = logits.float()
    if temp != 1.0:
        lf = lf / torch.full_like(lf, temp)
    n = lf.shape[-1]
    k = min(top_k, n) if top_k > 0 else n
    vals, idx = torch.topk(lf, k)
    e = torch.exp(vals - vals.max())
    probs = e / e.sum()
    if top_p < 1.0:
        csum = torch.cumsum(probs, dim=0)
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=lf.device),
                          csum[:-1] < top_p])
        probs = torch.where(keep, probs, torch.zeros_like(probs))
        probs = probs / probs.sum()
    choice = categorical(key, torch.log(torch.clamp(probs, min=1e-30)))
    return idx[choice].to(torch.int32)
