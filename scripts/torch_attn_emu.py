"""The arithmetic of K2 (csrc/flash_attn.cu) and of K3's scale fold
(csrc/qmm_q4k.cu, format Q4KI8) in plain torch, in the kernels' order, to
check the designs on the CPU.

    python3 scripts/torch_attn_emu.py

K2 (`k2`): a row's causal range cut into chunks of CHUNK positions at fixed
absolute places; a score is a D-long dot over 16 lanes (lane j takes the
16-byte segments j, j+16, ... of the row in order, each product-sum an
f32 fma) whose lane sums meet in an xor butterfly (8, 4, 2, 1); per chunk
m = max, p = exp(s - m) (0 on masked columns), l = lane-strided sums (lane
l: columns l, l+32, l+64, l+96) met in a butterfly (16 .. 1), acc = one
fma chain over the chunk's columns; a row's result is the left fold of its
chunks with `merge`, then acc * (1/l). With split > 1 the chunk partials
are kept and folded afterwards, as the combine kernel does. The fma is
emulated in float64 (exact product, one sum) and rounded to f32, exp and
tanh in float64 rounded to f32: this is the kernel's order, not its bits
(CUDA's expf differs from a correctly rounded exp in the last bit).

K3 (`q4k_fold`, `expand_w8`): the fold of Q4_K block scales by the per-tile
bound, step by step in f32 as the kernel forms it from scm and dd, and the
expansion's rounding by the 1.5 * 2^23 sum.

Run as a script it prints K2's distance to its plain version and the row
checks, and K3's fold against `prepare_i8` (tests/test_torch_attn_tools.py
holds the same against the JAX package). CPU only; imports torch only.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

CHUNK = 128
LANES = 16
NEG_INF = np.float32(-0.7) * np.float32(np.finfo(np.float32).max)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _exp(x):
    return torch.exp(x.double()).float()


def _butterfly(x, offsets):
    """x (..., lanes): every lane's value after the xor butterfly; the sum
    is the same on every lane (a + b == b + a), lane 0's is returned."""
    lanes = torch.arange(x.shape[-1])
    for off in offsets:
        x = x + x[..., lanes ^ off]
    return x[..., 0]


def _scores(q, k, width):
    """q (..., R, D), k (..., C, D) f32 → (..., R, C) dots in the kernel's
    order: lane j's sum of its segments (width elements each), then the
    butterfly over 16 lanes."""
    D = q.shape[-1]
    nseg = D // width
    lane = torch.zeros(q.shape[:-1] + (k.shape[-2], LANES), dtype=torch.float32)
    for j in range(LANES):
        acc = torch.zeros(q.shape[:-1] + (k.shape[-2],), dtype=torch.float32)
        for s in range(j, nseg, LANES):
            for e in range(width):
                d = s * width + e
                acc = _fma(q[..., :, None, d], k[..., None, :, d], acc)
        lane[..., j] = acc
    return _butterfly(lane, (8, 4, 2, 1))


def merge(m, l, acc, mc, lc, accc):
    """The fold of a chunk's partial into a running one (csrc/flash_attn.cu
    merge_coef / merge)."""
    mn = torch.maximum(m, mc)
    a, b = _exp(m - mn), _exp(mc - mn)
    return mn, l * a + lc * b, acc * a[..., None] + accc * b[..., None]


def k2(q, k, v, pos, scale: float, softcap: float = 0.0, k_scale=None, v_scale=None,
       split: int = 1):
    """K2's order on (B, H, N, D) q and (B, KVH, M, D) K/V: (B, H, N, D) f32."""
    B, H, N, D = q.shape
    KVH, M = k.shape[1], k.shape[2]
    G = H // KVH
    width = 16 // k.element_size()
    pos = torch.as_tensor(pos, dtype=torch.int64).reshape(-1).expand(B)
    qf = q.float().reshape(B, KVH, G, N, D).transpose(2, 3).reshape(B, KVH, N * G, D)
    kf, vf = k.float(), v.float()
    qpos = pos[:, None] + torch.arange(N * G) // G                     # (B, R)
    last = torch.clamp(qpos, max=M - 1) // CHUNK
    scale, softcap = np.float32(scale), np.float32(softcap)
    R = N * G
    m = torch.full((B, KVH, R), float(NEG_INF))
    l = torch.zeros((B, KVH, R))
    acc = torch.zeros((B, KVH, R, D))
    parts = []
    for c in range((M + CHUNK - 1) // CHUNK):
        cols = torch.arange(c * CHUNK, min((c + 1) * CHUNK, M))
        s = _scores(qf, kf[:, :, cols], width)                         # (B, KVH, R, C)
        if k_scale is not None:
            s = s * k_scale.float()[:, :, None, cols]
        s = s * scale
        if softcap:
            s = torch.tanh((s * (np.float32(1) / softcap)).double()).float() * softcap
        ok = (cols[None, None, None, :] <= qpos[:, None, :, None]).expand(s.shape)
        s = torch.where(ok, s, torch.full_like(s, float(NEG_INF)))
        mc = s.amax(-1)
        p = torch.where(ok, _exp(s - mc[..., None]), torch.zeros_like(s))
        pad = torch.zeros(p.shape[:-1] + (CHUNK - p.shape[-1],))
        lane = torch.cat([p, pad], -1).reshape(p.shape[:-1] + (CHUNK // 32, 32))
        lsum = torch.zeros(lane.shape[:-2] + (32,))
        for u in range(CHUNK // 32):
            lsum = lsum + lane[..., u, :]
        lc = _butterfly(lsum, (16, 8, 4, 2, 1))
        if v_scale is not None:
            p = p * v_scale.float()[:, :, None, cols]
        accc = torch.zeros((B, KVH, R, D))
        for i, col in enumerate(cols.tolist()):
            accc = _fma(p[..., i, None], vf[:, :, None, col, :], accc)
        live = (c <= last)[:, None, :]                                 # (B, 1, R)
        if split == 1:
            mn, ln, an = merge(m, l, acc, mc, lc, accc)
            m, l = torch.where(live, mn, m), torch.where(live, ln, l)
            acc = torch.where(live[..., None], an, acc)
        else:
            parts.append((mc, lc, accc, live))
    for mc, lc, accc, live in parts:            # the combine kernel's fold
        mn, ln, an = merge(m, l, acc, mc, lc, accc)
        m, l = torch.where(live, mn, m), torch.where(live, ln, l)
        acc = torch.where(live[..., None], an, acc)
    out = acc * (1.0 / torch.where(l == 0, torch.ones_like(l), l))[..., None]
    return out.reshape(B, KVH, N, G, D).transpose(2, 3).reshape(B, H, N, D)


def q4k_fold(scm, dd):
    """K3's fold from the packed Q4_K scales, as the kernel forms it: per
    (row, superblock) and half (lo: sub-blocks 0, 2, 4, 6; hi: 1, 3, 5, 7)
    the f32 steps dsc = sc·d, dm = m·dmin, bound = max(|15·dsc − dm|, |dm|),
    amax over the half, dw = amax/127, inv = 127/amax (0 when amax = 0),
    dsc' = dsc·inv, dm' = dm·inv, each one IEEE operation. Returns
    prepare_i8's fold order: (dsclo_f, dschi_f, dmlo_f, dmhi_f, dwlo, dwhi)."""
    n = scm.shape[0]
    s = scm.reshape(n, -1, 16).numpy().astype(np.float32)
    d = dd.reshape(n, -1, 2).numpy()
    f32 = np.float32
    out = {}
    for half, name in ((0, "lo"), (1, "hi")):
        dsc = s[:, :, half:8:2] * d[:, :, 0:1]
        dm = s[:, :, 8 + half:16:2] * d[:, :, 1:2]
        bound = np.maximum(np.abs(f32(15) * dsc - dm), np.abs(dm))
        amax = np.zeros(bound.shape[:2], np.float32)
        for g in range(4):
            amax = np.maximum(amax, bound[:, :, g])
        dw = amax / f32(127)
        inv = np.where(amax > 0, f32(127) / np.where(amax > 0, amax, f32(1)), f32(0))
        out[name] = ((dsc * inv[..., None]).reshape(n, -1), (dm * inv[..., None]).reshape(n, -1),
                     dw)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return (t(out["lo"][0]), t(out["hi"][0]), t(out["lo"][1]), t(out["hi"][1]),
            t(out["lo"][2]), t(out["hi"][2]))


def expand_w8(qs, dsc_f, dm_f, high: bool):
    """The kernel's expansion of one half's nibbles: v = q·dsc' − dm', clamped
    to ±127, rounded by the f32 sum with 1.5·2^23 (ties to even); the int8
    is the low byte of the sum's bits."""
    n = qs.shape[0]
    q = ((qs >> 4) if high else (qs & 0xF)).reshape(n, -1, 4, 32).numpy().astype(np.float32)
    v = q * dsc_f.reshape(n, -1, 4, 1).numpy() - dm_f.reshape(n, -1, 4, 1).numpy()
    v = np.minimum(np.maximum(v, np.float32(-127)), np.float32(127))
    bits = (v + np.float32(12582912.0)).view(np.uint32) & 0xFF
    return torch.from_numpy(bits.astype(np.uint8).view(np.int8).reshape(n, -1).copy())


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from ggml_gfx906_tpu_torch.ops.cuda import flash_attn, qmm

    gen = torch.Generator().manual_seed(0)
    B, H, KVH, D, M = 2, 4, 2, 64, 300
    q = torch.randn((B, H, 3, D), generator=gen)
    k = torch.randn((B, KVH, M, D), generator=gen).bfloat16()
    v = torch.randn((B, KVH, M, D), generator=gen).bfloat16()
    pos = torch.tensor([120, 290])
    got = k2(q, k, v, pos, 0.125, split=1)
    ref = flash_attn.causal_flash_attention_plain(q, k, v, pos, 0.125)
    e = float(((got - ref).double() ** 2).mean() / (ref.double() ** 2).mean())
    print(f"K2 order vs its plain version: nmse {e:.3e}; split 3 bit-equal "
          f"{torch.equal(got, k2(q, k, v, pos, 0.125, split=3))}")
    qs = torch.randint(0, 256, (16, 512), dtype=torch.uint8, generator=gen)
    scm = torch.randint(0, 64, (16, 64), dtype=torch.uint8, generator=gen)
    scm[0] = 0
    dd = torch.rand((16, 8), generator=gen) * 0.003
    fold = q4k_fold(scm, dd)
    want = qmm.prepare_i8(torch.randn((1, 1024), generator=gen), scm, dd)[4:]
    print("K3 fold bit-equal to prepare_i8:", all(torch.equal(a, b) for a, b in zip(fold, want)))
    w8 = [expand_w8(qs, fold[h], fold[2 + h], bool(h)) for h in (0, 1)]
    ref8 = [qmm.expand_w8(qs, want[h], want[2 + h], bool(h)) for h in (0, 1)]
    print("K3 expansion bit-equal to expand_w8:", all(torch.equal(a, b) for a, b in zip(w8, ref8)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
