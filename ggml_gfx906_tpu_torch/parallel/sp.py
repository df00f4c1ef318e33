"""Sequence (context) parallelism: ring attention over an 'sp' mesh axis —
the port of ggml_gfx906_tpu/parallel/sp.py (:1-252).

The sequence dimension of Q/K/V is split over the axis and the K/V chunks
rotate around the ring by point-to-point sends (mesh.ppermute: NCCL's, or
gloo's through pinned host buffers for CUDA tensors), each rank merging
per-chunk partial attention with the online-softmax update of the flash
kernel. Every rank streams each K/V chunk once and never holds more than
(N/sp) query rows × (M/sp) key columns of scores. Plain torch in f32, as
the reference's jnp is: no Pallas kernel is involved.

Semantics match causal attention (ops.attention_ref with a causal mask):
q/k/v (B, H|KVH, S, D) with GQA broadcast, scale, optional logit softcap.
Inputs and the output are whole on every rank (the output all-gathered
over 'sp' and 'dp'), in standard sequence order.

Two schedules: "contiguous" (rank d owns rows [dC, (d+1)C): causality
masks every chunk j > d, so rank 0 does 1 useful chunk and rank sp-1 sp)
and the default "zigzag" (rank d owns the half-chunks {d, 2sp-1-d}: every
rank runs exactly 2sp+1 half-chunk updates). The zigzag permutation of the
S axis is applied and inverted around the ring (`zigzag_perm`).
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import all_gather, ppermute

# Finite -inf: exp(NEG_INF - NEG_INF) = 1 would poison fully-masked rows if
# we used true -inf; matches the flash kernel's mask value (reference :38-40).
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def _chunk_attn(q, k, v, row0: int, col0: int, scale: float, softcap: float, m, l, acc,
                masked: bool = True):
    """One online-softmax update of (m, l, acc) with a K/V chunk.

    q (B,H,C,D) at global rows row0+arange(C); k/v (B,H,Ck,D) at global
    cols col0+arange(Ck). All f32. masked=False skips the causal mask for
    chunk pairs known to be fully visible."""
    C, Ck = q.shape[2], k.shape[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if softcap != 0.0:
        s = torch.tanh(s * (1.0 / softcap)) * softcap
    if masked:
        rows = row0 + torch.arange(C, device=q.device)
        cols = col0 + torch.arange(Ck, device=q.device)
        causal = cols[None, :] <= rows[:, None]                 # (C, Ck)
        s = torch.where(causal, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(-1))
    # corrected exp terms; fully-masked chunks contribute exactly zero
    p = torch.exp(s - m_new[..., None])
    if masked:
        p = torch.where(causal, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    return m_new, l * corr + p.sum(-1), acc * corr[..., None] + torch.matmul(p, v)


def _widen(k, v, rep: int):
    """A chunk's K/V in f32 with the GQA heads repeated: the ring carries
    them in their input dtype and KV head count."""
    kc, vc = k.float(), v.float()
    if rep != 1:
        kc = kc.repeat_interleave(rep, dim=1)
        vc = vc.repeat_interleave(rep, dim=1)
    return kc, vc


def _fresh(q):
    B, H, C, D = q.shape
    return (torch.full((B, H, C), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((B, H, C), dtype=torch.float32, device=q.device),
            torch.zeros((B, H, C, D), dtype=torch.float32, device=q.device))


def _ring_body(mesh, axis: str, q, k, v, scale: float, softcap: float):
    """This rank's q chunk against every K/V chunk, rotated around the ring.
    Chunks j > i are fully causally masked and contribute exactly zero (the
    zigzag schedule reclaims that work)."""
    sp, i = mesh.size(axis), mesh.index(axis)
    rep = q.shape[1] // k.shape[1]
    q = q.float()
    C, Ck = q.shape[2], k.shape[2]
    m, l, acc = _fresh(q)
    for t in range(sp):
        j = (i - t) % sp                  # the chunk held at this step
        kc, vc = _widen(k, v, rep)
        m, l, acc = _chunk_attn(q, kc, vc, i * C, j * Ck, scale, softcap, m, l, acc)
        if t + 1 < sp:
            k, v = ppermute(k, mesh, axis), ppermute(v, mesh, axis)
    return acc / l[..., None]


def _zigzag_body(mesh, axis: str, q, k, v, scale: float, softcap: float):
    """The zigzag schedule. Rank i's rows are the half-chunks {i, 2sp-1-i};
    writing a for the early half and b for the late one, while rank i holds
    rank j's K/V:

      - b x a is always fully visible (row chunk 2sp-1-i >= sp > j):
        computed unmasked every step;
      - a x b is always fully masked (2sp-1-j >= sp > i): skipped;
      - a x a runs iff j <= i, b x b iff j >= i (masked updates, diagonal
        only when j == i).

    So every rank runs 1 + (j<=i) + (j>=i) half-chunk updates per step,
    2sp+1 in all. Returns (out, n_updates)."""
    sp, i = mesh.size(axis), mesh.index(axis)
    rep = q.shape[1] // k.shape[1]
    q = q.float()
    Ch = q.shape[2] // 2
    qa, qb = q[:, :, :Ch], q[:, :, Ch:]
    row_a, row_b = i * Ch, (2 * sp - 1 - i) * Ch
    sa, sb = _fresh(qa), _fresh(qb)
    nwork = 0
    for t in range(sp):
        j = (i - t) % sp
        kc, vc = _widen(k, v, rep)
        ka, kb = kc[:, :, :Ch], kc[:, :, Ch:]
        va, vb = vc[:, :, :Ch], vc[:, :, Ch:]
        col_a, col_b = j * Ch, (2 * sp - 1 - j) * Ch
        sb = _chunk_attn(qb, ka, va, row_b, col_a, scale, softcap, *sb, masked=False)
        if j <= i:
            sa = _chunk_attn(qa, ka, va, row_a, col_a, scale, softcap, *sa)
        if j >= i:
            sb = _chunk_attn(qb, kb, vb, row_b, col_b, scale, softcap, *sb)
        nwork += 1 + (j <= i) + (j >= i)
        if t + 1 < sp:
            k, v = ppermute(k, mesh, axis), ppermute(v, mesh, axis)
    out = torch.cat([sa[2] / sa[1][..., None], sb[2] / sb[1][..., None]], dim=2)
    return out, nwork


def zigzag_perm(S: int, sp: int):
    """Standard → zigzag sequence permutation: S split into 2·sp
    half-chunks, rank d owning half-chunks {d, 2sp-1-d}. Returns (perm,
    inv) index arrays; x_zig = x[..., perm, :], x = x_zig[..., inv, :]."""
    Ch = S // (2 * sp)
    parts = []
    for d in range(sp):
        parts.append(np.arange(d * Ch, (d + 1) * Ch))
        parts.append(np.arange((2 * sp - 1 - d) * Ch, (2 * sp - d) * Ch))
    perm = np.concatenate(parts)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(S)
    return perm, inv


def _local(mesh, x, axis: str, bax: str | None):
    """This rank's (batch, sequence) block of a whole (B, H, S, D) tensor."""
    if bax is not None:
        b = x.shape[0] // mesh.size(bax)
        x = x[mesh.index(bax) * b:(mesh.index(bax) + 1) * b]
    c = x.shape[2] // mesh.size(axis)
    return x[:, :, mesh.index(axis) * c:(mesh.index(axis) + 1) * c]


def ring_self_attention(mesh, q, k, v, scale: float | None = None, logit_softcap: float = 0.0,
                        axis: str = "sp", batch_axis: str | None = "dp",
                        schedule: str = "zigzag", return_work_counts: bool = False):
    """Causal self-attention with the sequence split over `axis`.

    q (B, H, S, D), k/v (B, KVH, S, D), whole on every rank; S must divide
    by the axis's size (2× it for the zigzag schedule) and B by
    batch_axis's when the mesh has it with size > 1. Returns (B, H, S, D)
    in q.dtype on every rank.

    schedule: "zigzag" (default) or "contiguous"; a shape valid for the
    ring but not for zigzag (S % 2sp) runs the contiguous one.
    return_work_counts (zigzag only) also returns every rank's update
    count (sp,) for the balance proof."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    sp = mesh.size(axis)
    bax = batch_axis if batch_axis and mesh.size(batch_axis) > 1 else None
    S = q.shape[2]
    if S % sp or (bax is not None and q.shape[0] % mesh.size(bax)):
        raise ValueError(f"S {S} and B {q.shape[0]} must divide by {axis} and {bax}")

    def whole(out):
        out = all_gather(out, mesh.groups[axis], dim=2)
        return out if bax is None else all_gather(out, mesh.groups[bax], dim=0)

    if schedule not in ("zigzag", "contiguous"):
        raise ValueError(f"unknown ring schedule {schedule!r}")
    if schedule == "zigzag" and S % (2 * sp):
        if return_work_counts:
            raise ValueError(f"work counts need the zigzag schedule: S % (2*sp) == 0, "
                             f"got {S} % {2 * sp}")
        schedule = "contiguous"
    if schedule == "contiguous":
        out = _ring_body(mesh, axis, *(_local(mesh, x, axis, bax) for x in (q, k, v)),
                         float(scale), float(logit_softcap))
        return whole(out).to(q.dtype)
    perm, inv = zigzag_perm(S, sp)
    pt = torch.as_tensor(perm, device=q.device)
    zig = [_local(mesh, x.index_select(2, pt), axis, bax) for x in (q, k, v)]
    out, nwork = _zigzag_body(mesh, axis, *zig, float(scale), float(logit_softcap))
    out = whole(out).index_select(2, torch.as_tensor(inv, device=q.device)).to(q.dtype)
    if not return_work_counts:
        return out
    counts = all_gather(torch.tensor([nwork], dtype=torch.int32, device=q.device),
                        mesh.groups[axis])
    return out, counts
