"""Codebook i-quants IQ2_XXS / IQ2_XS / IQ2_S, IQ3_XXS / IQ3_S, IQ1_S /
IQ1_M, on tensors: the dequantizers, the lattice machinery and the plain
versions of the grid-search quantizers.

The port of ggml_gfx906_tpu/quant/iquants.py, the same f32 operations in
the same order, so that the bytes and bits equal the reference's:
- the dequantizers (:52-234; ggml's dequantize_row_iq*,
  src/ggml-quants.c:2275-2505): grid lookups, the ksigns sign expansion
  and 4- or 3-bit block scales;
- the lattice machinery (:226-346; ggml's iq2xs_init_impl /
  iq3xs_init_impl): each lattice's points, the map from a packed point to
  its grid index, and the neighbour lists of the points off the grid;
- the quantizers (:351-1238; ggml's quantize_row_iq*_impl): per scale
  sub-block a sweep of candidate scales, each snapping its groups to the
  lattice (a neighbour search off it), then a refit, and per super-block
  the f16 scale and the 4- or 3-bit sub-block scales.

The quantizers here are the plain versions of the search kernels S1 (iq3),
S2 (iq2) and S3 (iq1), csrc/iq_search.cu; ops/cuda/iq_search.py runs these
on CPU tensors and the kernels on CUDA tensors. They are vectorised over
every sub-block of a call and loop over the candidates in the reference's
order, with a strict-greater update as its sequential loop has; a
neighbour search lays the groups' lists end to end and keeps each group's
first minimum, as np.argmin does.

The tables are the port's own copies, data/iq_grids.npz and
data/machinery_*.npz. A dequantizer takes (..., nb, block bytes) uint8
wire blocks and returns (..., nb·256) f32 on their device; a quantizer
takes f32 (..., n) and an optional importance row (n,) and returns (...,
n/256, block bytes) uint8 on x's device.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from . import blocks
from .kquants import make_qp_quants
from .numerics import const, f16_bytes, f16_from_bytes, nearest_int, seq_sum, sqrt
from .types import (BLOCK_IQ1_M, BLOCK_IQ1_S, BLOCK_IQ2_S, BLOCK_IQ2_XS, BLOCK_IQ2_XXS,
                    BLOCK_IQ3_S, BLOCK_IQ3_XXS, GROUP_MAX_EPS, QK_K)

IQ1_DELTA = 0.125           # IQ1S_DELTA == IQ1M_DELTA, exact in f32
_DATA = os.path.join(os.path.dirname(__file__), "data", "iq_grids.npz")


@functools.cache
def _tables() -> dict:
    with np.load(_DATA) as t:
        return dict(t)


@functools.cache
def grid_u8(name: str, device: torch.device) -> torch.Tensor:
    """A dequant lattice as (grid_size, 8 | 4) f32 on `device`: its packed
    words' bytes, unsigned (iq1s_grid signed)."""
    t = _tables()[name]
    g = t.view(np.uint8).reshape(len(t), t.dtype.itemsize)
    if name == "iq1s_grid":
        g = g.view(np.int8)
    return torch.from_numpy(g.astype(np.float32)).to(device)


@functools.cache
def ksigns(device: torch.device) -> torch.Tensor:
    """ksigns_iq2xs (src/ggml-common.h): a 7-bit sign word → 8 bits with
    odd parity in bit 7, as int64 on `device`."""
    i = np.arange(128)
    pc = ((i[:, None] >> np.arange(7)) & 1).sum(1) & 1
    return torch.from_numpy(i | (pc << 7)).to(device)


def _sign_pm1(sign_bytes: torch.Tensor) -> torch.Tensor:
    """(...) sign bytes → (..., 8) of ±1 f32 (bit j set → −1)."""
    j = torch.arange(8, device=sign_bytes.device)
    bits = (sign_bytes.to(torch.int64)[..., None] >> j) & 1
    return torch.where(bits.bool(), -1.0, 1.0)


def _fields(raw, dtype):
    """(the blocks' fields, one block a row; the output's shape, zero rows
    included; the f16 scale d as f32, where the block has one)."""
    f = blocks.split(raw.reshape(-1, dtype.itemsize), dtype)
    return (f, (*raw.shape[:-2], raw.shape[-2] * QK_K),
            f16_from_bytes(f["d"]) if "d" in f else None)


def _db(d, code, half: float):
    """Block scales (d · (0.5 + code)) · half, each product rounded."""
    return (d * (0.5 + code.to(torch.float32))) * half


def dequantize_iq2_xxs(raw):
    f, shape, d = _fields(raw, BLOCK_IQ2_XXS)
    dev = raw.device
    aux = blocks.le_words(f["qs"], 4).reshape(-1, 8, 2)
    a, s = aux[..., 0], aux[..., 1]                                # (nb, 8)
    db = _db(d[:, None], s >> 28, 0.25)
    k4 = torch.arange(4, device=dev)
    grid = grid_u8("iq2xxs_grid", dev)[(a[..., None] >> (8 * k4)) & 0xFF]   # (nb, 8, 4, 8)
    signs = _sign_pm1(ksigns(dev)[(s[..., None] >> (7 * k4)) & 127])
    return ((db[:, :, None, None] * grid) * signs).reshape(shape)


def _dl_nibbles(d, scales):
    """IQ2_XS / IQ2_S: per 32-block the two nibble scales, as each of its
    four 8-groups takes them (0, 0, 1, 1) → (nb, 8, 4)."""
    sc = scales.to(torch.int32)
    db = _db(d[:, None, None], torch.stack([sc & 0xF, sc >> 4], dim=-1), 0.25)
    return db[:, :, [0, 0, 1, 1]]


def dequantize_iq2_xs(raw):
    f, shape, d = _fields(raw, BLOCK_IQ2_XS)
    dev = raw.device
    qs = blocks.le_words(f["qs"], 2).reshape(-1, 8, 4)
    grid = grid_u8("iq2xs_grid", dev)[qs & 511]
    signs = _sign_pm1(ksigns(dev)[qs >> 9])
    dl = _dl_nibbles(d, f["scales"])
    return ((dl[..., None] * grid) * signs).reshape(shape)


def dequantize_iq2_s(raw):
    f, shape, d = _fields(raw, BLOCK_IQ2_S)
    dev = raw.device
    qs = f["qs"][:, :32].reshape(-1, 8, 4).to(torch.int64)
    sgn = f["qs"][:, 32:].reshape(-1, 8, 4)
    qh = f["qh"].to(torch.int64)
    sh = 8 - 2 * torch.arange(4, device=dev)
    grid = grid_u8("iq2s_grid", dev)[qs | ((qh[..., None] << sh) & 0x300)]
    dl = _dl_nibbles(d, f["scales"])
    return ((dl[..., None] * grid) * _sign_pm1(sgn)).reshape(shape)


def dequantize_iq3_xxs(raw):
    f, shape, d = _fields(raw, BLOCK_IQ3_XXS)
    dev = raw.device
    qs = f["qs"][:, :64].reshape(-1, 8, 8).to(torch.int64)          # grid bytes
    aux = blocks.le_words(f["qs"][:, 64:], 4)                       # (nb, 8)
    db = _db(d[:, None], aux >> 28, 0.5)
    grid = grid_u8("iq3xxs_grid", dev)[qs]                           # (nb, 8, 8, 4)
    k4 = torch.arange(4, device=dev)
    signs = _sign_pm1(ksigns(dev)[(aux[..., None] >> (7 * k4)) & 127])   # (nb, 8, 4, 8)
    # grid pairs qs[2l], qs[2l + 1] give elements 0-3 / 4-7 of sign word l
    y = db[:, :, None, None] * grid.reshape(-1, 8, 4, 8)
    return (y * signs).reshape(shape)


def dequantize_iq3_s(raw):
    f, shape, d = _fields(raw, BLOCK_IQ3_S)
    dev = raw.device
    nb = d.shape[0]
    qs = f["qs"].reshape(nb, 4, 2, 8).to(torch.int64)      # (pair of 32-blocks, half, 2l)
    qh = f["qh"].reshape(nb, 4, 2).to(torch.int64)
    sc = f["scales"].to(torch.int32)
    # C order: d · (1 + 2·nibble)
    db = d[:, None, None] * torch.stack([1.0 + 2.0 * (sc & 0xF).to(torch.float32),
                                         1.0 + 2.0 * (sc >> 4).to(torch.float32)], dim=-1)
    l2 = torch.arange(8, device=dev)
    shifts = torch.where(l2 % 2 == 0, 8 - (l2 // 2) * 2, 7 - (l2 // 2) * 2)
    grid = grid_u8("iq3s_grid", dev)[qs | ((qh[..., None] << shifts) & 256)]   # (nb,4,2,8,4)
    y = db[:, :, :, None, None] * grid.reshape(nb, 4, 2, 4, 8)
    return (y * _sign_pm1(f["signs"].reshape(nb, 4, 2, 4))).reshape(shape)


def dequantize_iq1_s(raw):
    f, shape, d = _fields(raw, BLOCK_IQ1_S)
    dev = raw.device
    qs = f["qs"].reshape(-1, 8, 4).to(torch.int64)
    qh = blocks.le_words(f["qh"], 2)                                  # (nb, 8)
    dl = d[:, None] * (2.0 * ((qh >> 12) & 7).to(torch.float32) + 1.0)
    delta = torch.where((qh & 0x8000) != 0, -IQ1_DELTA, IQ1_DELTA)
    k4 = torch.arange(4, device=dev)
    grid = grid_u8("iq1s_grid", dev)[qs | (((qh[..., None] >> (3 * k4)) & 7) << 8)]
    return (dl[..., None, None] * (grid + delta[..., None, None])).reshape(shape)


def dequantize_iq1_m(raw):
    f, shape, _ = _fields(raw, BLOCK_IQ1_M)
    dev = raw.device
    sc = blocks.le_words(f["scales"], 2)                              # (nb, 4)
    nb = sc.shape[0]
    du16 = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0) | ((sc[:, 2] >> 4) & 0x0F00)
            | (sc[:, 3] & 0xF000))
    d = f16_from_bytes(blocks.le_bytes(du16, 2))
    qs = f["qs"].reshape(nb, 8, 4).to(torch.int64)
    qh = f["qh"].reshape(nb, 8, 2).to(torch.int64)
    ib = torch.arange(8, device=dev)
    word = sc[:, ib // 2]
    sh = 6 * (ib % 2)
    dl = torch.stack([(word >> sh) & 7, (word >> (sh + 3)) & 7], dim=-1)
    dl = d[:, None, None] * (dl.to(torch.float32) * 2.0 + 1.0)       # (nb, 8, 2)
    idx = torch.stack([qs[..., 0] | ((qh[..., 0] << 8) & 0x700),
                       qs[..., 1] | ((qh[..., 0] << 4) & 0x700),
                       qs[..., 2] | ((qh[..., 1] << 8) & 0x700),
                       qs[..., 3] | ((qh[..., 1] << 4) & 0x700)], dim=-1)
    hb = torch.stack([qh[..., 0] & 0x08, qh[..., 0] & 0x80,
                      qh[..., 1] & 0x08, qh[..., 1] & 0x80], dim=-1)
    delta = torch.where(hb != 0, -IQ1_DELTA, IQ1_DELTA)
    grid = grid_u8("iq1s_grid", dev)[idx]                            # (nb, 8, 4, 8)
    dsel = dl[:, :, [0, 0, 1, 1]]
    return (dsel[..., None] * (grid + delta[..., None])).reshape(shape)


# ------------------------------------------------------ the lattice machinery

def _f32(v) -> float:
    """A host scalar rounded to f32 (numpy's np.float32 arithmetic)."""
    return float(np.float32(v))


# the group-max thresholds below which a sub-block is left zero (:228-231)
GROUP_MAX_EPS_IQ3_XXS = _f32(1e-8)
GROUP_MAX_EPS_IQ2_S = _f32(1e-8)
GROUP_MAX_EPS_IQ1_M = _f32(1e-7)
GROUP_MAX_EPS_IQ1_S = _f32(1e-12)
_EPS = float(GROUP_MAX_EPS)

# kind → (its packed lattice in iq_grids.npz, coordinates per group, bits
# per coordinate, distinct distances kept per neighbour list, kmap size)
# (:253-260)
MACHINERY_KINDS = {
    "iq2_xxs": ("kgrid_2bit_256", 8, 2, 2, 43692),
    "iq2_xs": ("kgrid_2bit_512", 8, 2, 2, 43692),
    "iq2_s": ("kgrid_2bit_1024", 8, 2, 1, 43692),
    "iq1": ("kgrid_1bit_2048", 8, 2, 3, 43692),
    "iq3_256": ("iq3_kgrid_256", 4, 3, 2, 4096),
    "iq3_512": ("iq3_kgrid_512", 4, 3, 3, 4096),
}


@dataclass(frozen=True)
class Machinery:
    """One lattice's search tables, int64 on a device. grid (S, dim): the
    points' odd coordinates 2l + 1. kmap (kmap_size,): for a packed point
    u (level l_j at bits·j) its grid index, or −(start + 1) where
    neigh[start] is the length of its neighbour list, which follows it.
    neigh: the flat lists, each sorted by (distance², grid index)."""
    grid: torch.Tensor
    kmap: torch.Tensor
    neigh: torch.Tensor


def machinery_path(kind: str) -> str:
    """The shipped tables of `kind` (the reference's own files)."""
    return os.path.join(os.path.dirname(_DATA), f"machinery_{kind}.npz")


def build_machinery(kind: str, device) -> Machinery:
    """The tables of `kind` computed from its packed lattice in torch on
    `device` (:261-305, ggml's iq2xs_init_impl / iq3xs_init_impl): each
    point off the grid lists the grid points at its `nwant` smallest
    distinct squared distances, in a stable sort by distance, so that ties
    keep index order as the C comparator's do. Writes nothing."""
    name, dim, bits, nwant, kmap_size = MACHINERY_KINDS[kind]
    device = torch.device(device)
    kgrid = torch.from_numpy(_tables()[name].astype(np.int64)).to(device)
    shifts = bits * torch.arange(dim, device=device)
    mask = (1 << bits) - 1
    lv = (kgrid[:, None] >> shifts) & mask
    grid = 2 * lv + 1
    kmap = torch.full((kmap_size,), -1, dtype=torch.int64, device=device)
    kmap[(lv << shifts).sum(1)] = torch.arange(len(kgrid), device=device)
    missing = torch.nonzero(kmap < 0)[:, 0]
    parts, counter = [], 0
    for s0 in range(0, len(missing), 1024):
        chunk = missing[s0:s0 + 1024]
        pos = 2 * ((chunk[:, None] >> shifts) & mask) + 1
        d2 = ((pos[:, None, :] - grid[None]) ** 2).sum(-1)           # exact integers
        d2s, order = torch.sort(d2, dim=1, stable=True)
        step = torch.ones_like(d2s)
        step[:, 1:] = (d2s[:, 1:] != d2s[:, :-1]).to(torch.int64)
        within = torch.cumsum(step, 1) <= nwant
        lens = within.sum(1)
        starts = torch.cumsum(lens + 1, 0) - (lens + 1)
        total = int(lens.sum()) + len(chunk)
        flat = torch.empty(total, dtype=torch.int64, device=device)
        flat[starts] = lens
        fill = torch.ones(total, dtype=torch.bool, device=device)
        fill[starts] = False
        flat[fill] = order[within]                                     # row-major
        kmap[chunk] = -(counter + starts + 1)
        parts.append(flat)
        counter += total
    return Machinery(grid, kmap, torch.cat(parts))


@functools.cache
def machinery(kind: str, device) -> Machinery:
    """The tables of `kind` on `device`, once per device: the shipped file,
    or built when it is missing."""
    device = torch.device(device)
    path = machinery_path(kind)
    if not os.path.exists(path):
        return build_machinery(kind, device)
    with np.load(path) as z:
        return Machinery(*(torch.from_numpy(z[f].astype(np.int64)).to(device)
                           for f in ("grid", "kmap", "neigh")))


# ------------------------------------------------ the searches' shared steps

_NEIGH_CHUNK = 1 << 16        # groups per neighbour search


def _pack(levels: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., dim) levels → the packed point Σ l_j << bits·j."""
    sh = bits * torch.arange(levels.shape[-1], device=levels.device)
    return (levels.to(torch.int64) << sh).sum(-1)


def _best_neighbour(m: Machinery, u, xv, w, scale, values, sel):
    """For groups off the grid (packed points u (G,)): the grid index of
    the first minimum of Σ w·(scale·v − x)² over each group's neighbour
    list, v the neighbour's row of values[sel] (:319-325, iq1's :972-980).
    xv, w (G, dim); scale (G,); values (V, S, dim); sel (G,). The lists are
    laid end to end; a group's minimum is found by a scatter, and its first
    position holding it by another, as np.argmin keeps the first."""
    out = torch.empty_like(u)
    for c0 in range(0, len(u), _NEIGH_CHUNK):
        sl = slice(c0, c0 + _NEIGH_CHUNK)
        start = -m.kmap[u[sl]] - 1
        n = m.neigh[start]
        grp = torch.repeat_interleave(torch.arange(len(n), device=u.device), n)
        pos = torch.arange(len(grp), device=u.device) - (torch.cumsum(n, 0) - n)[grp]
        idx = m.neigh[start[grp] + 1 + pos]
        diff = scale[sl][grp, None] * values[sel[sl][grp], idx] - xv[sl][grp]
        d2 = seq_sum(w[sl][grp] * diff * diff)
        low = torch.full((len(n),), torch.inf, device=u.device).scatter_reduce(
            0, grp, d2, "amin")
        first = torch.full_like(n, len(m.neigh)).scatter_reduce(
            0, grp, torch.where(d2 == low[grp], pos, len(m.neigh)), "amin")
        out[sl] = m.neigh[start + 1 + torch.clamp(first, max=n - 1)]
    return out


def _snap(m: Machinery, L, xval, waux, scale, values, sel=None, want=None):
    """Levels L (N, bsz) snapped to the lattice group by group: a group
    off the grid (and in `want` (N, G), all when None) takes its best
    neighbour's levels. Returns (L, off (N, G))."""
    N, bsz = L.shape
    dim = m.grid.shape[1]
    G = bsz // dim
    Lg = L.reshape(N, G, dim)
    u = _pack(Lg, 3 if dim == 4 else 2)
    off = m.kmap[u] < 0
    todo = off if want is None else off & want
    if bool(todo.any()):
        r, g = torch.nonzero(todo, as_tuple=True)
        s = torch.zeros_like(r) if sel is None else sel[r, g]
        best = _best_neighbour(m, u[r, g], xval.reshape(N, G, dim)[r, g],
                               waux.reshape(N, G, dim)[r, g], scale[r], values, s)
        Lg = Lg.clone()
        Lg[r, g] = ((m.grid[best] - 1) // 2).to(Lg.dtype)
    return Lg.reshape(N, bsz), off


def _sign_fold(xb, weight):
    """The iq2/iq3 sign-folding prologue (:328-346): |x|, with the least
    important element (first minimum of w·x·x) of an 8-group with an odd
    number of negatives negated, and the group's 7 low sign bits."""
    N, bsz = xb.shape
    x8, w8 = xb.reshape(N, -1, 8), weight.reshape(N, -1, 8)
    j = torch.arange(8, device=xb.device)
    neg = x8 < 0
    odd = neg.sum(-1) % 2 == 1
    imin = torch.argmin(w8 * x8 * x8, -1)
    flip = odd[..., None] & (j == imin[..., None])
    xval = torch.where(flip, -x8.abs(), x8.abs()).reshape(N, bsz)
    bits = (neg.to(torch.int64) << j).sum(-1) ^ (odd.to(torch.int64) << imin)
    return xval, bits & 127


def _sign_bytes(xb):
    """iq2_s / iq3_s: each 8-group's full sign byte (bit j: x_j < 0)."""
    N = xb.shape[0]
    j = torch.arange(8, device=xb.device)
    return ((xb.reshape(N, -1, 8) < 0).to(torch.int64) << j).sum(-1)


def _superblocks(x) -> torch.Tensor:
    x = x.to(torch.float32)
    if x.shape[-1] % QK_K:
        raise ValueError(f"last dim {x.shape[-1]} is not a multiple of {QK_K}")
    return x.reshape(-1, QK_K)


def _out(x, blk: torch.Tensor) -> torch.Tensor:
    return blk.reshape(*x.shape[:-1], x.shape[-1] // QK_K, blk.shape[-1])


def _block_weights(xs, quant_weights, bsz: int, sigma2_double: bool, fallback: str):
    """(xb (N, bsz), weight (N, bsz)) of the super-blocks xs (nbl, 256):
    with an importance row, qw·sqrt(sigma2 + x²), the row's segment
    qw_rows[ibl % len(qw_rows)] for super-block ibl; without, x² or
    0.25·sigma2 + x² (iq2_s). sigma2 = Σx²/256, doubled but in iq2_xxs and
    iq2_xs."""
    s = seq_sum(xs * xs)
    sigma2 = (s * 2.0 if sigma2_double else s) / const(QK_K, xs)
    if quant_weights is not None:
        qw = quant_weights.to(device=xs.device, dtype=torch.float32).reshape(-1, QK_K)
        qw = qw[torch.arange(xs.shape[0], device=xs.device) % qw.shape[0]]
        weight = qw * sqrt(sigma2[:, None] + xs * xs)
    elif fallback == "x2":
        weight = xs * xs
    elif fallback == "sigma":
        weight = (sigma2 * 0.25)[:, None] + xs * xs
    else:
        raise ValueError("this type needs an importance row")
    return xs.reshape(-1, bsz), weight.reshape(-1, bsz)


def _scale_codes(scale, max_scale, div: float, top: int):
    """d = max_scale / div and each sub-block's code clip(rint(0.5·(scale/d
    − 1)), 0, top) (the super-block epilogues; d where max_scale is 0 is
    unused)."""
    zero = max_scale == 0
    d = torch.where(zero, 1.0, max_scale) / const(div, scale)
    id_ = const(1.0, scale) / d
    l = torch.clamp(nearest_int(0.5 * (id_[:, None] * scale - 1.0)), 0, top)
    return d, l.to(torch.int64), zero


def _f16_where(zero, v):
    return f16_bytes(torch.where(zero, 0.0, v))


# ----------------------------------------------------- the iq2 / iq3 searches

@dataclass(frozen=True)
class _Search:
    """What the iq2 / iq3 searches differ in (the reference's seven
    functions), kept as parameters."""
    kind: str                  # machinery
    bsz: int                   # elements per scale sub-block
    kmaxq: int                 # levels 0 .. kmaxq − 1
    cands: range               # the candidate steps is
    step: float                # id = (2·kmaxq − 1 + is·step) / max
    fold: bool                 # sign folding (else full sign bytes)
    eps: float                 # dead below (0: dead when max == 0)
    on_grid_init: bool         # is_on_grid before the sweep
    skip_on_grid: bool         # the refit redoes only the groups off the grid
    qp: bool                   # iq2_xxs: start from make_qp_quants, max = 3·its scale


_IQ3_XXS = _Search("iq3_256", 32, 8, range(-15, 16), 0.2, True, GROUP_MAX_EPS_IQ3_XXS,
                   False, True, False)
_IQ3_S = _Search("iq3_512", 32, 8, range(-9, 10), 0.2, False, 0.0, False, False, False)
_IQ2_XXS = _Search("iq2_xxs", 32, 3, range(-6, 7), 0.1, True, _EPS, True, False, True)
_IQ2_XS = _Search("iq2_xs", 16, 3, range(-9, 10), 0.1, True, _EPS, True, True, False)
_IQ2_S = _Search("iq2_s", 16, 3, range(-9, 10), 0.1, False, GROUP_MAX_EPS_IQ2_S, True, True,
                 False)


def _grid_search(p: _Search, xb, weight):
    """One search of `p` on every sub-block (N, bsz) (_quantize_iq3
    :369-458 and its iq2 siblings :660-734, :761-840, :870-956): the sweep
    of candidate scales, each snapping its groups to the lattice, the
    strict-greater update, the refit at the best scale and the sign flip.
    Returns (scale (N,), grid index (N, G), sign words (N, bsz/8)), zero
    where the sub-block is dead."""
    m = machinery(p.kind, xb.device)
    values = m.grid.to(torch.float32)[None]
    N = xb.shape[0]
    G = p.bsz // m.grid.shape[1]
    waux = sqrt(weight)
    if p.fold:
        xval, signs = _sign_fold(xb, weight)
    else:
        xval, signs = xb.abs(), _sign_bytes(xb)
    maxv = xval.amax(1)
    dead = maxv < p.eps if p.eps else maxv == 0
    safe = torch.where(dead, 1.0, maxv)
    top = p.kmaxq - 1
    if p.qp:
        scale, L = make_qp_quants(xval, weight, p.kmaxq + 1)
        # levels above top reach the packing only where the reference raises
        L = torch.clamp(L, 0, top)
        denom = scale * float(p.kmaxq)
        on_grid = None
    else:
        scale = safe / const(2 * p.kmaxq - 1, xb)
        L = torch.zeros_like(xb)
        denom = safe
        on_grid = torch.full((N, G), p.on_grid_init, device=xb.device)
    best = torch.zeros_like(scale)
    for is_ in p.cands:
        num = _f32(np.float32(2 * p.kmaxq - 1) + np.float32(is_) * np.float32(p.step))
        id_ = const(num, xb) / denom
        laux = torch.clamp(nearest_int(0.5 * (id_[:, None] * xval - 1.0)), 0, top)
        laux, off = _snap(m, laux, xval, waux, const(1.0, xb) / id_, values)
        q = 2.0 * laux + 1.0
        sumqx, sumq2 = seq_sum(weight * xval * q), seq_sum(weight * q * q)
        upd = (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
        scale = torch.where(upd, sumqx / torch.where(upd, sumq2, 1.0), scale)
        best = torch.where(upd, scale * sumqx, best)
        L = torch.where(upd[:, None], laux, L)
        if on_grid is not None:
            on_grid = torch.where(upd[:, None], ~off, on_grid)
    if on_grid is None:
        redo = scale > 0
        want = redo[:, None].expand(N, G)
    else:
        redo = (~on_grid).any(1) & (scale > 0)
        want = redo[:, None] & (~on_grid if p.skip_on_grid else torch.ones_like(on_grid))
    if bool(redo.any()):
        s = torch.where(redo, scale, 1.0)
        l = torch.clamp(nearest_int(0.5 * ((const(1.0, xb) / s)[:, None] * xval - 1.0)), 0, top)
        lr = torch.where(want.repeat_interleave(p.bsz // G, 1), l, L)
        lr, _ = _snap(m, lr, xval, waux, s, values, want=want)
        q = 2.0 * lr + 1.0
        sumqx, sumq2 = seq_sum(weight * xval * q), seq_sum(weight * q * q)
        L = torch.where(redo[:, None], lr, L)
        fit = redo & (sumq2 > 0)
        scale = torch.where(fit, sumqx / torch.where(fit, sumq2, 1.0), scale)
    neg = scale < 0
    scale = torch.where(neg, -scale, scale)
    signs = torch.where(neg[:, None], ~signs & (127 if p.fold else 255), signs)
    gi = m.kmap[_pack(L.reshape(N, G, -1), 3 if p.kind.startswith("iq3") else 2)]
    gi = torch.clamp(gi, min=0)       # below 0 only where the reference raises
    return (torch.where(dead, 0.0, scale), torch.where(dead[:, None], 0, gi),
            torch.where(dead[:, None], 0, signs))


def _run(p: _Search, x, quant_weights, sigma2_double: bool, fallback: str):
    xs = _superblocks(x)
    xb, weight = _block_weights(xs, quant_weights, p.bsz, sigma2_double, fallback)
    scale, gi, signs = _grid_search(p, xb, weight)
    nbl, nsub = xs.shape[0], QK_K // p.bsz
    return (xs, scale.reshape(nbl, nsub), gi.reshape(nbl, nsub, -1),
            signs.reshape(nbl, nsub, -1))


def quantize_iq3_xxs(x, quant_weights=None):
    """IQ3_XXS (:471-479, _quantize_iq3 :351-468 at the 256-point grid)."""
    xs, scale, gi, signs = _run(_IQ3_XXS, x, quant_weights, True, "x2")
    d, l, zero = _scale_codes(scale, scale.amax(1), 31.0, 15)
    sas = signs[..., 0] | (signs[..., 1] << 7) | (signs[..., 2] << 14) | (signs[..., 3] << 21)
    sas = sas | torch.where(zero[:, None], 0, l << 28)
    nbl = xs.shape[0]
    qs = torch.cat([blocks.u8(gi.reshape(nbl, 64)), blocks.le_bytes(sas, 4).reshape(nbl, 32)], 1)
    return _out(x, blocks.join(BLOCK_IQ3_XXS, d=_f16_where(zero, d * _f32(1.0125)), qs=qs))


def quantize_iq3_s(x, quant_weights=None):
    """IQ3_S (:482-594): the 512-point grid, full sign bytes, every group
    refit."""
    xs, scale, gi, signs = _run(_IQ3_S, x, quant_weights, True, "x2")
    d, l, zero = _scale_codes(scale, scale.amax(1), 31.0, 15)
    nbl = xs.shape[0]
    k = torch.arange(8, device=xs.device)
    qh = ((gi >> 8) << k).sum(-1)                                   # (nbl, 8)
    l = torch.where(zero[:, None], 0, l).reshape(nbl, 4, 2)
    return _out(x, blocks.join(
        BLOCK_IQ3_S, d=_f16_where(zero, d * _f32(1.033)), qs=blocks.u8(gi.reshape(nbl, 64)),
        qh=blocks.u8(qh), signs=blocks.u8(signs.reshape(nbl, 32)),
        scales=blocks.u8(l[..., 0] | (l[..., 1] << 4))))


def quantize_iq2_xxs(x, quant_weights):
    """IQ2_XXS (:648-745); the importance row is required."""
    xs, scale, gi, signs = _run(_IQ2_XXS, x, quant_weights, False, "")
    d, l, zero = _scale_codes(scale, scale.amax(1), 31.0, 15)
    k = torch.arange(4, device=xs.device)
    w0 = (gi << (8 * k)).sum(-1)
    w1 = (signs << (7 * k)).sum(-1) | (l << 28)
    q2 = torch.where(zero[:, None, None], 0, torch.stack([w0, w1], -1))
    nbl = xs.shape[0]
    return _out(x, blocks.join(BLOCK_IQ2_XXS, d=_f16_where(zero, d),
                               qs=blocks.le_bytes(q2, 4).reshape(nbl, 64)))


def _nibbles(l, zero):
    l = torch.where(zero[:, None], 0, l).reshape(l.shape[0], -1, 2)
    return blocks.u8(l[..., 0] | (l[..., 1] << 4))


def quantize_iq2_xs(x, quant_weights):
    """IQ2_XS (:748-854); the importance row is required."""
    xs, scale, gi, signs = _run(_IQ2_XS, x, quant_weights, False, "")
    d, l, zero = _scale_codes(scale, scale.amax(1), 31.0, 15)
    nbl = xs.shape[0]
    q2 = torch.where(zero[:, None], 0, (gi | (signs << 9)).reshape(nbl, 32))
    return _out(x, blocks.join(BLOCK_IQ2_XS, d=_f16_where(zero, d),
                               qs=blocks.le_bytes(q2, 2).reshape(nbl, 64),
                               scales=_nibbles(l, zero)))


def quantize_iq2_s(x, quant_weights=None):
    """IQ2_S (:857-969): the 1024-point grid, full sign bytes, 0.25·sigma2
    + x² weights without an importance row."""
    xs, scale, gi, signs = _run(_IQ2_S, x, quant_weights, True, "sigma")
    d, l, zero = _scale_codes(scale, scale.amax(1), 31.0, 15)
    nbl = xs.shape[0]
    gi = gi.reshape(nbl, 32)
    k = torch.arange(4, device=xs.device)
    qh = ((gi.reshape(nbl, 8, 4) >> 8) << (2 * k)).sum(-1)
    qs = torch.cat([blocks.u8(gi), blocks.u8(signs.reshape(nbl, 32))], 1)
    return _out(x, blocks.join(BLOCK_IQ2_S, d=_f16_where(zero, d * _f32(0.9875)), qs=qs,
                               qh=blocks.u8(qh), scales=_nibbles(l, zero)))


# ----------------------------------------------------------- the iq1 searches

X_P = (-0.875, 0.125, 1.125)         # the shifted ternary codebooks, exact in f32
X_M = (-1.125, -0.125, 0.875)
_IQ1M_MASKS = (0x00, 0x80, 0x08, 0x88)
_IQ1_CHUNK = 4096                    # sub-blocks per iq1_m candidate tensor


def _iq1_values(m: Machinery) -> torch.Tensor:
    """(2, S, 8): each grid point through the codebook x_p (0) and x_m (1)."""
    lv = (m.grid - 1) // 2
    return torch.stack([torch.tensor(v, device=lv.device)[lv] for v in (X_P, X_M)])


def _pairs(n: int, device):
    """The splits (i1, i2), 0 ≤ i1 ≤ i2 ≤ n, in the reference's loop order."""
    i1, i2 = zip(*[(a, b) for a in range(n + 1) for b in range(a, n + 1)])
    return torch.tensor(i1, device=device), torch.tensor(i2, device=device)


def _sweep(sumqx, sumq2, init_scale):
    """The sequential candidate loop with -inf start (:1030-1042,
    :1145-1162): (scale, index of the winning candidate, -1 if none)."""
    best = torch.full_like(init_scale, -torch.inf)
    scale = init_scale.clone()
    pick = torch.full(init_scale.shape, -1, dtype=torch.int64, device=init_scale.device)
    for c in range(sumqx.shape[1]):
        sx, s2 = sumqx[:, c], sumq2[:, c]
        upd = (s2 > 0) & (sx * sx > best * s2)
        scale = torch.where(upd, sx / torch.where(upd, s2, 1.0), scale)
        best = torch.where(upd, scale * sx, best)
        pick = torch.where(upd, c, pick)
    return scale, pick


def _levels(order, i1, i2):
    """L of the split (i1, i2) of the sorted sub-block: 0 below i1, 1 below
    i2, else 2, in the sub-block's own order."""
    j = torch.arange(order.shape[1], device=order.device)
    ls = (j >= i1[:, None]).to(torch.int64) + (j >= i2[:, None]).to(torch.int64)
    return torch.empty_like(ls).scatter_(1, order, ls)


def _iq1_snap(m, L, xb, weight, scale, sel):
    """Grid indices of the 8-groups of L (N, bsz), each off the grid
    replaced by its best neighbour in the codebook of sel (N, G); and
    whether any group was off."""
    N, bsz = L.shape
    u = _pack(L.reshape(N, -1, 8), 2)
    gi = m.kmap[u]
    off = gi < 0
    if bool(off.any()):
        r, g = torch.nonzero(off, as_tuple=True)
        gi = gi.clone()
        gi[r, g] = _best_neighbour(m, u[r, g], xb.reshape(N, -1, 8)[r, g],
                                   weight.reshape(N, -1, 8)[r, g], scale[r],
                                   _iq1_values(m), sel[r, g])
    return gi, off.any(1)


def _iq1_group_sums(m, gi, sel, xb, weight, mult=None):
    """Per 8-group seq_sum(w·q·x) and seq_sum(w·q·q), (N, G) each, q the
    codebook values of the group's grid point (times mult (N, 1, 1))."""
    N = gi.shape[0]
    q = _iq1_values(m)[sel, gi]                                      # (N, G, 8)
    if mult is not None:
        q = q * mult
    w8, x8 = weight.reshape(N, -1, 8), xb.reshape(N, -1, 8)
    return seq_sum(w8 * q * x8), seq_sum(w8 * q * q)


def _from_zero(s):
    """0 + s_0 + s_1 + ... in order over the last axis (a running f32 sum
    that starts at 0.0, as the reference's refits do)."""
    return seq_sum(torch.cat([torch.zeros_like(s[..., :1]), s], -1))


def _iq1_sort(xb):
    """np.argsort(kind="stable"): −0.0 and 0.0 compare equal."""
    return torch.sort(xb + 0.0, dim=1, stable=True).indices


def quantize_iq1_s(x, quant_weights):
    """IQ1_S (:983-1097): the exact ternary split search over sorted prefix
    sums, the grid snap with the neighbour fallback, the refit, 3-bit
    scales and the shift bit. The importance row is required."""
    xs = _superblocks(x)
    xb, weight = _block_weights(xs, quant_weights, 32, True, "")
    m = machinery("iq1", xb.device)
    N = xb.shape[0]
    maxv = xb.abs().amax(1)
    dead = maxv < GROUP_MAX_EPS_IQ1_S
    order = _iq1_sort(xb)
    wx_s, w_s = (weight * xb).gather(1, order), weight.gather(1, order)
    sumx = torch.zeros(N, 33, device=xb.device)
    sumw = torch.zeros_like(sumx)
    for j in range(32):
        sumx[:, j + 1] = sumx[:, j] + wx_s[:, j]
        sumw[:, j + 1] = sumw[:, j] + w_s[:, j]
    i1, i2 = _pairs(32, xb.device)
    a, b, c = sumx[:, i1] - sumx[:, :1], sumx[:, i2] - sumx[:, i1], sumx[:, 32:] - sumx[:, i2]
    aw, bw, cw = sumw[:, i1] - sumw[:, :1], sumw[:, i2] - sumw[:, i1], sumw[:, 32:] - sumw[:, i2]
    sx = torch.stack([(a * v[0] + b * v[1]) + c * v[2] for v in (X_P, X_M)], -1)
    s2 = torch.stack([(aw * v[0] * v[0] + bw * v[1] * v[1]) + cw * v[2] * v[2]
                      for v in (X_P, X_M)], -1)
    scale, pick = _sweep(sx.reshape(N, -1), s2.reshape(N, -1), maxv)
    pick = torch.clamp(pick, min=0)
    shift = torch.where(pick % 2 == 0, 1, -1)
    L = _levels(order, i1[pick // 2], i2[pick // 2])
    neg = scale < 0
    L = torch.where(neg[:, None], 2 - L, L)
    scale = torch.where(neg, -scale, scale)
    shift = torch.where(neg, -shift, shift)
    sel = (shift == -1).to(torch.int64)[:, None].expand(N, 4)
    gi, any_off = _iq1_snap(m, L, xb, weight, scale, sel)
    sumqx, sumq2 = (_from_zero(t) for t in _iq1_group_sums(m, gi, sel, xb, weight))
    fit = any_off & (sumqx > 0) & (sumq2 > 0)
    scale = torch.where(fit, sumqx / torch.where(fit, sumq2, 1.0), scale)
    scale = torch.where(dead, 0.0, scale).reshape(-1, 8)
    gi = torch.where(dead[:, None], 0, gi).reshape(-1, 8, 4)
    shift = torch.where(dead, 0, shift).reshape(-1, 8)
    d, l, zero = _scale_codes(scale, scale.amax(1), 15.0, 7)
    k = torch.arange(4, device=xs.device)
    h = ((gi >> 8) << (3 * k)).sum(-1)
    qh = h | torch.where(zero[:, None], 0, (l | torch.where(shift == -1, 8, 0)) << 12)
    return _out(x, blocks.join(BLOCK_IQ1_S, d=_f16_where(zero, d * _f32(1.125)),
                               qs=blocks.u8(gi.reshape(-1, 32)),
                               qh=blocks.le_bytes(qh, 2).reshape(-1, 16)))


def _iq1_m_sums(w_s, x_s, lower, i1, i2):
    """(N, 612) sumqx and sumq2 of every (i1, i2, k) candidate, k the
    codebook combination (first half, second half) = (+,+), (+,−), (−,+),
    (−,−), each a left-to-right sum over the sorted sub-block."""
    dev = w_s.device
    j = torch.arange(16, device=dev)
    g = (j >= i1[:, None]).to(torch.int64) + (j >= i2[:, None]).to(torch.int64)
    vp, vm = (torch.tensor(v, device=dev)[g] for v in (X_P, X_M))   # (153, 16)
    sx, s2 = [], []
    for k in range(4):
        first, second = (vp if k < 2 else vm), (vp if k % 2 == 0 else vm)
        q = torch.where(lower[:, None, :], first[None], second[None])
        wq = w_s[:, None, :] * q
        sx.append(seq_sum(wq * x_s[:, None, :]))
        s2.append(seq_sum(wq * q))
    return torch.stack(sx, -1).reshape(len(w_s), -1), torch.stack(s2, -1).reshape(len(w_s), -1)


def quantize_iq1_m(x, quant_weights=None):
    """IQ1_M (:1100-1238): 16-element sub-blocks, a codebook shift per
    8-element half (four combinations), the exact split search, the grid
    snap, and the block-global refit of d, whose f16 bits go into the top
    nibbles of the scale words."""
    xs = _superblocks(x)
    xb, weight = _block_weights(xs, quant_weights, 16, True, "x2")
    m = machinery("iq1", xb.device)
    N = xb.shape[0]
    maxv = xb.abs().amax(1)
    dead = maxv < GROUP_MAX_EPS_IQ1_M
    order = _iq1_sort(xb)
    lower = order < 8
    w_s, x_s = weight.gather(1, order), xb.gather(1, order)
    i1, i2 = _pairs(16, xb.device)
    scale = torch.empty_like(maxv)
    pick = torch.empty(N, dtype=torch.int64, device=xb.device)
    for c0 in range(0, N, _IQ1_CHUNK):
        sl = slice(c0, c0 + _IQ1_CHUNK)
        sx, s2 = _iq1_m_sums(w_s[sl], x_s[sl], lower[sl], i1, i2)
        scale[sl], pick[sl] = _sweep(sx, s2, maxv[sl])
    pick = torch.clamp(pick, min=0)
    combo = pick % 4
    L = _levels(order, i1[pick // 4], i2[pick // 4])
    neg = scale < 0
    L = torch.where(neg[:, None], 2 - L, L)
    scale = torch.where(neg, -scale, scale)
    combo = torch.where(neg, 3 - combo, combo)
    sel = torch.stack([combo >= 2, combo % 2 == 1], 1).to(torch.int64)
    gi, any_off = _iq1_snap(m, L, xb, weight, scale, sel)
    sumqx, sumq2 = (_from_zero(t) for t in _iq1_group_sums(m, gi, sel, xb, weight))
    fit = any_off & (sumqx > 0) & (sumq2 > 0)
    scale = torch.where(fit, sumqx / torch.where(fit, sumq2, 1.0), scale)
    nbl = xs.shape[0]
    scale = torch.where(dead, 0.0, scale).reshape(nbl, 16)
    gi = torch.where(dead[:, None], 0, gi)
    combo = torch.where(dead, 0, combo)
    sel = torch.where(dead[:, None], 0, sel)
    # the super-block epilogue (:1209-1237): 3-bit scales, the shift masks,
    # and d refit over every group in order with the coded scales
    d, l, zero = _scale_codes(scale, scale.amax(1), 15.0, 7)
    mult = (2 * l + 1).to(torch.float32).reshape(-1)[:, None, None]
    sumqx, sumq2 = (_from_zero(t.reshape(nbl, 32))
                    for t in _iq1_group_sums(m, gi, sel, xb, weight, mult))
    d = torch.where(sumq2 > 0, sumqx / torch.where(sumq2 > 0, sumq2, 1.0), d)
    su16 = torch.where(zero, 0.0, d * _f32(1.1125)).to(torch.float16).view(torch.int16)
    su16 = su16.to(torch.int64) & 0xFFFF
    k = torch.arange(4, device=xs.device)
    sc = (l.reshape(nbl, 4, 4) << (3 * k)).sum(-1)
    sc = sc | torch.stack([(su16 & 0x000F) << 12, (su16 & 0x00F0) << 8,
                           (su16 & 0x0F00) << 4, su16 & 0xF000], 1)
    sc = torch.where(zero[:, None], 0, sc)
    gi = gi.reshape(nbl, 16, 2)
    masks = torch.tensor(_IQ1M_MASKS, device=xs.device)[combo.reshape(nbl, 16)]
    qh = (gi[..., 0] >> 8) | ((gi[..., 1] >> 8) << 4) | torch.where(zero[:, None], 0, masks)
    return _out(x, blocks.join(BLOCK_IQ1_M, qs=blocks.u8(gi.reshape(nbl, 32)),
                               qh=blocks.u8(qh), scales=blocks.le_bytes(sc, 2).reshape(nbl, 8)))
