"""The benchmark's own block formats: random valid GGUF wire blocks made on
a device from a seeded `torch.Generator`, and a frozen plain dequantization
of them. Imports torch only, so the reference (ref/) can use it.

Four block types, as ggml lays them out (ggml-common.h):

    Q4_K  256 weights, 144 bytes: d f16 | dmin f16 | scales[12] | qs[128]
    Q5_K  256 weights, 176 bytes: d f16 | dmin f16 | scales[12] | qh[32] | qs[128]
    Q6_K  256 weights, 210 bytes: ql[128] | qh[64] | scales[16] i8 | d f16
    Q8_0   32 weights,  34 bytes: d f16 | qs[32] i8

The quant bytes are uniform random; the scale fields are drawn so that
every weight is finite and about N(0, 0.02) (block scale ×U(0.85, 1.15),
six-bit sub-scales drawn and the mins set to centre the quants), so the
dequantization's scale paths see more than one value.
"""
from __future__ import annotations

import zlib

import torch

# type → (weights per block, bytes per block)
BLOCK = {"Q4_K": (256, 144), "Q5_K": (256, 176), "Q6_K": (256, 210), "Q8_0": (32, 34)}
# the sub-scales drawn per type (inclusive range) and the block scale
# e that gives weights of std ~0.02 at the mean sub-scale
_SC = {"Q4_K": (24, 33), "Q5_K": (24, 32), "Q6_K": (12, 20)}
_E = {"Q4_K": 0.02 / (28.5 * 4.610), "Q5_K": 0.02 / (28.0 * 9.233),
      "Q6_K": 0.02 / (16.0 * 18.47), "Q8_0": 0.02 / 73.9}
# dmin / d, and the mean quant that the mins centre (Q4_K 7.5, Q5_K 15.5)
_DMIN = {"Q4_K": (4.0, 7.5), "Q5_K": (8.0, 15.5)}


def row_bytes(qtype: str, cols: int) -> int:
    n, size = BLOCK[qtype]
    if cols % n:
        raise ValueError(f"{qtype} rows of {cols} are not whole blocks of {n}")
    return cols // n * size


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of one named tensor of a run seeded `seed`: the
    same tensor gets the same bytes whichever side makes it, in any order."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 62)


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(tensor_seed(seed, name))
    return g


def _f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """(..., nb) f32 → (..., nb, 2) u8, little-endian f16."""
    return x.to(torch.float16).contiguous().view(torch.uint8).reshape(*x.shape, 2)


def pack_scale_min_k4(sc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 8) six-bit sc and m → (..., 12) u8, the inverse of ggml's
    get_scale_min_k4."""
    sc, m = sc.to(torch.uint8), m.to(torch.uint8)
    lo = sc[..., :4] | ((sc[..., 4:] >> 4) << 6)
    mid = m[..., :4] | ((m[..., 4:] >> 4) << 6)
    hi = (sc[..., 4:] & 0xF) | ((m[..., 4:] & 0xF) << 4)
    return torch.cat([lo, mid, hi], dim=-1)


def unpack_scale_min_k4(q: torch.Tensor):
    """ggml's get_scale_min_k4 over (..., 12) u8 → (sc, m), each (..., 8)."""
    sc = torch.cat([q[..., 0:4] & 63, (q[..., 8:12] & 0xF) | ((q[..., 0:4] >> 6) << 4)], -1)
    m = torch.cat([q[..., 4:8] & 63, (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)], -1)
    return sc, m


def make_blocks(qtype: str, rows: int, cols: int, gen: torch.Generator,
                device) -> torch.Tensor:
    """(rows, row_bytes) u8 wire blocks of `qtype`, random and valid, drawn
    on `device` from `gen` in a few calls."""
    n, size = BLOCK[qtype]
    nb = cols // n
    row_bytes(qtype, cols)
    raw = torch.randint(0, 256, (rows, nb, size), dtype=torch.uint8, device=device,
                        generator=gen)
    u = torch.empty((rows, nb), device=device).uniform_(0.85, 1.15, generator=gen)
    d = u * _E[qtype]
    if qtype == "Q8_0":
        raw[..., 0:2] = _f16_bytes(d)
    elif qtype == "Q6_K":
        lo, hi = _SC[qtype]
        mag = torch.randint(lo, hi + 1, (rows, nb, 16), device=device, generator=gen)
        sign = torch.randint(0, 2, (rows, nb, 16), device=device, generator=gen) * 2 - 1
        raw[..., 192:208] = (mag * sign).to(torch.int8).view(torch.uint8)
        raw[..., 208:210] = _f16_bytes(d)
    else:
        lo, hi = _SC[qtype]
        ratio, centre = _DMIN[qtype]
        sc = torch.randint(lo, hi + 1, (rows, nb, 8), device=device, generator=gen)
        m = torch.round(sc.float() * (centre / ratio)).to(torch.int64)
        raw[..., 0:2] = _f16_bytes(d)
        raw[..., 2:4] = _f16_bytes(d * ratio)
        raw[..., 4:16] = pack_scale_min_k4(sc, m)
    return raw.reshape(rows, nb * size)


def _f16(raw: torch.Tensor, at: int) -> torch.Tensor:
    return raw[..., at:at + 2].contiguous().view(torch.float16)[..., 0].float()


def dequantize(qtype: str, raw: torch.Tensor, cols: int) -> torch.Tensor:
    """(rows, row_bytes) u8 wire blocks → (rows, cols) f32, as ggml's
    dequantize_row_* computes each weight."""
    n, size = BLOCK[qtype]
    rows = raw.shape[0]
    b = raw.reshape(rows, cols // n, size)
    if qtype == "Q8_0":
        return (_f16(b, 0)[..., None] * b[..., 2:34].view(torch.int8).float()).reshape(rows, cols)
    if qtype == "Q6_K":
        ql, qh = b[..., 0:128], b[..., 128:192]
        sc = b[..., 192:208].view(torch.int8).float()
        d = _f16(b, 208)
        out = []
        for h in range(2):                       # two halves of 128 weights
            l_lo, l_hi = ql[..., 64 * h:64 * h + 32], ql[..., 64 * h + 32:64 * h + 64]
            hh = qh[..., 32 * h:32 * h + 32]
            qs = [(l_lo & 0xF) | (((hh >> 0) & 3) << 4), (l_hi & 0xF) | (((hh >> 2) & 3) << 4),
                  (l_lo >> 4) | (((hh >> 4) & 3) << 4), (l_hi >> 4) | (((hh >> 6) & 3) << 4)]
            for i, q in enumerate(qs):           # quarter i: scales 8h + 2i, 8h + 2i + 1
                s = sc[..., 8 * h + 2 * i:8 * h + 2 * i + 2].repeat_interleave(16, dim=-1)
                out.append(d[..., None] * s * (q.float() - 32.0))
        return torch.cat(out, dim=-1).reshape(rows, cols)
    d, dmin = _f16(b, 0), _f16(b, 2)
    sc, m = unpack_scale_min_k4(b[..., 4:16])
    qs = b[..., 48:176] if qtype == "Q5_K" else b[..., 16:144]
    out = []
    for j in range(4):                           # 64 weights per 32 quant bytes
        q = qs[..., 32 * j:32 * j + 32]
        lo, hi = (q & 0xF).float(), (q >> 4).float()
        if qtype == "Q5_K":
            qh = b[..., 16:48]
            lo = lo + ((qh >> (2 * j)) & 1).float() * 16
            hi = hi + ((qh >> (2 * j + 1)) & 1).float() * 16
        for half, q4 in ((0, lo), (1, hi)):
            k = 2 * j + half
            d1 = d * sc[..., k].float()
            m1 = dmin * m[..., k].float()
            out.append(d1[..., None] * q4 - m1[..., None])
    return torch.cat(out, dim=-1).reshape(rows, cols)


def dense(seed: int, name: str, shape: tuple, device, std: float = 0.02) -> torch.Tensor:
    """A small f32 tensor ~N(0, std²) (a router, a bias, position
    embeddings), drawn on `device` from the tensor's own generator."""
    return torch.randn(shape, device=device, generator=generator(seed, name, device)) * std


def wire(seed: int, name: str, qtype: str, rows: int, cols: int, device) -> torch.Tensor:
    """The wire blocks of one named matrix (or stack of expert matrices,
    rows counting every expert's) of a run seeded `seed`."""
    return make_blocks(qtype, rows, cols, generator(seed, name, device), device)
