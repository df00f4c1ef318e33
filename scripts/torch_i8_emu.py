"""The arithmetic of K5-i8's and K6-i8's operand preparation on the int8
body (csrc/qmm_q8_0.cu format Q80I8, csrc/qmm_q4_0.cu format Q40I8) and of
the x quantization the int8 kernels share (csrc/qmm_i8_tiled.cuh,
quant_x), written out in numpy float32 as the kernels form it, to check
the designs on the CPU.

    python3 scripts/torch_i8_emu.py

The fold (`q80_fold`, `q40_fold`): per (row, tile) from the block scales d
alone, the bound qmax·|d| per block (127 for Q8_0 over the tile's 4
blocks, 8 for Q4_0 over the span's 8), its amax, dw = amax/127, inv =
127/amax (0 when amax = 0), d' = d·inv, each step one f32 operation.

The expansion (`q80_expand`, `q40_expand`): a byte b under the exponent of
2^23 (Q8_0: q + 128; Q4_0: a nibble), minus 2^23 + c (c = 128 or 8), times
d', clamped to ±127 and rounded by the f32 sum with 1.5·2^23 (ties to
even); the int8 is the low byte of the sum's bits.

The x quantization (`quant_x`): one warp per (row, 256-element span), lane
l holding elements 8l .. 8l+7; the map of each format (XMAPS, the structs
XQ4K, XQ40 and XQ80 of the header) says which of the span's two tiles and
which place in it the lane's elements go to, and by which lane masks the
tile's amax meets in its xor butterfly.

Run as a script it prints whether each equals the plain operands of
ops/cuda (`prepare_i8`, `expand_w8`, `quantize_x`);
tests/test_torch_i8_tools.py holds the same. CPU only; imports torch and
numpy only.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

F32 = np.float32

# format → (tile(l), place(l), the four lane masks of the butterfly)
XMAPS = {
    "q4_K": (lambda l: (l >> 2) & 1, lambda l: 32 * (l >> 3) + 8 * (l & 3), (1, 2, 8, 16)),
    "q4_0": (lambda l: (l >> 1) & 1, lambda l: 16 * (l >> 2) + 8 * (l & 1), (1, 4, 8, 16)),
    "q8_0": (lambda l: l >> 4, lambda l: 8 * (l & 15), (1, 2, 4, 8)),
}


def _fold(d, blocks: int, qmax: float):
    n = d.shape[0]
    d3 = d.numpy().reshape(n, -1, blocks)
    amax = np.zeros(d3.shape[:2], F32)
    for b in range(blocks):
        amax = np.maximum(amax, F32(qmax) * np.abs(d3[:, :, b]))
    dw = amax / F32(127)
    inv = np.where(amax > 0, F32(127) / np.where(amax > 0, amax, F32(1)), F32(0)).astype(F32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, F32))  # noqa: E731
    return t((d3 * inv[..., None]).reshape(n, -1)), t(dw)


def q80_fold(d):
    """Q80I8's fold of d (N, K/32): (d', dw (N, K/128)), prepare_i8's."""
    return _fold(d, 4, 127.0)


def q40_fold(d):
    """Q40I8's fold of d (N, K/32): (d', dw (N, K/256)), one dw per span."""
    return _fold(d, 8, 8.0)


def _round_i8_bytes(v):
    v = np.minimum(np.maximum(v, F32(-127)), F32(127))
    bits = (v + F32(12582912.0)).view(np.uint32) & 0xFF
    return bits.astype(np.uint8).view(np.int8)


def _biased(b):
    """2^23 + b as the byte permute forms it: b under the exponent."""
    return (np.uint32(0x4B000000) | b.astype(np.uint32)).view(F32)


def q80_expand(qs, dsc_f):
    """Q80I8's int8 weights (N, K): q + 128 biased, minus 2^23 + 128."""
    n = qs.shape[0]
    b = (qs.numpy().view(np.uint8) ^ 0x80).reshape(n, -1, 32)
    v = (_biased(b) - F32(8388736.0)) * dsc_f.numpy().reshape(n, -1, 1)
    return torch.from_numpy(_round_i8_bytes(v).reshape(n, -1).copy())


def q40_expand(qs, dsc_f, high: bool):
    """Q40I8's int8 weights (N, K/2) of the low or the high nibbles, in qs
    byte order: the nibble biased, minus 2^23 + 8."""
    n = qs.shape[0]
    q = qs.numpy()
    b = ((q >> 4) if high else (q & 0xF)).reshape(n, -1, 16)
    v = (_biased(b) - F32(8388616.0)) * dsc_f.numpy().reshape(n, -1, 1)
    return torch.from_numpy(_round_i8_bytes(v).reshape(n, -1).copy())


def quant_x(x, fmt: str):
    """The x quantization as the warps of quant_x place it with fmt's map:
    (qx_0, ex_0, qx_1, ex_1) with the two tiles of each span apart (Q4_K,
    Q4_0: lo and hi (M, K/2), (M, K/256)), or (qx, ex) in K's order for
    Q8_0 ((M, K), (M, K/128)), whose K need only be a multiple of 128."""
    tile, place, masks = XMAPS[fmt]
    m, k = x.shape
    spans = -(-k // 256)
    xs = np.zeros((m, spans * 256), F32)
    xs[:, :k] = x.float().numpy()
    lanes = xs.reshape(m, spans, 32, 8)
    a = np.abs(lanes).max(-1)                        # each lane's amax over its 8
    for mask in masks:                               # the xor butterfly
        a = np.maximum(a, a[:, :, [lane ^ mask for lane in range(32)]])
    ex = a / F32(127)
    inv = np.where(a > 0, F32(127) / np.where(a > 0, a, F32(1)), F32(0)).astype(F32)
    q = np.clip(np.rint(lanes * inv[..., None]), -127, 127).astype(np.int8)
    qx = np.zeros((2, m, spans, 128), np.int8)
    e = np.zeros((2, m, spans), F32)
    for lane in range(32):
        h, p = tile(lane), place(lane)
        qx[h, :, :, p:p + 8] = q[:, :, lane]
        if p == 0:
            e[h] = ex[:, :, lane]
    t = torch.from_numpy
    if fmt == "q8_0":     # tile 2t + h of row m is K's tile: interleave, drop a padded tile
        qx8 = qx.transpose(1, 2, 0, 3).reshape(m, spans * 256)[:, :k]
        e8 = e.transpose(1, 2, 0).reshape(m, 2 * spans)[:, :k // 128]
        return t(np.ascontiguousarray(qx8)), t(np.ascontiguousarray(e8))
    return (t(qx[0].reshape(m, -1).copy()), t(e[0].copy()),
            t(qx[1].reshape(m, -1).copy()), t(e[1].copy()))


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from ggml_gfx906_tpu_torch.ops.cuda import qmm, qmm_q4_0, qmm_q8_0

    gen = torch.Generator().manual_seed(0)
    n, k = 16, 1024
    d = torch.rand((n, k // 32), generator=gen) * 1e-3
    d[0, :8] = 0
    d[1] *= -1
    x = torch.randn((6, k), generator=gen)
    x[2, :256] = 0
    qs8 = torch.randint(-128, 128, (n, k), dtype=torch.int8, generator=gen)
    qs4 = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=gen)
    eq = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))  # noqa: E731
    f8, f4 = q80_fold(d), q40_fold(d)
    print("Q8_0 fold bit-equal to prepare_i8:", eq(f8, qmm_q8_0.prepare_i8(x, d)[2:]))
    print("Q4_0 fold bit-equal to prepare_i8:", eq(f4, qmm_q4_0.prepare_i8(x, d)[4:]))
    print("Q8_0 expansion bit-equal to expand_w8:",
          torch.equal(q80_expand(qs8, f8[0]), qmm_q8_0.expand_w8(qs8, f8[0])))
    print("Q4_0 expansion bit-equal to expand_w8:",
          all(torch.equal(q40_expand(qs4, f4[0], h), qmm_q4_0.expand_w8(qs4, f4[0], h))
              for h in (False, True)))
    for fmt, mod in (("q4_K", qmm), ("q4_0", qmm_q4_0), ("q8_0", qmm_q8_0)):
        print(f"{fmt} x quantization bit-equal to quantize_x:", eq(quant_x(x, fmt),
                                                                   mod.quantize_x(x)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
