"""K-quant scale packing (numpy), copied from ggml_gfx906_tpu/quant/kquants.py.

Only the pieces the port needs to build Q3_K, Q4_K and Q5_K wire blocks with
constructed scales (chip_smoke.py's 7B-shape GGUF recipes); the quantizers
themselves are a later slice.
"""
from __future__ import annotations

import numpy as np


def pack_scale_min_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """Pack 8 6-bit scales + 8 6-bit mins into 12 bytes.
    ref: quantize_row_q4_K_ref packing src/ggml-quants.c:1312-1326."""
    nb = ls.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    for j in range(8):
        s, m = ls[:, j].astype(np.uint8), lm[:, j].astype(np.uint8)
        if j < 4:
            out[:, j] = s
            out[:, j + 4] = m
        else:
            out[:, j + 4] = (s & 0xF) | ((m & 0xF) << 4)
            out[:, j - 4] |= (s >> 4) << 6
            out[:, j] |= (m >> 4) << 6
    return out


def pack_q3_scales(sc: np.ndarray) -> np.ndarray:
    """Pack (..., 16) signed 6-bit scales (-32..31) into Q3_K's 12 bytes: the
    low nibbles of scales j and j + 8 in byte j (j < 8), the two high bits of
    scale j at bits 2·(j // 4) of byte 8 + j % 4.
    ref: the packing in quantize_row_q3_K_ref (src/ggml-quants.c:1052-1126),
    as ggml_gfx906_tpu/quant/kquants.py::quantize_q3_K writes it."""
    lv = (np.asarray(sc) + 32).astype(np.uint8)
    out = np.zeros(lv.shape[:-1] + (12,), dtype=np.uint8)
    for j in range(16):
        if j < 8:
            out[..., j] |= lv[..., j] & 0xF
        else:
            out[..., j - 8] |= (lv[..., j] & 0xF) << 4
        out[..., 8 + j % 4] |= (lv[..., j] >> 4) << (2 * (j // 4))
    return out
