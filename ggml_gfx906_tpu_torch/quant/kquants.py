"""K-quant scale packing (numpy), copied from ggml_gfx906_tpu/quant/kquants.py.

Only the piece the port needs to build Q4_K and Q5_K wire blocks with constructed
scales (chip_smoke.py's 7B-shape GGUF recipe); the quantizers themselves are
a later slice.
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
