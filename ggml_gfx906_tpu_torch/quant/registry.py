"""Codec dispatch: quantize / dequantize by GGMLType, on tensors.

The port of ggml_gfx906_tpu/quant/registry.py (ggml's type-traits table,
include/ggml.h:2439-2449, and ggml_quantize_chunk, src/ggml.c:6989), with
its type tables. Every codec runs on the device of the tensor it is given:
the card when the caller hands it CUDA tensors, the CPU otherwise; none
moves data between devices. `quantize` returns the wire bytes as a uint8
tensor of (rows, row_size), which QuantTensor.from_wire takes as it is;
`dequantize` takes such bytes and returns f32 (rows, n_per_row).

The seven IQ grid searches (IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS, IQ2_S,
IQ3_XXS, IQ3_S) go through ops/cuda/iq_search.py: their plain versions on
the CPU, the kernels S1-S3 on the card. IQ2_XXS, IQ2_XS and IQ1_S need an
importance row: without one `quantize` raises NotImplementedError, where
the reference's table lookup raises KeyError.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import iquants, kquants, legacy, modern
from .types import GGMLType, TYPE_TRAITS, row_size


def _search(t: GGMLType, x, quant_weights=None):
    """An IQ grid search (ops/cuda/iq_search.py; imported here at the call,
    since the ops package imports this module)."""
    from ..ops.cuda import iq_search
    return iq_search.quantize(t, x, quant_weights)


def _searches(*types) -> dict:
    return {t: functools.partial(_search, t) for t in types}


# codecs taking an importance matrix (ggml_quantize_chunk's imatrix,
# include/ggml.h:2406-2416)
_QUANTIZE_IMATRIX = {
    GGMLType.Q4_0: legacy.quantize_q4_0_imatrix,
    GGMLType.Q4_1: legacy.quantize_q4_1_imatrix,
    GGMLType.Q5_0: legacy.quantize_q5_0_imatrix,
    GGMLType.Q5_1: legacy.quantize_q5_1_imatrix,
    GGMLType.Q2_K: kquants.quantize_q2_K_imatrix,
    GGMLType.Q3_K: kquants.quantize_q3_K_imatrix,
    GGMLType.Q4_K: kquants.quantize_q4_K_imatrix,
    GGMLType.Q5_K: kquants.quantize_q5_K_imatrix,
    GGMLType.Q6_K: kquants.quantize_q6_K_imatrix,
    GGMLType.IQ4_NL: modern.quantize_iq4_nl,
    GGMLType.IQ4_XS: modern.quantize_iq4_xs,
    **_searches(GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ2_XXS, GGMLType.IQ2_XS,
                GGMLType.IQ2_S, GGMLType.IQ1_S, GGMLType.IQ1_M),
}

# types whose reference chunk API accepts but ignores the imatrix
# (quantize_q8_0 src/ggml-quants.c:2091, quantize_mxfp4 :2098,
# quantize_tq1_0 / tq2_0 :2710-2730)
_IMATRIX_IGNORED = {
    GGMLType.Q8_0, GGMLType.Q8_1, GGMLType.MXFP4,
    GGMLType.TQ1_0, GGMLType.TQ2_0,
}

_QUANTIZE = {
    GGMLType.Q4_0: legacy.quantize_q4_0,
    GGMLType.Q4_1: legacy.quantize_q4_1,
    GGMLType.Q5_0: legacy.quantize_q5_0,
    GGMLType.Q5_1: legacy.quantize_q5_1,
    GGMLType.Q8_0: legacy.quantize_q8_0,
    GGMLType.Q8_1: legacy.quantize_q8_1,
    GGMLType.Q2_K: kquants.quantize_q2_K,
    GGMLType.Q3_K: kquants.quantize_q3_K,
    GGMLType.Q4_K: kquants.quantize_q4_K,
    GGMLType.Q5_K: kquants.quantize_q5_K,
    GGMLType.Q6_K: kquants.quantize_q6_K,
    GGMLType.Q8_K: kquants.quantize_q8_K,
    GGMLType.MXFP4: modern.quantize_mxfp4,
    GGMLType.TQ1_0: modern.quantize_tq1_0,
    GGMLType.TQ2_0: modern.quantize_tq2_0,
    GGMLType.IQ4_NL: modern.quantize_iq4_nl,
    GGMLType.IQ4_XS: modern.quantize_iq4_xs,
    **_searches(GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ2_S, GGMLType.IQ1_M),
}

_DEQUANTIZE = {
    GGMLType.Q4_0: legacy.dequantize_q4_0,
    GGMLType.Q4_1: legacy.dequantize_q4_1,
    GGMLType.Q5_0: legacy.dequantize_q5_0,
    GGMLType.Q5_1: legacy.dequantize_q5_1,
    GGMLType.Q8_0: legacy.dequantize_q8_0,
    GGMLType.Q8_1: legacy.dequantize_q8_1,
    GGMLType.Q2_K: kquants.dequantize_q2_K,
    GGMLType.Q3_K: kquants.dequantize_q3_K,
    GGMLType.Q4_K: kquants.dequantize_q4_K,
    GGMLType.Q5_K: kquants.dequantize_q5_K,
    GGMLType.Q6_K: kquants.dequantize_q6_K,
    GGMLType.Q8_K: kquants.dequantize_q8_K,
    GGMLType.MXFP4: modern.dequantize_mxfp4,
    GGMLType.TQ1_0: modern.dequantize_tq1_0,
    GGMLType.TQ2_0: modern.dequantize_tq2_0,
    GGMLType.IQ4_NL: modern.dequantize_iq4_nl,
    GGMLType.IQ4_XS: modern.dequantize_iq4_xs,
    GGMLType.IQ2_XXS: iquants.dequantize_iq2_xxs,
    GGMLType.IQ2_XS: iquants.dequantize_iq2_xs,
    GGMLType.IQ2_S: iquants.dequantize_iq2_s,
    GGMLType.IQ3_XXS: iquants.dequantize_iq3_xxs,
    GGMLType.IQ3_S: iquants.dequantize_iq3_s,
    GGMLType.IQ1_S: iquants.dequantize_iq1_s,
    GGMLType.IQ1_M: iquants.dequantize_iq1_m,
}

# the elements of one chunk of rows: the searches keep ~20 f32 intermediates
# of their input's size alive, so a 32000 x 4096 tensor is cut into chunks
# (rows are independent)
_CHUNK = 1 << 25


def supported_quant_types() -> list[GGMLType]:
    """The types `quantize` takes without an importance row (the
    reference's)."""
    return sorted(_QUANTIZE)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def quantize(t: GGMLType, x, quant_weights=None) -> torch.Tensor:
    """f32 (rows, n) (or (n,)) → the wire bytes, uint8 (rows, row_size(t,
    n)), on x's device. quant_weights: an importance row (n,) applied to
    every row (the imatrix), for the types of _QUANTIZE_IMATRIX; the types
    of _IMATRIX_IGNORED ignore it, any other raises."""
    x = _as_tensor(x).to(torch.float32)
    n = x.shape[-1]
    rows = x.reshape(-1, n)
    if n % TYPE_TRAITS[t].blck_size:
        raise ValueError(f"{t.name}: row length {n} is not a multiple of "
                         f"{TYPE_TRAITS[t].blck_size}")
    if quant_weights is not None:
        if t in _QUANTIZE_IMATRIX:
            qw = _as_tensor(quant_weights).to(device=x.device, dtype=torch.float32)
            if qw.numel() != n:
                raise ValueError(f"importance row of {qw.numel()} for rows of {n}")
            fn = lambda r: _QUANTIZE_IMATRIX[t](r, qw)  # noqa: E731
        elif t in _IMATRIX_IGNORED:
            fn = _QUANTIZE[t]
        else:
            raise NotImplementedError(f"{t.name} has no imatrix-aware path")
    elif t not in _QUANTIZE:
        raise NotImplementedError(f"{t.name} has no quantizer"
                                  + (" without an importance row (imatrix)"
                                     if t in _QUANTIZE_IMATRIX else ""))
    else:
        fn = _QUANTIZE[t]
    step = max(1, _CHUNK // n)
    rs = row_size(t, n)
    parts = [fn(rows[i:i + step]).reshape(-1, rs) for i in range(0, rows.shape[0], step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def dequantize(t: GGMLType, raw, n_per_row: int) -> torch.Tensor:
    """Wire bytes (uint8, any shape holding whole rows) → f32 (rows,
    n_per_row), on raw's device."""
    if isinstance(raw, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(raw, dtype=np.uint8)
    if not isinstance(raw, torch.Tensor):
        raw = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True))
    tt = TYPE_TRAITS[t]
    if t in (GGMLType.F32, GGMLType.F16):
        dt = torch.float32 if t == GGMLType.F32 else torch.float16
        return raw.reshape(-1).view(dt).to(torch.float32).reshape(-1, n_per_row)
    if t == GGMLType.BF16:
        return raw.reshape(-1).view(torch.bfloat16).to(torch.float32).reshape(-1, n_per_row)
    nb = n_per_row // tt.blck_size
    blk = raw.reshape(-1, nb, tt.type_size)
    return _DEQUANTIZE[t](blk).reshape(-1, n_per_row)


def quantize_to_bytes(t: GGMLType, x) -> bytes:
    """Row-major wire bytes, the layout of ggml_quantize_chunk's output."""
    return quantize(t, x).cpu().numpy().tobytes()


def bytes_to_blocks(t: GGMLType, data, n_per_row: int, n_rows: int | None = None
                    ) -> np.ndarray:
    """View wire bytes as a numpy structured block array (rows,
    n_per_row / blck) (GGUFReader.tensor_blocks' view)."""
    tt = TYPE_TRAITS[t]
    buf = np.frombuffer(data, dtype=np.uint8)
    rs = row_size(t, n_per_row)
    if n_rows is None:
        if buf.size % rs:
            raise ValueError(f"{buf.size} bytes are not whole rows of {rs}")
        n_rows = buf.size // rs
    return buf[: n_rows * rs].view(tt.block_dtype).reshape(n_rows, n_per_row // tt.blck_size)


def dequantize_bytes(t: GGMLType, data, n_per_row: int, n_rows: int | None = None
                     ) -> torch.Tensor:
    """Wire bytes (bytes or a uint8 array) → f32 (rows, n_per_row) on the
    CPU."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return dequantize(t, buf if n_rows is None else buf[: n_rows * row_size(t, n_per_row)],
                      n_per_row)
