"""The IQ grid-search quantizers S1 (iq3), S2 (iq2) and S3 (iq1).

Kernel source: csrc/iq_search.cu (fuller notes there).

- S1 `iq3_search` (IQ3_XXS, IQ3_S), S2 `iq2_search` (IQ2_XXS, IQ2_XS,
  IQ2_S) and S3 `iq1_search` (IQ1_S, IQ1_M) replace no TPU kernel: the JAX
  package runs these searches as numpy loops over super-blocks
  (ggml_gfx906_tpu/quant/iquants.py:351-1238). Bound on the H100:
  operations (scalar f32 candidate sweeps and neighbour scans; the bytes
  in and out are a few per weight). Design: one thread per scale
  sub-block, one thread per super-block for its epilogue, every sum and
  sweep in the reference's order, built with --fmad=false.

Their plain versions are quant/iquants.py's quantize_iq*, which hold the
reference's bytes on the CPU. `quantize` runs those on CPU tensors and the
kernels on CUDA tensors, writing the wire bytes straight into the uint8
(rows, row size) tensor that quant/registry.py::quantize returns. There is
no PyTorch call that computes the same function (library: none).
"""
from __future__ import annotations

import functools

import torch

from ...quant import iquants
from ...quant.types import QK_K, GGMLType, row_size
from . import S1, S2, S3, build

# type → (kernel, entry point, type code, lattice tables, plain version)
ROUTES = {
    GGMLType.IQ3_XXS: (S1, "iq3_search", 0, "iq3_256", iquants.quantize_iq3_xxs),
    GGMLType.IQ3_S: (S1, "iq3_search", 1, "iq3_512", iquants.quantize_iq3_s),
    GGMLType.IQ2_XXS: (S2, "iq2_search", 0, "iq2_xxs", iquants.quantize_iq2_xxs),
    GGMLType.IQ2_XS: (S2, "iq2_search", 1, "iq2_xs", iquants.quantize_iq2_xs),
    GGMLType.IQ2_S: (S2, "iq2_search", 2, "iq2_s", iquants.quantize_iq2_s),
    GGMLType.IQ1_S: (S3, "iq1_search", 0, "iq1", iquants.quantize_iq1_s),
    GGMLType.IQ1_M: (S3, "iq1_search", 1, "iq1", iquants.quantize_iq1_m),
}

# the types whose reference quantizer asserts on a missing importance row
IMATRIX_REQUIRED = frozenset({GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ1_S})


@functools.cache
def kernel_tables(kind: str, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lattice tables as the kernels read them, once per device: grid
    int8 (S, dim), kmap int32, the neighbour lists as 16-bit words (every
    entry is below 2^15)."""
    m = iquants.machinery(kind, device)
    return (m.grid.to(torch.int8).contiguous(), m.kmap.to(torch.int32).contiguous(),
            m.neigh.to(torch.int16).contiguous())


def quantize_plain(qtype: GGMLType, x: torch.Tensor, quant_weights=None) -> torch.Tensor:
    """The plain version: f32 (rows, n) → uint8 (rows, row size)."""
    return ROUTES[qtype][4](x, quant_weights).reshape(x.shape[0], -1)


def quantize(qtype: GGMLType, x: torch.Tensor, quant_weights=None) -> torch.Tensor:
    """f32 (rows, n), n a multiple of 256, and an importance row (n,) or
    None → the wire bytes, uint8 (rows, row_size(qtype, n)). On the CPU:
    the plain version; on the card: the type's kernel, once."""
    kernel, fn, code, kind, _ = ROUTES[qtype]
    if x.dim() != 2 or x.shape[1] % QK_K:
        raise ValueError(f"{qtype.name} takes (rows, n) with n a multiple of {QK_K}, "
                         f"got {tuple(x.shape)}")
    if qtype in IMATRIX_REQUIRED and quant_weights is None:
        raise ValueError(f"{qtype.name} needs an importance row")
    if quant_weights is not None and quant_weights.numel() != x.shape[1]:
        raise ValueError(f"importance row of {quant_weights.numel()} for rows of {x.shape[1]}")
    if not x.is_cuda:
        return quantize_plain(qtype, x.to(torch.float32), quant_weights)
    x = x.to(torch.float32).contiguous()
    qw = None if quant_weights is None else \
        quant_weights.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape[0], row_size(qtype, x.shape[1]), dtype=torch.uint8,
                      device=x.device)
    nsb = x.numel() // QK_K
    if nsb:
        grid, kmap, neigh = kernel_tables(kind, x.device)
        build.call(fn, code, x.data_ptr(), None if qw is None else qw.data_ptr(),
                   x.shape[1] // QK_K, nsb, out.data_ptr(), grid.data_ptr(), kmap.data_ptr(),
                   neigh.data_ptr(), kmap.numel(),
                   torch.cuda.current_stream(x.device).cuda_stream)
        kernel.launches += 1
    return out
