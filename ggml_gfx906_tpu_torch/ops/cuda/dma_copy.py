"""Streaming copy kernel K11 (the autotuner's memory-stream probe).

Kernel source: csrc/dma_copy.cu (fuller notes there).

- K11 `dma_copy` replaces ggml_gfx906_tpu/utils/autotune.py::pallas_dma_gbs
  (its body `copy_kernel`). Bound on the H100: bytes — each element read
  once and written once. Design: the array as flat, one 16-byte load and
  store per thread, a grid of 256-thread blocks that covers it once.

Its plain version is `Tensor.copy_`, which is also the one PyTorch call
that computes the same function (the smoke's library yardstick).
"""
from __future__ import annotations

import torch

from . import K11, build


def dma_copy_plain(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K11."""
    return out.copy_(x)


def dma_copy(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """out ← x for a contiguous f32 array; returns out (a new tensor when
    out is None). Both on the CPU: the plain version; both on the card:
    K11."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"dma_copy takes a contiguous f32 array, got {x.dtype}")
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype or not out.is_contiguous():
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} does not fit x {tuple(x.shape)}")
    if not x.is_cuda and not out.is_cuda:
        return dma_copy_plain(x, out)
    if not (x.is_cuda and out.is_cuda) or x.device != out.device:
        raise ValueError(f"x on {x.device}, out on {out.device}: both must be on one card")
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("dma_copy needs 16-byte aligned arrays")
    if x.numel():
        build.call("dma_copy_f32", x.data_ptr(), out.data_ptr(), x.numel(),
                   torch.cuda.current_stream(x.device).cuda_stream)
        K11.launches += 1
    return out
