"""Loading the seeded wire blocks into the port (QuantTensor.from_wire),
one tensor at a time on the device."""
from __future__ import annotations

import torch

from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.quant.types import GGMLType

from .. import quant


def matrix(seed: int, name: str, qt: str, rows: int, cols: int, experts: int, device):
    """One matrix as the port holds it, or a stack as a list of per-expert
    QuantTensors (the layout models/moe.py::load gives)."""
    raw = quant.wire(seed, name, qt, rows * max(experts, 1), cols, device)
    t = GGMLType[qt]
    if not experts:
        return QuantTensor.from_wire(t, raw, (rows, cols), device)
    raw = raw.reshape(experts, rows, -1)
    return [QuantTensor.from_wire(t, raw[e], (rows, cols), device) for e in range(experts)]


def ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32, device=device)
