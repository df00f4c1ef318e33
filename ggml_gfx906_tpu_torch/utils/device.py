"""Device choice for the port's entry points: the card unless asked."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """None → cuda. Raises when a CUDA device is wanted but there is none:
    the entry points never fall back to the CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
