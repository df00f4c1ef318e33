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


def upload(dst: torch.Tensor, src) -> torch.Tensor:
    """Copy host data (a tensor or an array) into `dst` without waiting on
    the card: a blocking host→device copy synchronises the stream, which
    would drain the decode steps queued ahead of it. On the card the data
    goes through pinned memory by a copy ordered on the current stream;
    on the CPU it is a plain copy."""
    src = torch.as_tensor(src)
    if dst.is_cuda:
        return dst.copy_(src.pin_memory(), non_blocking=True)
    return dst.copy_(src)


def to_device(src, device) -> torch.Tensor:
    """`src` (host data) as a new tensor on `device`, by `upload`."""
    src = torch.as_tensor(src)
    return upload(torch.empty(src.shape, dtype=src.dtype, device=device), src)


def tree_device(tree) -> torch.device:
    """The device of the first tensor of a params tree (dicts, lists, and
    QuantTensors through their `fields`)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if hasattr(tree, "fields"):
        tree = tree.fields
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        try:
            return tree_device(v)
        except (ValueError, TypeError):
            continue
    raise ValueError("the tree holds no tensor")
