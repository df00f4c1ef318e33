"""Training-state checkpoint/resume (the port of
ggml_gfx906_tpu/training/checkpoint.py, in a format of its own).

The full training state — params, AdamW moments, gradient accumulator,
epoch counter, metric history, the numpy RNG state and the dataset's
shuffle permutation — round-trips, so an interrupted `fit` continues
bit-exactly (same batches, same updates) as an uninterrupted run.

The reference writes through orbax; here step N is the directory
`step_%08d` holding one `torch.save` file of the state tree (nested dicts
and lists; tensors on the host, numpy arrays and scalars as tensors of
their dtype), written under a temporary name and renamed when complete,
and read back with torch.load(weights_only=True). Only the two newest
steps are kept.

    from ggml_gfx906_tpu_torch.training import checkpoint as ckpt
    ckpt.save(dir, step, state)            # state: dict tree
    state = ckpt.restore_latest(dir)       # None if dir empty
"""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

STATE_FILE = "state.pt"
KEEP = 2


def encode_rng(rng: np.random.Generator) -> np.ndarray:
    """numpy Generator state → uint8 array (PCG64 state holds 128-bit ints,
    so it travels as JSON bytes)."""
    s = json.dumps(rng.bit_generator.state)
    return np.frombuffer(s.encode(), np.uint8).copy()


def decode_rng(buf) -> np.random.Generator:
    state = json.loads(bytes(np.asarray(buf, np.uint8)).decode())
    rng = np.random.default_rng(0)
    rng.bit_generator.state = state
    return rng


def _host(tree):
    """The state tree as torch.load(weights_only=True) reads it back:
    tensors copied to the host, numpy arrays and scalars as tensors of
    their dtype."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, state) -> str:
    """Write checkpoint `step` under directory (keeps the previous one
    until the new write completes, then prunes to the 2 most recent)."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_host(state), os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    for s in all_steps(directory)[:-KEEP]:
        shutil.rmtree(_path(directory, s), ignore_errors=True)
    return path


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d{8})", name)
        if m and os.path.isdir(os.path.join(directory, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def restore(directory: str, step: int):
    """The state tree of step `step`, its tensors on the host."""
    return torch.load(os.path.join(_path(directory, step), STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_latest(directory: str):
    steps = all_steps(directory)
    if not steps:
        return None
    return restore(directory, steps[-1])
