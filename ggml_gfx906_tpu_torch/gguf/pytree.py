"""Any params pytree ↔ GGUF — the port of ggml_gfx906_tpu/gguf/pytree.py.

One generic mapping covers any nested dict/list/tuple tree of arrays or
tensors: tensor names are the dotted key paths ("enc.blocks.0.qkv_w"),
and loading rebuilds the nesting from the names (integer segments → list
positions). A file written here from a numpy tree is byte for byte the
one the JAX package writes from it.

    save_pytree("m.gguf", params, kv={"sam.n_enc_layer": 12})
    params, kv = load_pytree("m.gguf")            # f32 tensors on the card
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve
from .format import GGUFReader, GGUFWriter


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def save_pytree(path, params, kv: dict | None = None, vtypes: dict | None = None):
    """Write a tree of arrays or tensors to GGUF as F32 tensors (GGUF's
    `ne` keeps the shape). vtypes: optional per-key GGUFValueType
    overrides for the kv metadata. Returns the tensor names."""
    w = GGUFWriter()
    for key, val in (kv or {}).items():
        w.set(key, val, (vtypes or {}).get(key))
    names = []
    for name, arr in _flatten(params):
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr, np.float32)
        w.add_array_tensor(name, arr)
        names.append(name)
    if not names:
        raise ValueError("empty pytree")
    w.write(path)
    return names


def _insert(root: dict, segs: list[str], value):
    cur = root
    for s in segs[:-1]:
        cur = cur.setdefault(s, {})
    cur[segs[-1]] = value


def _listify(node):
    """Turn dicts whose keys are all stringified ints into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] != list(range(len(idx))):
            raise ValueError(f"list positions {idx} are not 0..{len(idx) - 1}")
        return [out[k] for k in idx]
    return out


def load_pytree(path, device=None):
    """GGUF → (params tree of f32 tensors on `device`, kv metadata dict).
    On the card unless device="cpu" (the reference's `device_put` flag)."""
    device = resolve(device)
    r = GGUFReader(path)
    root: dict = {}
    for name in r.tensors:
        _insert(root, name.split("."), torch.from_numpy(r.tensor_float(name)).to(device))
    return _listify(root), dict(r.kv)
