"""Magika file-type classifier — the port of ggml_gfx906_tpu/models/magika.py.

ref: examples/magika/main.cpp — magika_graph :181-251: one-hot bytes
(257×1536) → dense(128)+gelu → reshape to (384, 512) → layernorm(γ,β) →
dense_1(256)+gelu → dense_2(256)+gelu → global max-pool over sequence →
layernorm_1 → target_label dense → softmax. Input bytes: first/mid/last 512
bytes of the file, padded with 256 (main.cpp input prep).

`load` and `params_from_numpy` run on the card unless device="cpu" is
passed; `forward` and `classify_bytes` run where the params are.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..gguf import GGUFReader
from ..utils.device import resolve, tree_device
from . import llama as _llama

NORM_EPS = 0.001
PAD_TOKEN = 256
BLOCK = 512

# params key → the reference's TF-style tensor name
TENSORS = {
    "dense_w": "dense/kernel:0", "dense_b": "dense/bias:0",
    "ln_g": "layer_normalization/gamma:0", "ln_b": "layer_normalization/beta:0",
    "dense1_w": "dense_1/kernel:0", "dense1_b": "dense_1/bias:0",
    "dense2_w": "dense_2/kernel:0", "dense2_b": "dense_2/bias:0",
    "ln1_g": "layer_normalization_1/gamma:0", "ln1_b": "layer_normalization_1/beta:0",
    "label_w": "target_label/kernel:0", "label_b": "target_label/bias:0",
}


def load(path, device=None) -> dict:
    """A Magika GGUF (the reference's tensor names) → f32 params on `device`."""
    device = resolve(device)
    r = GGUFReader(path)
    return {k: torch.from_numpy(r.tensor_float(n)).to(device) for k, n in TENSORS.items()}


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's magika params (numpy leaves) → the port's."""
    return _llama.params_from_numpy(tree, device)


def prepare_input(data: bytes) -> np.ndarray:
    """File bytes → (1536,) int tokens (the reference's beg/mid/end
    extraction, main.cpp:272-308): first 512 bytes padded at the end,
    middle 512 centered, last 512 padded at the beginning."""
    n = len(data)
    arr = np.frombuffer(data, dtype=np.uint8)
    out = np.full(3 * BLOCK, PAD_TOKEN, dtype=np.int32)
    head = arr[:BLOCK]
    out[:len(head)] = head
    mid_offs = max(0, (n - BLOCK) // 2)
    mid = arr[mid_offs:mid_offs + BLOCK]
    off = BLOCK + BLOCK // 2 - len(mid) // 2
    out[off:off + len(mid)] = mid
    end_offs = max(0, n - BLOCK)
    tail = arr[end_offs:end_offs + BLOCK]
    out[3 * BLOCK - len(tail):] = tail
    return out


def forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, 1536) int → label probabilities (B, n_labels).

    The one-hot product is a row gather of dense_w.T, which a one-hot f32
    product gives exactly. GGUF tensors arrive in numpy C-order, so each
    ggml mul_mat(W, x) is x @ W.T; the middle layernorm runs over the 384
    axis between two transposes (main.cpp:213-222)."""
    b = tokens.shape[0]
    cur = ops.gelu(params["dense_w"].T[tokens.long()] + params["dense_b"])  # (B, 1536, 128)
    cur = cur.reshape(b, 384, 512).transpose(1, 2)                          # (B, 512, 384)
    cur = ops.norm(cur, NORM_EPS) * params["ln_g"] + params["ln_b"]
    cur = cur.transpose(1, 2)                                               # (B, 384, 512)
    cur = ops.gelu(cur @ params["dense1_w"].T + params["dense1_b"])
    cur = ops.gelu(cur @ params["dense2_w"].T + params["dense2_b"])
    cur = cur.amax(dim=1)                      # global max pool over the 384 positions
    cur = ops.norm(cur, NORM_EPS) * params["ln1_g"] + params["ln1_b"]
    logits = cur @ params["label_w"].T + params["label_b"]
    return torch.softmax(logits, dim=-1)


def classify_bytes(params: dict, data: bytes) -> np.ndarray:
    """One file's label probabilities (n_labels,), on the params' device."""
    toks = torch.from_numpy(prepare_input(data)[None]).to(tree_device(params))
    with torch.inference_mode():
        return forward(params, toks)[0].cpu().numpy()
