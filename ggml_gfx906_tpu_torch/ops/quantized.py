"""Quantized weights on the device and the matmuls over them.

The counterpart of ggml_gfx906_tpu/ops/quantized.py for the types the port
has kernels for (Q4_K). A QuantTensor keeps ggml's block fields as separate
tensors (struct of arrays). The port keeps ggml's wire byte order for the
nibbles — the reference's lane-interleaved "kernel" layout (qmm.py:9-22,
139-155) exists for the TPU's 128-lane tiles — and stores the scales
unpacked, as the reference's kernel layout does:

    qs  (N, K/2)   u8   packed nibbles, wire order
    scm (N, K/16)  u8   per superblock [sc0..sc7 | m0..m7] (6-bit values)
    dd  (N, K/128) f32  per superblock [d, dmin]

That streams 4.75 bits per weight. Dequantization from it is bit-identical
to ggml's (and the JAX package's) for every layout they hold.

ref: ggml's mul_mat convention — weights are (n_out, n_in) rows and
`mul_mat(W, x)` dots rows of x with rows of W, i.e. x @ W.T here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..quant.dequant_math import unpack_scale_min_k4
from ..quant.types import BLOCK_Q4_K, GGMLType, TYPE_TRAITS
from .cuda import dispatch
from .cuda import qmm as _qmm


@dataclass
class QuantTensor:
    """A quantized weight as packed block fields; shape is the logical
    float shape in C order (n_out, n_in)."""

    qtype: GGMLType
    shape: tuple[int, ...]
    fields: dict[str, torch.Tensor]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.fields.values())

    @classmethod
    def from_wire(cls, qtype: GGMLType, raw, shape: tuple[int, int],
                  device) -> "QuantTensor":
        """From packed wire bytes (a uint8 numpy array or tensor of
        N * K/256 blocks, e.g. GGUFReader.tensor_bytes). The bytes go to the
        device as they are and are split into fields there."""
        if qtype != GGMLType.Q4_K:
            raise NotImplementedError(f"{qtype.name} weights are not ported yet")
        n, k = shape
        if k % 256:
            raise ValueError(f"Q4_K row length {k} is not a multiple of 256")
        nb = k // 256
        bs = BLOCK_Q4_K.itemsize
        if not isinstance(raw, torch.Tensor):
            raw = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True))
        raw = raw.to(device).reshape(n, nb, bs)
        off = {nm: BLOCK_Q4_K.fields[nm][1] for nm in ("d", "dmin", "scales", "qs")}
        f16 = lambda o: raw[..., o:o + 2].contiguous().view(torch.float16)[..., 0]  # noqa: E731
        sc, m = unpack_scale_min_k4(raw[..., off["scales"]:off["scales"] + 12])
        fields = {
            "qs": raw[..., off["qs"]:off["qs"] + 128].reshape(n, nb * 128).contiguous(),
            "scm": torch.cat([sc, m], dim=-1).reshape(n, nb * 16).contiguous(),
            "dd": torch.stack([f16(off["d"]).float(), f16(off["dmin"]).float()],
                              dim=-1).reshape(n, nb * 2).contiguous(),
        }
        return cls(qtype, (n, k), fields)

    @classmethod
    def from_blocks(cls, qtype: GGMLType, blocks: np.ndarray, device) -> "QuantTensor":
        """From a numpy structured block array (N, nb) (GGUFReader.tensor_blocks)."""
        tt = TYPE_TRAITS[qtype]
        if blocks.ndim != 2:
            raise ValueError(f"expected (N, nb) blocks, got {blocks.shape}")
        shape = (blocks.shape[0], blocks.shape[1] * tt.blck_size)
        return cls.from_wire(qtype, np.ascontiguousarray(blocks).view(np.uint8),
                             shape, device)

    @classmethod
    def from_reference_kernel_layout(cls, qtype: GGMLType, shape, fields: dict,
                                     device) -> "QuantTensor":
        """From the JAX package's Q4_K "kernel" layout (qmm.py:139-155) as
        numpy: undo its lane interleave (byte lane 4*j + g ↔ wire byte
        32*g + j) and its even/odd scale split."""
        if qtype != GGMLType.Q4_K:
            raise NotImplementedError(f"{qtype.name} weights are not ported yet")
        n, k = shape
        nb = k // 256
        qs = np.asarray(fields["qs"]).reshape(n, nb, 32, 4).transpose(0, 1, 3, 2)
        scm = np.asarray(fields["scm"]).reshape(n, nb, 4, 4)
        sc = np.stack([scm[:, :, 0], scm[:, :, 1]], axis=-1).reshape(n, nb, 8)
        mm = np.stack([scm[:, :, 2], scm[:, :, 3]], axis=-1).reshape(n, nb, 8)
        t = lambda a, dt: torch.from_numpy(np.array(a, dt, copy=True)).to(device)  # noqa: E731
        return cls(qtype, (n, k), {
            "qs": t(qs.reshape(n, nb * 128), np.uint8),
            "scm": t(np.concatenate([sc, mm], -1).reshape(n, nb * 16), np.uint8),
            "dd": t(np.asarray(fields["dd"]).reshape(n, nb * 2), np.float32),
        })


def dequant(qt: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense tensor of qt.shape (bit-exact f32 w.r.t. ggml)."""
    f = qt.fields
    return _qmm.dequant(f["qs"], f["scm"], f["dd"]).reshape(qt.shape).to(dtype)


def embed_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Row gather (+ dequantization for a QuantTensor table)."""
    if not isinstance(table, QuantTensor):
        return table[ids]
    flat = ids.reshape(-1)
    sub = QuantTensor(table.qtype, (flat.numel(),) + table.shape[1:],
                      {k: v[flat] for k, v in table.fields.items()})
    return dequant(sub).reshape(*ids.shape, *table.shape[1:])


def qmatmul(x: torch.Tensor, w, compute_dtype=None) -> torch.Tensor:
    """x (..., K) @ w(N, K).T → (..., N) in x.dtype (ggml mul_mat).

    A QuantTensor goes through the Q4_K kernels (ops/cuda/dispatch.py); a
    dense f32/bf16 weight goes to torch.matmul, as the JAX package gives it
    to XLA (quantized.py:628-639). f32 products run in full f32: the card's
    TF32 switch for matmuls is off by default and must stay off."""
    if isinstance(w, QuantTensor):
        return dispatch.matmul(x, w).to(x.dtype)
    wd = w.to(compute_dtype or x.dtype)
    return torch.matmul(x.to(wd.dtype), wd.T).to(x.dtype)
