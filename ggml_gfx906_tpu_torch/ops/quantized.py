"""Quantized weights on the device and the matmuls over them.

The counterpart of ggml_gfx906_tpu/ops/quantized.py for the types the port
has kernels for: Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K and
Q8_0 — the types of llama.cpp's Q2_K, Q3_K_M, Q4_K_M and Q5_K_M mixtures
and of its Q8_0, Q4_0, Q4_1, Q5_0 and Q5_1 files. A QuantTensor
keeps ggml's block fields as separate tensors (struct of arrays), one row
of blocks per weight row. The port keeps ggml's wire byte order for the
quants — the reference's lane-interleaved "kernel" layouts (qmm.py:9-22,
139-155, 428-434, 471-478, 781-801, 854-878, 923-932, 981-1004,
1093-1133) exist for
the TPU's 128-lane tiles — with f32 block scales and mins:

    Q4_0  qs  (N, K/2)   u8   packed nibbles, wire order
          d   (N, K/32)  f32                                5 bits/weight
    Q4_1  qs, d               as Q4_0
          m   (N, K/32)  f32  one min per block             6 bits/weight
    Q5_0  qs, d               as Q4_0
          qh  (N, K/8)   u8   fifth bits: the block's four
                              wire bytes (a little-endian
                              word, bit j ↔ element j)      6 bits/weight
    Q5_1  qs, qh, d           as Q5_0
          m   (N, K/32)  f32  one min per block             7 bits/weight
    Q2_K  qs     (N, K/4)  u8   four 2-bit planes per byte, wire order
          scales (N, K/16) u8   wire bytes: sc low nibble, m high nibble
          d, dmin (N, K/256) f32                            2.75 bits/weight
    Q3_K  qs     (N, K/4)  u8   as Q2_K
          hmask  (N, K/8)  u8   wire order: byte l, bit 4h + t
          sc     (N, K/16) i8   unpacked signed scales (−32..31)
          d      (N, K/256) f32                             3.625 bits/weight
    Q4_K  qs  (N, K/2)   u8   packed nibbles, wire order
          scm (N, K/16)  u8   per superblock [sc0..sc7 | m0..m7] (6-bit)
          dd  (N, K/128) f32  per superblock [d, dmin]      4.75 bits/weight
    Q5_K  qs, scm, dd         as Q4_K
          qh  (N, K/8)   u8   fifth bits, wire order        5.75 bits/weight
    Q6_K  ql  (N, K/2)   u8   low nibbles, wire order
          qh  (N, K/4)   u8   high 2-bit pairs, wire order
          sc  (N, K/16)  i8   one scale per 16 elements
          d   (N, K/256) f32                                6.625 bits/weight
    Q8_0  qs  (N, K)     i8
          d   (N, K/32)  f32                                9 bits/weight

Dequantization from it is bit-identical to ggml's (and the JAX package's)
for every layout they hold.

A QuantTensor's `layout` says which matmul runs it (`qmatmul`):
- "kernel": the fields above at K % `_K_MULT` == 0; the type's kernels
  (ops/cuda/dispatch.py). The default.
- "wire": the same fields where the kernels cannot take them (a block-32
  type at K % 32 == 0 but K % `_K_MULT` != 0), and Q8_1 / Q8_K (qs (N, K)
  i8, d f32 per block) at any K: dequantized, then one f32 torch.matmul,
  as the reference dequantizes and hands them to XLA (quantized.py:
  339-341, 370-373, 628-639).
- "int8": the reference's int8 execution layout (quantized.py:412-605),
  w8t (K/tile, N, tile) i8 and dwt (K/tile, N) f32, each (row, K-tile)
  requantized against its own max; `_int8_layout_matmul` in plain torch.
  The types without kernels or wire fields (IQ1_S, IQ1_M, IQ2_XXS, IQ2_XS,
  IQ2_S, IQ3_XXS, IQ3_S, IQ4_NL, IQ4_XS, TQ1_0, TQ2_0, MXFP4) load straight
  into it: dequantized on the device by the codecs (quant/registry.py),
  then requantized per tile, as the reference loads them (quantized.py:
  345-369).

ref: ggml's mul_mat convention — weights are (n_out, n_in) rows and
`mul_mat(W, x)` dots rows of x with rows of W, i.e. x @ W.T here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..quant import registry
from ..quant.dequant_math import dequant_q8_0, unpack_q3_scales, unpack_scale_min_k4
from ..quant.types import GGMLType, TYPE_TRAITS
from ..utils import autotune, config
from ..utils.device import resolve, tree_device
from .cuda import dispatch
from .cuda import qmm as _qmm
from .cuda import qmm_legacy as _qmm_legacy
from .cuda import qmm_q4_0 as _qmm_q4_0
from .cuda import qmm_q23k as _qmm_q23k
from .cuda import qmm_q5k as _qmm_q5k
from .cuda import qmm_q6k as _qmm_q6k
from .cuda import qmm_q8_0 as _qmm_q8_0

# the K multiple each ported type's layout and kernels take (Q4_0, Q4_1,
# Q5_0, Q5_1 and Q5_K at 256, as the reference takes its kernel layout only
# at K % 256 == 0)
_K_MULT = {GGMLType.Q4_K: 256, GGMLType.Q6_K: 256, GGMLType.Q8_0: 128,
           GGMLType.Q4_0: 256, GGMLType.Q5_K: 256, GGMLType.Q4_1: 256,
           GGMLType.Q5_0: 256, GGMLType.Q5_1: 256, GGMLType.Q2_K: 256,
           GGMLType.Q3_K: 256}
_DEQUANT = {GGMLType.Q4_K: _qmm.dequant, GGMLType.Q6_K: _qmm_q6k.dequant,
            GGMLType.Q8_0: _qmm_q8_0.dequant, GGMLType.Q4_0: _qmm_q4_0.dequant,
            GGMLType.Q5_K: _qmm_q5k.dequant, GGMLType.Q4_1: _qmm_legacy.dequant_q4_1,
            GGMLType.Q5_0: _qmm_legacy.dequant_q5_0,
            GGMLType.Q5_1: _qmm_legacy.dequant_q5_1,
            GGMLType.Q2_K: _qmm_q23k.dequant_q2_K, GGMLType.Q3_K: _qmm_q23k.dequant_q3_K,
            GGMLType.Q8_1: _qmm_q8_0.dequant,
            GGMLType.Q8_K: lambda qs, d: dequant_q8_0(d, qs.reshape(qs.shape[0], -1, 256))}
# each type's fields in its dequantization's argument order; Q8_1 and Q8_K
# have no kernel in either package and only the "wire" layout
_FIELDS = {**dispatch.FIELDS, GGMLType.Q8_1: ("qs", "d"), GGMLType.Q8_K: ("qs", "d")}
# the weights per column of each type's first field (its quants: two per
# byte of packed nibbles, four of 2-bit planes, one of int8)
_K_PER_COL = {GGMLType.Q4_K: 2, GGMLType.Q5_K: 2, GGMLType.Q6_K: 2, GGMLType.Q4_0: 2,
              GGMLType.Q4_1: 2, GGMLType.Q5_0: 2, GGMLType.Q5_1: 2, GGMLType.Q2_K: 4,
              GGMLType.Q3_K: 4, GGMLType.Q8_0: 1, GGMLType.Q8_1: 1, GGMLType.Q8_K: 1}


def _wire_fields(qtype: GGMLType, raw: torch.Tensor) -> dict:
    """(N, nb, block bytes) u8 wire blocks → the port's fields."""
    n = raw.shape[0]
    off = {nm: f[1] for nm, f in TYPE_TRAITS[qtype].block_dtype.fields.items()}
    take = lambda nm, size: raw[..., off[nm]:off[nm] + size].reshape(n, -1).contiguous()  # noqa: E731
    f16 = lambda nm: take(nm, 2).view(torch.float16).float()                              # noqa: E731
    if qtype in (GGMLType.Q4_K, GGMLType.Q5_K):
        sc, m = unpack_scale_min_k4(raw[..., off["scales"]:off["scales"] + 12])
        out = {"qs": take("qs", 128),
               "scm": torch.cat([sc, m], dim=-1).reshape(n, -1).contiguous(),
               "dd": torch.stack([f16("d"), f16("dmin")], dim=-1).reshape(n, -1).contiguous()}
        if qtype == GGMLType.Q5_K:
            out["qh"] = take("qh", 32)
        return out
    if qtype == GGMLType.Q2_K:
        return {"qs": take("qs", 64), "scales": take("scales", 16),
                "d": f16("d"), "dmin": f16("dmin")}
    if qtype == GGMLType.Q3_K:
        sc = unpack_q3_scales(raw[..., off["scales"]:off["scales"] + 12])
        return {"qs": take("qs", 64), "hmask": take("hmask", 32),
                "sc": sc.to(torch.int8).reshape(n, -1).contiguous(), "d": f16("d")}
    if qtype == GGMLType.Q6_K:
        return {"ql": take("ql", 128), "qh": take("qh", 64),
                "sc": take("scales", 16).view(torch.int8), "d": f16("d")}
    if qtype in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        out = {"qs": take("qs", 16), "d": f16("d")}
        if "qh" in off:
            out["qh"] = take("qh", 4)
        if "m" in off:
            out["m"] = f16("m")
        return out
    if qtype == GGMLType.Q8_K:
        return {"qs": take("qs", 256).view(torch.int8), "d": take("d", 4).view(torch.float32)}
    return {"qs": take("qs", 32).view(torch.int8), "d": f16("d")}     # Q8_0, Q8_1


def _from_reference_fields(qtype: GGMLType, n: int, k: int, f: dict) -> dict:
    """The JAX package's kernel-layout fields (numpy) → the port's fields
    (numpy), undoing its lane interleaves, scale splits and padding."""
    if qtype == GGMLType.Q4_K:
        # byte lane 4*j + g ↔ wire byte 32*g + j; scm = [sc even | sc odd |
        # m even | m odd] per superblock (qmm.py:139-155)
        nb = k // 256
        qs = f["qs"].reshape(n, nb, 32, 4).transpose(0, 1, 3, 2)
        scm = f["scm"].reshape(n, nb, 4, 4)
        sc = np.stack([scm[:, :, 0], scm[:, :, 1]], axis=-1).reshape(n, nb, 8)
        mm = np.stack([scm[:, :, 2], scm[:, :, 3]], axis=-1).reshape(n, nb, 8)
        return {"qs": qs.astype(np.uint8),
                "scm": np.concatenate([sc, mm], -1).astype(np.uint8),
                "dd": f["dd"].astype(np.float32)}
    if qtype == GGMLType.Q6_K:
        # chunks of two superblocks, the superblock axis zero-padded to even
        # (qmm.py:734-801; the same inverse as ops/quantized.py:246-270)
        nb = k // 256
        ch = f["ql"].shape[1] // 256
        ql = f["ql"].reshape(n, ch, 2, 16, 2, 2, 2).transpose(0, 1, 4, 5, 2, 6, 3)
        qh = f["qh"].reshape(n, ch, 16, 2, 2, 2).transpose(0, 1, 3, 4, 5, 2)
        sc = f["sc"].reshape(n, ch, 4, 2, 2, 2).transpose(0, 1, 3, 4, 2, 5)
        cut = lambda a: a.reshape(n, 2 * ch, -1)[:, :nb]  # noqa: E731
        return {"ql": cut(ql).astype(np.uint8), "qh": cut(qh).astype(np.uint8),
                "sc": cut(sc).astype(np.int8),
                "d": f["dq"][:, ::4][:, :nb].astype(np.float32)}
    if qtype == GGMLType.Q5_K:
        # chunks of four superblocks, the superblock axis zero-padded to a
        # multiple of 4; per chunk qs lane (g, j, sb), qh lane (j, sb), scm
        # [sc(t, sb) | m(t, sb)] (qmm.py:854-878; the same inverse as
        # ops/quantized.py:271-296)
        nb = k // 256
        ch = f["ql"].shape[1] // 512
        qs = f["ql"].reshape(n, ch, 4, 32, 4).transpose(0, 1, 4, 2, 3)
        qh = f["qh"].reshape(n, ch, 32, 4).transpose(0, 1, 3, 2)
        scm = f["scm"].reshape(n, ch, 2, 8, 4).transpose(0, 1, 4, 2, 3)
        dd = np.stack([f["d"], f["dmin"]], axis=-1)
        cut = lambda a: a.reshape(n, 4 * ch, -1)[:, :nb]  # noqa: E731
        return {"qs": cut(qs).astype(np.uint8), "qh": cut(qh).astype(np.uint8),
                "scm": cut(scm).astype(np.uint8), "dd": cut(dd).astype(np.float32)}
    if qtype == GGMLType.Q4_0:
        # byte lane 8*j + b of a 256-span ↔ wire byte j of its block b
        # (qmm.py:471-478)
        qs = f["qs"].reshape(n, k // 256, 16, 8).transpose(0, 1, 3, 2)
        return {"qs": qs.astype(np.uint8), "d": f["d"].astype(np.float32)}
    if qtype == GGMLType.Q4_1:
        # Q4_0's byte lanes, plus the per-block min (qmm.py:923-932)
        qs = f["qs"].reshape(n, k // 256, 16, 8).transpose(0, 1, 3, 2)
        return {"qs": qs.astype(np.uint8), "d": f["d"].astype(np.float32),
                "m": f["m"].astype(np.float32)}
    if qtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        # chunks of 32 blocks (b = 8t + b'), the block axis zero-padded to a
        # multiple of 32; per chunk qs lane (t, jj, kk, b') ↔ wire byte
        # 8kk + jj, qh lane (t, h, kk, b') ↔ wire byte 2h + kk (qmm.py:
        # 981-1004; the same inverse as ops/quantized.py:194-212)
        nb = k // 32
        ch = f["qs"].shape[1] // 512
        qs = f["qs"].reshape(n, ch, 4, 8, 2, 8).transpose(0, 1, 2, 5, 4, 3)
        qh = f["qh"].reshape(n, ch, 4, 2, 2, 8).transpose(0, 1, 2, 5, 3, 4)
        cut = lambda a: a.reshape(n, 32 * ch, -1)[:, :nb]  # noqa: E731
        out = {"qs": cut(qs).astype(np.uint8), "qh": cut(qh).astype(np.uint8),
               "d": f["d"][:, :nb].astype(np.float32)}
        if qtype == GGMLType.Q5_1:
            out["m"] = f["m"][:, :nb].astype(np.float32)
        return out
    if qtype in (GGMLType.Q2_K, GGMLType.Q3_K):
        # chunks of two superblocks, the superblock axis zero-padded to even;
        # per chunk qs (and hmask) lane (jj, sb, h, s) ↔ wire byte 32h + 16s
        # + jj, scale lane (t, sb, h, s) ↔ wire scale 8h + 2t + s, d repeated
        # 4× per superblock; hmask byte jj + 16s is copied to both h-lanes
        # and h = 0's copy is kept (qmm.py:1093-1133; the same inverse as
        # ops/quantized.py:213-245)
        nb = k // 256
        ch = f["qs"].shape[1] // 128
        lanes = lambda a: a.reshape(n, ch, 16, 2, 2, 2).transpose(0, 1, 3, 4, 5, 2)  # noqa: E731
        scales = f["scm" if qtype == GGMLType.Q2_K else "sc"].reshape(
            n, ch, 4, 2, 2, 2).transpose(0, 1, 3, 4, 2, 5)
        cut = lambda a: a.reshape(n, 2 * ch, -1)[:, :nb]  # noqa: E731
        out = {"qs": cut(lanes(f["qs"])).astype(np.uint8),
               "d": f["dq"][:, ::4][:, :nb].astype(np.float32)}
        if qtype == GGMLType.Q2_K:
            out["scales"] = cut(scales).astype(np.uint8)
            out["dmin"] = f["dm"][:, ::4][:, :nb].astype(np.float32)
        else:
            out["hmask"] = cut(lanes(f["hm"])[:, :, :, 0]).astype(np.uint8)
            out["sc"] = cut(scales).astype(np.int8)
        return out
    # Q8_0: byte lane 4*j + b of a 128-tile ↔ element 32*b + j (qmm.py:428-434)
    qs = f["qs"].reshape(n, k // 128, 32, 4).transpose(0, 1, 3, 2)
    return {"qs": qs.astype(np.int8), "d": f["d"].astype(np.float32)}


@dataclass
class QuantTensor:
    """A quantized weight as packed block fields; shape is the logical
    float shape in C order (n_out, n_in)."""

    qtype: GGMLType
    shape: tuple[int, ...]
    fields: dict[str, torch.Tensor]
    layout: str = "kernel"      # "kernel" | "wire" | "int8" (module docstring)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.fields.values())

    def localize(self) -> "QuantTensor":
        """The logical shape rebound to the fields' own, for fields cut
        from a larger weight (parallel/mesh.py::shard_quant_tensor returns
        its shards so): the kernels and dequantization read the shard's
        shape (the reference's localize, quantized.py:385-409). Both axes
        come from the fields, so a column shard's K is its own part of K:
        the reference takes K from the logical shape (its comment says only
        N is ever sharded, while its tp.py splits wo and w_down by column)."""
        if self.layout == "int8":
            w8t = self.fields["w8t"]          # rows on axis 1, K-tiles on axis 0
            shp = (w8t.shape[1], w8t.shape[0] * w8t.shape[2])
        else:
            f = self.fields[_FIELDS[self.qtype][0]]
            shp = (f.shape[0], f.shape[1] * _K_PER_COL[self.qtype])
        if shp == tuple(self.shape):
            return self
        return QuantTensor(self.qtype, shp, self.fields, self.layout)

    @staticmethod
    def _layout(qtype: GGMLType, shape) -> str:
        """"kernel" where the type's kernels take the shape, else "wire"
        where its fields can still be dequantized, "int8" for the types
        that have only a codec; raises otherwise."""
        blck = TYPE_TRAITS[qtype].blck_size
        if shape[-1] % blck:
            raise ValueError(f"{qtype.name} row length {shape[-1]} is not a multiple of {blck}")
        if qtype not in _FIELDS:
            if qtype not in registry._DEQUANTIZE:
                raise NotImplementedError(f"{qtype.name} weights are not ported yet")
            return "int8"
        if qtype in _K_MULT and shape[-1] % _K_MULT[qtype] == 0:
            return "kernel"
        return "wire"

    @classmethod
    def from_wire(cls, qtype: GGMLType, raw, shape: tuple[int, int],
                  device) -> "QuantTensor":
        """From packed wire bytes (a uint8 numpy array or tensor of N rows
        of blocks, e.g. GGUFReader.tensor_bytes or registry.quantize's
        output). The bytes go to the device as they are and are split into
        fields there; the layout is "kernel" where the kernels take the
        shape, else "wire"; a type with only a codec is dequantized there
        and requantized into the int8 layout (tile from `_choose_tile`,
        reference quantized.py:345-369)."""
        layout = cls._layout(qtype, shape)
        n, k = shape
        tt = TYPE_TRAITS[qtype]
        if not isinstance(raw, torch.Tensor):
            raw = torch.from_numpy(np.array(raw, dtype=np.uint8, copy=True))
        raw = raw.to(device).reshape(n, k // tt.blck_size, tt.type_size)
        if layout == "int8":
            w8t, dwt = _requant_tiles(registry.dequantize(qtype, raw, k), _choose_tile(k, None))
            return cls(qtype, (n, k), {"w8t": w8t, "dwt": dwt}, "int8")
        return cls(qtype, (n, k), _wire_fields(qtype, raw), layout)

    @classmethod
    def quantize(cls, qtype: GGMLType, x, device=None, quant_weights=None) -> "QuantTensor":
        """Quantize f32 (N, K) (a tensor or an array) with the codecs on
        `device` (the card unless asked for the CPU) and load the wire bytes
        as from_wire does (reference quantized.py:377-383). quant_weights:
        an importance row (K,) (quant/registry.py::quantize)."""
        device = resolve(device)
        x = torch.as_tensor(x).to(device=device, dtype=torch.float32)
        if x.dim() != 2:
            raise ValueError(f"expected an (N, K) matrix, got {tuple(x.shape)}")
        return cls.from_wire(qtype, registry.quantize(qtype, x, quant_weights),
                             tuple(x.shape), device)

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
        """From the JAX package's "kernel" layout (Q4_K qmm.py:139-155, Q6_K
        :781-801, Q8_0 :428-434, Q4_0 :471-478, Q5_K :854-878, Q4_1
        :923-932, Q5_0 and Q5_1 :981-1004, Q2_K and Q3_K :1093-1133) as
        numpy."""
        if cls._layout(qtype, shape) != "kernel":
            raise ValueError(f"{qtype.name} {tuple(shape)} has no kernel layout")
        n, k = shape
        port = _from_reference_fields(qtype, n, k,
                                      {f: np.asarray(a) for f, a in fields.items()})
        return cls(qtype, (n, k), {
            f: torch.from_numpy(np.ascontiguousarray(a).reshape(n, -1)).to(device)
            for f, a in port.items()})


# ------------------------------------------------ the int8 execution layout

# the widest K-tile whose int8 dot is exact in f32: tile·127² < 2^24
_EXACT_TILE = 1024
# the values of config "weights_layout"
WEIGHTS_LAYOUTS = ("kernel", "int8", "auto")


def _choose_tile(k: int, tile: int | None) -> int:
    """The int8 layout's K-tile for rows of k (reference quantized.py:434):
    halve while k % tile != 0; for the configured tile (`int8_tile`), also
    while k / tile < 8, never below 128. K = 4096 → 512, 11008 → 256,
    256 → 128."""
    from_config = tile is None
    if from_config:
        tile = int(config.get("int8_tile"))
    while k % tile and tile > 32:
        tile //= 2
    if from_config:
        while k // tile < 8 and tile > 128:
            tile //= 2
    if k % tile:
        raise ValueError(f"row length {k} has no int8 tile (from {tile})")
    return tile


def _tile_scales(amax: torch.Tensor):
    """(amax / 127, 127 / amax or 0 where amax == 0), both correctly
    rounded divisions as XLA's are: tensor by tensor, since torch turns
    `127.0 / t` into t.reciprocal() * 127 and, on the card, a division by a
    scalar into a multiply by its reciprocal."""
    c = torch.full_like(amax, 127.0)
    pos = amax > 0
    inv = torch.where(pos, c / torch.where(pos, amax, torch.ones_like(amax)),
                      torch.zeros_like(amax))
    return amax / c, inv


def _round_i8(v: torch.Tensor) -> torch.Tensor:
    """Half to even, then clip to ±127, as jnp.round and jnp.clip do."""
    return torch.clamp(torch.round(v), -127.0, 127.0)


def _requant_tiles(w: torch.Tensor, tile: int):
    """(N, K) f32 → (w8t (K/tile, N, tile) i8, dwt (K/tile, N) f32), each
    (row, tile) requantized against its own max (reference
    quantized.py:454), stored tile-major as the reference stores it."""
    n, k = w.shape
    wt = w.reshape(n, k // tile, tile)
    dw, inv = _tile_scales(wt.abs().amax(-1))
    w8 = _round_i8(wt * inv[..., None]).to(torch.int8)
    return w8.transpose(0, 1).contiguous(), dw.T.contiguous()


def to_int8_layout(qt: QuantTensor, tile: int | None = None) -> QuantTensor:
    """Any quantized weight → the int8 execution layout (reference
    quantized.py:412): dequantize, then requantize per (row, K-tile); the
    tile from `_choose_tile`."""
    w = dequant(qt)
    tile = _choose_tile(w.shape[1], tile)
    w8t, dwt = _requant_tiles(w, tile)
    return QuantTensor(qt.qtype, qt.shape, {"w8t": w8t, "dwt": dwt}, "int8")


def _tile_dots(qx: torch.Tensor, w8t: torch.Tensor) -> torch.Tensor:
    """Per-tile integer dots: qx (Kt, M, tile) integer-valued f32, w8t (Kt,
    N, tile) i8 → (Kt, M, N) f32 holding the exact int32 sums. torch has no
    int8 matmul that fits (CPU int8 matmul wraps, CUDA's raises,
    `_int_mm` is 2-D with M > 16), so the int8 values are multiplied as f32:
    every product and partial sum is an integer below 2^24, exact in any
    summation order, while tile ≤ 1024. A wider tile is cut into
    1024-wide parts whose sums are added in integers."""
    if qx.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("the int8 layout's per-tile dots need full-f32 matmuls "
                           "(TF32 off)")
    kt, m, tile = qx.shape
    n = w8t.shape[1]
    if tile <= _EXACT_TILE:
        return torch.matmul(qx, w8t.float().transpose(1, 2))
    s = tile // _EXACT_TILE
    part = torch.matmul(qx.reshape(kt, m, s, _EXACT_TILE).transpose(1, 2),
                        w8t.reshape(kt, n, s, _EXACT_TILE).permute(0, 2, 3, 1).float())
    return part.to(torch.int32).sum(1).float()


def _sum_tiles(t: torch.Tensor) -> torch.Tensor:
    """(Kt, ...) → (...): tiles added in a fixed pairwise order (0+1, 2+3,
    ..., then the pairs' sums, an odd last tile carried up), elementwise
    adds only, so that a row's sum does not depend on M (torch's reduction
    over a leading dim may reorder with the output size); log2(Kt) launches
    where a left-to-right loop takes Kt − 1."""
    while t.shape[0] > 1:
        kt = t.shape[0]
        pairs = t[0:kt - 1:2] + t[1:kt:2]
        t = torch.cat([pairs, t[kt - 1:]]) if kt % 2 else pairs
    return t[0]


def _int8_layout_matmul(x: torch.Tensor, qt: QuantTensor) -> torch.Tensor:
    """x (..., K) @ int8-layout weight → (..., N) f32 (reference
    quantized.py:534): x requantized per (row, tile), exact per-tile
    integer dots, each scaled by its activation and weight tile scales,
    and the tiles summed in a fixed order (`_sum_tiles`)."""
    lead = x.shape[:-1]
    w8t, dwt = qt.fields["w8t"], qt.fields["dwt"]
    kt, n, tile = w8t.shape
    x2 = x.reshape(-1, kt, tile).float()
    ex, inv = _tile_scales(x2.abs().amax(-1))
    qx = _round_i8(x2 * inv[..., None])
    scaled = _tile_dots(qx.transpose(0, 1), w8t) * ex.T[:, :, None] * dwt[:, None, :]
    return _sum_tiles(scaled).reshape(*lead, n)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def apply_weights_layout(params, layout: str | None = None):
    """Every QuantTensor of a params tree (or one QuantTensor) in the
    execution layout `layout` (None reads config "weights_layout"; "auto"
    asks utils/autotune.choose on the params' device): "int8" converts by
    `to_int8_layout`, "kernel" keeps the loaded layouts (reference
    quantized.py:580); any other value raises ValueError."""
    layout = layout or config.get("weights_layout")
    if layout not in WEIGHTS_LAYOUTS:
        raise ValueError(f"weights_layout {layout!r} is not one of {WEIGHTS_LAYOUTS}")
    if layout == "auto":
        layout = autotune.choose(tree_device(params))
    if layout != "int8":
        return params
    return _tree_map(lambda t: to_int8_layout(t)
                     if isinstance(t, QuantTensor) and t.layout != "int8" else t, params)


# ---------------------------------------------------------- every layout

def dequant(qt: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense tensor of qt.shape: bit-exact f32 w.r.t. ggml for the "kernel"
    and "wire" layouts; the int8 layout's own requantized values."""
    if qt.layout == "int8":
        w8 = qt.fields["w8t"].transpose(0, 1).float()
        w = w8 * qt.fields["dwt"].T[..., None]
    else:
        w = _DEQUANT[qt.qtype](*(qt.fields[f] for f in _FIELDS[qt.qtype]))
    return w.reshape(qt.shape).to(dtype)


def embed_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """Row gather (+ dequantization for a QuantTensor table; the int8
    layout keeps rows on axis 1 of its fields)."""
    if not isinstance(table, QuantTensor):
        return table[ids]
    flat = ids.reshape(-1)
    if table.layout == "int8":
        fields = {k: v[:, flat] for k, v in table.fields.items()}
    else:
        fields = {k: v[flat] for k, v in table.fields.items()}
    sub = QuantTensor(table.qtype, (flat.numel(),) + table.shape[1:], fields, table.layout)
    return dequant(sub).reshape(*ids.shape, *table.shape[1:])


def qmatmul(x: torch.Tensor, w, compute_dtype=None) -> torch.Tensor:
    """x (..., K) @ w(N, K).T → (..., N) in x.dtype (ggml mul_mat).

    A QuantTensor goes by its layout: "kernel" through its type's kernels
    (ops/cuda/dispatch.py), "int8" through `_int8_layout_matmul`, "wire"
    dequantized and multiplied in f32; a dense f32/bf16 weight goes to
    torch.matmul, as the JAX package gives both to XLA (quantized.py:
    628-639). f32 products run in full f32: the card's TF32 switch for
    matmuls is off by default and must stay off."""
    if isinstance(w, QuantTensor):
        if w.layout == "kernel":
            return dispatch.matmul(x, w).to(x.dtype)
        if w.layout == "int8":
            return _int8_layout_matmul(x, w).to(x.dtype)
        return torch.matmul(x.float(), dequant(w).T).to(x.dtype)
    wd = w.to(compute_dtype or x.dtype)
    return torch.matmul(x.to(wd.dtype), wd.T).to(x.dtype)
