"""GGUF file format: reader + writer.

A numpy-only copy of ggml_gfx906_tpu/gguf/format.py (spec comment at ggml's
include/gguf.h:1-31; reference reader src/gguf.cpp:319
gguf_init_from_file_impl, writer src/gguf.cpp:1332 gguf_write_to_file).
Reading memory-maps the aligned data blob and exposes tensors as zero-copy
numpy views. One difference from the JAX package's copy: the writer
streams tensor data to the file instead of assembling the whole file in
memory (a 7B-shape file is ~4 GB). `tensor_float` dequantizes and
`add_array_tensor` quantizes through the port's codecs (quant/registry.py),
on the CPU for numpy arrays and on a tensor's own device for tensors.

GGUF dims are stored fastest-varying-first (ne[0] = contiguous row length);
numpy shapes are the reverse. `TensorInfo.shape` is the numpy/C-order shape,
`TensorInfo.ne` the ggml-order dims.
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..quant.types import GGMLType, TYPE_TRAITS, row_size

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32
GGUF_KEY_GENERAL_ALIGNMENT = "general.alignment"


class GGUFValueType:
    """KV value type ids (ref include/gguf.h:54-68)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<b",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NUMPY_SIMPLE = {
    GGMLType.F32: np.dtype("<f4"),
    GGMLType.F16: np.dtype("<f2"),
    GGMLType.F64: np.dtype("<f8"),
    GGMLType.I8: np.dtype("i1"),
    GGMLType.I16: np.dtype("<i2"),
    GGMLType.I32: np.dtype("<i4"),
    GGMLType.I64: np.dtype("<i8"),
    GGMLType.BF16: np.dtype("<u2"),  # raw bits; tensor_float converts
}


@dataclass
class TensorInfo:
    name: str
    ne: tuple[int, ...]  # ggml order: ne[0] fastest-varying
    type: GGMLType
    offset: int  # relative to data section

    @property
    def shape(self) -> tuple[int, ...]:
        """C-order (numpy) shape."""
        return tuple(reversed(self.ne))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        return row_size(self.type, self.ne[0]) * self.n_elements // self.ne[0]


def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f, vtype: int):
    if vtype == GGUFValueType.STRING:
        return _read_str(f)
    if vtype == GGUFValueType.ARRAY:
        (atype,) = struct.unpack("<i", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        if atype == GGUFValueType.STRING:
            return [_read_str(f) for _ in range(n)]
        if atype == GGUFValueType.ARRAY:
            raise ValueError("nested GGUF arrays are not supported")
        fmt = _SCALAR_FMT[atype]
        sz = struct.calcsize(fmt)
        raw = f.read(sz * n)
        out = list(struct.unpack(f"<{n}{fmt[1:]}", raw)) if n else []
        if atype == GGUFValueType.BOOL:
            out = [bool(v) for v in out]
        return out
    fmt = _SCALAR_FMT[vtype]
    (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    return bool(v) if vtype == GGUFValueType.BOOL else v


class GGUFReader:
    """Parse a GGUF file; tensor data is np.memmap'ed, never copied eagerly.

    ref: gguf_init_from_file_impl src/gguf.cpp:319 (same validation rules:
    magic, version != 0, duplicate keys/tensors rejected, offsets aligned).
    """

    def __init__(self, path: str | Path, header_only: bool = False):
        """header_only: parse the KV metadata and the tensor directory
        without mapping the data section (the model sync of parallel/
        launch.py writes that section from fetched blobs after reading the
        layout)."""
        self.path = Path(path)
        self.kv: dict[str, object] = {}
        self.kv_types: dict[str, int] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self.alignment = GGUF_DEFAULT_ALIGNMENT

        with open(self.path, "rb") as f:
            magic = f.read(4)
            if magic != GGUF_MAGIC:
                raise ValueError(f"not a GGUF file: magic {magic!r}")
            (self.version,) = struct.unpack("<I", f.read(4))
            if self.version == 0 or self.version > GGUF_VERSION:
                raise ValueError(f"unsupported GGUF version {self.version}")
            if self.version == 1:
                raise ValueError("GGUF v1 (32-bit counts) is not supported")
            n_tensors, n_kv = struct.unpack("<qq", f.read(16))
            if n_tensors < 0 or n_kv < 0:
                raise ValueError("negative tensor/kv count")
            for _ in range(n_kv):
                key = _read_str(f)
                if key in self.kv:
                    raise ValueError(f"duplicate key {key}")
                (vtype,) = struct.unpack("<i", f.read(4))
                self.kv[key] = _read_value(f, vtype)
                self.kv_types[key] = vtype
            align = self.kv.get(GGUF_KEY_GENERAL_ALIGNMENT)
            if align is not None:
                if align <= 0 or (align & (align - 1)) != 0:
                    raise ValueError(f"bad alignment {align}")
                self.alignment = int(align)
            for _ in range(n_tensors):
                name = _read_str(f)
                if name in self.tensors:
                    raise ValueError(f"duplicate tensor {name}")
                (n_dims,) = struct.unpack("<I", f.read(4))
                if n_dims > 4:
                    raise ValueError(f"tensor {name}: n_dims {n_dims} > 4")
                ne = struct.unpack(f"<{n_dims}q", f.read(8 * n_dims))
                (ttype,) = struct.unpack("<i", f.read(4))
                (offset,) = struct.unpack("<Q", f.read(8))
                t = GGMLType(ttype)
                if ne and ne[0] % TYPE_TRAITS[t].blck_size != 0:
                    raise ValueError(f"tensor {name}: ne[0]={ne[0]} not a "
                                     f"multiple of {t.name} block size")
                if offset % self.alignment != 0:
                    raise ValueError(f"tensor {name}: misaligned offset {offset}")
                self.tensors[name] = TensorInfo(name, tuple(ne), t, offset)
            pos = f.tell()
        self.data_offset = (pos + self.alignment - 1) // self.alignment * self.alignment
        self._data = None if header_only else np.memmap(
            self.path, dtype=np.uint8, mode="r", offset=self.data_offset)

    # -- tensor access ----------------------------------------------------

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw packed bytes of a tensor (zero-copy memmap view)."""
        ti = self.tensors[name]
        return self._data[ti.offset : ti.offset + ti.n_bytes]

    def tensor_blocks(self, name: str) -> np.ndarray:
        """Quantized tensor as structured block array, shape
        (*outer_dims, ne[0]//blck)."""
        ti = self.tensors[name]
        tt = TYPE_TRAITS[ti.type]
        if not tt.is_quantized:
            raise ValueError(f"tensor {name} is {ti.type.name}, not quantized")
        blocks = self.tensor_bytes(name).view(tt.block_dtype)
        return blocks.reshape(*ti.shape[:-1], ti.shape[-1] // tt.blck_size)

    def tensor_array(self, name: str) -> np.ndarray:
        """Non-quantized tensor as a numpy array view in C-order shape."""
        ti = self.tensors[name]
        dt = _NUMPY_SIMPLE[ti.type]
        return self.tensor_bytes(name).view(dt).reshape(ti.shape)

    def tensor_float(self, name: str) -> np.ndarray:
        """Tensor as float32, C-order shape; a quantized one dequantized on
        the CPU by the port's codecs."""
        from ..quant.registry import dequantize_bytes

        ti = self.tensors[name]
        if ti.type in (GGMLType.F32, GGMLType.F16):
            return self.tensor_array(name).astype(np.float32)
        if ti.type == GGMLType.BF16:
            raw = self.tensor_array(name).astype(np.uint32) << 16
            return raw.view(np.float32).reshape(ti.shape)
        out = dequantize_bytes(ti.type, self.tensor_bytes(name), ti.ne[0],
                               ti.n_elements // ti.ne[0])
        return out.numpy().reshape(ti.shape)


@dataclass
class GGUFWriter:
    """Compose and write a GGUF file (ref: gguf_write_to_file src/gguf.cpp:1332)."""

    alignment: int = GGUF_DEFAULT_ALIGNMENT
    kv: dict[str, tuple[int, object]] = field(default_factory=dict)
    _tensors: list[tuple[str, tuple[int, ...], GGMLType, object]] = field(
        default_factory=list
    )

    # -- KV setters -------------------------------------------------------

    def set(self, key: str, value, vtype: int | None = None):
        if vtype is None:
            vtype = self._infer_type(value)
        self.kv[key] = (vtype, value)
        return self

    @staticmethod
    def _infer_type(value) -> int:
        if isinstance(value, bool):
            return GGUFValueType.BOOL
        if isinstance(value, int):
            return GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
        if isinstance(value, float):
            return GGUFValueType.FLOAT32
        if isinstance(value, str):
            return GGUFValueType.STRING
        if isinstance(value, (list, tuple, np.ndarray)):
            return GGUFValueType.ARRAY
        raise TypeError(f"cannot infer GGUF type for {type(value)}")

    # -- tensors ----------------------------------------------------------

    def add_tensor(self, name: str, ne: tuple[int, ...], ttype: GGMLType, data):
        """ne in ggml order (ne[0] = contiguous). data = packed wire bytes
        (bytes or a 1-D uint8 numpy array; kept by reference until write)."""
        expected = row_size(ttype, ne[0]) * int(np.prod(ne[1:], dtype=np.int64))
        if len(data) != expected:
            raise ValueError(f"{name}: {len(data)} bytes, expected {expected}")
        self._tensors.append((name, tuple(ne), ttype, data))
        return self

    def add_array_tensor(self, name: str, arr, ttype: GGMLType | None = None):
        """Float array (C-order; a numpy array or a tensor) → an F32
        (default), F16 or quantized tensor. The conversion runs where the
        data is: a tensor on its device (the card's bytes come back to the
        host), a numpy array on the CPU."""
        import torch

        from ..quant.registry import quantize

        ne = tuple(reversed(arr.shape))
        ttype = GGMLType.F32 if ttype is None else ttype
        if ttype in (GGMLType.F32, GGMLType.F16):
            if isinstance(arr, torch.Tensor):
                dt = torch.float32 if ttype == GGMLType.F32 else torch.float16
                data = arr.to(torch.float32).to(dt).contiguous().cpu().numpy()
            else:
                data = np.ascontiguousarray(arr, "<f4" if ttype == GGMLType.F32 else "<f2")
        else:
            t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(arr, np.float32))
            data = quantize(ttype, t.reshape(-1, t.shape[-1])).cpu().numpy()
        return self.add_tensor(name, ne, ttype, data.reshape(-1).view(np.uint8))

    # -- serialization ----------------------------------------------------

    @staticmethod
    def _write_str(f, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f, vtype: int, value):
        if vtype == GGUFValueType.STRING:
            self._write_str(f, value)
            return
        if vtype == GGUFValueType.ARRAY:
            value = list(value)
            if value and isinstance(value[0], str):
                atype = GGUFValueType.STRING
            elif value and isinstance(value[0], bool):
                atype = GGUFValueType.BOOL
            elif value and isinstance(value[0], float):
                atype = GGUFValueType.FLOAT32
            elif all(isinstance(v, (int, np.integer)) for v in value):
                atype = GGUFValueType.INT32
            else:
                atype = GGUFValueType.FLOAT32
            f.write(struct.pack("<iQ", atype, len(value)))
            for v in value:
                self._write_value(f, atype, v)
            return
        fmt = _SCALAR_FMT[vtype]
        f.write(struct.pack(fmt, int(value) if vtype == GGUFValueType.BOOL else value))

    def write(self, path: str | Path):
        self.set(GGUF_KEY_GENERAL_ALIGNMENT, self.alignment, GGUFValueType.UINT32)
        head = io.BytesIO()
        head.write(GGUF_MAGIC)
        head.write(struct.pack("<I", GGUF_VERSION))
        head.write(struct.pack("<qq", len(self._tensors), len(self.kv)))
        for key, (vtype, value) in self.kv.items():
            self._write_str(head, key)
            head.write(struct.pack("<i", vtype))
            self._write_value(head, vtype, value)
        offset = 0
        for name, ne, ttype, data in self._tensors:
            self._write_str(head, name)
            head.write(struct.pack("<I", len(ne)))
            head.write(struct.pack(f"<{len(ne)}q", *ne))
            head.write(struct.pack("<i", int(ttype)))
            head.write(struct.pack("<Q", offset))
            offset += len(data)
            offset = (offset + self.alignment - 1) // self.alignment * self.alignment
        head.write(b"\x00" * ((-head.tell()) % self.alignment))
        with open(path, "wb") as f:
            f.write(head.getvalue())
            for _, _, _, data in self._tensors:
                f.write(data)
                f.write(b"\x00" * ((-len(data)) % self.alignment))
