"""Quant type enumeration + type-traits table.

A numpy-only copy of ggml_gfx906_tpu/quant/types.py, kept here so the port
imports nothing from the JAX package.

Mirrors the ggml type system (ref: ggml's include/ggml.h:450-581 enum
ggml_type; traits table include/ggml.h:2439-2449; block layouts
src/ggml-common.h:170-345) re-expressed as numpy structured dtypes so packed
GGUF data can be viewed zero-copy as struct-of-arrays.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

QK4_0 = 32
QK4_1 = 32
QK5_0 = 32
QK5_1 = 32
QK8_0 = 32
QK8_1 = 32
QK_K = 256
K_SCALE_SIZE = 12
QK_MXFP4 = 32
QK4_NL = 32

GROUP_MAX_EPS = np.float32(1e-15)


class GGMLType(enum.IntEnum):
    """Wire-format type ids (stable; used by GGUF). ref include/ggml.h:450-581."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


# Block layouts as packed numpy structured dtypes (bit-identical to the C
# structs in src/ggml-common.h; numpy default is unaligned/packed which matches
# the static_asserts on sizeof there).
BLOCK_Q4_0 = np.dtype([("d", "<f2"), ("qs", "u1", (QK4_0 // 2,))])
BLOCK_Q4_1 = np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (QK4_1 // 2,))])
BLOCK_Q5_0 = np.dtype([("d", "<f2"), ("qh", "u1", (4,)), ("qs", "u1", (QK5_0 // 2,))])
BLOCK_Q5_1 = np.dtype(
    [("d", "<f2"), ("m", "<f2"), ("qh", "u1", (4,)), ("qs", "u1", (QK5_1 // 2,))]
)
BLOCK_Q8_0 = np.dtype([("d", "<f2"), ("qs", "i1", (QK8_0,))])
BLOCK_Q8_1 = np.dtype([("d", "<f2"), ("s", "<f2"), ("qs", "i1", (QK8_1,))])
BLOCK_Q2_K = np.dtype(
    [
        ("scales", "u1", (QK_K // 16,)),
        ("qs", "u1", (QK_K // 4,)),
        ("d", "<f2"),
        ("dmin", "<f2"),
    ]
)
BLOCK_Q3_K = np.dtype(
    [
        ("hmask", "u1", (QK_K // 8,)),
        ("qs", "u1", (QK_K // 4,)),
        ("scales", "u1", (12,)),
        ("d", "<f2"),
    ]
)
BLOCK_Q4_K = np.dtype(
    [
        ("d", "<f2"),
        ("dmin", "<f2"),
        ("scales", "u1", (K_SCALE_SIZE,)),
        ("qs", "u1", (QK_K // 2,)),
    ]
)
BLOCK_Q5_K = np.dtype(
    [
        ("d", "<f2"),
        ("dmin", "<f2"),
        ("scales", "u1", (K_SCALE_SIZE,)),
        ("qh", "u1", (QK_K // 8,)),
        ("qs", "u1", (QK_K // 2,)),
    ]
)
BLOCK_Q6_K = np.dtype(
    [
        ("ql", "u1", (QK_K // 2,)),
        ("qh", "u1", (QK_K // 4,)),
        ("scales", "i1", (QK_K // 16,)),
        ("d", "<f2"),
    ]
)
BLOCK_Q8_K = np.dtype(
    [("d", "<f4"), ("qs", "i1", (QK_K,)), ("bsums", "<i2", (QK_K // 16,))]
)
# ref src/ggml-common.h:190-195 (mxfp4), :238-256 (ternary), :415-428 (iq4)
BLOCK_MXFP4 = np.dtype([("e", "u1"), ("qs", "u1", (QK_MXFP4 // 2,))])
BLOCK_TQ1_0 = np.dtype(
    [("qs", "u1", ((QK_K - 4 * QK_K // 64) // 5,)), ("qh", "u1", (QK_K // 64,)),
     ("d", "<f2")]
)
BLOCK_TQ2_0 = np.dtype([("qs", "u1", (QK_K // 4,)), ("d", "<f2")])
BLOCK_IQ4_NL = np.dtype([("d", "<f2"), ("qs", "u1", (QK4_NL // 2,))])
BLOCK_IQ4_XS = np.dtype(
    [("d", "<f2"), ("scales_h", "<u2"), ("scales_l", "u1", (QK_K // 64,)),
     ("qs", "u1", (QK_K // 2,))]
)
# codebook i-quants, ref src/ggml-common.h:348-406
BLOCK_IQ2_XXS = np.dtype([("d", "<f2"), ("qs", "<u2", (QK_K // 8,))])
BLOCK_IQ2_XS = np.dtype(
    [("d", "<f2"), ("qs", "<u2", (QK_K // 8,)), ("scales", "u1", (QK_K // 32,))]
)
BLOCK_IQ2_S = np.dtype(
    [("d", "<f2"), ("qs", "u1", (QK_K // 4,)), ("qh", "u1", (QK_K // 32,)),
     ("scales", "u1", (QK_K // 32,))]
)
BLOCK_IQ3_XXS = np.dtype([("d", "<f2"), ("qs", "u1", (3 * QK_K // 8,))])
BLOCK_IQ3_S = np.dtype(
    [("d", "<f2"), ("qs", "u1", (QK_K // 4,)), ("qh", "u1", (QK_K // 32,)),
     ("signs", "u1", (QK_K // 8,)), ("scales", "u1", (QK_K // 64,))]
)
BLOCK_IQ1_S = np.dtype(
    [("d", "<f2"), ("qs", "u1", (QK_K // 8,)), ("qh", "<u2", (QK_K // 32,))]
)
BLOCK_IQ1_M = np.dtype(
    [("qs", "u1", (QK_K // 8,)), ("qh", "u1", (QK_K // 16,)),
     ("scales", "u1", (QK_K // 32,))]
)


@dataclass(frozen=True)
class TypeTraits:
    """Analogue of ggml_type_traits (include/ggml.h:2439-2449)."""

    name: str
    blck_size: int
    type_size: int
    is_quantized: bool
    block_dtype: np.dtype | None = None
    # companion activation-quant type for integer dot products
    # (ggml "vec_dot_type", include/ggml-cpu.h traits)
    vec_dot_type: "GGMLType | None" = None


TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits("f32", 1, 4, False),
    GGMLType.F16: TypeTraits("f16", 1, 2, False),
    GGMLType.BF16: TypeTraits("bf16", 1, 2, False),
    GGMLType.F64: TypeTraits("f64", 1, 8, False),
    GGMLType.I8: TypeTraits("i8", 1, 1, False),
    GGMLType.I16: TypeTraits("i16", 1, 2, False),
    GGMLType.I32: TypeTraits("i32", 1, 4, False),
    GGMLType.I64: TypeTraits("i64", 1, 8, False),
    GGMLType.Q4_0: TypeTraits(
        "q4_0", QK4_0, BLOCK_Q4_0.itemsize, True, BLOCK_Q4_0, GGMLType.Q8_0
    ),
    GGMLType.Q4_1: TypeTraits(
        "q4_1", QK4_1, BLOCK_Q4_1.itemsize, True, BLOCK_Q4_1, GGMLType.Q8_1
    ),
    GGMLType.Q5_0: TypeTraits(
        "q5_0", QK5_0, BLOCK_Q5_0.itemsize, True, BLOCK_Q5_0, GGMLType.Q8_0
    ),
    GGMLType.Q5_1: TypeTraits(
        "q5_1", QK5_1, BLOCK_Q5_1.itemsize, True, BLOCK_Q5_1, GGMLType.Q8_1
    ),
    GGMLType.Q8_0: TypeTraits(
        "q8_0", QK8_0, BLOCK_Q8_0.itemsize, True, BLOCK_Q8_0, GGMLType.Q8_0
    ),
    GGMLType.Q8_1: TypeTraits(
        "q8_1", QK8_1, BLOCK_Q8_1.itemsize, True, BLOCK_Q8_1, GGMLType.Q8_1
    ),
    GGMLType.Q2_K: TypeTraits(
        "q2_K", QK_K, BLOCK_Q2_K.itemsize, True, BLOCK_Q2_K, GGMLType.Q8_K
    ),
    GGMLType.Q3_K: TypeTraits(
        "q3_K", QK_K, BLOCK_Q3_K.itemsize, True, BLOCK_Q3_K, GGMLType.Q8_K
    ),
    GGMLType.Q4_K: TypeTraits(
        "q4_K", QK_K, BLOCK_Q4_K.itemsize, True, BLOCK_Q4_K, GGMLType.Q8_K
    ),
    GGMLType.Q5_K: TypeTraits(
        "q5_K", QK_K, BLOCK_Q5_K.itemsize, True, BLOCK_Q5_K, GGMLType.Q8_K
    ),
    GGMLType.Q6_K: TypeTraits(
        "q6_K", QK_K, BLOCK_Q6_K.itemsize, True, BLOCK_Q6_K, GGMLType.Q8_K
    ),
    GGMLType.Q8_K: TypeTraits(
        "q8_K", QK_K, BLOCK_Q8_K.itemsize, True, BLOCK_Q8_K, GGMLType.Q8_K
    ),
    GGMLType.MXFP4: TypeTraits(
        "mxfp4", QK_MXFP4, BLOCK_MXFP4.itemsize, True, BLOCK_MXFP4, GGMLType.Q8_0
    ),
    GGMLType.TQ1_0: TypeTraits(
        "tq1_0", QK_K, BLOCK_TQ1_0.itemsize, True, BLOCK_TQ1_0, GGMLType.Q8_K
    ),
    GGMLType.TQ2_0: TypeTraits(
        "tq2_0", QK_K, BLOCK_TQ2_0.itemsize, True, BLOCK_TQ2_0, GGMLType.Q8_K
    ),
    GGMLType.IQ4_NL: TypeTraits(
        "iq4_nl", QK4_NL, BLOCK_IQ4_NL.itemsize, True, BLOCK_IQ4_NL, GGMLType.Q8_0
    ),
    GGMLType.IQ4_XS: TypeTraits(
        "iq4_xs", QK_K, BLOCK_IQ4_XS.itemsize, True, BLOCK_IQ4_XS, GGMLType.Q8_K
    ),
    GGMLType.IQ2_XXS: TypeTraits(
        "iq2_xxs", QK_K, BLOCK_IQ2_XXS.itemsize, True, BLOCK_IQ2_XXS, GGMLType.Q8_K
    ),
    GGMLType.IQ2_XS: TypeTraits(
        "iq2_xs", QK_K, BLOCK_IQ2_XS.itemsize, True, BLOCK_IQ2_XS, GGMLType.Q8_K
    ),
    GGMLType.IQ2_S: TypeTraits(
        "iq2_s", QK_K, BLOCK_IQ2_S.itemsize, True, BLOCK_IQ2_S, GGMLType.Q8_K
    ),
    GGMLType.IQ3_XXS: TypeTraits(
        "iq3_xxs", QK_K, BLOCK_IQ3_XXS.itemsize, True, BLOCK_IQ3_XXS, GGMLType.Q8_K
    ),
    GGMLType.IQ3_S: TypeTraits(
        "iq3_s", QK_K, BLOCK_IQ3_S.itemsize, True, BLOCK_IQ3_S, GGMLType.Q8_K
    ),
    GGMLType.IQ1_S: TypeTraits(
        "iq1_s", QK_K, BLOCK_IQ1_S.itemsize, True, BLOCK_IQ1_S, GGMLType.Q8_K
    ),
    GGMLType.IQ1_M: TypeTraits(
        "iq1_m", QK_K, BLOCK_IQ1_M.itemsize, True, BLOCK_IQ1_M, GGMLType.Q8_K
    ),
}

# sanity: sizes must match the C static_asserts in src/ggml-common.h
assert BLOCK_Q4_0.itemsize == 18
assert BLOCK_Q4_1.itemsize == 20
assert BLOCK_Q5_0.itemsize == 22
assert BLOCK_Q5_1.itemsize == 24
assert BLOCK_Q8_0.itemsize == 34
assert BLOCK_Q8_1.itemsize == 36
assert BLOCK_Q2_K.itemsize == 2 * 2 + QK_K // 16 + QK_K // 4
assert BLOCK_Q3_K.itemsize == 2 + QK_K // 4 + QK_K // 8 + 12
assert BLOCK_Q4_K.itemsize == 2 * 2 + K_SCALE_SIZE + QK_K // 2
assert BLOCK_Q5_K.itemsize == 2 * 2 + K_SCALE_SIZE + QK_K // 2 + QK_K // 8
assert BLOCK_Q6_K.itemsize == 2 + QK_K // 16 + 3 * QK_K // 4
assert BLOCK_Q8_K.itemsize == 4 + QK_K + QK_K // 16 * 2
assert BLOCK_MXFP4.itemsize == 1 + QK_MXFP4 // 2
assert BLOCK_TQ1_0.itemsize == 2 + QK_K // 64 + (QK_K - 4 * QK_K // 64) // 5
assert BLOCK_TQ2_0.itemsize == 2 + QK_K // 4
assert BLOCK_IQ4_NL.itemsize == 2 + QK4_NL // 2
assert BLOCK_IQ4_XS.itemsize == 2 + 2 + QK_K // 64 + QK_K // 2


def row_size(t: GGMLType, n: int) -> int:
    """Bytes for n elements of type t (ggml_row_size, src/ggml.c)."""
    tt = TYPE_TRAITS[t]
    assert n % tt.blck_size == 0, (t, n)
    return n // tt.blck_size * tt.type_size
