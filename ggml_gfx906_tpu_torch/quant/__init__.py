"""Quant types and codecs (ref: src/ggml-quants.c, src/ggml-common.h): the
type tables (numpy dtypes) and every codec as torch functions on the
device of their input."""
from .types import (  # noqa: F401
    GGMLType,
    TYPE_TRAITS,
    TypeTraits,
    QK_K,
    K_SCALE_SIZE,
    BLOCK_Q4_K,
    row_size,
)
from .registry import (  # noqa: F401
    bytes_to_blocks,
    dequantize,
    dequantize_bytes,
    quantize,
    quantize_to_bytes,
    supported_quant_types,
)
