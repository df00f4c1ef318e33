"""Quant types and the Q4_0, Q4_1, Q5_0, Q5_1, Q4_K, Q5_K, Q6_K and Q8_0
dequantization math (numpy types, torch math)."""
from .types import (  # noqa: F401
    GGMLType,
    TYPE_TRAITS,
    TypeTraits,
    QK_K,
    K_SCALE_SIZE,
    BLOCK_Q4_K,
    row_size,
)
