"""Op surface of the port: norms, rope, attention, quantized matmul,
activation quantization."""
from .act_quant import dequantize_q8, quantize_q8, quantize_q8_with_sums  # noqa: F401
from .attention import attention_ref, causal_attn_delta, causal_flash_attn  # noqa: F401
from .basic import rms_norm, silu  # noqa: F401
from .quantized import QuantTensor, dequant, embed_rows, qmatmul  # noqa: F401
from .rope import ROPE_TYPE_NEOX, ROPE_TYPE_NORMAL, rope_ext  # noqa: F401
