"""Op surface of the port: the JAX package's ops/__init__.py, name for
name, plus `embed_rows` — elementwise, norms, softmax, rows, rope (rope_ext
and the multimodal rope_multi), attention, quantized matmul, convolution,
pooling, resampling, SAM's window ops, the Mamba SSM ops, the RWKV and
gated-linear-attention recurrences, MoE routing, activation quantization."""
from .act_quant import dequantize_q8, quantize_q8, quantize_q8_with_sums  # noqa: F401
from .attention import (attention_ref, causal_attn_delta,  # noqa: F401
                        causal_flash_attn, flash_attn_ext)
from .basic import (  # noqa: F401
    abs_, acc, add1, alibi_slopes, arange, argmax, argsort, causal_mask,
    clamp, concat, count_equal, cross_entropy_loss, diag_mask_inf, elu,
    embedding, exp, geglu, geglu_erf, geglu_quick, gelu, gelu_erf, gelu_quick,
    get_rows, group_norm, hardsigmoid, hardswish, l2_norm, leaky_relu, mean,
    neg, norm, out_prod, pad, pad_reflect_1d, reglu, relu, repeat, rms_norm, roll, scale,
    set_rows, sgn, sigmoid, silu, soft_max, soft_max_ext, softcap, step, sum_,
    sum_rows, swiglu, swiglu_oai, tanh, timestep_embedding, top_k, UNARY,
)
from .conv import (  # noqa: F401
    add_rel_pos, conv_1d, conv_1d_dw, conv_2d, conv_2d_dw, conv_3d, conv_transpose_1d,
    conv_transpose_2d, get_rel_pos, im2col, interpolate_bilinear, pool_1d, pool_2d,
    ssm_conv, ssm_scan, upscale_nearest, win_part, win_unpart,
)
from .quantized import QuantTensor, dequant, embed_rows, qmatmul, to_int8_layout  # noqa: F401
from .recurrent import gated_linear_attn, mul_mat_id, rwkv_wkv6, rwkv_wkv7  # noqa: F401
from .rope import (ROPE_TYPE_MROPE, ROPE_TYPE_NEOX, ROPE_TYPE_NORMAL,  # noqa: F401
                   ROPE_TYPE_VISION, rope_ext, rope_multi, yarn_corr_dims)
