"""Multi-process parallelism on torch.distributed — the port of
ggml_gfx906_tpu/parallel/ (a jax mesh under one controller there, one
process per mesh position here: parallel/mesh.py)."""
from .mesh import (  # noqa: F401
    GPT2_RULES,
    P,
    make_mesh,
    shard_array,
    shard_gpt2_params,
    shard_quant_tensor,
)
