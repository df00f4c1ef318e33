"""Training layer (the port of ggml_gfx906_tpu/training; ref:
src/ggml-opt.cpp — datasets, loss, AdamW/SGD, epoch/fit loops)."""
from .opt import AdamWParams, SGDParams, adamw_init, adamw_step, sgd_step  # noqa: F401
