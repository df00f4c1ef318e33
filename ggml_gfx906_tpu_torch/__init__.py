"""ggml_gfx906_tpu_torch — the PyTorch and CUDA port of ggml_gfx906_tpu.

The JAX package beside it stays the reference. This package imports torch
and numpy only. Its main path loads a llama-class GGUF in Q4_K, the
Q4_K_M or Q5_K_M mixture (Q4_K or Q5_K + Q6_K), Q8_0, Q4_0, Q4_1, Q5_0 or
Q5_1 (`models.llama.load`) and serves it through the continuous-batching
`runtime.engine.Engine`, on hand-written Hopper kernels (`ops/cuda/`,
sources in `csrc/`). Entry points run on the card unless the caller passes
device="cpu", where every kernel wrapper takes its plain PyTorch version.
"""
