"""Hand-written Hopper kernels and their wrappers (the counterpart of the
JAX package's ops/pallas/).

Each kernel has a `Kernel` record here: its name, its CUDA source, the TPU
kernel it replaces (for S1-S3, the numpy search they replace: the JAX
package runs the IQ grid searches on the host), and a plain-integer launch
count that its wrapper
raises by one at every launch (and nowhere else). A wrapper given a CPU
tensor runs the kernel's plain PyTorch version instead; given a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Kernel:
    name: str
    source: str          # path in the repo
    replaces: str        # file:line of the TPU kernel
    launches: int = 0


K1 = Kernel("qmm_q4_K", "ggml_gfx906_tpu_torch/csrc/qmm_q4k.cu",
            "ggml_gfx906_tpu/ops/pallas/qmm.py:183")
K2 = Kernel("causal_flash_attention", "ggml_gfx906_tpu_torch/csrc/flash_attn.cu",
            "ggml_gfx906_tpu/ops/pallas/flash_attn.py:130")
K3 = Kernel("qmm_q4_K_i8", "ggml_gfx906_tpu_torch/csrc/qmm_q4k.cu",
            "ggml_gfx906_tpu/ops/pallas/qmm.py:674")
K4 = Kernel("qmm_q6_K", "ggml_gfx906_tpu_torch/csrc/qmm_q6k.cu",
            "ggml_gfx906_tpu/ops/pallas/qmm.py:814")
K5 = Kernel("qmm_q8_0", "ggml_gfx906_tpu_torch/csrc/qmm_q8_0.cu",
            "ggml_gfx906_tpu/ops/pallas/qmm.py:443")
K5_I8 = Kernel("qmm_q8_0_i8", "ggml_gfx906_tpu_torch/csrc/qmm_q8_0.cu",
               "ggml_gfx906_tpu/ops/pallas/qmm.py:692")
K6 = Kernel("qmm_q4_0", "ggml_gfx906_tpu_torch/csrc/qmm_legacy.cu",
            "ggml_gfx906_tpu/ops/pallas/qmm.py:489")
K6_I8 = Kernel("qmm_q4_0_i8", "ggml_gfx906_tpu_torch/csrc/qmm_q4_0.cu",
               "ggml_gfx906_tpu/ops/pallas/qmm.py:704")
K7 = Kernel("qmm_q5_K", "ggml_gfx906_tpu_torch/csrc/qmm_q5k.cu",
            "ggml_gfx906_tpu/ops/pallas/qmm.py:889")
K8_Q4_1 = Kernel("qmm_q4_1", "ggml_gfx906_tpu_torch/csrc/qmm_legacy.cu",
                 "ggml_gfx906_tpu/ops/pallas/qmm.py:935")
K8_Q5_0 = Kernel("qmm_q5_0", "ggml_gfx906_tpu_torch/csrc/qmm_legacy.cu",
                 "ggml_gfx906_tpu/ops/pallas/qmm.py:1017")
K8_Q5_1 = Kernel("qmm_q5_1", "ggml_gfx906_tpu_torch/csrc/qmm_legacy.cu",
                 "ggml_gfx906_tpu/ops/pallas/qmm.py:1028")
K9_Q2_K = Kernel("qmm_q2_K", "ggml_gfx906_tpu_torch/csrc/qmm_q23k.cu",
                 "ggml_gfx906_tpu/ops/pallas/qmm.py:1146")
K9_Q3_K = Kernel("qmm_q3_K", "ggml_gfx906_tpu_torch/csrc/qmm_q23k.cu",
                 "ggml_gfx906_tpu/ops/pallas/qmm.py:1158")
K10 = Kernel("qmm_q4_K_pipelined", "ggml_gfx906_tpu_torch/csrc/qmm_q4k_pipe.cu",
             "ggml_gfx906_tpu/ops/pallas/qmm.py:349")
K11 = Kernel("dma_copy", "ggml_gfx906_tpu_torch/csrc/dma_copy.cu",
             "ggml_gfx906_tpu/utils/autotune.py:142")
S1 = Kernel("iq3_search", "ggml_gfx906_tpu_torch/csrc/iq_search.cu",
            "ggml_gfx906_tpu/quant/iquants.py:351")
S2 = Kernel("iq2_search", "ggml_gfx906_tpu_torch/csrc/iq_search.cu",
            "ggml_gfx906_tpu/quant/iquants.py:648")
S3 = Kernel("iq1_search", "ggml_gfx906_tpu_torch/csrc/iq_search.cu",
            "ggml_gfx906_tpu/quant/iquants.py:983")
KERNELS = (K1, K2, K3, K4, K5, K5_I8, K6, K6_I8, K7, K8_Q4_1, K8_Q5_0, K8_Q5_1,
           K9_Q2_K, K9_Q3_K, K10, K11, S1, S2, S3)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
