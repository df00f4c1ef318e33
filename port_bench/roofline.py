"""The yardstick of the per-layer metrics: the H100's published peaks, the
bytes and operations a forward's quantized products need, and the names
of the port's quantized-product kernels.

Counting rule (a forward of T real rows): each matrix's GGUF wire bytes,
counted once per forward, plus its activations in and out at 2 bytes an
element; 2·N·K operations per real row (never the padded rows a kernel
computes). An expert stack counts the experts the forward's tokens were
routed to, E·(1 − (1 − U/E)^T) in expectation (the harness cannot see the
routing; the reference's own routing checks the formula), each with the T·U
routed rows' operations. A matrix's least time is max(bytes / HBM,
ops / peak) with the peak of the fastest arithmetic the card offers these
operands (int8 / fp8, 1,979 TOP/s): a route-specific peak would read over
100% as soon as a product moved to faster arithmetic."""
from __future__ import annotations

from . import quant

HBM_BPS = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
ACT_BYTES = 2                # a bf16 activation element

# substrings of the device-trace names of the port's quantized-product
# kernels (csrc/qmm_*.cu, qmm_f32_tiled.cuh, qmm_i8_tiled.cuh): the f32
# bodies, the int8 bodies on their formats and their x quantization, K1's
# and K10's own kernels
QMM_KERNEL_NAMES = ("small_kernel<", "tiled_kernel<", "tree_kernel<", "quant_x_kernel<",
                    "Q4KI8", "Q80I8", "Q40I8", "qmm_q4k_f32_kernel", "pipe_kernel")


def is_qmm_kernel(name: str) -> bool:
    return any(p in name for p in QMM_KERNEL_NAMES)


def expected_experts(E: int, U: int, T: float) -> float:
    """Experts that T tokens, each routed to U of E uniformly, touch."""
    return E * (1.0 - (1.0 - U / E) ** T) if T > 0 else 0.0


def matrix_least_s(rows: int, cols: int, qtype: str, T: float, experts: int = 0,
                   U: int = 0) -> float:
    """Least seconds of one matrix (or expert stack) for T real rows."""
    if T <= 0:
        return 0.0
    if experts:
        touched = expected_experts(experts, U, T)
        nbytes = touched * rows * quant.row_bytes(qtype, cols) + T * U * (rows + cols) * ACT_BYTES
        ops = 2.0 * rows * cols * T * U
    else:
        nbytes = rows * quant.row_bytes(qtype, cols) + T * (rows + cols) * ACT_BYTES
        ops = 2.0 * rows * cols * T
    return max(nbytes / HBM_BPS, ops / PEAK["int8"])


def forward_least_s(products, T: float, U: int) -> float:
    """Least seconds of the quantized products of one forward of T real
    rows; `products` as ref/<arch>.py::products gives them."""
    return sum(matrix_least_s(r, c, qt, T, e, U) for _, _, r, c, e, qt in products)


def routed_experts(routes, T: int, rng, groups: int = 64) -> float:
    """The mean experts that random groups of T rows touch in a routing
    ([(rows, U) expert ids per layer], as ref/mixtral.py records it): what
    the formula stands for, read from the reference's own routing."""
    import numpy as np

    seen = []
    for idx in routes:
        ids = idx.cpu().numpy()
        for _ in range(groups):
            rows = rng.choice(ids.shape[0], size=min(T, ids.shape[0]), replace=False)
            seen.append(len(np.unique(ids[rows])))
    return float(np.mean(seen))
