"""Route quantized matmuls to their kernels by type, M and shape, as
ggml_gfx906_tpu/ops/pallas/dispatch.py:28-85 does: with `qmm_pipeline`
"on" (or "auto" and the operands on the card) a single-row Q4_K product of
a weight with N % 128 == 0, N >= 256 takes K10; otherwise a type with an
int8 twin (Q4_K → K3, Q8_0 → K5-i8, Q4_0 → K6-i8) takes it at M >=
int8_min_m (> 0); every other M, and every M of a type without one (Q6_K →
K4, Q5_K → K7, Q4_1 / Q5_0 / Q5_1 → K8, Q2_K / Q3_K → K9), takes the f32
kernel (Q4_K → K1, Q8_0 → K5, Q4_0 → K6)."""
from __future__ import annotations

from ...quant.types import GGMLType
from ...utils import config
from . import qmm, qmm_legacy, qmm_pipe, qmm_q4_0, qmm_q5k, qmm_q6k, qmm_q8_0, qmm_q23k

# the QuantTensor fields of each ported type, in the order its kernels take them
FIELDS = {GGMLType.Q4_K: ("qs", "scm", "dd"), GGMLType.Q6_K: ("ql", "qh", "sc", "d"),
          GGMLType.Q8_0: ("qs", "d"), GGMLType.Q4_0: ("qs", "d"),
          GGMLType.Q5_K: ("qs", "qh", "scm", "dd"), GGMLType.Q4_1: ("qs", "d", "m"),
          GGMLType.Q5_0: ("qs", "qh", "d"), GGMLType.Q5_1: ("qs", "qh", "d", "m"),
          GGMLType.Q2_K: ("qs", "scales", "d", "dmin"),
          GGMLType.Q3_K: ("qs", "hmask", "sc", "d")}
_KERNELS = {
    (GGMLType.Q4_K, "f32"): qmm.qmm_q4_K,
    (GGMLType.Q4_K, "i8"): qmm.qmm_q4_K_i8,
    (GGMLType.Q4_K, "pipe"): qmm_pipe.qmm_q4_K_pipelined,
    (GGMLType.Q6_K, "f32"): qmm_q6k.qmm_q6_K,
    (GGMLType.Q8_0, "f32"): qmm_q8_0.qmm_q8_0,
    (GGMLType.Q8_0, "i8"): qmm_q8_0.qmm_q8_0_i8,
    (GGMLType.Q4_0, "f32"): qmm_q4_0.qmm_q4_0,
    (GGMLType.Q4_0, "i8"): qmm_q4_0.qmm_q4_0_i8,
    (GGMLType.Q5_K, "f32"): qmm_q5k.qmm_q5_K,
    (GGMLType.Q4_1, "f32"): qmm_legacy.qmm_q4_1,
    (GGMLType.Q5_0, "f32"): qmm_legacy.qmm_q5_0,
    (GGMLType.Q5_1, "f32"): qmm_legacy.qmm_q5_1,
    (GGMLType.Q2_K, "f32"): qmm_q23k.qmm_q2_K,
    (GGMLType.Q3_K, "f32"): qmm_q23k.qmm_q3_K,
}
KERNEL_TYPES = set(FIELDS)
INT8_TYPES = {t for t, r in _KERNELS if r == "i8"}
PIPELINE_TYPES = {t for t, r in _KERNELS if r == "pipe"}


def _use_pipeline(m: int, qtype: GGMLType, shape, cuda: bool) -> bool:
    """ops/pallas/dispatch.py:28-39: "auto" is "on" where the operands are
    on the card, as the reference's is on the TPU."""
    mode = config.get("qmm_pipeline")
    if mode == "off" or qtype not in PIPELINE_TYPES or shape is None:
        return False
    if mode == "auto" and not cuda:
        return False
    n, k = shape
    return m == 1 and n % 128 == 0 and k % 256 == 0 and n >= 256


def route(m: int, qtype: GGMLType, shape=None, cuda: bool = False) -> str:
    """'pipe', 'i8' or 'f32': the kernel a (m, K) @ W(qtype).T product
    takes, W of `shape` (N, K) on the card if `cuda` (without a shape, the
    pipelined route is not considered)."""
    if qtype not in KERNEL_TYPES:
        raise NotImplementedError(f"{qtype.name} matmul kernel is not ported yet")
    if _use_pipeline(m, qtype, shape, cuda):
        return "pipe"
    min_m = int(config.get("int8_min_m"))
    return "i8" if qtype in INT8_TYPES and min_m > 0 and m >= min_m else "f32"


def matmul(x, qt):
    """x (..., K) @ qt(N, K).T → (..., N) f32 through qt's kernel."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    r = route(x2.shape[0], qt.qtype, qt.shape, x2.is_cuda)
    out = _KERNELS[(qt.qtype, r)](x2, *(qt.fields[f] for f in FIELDS[qt.qtype]))
    return out.reshape(*lead, qt.shape[0])
