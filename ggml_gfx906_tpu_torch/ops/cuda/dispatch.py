"""Route Q4_K matmuls to K1 or K3 by M (ggml_gfx906_tpu/ops/pallas/
dispatch.py:42-63, Q4_K branch): M >= int8_min_m (> 0) takes the int8
kernel, every smaller M the f32 kernel."""
from __future__ import annotations

from ...quant.types import GGMLType
from ...utils import config
from . import qmm

KERNEL_TYPES = {GGMLType.Q4_K}


def route(m: int, qtype: GGMLType) -> str:
    """'i8' or 'f32': the kernel a (m, K) @ W(qtype).T product takes."""
    if qtype not in KERNEL_TYPES:
        raise NotImplementedError(f"{qtype.name} matmul kernel is not ported yet")
    min_m = int(config.get("int8_min_m"))
    return "i8" if min_m > 0 and m >= min_m else "f32"


def matmul(x, qt):
    """x (..., K) @ qt(N, K).T → (..., N) f32 through K1 or K3."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    f = qt.fields
    if route(x2.shape[0], qt.qtype) == "i8":
        out = qmm.qmm_q4_K_i8(x2, f["qs"], f["scm"], f["dd"])
    else:
        out = qmm.qmm_q4_K(x2, f["qs"], f["scm"], f["dd"])
    return out.reshape(*lead, qt.shape[0])
