"""Bit-exact scalar numeric helpers shared by the quant codecs, on tensors.

The counterpart of ggml_gfx906_tpu/quant/numerics.py (ggml's nearest_int,
src/ggml-quants.c:444-449, and its fp16 conversion, src/ggml-impl.h:
340-379). Every helper runs on the device of its input. Two rules keep the
codecs' f32 arithmetic equal to numpy's, op for op, on the CPU and the
card:

- a division is tensor by tensor (`const` makes the scalar side a 0-d
  tensor on the device): torch turns `c / t` into t.reciprocal() * c, and
  on the card a tensor divided by a Python scalar into a multiply by its
  reciprocal;
- a sum over an axis is a strict left-to-right loop of f32 adds
  (`seq_sum`): torch's reductions and its CPU cumsum (which accumulates
  float32 in double) round in another order;
- a square root is `sqrt` here, correctly rounded on both devices.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def const(v, like: torch.Tensor) -> torch.Tensor:
    """The f32 value v as a 0-d tensor on like's device (an operand that a
    division treats as a tensor, never as a scalar), made by a fill there:
    no host-to-device copy, which would wait for the stream."""
    return torch.full((), v, dtype=F32, device=like.device)


def fp16_round(x: torch.Tensor) -> torch.Tensor:
    """Round-trip f32 through f16 storage (round to nearest even), what
    storing a ggml_half does."""
    return x.to(torch.float16).to(F32)


def f16_bytes(x: torch.Tensor) -> torch.Tensor:
    """(...) f32 → (..., 2) uint8: the little-endian bytes of x in f16."""
    return x.to(torch.float16).unsqueeze(-1).view(torch.uint8)


def f16_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(..., 2) uint8 → (...) f32."""
    return b.contiguous().view(torch.float16)[..., 0].to(F32)


_I32_MIN = -2147483648.0


def _as_i32(r: torch.Tensor) -> torch.Tensor:
    """Integer-valued f32 as numpy's astype(np.int32) leaves it on x86, kept
    in f32: a value outside int32, or NaN, becomes −2^31."""
    return torch.where(r.abs() < -_I32_MIN, r, _I32_MIN)


def nearest_int(x: torch.Tensor) -> torch.Tensor:
    """np.rint(x).astype(np.int32) in f32: round half to even, as ggml's
    nearest_int (the 12582912.0f trick). The search loops whose argument is
    bounded by construction call torch.round directly."""
    return _as_i32(torch.round(x))


def trunc_i(x: torch.Tensor) -> torch.Tensor:
    """C float → int cast (truncation toward zero), in f32."""
    return _as_i32(torch.trunc(x))


def roundf_c(x: torch.Tensor) -> torch.Tensor:
    """C roundf: round half away from zero (the q8_0/q8_1 quantizers), as
    sign(x)·floor(|x| + 0.5) in f32, the reference's order."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def signed_absmax(x: torch.Tensor) -> torch.Tensor:
    """Per row (last axis) the value with the largest |.|, the first on ties
    (torch.argmax returns the first maximum), as the reference's `if (amax <
    fabsf(v))` scan."""
    idx = torch.argmax(torch.abs(x), dim=-1, keepdim=True)
    return torch.gather(x, -1, idx)[..., 0]


def seq_sum(a: torch.Tensor) -> torch.Tensor:
    """Strict left-to-right f32 sum over the last axis (np.cumsum(dtype=
    float32)[..., -1], the C loops' `acc += a[i]`): one add per column over
    a column-major copy."""
    cols = a.to(F32).movedim(-1, 0).contiguous()
    acc = cols[0].clone()
    for i in range(1, cols.shape[0]):
        acc += cols[i]
    return acc


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as numpy's and C's sqrtf: taken in
    float64 and rounded once (exact for sqrt). torch's f32 sqrt on the CPU
    (its AVX-512 kernel) is off by an ulp for some inputs."""
    return torch.sqrt(x.to(torch.float64)).to(F32)


def safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b, 0 where b == 0 (the `d ? 1.0f/d : 0.0f` idiom)."""
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, 1.0), 0.0)


def min0(x: torch.Tensor) -> torch.Tensor:
    """np.minimum(x, 0.0f): x where x < 0, else +0 (numpy returns its second
    operand on equal zeros, so −0 becomes +0)."""
    return torch.where(x < 0, x, torch.zeros_like(x))
