"""Universal op-conformance harness — the test-backend-ops analogue (the
port of ggml_gfx906_tpu/tools/backend_ops.py).

ref: tests/test-backend-ops.cpp — ~78 parameterized op cases run in four
modes (MODE_TEST :1228 compares a backend against the CPU backend with
per-op NMSE thresholds; MODE_GRAD :1409; MODE_PERF :1247; MODE_SUPPORT
prints the supports_op matrix). The case table is the reference's: the
same names, shapes, `nmse_max`, `grad` flags and reasons, built on the
port's ops.

- `test`    every case on the card against the same case on the CPU (the
            plain PyTorch versions), within its nmse_max. Each case records
            the kernel launches it made; a `qmm_<type>_m<M>` case fails
            unless it launched the kernel ops/cuda/dispatch.py::route names
            (a weight that fell back to a plain path would pass the
            numerics and launch nothing). With `--device cpu` both legs are
            the plain path, as the reference's same-backend branch is.
- `grad`    autograd's directional derivative against central differences
            in float64. A case whose op takes no f64 on the card says so in
            the table (`grad_cpu`): its f64 leg runs on the CPU and the mode
            prints why; nothing falls back silently.
- `perf`    each case's device time on the card, by CUDA events behind a
            spin kernel, beside the host's dispatch time per call.
- `support` the type × layout table and the dispatch matrix at M ∈ {1, 8,
            64, 512} naming the kernel (K1…K10), with the grad-eligibility
            report.

    python -m ggml_gfx906_tpu_torch.tools.backend_ops test [--device cpu]
    python -m ggml_gfx906_tpu_torch.tools.backend_ops test --op qmm --verbose
    python -m ggml_gfx906_tpu_torch.tools.backend_ops grad perf support

Deliberate difference from the reference: a case's inputs are seeded by
zlib.crc32 of its name, where the reference takes abs(hash(name)), which
changes from process to process unless PYTHONHASHSEED is set; so a case's
inputs are the same in every run here.
"""
from __future__ import annotations

import argparse
import sys
import time
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass
class Case:
    name: str
    build: Callable[[], tuple]   # () -> (fn, args), args on the CPU
    nmse_max: float = 1e-7       # test mode threshold (vs the CPU)
    grad: bool = False           # eligible for grad mode
    flops: Callable[[], float] | None = None
    grad_reason: str | None = None   # why a case is grad-ineligible
    grad_cpu: str | None = None      # why its f64 leg runs on the CPU (None: on the device)
    qmm: tuple | None = None         # (qtype, M) of a quantized matmul case


CASES: list[Case] = []


def case(name, nmse_max=1e-7, grad=False, flops=None, grad_reason=None, grad_cpu=None,
         qmm=None):
    def reg(build):
        CASES.append(Case(name, build, nmse_max, grad, flops,
                          None if grad else grad_reason, grad_cpu, qmm))
        return build
    return reg


def _rng(name):
    return np.random.default_rng(zlib.crc32(name.encode()) % (2 ** 31))


def _np32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return torch.from_numpy(_np32(rng, *shape, scale=scale, shift=shift))


def _on(a, like: torch.Tensor) -> torch.Tensor:
    """A constant of a case (numpy or tensor) on the device of `like`."""
    return torch.as_tensor(a).to(like.device)


# --------------------------------------------------------------- the table
# The reference's shapes (test-backend-ops' small-but-odd sizes for
# semantics; power-of-two rows for the quantized kernels). Every build draws
# from its generator in the reference's order, so that under one seed both
# tables give the same inputs.

def _register_cases():
    if CASES:          # idempotent: main() may be called repeatedly in-process
        return
    from .. import ops
    from ..ops.quantized import QuantTensor, dequant, qmatmul, to_int8_layout
    from ..ops.cuda.dispatch import KERNEL_TYPES
    from ..quant.registry import supported_quant_types
    from ..quant.types import GGMLType, TYPE_TRAITS

    for uname in ("gelu", "gelu_erf", "gelu_quick", "silu", "elu", "relu",
                  "sigmoid", "tanh", "exp", "hardswish", "hardsigmoid",
                  "abs_", "sgn", "neg", "step"):
        fn = getattr(ops, uname)

        _kinked = {"relu", "abs_", "hardsigmoid", "hardswish"}

        @case(f"unary_{uname.rstrip('_')}",
              grad=uname not in ("sgn", "step") and uname not in _kinked,
              grad_reason=("zero gradient a.e. (piecewise-constant) - the "
                           "FD check is vacuous")
              if uname in ("sgn", "step") else
              "FD step crosses the activation's kink at this tensor size "
              "(measured relerr up to 0.26); analytic grads are exercised "
              "end-to-end in tests/test_grad.py")
        def build(fn=fn, uname=uname):
            return fn, (_f32(_rng(uname), 10, 5, 4, 3),)

    for gname in ("reglu", "geglu", "swiglu", "geglu_erf", "geglu_quick"):
        fn = getattr(ops, gname)

        @case(f"glu_{gname}", grad=True)
        def build(fn=fn, gname=gname):
            return fn, (_f32(_rng(gname), 6, 32),)

    @case("norm", grad=True)
    def _():
        return lambda x: ops.norm(x, 1e-5), (_f32(_rng("norm"), 4, 7, 64),)

    @case("rms_norm", grad=True)
    def _():
        return lambda x: ops.rms_norm(x, 1e-6), (_f32(_rng("rms"), 4, 7, 64),)

    @case("group_norm", grad=True)
    def _():
        return lambda x: ops.group_norm(x, 4), (_f32(_rng("gn"), 2, 8, 6, 5),)

    @case("l2_norm", grad=True)
    def _():
        return lambda x: ops.l2_norm(x), (_f32(_rng("l2"), 3, 33),)

    @case("soft_max", grad=True)
    def _():
        return ops.soft_max, (_f32(_rng("sm"), 4, 65),)

    @case("soft_max_ext_alibi", grad=True)
    def _():
        x = _f32(_rng("sme"), 2, 8, 5, 9)
        # the mask is a constant, not an argument: its -inf entries saturate
        # and an FD perturbation of them is meaningless; grads wrt x
        mask = np.triu(np.full((5, 9), -np.inf, np.float32), 2)
        return (lambda a: ops.soft_max_ext(a, _on(mask, a), scale=0.5, max_bias=8.0), (x,))

    @case("matmul_f32", grad=True, flops=lambda: 2 * 16 * 64 * 48)
    def _():
        r = _rng("mm")
        return torch.matmul, (_f32(r, 16, 64), _f32(r, 64, 48))

    @case("out_prod", grad=True)
    def _():
        r = _rng("op")
        return ops.out_prod, (_f32(r, 9, 5), _f32(r, 9, 7))

    @case("rope_neox", grad=True)
    def _():
        x = _f32(_rng("rope"), 7, 4, 32)
        pos = np.arange(7, dtype=np.int32)
        return (lambda a: ops.rope_ext(a, _on(pos, a), 32, mode=ops.ROPE_TYPE_NEOX), (x,))

    @case("rope_yarn", grad=True)
    def _():
        x = _f32(_rng("yarn"), 5, 2, 64)
        pos = np.arange(5, dtype=np.int32) * 17

        def f(a):
            return ops.rope_ext(a, _on(pos, a), 64, mode=ops.ROPE_TYPE_NEOX, freq_scale=0.25,
                                ext_factor=1.0, n_ctx_orig=512)
        return f, (x,)

    @case("rope_mrope", grad=True)
    def _():
        x = _f32(_rng("mrope"), 6, 2, 32)
        pos = np.stack([np.arange(6)] * 4).astype(np.int32)

        def f(a):
            return ops.rope_multi(a, _on(pos, a), 32, sections=(2, 3, 3, 0),
                                  mode=ops.ROPE_TYPE_MROPE)
        return f, (x,)

    @case("flash_attn_ext", nmse_max=2e-6, grad=True,
          flops=lambda: 4 * 1 * 4 * 33 * 65 * 16)
    def _():
        r = _rng("fa")
        q = _f32(r, 1, 4, 33, 16)
        k = _f32(r, 1, 2, 65, 16)
        v = _f32(r, 1, 2, 65, 16)
        return (lambda a, b, c: ops.flash_attn_ext(a, b, c), (q, k, v))

    @case("causal_flash_attn", nmse_max=2e-6, grad=True,
          grad_cpu="K2 takes f32/bf16 K/V only: an f64 leg on the card would raise in its "
                   "wrapper (ops/cuda/flash_attn.py); the CPU runs K2's plain version, whose "
                   "autograd is the card's backward (recomputed through _causal_ref)")
    def _():
        r = _rng("cfa")
        q = _f32(r, 1, 4, 1, 32)
        k = _f32(r, 1, 4, 64, 32)
        v = _f32(r, 1, 4, 64, 32)

        def f(a, b, c):
            return ops.causal_flash_attn(a, b, c, 40)
        return f, (q, k, v)

    @case("causal_attn_delta", nmse_max=2e-6, grad=True)
    def _():
        # window-delta decode attention: the big-cache segment [0, len0)
        # merged with the delta rows [0, step] at score level
        r = _rng("cad")
        B, KVH, H, W, DEPTH, D = 2, 2, 4, 48, 8, 32
        q = _f32(r, B, H, 1, D)
        kc = _f32(r, B, KVH, W, D)
        vc = _f32(r, B, KVH, W, D)
        dk = _f32(r, B, KVH, DEPTH, D)
        dv = _f32(r, B, KVH, DEPTH, D)
        len0 = np.array([17, 40], np.int32)

        def f(a, b, c, dkk, dvv):
            return ops.causal_attn_delta(a, b, c, None, None, _on(len0, a), dkk, dvv, 3)
        return f, (q, kc, vc, dk, dv)

    @case("conv_1d", grad=True)
    def _():
        r = _rng("c1")
        return (lambda x, w: ops.conv_1d(x, w, stride=2, padding=1),
                (_f32(r, 2, 3, 20), _f32(r, 5, 3, 4)))

    @case("conv_2d", grad=True)
    def _():
        r = _rng("c2")
        return (lambda x, w: ops.conv_2d(x, w, padding=(1, 1)),
                (_f32(r, 2, 3, 10, 9), _f32(r, 4, 3, 3, 3)))

    @case("conv_3d", grad=True)
    def _():
        r = _rng("c3")
        return (lambda x, w: ops.conv_3d(x, w), (_f32(r, 1, 2, 6, 7, 8), _f32(r, 3, 2, 2, 3, 3)))

    @case("conv_2d_dw", grad=True)
    def _():
        r = _rng("cdw")
        return (lambda x, w: ops.conv_2d_dw(x, w, padding=(1, 1)),
                (_f32(r, 2, 4, 8, 8), _f32(r, 4, 1, 3, 3)))

    @case("conv_transpose_1d", grad=True)
    def _():
        r = _rng("ct1")
        return (lambda x, w: ops.conv_transpose_1d(x, w, stride=2),
                (_f32(r, 1, 3, 9), _f32(r, 3, 4, 5)))

    @case("conv_transpose_2d", grad=True)
    def _():
        r = _rng("ct2")
        return (lambda x, w: ops.conv_transpose_2d(x, w, stride=2),
                (_f32(r, 1, 3, 5, 6), _f32(r, 3, 4, 3, 3)))

    @case("im2col", grad=True)
    def _():
        return (lambda x: ops.im2col(x, 3, 3, padding=(1, 1)), (_f32(_rng("i2c"), 1, 3, 8, 9),))

    @case("pool_2d_avg", grad=True)
    def _():
        return (lambda x: ops.pool_2d(x, "avg", (3, 3), (2, 2), (1, 1)),
                (_f32(_rng("pa"), 1, 2, 9, 11),))

    @case("pool_2d_max",
          grad_reason="max selection switches under the FD perturbation "
                      "(tie kinks); avg-pool covers the pooling adjoint")
    def _():
        return (lambda x: ops.pool_2d(x, "max", (2, 2), (2, 2)), (_f32(_rng("pm"), 1, 2, 8, 10),))

    @case("upscale_nearest", grad=True)
    def _():
        return (lambda x: ops.upscale_nearest(x, 2, 3), (_f32(_rng("up"), 1, 2, 4, 5),))

    @case("interpolate_bilinear", grad=True)
    def _():
        return (lambda x: ops.interpolate_bilinear(x, 7, 9), (_f32(_rng("ib"), 1, 2, 4, 5),))

    @case("ssm_conv", grad=True)
    def _():
        r = _rng("sc")
        return ops.ssm_conv, (_f32(r, 2, 5, 10), _f32(r, 5, 4))

    def _ssm_args(r):
        s = _f32(r, 2, 5, 4, scale=0.1)
        x = _f32(r, 2, 6, 5)
        dt = _f32(r, 2, 6, 5, scale=0.1, shift=0.2)
        A = _f32(r, 5, 4, scale=0.5, shift=-1.0)
        B = _f32(r, 2, 6, 4)
        C = _f32(r, 2, 6, 4)
        return s, x, dt, A, B, C

    @case("ssm_scan", nmse_max=1e-6, grad=True)
    def _():
        return ops.ssm_scan, _ssm_args(_rng("ss"))

    @case("rwkv_wkv6", nmse_max=1e-6, grad=True)
    def _():
        r = _rng("w6")
        B, T, H, S = 2, 5, 2, 4
        decay = torch.from_numpy(np.exp(-np.exp(_np32(r, B, T, H, S))).astype(np.float32))
        args = (_f32(r, B, T, H, S), _f32(r, B, T, H, S), _f32(r, B, T, H, S),
                _f32(r, H, S), decay, _f32(r, B, H, S, S, scale=0.1))
        return ops.rwkv_wkv6, args

    @case("rwkv_wkv7", nmse_max=1e-6, grad=True)
    def _():
        r = _rng("w7")
        B, T, H, S = 1, 4, 2, 3
        decay = torch.from_numpy(np.exp(-np.exp(_np32(r, B, T, H, S))).astype(np.float32))
        args = (_f32(r, B, T, H, S, scale=0.5), decay,
                _f32(r, B, T, H, S, scale=0.5), _f32(r, B, T, H, S, scale=0.5),
                _f32(r, B, T, H, S, scale=0.1), _f32(r, B, T, H, S, scale=0.1),
                _f32(r, B, H, S, S, scale=0.1))
        return ops.rwkv_wkv7, args

    @case("gated_linear_attn", nmse_max=1e-6, grad=True)
    def _():
        r = _rng("gla")
        B, T, H, S = 1, 4, 2, 3
        gate = torch.from_numpy((1.0 / (1.0 + np.exp(-_np32(r, B, T, H, S))))
                                .astype(np.float32))
        args = (_f32(r, B, T, H, S, scale=0.5), _f32(r, B, T, H, S, scale=0.5),
                _f32(r, B, T, H, S, scale=0.5), gate, _f32(r, B, H, S, S, scale=0.1))
        return (lambda k, v, q, g, s0: ops.gated_linear_attn(k, v, q, g, s0, scale=0.5), args)

    @case("mul_mat_id", grad=True)
    def _():
        r = _rng("mmid")
        experts = _f32(r, 4, 6, 8)     # (n_expert, N, K)
        x = _f32(r, 5, 2, 8)           # (T, n_used, K)
        ids = r.integers(0, 4, (5, 2)).astype(np.int32)
        return (lambda e, a: ops.mul_mat_id(e, a, _on(ids, a)), (experts, x))

    # the MoE case at a Mixtral-proportioned shape (FF/D = 3.5, 8 experts,
    # top-2) with int8-layout experts; flops counts the routed work (T·U
    # token-expert pairs)
    @case("mul_mat_id_moe_int8", nmse_max=2e-5,
          grad_reason="packed-integer quantized expert weights",
          flops=lambda: 2 * 16 * 2 * 1792 * 512)
    def _():
        r = _rng("mmid8")
        E, N, K, T, U = 8, 1792, 512, 16, 2
        experts = [to_int8_layout(QuantTensor.quantize(
            GGMLType.Q8_0, _np32(r, N, K, scale=0.02), device="cpu")) for _ in range(E)]
        x = _f32(r, T, U, K, scale=0.1)
        ids = r.integers(0, E, (T, U)).astype(np.int32)
        return (lambda *e: ops.mul_mat_id(list(e[:-1]), e[-1], _on(ids, e[-1])),
                (*experts, x))

    @case("get_set_rows", grad=True)
    def _():
        r = _rng("gsr")
        x = _f32(r, 10, 6)
        rows = _f32(r, 3, 6)
        ids = np.asarray([7, 2, 5], np.int64)

        def f(a, rws):
            i = _on(ids, a)
            return ops.set_rows(a, rws, i) + ops.get_rows(a, i).sum()
        return f, (x, rows)

    @case("argsort_topk", grad_reason="integer ranking outputs (argsort/top-k indices)")
    def _():
        x = _f32(_rng("as"), 4, 37)

        def f(a):
            vals, idx = ops.top_k(a, 5)
            return vals + ops.argsort(a)[..., :5].to(torch.float32)
        return f, (x,)

    @case("cross_entropy", grad=True)
    def _():
        r = _rng("ce")
        logits = _f32(r, 6, 33)
        labels = np.zeros((6, 33), np.float32)
        labels[np.arange(6), r.integers(0, 33, 6)] = 1.0
        return (lambda lg: ops.cross_entropy_loss(lg, _on(labels, lg)), (logits,))

    @case("timestep_embedding", grad=True)
    def _():
        # t capped at 99 for the FD gate (the op's f32 trig at t=999 puts
        # argument-reduction noise through the FD quotient)
        ts = torch.tensor([0.0, 1.0, 17.5, 99.0], dtype=torch.float32)
        return lambda t: ops.timestep_embedding(t, 32), (ts,)

    @case("pad_roll_concat", grad=True)
    def _():
        x = _f32(_rng("prc"), 4, 6)

        def f(a):
            p = ops.pad(a, ((1, 1), (0, 2)))
            return ops.concat(ops.roll(p, (1, -2), (0, 1)), p, axis=-1)
        return f, (x,)

    @case("win_part_rel_pos", grad=True)
    def _():
        r = _rng("sam")
        x = _f32(r, 1, 14, 14, 8)
        rel = _f32(r, 27, 4)

        def f(a, rp):
            w = ops.win_part(a, 7)
            g = ops.get_rel_pos(rp, 7, 7)
            return ops.win_unpart(w, 14, 14, 7) + g.sum()
        return f, (x, rel)

    # quantized matmuls: every kernel type at M=1 (the mmvq role) and M=64
    # (the mmq role; ≥ int8_min_m takes the int8 kernels of the types that
    # have them), plus the int8 execution layout
    for qt in sorted(KERNEL_TYPES, key=lambda t: t.name):
        for m in (1, 64):
            @case(f"qmm_{qt.name}_m{m}", nmse_max=3e-4,
                  flops=(lambda m=m: 2 * m * 64 * 512),
                  grad_reason="packed-integer quantized weight operand "
                              "(quantization is non-differentiable; ref "
                              "excludes quantized srcs the same way, "
                              "src/ggml.c:6400-6424)",
                  qmm=(qt, m))
            def build(qt=qt, m=m):
                r = _rng(f"q{qt.name}{m}")
                w = _np32(r, 64, 512, scale=0.05)
                x = _f32(r, m, 512)
                return qmatmul, (x, QuantTensor.quantize(qt, w, device="cpu"))

    @case("qmm_int8_layout", nmse_max=3e-4, grad_reason="packed-integer quantized weight operand")
    def _():
        r = _rng("q8l")
        w = _np32(r, 64, 512, scale=0.05)
        x = _f32(r, 4, 512)
        return qmatmul, (x, to_int8_layout(QuantTensor.quantize(GGMLType.Q4_K, w, device="cpu")))

    # the rest of test-backend-ops' cases (ref tests/test-backend-ops.cpp:935-1000)

    @case("acc", grad=True)
    def _():
        r = _rng("acc")
        x = _f32(r, 6, 5, 4)
        src = _f32(r, 2, 5, 4)
        return (lambda a, s: ops.acc(a, s, 17)), (x, src)

    @case("count_equal", nmse_max=0.0, grad_reason="integer comparison count")
    def _():
        r = _rng("ceq")
        a = torch.from_numpy(r.integers(0, 5, (7, 9)).astype(np.int32))
        b = torch.from_numpy(r.integers(0, 5, (7, 9)).astype(np.int32))
        return ops.count_equal, (a, b)

    @case("pad_reflect_1d", grad=True)
    def _():
        # edge shape: pad wider than half the row, odd row length
        return (lambda a: ops.pad_reflect_1d(a, 5, 7)), (_f32(_rng("pr1"), 3, 2, 13),)

    @case("roll_multi_axis", grad=True)
    def _():
        # negative and wrapping shifts on two axes at once
        return (lambda a: ops.roll(a, (-3, 11), (0, 2))), (_f32(_rng("roll2"), 4, 6, 8),)

    @case("argmax", nmse_max=0.0, grad_reason="integer index output")
    def _():
        return ops.argmax, (_f32(_rng("am"), 7, 33),)

    @case("sum_rows_mean", grad=True)
    def _():
        return (lambda a: ops.sum_rows(a) + ops.mean(a)), (_f32(_rng("srm"), 3, 5, 17),)

    @case("arange_tsembd", grad=True)
    def _():
        def f(t):
            return ops.timestep_embedding(t + _on(ops.arange(0.0, 6.0, 1.0), t), 32)
        return f, (_f32(_rng("ats"), 6),)

    @case("scale_clamp_softcap", grad=True)
    def _():
        def f(a):
            return ops.softcap(ops.clamp(ops.scale(a, 1.7, 0.3), -2.0, 2.0), 1.5)
        return f, (_f32(_rng("scs"), 5, 9),)

    @case("ssm_scan_state_carry", nmse_max=1e-6, grad=True)
    def _():
        # scan(x[:, :3]) then scan(x[:, 3:]) from the returned state == one
        # scan over the whole sequence
        def f(s, x, dt, A, B, C):
            y1, s1 = ops.ssm_scan(s, x[:, :3], dt[:, :3], A, B[:, :3], C[:, :3])
            y2, s2 = ops.ssm_scan(s1, x[:, 3:], dt[:, 3:], A, B[:, 3:], C[:, 3:])
            return torch.cat([y1, y2], dim=1), s2
        return f, _ssm_args(_rng("ssc"))

    @case("rope_mrope_vision", grad=True)
    def _():
        # vision mode: every n_dims pair rotated, per-sector position
        # streams (n_dims == head_dim // 2)
        x = _f32(_rng("mrv"), 6, 2, 32)
        pos = np.stack([np.arange(6)] * 4).astype(np.int32)

        def f(a):
            return ops.rope_multi(a, _on(pos, a), 16, sections=(2, 2, 0, 0),
                                  mode=ops.ROPE_TYPE_VISION)
        return f, (x,)

    @case("repeat_concat_axes", grad=True)
    def _():
        r = _rng("rc")
        a = _f32(r, 2, 1, 5)
        b = _f32(r, 2, 3, 5)
        return (lambda a, b: ops.concat(ops.repeat(a, (2, 3, 5)), b, axis=1)), (a, b)

    @case("upscale_bilinear_align", grad=True)
    def _():
        # interpolation with align-corners semantics (the other mode branch)
        x = _f32(_rng("ubl"), 1, 3, 5, 4)
        return (lambda a: ops.interpolate_bilinear(a, 6, 10, align_corners=True)), (x,)

    # dequantization of every codec the registry quantizes without an imatrix
    for qt in sorted(supported_quant_types(), key=lambda t: t.name):
        if not TYPE_TRAITS[qt].is_quantized:
            continue

        @case(f"dequant_{qt.name}", nmse_max=0.0,   # exact self-match
              grad_reason="wire-format input (packed integer blocks)")
        def build(qt=qt):
            w = _np32(_rng(f"dq{qt.name}"), 8, 512, scale=0.05)
            return dequant, (QuantTensor.quantize(qt, w, device="cpu"),)


# ------------------------------------------------------------------ modes

def to_device(args, device):
    """A case's arguments (tensors, QuantTensors, sequences of them) on
    `device`; a QuantTensor keeps its layout."""
    from ..ops.quantized import QuantTensor

    if isinstance(args, torch.Tensor):
        return args.to(device)
    if isinstance(args, QuantTensor):
        return QuantTensor(args.qtype, args.shape,
                           {k: v.to(device) for k, v in args.fields.items()}, args.layout)
    if isinstance(args, (list, tuple)):
        return type(args)(to_device(a, device) for a in args)
    return args


def leaves(out) -> list:
    """The tensors of an op's output (a tensor or nested tuples of them)."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in leaves(o)]


def nmse(a, b) -> float:
    a = torch.as_tensor(a).detach().cpu().double().reshape(-1)
    b = torch.as_tensor(b).detach().cpu().double().reshape(-1)
    denom = float((a ** 2).mean()) if a.numel() else 0.0
    return float(((a - b) ** 2).mean()) / (denom or 1.0) if a.numel() else 0.0


def _launches() -> dict:
    from ..ops import cuda as kernels

    return {k.name: k.launches for k in kernels.KERNELS}


def expected_kernel(c: Case, cuda: bool):
    """The kernel record a qmm case's product takes (ops/cuda/dispatch.py::
    route and KERNEL_OF), or None for another case."""
    from ..ops.cuda import dispatch

    if c.qmm is None:
        return None
    qt, m = c.qmm
    return dispatch.KERNEL_OF[(qt, dispatch.route(m, qt, (64, 512), cuda))]


def mode_test(cases, device, verbose=False, out=None) -> int:
    """Every case on `device` against the CPU, within its nmse_max; on the
    card a qmm case must also have launched its route's kernel."""
    cuda = device.type == "cuda"
    fails = 0
    for c in cases:
        rec = {"name": c.name, "nmse_max": c.nmse_max}
        try:
            fn, args = c.build()
            with torch.no_grad():
                ref = leaves(fn(*args))
                if cuda:
                    before = _launches()
                    got = leaves(fn(*to_device(args, device)))
                    torch.cuda.synchronize(device)
                    after = _launches()
                    rec["launches"] = {k: after[k] - before[k] for k in after
                                       if after[k] != before[k]}
                else:
                    got = ref
            err = max((nmse(g, r) for r, g in zip(ref, got)), default=0.0)
            ok = len(ref) == len(got) and err <= c.nmse_max
            kern = expected_kernel(c, cuda) if cuda else None
            if kern is not None:
                rec["kernel"] = kern.name
                if not rec["launches"].get(kern.name):
                    ok, err = False, f"{err} but no launch of {kern.name}"
        except Exception as e:  # noqa: BLE001 - report, keep sweeping
            err, ok = repr(e)[:120], False
        rec.update(nmse=err, ok=ok)
        if out is not None:
            out.append(rec)
        fails += not ok
        if verbose or not ok:
            extra = f" launches {rec['launches']}" if rec.get("launches") else ""
            print(f"  {'OK ' if ok else 'FAIL'} {c.name:28s} nmse={err}"
                  f" (max {c.nmse_max}){extra}")
    print(f"test: {len(cases) - fails}/{len(cases)} ok on {device.type} vs cpu")
    return fails


def _grad_check(c: Case, device) -> float:
    """The worst relative error of two directional derivatives of
    sum(fn(*args)) in f64: autograd's against central differences."""
    fn, args = c.build()
    rng = _rng("dir" + c.name)
    a64 = [a.to(device=device, dtype=torch.float64).requires_grad_() for a in args]

    def loss(*a):
        # every output leaf: the recurrent ops return (y, state) tuples and
        # both carry gradients
        return sum(le.double().sum() for le in leaves(fn(*a)))

    grads = torch.autograd.grad(loss(*a64), a64, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g for a, g in zip(a64, grads)]
    eps, worst = 5e-3, 0.0
    with torch.no_grad():
        for _ in range(2):
            vs = [torch.from_numpy(rng.standard_normal(tuple(a.shape))).to(device)
                  for a in a64]
            lin = sum(float((g * v).sum()) for g, v in zip(grads, vs))
            fp = float(loss(*[a + eps * v for a, v in zip(a64, vs)]))
            fm = float(loss(*[a - eps * v for a, v in zip(a64, vs)]))
            num = (fp - fm) / (2 * eps)
            worst = max(worst, abs(lin - num) / max(1.0, abs(num), abs(lin)))
    return worst


def mode_grad(cases, device, verbose=False, out=None) -> int:
    """Directional-derivative check (f64): autograd's grad(sum f)·v against
    central differences, two random directions, relative error < 5e-3. A
    case with `grad_cpu` runs its f64 leg on the CPU, and says why."""
    fails = 0
    gcases = [c for c in cases if c.grad]
    cpu = torch.device("cpu")
    for c in gcases:
        dev = cpu if c.grad_cpu else device
        try:
            worst = _grad_check(c, dev)
            ok = worst < 5e-3
        except Exception as e:  # noqa: BLE001
            ok, worst = False, repr(e)[:120]
        fails += not ok
        if out is not None:
            out.append({"name": c.name, "relerr": worst, "ok": ok, "device": dev.type})
        if verbose or not ok or dev != device:
            where = f" (f64 leg on the CPU: {c.grad_cpu})" if dev != device else ""
            print(f"  {'OK ' if ok else 'FAIL'} grad {c.name:24s} relerr={worst}{where}")
    print(f"grad: {len(gcases) - fails}/{len(gcases)} ok on {device.type}")
    return fails


SPIN_CYCLES_PER_MS = 2_000_000      # clock64 cycles of a spin kernel per ms, at most


def mode_perf(cases, device, verbose=False, out=None, iters: int = 10) -> int:
    """Each case's time on the card: `iters` calls between two CUDA events
    behind a spin kernel that keeps the device busy while the host enqueues
    them (so the interval holds the device's work, not the host's
    dispatch; the spin lasts 1.5x the second warm call's wall time per
    call), the better of two rounds, per call; beside it the host's
    dispatch time per call (where it exceeds the device's, the op is
    host-bound at this size). Flops-annotated cases also print GFLOP/s."""
    if device.type != "cuda":
        print("perf: timing needs the card (CUDA events); not measured on the CPU")
        return 1
    fails = 0
    for c in cases:
        try:
            fn, args = c.build()
            args = to_device(args, device)
            with torch.no_grad():
                fn(*args)                       # builds, caches, first-call work
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize(device)
                spin = int(SPIN_CYCLES_PER_MS * 1.5 * iters * (time.perf_counter() - t0) * 1e3)
                best, host = float("inf"), float("inf")
                for _ in range(2):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(spin)
                    a.record()
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn(*args)
                    host = min(host, (time.perf_counter() - t0) * 1e3 / iters)
                    b.record()
                    b.synchronize()
                    best = min(best, a.elapsed_time(b) / iters)
            extra = f"  {c.flops() / best / 1e6:9.1f} GFLOP/s" if c.flops else ""
            print(f"  {c.name:28s} {best:9.4f} ms device {host:9.4f} ms host{extra}")
            if out is not None:
                out.append({"name": c.name, "ms": best, "host_ms": host})
        except Exception as e:  # noqa: BLE001
            fails += 1
            print(f"  {c.name:28s} FAILED {repr(e)[:80]}")
    return fails


SUPPORT_MS = (1, 8, 64, 512)


def dispatch_matrix(ms=SUPPORT_MS, cuda: bool = True) -> dict:
    """{type: [route at each M]} of a 4096 x 4096 weight in the kernel
    layout (ops/cuda/dispatch.py::route: "f32", "i8" or "pipe")."""
    from ..ops.cuda import dispatch

    return {qt: [dispatch.route(m, qt, (4096, 4096), cuda) for m in ms]
            for qt in sorted(dispatch.KERNEL_TYPES, key=lambda t: t.name)}


def _kernel_label(kernel) -> str:
    from ..ops import cuda as kernels

    return next(n for n in dir(kernels) if getattr(kernels, n) is kernel).replace("_", "-", 1)


def mode_support(cases=None) -> int:
    """The supports_op matrix: execution paths per quant type, the dispatch
    matrix naming the kernel of each (type, M), and the grad-eligibility
    table with a reason for every ineligible case."""
    from ..ops.cuda import dispatch
    from ..ops.quantized import _FIELDS
    from ..quant.registry import supported_quant_types
    from ..quant.types import TYPE_TRAITS
    from ..utils import config

    print(f"{'type':8s} {'bpw':>6s} {'codec':>5s} {'wire-dq':>7s} "
          f"{'kernel':>6s} {'int8-k':>6s} {'int8-layout':>11s}")
    for qt in sorted(supported_quant_types(), key=lambda t: t.name):
        tt = TYPE_TRAITS[qt]
        if not tt.is_quantized:
            continue
        bpw = 8.0 * tt.type_size / tt.blck_size
        print(f"{qt.name:8s} {bpw:6.2f} {'yes':>5s} "
              f"{'yes' if qt in _FIELDS else '-':>7s} "
              f"{'yes' if qt in dispatch.KERNEL_TYPES else '-':>6s} "
              f"{'yes' if qt in dispatch.INT8_TYPES else '-':>6s} {'yes':>11s}")
    print(f"\nattn_impl={config.get('attn_impl')} "
          f"weights_layout={config.get('weights_layout')} "
          f"int8_min_m={config.get('int8_min_m')} "
          f"qmm_pipeline={config.get('qmm_pipeline')}")
    print("\ndispatch at M (kernel layout, operands on the card):  "
          + "".join(f"{('M=' + str(m)):>12s}" for m in SUPPORT_MS))
    for qt, routes in dispatch_matrix().items():
        row = [f"{_kernel_label(dispatch.KERNEL_OF[(qt, r)])} {r}" for r in routes]
        print(f"{qt.name:30s} " + "".join(f"{x:>12s}" for x in row))
    print("int8 execution layout: plain torch per-tile int8 dots at every M;"
          "\nwire layout: dequant, then one f32 torch.matmul")
    if cases:
        elig = [c for c in cases if c.grad]
        inel = [c for c in cases if not c.grad]
        print(f"\ngrad eligibility: {len(elig)}/{len(cases)} cases; ineligible with reasons:")
        for c in inel:
            print(f"  {c.name:28s} {c.grad_reason or 'UNANNOTATED'}")
        missing = [c.name for c in inel if not c.grad_reason]
        if missing:
            print(f"  WARNING: {len(missing)} unannotated exclusions")
        for c in elig:
            if c.grad_cpu:
                print(f"  {c.name:28s} f64 leg on the CPU: {c.grad_cpu}")
    return 0


def main(argv=None, out: dict | None = None) -> int:
    """The CLI. `out`, when given, receives each mode's per-case records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modes", nargs="+", choices=["test", "grad", "perf", "support"])
    ap.add_argument("--op", action="append", help="substring filter on case names")
    ap.add_argument("--device", default=None,
                    help="the device under test (default: the card; 'cpu' runs both legs "
                         "on the plain path)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from ..utils.device import resolve

    device = resolve(args.device)
    _register_cases()
    cases = CASES
    if args.op:
        cases = [c for c in cases if any(s in c.name for s in args.op)]
        if not cases:
            print(f"no cases match {args.op}", file=sys.stderr)
            return 2
    fails = 0
    for m in args.modes:
        rec = None if out is None else out.setdefault(m, [])
        if m == "test":
            fails += mode_test(cases, device, args.verbose, rec)
        elif m == "grad":
            fails += mode_grad(cases, device, args.verbose, rec)
        elif m == "perf":
            fails += mode_perf(cases, device, args.verbose, rec)
        else:
            fails += mode_support(cases)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
