"""Port parity: the op-conformance harness (tools/backend_ops.py) against
the JAX package's.

The case table (names, nmse_max, grad flags and reasons) is the
reference's. Every case's function, given the reference's own built
arguments (numpy arrays, its QuantTensors converted to the port's), equals
the reference's jitted function on the CPU (Pallas in qmm.force_interpret)
within the case's nmse_max. The reference seeds its inputs with
abs(hash(name)), which changes per process, so here both tables are built
under the port's crc32 seeds: their closed-over constants (routing ids,
labels) then agree too. The modes run on the CPU (`--device cpu`), and the
support mode's dispatch matrix equals the reference's."""
import jax
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.ops.pallas import dispatch as jdispatch
from ggml_gfx906_tpu.ops.pallas import qmm as jqmm
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.tools import backend_ops as jbo
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.quant.types import TYPE_TRAITS
from ggml_gfx906_tpu_torch.tools import backend_ops as bo
from ggml_gfx906_tpu_torch.utils import config

import _torch_port  # noqa: F401  (one torch thread per file)
from _torch_port import nmse

bo._register_cases()
jbo._register_cases()
PORT = {c.name: c for c in bo.CASES}
REF = {c.name: c for c in jbo.CASES}


def test_case_table_equals_the_reference():
    assert [c.name for c in bo.CASES] == [c.name for c in jbo.CASES]
    assert len(bo.CASES) == 112 and sum(c.grad for c in bo.CASES) == 59
    for p, r in zip(bo.CASES, jbo.CASES):
        assert (p.nmse_max, p.grad, p.grad_reason) == (r.nmse_max, r.grad, r.grad_reason), p.name
        assert (p.flops is None) == (r.flops is None), p.name
        if p.flops is not None:
            assert p.flops() == r.flops(), p.name
    assert [c.name for c in bo.CASES if c.grad_cpu] == ["causal_flash_attn"]
    qmm = [c for c in bo.CASES if c.qmm is not None]
    assert [f"qmm_{qt.name}_m{m}" for qt, m in (c.qmm for c in qmm)] == [c.name for c in qmm]


def _port_arg(a):
    """A reference case argument as the port's: arrays as tensors, its
    QuantTensors (kernel, wire or int8 layout) as the port's."""
    if isinstance(a, JQuantTensor):
        fields = {k: np.asarray(v) for k, v in a.fields.items()}
        if a.layout == "kernel":
            return QuantTensor.from_reference_kernel_layout(a.qtype, a.shape, fields, "cpu")
        if a.layout == "int8":
            return QuantTensor(a.qtype, tuple(a.shape),
                               {k: torch.from_numpy(v.copy()) for k, v in fields.items()},
                               "int8")
        blocks = np.zeros(next(iter(fields.values())).shape[:2],
                          TYPE_TRAITS[a.qtype].block_dtype)
        for k, v in fields.items():
            blocks[k] = v
        return QuantTensor.from_blocks(a.qtype, blocks, "cpu")
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("name", list(PORT))
def test_case_matches_the_reference(name, monkeypatch):
    monkeypatch.setattr(jbo, "_rng", bo._rng)
    rfn, rargs = REF[name].build()
    with jqmm.force_interpret():
        want = jax.tree.leaves(jax.jit(rfn)(*rargs))
    fn, _ = PORT[name].build()
    with torch.no_grad():
        got = bo.leaves(fn(*[_port_arg(a) for a in rargs]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        e = nmse(g.numpy(), np.asarray(w))
        assert e <= PORT[name].nmse_max, (name, e)


def test_port_inputs_equal_the_reference_under_one_seed(monkeypatch):
    """Under the port's seeds the two tables build the same dense inputs."""
    monkeypatch.setattr(jbo, "_rng", bo._rng)
    for name in ("rwkv_wkv6", "gated_linear_attn", "mul_mat_id", "ssm_scan_state_carry",
                 "cross_entropy", "count_equal"):
        _, rargs = REF[name].build()
        _, args = PORT[name].build()
        for a, r in zip(args, rargs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_modes_on_the_cpu(capsys):
    assert bo.main(["test", "--device", "cpu"]) == 0
    assert "test: 112/112 ok on cpu vs cpu" in capsys.readouterr().out
    out = {}
    assert bo.main(["grad", "--device", "cpu", "--op", "rms_norm", "--op", "soft_max",
                    "--op", "matmul_f32", "--op", "conv_2d", "--op", "causal_flash_attn",
                    "--op", "rwkv"], out) == 0
    assert {r["name"] for r in out["grad"]} >= {"rms_norm", "causal_flash_attn", "rwkv_wkv7"}
    assert all(r["ok"] and r["relerr"] < 5e-3 for r in out["grad"])
    assert bo.main(["test", "--device", "cpu", "--op", "no_such_op_xyz"]) == 2
    assert bo.main(["perf", "--device", "cpu", "--op", "norm"]) == 1


def test_the_modes_want_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the harness would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bo.main(["test", "--op", "norm"])


def _ref_route(qt, m):
    """The reference's support-mode decision (its mode_support)."""
    probe = JQuantTensor(qt, (4096, 4096), {}, "kernel")
    if qt in jdispatch.PIPELINE_TYPES and jdispatch._use_pipeline(m, probe):
        return "pipe"
    min_m = int(jconfig.get("int8_min_m"))
    return "i8" if qt in jdispatch.INT8_TYPES and min_m > 0 and m >= min_m else "f32"


@pytest.mark.parametrize("knobs", [{}, {"qmm_pipeline": "on"}, {"qmm_pipeline": "auto"},
                                   {"int8_min_m": 8}, {"int8_min_m": 0}])
def test_support_dispatch_matrix_equals_the_reference(knobs, capsys):
    try:
        for k, v in knobs.items():
            config.set(k, v)
            jconfig.set(k, v)
        # "auto" is "on" for operands on the card here, on the TPU there;
        # the reference process runs on the CPU, so compare the CPU's matrix
        got = bo.dispatch_matrix(cuda=knobs.get("qmm_pipeline") != "auto")
        assert sorted(qt.name for qt in got) == sorted(qt.name for qt in jdispatch.KERNEL_TYPES)
        for qt, routes in got.items():
            assert routes == [_ref_route(qt, m) for m in bo.SUPPORT_MS], qt.name
        assert bo.mode_support(bo.CASES) == 0
        text = capsys.readouterr().out
        assert "grad eligibility: 59/112" in text and "UNANNOTATED" not in text
    finally:
        for k in knobs:
            config.unset(k)
            jconfig.unset(k)
