"""Port parity: the pipelined Q4_K decode matvec K10 (`qmm_q4_K_pipelined`)
behind `qmm_pipeline`, against the JAX package's interpret-mode Pallas
kernel on the CPU, against K1, and through a tiny model's decode step. On
the CPU the port runs K10's plain PyTorch version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.ops.pallas import qmm as jqmm
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.ops.cuda import dispatch as tdispatch
from ggml_gfx906_tpu_torch.ops.cuda import qmm as tqmm
from ggml_gfx906_tpu_torch.ops.cuda import qmm_pipe
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import nmse, tiny_models

Q4K = GGMLType.Q4_K


def _weights(n, k, seed):
    """tests/test_qmm_int8.py:139-142's weights and x."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    jq = jqz.QuantTensor.quantize(Q4K, w)
    tq = tqz.QuantTensor.from_reference_kernel_layout(
        Q4K, jq.shape, {f: np.asarray(a) for f, a in jq.fields.items()}, "cpu")
    x = rng.standard_normal((1, k)).astype(np.float32)
    return jq, tq, x


def _k10(tq, x):
    g = tq.fields
    return qmm_pipe.qmm_q4_K_pipelined(torch.from_numpy(x), g["qs"], g["scm"], g["dd"]).numpy()


@pytest.fixture
def pipeline_on():
    tconfig.set("qmm_pipeline", "on")
    jconfig.set("qmm_pipeline", "on")
    yield
    tconfig.unset("qmm_pipeline")
    jconfig.unset("qmm_pipeline")


# (512, 2048): the reference streams scm in chunks beside qs; (256, 2816):
# 11 superblocks, scm resident (qmm.py:379). Measured nmse ~6e-14 / ~1.4e-13:
# the same function, summed in another order.
@pytest.mark.parametrize("n,k", [(512, 2048), (256, 2816)])
def test_k10_matches_reference_pipelined(n, k):
    jq, tq, x = _weights(n, k, seed=5)
    f = jq.fields
    ref = np.asarray(jax.jit(jqmm.qmm_q4_K_pipelined)(jnp.asarray(x), f["qs"], f["scm"], f["dd"]))
    got = _k10(tq, x)
    assert got.shape == (1, n)
    assert nmse(got, ref) < 1e-10


@pytest.mark.parametrize("n,k", [(512, 2048), (384, 1024), (256, 2816)])
def test_k10_against_k1(n, k):
    """K10 rounds x to bf16, K1 does not: they differ within the reference's
    bound (tests/test_qmm_int8.py:148, nmse < 5e-5); with x already
    bf16-valued, only in summation order."""
    _, tq, x = _weights(n, k, seed=6)
    g = tq.fields
    k1 = lambda a: tqmm.qmm_q4_K(torch.from_numpy(a), g["qs"], g["scm"], g["dd"]).numpy()  # noqa: E731
    assert nmse(_k10(tq, x), k1(x)) < 5e-5
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert nmse(_k10(tq, xb), k1(xb)) < 1e-10


def test_k10_rejects_more_than_one_row():
    _, tq, _ = _weights(256, 256, seed=7)
    g = tq.fields
    with pytest.raises(ValueError):
        qmm_pipe.qmm_q4_K_pipelined(torch.zeros((2, 256)), g["qs"], g["scm"], g["dd"])


def test_route_follows_qmm_pipeline():
    """ops/pallas/dispatch.py:28-53: "on" takes K10 for M = 1 Q4_K products
    with N % 128 == 0, N >= 256 (before the int8 test); "auto" only for
    operands on the card; "off", M > 1, other types and other shapes keep
    their routes."""
    assert tconfig.get("qmm_pipeline") == "off"
    assert tdispatch.route(1, Q4K, (512, 256), cuda=True) == "f32"
    for mode, cuda, want in (("on", False, "pipe"), ("on", True, "pipe"),
                             ("auto", False, "f32"), ("auto", True, "pipe")):
        tconfig.set("qmm_pipeline", mode)
        try:
            assert tdispatch.route(1, Q4K, (512, 256), cuda) == want, (mode, cuda)
            assert tdispatch.route(2, Q4K, (512, 256), cuda) == "f32"
            assert tdispatch.route(1, Q4K, (128, 256), cuda) == "f32"      # N < 256
            assert tdispatch.route(1, Q4K, (320, 256), cuda) == "f32"      # N % 128
            assert tdispatch.route(1, GGMLType.Q6_K, (512, 256), cuda) == "f32"
            assert tdispatch.route(64, Q4K, (512, 256), cuda) == "i8"
            assert tdispatch.route(1, Q4K) == "f32"                      # no shape
        finally:
            tconfig.unset("qmm_pipeline")


def test_qmatmul_takes_k10_when_on(pipeline_on):
    """qmatmul of a single row under "on" is K10's function (it differs from
    K1's), and of two rows K1's."""
    _, tq, x = _weights(512, 1024, seed=8)
    got = tqz.qmatmul(torch.from_numpy(x), tq).numpy()
    assert np.array_equal(got, _k10(tq, x))
    x2 = np.concatenate([x, x])
    g = tq.fields
    k1 = tqmm.qmm_q4_K(torch.from_numpy(x2), g["qs"], g["scm"], g["dd"]).numpy()
    assert np.array_equal(tqz.qmatmul(torch.from_numpy(x2), tq).numpy(), k1)


def test_tiny_model_decode_logits_match_reference(pipeline_on, monkeypatch):
    """A tiny Q4_K model's decode step with qmm_pipeline="on" in both
    packages: its 256-wide wq/wo, the ffn and the tied head take K10 (wk
    and wv, 128 rows, stay on K1). The first K10 call sees the same x in
    both (the embedding row, normed) and agrees as the kernels do (< 1e-10;
    ~1e-13 measured). The logits do not: K10 rounds x to bf16, so a
    last-bit difference upstream flips some roundings, and each matmul
    multiplies the gap (measured nmse 5.8e-6 at the logits, 2.5e-5 between
    the flag on and off). They are held to the int8 route's error class
    (2e-4), whose per-tile int8 activations round more coarsely than bf16."""
    jcfg, jp, tcfg, tp = tiny_models(Q4K, seed=2)
    prompt = np.random.default_rng(3).integers(0, 256, 12).astype(np.int32)
    calls = {"jax": [], "torch": []}

    def spy(side, fn):
        def wrapped(x, *a, **k):
            y = fn(x, *a, **k)
            calls[side].append((np.array(x), np.array(y)))
            return y
        return wrapped

    monkeypatch.setattr(jqmm, "qmm_q4_K_pipelined", spy("jax", jqmm.qmm_q4_K_pipelined))
    monkeypatch.setitem(tdispatch._KERNELS, (Q4K, "pipe"),
                        spy("torch", tdispatch._KERNELS[(Q4K, "pipe")]))
    kv = jllama.make_cache(jcfg, 64)
    _, kv = jllama.forward_jit(jcfg, jp, jnp.asarray(prompt), kv, jnp.int32(0))
    ref, _ = jllama.forward(jcfg, jp, jnp.asarray([7], jnp.int32), kv, jnp.int32(12))
    tkv = tllama.make_cache(tcfg, 64, device="cpu")
    _, tkv = tllama.forward(tcfg, tp, torch.from_numpy(prompt.astype(np.int64)), tkv, 0)
    launches = qmm_pipe.K10.launches
    got, _ = tllama.forward(tcfg, tp, torch.tensor([7]), tkv, 12)
    assert qmm_pipe.K10.launches == launches       # the CPU runs the plain version
    assert len(calls["jax"]) == len(calls["torch"]) == 2 * 5 + 1
    (jx, jy), (tx, ty) = calls["jax"][0], calls["torch"][0]
    assert nmse(tx, jx) < 1e-12 and nmse(ty, jy) < 1e-10
    assert nmse(got.numpy(), np.asarray(ref)) < 2e-4
    tconfig.set("qmm_pipeline", "off")
    off, _ = tllama.forward(tcfg, tp, torch.tensor([7]), tkv, 12)
    assert 0 < nmse(got.numpy(), off.numpy()) < 2e-4
