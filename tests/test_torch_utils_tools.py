"""The port's utilities against the JAX package's: the logger (levels,
callback, env key), config.describe and the log_level knob, the taps of
models/llama.py (utils/observe.py; names and values against the
reference's observer on the same tiny llama), utils/trace.py (the section
timer, the fx graph dump, the stages), utils/perf.py (raises off the card,
the reference's op table) and the simple example on the CPU."""
import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.utils import observe as jobserve
from ggml_gfx906_tpu.utils import perf as jperf
from ggml_gfx906_tpu_torch import ops
from ggml_gfx906_tpu_torch.examples import simple
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.runtime.graphs import StepGraph
from ggml_gfx906_tpu_torch.utils import config, log, observe, perf, trace

from _torch_port import nmse, tiny_models

TAP_BOUND = 1e-9      # tests/test_torch_llama.py's bound on the f32 route


# ------------------------------------------------------------------ log

def test_levels_and_callback():
    seen = []
    log.log_set(lambda level, msg: seen.append((level, msg)))
    try:
        log.set_level(log.LogLevel.WARN)
        log.debug("d")
        log.info("i")
        log.warn("w")
        log.error("e")
        assert seen == [(log.LogLevel.WARN, "w"), (log.LogLevel.ERROR, "e")]
        log.set_level(log.LogLevel.DEBUG)
        log.debug("d2")
        assert seen[-1] == (log.LogLevel.DEBUG, "d2")
    finally:
        log.log_set(None)
        log.set_level(log._initial_level())


def test_default_writes_stderr(capsys):
    log.info("to stderr")
    err = capsys.readouterr().err
    assert "INFO  to stderr" in err


@pytest.mark.parametrize("raw, level", [("debug", "DEBUG"), ("ERROR", "ERROR"), (None, "INFO"),
                                        ("warn", "WARN"), ("nonsense", "INFO")])
def test_level_from_the_env_at_import(monkeypatch, raw, level):
    key = config._env_key("log_level")
    assert key == "GGML_TORCH_LOG_LEVEL"
    if raw is None:
        monkeypatch.delenv(key, raising=False)
    else:
        monkeypatch.setenv(key, raw)
    try:
        assert importlib.reload(log)._min_level == log.LogLevel[level]
    finally:
        monkeypatch.undo()
        importlib.reload(log)


# --------------------------------------------------------------- config

def test_describe_sources_and_log_level(monkeypatch):
    monkeypatch.delenv("GGML_TORCH_LOG_LEVEL", raising=False)
    monkeypatch.delenv("GGML_TORCH_INT8_MIN_M", raising=False)
    rows = {name: (value, src, help_) for name, value, src, help_ in config.describe()}
    assert sorted(rows) == sorted(config._REGISTRY)
    assert rows["log_level"][:2] == ("info", "default") and "debug" in rows["log_level"][2]
    monkeypatch.setenv("GGML_TORCH_INT8_MIN_M", "128")
    config.set("log_level", "warn")
    try:
        rows = {name: (value, src) for name, value, src, _ in config.describe()}
        assert rows["int8_min_m"] == (128, "env:GGML_TORCH_INT8_MIN_M")
        assert rows["log_level"] == ("warn", "override")
        with pytest.raises(ValueError, match="log_level"):
            config.set("log_level", "loud")
        monkeypatch.setenv("GGML_TORCH_LOG_LEVEL", "DEBUG")
        config.unset("log_level")
        assert config.get("log_level") == "debug"
    finally:
        config.unset("log_level")


# -------------------------------------------------------------- observe

@pytest.fixture(scope="module")
def models():
    return tiny_models(GGMLType.Q4_K, seed=0)


def _port_taps(tcfg, tp, toks):
    taps = []
    with observe.observer(lambda name, v: taps.append((name, v))):
        logits, _ = tllama.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                                   tllama.make_cache(tcfg, 64, device="cpu"), 0)
    return taps, logits


def test_taps_equal_the_reference(models):
    jcfg, jp, tcfg, tp = models
    toks = np.random.default_rng(7).integers(0, 256, 7).astype(np.int32)
    want = []
    with jobserve.observer(lambda name, v: want.append((name, np.asarray(v)))):
        jlogits, _ = jllama.forward(jcfg, jp, jnp.asarray(toks), jllama.make_cache(jcfg, 64),
                                    jnp.int32(0))
    got, logits = _port_taps(tcfg, tp, toks)
    names = [f"blk.{i}.{s}" for i in range(tcfg.n_layer) for s in ("attn_out", "ffn_out")]
    assert [n for n, _ in got] == [n for n, _ in want] == names + ["logits"]
    for (name, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        assert nmse(g, w) < TAP_BOUND, name
    np.testing.assert_array_equal(got[-1][1], logits.numpy())    # the logits tap, bit for bit
    assert nmse(logits.numpy(), np.asarray(jlogits)) < TAP_BOUND


def test_no_observer_no_work(models, monkeypatch):
    _, _, tcfg, tp = models

    def boom(*a):
        raise AssertionError("a tap did work without an observer")

    monkeypatch.setattr(observe, "_capturing", boom)
    t = torch.ones(3)
    assert observe.tap("x", t) is t
    logits, _ = tllama.forward(tcfg, tp, torch.tensor([1, 2, 3]),
                               tllama.make_cache(tcfg, 64, device="cpu"), 0)
    assert logits.shape == (3, tcfg.n_vocab)
    seen = []
    with observe.observer(lambda n, v: seen.append(n)):
        with observe.observer(lambda n, v: None):     # the inner one replaces it, then ends
            pass
        monkeypatch.setattr(observe, "_capturing", lambda: False)
        observe.tap("y", t)
    observe.tap("z", t)
    assert seen == ["y"]


def test_tap_under_a_capture_raises(models, monkeypatch):
    """A stand-in for torch.cuda's streams and graphs (as in
    tests/test_torch_graphs.py) runs StepGraph's capture of one decode
    forward here: with an observer installed the warm-up taps, the capture
    raises; without one the capture goes through."""
    _, _, tcfg, tp = models
    capturing = [False]

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None):
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    kv = tllama.make_cache(tcfg, 64, device="cpu")
    tok = torch.tensor([5])

    def step():
        return tllama._forward(tcfg, tp, tok, kv, 0)

    seen = []
    with observe.observer(lambda n, v: seen.append(n)):
        with pytest.raises(RuntimeError, match="CUDA graph capture"):
            StepGraph(step, torch.device("cuda"))
    assert seen == [f"blk.{i}.{s}" for i in range(tcfg.n_layer)
                    for s in ("attn_out", "ffn_out")] + ["logits"]     # the warm-up's
    assert not capturing[0]
    g = StepGraph(step, torch.device("cuda"))
    assert g.graph is not None and len(g.outputs) == 1


# ---------------------------------------------------------------- trace

def test_section_timer_report():
    t = trace.SectionTimer()
    for name in ("a", "b", "a"):
        with t.section(name, sync=True):
            sum(range(1000))
    rep = t.report().splitlines()
    assert rep[0].split() == ["section", "total_ms", "calls", "avg_ms"]
    assert {r.split()[0]: int(r.split()[2]) for r in rep[1:]} == {"a": 2, "b": 1}


def test_dump_graph_fx_names_the_ops(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
    path = tmp_path / "g.txt"
    text = trace.dump_graph(lambda a: ops.silu(ops.rms_norm(a, 1e-6)) @ a.T, x, path=str(path))
    for op in ("aten.sigmoid", "aten.rsqrt", "aten.mm"):     # silu is x · sigmoid(x)
        assert op in text, op
    assert path.read_text() == text
    for stage in ("jaxpr", "hlo", "optimized"):
        with pytest.raises(ValueError, match="fx"):
            trace.dump_graph(torch.neg, x, stage=stage)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            trace.dump_graph(torch.neg, x, stage="kernels")


def test_profile_writes_a_trace(tmp_path):
    with trace.profile(tmp_path) as path:
        with trace.named_scope("my_scope"):
            torch.ones(8) + 1
    assert path.parent == tmp_path and path.exists() and "my_scope" in path.read_text()


# ----------------------------------------------------------------- perf

def test_perf_raises_off_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the benchmarks would run")
    assert list(perf.ALL) == list(jperf.ALL)
    for call in (lambda: perf.bench_qmm("Q4_K", 1, 256, 256), lambda: perf.bench_dequant(
            "Q8_0", 256, 256), lambda: perf.bench_attention(1, 2, 16, 16, 8),
            lambda: perf.bench_softmax(8, 8), lambda: perf.main([]),
            lambda: perf.measure_hbm_bw()):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
    assert (perf.HBM_BPS_SPEC, perf.F32_FLOPS) == (chip_smoke.HBM_BPS, chip_smoke.PEAK["f32"])
    assert not hasattr(perf, "HBM_GBS_SPEC") and not hasattr(perf, "BF16_TFLOPS")


def test_random_qt_is_the_kernel_layout():
    from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor, qmatmul
    from ggml_gfx906_tpu_torch.quant.types import GGMLType as TGGMLType

    rng = np.random.default_rng(0)
    x = torch.ones(1, 512)
    for name in ("Q4_K", "Q8_0", "Q4_0"):
        qt = perf._random_qt(rng, TGGMLType[name], 64, 512, "cpu")
        ref = QuantTensor.quantize(TGGMLType[name], np.ones((64, 512), np.float32), "cpu")
        assert qt.layout == "kernel" and {k: (v.shape, v.dtype) for k, v in qt.fields.items()} \
            == {k: (v.shape, v.dtype) for k, v in ref.fields.items()}, name
        assert qmatmul(x, qt).shape == (1, 64)


# -------------------------------------------------------------- example

def test_simple_example_on_the_cpu(capsys):
    assert simple.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "style ctx" in out and "only the ctx style runs" in out
