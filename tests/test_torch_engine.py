"""Port parity: the continuous-batching Engine.

The port's Engine (flood and chunked admission, batched decode steps in
pipelined windows of the default harvest depth, 8, on captured graphs —
direct calls on the CPU) must give token streams equal to the port's own
single-sequence generate where both prefill on one matmul route, and to
the JAX Engine in its strict per-step formulation (engine_window_delta
False on both sides, pinned so that a default flip cannot change what is
compared). Other depths and the scan-window switch: test_torch_graphs.py;
floods and the paged pool: test_torch_admission.py; the int8 cache and
window delta: test_torch_kv_variants.py."""
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops.cuda import dispatch
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import one_torch_thread, tiny_models  # noqa: F401

MAX_SEQ = 128
CHUNK = 32


@pytest.fixture(scope="module")
def models():
    return tiny_models(GGMLType.Q4_K, seed=2)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, n)] for n in lengths]


def _run(eng, prompts, n_new):
    rids = [eng.submit(p, n_new) for p in prompts]
    done = {r.rid: r for r in eng.run()}
    assert set(done) == set(rids)
    return [done[r].out for r in rids]


def _serve_flooded(tcfg, tp, lengths, chunk, min_m):
    """(prompts, streams) of an engine that floods (asserted) at
    int8_min_m = min_m (None: the default)."""
    prompts = _prompts(lengths)
    if min_m is not None:
        tconfig.set("int8_min_m", min_m)
    try:
        eng = Engine(tllama, tcfg, tp, max_batch=3, max_seq=MAX_SEQ, chunk_size=chunk,
                     device="cpu")
        floods = []
        orig = eng._admit_batch
        eng._admit_batch = lambda: floods.append(orig()) or floods[-1]
        outs = _run(eng, prompts, 6)
        assert any(floods)
        return prompts, outs
    finally:
        tconfig.unset("int8_min_m")


def test_engine_matches_generate(models):
    """Engine streams equal generate's where both prefill a prompt on one
    matmul route. A flood's products take the routes of M = B·s_pad, which
    crosses int8_min_m where generate's prefill of a short prompt does not, so both run the
    f32 route here (int8_min_m=0): the short prompts [5, 20] flood, the
    70-token one is admitted in three 32-token chunks."""
    _, _, tcfg, tp = models
    prompts, outs = _serve_flooded(tcfg, tp, (5, 20, 70, 3), CHUNK, 0)
    tconfig.set("int8_min_m", 0)
    try:
        for prompt, out in zip(prompts, outs):
            assert prompt + out == tllama.generate(tcfg, tp, prompt, 6,
                                                   max_seq=MAX_SEQ, device="cpu")
    finally:
        tconfig.unset("int8_min_m")


def test_engine_matches_generate_int8_route(models):
    """At the default int8_min_m (64), prompts of at least 64 tokens are
    flooded (M = 3·128) and prefilled by generate (M = 64–100) on the int8
    route alike: the streams are equal."""
    _, _, tcfg, tp = models
    prompts, outs = _serve_flooded(tcfg, tp, (64, 100, 80), 128, None)
    for prompt, out in zip(prompts, outs):
        assert prompt + out == tllama.generate(tcfg, tp, prompt, 6, max_seq=MAX_SEQ,
                                               device="cpu")


def test_engine_matches_reference_engine(models):
    """Same requests through the JAX Engine (window delta off on both
    sides). Both engines flood the short prompts at the same M; both run
    the f32 route here (int8_min_m=0), where the packages compute the same
    function (the int8 route: test_engine_matches_reference_engine_int8_route)."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts([9, 40, 2, 17], seed=1)
    jconfig.set("engine_window_delta", False)
    tconfig.set("engine_window_delta", False)
    jconfig.set("int8_min_m", 0)
    tconfig.set("int8_min_m", 0)
    try:
        ref = _run(JEngine(jllama, jcfg, jp, max_batch=4, max_seq=MAX_SEQ,
                           chunk_size=CHUNK), prompts, 5)
        got = _run(Engine(tllama, tcfg, tp, max_batch=4, max_seq=MAX_SEQ,
                          chunk_size=CHUNK, device="cpu"), prompts, 5)
    finally:
        jconfig.unset("engine_window_delta")
        tconfig.unset("engine_window_delta")
        jconfig.unset("int8_min_m")
        tconfig.unset("int8_min_m")
    assert got == ref


def test_engine_eos_and_cadence(models):
    _, _, tcfg, tp = models
    base = tllama.generate(tcfg, tp, [5, 6], 3, max_seq=MAX_SEQ, device="cpu")
    eng = Engine(tllama, tcfg, tp, max_batch=2, max_seq=MAX_SEQ, chunk_size=16,
                 device="cpu")
    rid = eng.submit([5, 6], 8, eos_id=base[2])
    assert {r.rid: r for r in eng.run()}[rid].out == [base[2]]
    # a 48-token admission takes three 16-token chunks; the active slot
    # gains exactly one token per step meanwhile
    eng.submit([1, 2, 3], 40)
    eng.step()
    eng.submit(list(range(1, 49)), 2)
    for _ in range(3):
        before = len(eng.slots[0].out)
        eng.step()
        assert len(eng.slots[0].out) == before + 1


def test_engine_sampling_batch_invariant(models):
    """Seeded sampling gives a request the same tokens alone or batched."""
    _, _, tcfg, tp = models
    kw = dict(temp=0.9, top_k=20, top_p=0.85)

    def run(reqs):
        eng = Engine(tllama, tcfg, tp, max_batch=2, max_seq=64, device="cpu")
        rids = [eng.submit(p, 6, seed=s, **kw) for s, p in reqs]
        done = {r.rid: r.out for r in eng.run()}
        return [done[r] for r in rids]

    solo = [run([(11, [1, 2, 3])])[0], run([(22, [9, 8])])[0]]
    assert run([(11, [1, 2, 3]), (22, [9, 8])]) == solo
    assert all(len(o) == 6 for o in solo)


def test_engine_sampled_streams_match_reference_engine(models):
    """At temp > 0 both engines key token j of a request with
    fold_in(PRNGKey(seed), j): the port's streams equal the JAX Engine's
    token for token (window delta off; int8_min_m = 0 on both sides, as in
    test_engine_matches_reference_engine)."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts([9, 14, 2, 16], seed=6)      # one prefill bucket: few compiles
    seeds = [3, 11, 12345, 2 ** 31 - 1]
    kw = dict(temp=0.9, top_k=20, top_p=0.85)

    def run(eng):
        rids = [eng.submit(p, 6, seed=s, **kw) for p, s in zip(prompts, seeds)]
        done = {r.rid: r.out for r in eng.run()}
        return [done[r] for r in rids]

    jconfig.set("engine_window_delta", False)
    tconfig.set("engine_window_delta", False)
    jconfig.set("int8_min_m", 0)
    tconfig.set("int8_min_m", 0)
    try:
        ref = run(JEngine(jllama, jcfg, jp, max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK))
        got = run(Engine(tllama, tcfg, tp, max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK,
                         device="cpu"))
    finally:
        jconfig.unset("engine_window_delta")
        tconfig.unset("engine_window_delta")
        jconfig.unset("int8_min_m")
        tconfig.unset("int8_min_m")
    assert got == ref
    greedy = [tllama.generate(tcfg, tp, p, 6, max_seq=MAX_SEQ, device="cpu")[len(p):]
              for p in prompts]
    assert got != greedy                      # the streams are really sampled


def test_engine_matches_reference_engine_int8_route(models, monkeypatch):
    """Prefill chunks of 64 tokens and ragged tails padded to 64 run the
    int8 route (K3) at the default int8_min_m on both sides. Every prompt is
    longer than the chunk size, so the JAX engine's batched flood admission
    stays off and both engines prefill the same per-request chunks; the
    70-token prompt's 6-token tail runs the f32 route."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts([100, 120, 70], seed=3)
    chunk = 64
    jconfig.set("engine_window_delta", False)
    tconfig.set("engine_window_delta", False)
    try:
        ref = _run(JEngine(jllama, jcfg, jp, max_batch=3, max_seq=MAX_SEQ,
                           chunk_size=chunk), prompts, 4)
    finally:
        jconfig.unset("engine_window_delta")
    routes = []
    real_route = dispatch.route
    monkeypatch.setattr(dispatch, "route",
                        lambda m, qtype, *a: routes.append((m, real_route(m, qtype, *a)))
                        or routes[-1][1])
    try:
        got = _run(Engine(tllama, tcfg, tp, max_batch=3, max_seq=MAX_SEQ,
                          chunk_size=chunk, device="cpu"), prompts, 4)
    finally:
        tconfig.unset("engine_window_delta")
    assert (64, "i8") in routes and (16, "f32") in routes
    assert got == ref


def test_engine_unported_options_raise(models, monkeypatch):
    """The knobs that raised before they were ported now take effect, set in
    code or through the environment: GGML_TORCH_KV_QUANT=1 builds an Engine
    whose cache is int8, engine_window_delta=True sets (its streams:
    test_torch_kv_variants.py). A knob the port does not have raises."""
    _, _, tcfg, tp = models
    tconfig.set("engine_window_delta", True)
    try:
        assert tconfig.get("engine_window_delta") is True
    finally:
        tconfig.unset("engine_window_delta")
    monkeypatch.setenv("GGML_TORCH_KV_QUANT", "1")
    eng = Engine(tllama, tcfg, tp, max_batch=2, max_seq=MAX_SEQ, device="cpu")
    assert eng.kv.quantized and eng.kv.k[0].dtype == torch.int8
    assert eng.kv.k_d[0].shape == (2, tcfg.n_kv_head, MAX_SEQ)
    with pytest.raises(KeyError):
        tconfig.set("load_chunk_mb", 256)
