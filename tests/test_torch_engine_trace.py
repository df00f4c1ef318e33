"""The span recorder (utils/trace.py), the engine's spans and per-request
timings (runtime/engine.py), graphs.py's own spans and the benchmark's
three readers of them (port_bench/metrics/): on the CPU, at tiny sizes."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.runtime.engine import Engine, Request
from ggml_gfx906_tpu_torch.runtime.graphs import GraphCache, HostCopy
from ggml_gfx906_tpu_torch.utils import config as tconfig
from ggml_gfx906_tpu_torch.utils import trace
from port_bench.driver import Done
from port_bench.run import load_reader

from _torch_port import one_torch_thread, tiny_models  # noqa: F401

MS = 1_000_000                  # ns
READERS = ("admission.queue_wait_ms", "admission.flood_fill", "engine.first_harvest_ms")


@pytest.fixture
def rec(monkeypatch):
    """A fresh process recorder for one test."""
    r = trace.Recorder()
    monkeypatch.setattr(trace, "RECORDER", r)
    return r


class _Ops(TorchDispatchMode):
    """The dispatcher calls made inside it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------ the recorder

def test_spans_nest_with_parent_ids_and_attributes(rec):
    with trace.named_scope("a", n=1) as a:
        with trace.named_scope("b") as b:
            b.rid = 7
            with trace.named_scope("c") as c:
                c.set(tokens=5, rids=(1, 2))
        with trace.named_scope("d") as d:
            pass
    assert [s.name for s in rec.spans] == ["c", "b", "d", "a"]      # in the order they end
    assert (a.parent, b.parent, c.parent, d.parent) == (0, a.sid, b.sid, a.sid)
    assert len({a.sid, b.sid, c.sid, d.sid}) == 4
    assert a.attrs == {"n": 1} and c.attrs == {"tokens": 5, "rids": (1, 2)}
    assert (b.rid, a.rid) == (7, None)
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1
    sid = trace.record("r", 10, 20, parent=a.sid, rid=3, k=4)
    assert rec.spans[-1].sid == sid and (rec.spans[-1].t0, rec.spans[-1].t1) == (10, 20)


def test_a_span_ends_when_its_block_raises(rec):
    with pytest.raises(KeyError):
        with trace.named_scope("outer"):
            with trace.named_scope("inner"):
                raise KeyError
    with trace.named_scope("next") as nxt:
        pass
    assert [s.name for s in rec.spans] == ["inner", "outer", "next"] and nxt.parent == 0


@pytest.mark.parametrize("capacity,n", [(4, 3), (4, 4), (4, 10), (16, 100)])
def test_the_ring_keeps_the_newest_spans(monkeypatch, capacity, n):
    r = trace.Recorder(capacity)
    monkeypatch.setattr(trace, "RECORDER", r)
    for i in range(n):
        trace.record("s", 100 * i, 100 * i + 50, i=i)
    assert [s.attrs["i"] for s in r.spans] == list(range(max(0, n - capacity), n))
    lost = n - capacity
    assert r.lost_until == (100 * (lost - 1) + 50 if lost > 0 else None)
    first_kept = 100 * max(lost, 0)
    assert r.window(first_kept, 10 ** 9) is not None
    assert (r.window(first_kept - 50, 10 ** 9) is None) == (lost > 0)
    assert len(r.overlapping(0, 10 ** 9)) == min(n, capacity)


@pytest.mark.parametrize("profiling", [False, True])
def test_a_scope_mirrors_into_the_profiler_only_while_one_runs(rec, profiling):
    """With no profiler a scope makes no dispatcher call (record_function
    makes two: the control); under one it is a record_function of its name,
    and a scope made with mirror=False never is."""
    with _Ops() as ctl:
        with torch.profiler.record_function("control"):
            pass
    assert len(ctl.ops) == 2
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    if profiling:
        prof.start()
    with _Ops() as seen:
        with trace.named_scope("mirrored", k=1):
            with trace.named_scope("ring_only", mirror=False):
                pass
    names = set()
    if profiling:
        prof.stop()
        names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert [s.name for s in rec.spans] == ["ring_only", "mirrored"]
    assert len(seen.ops) == (2 if profiling else 0)
    assert ("mirrored" in names) == profiling and "ring_only" not in names


def test_span_times_map_onto_the_profilers_clock(rec):
    with torch.profiler.record_function("warm"):    # the first range's one-off cost
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans = []
        for i in range(3):
            with trace.named_scope(f"clock{i}") as sp:
                time.sleep(0.003)
            spans.append(sp)
    ev = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for sp in spans:
        e = ev[sp.name]
        assert abs(e.start_ns() - trace.to_trace_ns(sp.t0)) < MS
        assert abs(e.start_ns() + e.duration_ns() - trace.to_trace_ns(sp.t1)) < MS


def test_profile_writes_the_rings_spans_and_requests(rec, tmp_path):
    with trace.profile(tmp_path) as path:
        with trace.named_scope("window", mirror=False):
            with trace.named_scope("leaf", n=2) as leaf:
                time.sleep(0.002)
        sid = trace.record(trace.REQUEST, leaf.t0, leaf.t1, rid=41, tokens=3)
        trace.record("request.queued", leaf.t0, leaf.t1, parent=sid, rid=41)
    trace.record("after", time.perf_counter_ns(), time.perf_counter_ns())
    ev = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in ev if e.get("cat") in ("span", trace.REQUEST)]
    assert {e["name"] for e in mine if e["ph"] == "X"} == {"window", "leaf"}
    assert sorted((e["name"], e["ph"], e["id"]) for e in mine if e["ph"] in "be") == [
        ("request", "b", 41), ("request", "e", 41), ("request.queued", "b", 41),
        ("request.queued", "e", 41)]
    x = next(e for e in mine if e["name"] == "leaf")
    annotated = next(e for e in ev if e["name"] == "leaf" and e.get("cat") == "user_annotation")
    assert x["args"]["n"] == 2 and abs(x["ts"] - annotated["ts"]) < 1e3      # µs


def test_request_timings_take_no_part_in_equality():
    a, b = Request(3, [1, 2], 4), Request(3, [1, 2], 4)
    b.t_submit, b.t_admit, b.t_first, b.t_finish, b.admitted_by = 1, 2, 3, 4, "flood"
    assert a == b and repr(a) == repr(b)
    assert a != Request(3, [1, 2], 5)


@pytest.mark.parametrize("calls", [1, 3])
def test_a_graph_is_made_inside_one_capture_span(rec, calls):
    """graphs.py names its own work: a program is made inside a
    `graphs.capture` span on its key's first call alone."""
    cache = GraphCache(torch.device("cpu"))
    for _ in range(calls):
        g = cache.get(("k",), lambda: torch.ones(2))
    assert [s.name for s in rec.spans] == ["graphs.capture"]
    assert torch.equal(g.replay()[0], torch.ones(2))


def test_a_host_copy_is_read_inside_a_wait_span(rec):
    with trace.named_scope("reader") as outer:
        got = HostCopy(torch.arange(3)).numpy()
    assert got.tolist() == [0, 1, 2]
    assert [(s.name, s.parent) for s in rec.spans] == [("graphs.wait", outer.sid),
                                                       ("reader", 0)]


@pytest.mark.parametrize("enabled", [True, False])
def test_no_garbage_collection_inside_a_capture(monkeypatch, enabled):
    """A collection inside a capture could destroy a dead cycle's CUDA graph
    there and invalidate the capture: the collector is off for the capture
    alone (not the warm-up) and comes back as it was. torch.cuda's streams
    and graphs are stand-ins that run the capture's Python here."""
    import contextlib
    import gc

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    @contextlib.contextmanager
    def graph(g, pool=None):
        seen.append("capture")
        yield

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    seen = []

    def body():
        seen.append(gc.isenabled())
        return torch.ones(1)

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        GraphCache(torch.device("cuda")).get(("k",), body)
        assert seen == [enabled, "capture", False] and gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


# ------------------------------------------------ the engine's spans (CPU)

MAX_BATCH = 4
LONG = 150                      # > engine_chunk_size (128): two chunks
LENGTHS = (3, 5, 8, 12, LONG, 7, 4)


@pytest.fixture(scope="module")
def model():
    _, _, tcfg, tp = tiny_models(GGMLType.Q4_K, seed=2, n_ctx=256)
    return tcfg, tp


def _prompts():
    rng = np.random.default_rng(9)
    return [[int(t) for t in rng.integers(1, 256, n)] for n in LENGTHS]


def _serve(model, recorder):
    """(requests in submit order, the recorder's spans) of one engine run."""
    old, trace.RECORDER = trace.RECORDER, recorder
    try:
        eng = Engine(tllama, *model, max_batch=MAX_BATCH, max_seq=256, device="cpu")
        rids = [eng.submit(p, 6) for p in _prompts()]
        done = {r.rid: r for r in eng.run()}
    finally:
        trace.RECORDER = old
    return [done[r] for r in rids], list(recorder.spans)


@pytest.fixture(scope="module")
def served(model):
    return _serve(model, trace.Recorder())


def test_every_request_is_stamped_in_order(served):
    reqs, _ = served
    for r in reqs:
        assert 0 < r.t_submit <= r.t_admit <= r.t_first <= r.t_finish, r.rid


def test_each_request_is_admitted_by_what_admitted_it(served):
    """A chunked request's rid is on its chunk spans; a flooded one's
    admission is the start of a flood span."""
    reqs, spans = served
    flood_starts = {s.t0 for s in spans if s.name == "engine.flood"}
    chunked = {s.rid for s in spans if s.name == "engine.chunk"}
    for r in reqs:
        if r.rid in chunked:
            assert r.admitted_by == "chunk", r.rid
        else:
            assert r.admitted_by == "flood" and r.t_admit in flood_starts, r.rid
    assert all(r.admitted_by == "flood" for r in reqs[:4]) and reqs[4].admitted_by == "chunk"
    starts = flood_starts | {s.t0 for s in spans if s.name == "engine.chunk"}
    assert all(r.t_admit in starts for r in reqs)


def test_a_flood_counts_its_prompts_and_rows(served):
    """Each flood's counts against the requests it admitted (those whose
    admission is its start): their number, their prompt tokens, the rows of
    its block (`batch`: one a request, raised to what keeps the max_batch
    block's int8 route at M = batch × s_pad) and the batch × s_pad rows
    computed (s_pad the bucket of the longest)."""
    reqs, spans = served
    floods = [s for s in spans if s.name == "engine.flood"]
    assert floods
    min_m = int(tconfig.get("int8_min_m"))
    for f in floods:
        prompts = [len(r.prompt) for r in reqs if r.admitted_by == "flood" and r.t_admit == f.t0]
        s_pad = min(b for b in (16, 32, 64, 128) if b >= max(prompts))
        batch = len(prompts)
        if 0 < min_m <= MAX_BATCH * s_pad:
            batch = max(batch, -(-min_m // s_pad))
        assert f.attrs == {"requests": len(prompts), "tokens": sum(prompts),
                           "rows": batch * s_pad, "batch": batch}
        assert len(prompts) >= 2
    assert sum(f.attrs["requests"] for f in floods) == sum(r.admitted_by == "flood" for r in reqs)


def test_chunk_spans_cover_the_long_prompt(served):
    reqs, spans = served
    long = reqs[LENGTHS.index(LONG)]
    chunks = [s for s in spans if s.name == "engine.chunk" and s.rid == long.rid]
    assert [c.attrs for c in chunks] == [{"tokens": 128}, {"tokens": LONG - 128}]
    assert chunks[0].t0 == long.t_admit


def test_leaf_spans_sit_in_their_windows(served):
    _, spans = served
    by_sid = {s.sid: s for s in spans}
    parent = {s.sid: by_sid[s.parent].name if s.parent in by_sid else None for s in spans}
    for s in spans:
        if s.name in ("engine.flood", "engine.chunk", "engine.replay", "engine.harvest"):
            assert parent[s.sid] == "engine.window", s
        elif s.name == "graphs.wait":
            assert parent[s.sid] in ("engine.harvest", "engine.flood"), s
        elif s.name == "graphs.capture":
            assert parent[s.sid] == "engine.replay", s
    assert {s.name for s in spans if not s.name.startswith(trace.REQUEST)} == {
        "engine.window", "engine.flood", "engine.chunk", "engine.replay", "engine.harvest",
        "graphs.capture", "graphs.wait"}


def test_each_request_leaves_its_lifetime_in_the_ring(served):
    reqs, spans = served
    for r in reqs:
        mine = {s.name: s for s in spans if s.rid == r.rid and s.name.startswith("request")}
        assert set(mine) == {trace.REQUEST, *trace.REQUEST_PHASES}
        top = mine[trace.REQUEST]
        assert (top.t0, top.t1, top.parent) == (r.t_submit, r.t_finish, 0)
        assert [(mine[n].t0, mine[n].t1, mine[n].parent) for n in trace.REQUEST_PHASES] == [
            (r.t_submit, r.t_admit, top.sid), (r.t_admit, r.t_first, top.sid),
            (r.t_first, r.t_finish, top.sid)]


def test_streams_do_not_depend_on_the_recorder(model, served):
    """The spans read host state only: the same engine's streams with a
    ring so small that it wraps many times over."""
    reqs, _ = served
    small = trace.Recorder(8)
    again, spans = _serve(model, small)
    assert [r.out for r in again] == [r.out for r in reqs]
    assert len(spans) == 8 and small.lost_until > 0


# ------------------------------------------------------------- the readers

def _ctx(done, t_open, t_close):
    return SimpleNamespace(res=SimpleNamespace(t_open=t_open / 1e9, t_close=t_close / 1e9),
                           completed=lambda: done)


def _synthetic(rec):
    """A window [1000, 2000] ms: two floods start in it (one before it), a
    chunk, a harvest with a wait under it, a replay with a capture under it,
    the per-iteration window spans, and 20 requests completed in it."""
    def span(name, a, b, parent=0, **attrs):
        return trace.record(name, a * MS, b * MS, parent=parent, **attrs)

    span("engine.flood", 900, 950, tokens=50, rows=1000)             # before the window
    w = span("engine.window", 1000, 1600)
    span("engine.flood", 1010, 1030, parent=w, tokens=30, rows=1024)
    span("engine.chunk", 1100, 1110, parent=w, tokens=100, rows=128)
    h = span("engine.harvest", 1500, 1540, parent=w)
    span("graphs.wait", 1500, 1530, parent=h)
    span("engine.window", 1600, 2100)
    r = span("engine.replay", 1990, 2010)                             # 10 ms inside
    span("graphs.capture", 1995, 2000, parent=r)
    span("engine.flood", 1800, 1810, tokens=10, rows=1024)
    done = []
    for i in range(20):
        sub, adm, first, fin = 200 + i, 300 + 10 * i, 400 + 20 * i, 1100 + i
        top = span(trace.REQUEST, sub, fin, rid=i)
        for name, a, b in zip(trace.REQUEST_PHASES, (sub, adm, first), (adm, first, fin)):
            span(name, a, b, parent=top, rid=i)
        done.append(Done(0, i, [1], [2], sub / 1e3, fin / 1e3))
    return done


def test_the_readers_on_a_synthetic_recorder(rec):
    import statistics

    done = _synthetic(rec)
    ctx = _ctx(done, 1000 * MS, 2000 * MS)
    got = {name: load_reader(name)(ctx) for name in READERS}
    waits = [100.0 + 9 * i for i in range(20)]
    assert got["admission.queue_wait_ms"] == pytest.approx(
        statistics.quantiles(waits, n=20)[18])
    assert got["admission.flood_fill"] == pytest.approx(100.0 * 40 / 2048)
    assert got["engine.first_harvest_ms"] == pytest.approx(statistics.median(
        100.0 + 10 * i for i in range(20)))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_none_without_the_spans(rec, monkeypatch, name):
    """None once the ring has dropped a span that ended inside the window,
    and on a program that records no spans (the parent's)."""
    done = _synthetic(rec)
    ctx = _ctx(done, 1000 * MS, 2000 * MS)
    assert load_reader(name)(ctx) is not None
    small = trace.Recorder(len(rec.spans) - 3)
    for s in rec.spans:
        small.add(s)
    assert small.lost_until >= 1000 * MS
    monkeypatch.setattr(trace, "RECORDER", small)
    assert load_reader(name)(ctx) is None
    monkeypatch.delattr(trace, "RECORDER")
    assert load_reader(name)(ctx) is None


def test_request_readers_need_every_request_of_the_window(rec):
    done = _synthetic(rec)
    ctx = _ctx(done + [Done(0, 99, [1], [2], 1.0, 1.5)], 1000 * MS, 2000 * MS)
    assert load_reader("admission.queue_wait_ms")(ctx) is None
    assert load_reader("engine.first_harvest_ms")(ctx) is None
    assert load_reader("admission.flood_fill")(ctx) is not None
