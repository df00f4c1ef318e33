"""Port parity: the device-resident decode loop (runtime/graphs.py).

On the CPU a captured program is a direct call behind the same static
buffers, so these tests cover everything but the capture itself:
`llama.decode_step` / `decode_chunk` / `decode_scan` against the JAX
package's and the port's `generate`; the Engine's windowed, pipelined
`run` at every harvest depth, with and without scan windows, against the
JAX Engine at the same settings (engine_window_delta=False and
int8_min_m=0 on both, as in test_torch_engine.py); the cooperative abort;
a capture per traced config knob; and the repairs that keep host copies
out of a decode step (rope tables, dequant shifts, the KV write at a
device position), bit for bit."""
import contextlib
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.ops import quantized as jqz
from ggml_gfx906_tpu.quant import quantize
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.utils import abort as jabort
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.ops import cuda as kernels
from ggml_gfx906_tpu_torch.ops import quantized as tqz
from ggml_gfx906_tpu_torch.ops import rope as trope
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.runtime.graphs import GraphCache
from ggml_gfx906_tpu_torch.runtime.kv_cache import KVCache
from ggml_gfx906_tpu_torch.utils import abort as tabort
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import (jax_params_to_numpy, one_torch_thread, port_cfg,  # noqa: F401
                         recipe_cfg, recipe_jax_params, recipe_weights)

MAX_SEQ = 128
CHUNK = 32
SAMPLED = dict(temp=0.9, top_k=20, top_p=0.85)


@pytest.fixture(scope="module")
def models():
    """A tiny all-Q4_K llama with its own head (a head tied to the
    embedding makes a random model repeat its input token)."""
    jcfg = recipe_cfg(512)
    jp = recipe_jax_params(jcfg, recipe_weights(lambda *_: GGMLType.Q4_K, jcfg, seed=0))
    return jcfg, jp, port_cfg(jcfg), tllama.params_from_numpy(jax_params_to_numpy(jp),
                                                               device="cpu")


@pytest.fixture
def both_configs():
    """Set a knob on both packages for one test (window delta off and the
    f32 route on both sides throughout)."""
    names = set()

    def set_(name, value):
        names.add(name)
        jconfig.set(name, value)
        tconfig.set(name, value)

    set_("engine_window_delta", False)
    set_("int8_min_m", 0)
    yield set_
    for name in names:
        jconfig.unset(name)
        tconfig.unset(name)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, n)] for n in lengths]


def _jax_prefill(jcfg, jp, prompt):
    kv = jllama.make_cache(jcfg, MAX_SEQ)
    lg, kv = jllama.forward_jit(jcfg, jp, jnp.asarray(prompt, jnp.int32), kv, jnp.int32(0))
    return jnp.argmax(lg[-1]).astype(jnp.int32), kv


def _port_prefill(tcfg, tp, prompt):
    kv = tllama.make_cache(tcfg, MAX_SEQ, device="cpu")
    lg, kv = tllama.forward(tcfg, tp, torch.tensor(prompt), kv, 0)
    return int(lg[-1].argmax()), kv


def test_decode_functions_match_reference_and_generate(models):
    """decode_step chained, decode_chunk (tokens and carry) and decode_scan
    give the JAX functions' tokens and the port's generate stream."""
    jcfg, jp, tcfg, tp = models
    prompt, n = [113, 7, 42, 200, 9], 4
    stream = tllama.generate(tcfg, tp, prompt, n + 1, max_seq=MAX_SEQ, device="cpu")
    want = stream[len(prompt) + 1:]
    start = len(prompt)

    jfirst, jkv = _jax_prefill(jcfg, jp, prompt)
    assert int(jfirst) == stream[len(prompt)]
    jtoks, jkv, jcarry = jllama.decode_chunk(jcfg, jp, jkv, jnp.stack([jfirst, jnp.int32(start)]),
                                             n)
    first, kv = _port_prefill(tcfg, tp, prompt)
    toks, kv, carry = tllama.decode_chunk(tcfg, tp, kv, torch.tensor([first, start]), n)
    assert toks.dtype == torch.int32 and toks.tolist() == np.asarray(jtoks).tolist() == want
    assert carry.tolist() == np.asarray(jcarry).tolist() == [want[-1], start + n]
    assert kv.length == start + n

    jfirst, jkv = _jax_prefill(jcfg, jp, prompt)
    jtoks, _ = jllama.decode_scan(jcfg, jp, jkv, jfirst, start, n)
    first, kv = _port_prefill(tcfg, tp, prompt)
    toks, kv = tllama.decode_scan(tcfg, tp, kv, first, start, n)
    assert toks.tolist() == np.asarray(jtoks).tolist() == want

    jfirst, jkv = _jax_prefill(jcfg, jp, prompt)
    first, kv = _port_prefill(tcfg, tp, prompt)
    jt, t = jfirst[None], torch.tensor([first])
    got, ref = [], []
    for i in range(n):
        jt, jkv = jllama.decode_step(jcfg, jp, jt, jkv, jnp.int32(start + i))
        t, kv = tllama.decode_step(tcfg, tp, t, kv, torch.tensor(start + i, dtype=torch.int32))
        ref.append(int(jt[0]))
        got.append(int(t[0]))
    assert got == ref == want


def test_decode_chunk_continues_from_its_carry(models):
    """Two chunks chained through the returned carry give one chunk's
    tokens, on the one graph of the cache."""
    _, _, tcfg, tp = models
    prompt = [3, 141, 59]
    first, kv = _port_prefill(tcfg, tp, prompt)
    whole, _, _ = tllama.decode_chunk(tcfg, tp, kv, torch.tensor([first, 3]), 6)
    first, kv = _port_prefill(tcfg, tp, prompt)
    a, kv, carry = tllama.decode_chunk(tcfg, tp, kv, torch.tensor([first, 3]), 2)
    b, kv, _ = tllama.decode_chunk(tcfg, tp, kv, carry, 4)
    assert torch.cat([a, b]).tolist() == whole.tolist()
    assert len(kv.graphs.graphs.graphs) == 1


@pytest.fixture(scope="module")
def generated(models):
    """The port's generate streams (6 new tokens) of some prompts, each
    computed once for the file."""
    _, _, tcfg, tp = models
    cache = {}

    def get(prompts):
        if prompts not in cache:
            cache[prompts] = [tllama.generate(tcfg, tp, list(p), 6, max_seq=MAX_SEQ,
                                              device="cpu")[len(p):] for p in prompts]
        return cache[prompts]

    return get


def _serve(eng, prompts, n_new, **kw):
    rids = [eng.submit(p, n_new, seed=s, **kw) for s, p in zip((3, 11, 12345, 2 ** 31 - 1),
                                                                prompts)]
    done = {r.rid: r.out for r in eng.run()}
    assert set(done) == set(rids)
    return [done[r] for r in rids]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "per_step"])
@pytest.mark.parametrize("depth", [1, 3, 8])
def test_engine_matches_reference_engine_at_depth(models, both_configs, generated, depth, scan,
                                                  sampled):
    """The port's windowed engine gives the JAX Engine's streams at the
    same harvest depth and scan setting; its window log counts every token
    served; scan windows replay a graph of `depth` steps."""
    jcfg, jp, tcfg, tp = models
    both_configs("engine_harvest_depth", depth)
    both_configs("engine_scan_window", scan)
    prompts = _prompts([9, 40, 2, 17], seed=1)
    kw = SAMPLED if sampled else {}
    ref = _serve(JEngine(jllama, jcfg, jp, max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK),
                 prompts, 6, **kw)
    eng = Engine(tllama, tcfg, tp, max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK,
                 device="cpu")
    got = _serve(eng, prompts, 6, **kw)
    assert got == ref
    assert sum(n for _, n in eng.window_log) == sum(map(len, got)) == 24
    depths = {key[6] for key in eng.graphs.graphs}
    assert depths == ({1, depth} if scan and depth > 1 else {1})
    if not sampled:
        assert got == generated(tuple(map(tuple, prompts)))


def test_abort_harvests_dispatched_tokens(models, both_configs):
    """An abort raised mid-run leaves each request with the tokens of every
    dispatched step, as in the JAX Engine. The prompts are longer than the
    chunk size, so both engines admit them the same way (no batched
    flood) and poll the callback at the same points."""
    jcfg, jp, tcfg, tp = models
    both_configs("engine_harvest_depth", 3)
    prompts = _prompts([40, 50], seed=4)
    outs = []
    for make, ab in ((lambda: JEngine(jllama, jcfg, jp, max_batch=2, max_seq=MAX_SEQ,
                                      chunk_size=CHUNK), jabort),
                     (lambda: Engine(tllama, tcfg, tp, max_batch=2, max_seq=MAX_SEQ,
                                     chunk_size=CHUNK, device="cpu"), tabort)):
        eng = make()
        polls = itertools.count()
        ab.set_abort_callback(lambda: next(polls) >= 5)
        try:
            rids = [eng.submit(p, 30) for p in prompts]
            with pytest.raises(ab.Aborted):
                eng.run()
        finally:
            ab.set_abort_callback(None)
        reqs = {r.rid: r.out for r in eng.finished + [s for s in eng.slots if s is not None]}
        outs.append([reqs[r] for r in rids])
    assert outs[0] == outs[1]
    assert 0 < sum(map(len, outs[1])) < 60


def test_knob_flip_captures_anew(models):
    """A config knob the traced step reads, flipped after a window, gives a
    new graph (never a stale replay); flipped back, the first one again."""
    _, _, tcfg, tp = models
    eng = Engine(tllama, tcfg, tp, max_batch=2, max_seq=64, chunk_size=CHUNK, device="cpu")
    prompts = _prompts([3, 5], seed=2)
    base = _serve(eng, prompts, 4)
    first = dict(eng.graphs.graphs)
    kv = _port_prefill(tcfg, tp, [1, 2])[1]
    g = tllama.step_graph(tcfg, tp, kv)
    for name, value in (("attn_impl", "xla"), ("qmm_pipeline", "on")):
        tconfig.set(name, value)
        try:
            again = _serve(eng, prompts, 4)
            assert tllama.step_graph(tcfg, tp, kv) is not g
        finally:
            tconfig.unset(name)
        new = {k: v for k, v in eng.graphs.graphs.items() if k not in first}
        assert new and all(value in k for k in new)
        assert not {id(v) for v in new.values()} & {id(v) for v in first.values()}
        assert again == base
        first = dict(eng.graphs.graphs)
    assert tllama.step_graph(tcfg, tp, kv) is g


def test_capture_counts_launches_per_replay(monkeypatch):
    """On the card a graph runs its callable once to warm up (its launches
    count, the state it advanced is restored), takes the capture's launches
    back out of the counters and adds them at every replay. A stand-in for
    torch.cuda's streams and graphs runs the capture's Python here."""
    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    state, seen = torch.zeros(1), []

    def step():
        seen.append(int(state))
        kernels.K1.launches += 3
        kernels.K2.launches += 1
        state.add_(1)
        return state * 2

    kernels.reset_launches()
    try:
        cache = GraphCache(torch.device("cuda"))
        g = cache.get(("step",), step, state=(state,))
        assert seen == [0, 0]                       # warm-up, then capture from the restored state
        assert (kernels.K1.launches, kernels.K2.launches) == (3, 1)    # the warm-up's only
        assert g.replay() is g.outputs and len(g.outputs) == 1
        g.replay()
        assert (kernels.K1.launches, kernels.K2.launches) == (9, 3)
        assert cache.get(("step",), step, state=(state,)) is g and len(seen) == 2
    finally:
        kernels.reset_launches()


# ------------------------------------------------------------- repairs

def _rope_cos_sin_per_call(pos, n_dims, freq_base, freq_scale, ext_factor, attn_factor,
                           beta_fast, beta_slow, n_ctx_orig):
    """The tables as they were built before they were cached: numpy on the
    host at every call, then copied to the positions' device."""
    import math

    half = n_dims // 2
    pair_idx = np.arange(half)
    theta_pow = np.float32(freq_base) ** (-2.0 * pair_idx.astype(np.float32) / n_dims)
    theta_extrap = pos.float()[..., None] * torch.from_numpy(theta_pow.astype(np.float32))
    theta_interp = float(freq_scale) * theta_extrap
    mscale = np.float32(attn_factor)
    if ext_factor != 0.0:
        low, high = trope.yarn_corr_dims(n_dims, n_ctx_orig, freq_base, beta_fast, beta_slow)
        ramp_y = (pair_idx.astype(np.float32) - low) / max(0.001, high - low)
        ramp = torch.from_numpy(((1.0 - np.clip(ramp_y.astype(np.float32), 0.0, 1.0))
                                 * ext_factor).astype(np.float32))
        theta = theta_interp * (1 - ramp) + theta_extrap * ramp
        mscale = np.float32(mscale * np.float32(1.0 + 0.1 * math.log(1.0 / freq_scale)))
    else:
        theta = theta_interp
    return torch.cos(theta) * float(mscale), torch.sin(theta) * float(mscale)


@pytest.mark.parametrize("kw", [
    dict(freq_base=10000.0, freq_scale=1.0, ext_factor=0.0, attn_factor=1.0, n_ctx_orig=1),
    dict(freq_base=500000.0, freq_scale=0.25, ext_factor=0.0, attn_factor=1.0, n_ctx_orig=1),
    dict(freq_base=10000.0, freq_scale=0.5, ext_factor=1.0, attn_factor=1.1, n_ctx_orig=64),
])
def test_rope_tables_cached_bit_equal(kw):
    """The cached rope tables give the per-call tables' bits, and a second
    call reads the same cached tensors."""
    pos = torch.from_numpy(np.random.default_rng(5).integers(0, 900, (3, 7)).astype(np.int32))
    args = (pos, 64, kw["freq_base"], kw["freq_scale"], kw["ext_factor"], kw["attn_factor"],
            32.0, 1.0, kw["n_ctx_orig"])
    for got, want in zip(trope._rope_cos_sin(*args), _rope_cos_sin_per_call(*args)):
        assert torch.equal(got, want)
    key = (64, kw["freq_base"], kw["ext_factor"], 32.0, 1.0, kw["n_ctx_orig"], pos.device)
    assert trope._rope_tables(*key)[0] is trope._rope_tables(*key)[0]


@pytest.mark.parametrize("qtype", [GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q6_K])
def test_dequant_with_device_shifts_bit_equal(qtype):
    """Q2_K, Q3_K and Q6_K dequantization and embedding rows (whose 2-bit
    shifts are now built by a kernel on the tensor's device) equal the JAX
    package's dequantization bit for bit."""
    w = (np.random.default_rng(int(qtype)).standard_normal((12, 512)) * 0.05).astype(np.float32)
    blocks = quantize(qtype, w)
    ref = np.asarray(jqz.dequant(jqz.QuantTensor.from_blocks(qtype, blocks, prefer_kernel=False)))
    qt = tqz.QuantTensor.from_blocks(qtype, blocks, "cpu")
    assert np.array_equal(tqz.dequant(qt).numpy(), ref)
    ids = torch.tensor([[3, 0], [11, 3]])
    assert np.array_equal(tqz.embed_rows(qt, ids).numpy(), ref[ids.numpy()])


@pytest.mark.parametrize("start", [0, 5, 60, 62])
def test_kv_write_at_device_position_bit_equal(start):
    """KVCache.update_layer at a device int32 start writes what a host int
    start writes, clamp included (3 rows at 62 of 64 land at 61)."""
    rng = np.random.default_rng(start)
    k, v = (torch.from_numpy(rng.standard_normal((3, 2, 8)).astype(np.float32))
            for _ in range(2))
    fill = torch.from_numpy(rng.standard_normal((4, 2, 64, 8)).astype(np.float32))
    caches = []
    for s in (start, torch.tensor([start], dtype=torch.int32)):
        kv = KVCache.create(2, 64, 2, 8, torch.bfloat16)
        for t, f in zip(kv.k + kv.v, fill):
            t.copy_(f)
        caches.append(kv.update_layer(1, k, v, s))
    a, b = caches
    assert all(torch.equal(x, y) for x, y in zip(a.k + a.v, b.k + b.v))
    s0 = min(start, 61)
    assert torch.equal(b.k[1][:, s0:s0 + 3], k.transpose(0, 1).to(torch.bfloat16))
    assert torch.equal(b.v[1][:, s0:s0 + 3], v.transpose(0, 1).to(torch.bfloat16))


def test_forward_at_device_start_bit_equal(models):
    """A forward at a device start gives the logits and cache of the same
    forward at a host int start."""
    _, _, tcfg, tp = models
    out = []
    for start in (4, torch.tensor([4], dtype=torch.int32)):
        kv = tllama.make_cache(tcfg, 32, device="cpu")
        _, kv = tllama.forward(tcfg, tp, torch.tensor([9, 8, 7, 6]), kv, 0)
        lg, kv = tllama.forward(tcfg, tp, torch.tensor([5, 4]), kv, start)
        out.append((lg, kv))
    (la, ka), (lb, kb) = out
    assert torch.equal(la, lb) and ka.length == kb.length == 6
    assert all(torch.equal(x, y) for x, y in zip(ka.k + ka.v, kb.k + kb.v))
