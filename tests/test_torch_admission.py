"""Port parity: the engine's batched flood admission and the paged KV pool.

The port's Engine floods short prompts (one `forward_batch` over the
admitted requests' rows into a temp cache, first tokens sampled on the
device, row i installed in place at its slot) where the JAX Engine
prefills every slot's row (runtime/engine.py:586-711), on the dense cache,
the int8 cache (kv_quant) and the paged pool (runtime/paged_kv.py). Its
streams, greedy and seeded-sampled, equal the JAX Engine's at the same
settings (engine_window_delta False on both sides; int8_min_m = 0 on both,
so that every product is f32 and both packages compute the same
function), for a flood into an empty engine and one beside active slots.
A compact flood keeps every product's route of the full block (the port
alone, int8_min_m > 0). Page bookkeeping: the pool against the dense
cache, deferred admission while the pool is full, the too-small-pool
error, a flood trimmed to the free pages."""
import itertools

import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.models import moe as jmoe
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.runtime.paged_kv import PagedKVCache as JPagedKVCache
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.models import moe as tmoe
from ggml_gfx906_tpu_torch.ops.cuda import dispatch
from ggml_gfx906_tpu_torch.runtime.batched_kv import BatchedKVCache
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.runtime.paged_kv import PagedKVCache
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import jax_params_to_numpy, one_torch_thread, tiny_models  # noqa: F401

MAX_SEQ = 64
CHUNK = 32
PS = 16          # small pages, so that tiny runs cross page boundaries
SAMPLED = dict(temp=0.8, top_k=20, top_p=0.9)


@pytest.fixture(scope="module")
def models():
    return tiny_models(GGMLType.Q4_K, seed=2, n_ctx=MAX_SEQ)


@pytest.fixture
def both():
    """Set knobs on both packages for one test: window delta off, the f32
    route and PS-position pages throughout."""
    names = set()

    def set_(name, value):
        names.add(name)
        jconfig.set(name, value)
        tconfig.set(name, value)

    for name, value in (("engine_window_delta", False), ("int8_min_m", 0),
                        ("kv_page_size", PS)):
        set_(name, value)
    yield set_
    for name in names:
        jconfig.unset(name)
        tconfig.unset(name)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, n)] for n in lengths]


def _spy_floods(eng) -> list:
    """Record, for every flood `eng` admits, the number of slots it filled."""
    floods = []
    orig = eng._admit_batch

    def spy():
        before = sum(s is not None for s in eng.slots)
        ok = orig()
        if ok:
            floods.append(sum(s is not None for s in eng.slots) - before)
        return ok

    eng._admit_batch = spy
    return floods


def _spy_blocks(eng) -> list:
    """Record the (rows, s_pad) shape of every flood's token block."""
    blocks = []
    orig = eng._prefill_flood

    def spy(toks, *a, **kw):
        blocks.append(tuple(toks.shape))
        return orig(toks, *a, **kw)

    eng._prefill_flood = spy
    return blocks


def _serve(eng, prompts, n_new, sampled=(), waves=(), **kw):
    """The streams of `prompts` (request j seeded 21 + j; the requests whose
    index is in `sampled` at temp > 0). waves: the sizes of leading groups
    submitted one at a time, each followed by two engine steps; the rest
    then arrive together."""
    rids = []
    for j, p in enumerate(prompts):
        rids.append(eng.submit(p, n_new, seed=21 + j, **(SAMPLED if j in sampled else {}),
                               **kw))
        if j + 1 in itertools.accumulate(waves):
            eng.step()
            eng.step()
    done = {r.rid: r.out for r in eng.run()}
    assert set(done) == set(rids)
    return [done[r] for r in rids]


# arrival "together": four prompts into an empty 4-slot engine, one flood
# of every slot; "beside": two prompts flood an empty 8-slot engine, then
# three more flood beside them (two greedy, one sampled)
ARRIVALS = {"together": dict(lengths=[9, 20, 3, 17, 5], max_batch=4, waves=(), sampled=(1, 3),
                             blocks=[(4, 32)], greedy=(0, 2)),
            "beside": dict(lengths=[25, 11, 9, 3, 14], max_batch=8, waves=(2,), sampled=(3,),
                           blocks=[(2, 32), (3, 16)], greedy=(2, 4))}


@pytest.mark.parametrize("arrival", list(ARRIVALS))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32kv", "int8kv"])
def test_flood_matches_reference_engine(models, both, kv_quant, paged, arrival):
    """Short prompts arrive together, or in two waves: both engines admit
    them in the same floods (the port's counted) and give the same
    streams, greedy and sampled, on each cache flavour. A flood that fills
    every slot of an empty engine computes every slot's row; one beside
    active slots computes its own requests' rows only. In "together" a
    fifth request, admitted after a slot frees, goes through the same
    flood-or-chunk choice."""
    jcfg, jp, tcfg, tp = models
    a = ARRIVALS[arrival]
    both("kv_quant", kv_quant)
    prompts = _prompts(a["lengths"], seed=1)
    kw = dict(max_batch=a["max_batch"], max_seq=MAX_SEQ, chunk_size=CHUNK,
              paged_pages=16 if paged else None)
    serve = dict(n_new=6, sampled=a["sampled"], waves=a["waves"])
    ref = _serve(JEngine(jllama, jcfg, jp, **kw), prompts, **serve)
    eng = Engine(tllama, tcfg, tp, device="cpu", **kw)
    floods, blocks = _spy_floods(eng), _spy_blocks(eng)
    got = _serve(eng, prompts, **serve)
    assert floods[:len(a["blocks"])] == [rows for rows, _ in a["blocks"]]
    assert blocks[:len(a["blocks"])] == a["blocks"]
    assert eng.kv.quantized == kv_quant
    assert got == ref
    assert isinstance(eng.kv, PagedKVCache if paged else BatchedKVCache)
    greedy = [tllama.generate(tcfg, tp, prompts[j], 6, max_seq=MAX_SEQ, device="cpu",
                              kv_quant=kv_quant)[len(prompts[j]):] for j in a["greedy"]]
    assert [got[j] for j in a["greedy"]] == greedy
    j = a["sampled"][0]
    assert got[j] != tllama.generate(tcfg, tp, prompts[j], 6, max_seq=MAX_SEQ, device="cpu",
                                     kv_quant=kv_quant)[len(prompts[j]):]


def test_flood_near_cap(models, both):
    """An active slot near max_seq, then a flood of two (its block of two
    rows): the active slot's cache is untouched by the flood (its stream
    equals the JAX Engine's and generate's), and the flooded requests equal
    the JAX Engine's."""
    jcfg, jp, tcfg, tp = models
    long_prompt = _prompts([24], seed=4)[0]
    short = _prompts([2, 3], seed=5)
    outs = []
    for make in (lambda: JEngine(jllama, jcfg, jp, max_batch=4, max_seq=32,
                                 chunk_size=CHUNK),
                 lambda: Engine(tllama, tcfg, tp, max_batch=4, max_seq=32, chunk_size=CHUNK,
                                device="cpu")):
        eng = make()
        if isinstance(eng, Engine):
            floods, blocks = _spy_floods(eng), _spy_blocks(eng)
        rid = eng.submit(long_prompt, 40)                  # runs to the 32-position cap
        for _ in range(4):
            eng.step()
        rids = [eng.submit(p, 4) for p in short]
        done = {r.rid: r.out for r in eng.run()}
        outs.append([done[r] for r in [rid] + rids])
    assert floods == [2]
    assert blocks == [(2, 16)]              # the two admitted rows, not the 4 slots
    assert outs[1] == outs[0]
    assert len(outs[1][0]) == 8
    assert long_prompt + outs[1][0] == tllama.generate(tcfg, tp, long_prompt, 8, max_seq=32,
                                                       device="cpu")


@pytest.fixture(scope="module")
def moe_models():
    """A tiny Mixtral-class model (4 experts, 2 a token; Q4_K), the port's."""
    jcfg = jmoe.MoEConfig(n_vocab=256, n_ctx=MAX_SEQ, n_embd=256, n_head=4, n_kv_head=2,
                          n_layer=2, n_ff=512, n_expert=4, n_expert_used=2)
    tcfg = tmoe.MoEConfig(**{f: getattr(jcfg, f) for f in (
        "n_vocab", "n_ctx", "n_embd", "n_head", "n_kv_head", "n_layer", "n_ff", "n_expert",
        "n_expert_used", "rms_eps", "rope_base", "rope_freq_scale")})
    jp = jmoe.random_params(jcfg, seed=0, qtype=GGMLType.Q4_K)
    return tcfg, tmoe.params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.mark.parametrize("family,min_m,rows", [("llama", 64, 4), ("moe", 64, 4),
                                               ("moe", 160, 5)])
def test_a_compact_flood_keeps_every_route(models, moe_models, monkeypatch, family, min_m,
                                           rows):
    """int8_min_m set so that the 8-slot block at s_pad 16 takes the int8
    route (M = 128; the experts' C = 256) where the two admitted prompts'
    rows alone would not (M = 32, C = 64): the flood beside an active slot
    computes `rows` rows (the fewest that keep the route: at 160 only the
    experts cross), every product of it takes the route that the same flood
    as the full block takes, and the streams are the full block's."""
    mod, cfg, params = ((tllama,) + models[2:] if family == "llama"
                        else (tmoe,) + moe_models)
    real, taking = dispatch.route, {}

    def route(*a, **kw):
        r = real(*a, **kw)
        if "flood" in taking:
            taking["flood"].append(r)
        return r

    def run(full: bool):
        """(blocks, the routes of the flood's products, streams)."""
        eng = Engine(mod, cfg, params, max_batch=8, max_seq=MAX_SEQ, chunk_size=CHUNK,
                     device="cpu")
        if full:
            eng._flood_rows = lambda n, s_pad: eng.max_batch
        blocks, routes, prefill = [], [], eng._prefill_flood

        def flood(toks, *a, **kw):
            blocks.append(tuple(toks.shape))
            taking["flood"] = routes
            try:
                return prefill(toks, *a, **kw)
            finally:
                del taking["flood"]

        eng._prefill_flood = flood
        rids = [eng.submit(_prompts([20], seed=11)[0], 4)]
        eng.step()                                 # a chunk: one slot active
        rids += [eng.submit(p, 4) for p in _prompts([5, 9], seed=12)]
        done = {r.rid: r.out for r in eng.run()}
        return blocks, routes, [done[r] for r in rids]

    monkeypatch.setattr(dispatch, "route", route)
    tconfig.set("int8_min_m", min_m)
    try:
        (blocks, routes, streams), (full_blocks, full_routes, full_streams) = map(
            run, (False, True))
    finally:
        tconfig.unset("int8_min_m")
    assert blocks == [(rows, 16)] and full_blocks == [(8, 16)]
    assert "i8" in routes and routes == full_routes
    assert streams == full_streams


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_paged_cache_unit_parity(quant):
    """Decode writes at staggered positions, crossing a page boundary: the
    port's paged pool gives the dense cache's windowed views bit for bit,
    and the JAX pool's; a window gathered, written and absorbed back gives
    the pool that direct writes give; a masked absorb lands only the
    masked slots' rows and lengths."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    B, H, D, L, MS = 3, 2, 8, 2, 64
    pt = np.arange(B * (MS // PS), dtype=np.int32).reshape(B, MS // PS)[:, ::-1].copy()
    dense = BatchedKVCache.create(L, B, MS, H, D, quant=quant)
    paged = PagedKVCache.create(L, B, MS, H, D, total_pages=B * MS // PS, page_size=PS,
                                quant=quant)
    paged.page_table.copy_(torch.from_numpy(pt))
    jpaged = JPagedKVCache.create(L, B, MS, H, D, total_pages=B * MS // PS, page_size=PS,
                                  quant=quant).with_page_table(jnp.asarray(pt))
    starts = torch.tensor([0, 5, 17], dtype=torch.int32)
    for step in range(PS + 3):
        k_new, v_new = (rng.standard_normal((B, 1, H, D)).astype(np.float32) for _ in range(2))
        for li in range(L):
            dense.update_layer(li, torch.from_numpy(k_new), torch.from_numpy(v_new),
                               starts + step)
            paged.update_layer(li, torch.from_numpy(k_new), torch.from_numpy(v_new),
                               starts + step)
            jpaged = jpaged.update_layer(li, jnp.asarray(k_new), jnp.asarray(v_new),
                                         jnp.asarray(starts.numpy() + step))
    for li in range(L):
        for w in (32, 64, None):
            want = dense.layer_kv(li, w)
            for got in (paged.layer_kv(li, w), jpaged.layer_kv(li, w)):
                assert all(torch.equal(torch.from_numpy(np.array(g)), x)
                           for g, x in zip(got, want) if x is not None)
    # gather → one dense write per slot at its length → absorb
    paged.lengths.copy_(starts + PS + 3)
    direct = PagedKVCache.create(L, B, MS, H, D, total_pages=B * MS // PS, page_size=PS,
                                 quant=quant)
    for a, b in zip(paged.k + paged.v + paged.k_d + paged.v_d,
                    direct.k + direct.v + direct.k_d + direct.v_d):
        b.copy_(a)
    direct.page_table.copy_(paged.page_table)
    k_new, v_new = (torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
                    for _ in range(2))
    view = paged.gather_window(48)
    for li in range(L):
        view.update_layer(li, k_new, v_new, paged.lengths)
        direct.update_layer(li, k_new, v_new, paged.lengths)
    paged.absorb(view, paged.lengths, 1)
    assert all(torch.equal(a, b) for a, b in zip(paged.k + paged.v + paged.k_d + paged.v_d,
                                                   direct.k + direct.v + direct.k_d + direct.v_d))
    # a masked absorb: slot 1's rows go to its pages, the others' to scratch
    temp = BatchedKVCache.create(L, B, PS, H, D, quant=quant)
    for t in temp.k + temp.v:
        t.copy_(torch.randint(-100, 100, t.shape).to(t.dtype))
    temp.lengths.copy_(torch.tensor([7, 9, 11], dtype=torch.int32))
    before = [t.clone() for t in paged.k]
    paged.absorb(temp, torch.zeros(B, dtype=torch.int32), PS,
                 mask=torch.tensor([False, True, False]))
    assert paged.lengths.tolist() == [PS + 3, 9, 17 + PS + 3]
    p1 = int(pt[1, 0])
    for li in range(L):
        assert torch.equal(paged.k[li][p1], temp.k[li][1].to(paged.k[li].dtype))
        changed = {int(p) for p in torch.nonzero((paged.k[li] != before[li]).flatten(1).any(1))}
        assert changed <= {p1, paged.scratch_page}


def test_admission_defers_when_pool_full(models, both):
    """A request whose pages the pool lacks waits while the active slots
    decode, and is admitted when a completion frees pages: the streams
    equal the JAX Engine's on the same pool, and generate's (the pool seats
    one 20-token prompt at a time, so no flood forms)."""
    jcfg, jp, tcfg, tp = models
    prompts = _prompts([20, 20, 3], seed=7)
    kw = dict(max_batch=2, max_seq=MAX_SEQ, chunk_size=CHUNK, paged_pages=3)
    ref = _serve(JEngine(jllama, jcfg, jp, **kw), prompts, 8)
    eng = Engine(tllama, tcfg, tp, device="cpu", **kw)
    deferred = []
    orig = eng._advance_admission_once

    def spy():
        orig()
        deferred.append(eng.pending is not None and eng.pending.first is not None)

    eng._advance_admission_once = spy
    got = _serve(eng, prompts, 8)
    assert any(deferred)
    assert got == ref
    for p, out in zip(prompts, got):
        assert p + out == tllama.generate(tcfg, tp, p, 8, max_seq=MAX_SEQ, device="cpu")
    # one pool group (dp = 1): every page back on its free list
    assert [sorted(f) for f in eng._free_pages] == [[0, 1, 2]]


def test_pool_too_small_raises(models, both):
    _, _, tcfg, tp = models
    eng = Engine(tllama, tcfg, tp, max_batch=2, max_seq=MAX_SEQ, paged_pages=1, device="cpu")
    eng.submit(list(range(1, 20)), 4)           # needs 2 pages, the pool has 1
    with pytest.raises(RuntimeError, match="paged KV pool"):
        eng.run()
    with pytest.raises(ValueError, match="multiple of the page size"):
        Engine(tllama, tcfg, tp, max_batch=2, max_seq=40, paged_pages=4, device="cpu")


def test_flood_trimmed_to_free_pages(models, both):
    """A pool of 5 pages seats two of four 20-token prompts (2 pages each):
    the flood admits two, the third waits for pages, and every stream
    equals the dense engine's; a pool of half the dense cache's pages
    serves the same requests with the same streams."""
    _, _, tcfg, tp = models
    prompts = _prompts([20, 20, 20, 3], seed=8)
    kw = dict(max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK, device="cpu")
    dense = Engine(tllama, tcfg, tp, **kw)
    want = _serve(dense, prompts, 6)
    eng = Engine(tllama, tcfg, tp, paged_pages=5, **kw)
    floods = _spy_floods(eng)
    assert _serve(eng, prompts, 6) == want
    assert floods[0] == 2
    half = Engine(tllama, tcfg, tp, paged_pages=4 * MAX_SEQ // PS // 2, **kw)

    def nbytes(kv):
        return sum(t.numel() * t.element_size() for t in kv.k + kv.v)

    assert nbytes(half.kv) <= 0.6 * nbytes(dense.kv)       # half, and a scratch page
    assert _serve(half, prompts, 6) == want
