"""Port parity: the int8 KV cache (kv_quant, kv_attn_int8_dot) and
window-delta decode (engine_window_delta).

`quantize_rows` and the quantized cache writes (KVCache, BatchedKVCache,
set_slot, absorb_delta) equal the JAX package's bit for bit;
`causal_attn_delta` and the quantized-KV attention of the plain path
(`_causal_postscale`, with and without the int8 score dot) agree with the
JAX functions within the reference's bounds (tests/test_window_delta.py);
the Engine's window-delta streams equal its strict streams on every cache
flavour and the JAX Engine's at engine_window_delta=True; generate and
decode_chunk on a quantized cache equal the JAX generate(kv_quant=True).
Model-level comparisons run at f32 compute with int8_min_m = 0 on both
sides (every product f32), where kv_attn_int8_dot does not apply and both
packages compute the same function."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu import ops as jops
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.runtime.batched_kv import BatchedKVCache as JBatchedKVCache
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.runtime.kv_cache import KVCache as JKVCache
from ggml_gfx906_tpu.runtime.kv_cache import quantize_rows as jquantize_rows
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch import ops as tops
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.runtime.batched_kv import BatchedKVCache
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.runtime.kv_cache import KVCache, quantize_rows
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import nmse, one_torch_thread, tiny_models  # noqa: F401

MAX_SEQ = 64
CHUNK = 32
PS = 16


@pytest.fixture(scope="module")
def models():
    return tiny_models(GGMLType.Q4_K, seed=2, n_ctx=MAX_SEQ)


@pytest.fixture
def both():
    """Set knobs on both packages for one test (the f32 route and
    PS-position pages throughout)."""
    names = set()

    def set_(name, value):
        names.add(name)
        jconfig.set(name, value)
        tconfig.set(name, value)

    set_("int8_min_m", 0)
    set_("kv_page_size", PS)
    yield set_
    for name in names:
        jconfig.unset(name)
        tconfig.unset(name)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _equal(got, ref) -> bool:
    return torch.equal(got, _t(ref))


# ------------------------------------------------------------ quantize_rows

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_rows_bit_equal(dtype):
    """Random rows, all-zero rows and rows whose scaled values sit exactly
    on .5 ties (amax 127, so d = 1): int8 values and scales equal the
    reference's bit for bit, ties rounded away from zero (C roundf)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 3, 64)) * rng.uniform(0.01, 30, (6, 3, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 2] = 0.0
    x[2, 1, :6] = [127.0, -0.5, 0.5, 2.5, -63.5, 126.5]
    x[2, 1, 6:] = 0.0
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32)
    q, d = quantize_rows(xt)
    qj, dj = jquantize_rows(xj)
    assert q.dtype == torch.int8 and d.dtype == torch.float32
    assert _equal(q, qj) and _equal(d, dj)
    assert q[2, 1, :6].tolist() == [127, -1, 1, 3, -64, 127]
    assert not q[0, 0].any() and d[0, 0] == 0 and not q[1, 2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_cache_writes_bit_equal(dtype):
    """KVCache.update_layer at host and device starts (a clamped 3-row
    write at 62 of 64 included), BatchedKVCache.update_layer at per-slot
    starts and set_slot of a quantized single cache: int8 rows and scales
    equal the reference's caches bit for bit."""
    rng = np.random.default_rng(2)
    L, H, D, MS = 2, 2, 8, 64

    def rows(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                      else jnp.float32)

    jkv = JKVCache.create(L, MS, H, D, quant=True)
    kvs = [KVCache.create(L, MS, H, D, quant=True) for _ in range(2)]
    for li, start, s in ((0, 0, 5), (1, 5, 1), (0, 62, 3), (1, 30, 4)):
        k, v = rows(s, H, D), rows(s, H, D)
        jkv = jkv.update_layer(li, jx(k), jx(v), min(start, MS - s))
        kvs[0].update_layer(li, k, v, start)
        kvs[1].update_layer(li, k, v, torch.tensor([start], dtype=torch.int32))
    for kv in kvs:
        assert kv.quantized and kv.layer_kv(0)[2] is kv.k_d[0]
        for got, ref in zip(kv.k + kv.v + kv.k_d + kv.v_d, jkv.k + jkv.v + jkv.k_d + jkv.v_d):
            assert _equal(got, ref)

    B = 3
    jb = JBatchedKVCache.create(L, B, MS, H, D, quant=True)
    tb = BatchedKVCache.create(L, B, MS, H, D, quant=True)
    starts = np.array([0, 7, 60], np.int32)
    for li in range(L):
        k, v = rows(B, 4, H, D), rows(B, 4, H, D)
        jb = jb.update_layer(li, jx(k), jx(v), jnp.asarray(starts))
        tb.update_layer(li, k, v, torch.from_numpy(starts))
    src = kvs[0]
    jb = jb.set_slot(1, *(tuple(jnp.asarray(t.numpy()) for t in ts)
                          for ts in (src.k, src.v)), 9,
                     *(tuple(jnp.asarray(t.numpy()) for t in ts) for ts in (src.k_d, src.v_d)))
    tb.set_slot(1, src.k, src.v, 9, src.k_d, src.v_d)
    assert tb.quantized and tb.lengths.tolist() == np.asarray(jb.lengths).tolist() == [0, 9, 0]
    for got, ref in zip(tb.k + tb.v + tb.k_d + tb.v_d, jb.k + jb.v + jb.k_d + jb.v_d):
        assert _equal(got, ref)


# ------------------------------------------------------------- attention

def _combined_ref(q, kc, vc, len0, dk, dv, step, scale):
    """Attention over [cache rows < len0[b]] + [delta rows ≤ step], per slot."""
    outs = []
    for b in range(q.shape[0]):
        L = int(len0[b])
        k_all = torch.cat([kc[b, :, :L], dk[b, :, :step + 1]], dim=1)
        v_all = torch.cat([vc[b, :, :L], dv[b, :, :step + 1]], dim=1)
        outs.append(tops.attention_ref(q[b:b + 1], k_all[None], v_all[None], None, scale)[0])
    return torch.stack(outs)


@pytest.mark.parametrize("rep", [1, 4])
def test_causal_attn_delta_matches_reference(rep):
    """Dense big segment, f32: the port's causal_attn_delta against the
    combined-prefix attention and the JAX function, nmse < 1e-10 (the
    reference's bound)."""
    rng = np.random.default_rng(rep)
    B, KVH, W, DEPTH, D = 3, 2, 40, 8, 16
    H = KVH * rep
    q, kc, vc, dk, dv = (rng.standard_normal(s).astype(np.float32) for s in
                         ((B, H, 1, D), (B, KVH, W, D), (B, KVH, W, D), (B, KVH, DEPTH, D),
                          (B, KVH, DEPTH, D)))
    len0, step = np.array([0, 17, 40], np.int32), 3
    args = [torch.from_numpy(a) for a in (q, kc, vc)] + [None, None, torch.from_numpy(len0)]
    got = tops.causal_attn_delta(*args, torch.from_numpy(dk), torch.from_numpy(dv), step,
                                 scale=0.21)
    ref = jops.causal_attn_delta(*(jnp.asarray(a) for a in (q, kc, vc)), None, None, len0,
                                 jnp.asarray(dk), jnp.asarray(dv), step, scale=0.21)
    comb = _combined_ref(*(torch.from_numpy(a) for a in (q, kc, vc)), len0,
                         torch.from_numpy(dk), torch.from_numpy(dv), step, 0.21)
    assert nmse(got, ref) < 1e-10 and nmse(got, comb) < 1e-10


def _int8_segment(rng, B, KVH, W, D):
    k8, v8 = (rng.integers(-127, 128, (B, KVH, W, D)).astype(np.int8) for _ in range(2))
    kd, vd = (np.abs(rng.standard_normal((B, KVH, W))).astype(np.float32) * 0.02
              for _ in range(2))
    return k8, v8, kd, vd


def test_causal_attn_delta_quantized_big_segment():
    """int8 big segment with its scales, f32: against dequantize-then-
    combined attention and the JAX function, nmse < 1e-9."""
    rng = np.random.default_rng(5)
    B, KVH, rep, W, DEPTH, D = 2, 2, 2, 32, 4, 16
    q = rng.standard_normal((B, KVH * rep, 1, D)).astype(np.float32)
    k8, v8, kd, vd = _int8_segment(rng, B, KVH, W, D)
    dk, dv = (rng.standard_normal((B, KVH, DEPTH, D)).astype(np.float32) for _ in range(2))
    len0, step = np.array([9, 32], np.int32), 2
    got = tops.causal_attn_delta(*(torch.from_numpy(a) for a in (q, k8, v8, kd, vd, len0, dk,
                                                                   dv)), step)
    ref = jops.causal_attn_delta(*(jnp.asarray(a) for a in (q, k8, v8, kd, vd)), len0,
                                 jnp.asarray(dk), jnp.asarray(dv), step)
    kc = torch.from_numpy(k8).float() * torch.from_numpy(kd)[..., None]
    vc = torch.from_numpy(v8).float() * torch.from_numpy(vd)[..., None]
    comb = _combined_ref(torch.from_numpy(q), kc, vc, len0, torch.from_numpy(dk),
                         torch.from_numpy(dv), step, 1.0 / D ** 0.5)
    assert nmse(got, ref) < 1e-9 and nmse(got, comb) < 1e-9


@pytest.mark.parametrize("int8_dot", [True, False], ids=["int8_dot", "bf16_dot"])
def test_quantized_attention_bf16_matches_reference(int8_dot):
    """bf16 q at decode against an int8 cache, where kv_attn_int8_dot
    applies: the plain path (attn_impl="xla": `_causal_postscale`) and
    causal_attn_delta equal the JAX functions at the same knob within the
    bf16 rounding of P (nmse < 1e-5; the scores are the same exact integer
    dots); the knob changes the result."""
    rng = np.random.default_rng(9)
    B, KVH, rep, W, DEPTH, D = 2, 2, 2, 48, 4, 32
    q = rng.standard_normal((B, KVH * rep, 1, D)).astype(np.float32)
    k8, v8, kd, vd = _int8_segment(rng, B, KVH, W, D)
    dk, dv = (rng.standard_normal((B, KVH, DEPTH, D)).astype(np.float32) for _ in range(2))
    pos, step = np.array([30, 47], np.int32), 1
    qt = torch.from_numpy(q).to(torch.bfloat16)
    qj = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)
    tt = [torch.from_numpy(a) for a in (k8, v8, kd, vd)]
    jj = [jnp.asarray(a) for a in (k8, v8, kd, vd)]
    dkt, dvt = (torch.from_numpy(a).to(torch.bfloat16) for a in (dk, dv))
    dkj, dvj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (dk, dv))
    outs = {}
    for knob in (int8_dot, not int8_dot):
        for pkg in (jconfig, tconfig):
            pkg.set("kv_attn_int8_dot", knob)
            pkg.set("attn_impl", "xla")
        try:
            got = (tops.causal_flash_attn(qt, tt[0], tt[1], torch.from_numpy(pos),
                                          k_scale=tt[2], v_scale=tt[3]),
                   tops.causal_attn_delta(qt, *tt, torch.from_numpy(pos), dkt, dvt, step))
            ref = (jops.causal_flash_attn(qj, jj[0], jj[1], jnp.asarray(pos),
                                          k_scale=jj[2], v_scale=jj[3]),
                   jops.causal_attn_delta(qj, *jj, pos, dkj, dvj, step))
        finally:
            for pkg in (jconfig, tconfig):
                pkg.unset("kv_attn_int8_dot")
                pkg.unset("attn_impl")
        outs[knob] = got
        for g, r in zip(got, ref):
            assert g.dtype == torch.bfloat16
            assert nmse(g.float(), np.asarray(r.astype(jnp.float32))) < 1e-5
    for a, b in zip(outs[True], outs[False]):
        assert not torch.equal(a, b)


# ------------------------------------------------------------- the delta

@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_absorb_delta_places_rows(quant):
    """absorb_delta lands the window's rows at len0 .. len0+depth-1 as
    per-step writes do, advances the active slots' lengths only, and equals
    the JAX absorb bit for bit."""
    rng = np.random.default_rng(7)
    L, B, H, W, D, DEPTH = 2, 3, 2, 32, 8, 4
    len0 = np.array([0, 5, 20], np.int32)
    active = np.array([True, True, False])
    kv = BatchedKVCache.create(L, B, W, H, D, quant=quant).with_lengths(torch.from_numpy(len0))
    step_kv = BatchedKVCache.create(L, B, W, H, D, quant=quant)
    jkv = JBatchedKVCache.create(L, B, W, H, D, quant=quant).with_lengths(jnp.asarray(len0))
    delta = kv.make_delta(DEPTH, dtype=torch.float32)
    jdelta = jkv.make_delta(DEPTH, dtype=jnp.float32)
    for li in range(L):
        for s in range(DEPTH):
            kn, vn = (rng.standard_normal((B, 1, H, D)).astype(np.float32) for _ in range(2))
            delta.write(li, torch.from_numpy(kn), torch.from_numpy(vn), s)
            jdelta = jdelta.write(li, jnp.asarray(kn), jnp.asarray(vn), s)
            step_kv.update_layer(li, torch.from_numpy(kn), torch.from_numpy(vn),
                                 torch.from_numpy(len0 + s))
    kv.absorb_delta(delta, torch.from_numpy(len0), torch.from_numpy(active), DEPTH)
    jkv = jkv.absorb_delta(jdelta, jnp.asarray(len0), jnp.asarray(active), DEPTH)
    assert kv.lengths.tolist() == np.asarray(jkv.lengths).tolist() == [4, 9, 20]
    for got, ref, step in zip(kv.k + kv.v + kv.k_d + kv.v_d, jkv.k + jkv.v + jkv.k_d + jkv.v_d,
                              step_kv.k + step_kv.v + step_kv.k_d + step_kv.v_d):
        assert _equal(got, ref) and torch.equal(got, step)


def test_absorb_delta_clamps_at_capacity():
    """A slot at len0 > max_seq - depth: the rows land at max_seq - depth
    .. max_seq - 1, as the JAX absorb (dynamic_update_slice) puts them."""
    kv = BatchedKVCache.create(1, 1, 8, 1, 4)
    jkv = JBatchedKVCache.create(1, 1, 8, 1, 4)
    delta, jdelta = kv.make_delta(4, dtype=torch.float32), jkv.make_delta(4, dtype=jnp.float32)
    for s in range(4):
        delta.write(0, torch.full((1, 1, 1, 4), s + 1.0), torch.full((1, 1, 1, 4), -(s + 1.0)), s)
        jdelta = jdelta.write(0, jnp.full((1, 1, 1, 4), s + 1.0),
                              jnp.full((1, 1, 1, 4), -(s + 1.0)), s)
    kv.absorb_delta(delta, torch.tensor([6], dtype=torch.int32), torch.tensor([True]), 4)
    jkv = jkv.absorb_delta(jdelta, jnp.asarray([6], jnp.int32), jnp.asarray([True]), 4)
    assert kv.k[0][0, 0, :, 0].tolist() == [0, 0, 0, 0, 1, 2, 3, 4]
    assert _equal(kv.k[0], jkv.k[0]) and _equal(kv.v[0], jkv.v[0])
    assert kv.lengths.tolist() == [10] == np.asarray(jkv.lengths).tolist()


def _serve(eng, prompts, n_new):
    rids = [eng.submit(p, n_new, seed=31 + j, **(dict(temp=0.8, top_k=20) if j % 2 else {}))
            for j, p in enumerate(prompts)]
    done = {r.rid: r.out for r in eng.run()}
    return [done[r] for r in rids]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32kv", "int8kv"])
def test_engine_window_delta_on_off_streams_equal(models, both, kv_quant, paged):
    """The port's window-delta engine (its scan windows on the delta flow)
    gives the JAX Engine's streams at engine_window_delta=True, greedy and
    sampled, on each cache flavour, and the greedy streams of the strict
    engine. (The sampled requests are held against the JAX Engine only: on
    the int8 cache the delta attends the window's fresh rows in bf16 where
    the strict window reads them back int8, and request 1's sampled stream
    moves with it, in the JAX Engine alike.)"""
    jcfg, jp, tcfg, tp = models
    both("kv_quant", kv_quant)
    prompts = [[1, 2, 3], [9, 8], [5, 5, 5, 4], [7, 3, 2, 11]]
    pages = 12 if paged else None
    both("engine_window_delta", True)
    ref = _serve(JEngine(jllama, jcfg, jp, max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK,
                         paged_pages=pages), prompts, 12)
    outs = {}
    for delta in (True, False):
        both("engine_window_delta", delta)
        eng = Engine(tllama, tcfg, tp, max_batch=4, max_seq=MAX_SEQ, chunk_size=CHUNK,
                     device="cpu", paged_pages=pages)
        outs[delta] = _serve(eng, prompts, 12)
        assert any(k[8] == "delta" for k in eng.graphs.graphs) == delta
    assert outs[True] == ref
    assert outs[True][::2] == outs[False][::2]


def test_generate_and_decode_chunk_kv_quant_match_reference(models, both):
    """generate(kv_quant=True) equals the JAX generate(kv_quant=True);
    decode_chunk and decode_step on a quantized cache continue a prefill
    with the same tokens, on one captured step."""
    jcfg, jp, tcfg, tp = models
    prompt, n = [113, 7, 42, 200, 9, 77, 3], 12
    got = tllama.generate(tcfg, tp, prompt, n, max_seq=MAX_SEQ, device="cpu", kv_quant=True)
    assert got == jllama.generate(jcfg, jp, prompt, n, max_seq=MAX_SEQ, kv_quant=True)
    want = got[len(prompt) + 1:]
    kv = tllama.make_cache(tcfg, MAX_SEQ, device="cpu", quant=True)
    lg, kv = tllama.forward(tcfg, tp, torch.tensor(prompt), kv, 0)
    first = int(lg[-1].argmax())
    toks, kv, carry = tllama.decode_chunk(tcfg, tp, kv, torch.tensor([first, len(prompt)]),
                                          n - 1)
    assert kv.quantized and toks.tolist() == want
    kv = tllama.make_cache(tcfg, MAX_SEQ, device="cpu", quant=True)
    tllama.forward(tcfg, tp, torch.tensor(prompt), kv, 0)
    t, steps = torch.tensor([first]), []
    for i in range(4):
        t, kv = tllama.decode_step(tcfg, tp, t, kv, torch.tensor(len(prompt) + i,
                                                                 dtype=torch.int32))
        steps.append(int(t[0]))
    assert steps == want[:4]
    assert kv.k[0].dtype == torch.int8 and len(kv.graphs.graphs.graphs) == 1
