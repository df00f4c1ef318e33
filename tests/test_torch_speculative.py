"""Port parity: speculative decoding (models/speculative.py). The same tiny
f32 and Q4_K models go through the JAX module and the port (its captured
steps are direct calls on the CPU): identical streams and per-step accept
counts for prompt lookup at k in {1, 4, 8} and for the model draft, the
prompt-lookup proposal itself on random histories, the capacity guard, and
the capture bookkeeping of the spec step under a stand-in torch.cuda."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.models import speculative as jspec
from ggml_gfx906_tpu.quant import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.models import speculative as tspec
from ggml_gfx906_tpu_torch.runtime.graphs import GraphCache

from _torch_port import jax_params_to_numpy, one_torch_thread, port_cfg  # noqa: F401

PROMPT = [3, 14, 15, 9, 2, 6]


def _toy(seed, quant):
    """(jax cfg, jax params, port cfg, port params): the reference test's toy
    model in f32, or a Q4_K one whose widths are multiples of 256."""
    if quant is None:
        cfg = jllama.LlamaConfig(n_vocab=160, n_ctx=256, n_embd=64, n_head=4, n_kv_head=2,
                                 n_layer=3, n_ff=128, compute_dtype=jnp.float32)
    else:
        cfg = jllama.LlamaConfig(n_vocab=256, n_ctx=256, n_embd=256, n_head=4, n_kv_head=2,
                                 n_layer=2, n_ff=512, compute_dtype=jnp.float32)
    jp = jllama.random_params(cfg, seed=seed, qtype=quant)
    return cfg, jp, port_cfg(cfg), tllama.params_from_numpy(jax_params_to_numpy(jp),
                                                            device="cpu")


# (seed, weights, lookup tokens, model-draft tokens)
MODELS = {"f32": (0, None, 40, 30), "q4_k": (1, GGMLType.Q4_K, 32, 12)}


@pytest.fixture(scope="module", params=list(MODELS))
def toy(request):
    seed, quant, n, n_draft = MODELS[request.param]
    jcfg, jp, tcfg, tp = _toy(seed, quant)
    ref = jllama.generate(jcfg, jp, PROMPT, n)
    assert tllama.generate(tcfg, tp, PROMPT, n, device="cpu") == ref
    return jcfg, jp, tcfg, tp, n, ref, n_draft


@pytest.mark.parametrize("k", [1, 4, 8])
def test_lookup_streams_and_accepts_equal_reference(toy, k):
    jcfg, jp, tcfg, tp, n, ref, _ = toy
    want, wstats = jspec.spec_generate(jcfg, jp, PROMPT, n, k=k, return_stats=True)
    got, stats = tspec.spec_generate(tcfg, tp, PROMPT, n, k=k, return_stats=True, device="cpu")
    assert got == want == ref
    assert stats == wstats


def test_lookup_accepts_on_repetitive_stream():
    """Random toy models fall into greedy cycles; once the stream repeats,
    prompt lookup accepts (the reference's test), with the reference's
    counts step by step."""
    jcfg, jp, tcfg, tp = _toy(1, None)
    ref = jllama.generate(jcfg, jp, PROMPT, 96)
    got, stats = tspec.spec_generate(tcfg, tp, PROMPT, 96, k=8, return_stats=True,
                                     device="cpu")
    _, wstats = jspec.spec_generate(jcfg, jp, PROMPT, 96, k=8, return_stats=True)
    assert got == ref and stats == wstats
    s = ref[len(PROMPT):]
    assert s[-24:-12] == s[-12:]          # this model's stream cycles
    assert stats["accept_rate"] > 0.5 and stats["spec_steps"] < 96, stats


def test_model_draft_full_accept_and_layer_skip(toy):
    """draft == the full model: every proposal is accepted (m == k); the
    layer-skip draft (weights shared) is exact whatever it proposes."""
    jcfg, jp, tcfg, tp, _, ref, n = toy
    got, stats = tspec.model_spec_generate(tcfg, tp, PROMPT, n, draft=(tcfg, tp), k=4,
                                           return_stats=True, device="cpu")
    _, wstats = jspec.model_spec_generate(jcfg, jp, PROMPT, n, draft=(jcfg, jp), k=4,
                                          return_stats=True)
    assert got == ref[:len(PROMPT) + n] and stats == wstats
    assert all(a == 4 for a in stats["accepted_per_step"]), stats
    got, stats = tspec.model_spec_generate(tcfg, tp, PROMPT, n, draft_layers=1, k=4,
                                           return_stats=True, device="cpu")
    _, wstats = jspec.model_spec_generate(jcfg, jp, PROMPT, n, draft_layers=1, k=4,
                                          return_stats=True)
    assert got == ref[:len(PROMPT) + n] and stats == wstats
    dcfg, dp = tspec.make_layer_draft(tcfg, tp, 1)
    assert dcfg.n_layer == 1 and dp["blocks"][0] is tp["blocks"][0] and dp["wte"] is tp["wte"]


def _lively(seed):
    """A toy model whose greedy stream does not lock onto one token (unit-
    variance weights, an untied head), so proposals are partly accepted."""
    cfg = jllama.LlamaConfig(n_vocab=160, n_ctx=256, n_embd=64, n_head=4, n_kv_head=2,
                             n_layer=3, n_ff=128, compute_dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    D, KVD = cfg.n_embd, cfg.n_kv_head * cfg.head_dim

    def m(r, c):
        return jnp.asarray((rng.standard_normal((r, c)) / np.sqrt(c)).astype(np.float32))

    one = jnp.ones((D,), jnp.float32)
    jp = {"wte": m(cfg.n_vocab, D), "lm_head": m(cfg.n_vocab, D), "out_norm": one,
          "blocks": [dict(attn_norm=one, ffn_norm=one, wq=m(D, D), wk=m(KVD, D), wv=m(KVD, D),
                          wo=m(D, D), w_gate=m(cfg.n_ff, D), w_up=m(cfg.n_ff, D),
                          w_down=m(D, cfg.n_ff)) for _ in range(cfg.n_layer)]}
    return cfg, jp, port_cfg(cfg), tllama.params_from_numpy(jax_params_to_numpy(jp),
                                                            device="cpu")


def test_partial_accepts_equal_reference():
    """Where proposals are partly rejected, every step's m equals the
    reference's, for prompt lookup and for the model draft. With the full
    model as its own draft a step after a full accept can reject: the
    draft's cache never receives its last proposal's row (the reference's
    model_spec_step feeds k tokens), and the port keeps that."""
    jcfg, jp, tcfg, tp = _lively(1)
    ref = jllama.generate(jcfg, jp, PROMPT, 30)
    got, stats = tspec.spec_generate(tcfg, tp, PROMPT, 30, k=4, return_stats=True,
                                     device="cpu")
    _, wstats = jspec.spec_generate(jcfg, jp, PROMPT, 30, k=4, return_stats=True)
    assert got == ref and stats == wstats
    assert 0 < stats["accept_rate"] < 1 and {0, 4} <= set(stats["accepted_per_step"])
    got, stats = tspec.model_spec_generate(tcfg, tp, PROMPT, 30, draft=(tcfg, tp), k=4,
                                           return_stats=True, device="cpu")
    _, wstats = jspec.model_spec_generate(jcfg, jp, PROMPT, 30, draft=(jcfg, jp), k=4,
                                          return_stats=True)
    assert got == ref and stats == wstats
    acc = stats["accepted_per_step"]
    assert acc[0] == 4 and acc[1] < 4


def test_capacity_guard():
    _, _, tcfg, tp = _toy(0, None)
    with pytest.raises(ValueError, match="max_seq"):
        tspec.spec_generate(tcfg, tp, PROMPT, 400, k=4, max_seq=256, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tspec.model_spec_generate(tcfg, tp, PROMPT, 250, k=4, max_seq=256, device="cpu")
    assert tspec.spec_generate(tcfg, tp, PROMPT, 0, device="cpu") == PROMPT


@pytest.mark.parametrize("k", [1, 3, 8])
def test_propose_ngram_equals_reference(k):
    """The device proposal against jnp's on seeded random histories with
    short alphabets (recurring bigrams, short and long periods) and none."""
    rng = np.random.default_rng(k)
    for trial in range(40):
        maxlen = 48
        hist = rng.integers(0, 2 + trial % 7, maxlen).astype(np.int32)
        L = int(rng.integers(2, maxlen - k))
        want = np.asarray(jspec._propose_ngram(jnp.asarray(hist), jnp.int32(L), k))
        got = tspec._propose_ngram(torch.from_numpy(hist.astype(np.int64)),
                                   torch.tensor([L]), k)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"L={L}")


class _Stream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


class _Graph:
    def replay(self):
        pass


def test_spec_graph_capture_bookkeeping(monkeypatch):
    """On the card the spec step is captured on the cache's graph cache
    after the history and L are set (the capture's warm-up runs one step,
    which must read a valid L), with hist, L and the step index restored
    after the warm-up; one graph per (k, window) per cache, and a new cache
    captures its own. A stand-in for torch.cuda's streams and graphs runs
    the capture's Python here."""
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    _, _, tcfg, tp = _toy(0, None)
    make_cache = tllama.make_cache

    def cache_with_card_graphs(*a, **kw):
        kv = make_cache(*a, **kw)
        kv.graphs = tllama._Decoder(torch.device("cpu"))
        kv.graphs.graphs = GraphCache(torch.device("cuda"))
        return kv

    monkeypatch.setattr(tllama, "make_cache", cache_with_card_graphs)
    seen = []
    step = tspec.spec_step

    def spy(cfg, k, params, carry):
        hist, L, _ = carry
        seen.append((int(L), hist[:int(L)].tolist()))
        return step(cfg, k, params, carry)

    monkeypatch.setattr(tspec, "spec_step", spy)
    P = len(PROMPT)
    kv, g, b, first = tspec._prefilled(tcfg, tp, PROMPT, 4, 64, 8, torch.device("cpu"))
    # warm-up, then the capture from the restored state: both at L = P + 1
    assert [L for L, _ in seen] == [P + 1, P + 1]
    assert seen[0][1] == seen[1][1] == PROMPT + [int(first.numpy()[0])]
    cache = kv.graphs.graphs
    assert g.graph is not None and list(cache.graphs) == [next(iter(cache.graphs))]
    key = next(iter(cache.graphs))
    assert key[:3] == ("spec", 4, 8) and b["hist"].data_ptr() in key
    assert tspec._spec_graph(tcfg, 4, tp, kv, b) is g and len(seen) == 2
    kv2, g2, _, _ = tspec._prefilled(tcfg, tp, PROMPT, 4, 64, 8, torch.device("cpu"))
    assert g2 is not g and kv2.graphs is not kv.graphs and len(seen) == 4
    tspec._prefilled(tcfg, tp, PROMPT, 2, 64, 8, torch.device("cpu"))
    assert len(seen) == 6
