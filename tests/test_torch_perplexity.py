"""Port parity: perplexity (models/perplexity.py). The same tiny models and
tokens go through the JAX perplexity_llama and the port's: equal n_tokens
and ppl within 2e-3 relative (the reference's own bound, tests/
test_perplexity.py:43), on a dense f32 model and on a Q4_K one whose
windows take the f32 route (n_ctx 32) and the int8 route (n_ctx 64); the
last window padded to n_ctx; warm-up 0."""
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.models import perplexity as jppl
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama
from ggml_gfx906_tpu_torch.models import perplexity as tppl

from _torch_port import jax_params_to_numpy, one_torch_thread, port_cfg, tiny_models  # noqa: F401


@pytest.fixture(scope="module")
def dense():
    cfg = jllama.LlamaConfig(n_vocab=96, n_ctx=64, n_embd=48, n_head=4, n_kv_head=2,
                             n_layer=2, n_ff=96)
    jp = jllama.random_params(cfg, seed=1)
    return cfg, jp, port_cfg(cfg), tllama.params_from_numpy(jax_params_to_numpy(jp),
                                                            device="cpu")


@pytest.fixture(scope="module")
def q4k():
    return tiny_models(GGMLType.Q4_K, seed=4, n_ctx=128)


def _check(jcfg, jp, tcfg, tp, toks, n_ctx, **kw):
    want = jppl.perplexity_llama(jcfg, jp, toks, n_ctx=n_ctx, **kw)
    got = tppl.perplexity_llama(tcfg, tp, toks, n_ctx=n_ctx, device="cpu", **kw)
    rel = abs(got["ppl"] - want["ppl"]) / want["ppl"]
    assert got["n_tokens"] == want["n_tokens"], (got, want)
    assert rel < 2e-3, f"ppl {got['ppl']} vs reference {want['ppl']}: relative distance {rel:.3e}"
    return got, want


@pytest.mark.parametrize("n_tok", [90, 65])
def test_dense_matches_reference(dense, n_tok):
    jcfg, jp, tcfg, tp = dense
    toks = np.random.default_rng(n_tok).integers(0, jcfg.n_vocab, n_tok).astype(np.int32)
    got, _ = _check(jcfg, jp, tcfg, tp, toks, 32)
    assert 0.3 * jcfg.n_vocab < got["ppl"] < 3.0 * jcfg.n_vocab


@pytest.mark.parametrize("n_ctx", [32, 64])
def test_q4_k_matches_reference_on_both_routes(q4k, n_ctx):
    """n_ctx 32 runs the f32 kernels' plain versions, n_ctx 64 (= int8_min_m)
    K3's plain int8 route, for every window."""
    jcfg, jp, tcfg, tp = q4k
    toks = np.random.default_rng(7).integers(0, 256, 3 * n_ctx - 5).astype(np.int32)
    _check(jcfg, jp, tcfg, tp, toks, n_ctx)


def test_last_window_padded_to_n_ctx(dense, monkeypatch):
    """Every window runs at M = n_ctx, the last one zero-padded and masked:
    a 90-token stream at n_ctx 32 gives windows of 32, 32 and 25 tokens, all
    run at 32 rows, counting 32 + (32 - 8) + (25 - 8) predictions (warm-up
    8); a 70-token one's third window, 5 tokens, is all warm-up and skipped."""
    jcfg, jp, tcfg, tp = dense
    seen = []
    fwd = tllama._forward

    def spy(cfg, params, tokens, kv, start):
        seen.append((tokens.shape[0], int(start), kv.max_seq))
        return fwd(cfg, params, tokens, kv, start)

    monkeypatch.setattr(tllama, "_forward", spy)
    toks = np.random.default_rng(3).integers(0, jcfg.n_vocab, 90).astype(np.int32)
    got, _ = _check(jcfg, jp, tcfg, tp, toks, 32)
    assert seen == [(32, 0, 32)] * 3
    assert got["n_tokens"] == 32 + (32 - 8) + (25 - 8)
    seen.clear()
    got, _ = _check(jcfg, jp, tcfg, tp, toks[:70], 32)
    assert len(seen) == 2 and got["n_tokens"] == 32 + 24


def test_warmup_zero_counts_every_prediction(dense):
    jcfg, jp, tcfg, tp = dense
    toks = np.random.default_rng(5).integers(0, jcfg.n_vocab, 77).astype(np.int32)
    got, _ = _check(jcfg, jp, tcfg, tp, toks, 32, warmup=0)
    assert got["n_tokens"] == 76


def test_needs_two_tokens(dense):
    _, _, tcfg, tp = dense
    with pytest.raises(ValueError):
        tppl.perplexity_llama(tcfg, tp, [1], n_ctx=32, device="cpu")


def test_window_nll_is_the_masked_log_softmax_sum():
    logits = torch.tensor([[0.0, 1.0, 2.0], [3.0, 0.0, -1.0]])
    nll, n = tppl._window_nll(lambda p, t: logits, None, torch.tensor([0, 1]),
                              torch.tensor([2, 0]), torch.tensor([1.0, 0.0]))
    assert float(n) == 1.0
    assert float(nll) == pytest.approx(-float(torch.log_softmax(logits[0], 0)[2]), rel=1e-6)
