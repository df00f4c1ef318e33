"""Port parity: the layer offload split (models/offload.py, the `-ngl`
analogue) with both sides on the CPU, against the single-device forward
(nmse < 1e-9, the bound of the reference's tests/test_pp.py:53) and the
reference's own split over two virtual CPU devices; an expert llama split
alike; auto_split's choice against the reference's on the same budget."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.models import moe as jmoe
from ggml_gfx906_tpu.models import offload as joffload
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama, moe, offload

from _torch_port import jax_params_to_numpy, nmse, port_cfg, one_torch_thread  # noqa: F401

JCFG = jllama.LlamaConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_kv_head=2,
                          n_layer=4, n_ff=512)


@pytest.fixture(scope="module")
def q4k():
    jp = jllama.random_params(JCFG, seed=2, qtype=GGMLType.Q4_K)
    jp["lm_head"] = jp["wte"]          # untied: the host side holds the head
    return jp, llama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")


def _single(cfg, tp, toks, kv, start):
    return llama.forward(cfg, tp, torch.tensor(toks), kv, start)


def test_split_matches_single_device_and_reference(q4k):
    """Layers [0, 2) on one side, [2, 4) and the head on the other: the
    prefill and an incremental step continuing on the same split caches
    equal the single-device forward and the reference's split."""
    jp, tp = q4k
    cfg = port_cfg(JCFG)
    split = offload.OffloadSplit.build(cfg, tp, n_device_layers=2, device="cpu")
    assert split.n_dev == 2 and len(split.host_params["blocks"]) == 2
    kvs = split.make_caches(32)
    assert (kvs[0].n_layer, kvs[1].n_layer) == (2, 2)
    toks = [3, 9, 27, 81]
    got, kvs = split.forward(toks, kvs, 0)
    kv = llama.make_cache(cfg, 32, device="cpu")
    ref, kv = _single(cfg, tp, toks, kv, 0)
    assert nmse(got.numpy(), ref.numpy()) < 1e-9
    got2, kvs = split.forward([5], kvs, 4)
    ref2, _ = _single(cfg, tp, [5], kv, 4)
    assert nmse(got2.numpy(), ref2.numpy()) < 1e-9
    assert kvs[0].length == kvs[1].length == 5

    devs = jax.devices()
    jsplit = joffload.OffloadSplit.build(JCFG, jp, n_device_layers=2, device=devs[0],
                                         host_device=devs[1])
    jgot, _ = jsplit.forward(jnp.asarray(toks, jnp.int32), jsplit.make_caches(32), jnp.int32(0))
    assert nmse(got.numpy(), np.asarray(jgot)) < 1e-9


@pytest.mark.parametrize("n_dev", [0, 1, 3])
def test_split_points(q4k, n_dev):
    """Every split point gives the single-device logits; n_dev 0 runs the
    embedding alone on the device side."""
    _, tp = q4k
    cfg = port_cfg(JCFG)
    split = offload.OffloadSplit.build(cfg, tp, n_device_layers=n_dev, device="cpu")
    toks = [7, 1, 250, 33, 60]
    got, _ = split.forward(toks, split.make_caches(16), 0)
    ref, _ = _single(cfg, tp, toks, llama.make_cache(cfg, 16, device="cpu"), 0)
    assert nmse(got.numpy(), ref.numpy()) < 1e-9


def test_tied_head_needs_lm_head(q4k):
    _, tp = q4k
    tied = {k: v for k, v in tp.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        offload.OffloadSplit.build(port_cfg(JCFG), tied, 2, device="cpu")


def test_expert_llama_split():
    """An expert llama split at layer 1 of 2 against moe.forward."""
    jcfg = jmoe.MoEConfig(n_vocab=256, n_ctx=64, n_embd=256, n_head=4, n_kv_head=2,
                          n_layer=2, n_ff=512, n_expert=4, n_expert_used=2)
    cfg = moe.MoEConfig(**{f: getattr(jcfg, f) for f in (
        "n_vocab", "n_ctx", "n_embd", "n_head", "n_kv_head", "n_layer", "n_ff", "n_expert",
        "n_expert_used")})
    tp = moe.random_params(cfg, seed=5, qtype=GGMLType.Q4_K, device="cpu")
    tp["lm_head"] = tp["wte"]
    split = offload.OffloadSplit.build(cfg, tp, 1, device="cpu", ffn=moe.block_ffn(cfg))
    toks = [4, 8, 15, 16, 23, 42]
    got, _ = split.forward(toks, split.make_caches(16), 0)
    ref, _ = moe.forward(cfg, tp, torch.tensor(toks), moe.make_cache(cfg, 16, device="cpu"), 0)
    assert nmse(got.numpy(), ref.numpy()) < 1e-9


def test_auto_split_matches_reference():
    """Dense params (the same bytes in both packages): the same layer count
    from the same budgets, and the tree sizes equal."""
    jp = jllama.random_params(JCFG, seed=3)
    tp = llama.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    cfg = port_cfg(JCFG)
    assert offload._tree_bytes(tp["blocks"][0]) == joffload._tree_bytes(jp["blocks"][0])
    per_layer = offload._tree_bytes(tp["blocks"][0]) + 2 * 64 * 2 * 64 * 4
    wte = offload._tree_bytes(tp["wte"])
    for budget in (wte, wte + 2 * per_layer + per_layer // 2, 10 ** 12):
        want = joffload.auto_split(JCFG, jp, 64, budget_bytes=budget, headroom=1.0)
        assert offload.auto_split(cfg, tp, 64, device="cpu", budget_bytes=budget,
                                  headroom=1.0) == want
    assert want == JCFG.n_layer
    with pytest.raises(ValueError, match="budget_bytes"):
        offload.auto_split(cfg, tp, 64, device="cpu")
