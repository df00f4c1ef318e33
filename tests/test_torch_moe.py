"""Port parity: the Mixtral-class expert llama (models/moe.py) against the
JAX package's.

The same seeded weights go through both packages (the JAX random_params
carried across by params_from_numpy, Q4_K experts in its kernel layout, or
dense (E, N, K) experts). Logits meet tests/test_torch_llama.py's bound
(nmse < 1e-9) on the f32 route, with the experts each token selects
identical on both sides; greedy streams are equal with the experts on K1's
route (C = T·U < 64) and on K3's (C >= 64); the Engine's streams equal
the JAX Engine's and the port's own generate; decode_step equals the
eager step; a GGUF from each package's convert_mixtral loads in both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.gguf import GGUFReader as JReader
from ggml_gfx906_tpu.models import convert as jconvert
from ggml_gfx906_tpu.models import moe as jmoe
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.models import convert, moe
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import hf_llama_state, jax_params_to_numpy, nmse, one_torch_thread  # noqa: F401

MAX_SEQ = 128


def _cfgs(n_expert=4):
    j = jmoe.MoEConfig(n_vocab=256, n_ctx=MAX_SEQ, n_embd=256, n_head=4, n_kv_head=2,
                       n_layer=2, n_ff=512, n_expert=n_expert, n_expert_used=2)
    t = moe.MoEConfig(**{f: getattr(j, f) for f in (
        "n_vocab", "n_ctx", "n_embd", "n_head", "n_kv_head", "n_layer", "n_ff", "n_expert",
        "n_expert_used", "rms_eps", "rope_base", "rope_freq_scale")})
    return j, t


def _models(qtype, seed):
    jcfg, tcfg = _cfgs()
    jp = jmoe.random_params(jcfg, seed=seed, qtype=qtype)
    return jcfg, jp, tcfg, moe.params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def q4k():
    return _models(GGMLType.Q4_K, 0)


def _selections(monkeypatch):
    """Record the expert ids each package's router picks, layer by layer."""
    picked = {"jax": [], "port": []}
    real_top_k, real_route = jax.lax.top_k, moe.route

    def jax_top_k(x, k):      # traced under jit: the ids come back by callback
        v, i = real_top_k(x, k)
        jax.debug.callback(lambda a: picked["jax"].append(np.asarray(a)), i, ordered=True)
        return v, i

    def port_route(cfg, blk, h2):
        w, i = real_route(cfg, blk, h2)
        picked["port"].append(i.numpy())
        return w, i

    monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
    monkeypatch.setattr(moe, "route", port_route)
    return picked


def _logits(jcfg, jp, tcfg, tp, toks):
    """(port logits, JAX logits) of one prefill; the reference runs under a
    jit of its own (traced afresh, so a patched top_k is traced in)."""
    ref, _ = jax.jit(lambda p, t, kv: jmoe.forward(jcfg, p, t, kv, jnp.int32(0)))(
        jp, jnp.asarray(toks), jmoe.make_cache(jcfg, MAX_SEQ))
    got, kv = moe.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                          moe.make_cache(tcfg, MAX_SEQ, device="cpu"), 0)
    assert kv.length == len(toks)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, None], ids=["q4_k", "dense"])
def test_logits_and_selected_experts(q4k, monkeypatch, qtype):
    """Q4_K experts through K1's plain version (C = 14), or dense (E, N, K)
    experts: logits at nmse < 1e-9, the same experts selected for every
    token in every layer."""
    models = q4k if qtype is not None else _models(None, 1)
    if qtype is not None:
        assert all(isinstance(w, QuantTensor) for w in models[3]["blocks"][0]["gate_exps"])
    else:
        assert models[3]["blocks"][0]["gate_exps"].shape == (4, 512, 256)
    picked = _selections(monkeypatch)
    toks = np.random.default_rng(7).integers(0, 256, 7).astype(np.int32)
    got, ref = _logits(*models, toks)
    assert got.shape == ref.shape == (7, 256)
    assert nmse(got, ref) < 1e-9
    assert len(picked["jax"]) == len(picked["port"]) == 2
    for a, b in zip(picked["jax"], picked["port"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("plen", [12, 40])
def test_generate_streams_equal(q4k, plen):
    """12-token prompt: every product on the f32 route; 40 tokens: the
    experts' capacity buffers hold C = 80 rows, so their prefill products
    take the int8 route (K3's plain version) on both sides."""
    jcfg, jp, tcfg, tp = q4k
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, 256, plen)]
    ref = jmoe.generate(jcfg, jp, prompt, 8, max_seq=MAX_SEQ)
    got = moe.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu")
    assert got == ref


def test_engine_matches_reference_engine_and_generate(q4k):
    """The same requests through the JAX Engine and the port's (window delta
    off on both sides, int8_min_m = 0 so that floods and single prefills
    run one route): equal streams, each equal to the port's generate."""
    jcfg, jp, tcfg, tp = q4k
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (9, 40, 3)]
    for c in (jconfig, tconfig):
        c.set("engine_window_delta", False)
        c.set("int8_min_m", 0)
    try:
        def run(eng):
            rids = [eng.submit(p, 5) for p in prompts]
            done = {r.rid: r.out for r in eng.run()}
            return [done[r] for r in rids]

        ref = run(JEngine(jmoe, jcfg, jp, max_batch=3, max_seq=MAX_SEQ, chunk_size=32))
        got = run(Engine(moe, tcfg, tp, max_batch=3, max_seq=MAX_SEQ, chunk_size=32,
                         device="cpu"))
        single = [moe.generate(tcfg, tp, p, 5, max_seq=MAX_SEQ, device="cpu")[len(p):]
                  for p in prompts]
    finally:
        for c in (jconfig, tconfig):
            c.unset("engine_window_delta")
            c.unset("int8_min_m")
    assert got == ref == single


def test_decode_step_equals_eager(q4k):
    _, _, tcfg, tp = q4k
    prompt = torch.tensor([5, 9, 200, 31])
    kv = moe.make_cache(tcfg, 64, device="cpu")
    logits, kv = moe.forward(tcfg, tp, prompt, kv, 0)
    tok = logits[-1].argmax().reshape(1)
    eager = moe.generate(tcfg, tp, prompt.tolist(), 5, max_seq=64, device="cpu")
    out = [int(tok)]
    for _ in range(4):
        tok, kv = moe.decode_step(tcfg, tp, tok, kv, kv.length)
        out.append(int(tok))
    assert prompt.tolist() + out == eager


@pytest.mark.parametrize("ftype", [GGMLType.Q4_K, GGMLType.F32], ids=["q4_k", "f32"])
def test_gguf_from_both_converters(tmp_path, monkeypatch, ftype):
    """A Mixtral state dict through each package's convert_mixtral: the
    files are equal, and loaded by both packages (stacked 3-D expert
    tensors split into per-expert weights) they give the same logits."""
    sd, hcfg = hf_llama_state(seed=4, experts=4)
    # the reference's load splits a quantized stack's blocks as (E·n_out, nb)
    # rows (:234-238), which its reader gives as (E, n_out, nb): handed over
    # flattened here
    real_blocks = JReader.tensor_blocks
    monkeypatch.setattr(JReader, "tensor_blocks",
                        lambda self, name: (lambda b: b.reshape(-1, b.shape[-1]))(
                            real_blocks(self, name)))
    jconvert.convert_mixtral(sd, hcfg, tmp_path / "ref.gguf", ftype=ftype)
    convert.convert_mixtral(sd, hcfg, tmp_path / "port.gguf", ftype=ftype, device="cpu")
    assert (tmp_path / "ref.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()
    jcfg, jp = jmoe.load(tmp_path / "ref.gguf")
    tcfg, tp = moe.load(tmp_path / "port.gguf", device="cpu")
    assert (tcfg.n_expert, tcfg.n_expert_used, tcfg.n_layer) == (4, 2, 2)
    exps = tp["blocks"][1]["down_exps"]
    if ftype == GGMLType.Q4_K:
        assert len(exps) == 4 and all(e.shape == (256, 512) for e in exps)
    else:
        assert exps.shape == (4, 256, 512)
    toks = np.random.default_rng(5).integers(0, 256, 9).astype(np.int32)
    got, ref = _logits(jcfg, jp, tcfg, tp, toks)
    assert nmse(got, ref) < 1e-9
