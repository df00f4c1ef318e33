"""Port parity: GPT-2 (models/gpt2.py) and perplexity_gpt2 against the JAX
package's.

random_params gives the reference's blocks from the same seed (the codecs
are byte-identical); logits meet tests/test_torch_llama.py's bound (nmse <
1e-9) on the f32 route (Q4_K matrices, head dim 64) and dense; greedy
streams (the f32 and int8 routes) and the
Engine's streams equal the reference's; forward_train, save_gguf and
convert_gpt2 round trips and perplexity_gpt2 against the reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import convert as jconvert
from ggml_gfx906_tpu.models import gpt2 as jgpt2
from ggml_gfx906_tpu.models import perplexity as jppl
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.models import convert, gpt2, perplexity
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import hf_gpt_state, jax_params_to_numpy, nmse, one_torch_thread  # noqa: F401

MAX_SEQ = 128


def _cfgs():
    j = jgpt2.GPT2Config(n_vocab=256, n_ctx=MAX_SEQ, n_embd=256, n_head=4, n_layer=2)
    return j, gpt2.GPT2Config(n_vocab=256, n_ctx=MAX_SEQ, n_embd=256, n_head=4, n_layer=2)


def _models(qtype, seed):
    jcfg, tcfg = _cfgs()
    jp = jgpt2.random_params(jcfg, seed=seed, qtype=qtype)
    return jcfg, jp, tcfg, gpt2.params_from_numpy(jax_params_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def q4k():
    return _models(GGMLType.Q4_K, 0)


def _logits(jcfg, jp, tcfg, tp, toks):
    ref, _ = jgpt2.forward_jit(jcfg, jp, jnp.asarray(toks), jgpt2.make_cache(jcfg, MAX_SEQ),
                               jnp.int32(0))
    got, kv = gpt2.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                           gpt2.make_cache(tcfg, MAX_SEQ, device="cpu"), 0)
    assert kv.length == len(toks)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, None], ids=["q4_k", "dense"])
def test_random_params_and_logits(q4k, qtype):
    """The port's random_params equals the reference's carried across
    (blocks bit for bit); logits at nmse < 1e-9."""
    models = q4k if qtype else _models(None, 0)
    jcfg, jp, tcfg, tp = models
    own = gpt2.random_params(tcfg, seed=0, qtype=qtype, device="cpu")
    for a, b in zip(_leaves(own), _leaves(tp)):
        if isinstance(a, QuantTensor):
            assert a.qtype == b.qtype and all(torch.equal(a.fields[f], b.fields[f])
                                              for f in a.fields)
        else:
            assert torch.equal(a, b)
    if qtype:
        assert isinstance(tp["blocks"][0]["qkv_w"], QuantTensor)
    toks = np.random.default_rng(7).integers(0, 256, 12).astype(np.int32)
    got, ref = _logits(*models, toks)
    assert got.shape == ref.shape == (12, 256)
    assert nmse(got, ref) < 1e-9


def _leaves(p):
    out = [p[k] for k in ("wte", "wpe", "ln_f_g", "ln_f_b")]
    for b in p["blocks"]:
        out += [b[k] for k in sorted(b)]
    return out


@pytest.mark.parametrize("plen", [12, 70])
def test_generate_streams_equal(q4k, plen):
    """12 tokens on the f32 route, 70 on the int8 route (K3's plain version)
    for the Q4_K matrices, on both sides."""
    jcfg, jp, tcfg, tp = q4k
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, 256, plen)]
    ref = jgpt2.generate(jcfg, jp, prompt, 8, max_seq=MAX_SEQ)
    assert gpt2.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu") == ref


def test_engine_matches_reference_engine_and_generate(q4k):
    """The same requests through the JAX Engine and the port's (window delta
    off, int8_min_m = 0 on both sides): equal streams, each equal to the
    port's generate."""
    jcfg, jp, tcfg, tp = q4k
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (9, 40, 3)]
    for c in (jconfig, tconfig):
        c.set("engine_window_delta", False)
        c.set("int8_min_m", 0)
    try:
        def run(eng):
            rids = [eng.submit(p, 5) for p in prompts]
            done = {r.rid: r.out for r in eng.run()}
            return [done[r] for r in rids]

        ref = run(JEngine(jgpt2, jcfg, jp, max_batch=3, max_seq=MAX_SEQ, chunk_size=32))
        got = run(Engine(gpt2, tcfg, tp, max_batch=3, max_seq=MAX_SEQ, chunk_size=32,
                         device="cpu"))
        single = [gpt2.generate(tcfg, tp, p, 5, max_seq=MAX_SEQ, device="cpu")[len(p):]
                  for p in prompts]
    finally:
        for c in (jconfig, tconfig):
            c.unset("engine_window_delta")
            c.unset("int8_min_m")
    assert got == ref == single


@pytest.mark.parametrize("window_delta", [False, True], ids=["strict", "delta"])
def test_engine_to_n_ctx_matches_reference_engine(q4k, window_delta):
    """Requests that reach max_seq = n_ctx (the rows of the position table)
    at the default harvest depth: the Engine steps a finished slot on to
    the end of its window, past n_ctx, where both packages read the table's
    last row. Streams equal the JAX Engine's, strict and window delta."""
    jcfg, jp, tcfg, tp = q4k
    rng = np.random.default_rng(12)
    reqs = [([int(t) for t in rng.integers(1, 256, 100)], MAX_SEQ - 100),
            ([int(t) for t in rng.integers(1, 256, 5)], 20)]
    for c in (jconfig, tconfig):
        c.set("engine_window_delta", window_delta)
        c.set("int8_min_m", 0)
    try:
        def run(eng):
            rids = [eng.submit(p, n) for p, n in reqs]
            done = {r.rid: r.out for r in eng.run()}
            return [done[r] for r in rids]

        ref = run(JEngine(jgpt2, jcfg, jp, max_batch=2, max_seq=MAX_SEQ, chunk_size=32))
        got = run(Engine(gpt2, tcfg, tp, max_batch=2, max_seq=MAX_SEQ, chunk_size=32,
                         device="cpu"))
    finally:
        for c in (jconfig, tconfig):
            c.unset("engine_window_delta")
            c.unset("int8_min_m")
    assert [len(o) for o in got] == [n for _, n in reqs]
    assert got == ref


def test_positions_past_n_ctx_read_the_last_row(q4k):
    """forward and forward_train at positions past n_ctx read the position
    table's last row, as the reference's gather clamps (forward_batch is
    held by the Engine test above). forward_train's 132 rows run with
    int8_min_m = 0 on both sides: the f32 route, whose logits meet the
    nmse bound."""
    jcfg, jp, tcfg, tp = q4k
    toks = np.array([3, 77, 140], np.int32)
    start = MAX_SEQ - 1
    jkv = jgpt2.make_cache(jcfg, MAX_SEQ + 8)
    ref, _ = jgpt2.forward_jit(jcfg, jp, jnp.asarray(toks), jkv, jnp.int32(start))
    got, _ = gpt2.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                          gpt2.make_cache(tcfg, MAX_SEQ + 8, device="cpu"), start)
    assert nmse(got.numpy(), np.asarray(ref)) < 1e-9
    long = np.random.default_rng(13).integers(0, 256, (1, MAX_SEQ + 4)).astype(np.int32)
    for c in (jconfig, tconfig):
        c.set("int8_min_m", 0)
    try:
        ref = np.asarray(jax.jit(jgpt2.forward_train, static_argnums=0)(jcfg, jp,
                                                                         jnp.asarray(long)))
        got = gpt2.forward_train(tcfg, tp, torch.from_numpy(long.astype(np.int64)))
    finally:
        for c in (jconfig, tconfig):
            c.unset("int8_min_m")
    assert got.shape == (1, MAX_SEQ + 4, 256)
    assert nmse(got.numpy(), ref) < 1e-9


def test_decode_step_and_forward_train(q4k):
    """decode_step (the captured step; a direct call on the CPU) continues
    generate's stream; forward_train (flash_attn_ext + causal_mask, no
    cache) against the reference's, and against the cached forward."""
    jcfg, jp, tcfg, tp = q4k
    prompt = torch.tensor([5, 9, 200, 31])
    kv = gpt2.make_cache(tcfg, 64, device="cpu")
    logits, kv = gpt2.forward(tcfg, tp, prompt, kv, 0)
    tok = logits[-1].argmax().reshape(1)
    out = [int(tok)]
    for _ in range(4):
        tok, kv = gpt2.decode_step(tcfg, tp, tok, kv, kv.length)
        out.append(int(tok))
    assert prompt.tolist() + out == gpt2.generate(tcfg, tp, prompt.tolist(), 5, max_seq=64,
                                                  device="cpu")
    toks = np.random.default_rng(8).integers(0, 256, (2, 10)).astype(np.int32)
    ref = np.asarray(jax.jit(jgpt2.forward_train, static_argnums=0)(jcfg, jp, jnp.asarray(toks)))
    got = gpt2.forward_train(tcfg, tp, torch.from_numpy(toks.astype(np.int64)))
    assert nmse(got.numpy(), ref) < 1e-9
    one, _ = gpt2.forward(tcfg, tp, torch.from_numpy(toks[1].astype(np.int64)),
                          gpt2.make_cache(tcfg, 16, device="cpu"), 0)
    assert nmse(got[1].numpy(), one.numpy()) < 1e-12


def test_save_gguf_round_trip(tmp_path):
    """Dense params saved by the port (Q4_K where rows are whole blocks),
    loaded by both packages: the same logits."""
    jcfg, jp, tcfg, tp = _models(None, 3)
    gpt2.save_gguf(tcfg, tp, tmp_path / "g.gguf", qtype=GGMLType.Q4_K)
    jcfg2, jq = jgpt2.load(tmp_path / "g.gguf")
    tcfg2, tq = gpt2.load(tmp_path / "g.gguf", device="cpu")
    assert (tcfg2.n_layer, tcfg2.n_embd) == (2, 256)
    assert isinstance(tq["blocks"][1]["up_w"], QuantTensor)
    toks = np.random.default_rng(9).integers(0, 256, 6).astype(np.int32)
    got, ref = _logits(jcfg2, jq, tcfg2, tq, toks)
    assert nmse(got, ref) < 1e-9


@pytest.mark.parametrize("ftype", [GGMLType.Q8_0, GGMLType.F32], ids=["q8_0", "f32"])
def test_gguf_from_both_converters(tmp_path, ftype):
    sd, hcfg = hf_gpt_state("gpt2", seed=2)
    jconvert.convert_gpt2(sd, hcfg, tmp_path / "ref.gguf", ftype=ftype)
    convert.convert_gpt2(sd, hcfg, tmp_path / "port.gguf", ftype=ftype, device="cpu")
    assert (tmp_path / "ref.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()
    jcfg, jp = jgpt2.load(tmp_path / "ref.gguf")
    tcfg, tp = gpt2.load(tmp_path / "port.gguf", device="cpu")
    toks = np.random.default_rng(10).integers(0, 256, 11).astype(np.int32)
    got, ref = _logits(jcfg, jp, tcfg, tp, toks)
    assert nmse(got, ref) < 1e-9


def test_perplexity_gpt2(q4k):
    """perplexity_gpt2 over 90 tokens at n_ctx 32 (the padded last window
    included) within 2e-3 relative of the reference's, as
    tests/test_torch_perplexity.py holds perplexity_llama."""
    jcfg, jp, tcfg, tp = q4k
    ids = np.random.default_rng(11).integers(0, 256, 90)
    ref = jppl.perplexity_gpt2(jcfg, jp, ids, n_ctx=32)
    got = perplexity.perplexity_gpt2(tcfg, tp, ids, n_ctx=32, device="cpu")
    assert got["n_tokens"] == ref["n_tokens"]
    assert abs(got["nll"] - ref["nll"]) / abs(ref["nll"]) < 2e-3
