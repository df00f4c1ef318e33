"""Port parity: GPT-J (models/gptj.py) against the JAX package's.

A tiny GPT-J at head dim 256 with rotary on n_rot = 64 of its dims (the
GPT-J-6B head), Q4_K matrices and a Q6_K head with a bias, made from a seed
with numpy and quantized by the reference's codecs; logits meet
tests/test_torch_llama.py's bound (nmse < 1e-9) on the f32 route and
dense; greedy streams equal the reference's on the f32 and int8 routes;
decode_step continues generate's stream; a GGUF from each package's
convert_gptj loads in both (head dim 64, n_rot 32 there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.models import convert as jconvert
from ggml_gfx906_tpu.models import gptj as jgptj
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import convert, gptj

from _torch_port import hf_gpt_state, jax_params_to_numpy, nmse, one_torch_thread  # noqa: F401

MAX_SEQ = 128
D, H, V, ROT, L = 512, 2, 256, 64, 2


def _cfg(mod):
    return mod.GPTJConfig(n_vocab=V, n_ctx=MAX_SEQ, n_embd=D, n_head=H, n_layer=L, n_rot=ROT)


def _jax_params(seed, quant: bool):
    """The JAX params of a tiny GPT-J: matrices ~N(0, 0.02) (Q4_K, and a
    Q6_K head, when quant), LayerNorm gains 1 + N(0, 0.1), biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)

    def vec(n, base=0.0, s=0.02):
        return jnp.asarray((base + rng.standard_normal(n) * s).astype(np.float32))

    def mat(r, c, qtype=GGMLType.Q4_K):
        a = (rng.standard_normal((r, c)) * 0.02).astype(np.float32)
        return JQuantTensor.quantize(qtype, a) if quant else jnp.asarray(a)

    p = {"wte": mat(V, D), "ln_f_g": vec(D, 1.0, 0.1), "ln_f_b": vec(D),
         "lm_head": mat(V, D, GGMLType.Q6_K), "lm_head_b": vec(V), "blocks": []}
    for _ in range(L):
        p["blocks"].append({"ln1_g": vec(D, 1.0, 0.1), "ln1_b": vec(D),
                            "wq": mat(D, D), "wk": mat(D, D), "wv": mat(D, D), "wo": mat(D, D),
                            "fc_in_w": mat(4 * D, D), "fc_in_b": vec(4 * D),
                            "fc_out_w": mat(D, 4 * D), "fc_out_b": vec(D)})
    return p


def _models(seed, quant=True):
    jp = _jax_params(seed, quant)
    return _cfg(jgptj), jp, _cfg(gptj), gptj.params_from_numpy(jax_params_to_numpy(jp),
                                                              device="cpu")


@pytest.fixture(scope="module")
def q4k():
    return _models(0)


def _logits(jcfg, jp, tcfg, tp, toks):
    ref, _ = jgptj.forward_jit(jcfg, jp, jnp.asarray(toks), jgptj.make_cache(jcfg, MAX_SEQ),
                               jnp.int32(0))
    got, kv = gptj.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                           gptj.make_cache(tcfg, MAX_SEQ, device="cpu"), 0)
    assert kv.length == len(toks)
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("quant", [True, False], ids=["q4_k", "dense"])
def test_logits(q4k, quant):
    models = q4k if quant else _models(1, quant=False)
    assert models[2].head_dim == 256 and models[2].n_rot == 64
    toks = np.random.default_rng(7).integers(0, V, 9).astype(np.int32)
    got, ref = _logits(*models, toks)
    assert got.shape == ref.shape == (9, V)
    assert nmse(got, ref) < 1e-9


@pytest.mark.parametrize("plen", [12, 70])
def test_generate_streams_equal(q4k, plen):
    jcfg, jp, tcfg, tp = q4k
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, V, plen)]
    ref = jgptj.generate(jcfg, jp, prompt, 8, max_seq=MAX_SEQ)
    assert gptj.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu") == ref


def test_decode_step_continues_generate(q4k):
    _, _, tcfg, tp = q4k
    prompt = torch.tensor([5, 9, 200, 31])
    kv = gptj.make_cache(tcfg, 64, device="cpu")
    logits, kv = gptj.forward(tcfg, tp, prompt, kv, 0)
    tok = logits[-1].argmax().reshape(1)
    out = [int(tok)]
    for _ in range(4):
        tok, kv = gptj.decode_step(tcfg, tp, tok, kv, kv.length)
        out.append(int(tok))
    assert prompt.tolist() + out == gptj.generate(tcfg, tp, prompt.tolist(), 5, max_seq=64,
                                                  device="cpu")


def test_no_batched_forward():
    """Like the reference's, the module has no forward_batch: the Engine
    cannot serve GPT-J (the CLI's serve says so, tests/test_torch_cli.py)."""
    assert not hasattr(gptj, "forward_batch") and not hasattr(jgptj, "forward_batch")


@pytest.mark.parametrize("ftype", [GGMLType.Q8_0, GGMLType.F32], ids=["q8_0", "f32"])
def test_gguf_from_both_converters(tmp_path, ftype):
    sd, hcfg = hf_gpt_state("gptj", seed=3)
    jconvert.convert_gptj(sd, hcfg, tmp_path / "ref.gguf", ftype=ftype)
    convert.convert_gptj(sd, hcfg, tmp_path / "port.gguf", ftype=ftype, device="cpu")
    assert (tmp_path / "ref.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()
    jcfg, jp = jgptj.load(tmp_path / "ref.gguf")
    tcfg, tp = gptj.load(tmp_path / "port.gguf", device="cpu")
    assert (tcfg.head_dim, tcfg.n_rot) == (64, 32)
    toks = np.random.default_rng(10).integers(0, 256, 11).astype(np.int32)
    ref, _ = jgptj.forward_jit(jcfg, jp, jnp.asarray(toks), jgptj.make_cache(jcfg, 64),
                               jnp.int32(0))
    got, _ = gptj.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                          gptj.make_cache(tcfg, 64, device="cpu"), 0)
    assert nmse(got.numpy(), np.asarray(ref)) < 1e-9
