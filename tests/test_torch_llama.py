"""Port parity: the llama model end to end, against the JAX package.

Weights are carried across with params_from_numpy (Q4_K in the JAX kernel
layout, or dense f32), or loaded by both packages from one GGUF. Logits
meet tests/test_llama.py's bound (nmse < 1e-9); greedy streams are equal,
with prompts shorter than int8_min_m (K1 route) and longer (K3 route)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.gguf.format import GGUFWriter as JWriter
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu_torch.models import llama as tllama

from _torch_port import nmse, tiny_cfg, tiny_models

MAX_SEQ = 128


@pytest.fixture(scope="module")
def q4k_models():
    return tiny_models(GGMLType.Q4_K, seed=0)


def _logits_pair(jcfg, jp, tcfg, tp, toks):
    jkv = jllama.make_cache(jcfg, MAX_SEQ)
    ref, _ = jllama.forward(jcfg, jp, jnp.asarray(toks), jkv, jnp.int32(0))
    tkv = tllama.make_cache(tcfg, MAX_SEQ, device="cpu")
    got, tkv = tllama.forward(tcfg, tp, torch.from_numpy(toks.astype(np.int64)),
                              tkv, 0)
    assert tkv.length == len(toks)
    return got.numpy(), np.asarray(ref)


def test_logits_q4k(q4k_models):
    """Every matmul on the f32 route (K1) on both sides, with
    tests/test_llama.py's bound. The int8 route (K3) is held by
    test_generate_streams_equal's 70-token prompt: there XLA's CPU compiler
    fuses q·dsc' − dm' into one FMA inside the interpret-mode reference
    kernel, which flips a few int8 weight roundings (tests/test_torch_qmm.py),
    and such ulp-level differences flip activation roundings downstream, so
    its logits agree only within the int8 route's own error class."""
    toks = np.random.default_rng(7).integers(0, 256, 7).astype(np.int32)
    got, ref = _logits_pair(*q4k_models, toks)
    assert got.shape == ref.shape == (7, 256)
    assert nmse(got, ref) < 1e-9


def test_logits_f32():
    models = tiny_models(None, seed=1)
    toks = np.array([5, 17, 200, 3, 77, 129], np.int32)
    got, ref = _logits_pair(*models, toks)
    assert nmse(got, ref) < 1e-9


def test_incremental_matches_full(q4k_models):
    _, _, tcfg, tp = q4k_models
    toks = torch.tensor([9, 8, 7, 30, 12])
    full, _ = tllama.forward(tcfg, tp, toks, tllama.make_cache(tcfg, 32, device="cpu"), 0)
    kv = tllama.make_cache(tcfg, 32, device="cpu")
    rows = []
    for i in range(len(toks)):
        lg, kv = tllama.forward(tcfg, tp, toks[i:i + 1], kv, i)
        rows.append(lg[0])
    assert nmse(torch.stack(rows).numpy(), full.numpy()) < 1e-12


@pytest.mark.parametrize("plen", [12, 70])
def test_generate_streams_equal(q4k_models, plen):
    jcfg, jp, tcfg, tp = q4k_models
    prompt = [int(t) for t in np.random.default_rng(plen).integers(0, 256, plen)]
    ref = jllama.generate(jcfg, jp, prompt, 8, max_seq=MAX_SEQ)
    got = tllama.generate(tcfg, tp, prompt, 8, max_seq=MAX_SEQ, device="cpu")
    assert got == ref


def test_same_gguf_same_logits(tmp_path):
    """One GGUF (Q4_K matrices, f32 norms) loaded by both packages."""
    rng = np.random.default_rng(4)
    jcfg = tiny_cfg()
    path = tmp_path / "tiny.gguf"
    w = JWriter()
    A = "llama"
    for key, val in ((f"{A}.context_length", jcfg.n_ctx),
                     (f"{A}.embedding_length", jcfg.n_embd),
                     (f"{A}.attention.head_count", jcfg.n_head),
                     (f"{A}.attention.head_count_kv", jcfg.n_kv_head),
                     (f"{A}.block_count", jcfg.n_layer),
                     (f"{A}.feed_forward_length", jcfg.n_ff)):
        w.set(key, val)
    w.set("general.architecture", A)
    w.set(f"{A}.attention.layer_norm_rms_epsilon", 1e-5)
    D, FF, KVD = jcfg.n_embd, jcfg.n_ff, jcfg.n_kv_head * jcfg.head_dim

    def mat(name, r, c):
        w.add_array_tensor(name, (rng.standard_normal((r, c)) * 0.05).astype(np.float32),
                           GGMLType.Q4_K)

    mat("token_embd.weight", jcfg.n_vocab, D)
    mat("output.weight", jcfg.n_vocab, D)
    w.add_array_tensor("output_norm.weight", (1 + 0.1 * rng.standard_normal(D)).astype(np.float32))
    for i in range(jcfg.n_layer):
        for nm, r, c in (("attn_q", D, D), ("attn_k", KVD, D), ("attn_v", KVD, D),
                         ("attn_output", D, D), ("ffn_gate", FF, D),
                         ("ffn_up", FF, D), ("ffn_down", D, FF)):
            mat(f"blk.{i}.{nm}.weight", r, c)
        for nm in ("attn_norm", "ffn_norm"):
            w.add_array_tensor(f"blk.{i}.{nm}.weight",
                               (1 + 0.1 * rng.standard_normal(D)).astype(np.float32))
    w.write(path)
    jcfg2, jp = jllama.load(path)
    tcfg, tp = tllama.load(path, device="cpu")
    assert tcfg.n_layer == jcfg2.n_layer and tcfg.n_kv_head == jcfg2.n_kv_head
    assert "lm_head" in tp
    toks = np.array([1, 50, 3, 99, 7], np.int32)
    got, ref = _logits_pair(jcfg2, jp, tcfg, tp, toks)
    assert nmse(got, ref) < 1e-9
