"""Mixtral-class mixture-of-experts llama — the port of
ggml_gfx906_tpu/models/moe.py.

The attention stack is models/llama.py's; the FFN is a softmax top-k router
and ops.mul_mat_id over per-expert weights (each a QuantTensor on its
type's kernels, or dense), GShard capacity dispatch inside (ops/
recurrent.py). Every expert runs on its C = T·U capacity buffer each step,
an empty one too, as in the reference.

GGUF schema (llama.cpp's Mixtral convention): architecture llama with
llama.expert_count / llama.expert_used_count, the router blk.N.
ffn_gate_inp.weight (E, D) and the stacked experts blk.N.ffn_{gate,up,
down}_exps.weight (E, n_out, K), split on load into E per-expert tensors.

The engine-facing surface (forward, forward_batch with window_delta,
make_cache) is the llama module's, so runtime/engine.py serves it
unchanged. Entry points (`load`, `params_from_numpy`, `random_params`,
`generate`) run on the card unless device="cpu" is passed; `decode_step`
replays a captured graph as llama.decode_step does.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import ops
from ..gguf import GGUFReader
from ..ops.quantized import QuantTensor, apply_weights_layout
from ..quant.types import GGMLType, TYPE_TRAITS
from ..runtime.kv_cache import KVCache
from ..utils import autotune, config
from ..utils.device import resolve
from . import llama as _llama

ARCH = "llama"    # llama.cpp's convention: a Mixtral is arch llama + experts


@dataclass(frozen=True)
class MoEConfig:
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_head: int
    n_kv_head: int
    n_layer: int
    n_ff: int
    n_expert: int
    n_expert_used: int
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_freq_scale: float = 1.0
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_rot(self) -> int:
        return self.head_dim


def route(cfg: MoEConfig, blk: dict, h2: torch.Tensor):
    """The router: h2 (T, D) → (weights (T, U) f32 normalized over the
    chosen experts, expert ids (T, U)). Its product is dense f32, each
    logit's D products summed by row_sum: a cuBLAS matmul's order of
    additions depends on T, and a router whose bits change with the batch
    made the engine's streams differ from generate's on the card (the
    bf16 residual and the int8 activations amplify a last-bit change).
    Softmax and the sums go through row_sum too; top-k breaks ties lower
    index first, as jax.lax.top_k does."""
    logits = ops.sum_rows(h2.float()[:, None, :] * blk["gate_inp"].float()[None])[..., 0]
    probs = ops.soft_max_ext(logits[None])[0]
    w, idx = ops.top_k(probs, cfg.n_expert_used)
    return w / ops.sum_rows(w), idx


def _moe_ffn(cfg: MoEConfig, blk: dict, h2: torch.Tensor) -> torch.Tensor:
    """h2 (T, D) → (T, D): silu(gate)·up → down per routed expert through
    mul_mat_id, summed with the router's weights (HF Mixtral with
    norm_topk_prob, llama.cpp's build_moe_ffn)."""
    T, D = h2.shape
    U = cfg.n_expert_used
    w, idx = route(cfg, blk, h2)
    xr = h2[:, None, :].expand(T, U, D)
    g = ops.mul_mat_id(blk["gate_exps"], xr, idx)                      # (T, U, FF)
    u = ops.mul_mat_id(blk["up_exps"], xr, idx)
    act = (ops.silu(g) * u).to(h2.dtype)
    d = ops.mul_mat_id(blk["down_exps"], act, idx)                     # (T, U, D)
    wd = w.to(d.dtype)
    out = d[:, 0] * wd[:, 0, None]
    for j in range(1, U):
        out = out + d[:, j] * wd[:, j, None]
    return out.to(h2.dtype)


def block_ffn(cfg: MoEConfig):
    """The residual FFN sublayer of llama._layers / forward_batch for an
    expert block: x + experts(rms_norm(x)), over any leading shape.
    tp_group is taken and not used: parallel/tp.py's rules leave the router
    and the experts replicated, so every rank computes the whole sublayer
    (the reference's forward_batch takes tp_axis and adds nothing over it,
    :131-171); expert parallelism is parallel/ep.py."""
    def ffn(blk, x, eps, tp_group=None):
        h2 = _llama._rms(x, blk["ffn_norm"], eps)
        return x + _moe_ffn(cfg, blk, h2.reshape(-1, x.shape[-1])).reshape(x.shape)
    return ffn


def _forward(cfg: MoEConfig, params: dict, tokens: torch.Tensor, kv: KVCache,
             start) -> torch.Tensor:
    return _llama._forward(cfg, params, tokens, kv, start, ffn=block_ffn(cfg))


def forward(cfg: MoEConfig, params: dict, tokens: torch.Tensor, kv: KVCache,
            start) -> tuple[torch.Tensor, KVCache]:
    """tokens (S,) at positions [start, start+S) → (logits (S, V) f32, kv)."""
    return _forward(cfg, params, tokens, kv, start), kv.advance(tokens.shape[0])


def forward_batch(cfg: MoEConfig, params: dict, tokens: torch.Tensor, kv,
                  start: torch.Tensor, attn_window: int | None = None,
                  window_delta=None):
    """Batched serving forward, llama.forward_batch's contract (window
    delta included) with the expert FFN."""
    return _llama.forward_batch(cfg, params, tokens, kv, start, attn_window=attn_window,
                                window_delta=window_delta, ffn=block_ffn(cfg))


def make_cache(cfg: MoEConfig, max_seq: int | None = None, dtype=None, device=None,
               quant: bool = False) -> KVCache:
    return _llama.make_cache(cfg, max_seq, dtype, device, quant)


@torch.inference_mode()
def decode_step(cfg: MoEConfig, params: dict, tok, kv: KVCache, start):
    """One greedy decode step, a replay of the cache's captured one-step
    graph (llama.decode_step)."""
    return _llama.decode_step(cfg, params, tok, kv, start, fwd=_forward)


@torch.inference_mode()
def generate(cfg: MoEConfig, params: dict, prompt_tokens, n_predict: int, sampler=None,
             max_seq: int | None = None, device=None, kv_quant: bool = False) -> list[int]:
    """Prompt + n_predict greedy (or `sampler`) tokens, eager, one forward
    per token (reference :166-182)."""
    device = _llama._check_device(params, device)
    kv = make_cache(cfg, max_seq, device=device, quant=kv_quant)
    return _llama.run_generate(functools.partial(forward, cfg, params), kv, prompt_tokens,
                               n_predict, sampler, device)


# --------------------------------------------------------------- GGUF I/O

def load(path, device=None, layout: str | None = None) -> tuple[MoEConfig, dict]:
    """Read a Mixtral-convention GGUF (architecture llama, expert_count ≥ 2)
    to the device, tensor by tensor as llama.load does; each stacked expert
    tensor (E, n_out, K) becomes E per-expert QuantTensors (or an (E,
    n_out, K) f32 tensor when not quantized), reference :206-264. layout:
    as in llama.load."""
    device = resolve(device)
    r = GGUFReader(path)
    kv = r.kv
    if r.kv.get("general.architecture") != ARCH or int(kv.get("llama.expert_count", 0)) < 2:
        raise ValueError("not an MoE GGUF (llama.expert_count < 2)")
    n_head = int(kv["llama.attention.head_count"])
    cfg = MoEConfig(
        n_vocab=int(kv.get("llama.vocab_size", r.tensors["token_embd.weight"].shape[0])),
        n_ctx=int(kv["llama.context_length"]),
        n_embd=int(kv["llama.embedding_length"]),
        n_head=n_head,
        n_kv_head=int(kv.get("llama.attention.head_count_kv", n_head)),
        n_layer=int(kv["llama.block_count"]),
        n_ff=int(kv["llama.feed_forward_length"]),
        n_expert=int(kv["llama.expert_count"]),
        n_expert_used=int(kv["llama.expert_used_count"]),
        rms_eps=float(kv.get("llama.attention.layer_norm_rms_epsilon", 1e-5)),
        rope_base=float(kv.get("llama.rope.freq_base", 10000.0)),
    )
    layout = layout or config.get("weights_layout")
    if layout == "auto":
        layout = autotune.choose(device)

    def weight(name):
        return apply_weights_layout(_llama._to_param(r, name, device), layout)

    def experts(name):
        ti = r.tensors[name]
        E = cfg.n_expert
        if not TYPE_TRAITS[ti.type].is_quantized:
            return weight(name).reshape(E, -1, ti.shape[-1])
        raw = r.tensor_bytes(name).reshape(E, -1)
        n_out, k = ti.shape[-2], ti.shape[-1]
        return [apply_weights_layout(QuantTensor.from_wire(ti.type, raw[e], (n_out, k), device),
                                     layout) for e in range(E)]

    p = {"wte": weight("token_embd.weight"), "out_norm": weight("output_norm.weight"),
         "blocks": []}
    if "output.weight" in r.tensors:
        p["lm_head"] = weight("output.weight")
    for i in range(cfg.n_layer):
        g = f"blk.{i}."
        p["blocks"].append({
            "attn_norm": weight(g + "attn_norm.weight"),
            "wq": weight(g + "attn_q.weight"), "wk": weight(g + "attn_k.weight"),
            "wv": weight(g + "attn_v.weight"), "wo": weight(g + "attn_output.weight"),
            "ffn_norm": weight(g + "ffn_norm.weight"),
            "gate_inp": weight(g + "ffn_gate_inp.weight"),
            "gate_exps": experts(g + "ffn_gate_exps.weight"),
            "up_exps": experts(g + "ffn_up_exps.weight"),
            "down_exps": experts(g + "ffn_down_exps.weight"),
        })
    return cfg, p


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's MoE params (numpy leaves, each QuantTensor as
    llama.params_from_numpy takes it, expert lists as lists) → the port's."""
    return _llama.params_from_numpy(tree, device)


def random_params(cfg: MoEConfig, seed: int = 0, qtype: GGMLType | None = None,
                  device=None) -> dict:
    """Random weights ~N(0, 0.05) from numpy's generator at `seed`, drawn in
    the reference's order (:267-300), so equal seeds give its weights and,
    with qtype, its blocks (quantized on `device` by the codecs); experts
    whose rows are not whole blocks stay one dense (E, n_out, K) tensor;
    norm weights are ones. On the card unless device="cpu"."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    D, V, FF, E = cfg.n_embd, cfg.n_vocab, cfg.n_ff, cfg.n_expert
    KVD = cfg.n_kv_head * cfg.head_dim

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    def quantizable(k):
        return qtype is not None and k % TYPE_TRAITS[qtype].blck_size == 0

    def w(r, c):
        a = mk(r, c)
        return QuantTensor.quantize(qtype, a, device) if quantizable(c) \
            else torch.from_numpy(a).to(device)

    def exps(n_out, k):
        if quantizable(k):
            return [QuantTensor.quantize(qtype, mk(n_out, k), device) for _ in range(E)]
        return torch.from_numpy(mk(E, n_out, k)).to(device)

    def ones():
        return torch.ones(D, dtype=torch.float32, device=device)

    p = {"wte": w(V, D), "out_norm": ones(), "blocks": []}
    for _ in range(cfg.n_layer):
        p["blocks"].append({
            "attn_norm": ones(),
            "wq": w(D, D), "wk": w(KVD, D), "wv": w(KVD, D), "wo": w(D, D),
            "ffn_norm": ones(),
            "gate_inp": torch.from_numpy(mk(E, D)).to(device),
            "gate_exps": exps(FF, D), "up_exps": exps(FF, D), "down_exps": exps(D, FF),
        })
    return p
