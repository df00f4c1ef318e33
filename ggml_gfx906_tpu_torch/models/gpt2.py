"""GPT-2 — the port of ggml_gfx906_tpu/models/gpt2.py.

LayerNorm → fused QKV (with bias) → causal attention → projection → GELU
MLP, learned position embeddings, the head tied to token_embd unless the
file has output.weight. Matrices are QuantTensors on their types' kernels
(ops/cuda/) or dense; attention runs on K2 at head dim n_embd / n_head.

GGUF schema: llama.cpp's gpt2 convention (kv `gpt2.*`, tensors
token_embd / position_embd / blk.N.attn_norm|attn_qkv|attn_output|
ffn_norm|ffn_up|ffn_down (weight and bias) / output_norm / output).

Entry points (`load`, `params_from_numpy`, `random_params`, `generate`)
run on the card unless device="cpu" is passed. `forward_batch` serves the
Engine (runtime/engine.py) with llama.forward_batch's contract, window
delta included; `decode_step` replays a captured graph as
llama.decode_step does; `forward_train` is the cache-free batched forward
that training differentiates (training/fit.py).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import ops
from ..gguf import GGUFReader
from ..ops.quantized import QuantTensor, apply_weights_layout, embed_rows, qmatmul
from ..quant.types import GGMLType, TYPE_TRAITS
from ..runtime.kv_cache import KVCache
from ..utils import autotune, config
from ..utils.device import resolve
from . import llama as _llama

ARCH = "gpt2"

_GGUF_NAMES = (
    ("ln1_g", "attn_norm.weight"), ("ln1_b", "attn_norm.bias"),
    ("qkv_w", "attn_qkv.weight"), ("qkv_b", "attn_qkv.bias"),
    ("proj_w", "attn_output.weight"), ("proj_b", "attn_output.bias"),
    ("ln2_g", "ffn_norm.weight"), ("ln2_b", "ffn_norm.bias"),
    ("up_w", "ffn_up.weight"), ("up_b", "ffn_up.bias"),
    ("down_w", "ffn_down.weight"), ("down_b", "ffn_down.bias"),
)


@dataclass(frozen=True)
class GPT2Config:
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_head: int
    n_layer: int
    ln_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def load(path, device=None, layout: str | None = None) -> tuple[GPT2Config, dict]:
    """Read a gpt2 GGUF to the device, tensor by tensor (llama.load's
    loader: every GGUF type, the kernel / wire / int8 layouts). layout: as
    in llama.load."""
    device = resolve(device)
    r = GGUFReader(path)
    arch = r.kv.get("general.architecture")
    if arch != ARCH:
        raise ValueError(f"not a gpt2 GGUF (architecture={arch!r})")
    kv = r.kv
    cfg = GPT2Config(
        n_vocab=int(kv[f"{ARCH}.vocab_size"]),
        n_ctx=int(kv[f"{ARCH}.context_length"]),
        n_embd=int(kv[f"{ARCH}.embedding_length"]),
        n_head=int(kv[f"{ARCH}.attention.head_count"]),
        n_layer=int(kv[f"{ARCH}.block_count"]),
        ln_eps=float(kv.get(f"{ARCH}.attention.layer_norm_epsilon", 1e-5)),
    )
    layout = layout or config.get("weights_layout")
    if layout == "auto":
        layout = autotune.choose(device)

    def mk(name):
        return apply_weights_layout(_llama._to_param(r, name, device), layout)

    p = {"wte": mk("token_embd.weight"), "wpe": mk("position_embd.weight"),
         "ln_f_g": mk("output_norm.weight"), "ln_f_b": mk("output_norm.bias")}
    if "output.weight" in r.tensors:
        p["lm_head"] = mk("output.weight")
    p["blocks"] = [{short: mk(f"blk.{i}.{gname}") for short, gname in _GGUF_NAMES}
                   for i in range(cfg.n_layer)]
    return cfg, p


def _ln(x, g, b, eps):
    return ops.norm(x, eps) * g + b


def _linear(x, w, b=None):
    y = qmatmul(x, w)
    return y + b if b is not None else y


def _mlp(blk, x, eps):
    h2 = _ln(x, blk["ln2_g"], blk["ln2_b"], eps)
    return _linear(ops.gelu(_linear(h2, blk["up_w"], blk["up_b"])), blk["down_w"],
                   blk["down_b"])


def _embed(cfg: GPT2Config, params: dict, tokens, pos) -> torch.Tensor:
    """Token plus learned position embedding. A position past the table's
    last row reads that row, as the reference's gather clamps: the Engine
    steps a finished slot to the end of its window, past n_ctx."""
    pos = pos.clamp(max=params["wpe"].shape[0] - 1)
    return (embed_rows(params["wte"], tokens) + embed_rows(params["wpe"], pos)
            ).to(cfg.compute_dtype)


def _block(cfg: GPT2Config, blk: dict, x, kv, li: int, start, pos_b=None,
           attn_window=None, window_delta=None) -> torch.Tensor:
    """Block li on x (B, S, D): fused QKV, cached attention on layer li of
    kv (llama.attend, whose arguments the last four are), projection, MLP."""
    B, S, _ = x.shape
    h = _ln(x, blk["ln1_g"], blk["ln1_b"], cfg.ln_eps)
    q, k, v = (t.reshape(B, S, cfg.n_head, cfg.head_dim)
               for t in _linear(h, blk["qkv_w"], blk["qkv_b"]).chunk(3, dim=-1))
    att = _llama.attend(kv, li, q, k, v, start, pos_b, attn_window, window_delta)
    x = x + _linear(att, blk["proj_w"], blk["proj_b"])
    return x + _mlp(blk, x, cfg.ln_eps)


def _head(cfg: GPT2Config, params: dict, x) -> torch.Tensor:
    x = _ln(x, params["ln_f_g"], params["ln_f_b"], cfg.ln_eps)
    return qmatmul(x, params.get("lm_head", params["wte"])).float()


def _forward(cfg: GPT2Config, params: dict, tokens: torch.Tensor, kv: KVCache,
             start) -> torch.Tensor:
    """`forward` without advancing kv.length (the body of a captured decode
    step, which reads its position from a device buffer)."""
    pos_b, pos = _llama._positions(tokens, start)
    x = _embed(cfg, params, tokens, pos)[None]
    for li, blk in enumerate(params["blocks"]):
        x = _block(cfg, blk, x, kv, li, start, pos_b)
    return _head(cfg, params, x[0])


def forward(cfg: GPT2Config, params: dict, tokens: torch.Tensor, kv: KVCache,
            start) -> tuple[torch.Tensor, KVCache]:
    """tokens (S,) at positions [start, start+S) → (logits (S, V) f32, kv),
    gpt2_graph's op sequence (reference :97-130). The cache is updated in
    place; `start` is a host int or a one-element device tensor."""
    return _forward(cfg, params, tokens, kv, start), kv.advance(tokens.shape[0])


def forward_batch(cfg: GPT2Config, params: dict, tokens: torch.Tensor, kv,
                  start: torch.Tensor, attn_window: int | None = None,
                  window_delta=None):
    """Batched serving forward over a BatchedKVCache or PagedKVCache:
    tokens (B, S) at per-slot positions start (B,) → (logits (B, S, V),
    kv); attn_window and window_delta as in llama.forward_batch (reference
    :149-197)."""
    S = tokens.shape[1]
    pos = start[:, None] + torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
    x = _embed(cfg, params, tokens, pos)
    for li, blk in enumerate(params["blocks"]):
        x = _block(cfg, blk, x, kv, li, start, attn_window=attn_window,
                   window_delta=window_delta)
    return _head(cfg, params, x), (kv if window_delta is None else window_delta[0])


def forward_train(cfg: GPT2Config, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The batched full-sequence forward without a cache (the reference's
    training forward, :200-225; flash_attn_ext with causal_mask): tokens
    (B, S) → logits (B, S, V) f32. Differentiable in every dense float
    param on either device: its attention is plain torch, and the
    embeddings' gather has a deterministic backward on the card (a
    sort-based accumulate), so two equal steps give equal gradients."""
    B, S = tokens.shape
    H, HD = cfg.n_head, cfg.head_dim
    x = _embed(cfg, params, tokens, torch.arange(S, device=tokens.device))
    mask = ops.causal_mask(S, S, device=tokens.device)
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1_g"], blk["ln1_b"], cfg.ln_eps)
        q, k, v = (t.reshape(B, S, H, HD).transpose(1, 2)
                   for t in _linear(h, blk["qkv_w"], blk["qkv_b"]).chunk(3, dim=-1))
        att = ops.flash_attn_ext(q, k, v, mask=mask, scale=1.0 / (HD ** 0.5))
        att = att.transpose(1, 2).reshape(B, S, cfg.n_embd)
        x = x + _linear(att, blk["proj_w"], blk["proj_b"])
        x = x + _mlp(blk, x, cfg.ln_eps)
    return _head(cfg, params, x)


def make_cache(cfg: GPT2Config, max_seq: int | None = None, dtype=None, device=None,
               quant: bool = False) -> KVCache:
    return KVCache.create(cfg.n_layer, max_seq or cfg.n_ctx, cfg.n_head, cfg.head_dim,
                          dtype or cfg.compute_dtype, device=resolve(device), quant=quant)


@torch.inference_mode()
def decode_step(cfg: GPT2Config, params: dict, tok, kv: KVCache, start):
    """One greedy decode step, a replay of the cache's captured one-step
    graph (llama.decode_step; reference :139-143)."""
    return _llama.decode_step(cfg, params, tok, kv, start, fwd=_forward)


@torch.inference_mode()
def generate(cfg: GPT2Config, params: dict, prompt_tokens, n_predict: int, sampler=None,
             max_seq: int | None = None, device=None, kv_quant: bool = False) -> list[int]:
    """Prompt + n_predict greedy (or `sampler`) tokens, eager, one forward
    per token (reference :333-355)."""
    device = _llama._check_device(params, device)
    kv = make_cache(cfg, max_seq, device=device, quant=kv_quant)
    return _llama.run_generate(functools.partial(forward, cfg, params), kv, prompt_tokens,
                               n_predict, sampler, device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's gpt2 params (numpy leaves, QuantTensors as
    llama.params_from_numpy takes them) → the port's."""
    return _llama.params_from_numpy(tree, device)


def random_params(cfg: GPT2Config, seed: int = 0, qtype: GGMLType | None = None,
                  dtype=torch.float32, device=None) -> dict:
    """Random weights ~N(0, 0.02) from numpy's generator at `seed`, drawn in
    the reference's order (:300-330), so equal seeds give its weights and,
    with qtype, its blocks (each matrix whose rows are whole blocks,
    quantized on `device` by the codecs); LayerNorm gains ones, offsets
    zeros. On the card unless device="cpu"."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    D, V = cfg.n_embd, cfg.n_vocab

    def w(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.02).astype(np.float32)
                                ).to(device=device, dtype=dtype)

    def mat(r, c):
        a = (rng.standard_normal((r, c)) * 0.02).astype(np.float32)
        if qtype is not None and c % TYPE_TRAITS[qtype].blck_size == 0:
            return QuantTensor.quantize(qtype, a, device)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def full(v):
        return torch.full((D,), v, dtype=dtype, device=device)

    p = {"wte": mat(V, D), "wpe": w(cfg.n_ctx, D), "ln_f_g": full(1.0), "ln_f_b": full(0.0),
         "blocks": []}
    for _ in range(cfg.n_layer):
        p["blocks"].append({
            "ln1_g": full(1.0), "ln1_b": full(0.0),
            "qkv_w": mat(3 * D, D), "qkv_b": w(3 * D),
            "proj_w": mat(D, D), "proj_b": w(D),
            "ln2_g": full(1.0), "ln2_b": full(0.0),
            "up_w": mat(4 * D, D), "up_b": w(4 * D),
            "down_w": mat(D, 4 * D), "down_b": w(D),
        })
    return p


def save_gguf(cfg: GPT2Config, params: dict, path, qtype: GGMLType | None = None):
    """Write a dense-float gpt2 params tree to a GGUF (the inverse of
    `load`, reference :246-297). With qtype, each 2-D weight whose rows are
    whole blocks is quantized by the codecs on its device; 1-D tensors stay
    f32, as the reference's quantize tool leaves them."""
    from ..gguf import GGUFValueType, GGUFWriter

    w = GGUFWriter()
    w.set("general.architecture", ARCH)
    for key, val in (("vocab_size", cfg.n_vocab), ("context_length", cfg.n_ctx),
                     ("embedding_length", cfg.n_embd), ("attention.head_count", cfg.n_head),
                     ("block_count", cfg.n_layer)):
        w.set(f"{ARCH}.{key}", int(val), GGUFValueType.UINT32)
    w.set(f"{ARCH}.attention.layer_norm_epsilon", float(cfg.ln_eps), GGUFValueType.FLOAT32)

    def put(name, a):
        a = a.float()
        if qtype is not None and a.dim() == 2 and a.shape[1] % TYPE_TRAITS[qtype].blck_size == 0:
            w.add_array_tensor(name, a, qtype)
        else:
            w.add_array_tensor(name, a)

    put("token_embd.weight", params["wte"])
    put("position_embd.weight", params["wpe"])
    put("output_norm.weight", params["ln_f_g"])
    put("output_norm.bias", params["ln_f_b"])
    if "lm_head" in params:
        put("output.weight", params["lm_head"])
    for i, blk in enumerate(params["blocks"]):
        for short, gname in _GGUF_NAMES:
            put(f"blk.{i}.{gname}", blk[short])
    w.write(path)
