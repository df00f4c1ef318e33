"""GPT-J (6B-class) decoder — the port of ggml_gfx906_tpu/models/gptj.py.

Parallel residual (attention and MLP both read ln_1(x) and add into the
same residual), rotary position embedding in ggml's NORMAL (interleaved)
mode on the first n_rot dims of each head, no attention biases, a head
with a bias. Matrices are QuantTensors on their types' kernels (ops/cuda/)
or dense; attention runs on K2.

GGUF schema: llama.cpp's gptj convention (kv `gptj.*`, tensors blk.N.
attn_q|attn_k|attn_v|attn_output|ffn_up|ffn_down, output with bias).

Entry points (`load`, `params_from_numpy`, `generate`) run on the card
unless device="cpu" is passed; `decode_step` replays a captured graph as
llama.decode_step does. Like the reference, the module has no
forward_batch, so the Engine cannot serve it (models/cli.py's `serve`
says so and exits 1).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .. import ops
from ..gguf import GGUFReader
from ..ops.quantized import apply_weights_layout, embed_rows, qmatmul
from ..runtime.kv_cache import KVCache
from ..utils import autotune, config
from ..utils.device import resolve
from . import llama as _llama

ARCH = "gptj"

_GGUF_NAMES = (
    ("ln1_g", "attn_norm.weight"), ("ln1_b", "attn_norm.bias"),
    ("wq", "attn_q.weight"), ("wk", "attn_k.weight"),
    ("wv", "attn_v.weight"), ("wo", "attn_output.weight"),
    ("fc_in_w", "ffn_up.weight"), ("fc_in_b", "ffn_up.bias"),
    ("fc_out_w", "ffn_down.weight"), ("fc_out_b", "ffn_down.bias"),
)


@dataclass(frozen=True)
class GPTJConfig:
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_head: int
    n_layer: int
    n_rot: int
    ln_eps: float = 1e-5
    rope_base: float = 10000.0
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


def load(path, device=None, layout: str | None = None) -> tuple[GPTJConfig, dict]:
    """Read a gptj GGUF to the device, tensor by tensor (llama.load's
    loader). layout: as in llama.load."""
    device = resolve(device)
    r = GGUFReader(path)
    if r.kv.get("general.architecture") != ARCH:
        raise ValueError(f"not a gptj GGUF ({r.kv.get('general.architecture')!r})")
    kv = r.kv
    cfg = GPTJConfig(
        n_vocab=int(kv.get(f"{ARCH}.vocab_size", r.tensors["token_embd.weight"].shape[0])),
        n_ctx=int(kv[f"{ARCH}.context_length"]),
        n_embd=int(kv[f"{ARCH}.embedding_length"]),
        n_head=int(kv[f"{ARCH}.attention.head_count"]),
        n_layer=int(kv[f"{ARCH}.block_count"]),
        n_rot=int(kv[f"{ARCH}.rope.dimension_count"]),
        ln_eps=float(kv.get(f"{ARCH}.attention.layer_norm_epsilon", 1e-5)),
    )
    layout = layout or config.get("weights_layout")
    if layout == "auto":
        layout = autotune.choose(device)

    def mk(name):
        return apply_weights_layout(_llama._to_param(r, name, device), layout)

    p = {"wte": mk("token_embd.weight"), "ln_f_g": mk("output_norm.weight"),
         "ln_f_b": mk("output_norm.bias"), "lm_head": mk("output.weight"),
         "lm_head_b": mk("output.bias")}
    p["blocks"] = [{short: mk(f"blk.{i}.{gname}") for short, gname in _GGUF_NAMES}
                   for i in range(cfg.n_layer)]
    return cfg, p


def _rope(cfg: GPTJConfig, x, pos):
    return ops.rope_ext(x, pos, cfg.n_rot, mode=ops.ROPE_TYPE_NORMAL, freq_base=cfg.rope_base)


def _forward(cfg: GPTJConfig, params: dict, tokens: torch.Tensor, kv: KVCache,
             start) -> torch.Tensor:
    """`forward` without advancing kv.length (the body of a captured decode
    step)."""
    S = tokens.shape[0]
    H, HD = cfg.n_head, cfg.head_dim
    pos_b, pos = _llama._positions(tokens, start)
    x = embed_rows(params["wte"], tokens).to(cfg.compute_dtype)
    for li, blk in enumerate(params["blocks"]):
        h = ops.norm(x, cfg.ln_eps) * blk["ln1_g"] + blk["ln1_b"]
        q = _rope(cfg, qmatmul(h, blk["wq"]).reshape(S, H, HD), pos)
        k = _rope(cfg, qmatmul(h, blk["wk"]).reshape(S, H, HD), pos)
        v = qmatmul(h, blk["wv"]).reshape(S, H, HD)
        att = _llama.attend(kv, li, q[None], k[None], v[None], start, pos_b)
        att_out = qmatmul(att[0], blk["wo"])
        ff = qmatmul(ops.gelu(qmatmul(h, blk["fc_in_w"]) + blk["fc_in_b"]),
                     blk["fc_out_w"]) + blk["fc_out_b"]
        x = x + att_out + ff            # parallel residual
    x = ops.norm(x, cfg.ln_eps) * params["ln_f_g"] + params["ln_f_b"]
    return (qmatmul(x, params["lm_head"]) + params["lm_head_b"]).float()


def forward(cfg: GPTJConfig, params: dict, tokens: torch.Tensor, kv: KVCache,
            start) -> tuple[torch.Tensor, KVCache]:
    """tokens (S,) at positions [start, start+S) → (logits (S, V) f32, kv)
    (reference :100-136)."""
    return _forward(cfg, params, tokens, kv, start), kv.advance(tokens.shape[0])


def make_cache(cfg: GPTJConfig, max_seq: int | None = None, dtype=None, device=None,
               quant: bool = False) -> KVCache:
    return KVCache.create(cfg.n_layer, max_seq or cfg.n_ctx, cfg.n_head, cfg.head_dim,
                          dtype or cfg.compute_dtype, device=resolve(device), quant=quant)


@torch.inference_mode()
def decode_step(cfg: GPTJConfig, params: dict, tok, kv: KVCache, start):
    """One greedy decode step, a replay of the cache's captured one-step
    graph (llama.decode_step). The reference has none for GPT-J: this is
    the port's, for the same single-stream decode on the card."""
    return _llama.decode_step(cfg, params, tok, kv, start, fwd=_forward)


@torch.inference_mode()
def generate(cfg: GPTJConfig, params: dict, prompt_tokens, n_predict: int, sampler=None,
             max_seq: int | None = None, device=None, kv_quant: bool = False) -> list[int]:
    """Prompt + n_predict greedy (or `sampler`) tokens, eager, one forward
    per token (reference :152-166)."""
    device = _llama._check_device(params, device)
    kv = make_cache(cfg, max_seq, device=device, quant=kv_quant)
    return _llama.run_generate(functools.partial(forward, cfg, params), kv, prompt_tokens,
                               n_predict, sampler, device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's gptj params (numpy leaves, QuantTensors as
    llama.params_from_numpy takes them) → the port's."""
    return _llama.params_from_numpy(tree, device)
