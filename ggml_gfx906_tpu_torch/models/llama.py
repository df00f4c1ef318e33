"""Llama-family decoder — the port of ggml_gfx906_tpu/models/llama.py.

The same op sequence as the reference (RMS_NORM + MUL_MAT + ROPE(NeoX) +
causal FLASH_ATTN + SWIGLU), in eager PyTorch over a params dict:
{"wte", "out_norm", ["lm_head"], "blocks": [{attn_norm, wq, wk, wv, wo,
ffn_norm, w_gate, w_up, w_down}, ...]}, where each matrix is a Q4_0, Q4_1,
Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K or Q8_0 QuantTensor (any mixture
of them, as in llama.cpp's Q2_K, Q3_K_M, Q4_K_M, Q5_K_M, Q4_0, Q4_1, Q5_0
and Q5_1 files) or a dense tensor. Quantized matmuls run on kernels K1/K3
(Q4_K, and K10 for single-row products under `qmm_pipeline`), K4 (Q6_K),
K5/K5-i8 (Q8_0), K6/K6-i8 (Q4_0), K7 (Q5_K), K8 (Q4_1, Q5_0, Q5_1) and K9
(Q2_K, Q3_K), attention on K2 (ops/cuda/); in the int8 execution layout
(`load(layout="int8")`, config "weights_layout") every quantized matmul
runs in plain torch (ops/quantized.py::_int8_layout_matmul).

GGUF schema: llama.cpp conventions (kv `llama.*`; tensors blk.N.attn_q|
attn_k|attn_v|attn_output|ffn_gate|ffn_up|ffn_down|attn_norm|ffn_norm).

Entry points (`load`, `params_from_numpy`, `random_params`, `generate`)
run on the card unless device="cpu" is passed, and raise when no CUDA
device exists. `load` takes every GGUF type: the types without kernels
(IQ*, TQ*, MXFP4) load into the int8 execution layout, token_embd and a
tied head included (ops/quantized.py::QuantTensor.from_wire).
`decode_step`, `decode_chunk` and `decode_scan` decode greedily on the
device of the cache they are given, dense or int8 (`make_cache(quant=
True)`; the quantizing write is captured with the step): each is a
replay of a static-shape step captured once as a CUDA graph on the card
(runtime/graphs.py; a direct call on the CPU), the reference's jitted
programs with their donated caches as in-place writes.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import ops
from ..gguf import GGUFReader
from ..ops.quantized import QuantTensor, apply_weights_layout, embed_rows, qmatmul
from ..parallel.mesh import all_reduce
from ..quant.types import GGMLType, TYPE_TRAITS
from ..runtime.kv_cache import KVCache
from ..runtime.graphs import GraphCache
from ..utils import abort, autotune, config
from ..utils.device import resolve, tree_device

ARCH = "llama"

_PER_BLOCK = (
    ("attn_norm", "attn_norm.weight"),
    ("wq", "attn_q.weight"), ("wk", "attn_k.weight"),
    ("wv", "attn_v.weight"), ("wo", "attn_output.weight"),
    ("ffn_norm", "ffn_norm.weight"),
    ("w_gate", "ffn_gate.weight"), ("w_up", "ffn_up.weight"),
    ("w_down", "ffn_down.weight"),
)


@dataclass(frozen=True)
class LlamaConfig:
    n_vocab: int
    n_ctx: int
    n_embd: int
    n_head: int
    n_kv_head: int
    n_layer: int
    n_ff: int
    rms_eps: float = 1e-5
    rope_base: float = 10000.0
    rope_dims: int | None = None  # defaults to head_dim
    rope_freq_scale: float = 1.0
    compute_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_rot(self) -> int:
        return self.rope_dims or self.head_dim


def params_device(params: dict) -> torch.device:
    """The device of a params tree (this module's, or another model's)."""
    return tree_device(params)


def _to_param(reader: GGUFReader, name: str, device):
    ti = reader.tensors[name]
    if TYPE_TRAITS[ti.type].is_quantized:
        if len(ti.shape) != 2:
            raise ValueError(f"{name}: quantized tensors must be 2-D")
        return QuantTensor.from_wire(ti.type, reader.tensor_bytes(name),
                                     tuple(ti.shape), device)
    if ti.type in (GGMLType.F32, GGMLType.F16):
        # to the device as stored, widened to f32 there (exact)
        return torch.from_numpy(np.array(reader.tensor_array(name))).to(device).to(torch.float32)
    return torch.from_numpy(reader.tensor_float(name)).to(device)


def load(path, device=None, layout: str | None = None) -> tuple[LlamaConfig, dict]:
    """Read a llama GGUF: mmap → torch → device. An `output.weight`
    becomes `lm_head`; without one the head is tied to `token_embd`.
    compute_dtype is f32; pass the config through dataclasses.replace for
    bf16 compute.

    layout: the execution layout of the quantized matrices; None reads
    config "weights_layout", and "auto" asks utils/autotune.choose(device)
    (reference :61-156); another value raises ValueError. Each tensor goes
    to the device as wire bytes, one at a time, and is split into its
    type's fields there (ops/quantized.py; "wire" where the kernels do not
    take its shape); for "int8" it is then converted on the device by
    ops/quantized.py::apply_weights_layout before the next tensor is read,
    so the kernel layout of one tensor at a time stands beside the int8
    params. The reference gathers the wire bytes into `load_chunk_mb`
    chunks to cut its host→device transfers (:159-208); a copy to the card
    costs no such fixed price, and the port keeps neither the chunks nor
    the knob."""
    device = resolve(device)
    r = GGUFReader(path)
    arch = r.kv.get("general.architecture")
    if arch != ARCH:
        raise ValueError(f"not a llama GGUF (architecture={arch!r})")
    kv = r.kv
    n_head = int(kv[f"{ARCH}.attention.head_count"])
    cfg = LlamaConfig(
        n_vocab=int(kv.get(f"{ARCH}.vocab_size",
                           r.tensors["token_embd.weight"].shape[0])),
        n_ctx=int(kv[f"{ARCH}.context_length"]),
        n_embd=int(kv[f"{ARCH}.embedding_length"]),
        n_head=n_head,
        n_kv_head=int(kv.get(f"{ARCH}.attention.head_count_kv", n_head)),
        n_layer=int(kv[f"{ARCH}.block_count"]),
        n_ff=int(kv[f"{ARCH}.feed_forward_length"]),
        rms_eps=float(kv.get(f"{ARCH}.attention.layer_norm_rms_epsilon", 1e-5)),
        rope_base=float(kv.get(f"{ARCH}.rope.freq_base", 10000.0)),
        rope_dims=int(kv[f"{ARCH}.rope.dimension_count"])
        if f"{ARCH}.rope.dimension_count" in kv else None,
        rope_freq_scale=float(kv.get(f"{ARCH}.rope.freq_scale", 1.0)),
    )
    names = {"wte": "token_embd.weight", "out_norm": "output_norm.weight"}
    if "output.weight" in r.tensors:
        names["lm_head"] = "output.weight"
    blocks = [{short: f"blk.{i}.{gname}" for short, gname in _PER_BLOCK}
              for i in range(cfg.n_layer)]
    layout = layout or config.get("weights_layout")
    if layout == "auto":
        layout = autotune.choose(device)

    def mk(nm):
        return apply_weights_layout(_to_param(r, nm, device), layout)
    p = {key: mk(nm) for key, nm in names.items()}
    p["blocks"] = [{key: mk(nm) for key, nm in b.items()} for b in blocks]
    return cfg, p


def params_from_numpy(tree: dict, device=None) -> dict:
    """Carry the JAX package's llama params across. `tree` mirrors its
    params pytree with numpy leaves; each QuantTensor arrives as
    {"qtype", "shape", "layout", "fields": {name: ndarray}} in one of the
    JAX layouts: "kernel" (Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K,
    Q6_K or Q8_0), "wire" (the ggml block fields, ops/quantized.py:29-42)
    or "int8" (w8t, dwt, carried as they are).
    Any nesting of dicts and lists is carried (the expert lists of
    models/moe.py, the other models' trees). Returns the port's params,
    which compute the same function."""
    device = resolve(device)

    def conv(leaf):
        if isinstance(leaf, dict) and "fields" in leaf:
            qtype, shape = GGMLType(leaf["qtype"]), tuple(leaf["shape"])
            if leaf["layout"] == "int8":
                return QuantTensor(qtype, shape, {
                    f: torch.from_numpy(np.array(leaf["fields"][f], copy=True)).to(device)
                    for f in ("w8t", "dwt")}, "int8")
            if leaf["layout"] == "wire":
                return _from_reference_wire(qtype, shape, leaf["fields"], device)
            return QuantTensor.from_reference_kernel_layout(
                qtype, shape, leaf["fields"], device)
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return [conv(v) for v in leaf]
        return torch.from_numpy(np.array(leaf, copy=True)).to(device)

    return conv(tree)


def random_params(cfg: LlamaConfig, seed: int = 0, qtype: GGMLType | None = None,
                  dtype=torch.float32, device=None) -> dict:
    """Random weights ~N(0, 0.02) from numpy's generator at `seed`, drawn in
    the reference's order (:459-480), so equal seeds give the reference's
    weights and, with qtype, its blocks: each matrix whose rows are whole
    blocks of qtype is quantized on `device` by the codecs
    (QuantTensor.quantize), the others kept dense in `dtype`; norm weights
    are ones. On the card unless device="cpu"."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    D, V, FF = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    KVD = cfg.n_kv_head * cfg.head_dim

    def mat(r, c, scale=0.02):
        a = (rng.standard_normal((r, c)) * scale).astype(np.float32)
        if qtype is not None and c % TYPE_TRAITS[qtype].blck_size == 0:
            return QuantTensor.quantize(qtype, a, device)
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def ones():
        return torch.ones(D, dtype=dtype, device=device)

    p = {"wte": mat(V, D), "out_norm": ones(), "blocks": []}
    for _ in range(cfg.n_layer):
        p["blocks"].append({
            "attn_norm": ones(),
            "wq": mat(D, D), "wk": mat(KVD, D), "wv": mat(KVD, D), "wo": mat(D, D),
            "ffn_norm": ones(),
            "w_gate": mat(FF, D), "w_up": mat(FF, D), "w_down": mat(D, FF),
        })
    return p


def _from_reference_wire(qtype: GGMLType, shape, fields: dict, device) -> QuantTensor:
    """The JAX package's "wire" fields (ggml's block fields by name) →
    packed blocks → QuantTensor.from_wire. Fields the reference does not
    keep (Q8_1's s, Q8_K's bsums) are not read by dequantization and stay
    zero."""
    tt = TYPE_TRAITS[qtype]
    n, k = shape
    blocks = np.zeros((n, k // tt.blck_size), tt.block_dtype)
    for name, a in fields.items():
        blocks[name] = np.asarray(a).reshape(blocks[name].shape)
    return QuantTensor.from_wire(qtype, blocks.view(np.uint8).reshape(-1), (n, k), device)


def _rms(x, g, eps):
    return ops.rms_norm(x, eps) * g


def _rope(cfg: LlamaConfig, x, pos):
    return ops.rope_ext(x, pos, cfg.n_rot, mode=ops.ROPE_TYPE_NEOX,
                        freq_base=cfg.rope_base,
                        freq_scale=cfg.rope_freq_scale)


def _tp_sum(t: torch.Tensor, tp_group) -> torch.Tensor:
    """A row-parallel product's partial sums added over the tensor-parallel
    group, in place (the reference's psum over tp_axis, :263-271): the
    compute dtype is summed as it is, bf16 included, as gloo and NCCL both
    add it. No group: t as it is."""
    return t if tp_group is None else all_reduce(t, tp_group)


def _block_ffn(blk, x, eps, tp_group=None):
    h2 = _rms(x, blk["ffn_norm"], eps)
    gate = ops.silu(qmatmul(h2, blk["w_gate"]))
    up = qmatmul(h2, blk["w_up"])
    return x + _tp_sum(qmatmul(gate * up, blk["w_down"]), tp_group)


def _positions(tokens: torch.Tensor, start):
    """(start as a (1,) int32 device tensor, the tokens' positions (S,))."""
    dev = tokens.device
    if isinstance(start, torch.Tensor):
        pos_b = start.reshape(1).to(torch.int32)
    else:
        pos_b = torch.full((1,), int(start), dtype=torch.int32, device=dev)
    return pos_b, pos_b + torch.arange(tokens.shape[0], dtype=torch.int32, device=dev)


def attend(kv, li, q, k, v, start, pos_b=None, attn_window=None, window_delta=None):
    """Layer li's cached attention, shared by every model: how a layer
    writes its K/V and reads the cache back (dense, paged or int8; strict
    or window delta). q (B, S, H, HD), k and v (B, S, KVH, HD) → att
    (B, S, H·HD); the K/V rows go into the cache, or into the delta under
    window_delta, in place.

    kv: a single-stream KVCache (B = 1; K/V written at `start`, a host int
    or a one-element device tensor; attention reads the position from
    pos_b, the same position as a (1,) int32 tensor), or a BatchedKVCache /
    PagedKVCache (start (B,) for both; attn_window as in `forward_batch`).
    window_delta: `forward_batch`'s (delta, step, len0) triple."""
    B, S, H, HD = q.shape
    scale = 1.0 / (HD ** 0.5)
    if window_delta is not None:
        delta, step, len0 = window_delta
        delta.write(li, k, v, step)
        kc, vc, kd, vd = kv.layer_kv(li, attn_window)
        att = ops.causal_attn_delta(q.transpose(1, 2), kc, vc, kd, vd, len0, delta.k[li],
                                    delta.v[li], step, scale=scale)
    elif isinstance(kv, KVCache):
        kv.update_layer(li, k[0], v[0], start)
        kc, vc, kd, vd = (None if t is None else t[None] for t in kv.layer_kv(li))
        att = ops.causal_flash_attn(q.transpose(1, 2), kc, vc, pos_b, scale=scale,
                                    k_scale=kd, v_scale=vd)
    else:
        kv.update_layer(li, k, v, start)
        kc, vc, kd, vd = kv.layer_kv(li, attn_window)
        att = ops.causal_flash_attn(q.transpose(1, 2), kc, vc, start, scale=scale,
                                    k_scale=kd, v_scale=vd)
    return att.transpose(1, 2).reshape(B, S, H * HD)


def _layers(cfg, blocks, x, kv: KVCache, start, pos_b, pos, ffn=_block_ffn, tp_group=None):
    """x (S, D) through `blocks`, block i on layer i of `kv`; `ffn(blk, x,
    eps, tp_group)` is the residual FFN sublayer (the dense SwiGLU here, the
    routed experts in models/moe.py).

    tp_group: the tensor-parallel process group when the blocks are this
    rank's shards (parallel/tp.py): the heads and FFN rows are local (H and
    KVH come from the local weight shapes) and the outputs of wo and w_down
    are summed over the group before each residual add."""
    S = x.shape[0]
    HD = cfg.head_dim
    for li, blk in enumerate(blocks):
        H = blk["wq"].shape[0] // HD
        KVH = blk["wk"].shape[0] // HD
        h = _rms(x, blk["attn_norm"], cfg.rms_eps)
        q = qmatmul(h, blk["wq"]).reshape(S, H, HD)
        k = qmatmul(h, blk["wk"]).reshape(S, KVH, HD)
        v = qmatmul(h, blk["wv"]).reshape(S, KVH, HD)
        q = _rope(cfg, q, pos)
        k = _rope(cfg, k, pos)
        att = attend(kv, li, q[None], k[None], v[None], start, pos_b)
        x = x + _tp_sum(qmatmul(att[0], blk["wo"]), tp_group)
        x = ffn(blk, x, cfg.rms_eps, tp_group)
    return x


def _head(cfg, params: dict, x) -> torch.Tensor:
    x = _rms(x, params["out_norm"], cfg.rms_eps)
    head = params["lm_head"] if "lm_head" in params else params["wte"]
    return qmatmul(x, head).float()


def _forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor, kv: KVCache,
             start, ffn=_block_ffn, tp_group=None) -> torch.Tensor:
    """`forward` without advancing kv.length (the body a captured decode
    step runs: it reads its position from a device buffer)."""
    pos_b, pos = _positions(tokens, start)
    x = embed_rows(params["wte"], tokens).to(cfg.compute_dtype)
    return _head(cfg, params, _layers(cfg, params["blocks"], x, kv, start, pos_b, pos, ffn,
                                      tp_group))


def forward(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
            kv: KVCache, start, tp_group=None) -> tuple[torch.Tensor, KVCache]:
    """tokens (S,) at absolute positions [start, start+S) → (logits (S, V)
    f32, kv). The cache is updated in place. `start` is a host int or a
    one-element int tensor on the device (read there, with no host copy).
    tp_group: as in `_layers` (params and kv are then this rank's shards)."""
    return (_forward(cfg, params, tokens, kv, start, tp_group=tp_group),
            kv.advance(tokens.shape[0]))


def forward_batch(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
                  kv, start: torch.Tensor, attn_window: int | None = None,
                  window_delta=None, ffn=_block_ffn, tp_group=None):
    """Batched serving forward: tokens (B, S) at per-slot positions
    start (B,) against a BatchedKVCache or PagedKVCache → (logits (B, S,
    V) f32, kv).

    attn_window: attend only over cache positions [0, window) — the engine
    passes the smallest bucket covering the longest active slot; callers
    guarantee every valid position is < attn_window. K/V writes still go to
    the full cache.

    window_delta (decode only, S == 1): a (delta: WindowDelta, step: int,
    len0 (B,)) triple — the fresh K/V rows go into the delta at column
    `step` (no write into the cache; the engine absorbs the window once,
    BatchedKVCache.absorb_delta) and attention merges the cache rows
    [0, len0) with the delta rows [0, step] (ops.causal_attn_delta).
    Returns (logits, delta) instead of (logits, kv) (reference :329-400).

    ffn, tp_group: as in `_layers`."""
    B, S = tokens.shape
    HD = cfg.head_dim
    dev = tokens.device
    pos = start[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    x = embed_rows(params["wte"], tokens).to(cfg.compute_dtype)
    for li, blk in enumerate(params["blocks"]):
        H = blk["wq"].shape[0] // HD
        KVH = blk["wk"].shape[0] // HD
        h = _rms(x, blk["attn_norm"], cfg.rms_eps)
        q = qmatmul(h, blk["wq"]).reshape(B, S, H, HD)
        k = qmatmul(h, blk["wk"]).reshape(B, S, KVH, HD)
        v = qmatmul(h, blk["wv"]).reshape(B, S, KVH, HD)
        q = _rope(cfg, q, pos)
        k = _rope(cfg, k, pos)
        att = attend(kv, li, q, k, v, start, attn_window=attn_window,
                     window_delta=window_delta)
        x = x + _tp_sum(qmatmul(att, blk["wo"]), tp_group)
        x = ffn(blk, x, cfg.rms_eps, tp_group)
    return _head(cfg, params, x), (kv if window_delta is None else window_delta[0])


def make_cache(cfg: LlamaConfig, max_seq: int | None = None, dtype=None,
               device=None, quant: bool = False) -> KVCache:
    """quant=True stores K/V int8 with per-(head, position) scales (the
    reference's :296-302)."""
    return KVCache.create(cfg.n_layer, max_seq or cfg.n_ctx, cfg.n_kv_head,
                          cfg.head_dim, dtype or cfg.compute_dtype,
                          device=resolve(device), quant=quant)


def _check_device(params, device) -> torch.device:
    device = resolve(device)
    if params_device(params).type != device.type:
        raise ValueError(f"params live on {params_device(params)}, asked for {device}")
    return device


@torch.inference_mode()
def generate(cfg: LlamaConfig, params: dict, prompt_tokens, n_predict: int,
             sampler=None, max_seq: int | None = None, device=None,
             kv_quant: bool = False) -> list[int]:
    """Prompt + n_predict greedy (or `sampler`) tokens, single sequence,
    on an int8 KV cache under kv_quant.
    Eager, one forward per token, as the reference's re-dispatches its
    jitted forward (:305-326): `sampler` is any Python callable. The
    captured greedy loop is `decode_chunk` / `decode_scan`."""
    device = _check_device(params, device)
    kv = make_cache(cfg, max_seq, device=device, quant=kv_quant)
    return run_generate(functools.partial(forward, cfg, params), kv, prompt_tokens,
                        n_predict, sampler, device)


def run_generate(fwd, kv, prompt_tokens, n_predict: int, sampler, device) -> list[int]:
    """The eager decode loop of every model's `generate`: fwd(tokens (S,),
    kv, start) → (logits (S, V), kv) prefills the prompt, then runs one
    step per token; `sampler` (greedy by default) picks each token."""
    from ..runtime.sampling import greedy

    toks = torch.as_tensor(np.asarray(prompt_tokens, np.int64), device=device)
    logits, kv = fwd(toks, kv, 0)
    out = list(map(int, prompt_tokens))
    sampler = sampler or greedy
    out.append(int(sampler(logits[-1])))
    pos = len(prompt_tokens)
    for _ in range(n_predict - 1):
        abort.check()   # cooperative-cancel poll point between steps
        logits, kv = fwd(torch.tensor([out[-1]], dtype=torch.int64, device=device), kv, pos)
        pos += 1
        out.append(int(sampler(logits[-1])))
    return out


@torch.inference_mode()
def prefill_kv(cfg: LlamaConfig, params: dict, tokens: torch.Tensor,
               max_seq: int):
    """Single-sequence prefill → (logits (S, V), k, v) with per-layer
    (n_kv_head, max_seq, head_dim) caches, for slot installation."""
    kv = make_cache(cfg, max_seq, device=tokens.device)
    logits, kv = forward(cfg, params, tokens, kv, 0)
    return logits, kv.k, kv.v


# ------------------------------------------- captured greedy decode steps

class _Decoder:
    """Single-stream greedy decode on one KVCache: the token and position
    buffers its captured steps read and advance, and their graphs."""

    def __init__(self, device: torch.device):
        self.tok = torch.zeros(1, dtype=torch.int64, device=device)
        self.pos = torch.zeros(1, dtype=torch.int32, device=device)
        self.graphs = GraphCache(device)
        # the static buffers of this cache's other captured programs
        # (models/speculative.py), by name: they live as long as the graphs
        self.buffers: dict = {}

    def load(self, tok, pos) -> None:
        """Set the next input token and its position (ints or device
        tensors; a tensor is copied on the device)."""
        for buf, v in ((self.tok, tok), (self.pos, pos)):
            if isinstance(v, torch.Tensor):
                buf.copy_(v.reshape(1))
            else:
                buf.fill_(int(v))


def _decoder(kv: KVCache) -> _Decoder:
    if kv.graphs is None:
        kv.graphs = _Decoder(kv.k[0].device)
    return kv.graphs


def step_graph(cfg: LlamaConfig, params: dict, kv: KVCache, n_steps: int = 1,
               fwd=None):
    """The captured program of `n_steps` chained greedy decode steps on
    `kv` (a `runtime.graphs.StepGraph`): each step runs `forward` on the
    token buffer at the position buffer, takes the argmax as the next
    token and advances both buffers in place. Its outputs are (tokens
    (n_steps,) int32, the last step's logits (1, V) f32). One graph serves
    every position: the position is read from the device and attention
    reads the whole cache, as the eager step's does. fwd: the model's
    `_forward` (cfg, params, tokens, kv, start) → logits, this module's by
    default (models/moe.py, gpt2.py and gptj.py pass theirs)."""
    d = _decoder(kv)
    fwd = fwd or _forward

    def body():
        toks = []
        for _ in range(n_steps):
            logits = fwd(cfg, params, d.tok, kv, d.pos)
            nxt = torch.argmax(logits[-1]).to(torch.int32)[None]
            d.tok.copy_(nxt)
            d.pos.add_(1)
            toks.append(nxt)
        return torch.cat(toks), logits

    key = ("decode", id(params), kv.k[0].data_ptr(), 1, 1, kv.max_seq, n_steps, cfg, fwd)
    return d.graphs.get(key, body, state=(d.tok, d.pos))


@torch.inference_mode()
def decode_step(cfg: LlamaConfig, params: dict, tok, kv: KVCache, start, fwd=None):
    """One greedy decode step with the argmax inside the program: (tok
    (1,), kv, start) → (next_tok (1,) int32, kv) (reference :285-293). The
    step is a replay of the cache's one-step graph; the cache is updated in
    place and kv.length advances on the host. Feed the returned token back
    as the next input: the real autoregressive dependence. fwd: as in
    `step_graph`."""
    d = _decoder(kv)
    d.load(tok, start)
    toks, _ = step_graph(cfg, params, kv, 1, fwd).replay()
    return toks.clone(), kv.advance(1)


@torch.inference_mode()
def decode_chunk(cfg: LlamaConfig, params: dict, kv: KVCache, carry, n_steps: int):
    """Greedy-decode n_steps tokens (reference :414-433): the one-step
    graph replayed n_steps times, the token and position chaining through
    its device buffers with no host read. carry: [token, position] (2,)
    int. Returns (tokens (n_steps,) int32, kv, new carry (2,) int32)."""
    d = _decoder(kv)
    d.load(carry[0], carry[1])
    g = step_graph(cfg, params, kv, 1)
    toks = torch.empty(n_steps, dtype=torch.int32, device=d.tok.device)
    for i in range(n_steps):
        toks[i:i + 1].copy_(g.replay()[0])
    return toks, kv.advance(n_steps), torch.cat([d.tok.to(torch.int32), d.pos])


@torch.inference_mode()
def decode_scan(cfg: LlamaConfig, params: dict, kv: KVCache, first_token, start,
                n_steps: int):
    """Greedy-decode n_steps tokens in ONE replay (reference :436-456,
    whose lax.scan is one program): a graph of n_steps chained steps,
    captured once per n_steps. Returns (tokens (n_steps,) int32, kv)."""
    d = _decoder(kv)
    d.load(first_token, start)
    toks, _ = step_graph(cfg, params, kv, n_steps).replay()
    return toks.clone(), kv.advance(n_steps)
