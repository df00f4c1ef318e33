"""Tensor-parallel llama inference — the port of ggml_gfx906_tpu/parallel/
tp.py (:1-405).

The reference places a Megatron split by PartitionSpecs and runs its fused
Pallas kernels inside shard_map on each device's shard, with one psum over
'tp' after each of the two row-parallel products of a block. Here each
rank holds its shard (parallel/mesh.py) and runs models/llama.py with
`tp_group`, so the same kernels (K1, K3, K4, K2, …) run at the shard's
shapes and the two sums are `dist.all_reduce` on the tp group.

Placement (per transformer block):
  wq/wk/wv, w_gate/w_up : row-split    P('tp', None) → local heads / local FF
  wo, w_down            : column-split P(None, 'tp') → partial sums, one all-reduce
  norms, wte, lm_head   : replicated
  KV cache              : head axis on 'tp' (each rank attends its heads),
                          slots on 'dp' (`shard_kv`)

Column splits stay at superblock boundaries when (K / tp) % 256 == 0
(checked). Llama-2-7B's n_ff 11008 = 43·256 cannot be split by column at
tp = 2; Llama-3-8B's 14336 can.

Array placement follows mesh.py: a sharded input is this rank's shard (the
caches: `shard_kv`), the logits are every rank's whole value — replicated
by the head, and all-gathered over 'dp' where the reference's out spec is
P('dp', ...), so every rank's host logic sees the same tokens.

The engine programs (tp_decode_window, tp_prefill_batch,
tp_absorb_temp_paged) are the mesh form of runtime/engine.py's window body
and flood: this rank's slots of the engine's (B,) vectors, the sampled
tokens all-gathered over 'dp'. The port's engine samples with Gumbel noise
built on the host from (seed, counter) (runtime/sampling.py), so these take
the noise where the reference takes seeds and counters.
"""
from __future__ import annotations

import functools

import torch

from ..models import llama
from ..ops.quantized import QuantTensor
from ..runtime.batched_kv import BatchedKVCache
from ..runtime.engine import decode_window, prefill_batch
from ..runtime.kv_cache import KVCache
from .mesh import P, all_gather, shard_array, shard_quant_tensor

ROW = P("tp", None)
COL = P(None, "tp")
REP = P()

_BLOCK_RULES = {"wq": ROW, "wk": ROW, "wv": ROW, "w_gate": ROW, "w_up": ROW,
                "wo": COL, "w_down": COL}


def _is_qt(x) -> bool:
    return isinstance(x, QuantTensor)


def llama_param_specs(params: dict) -> dict:
    """The spec of every weight of a llama params dict (the tree of specs
    the reference builds; a QuantTensor's fields follow its weight's spec
    in shard_quant_tensor)."""
    specs = {k: REP for k in params if k != "blocks"}
    specs["blocks"] = [{k: _BLOCK_RULES.get(k, REP) for k in blk} for blk in params["blocks"]]
    return specs


def shard_llama_params(mesh, params: dict) -> dict:
    """This rank's shards of a llama params dict, by llama_param_specs.
    Raises, as the reference asserts, where a row split leaves N % tp,
    where a column split does not fall on superblock (kernel layout) or
    tile (int8 layout) boundaries, and on a column split of another layout
    ("column TP needs kernel layout")."""
    specs = llama_param_specs(params)
    tp = mesh.size("tp")

    def place(x, spec):
        if not _is_qt(x):
            return shard_array(mesh, x, spec)
        if spec == COL:
            if x.layout not in ("kernel", "int8"):
                raise ValueError("column TP needs kernel layout")
            gran = x.fields["w8t"].shape[2] if x.layout == "int8" else 256
            if (x.shape[1] // tp) % gran:
                raise ValueError(f"column split of {x.shape} at tp {tp}: K / tp is not a "
                                 f"multiple of {gran}")
        if spec == ROW and x.shape[0] % tp:
            raise ValueError(f"row split of {x.shape} at tp {tp}: N % tp != 0")
        return shard_quant_tensor(mesh, x, spec)

    out = {k: place(v, specs[k]) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: place(v, bs[k]) for k, v in blk.items()}
                     for blk, bs in zip(params["blocks"], specs["blocks"])]
    return out


def _kv_specs(kv, batched: bool) -> dict:
    """The spec of each kind of cache tensor: K/V heads on 'tp' and, in a
    batched cache, slots on 'dp' (reference :120-153)."""
    if batched:
        return {"kv": P("dp", "tp", None, None), "scale": P("dp", "tp", None),
                "lengths": P("dp")}
    return {"kv": P("tp", None, None), "scale": P("tp", None)}


def shard_kv(mesh, kv, batched: bool):
    """This rank's shard of a whole cache made for the unsharded model (a
    KVCache, or a BatchedKVCache when batched): its heads and, batched,
    its slots, with the cache's lengths. The tp functions take and return
    this rank's shard. The engine's paged pool is made per rank instead
    (runtime/engine.py: one pool group per dp coordinate)."""
    sp = _kv_specs(kv, batched)

    def sh(ts, spec):
        return [shard_array(mesh, t, spec) for t in ts]

    k, v = sh(kv.k, sp["kv"]), sh(kv.v, sp["kv"])
    kd, vd = sh(kv.k_d, sp["scale"]), sh(kv.v_d, sp["scale"])
    if batched:
        return BatchedKVCache(k, v, kd, vd, shard_array(mesh, kv.lengths, sp["lengths"]))
    return KVCache(k, v, kv.length, kd, vd)


def _dp_slots(mesh, b: int) -> slice:
    """This rank's rows of a (B, ...) batch sharded on 'dp'."""
    n = mesh.size("dp")
    if b % n:
        raise ValueError(f"batch {b} does not divide by dp {n}")
    lo = mesh.index("dp") * (b // n)
    return slice(lo, lo + b // n)


def _gather_dp(mesh):
    return functools.partial(all_gather, group=mesh.groups["dp"])


def tp_forward(mesh, cfg, params: dict, tokens, kv, start):
    """Single-sequence TP forward: (logits (S, V), kv). params from
    shard_llama_params, kv this rank's head shard (shard_kv); the logits
    are whole on every rank."""
    return llama.forward(cfg, params, tokens, kv, start,
                         tp_group=mesh.groups["tp"])


def tp_decode_step(mesh, cfg, params: dict, tok, kv, start):
    """Greedy TP decode step: (next_tok (1,) int32, kv), argmax on the device."""
    logits, kv = tp_forward(mesh, cfg, params, tok, kv, start)
    return torch.argmax(logits[-1]).to(torch.int32)[None], kv


def tp_forward_batch(mesh, cfg, params: dict, tokens, kv, start):
    """dp×tp batched serving forward: batch slots over 'dp', heads over
    'tp' — tokens (B, S) and start (B,) whole, kv this rank's shard
    (shard_kv(batched=True)) → (logits (B, S, V) on every rank, kv)."""
    sl = _dp_slots(mesh, tokens.shape[0])
    logits, kv = llama.forward_batch(cfg, params, tokens[sl], kv, start[sl],
                                     tp_group=mesh.groups["tp"])
    return all_gather(logits, mesh.groups["dp"]), kv


def _fb(mesh, cfg, params):
    return functools.partial(llama.forward_batch, cfg, params,
                             tp_group=mesh.groups["tp"])


def tp_decode_window(mesh, cfg, params: dict, kv, toks, active, noise, temps, top_ks,
                     top_ps, window: int, depth: int, flow: str = "scan", delta=None):
    """One decode window of `depth` steps on the mesh (the engine's window
    body, runtime/engine.py::decode_window, on this rank's slots and heads):
    toks, active, temps, top_ks, top_ps the engine's whole (B,) vectors,
    noise (depth, B, k); kv this rank's cache (dense, int8 or its paged pool
    group, whose window is gathered, decoded and absorbed here, so no page
    crosses ranks); flow "step" | "scan" | "delta" (the window-delta body,
    with `delta` this rank's WindowDelta). Each step's sampled tokens are
    all-gathered over 'dp' into toks. Returns the (depth, B) token stack."""
    return decode_window(_fb(mesh, cfg, params), kv, toks, active, noise, temps, top_ks,
                         top_ps, window, depth, flow, delta, _dp_slots(mesh, toks.shape[0]),
                         _gather_dp(mesh))


def tp_prefill_batch(mesh, cfg, params: dict, toks, kv, starts, plens, noise, temps,
                     top_ks, top_ps):
    """The flood's prefill on the mesh (runtime/engine.py::prefill_batch):
    toks (B, s_pad) and the per-slot vectors whole, kv this rank's temp
    cache; first tokens sampled at counter 0 on each rank's slots and
    all-gathered over 'dp'. Returns (firsts (B,), kv)."""
    return prefill_batch(_fb(mesh, cfg, params), toks, kv, starts, plens, noise, temps,
                         top_ks, top_ps, _dp_slots(mesh, toks.shape[0]), _gather_dp(mesh))


def tp_absorb_temp_paged(mesh, kv, temp, admitted, s_pad: int):
    """Install a flood's temp cache through this rank's paged pool group:
    the admitted slots of its share (admitted (B,) whole) get rows [0,
    s_pad) in their pages and their lengths (page-table values are
    group-local, so the scatter runs where the group lives)."""
    sl = _dp_slots(mesh, admitted.shape[0])
    starts = torch.zeros(temp.max_batch, dtype=torch.int32, device=admitted.device)
    return kv.absorb(temp, starts, s_pad, mask=admitted[sl])
