"""Pipeline parallelism: layer stages over a 'pp' mesh axis with GPipe
micro-batching — the port of ggml_gfx906_tpu/parallel/pp.py (:1-152).

The transformer layers are split into `pp` contiguous stages (block
params stacked along a leading layer axis, this rank holding its stage's
layers) and each rank runs the GPipe schedule: at tick t stage s works on
micro-batch t − s while its neighbours work on the adjacent ones, the
activations going forward by point-to-point sends (mesh.send_recv). Fill
and drain bubbles shrink as n_micro / pp grows. A stage with no
micro-batch at a tick (the fill and the drain) sends and computes nothing,
where the reference's single program computes on padding there.

Scope: dense llama-style blocks, full-sequence forward (the prefill /
scoring shape; no KV carried across calls). Attention is K2 on the card.

    stacked = stack_blocks(params)                # (L, ...) per field
    sharded = shard_pp(mesh, stacked)             # this rank's L/pp layers
    logits = pp_forward(mesh, cfg, sharded, tokens, n_micro=4)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import ops
from .mesh import P, build_mesh, send_recv, shard_array


def make_pp_mesh(pp: int, device=None, backend: str | None = None):
    """The (pp,) mesh (mesh.build_mesh)."""
    return build_mesh(("pp",), (pp,), device, backend)


def stack_blocks(params: dict) -> dict:
    """List-of-block-dicts → one dict of (L, ...)-stacked fields (the layer
    axis is what the pipeline splits and each stage runs through)."""
    blocks = params["blocks"]
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: torch.stack([blk[k] for blk in blocks]) for k in blocks[0]}
    return out


def shard_pp(mesh, stacked: dict) -> dict:
    """This rank's stage: the blocks' layer axis split over 'pp' (raises
    unless the layer count divides by pp); everything else replicated
    (wte / out_norm / lm_head are used only on the first and last stages,
    but they are small next to the blocks)."""
    out = {k: shard_array(mesh, v, P()) for k, v in stacked.items() if k != "blocks"}
    out["blocks"] = {k: shard_array(mesh, v, P("pp")) for k, v in stacked["blocks"].items()}
    return out


def _block_apply(cfg, blk: dict, x: torch.Tensor) -> torch.Tensor:
    """One dense llama block on (MB, S, D) activations (full-seq causal)."""
    mb, S, _ = x.shape
    HD = cfg.head_dim
    H = blk["wq"].shape[0] // HD
    KVH = blk["wk"].shape[0] // HD
    pos = torch.arange(S, dtype=torch.int32, device=x.device)

    def rope(t):
        return ops.rope_ext(t, pos, cfg.n_rot, mode=ops.ROPE_TYPE_NEOX, freq_base=cfg.rope_base)

    h = ops.rms_norm(x, cfg.rms_eps) * blk["attn_norm"]
    q = rope((h @ blk["wq"].T).reshape(mb, S, H, HD))
    k = rope((h @ blk["wk"].T).reshape(mb, S, KVH, HD))
    v = (h @ blk["wv"].T).reshape(mb, S, KVH, HD)
    # K2 takes K/V as contiguous (batch, head) slabs, as a cache holds them
    att = ops.causal_flash_attn(q.transpose(1, 2), k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(), 0, scale=1.0 / (HD ** 0.5))
    att = att.transpose(1, 2).reshape(mb, S, H * HD)
    x = x + att @ blk["wo"].T
    h2 = ops.rms_norm(x, cfg.rms_eps) * blk["ffn_norm"]
    gate = ops.silu(h2 @ blk["w_gate"].T)
    up = h2 @ blk["w_up"].T
    return x + (gate * up) @ blk["w_down"].T


def pp_forward(mesh, cfg, params: dict, tokens: torch.Tensor, n_micro: int) -> torch.Tensor:
    """tokens (B, S) whole, B % n_micro == 0 → logits (B, S, V) on every
    rank; params from shard_pp(stack_blocks(...))."""
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} does not divide into {n_micro} micro-batches")
    nstages, s = mesh.size("pp"), mesh.index("pp")
    toks = tokens.reshape(n_micro, B // n_micro, S)
    blocks = params["blocks"]
    layers = [{k: v[i] for k, v in blocks.items()} for i in range(blocks["attn_norm"].shape[0])]
    wte = params["wte"]
    like = torch.empty((B // n_micro, S, wte.shape[1]), dtype=wte.dtype, device=wte.device)
    outs = torch.zeros((n_micro,) + like.shape, dtype=wte.dtype, device=wte.device)
    y = None
    for t in range(n_micro + nstages - 1):       # the pipeline's ticks
        mine = 0 <= t - s < n_micro              # this stage's micro-batch t − s
        theirs = s > 0 and 0 <= t - s < n_micro  # the one the stage before sent at t − 1
        x = send_recv(mesh, "pp", y, s + 1, like if theirs else None, s - 1)
        y = None
        if not mine:
            continue
        x = wte[toks[t - s]] if s == 0 else x
        for blk in layers:
            x = _block_apply(cfg, blk, x)
        if s == nstages - 1:
            outs[t - s] = x
        else:
            y = x
    # the last stage's activations to every stage (activations, not logits:
    # V is large)
    dist.broadcast(outs, mesh.ranks["pp"][-1], group=mesh.groups["pp"])
    h = ops.rms_norm(outs, cfg.rms_eps) * params["out_norm"]
    head = params.get("lm_head", wte)
    return (h @ head.T).reshape(B, S, -1)
