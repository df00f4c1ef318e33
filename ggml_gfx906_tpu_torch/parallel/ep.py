"""Expert parallelism: MUL_MAT_ID routed over an 'ep' mesh axis — the port
of ggml_gfx906_tpu/parallel/ep.py (:1-77).

Each expert's weights live on exactly one rank of the 'ep' axis and the
routing stays dense and static: every rank runs the GShard-style capacity
dispatch (ops/recurrent.py::mul_mat_id, the experts' own kernels: K1 / K3
for Q4_K) against only its local experts — tokens routed elsewhere get the
out-of-range id, so they take no local queue slot and capacity drops match
one device — and one all-reduce over 'ep' assembles the routed outputs
(each output row has exactly one non-zero partial, so the sum is exact).
Expert weights are never gathered; each rank streams only E/ep experts.

Composes with data parallelism: tokens shard over 'dp', experts over 'ep';
the output is all-gathered over 'dp', so every rank returns the whole.

    mesh = make_ep_mesh(ep=4, dp=2)
    experts = shard_experts(mesh, experts)      # this rank's E/ep experts
    out = ep_mul_mat_id(mesh, experts, x, ids)  # == ops.mul_mat_id
"""
from __future__ import annotations

import torch

from ..ops.recurrent import mul_mat_id
from .mesh import P, all_gather, all_reduce, build_mesh, shard_array


def make_ep_mesh(ep: int, dp: int = 1, device=None, backend: str | None = None):
    """The (dp, ep) mesh (mesh.build_mesh)."""
    return build_mesh(("dp", "ep"), (dp, ep), device, backend)


def shard_experts(mesh, experts, axis: str = "ep"):
    """This rank's experts of a stacked (E, N, K) tensor or a list of E
    per-expert weights (QuantTensors or dense; models/moe.py's lists): E
    must divide by the axis's size."""
    n = mesh.size(axis)
    if len(experts) % n:
        raise ValueError(f"{len(experts)} experts do not divide by {axis}={n}")
    if isinstance(experts, torch.Tensor):
        return shard_array(mesh, experts, P(axis, None, None))
    el = len(experts) // n
    return list(experts[mesh.index(axis) * el:(mesh.index(axis) + 1) * el])


def ep_mul_mat_id(mesh, experts, x, ids, capacity: int | None = None,
                  axis: str = "ep", batch_axis: str | None = "dp"):
    """Expert-parallel MUL_MAT_ID: out[t, u] = x[t, u] @ experts[ids[t, u]].T

    experts this rank's shard (shard_experts); x (T, U, K) and ids (T, U)
    whole, split over T on `batch_axis` when the mesh has it with size > 1.
    `capacity` bounds the per-expert token queue PER (dp shard, rank): with
    dp > 1 each dp shard counts queue positions over its own T/dp tokens,
    the GShard local-capacity semantics of the reference (intentionally
    not a single-device run over the whole batch). Returns (T, U, N)."""
    bax = batch_axis if batch_axis and mesh.size(batch_axis) > 1 else None
    if bax is not None:
        n = mesh.size(bax)
        if x.shape[0] % n:
            raise ValueError(f"T {x.shape[0]} does not divide by {bax}={n}")
        t = x.shape[0] // n
        lo = mesh.index(bax) * t
        x, ids = x[lo:lo + t], ids[lo:lo + t]
    el = len(experts)
    lid = ids.to(torch.int64) - mesh.index(axis) * el
    ok = (lid >= 0) & (lid < el)
    out = mul_mat_id(experts, x, torch.where(ok, lid, torch.full_like(lid, el)), capacity)
    out = all_reduce(out.contiguous(), mesh.groups[axis])
    return out if bax is None else all_gather(out, mesh.groups[bax])
