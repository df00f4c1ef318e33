"""Process mesh + sharding rules — the port of ggml_gfx906_tpu/parallel/
mesh.py (:1-84).

The reference is one controller over a jax Mesh: a global array is
sharded by a PartitionSpec and GSPMD (or shard_map) emits the collectives.
The port is one process per mesh position on torch.distributed:

- each rank holds its local shard of a sharded array (`shard_array`), and
  every rank holds the whole of a replicated one (`P()`);
- `psum` is `dist.all_reduce` on the axis's process group, `ppermute` is
  `dist.batch_isend_irecv` (`ppermute` below), `axis_index` is the rank's
  coordinate (`Mesh.index`);
- an output the reference shards over an axis (its out spec `P('dp',
  ...)`) is all-gathered over that axis, so every rank returns the
  reference's global value and the host logic on every rank (the engine's
  scheduler) sees the same tokens and stays in lockstep.

Axes: dp (data/batch), tp (tensor: weight rows/cols), sp (sequence); ep
(experts, parallel/ep.py) and pp (pipeline stages, parallel/pp.py) build
their own meshes the same way.

Backends: NCCL on the card, gloo on the CPU (and gloo on the card where
two processes share one card, which NCCL refuses). A mesh on an NCCL
group runs one collective on each of its groups when it is made, so that
no communicator is created inside a CUDA-graph capture; gloo collectives
cannot be captured at all (`Mesh.capturable`). Gloo stages a CUDA tensor
through host memory itself in all_reduce and all_gather; its point-to-
point sends are staged here, through pinned host buffers (`send_recv`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops.quantized import QuantTensor
from ..utils.device import resolve


class P(tuple):
    """A PartitionSpec: one entry per array axis, a mesh axis name (the
    axis is split into that axis's size of equal parts, this rank taking
    the part at its coordinate) or None (kept whole). Missing trailing
    entries are None; P() is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(eq=False)
class Mesh:
    """This rank's place in a mesh of processes: the axes and their sizes
    (`shape`, as jax's mesh.shape), its coordinate on each axis, and one
    process group per axis (the ranks that share the other coordinates),
    with the global ranks of that group in coordinate order."""
    shape: dict
    coords: dict
    groups: dict
    ranks: dict
    device: torch.device
    backend: str

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on the axis (the reference's
        jax.lax.axis_index); 0 for an axis the mesh does not have."""
        return self.coords.get(axis, 0)

    @property
    def capturable(self) -> bool:
        """Whether CUDA graphs can hold this mesh's collectives: NCCL's can
        be captured, gloo's cannot."""
        return self.backend == "nccl" and self.device.type == "cuda"


def build_mesh(names: tuple, sizes: tuple, device=None, backend: str | None = None):
    """The mesh of axes `names` of sizes `sizes` over the first prod(sizes)
    ranks of the default process group, rank r at the C-order coordinate
    np.unravel_index(r, sizes) (the reference's np.reshape of its device
    list). Every rank of the world calls it, in the same order, since
    dist.new_group must be called by every rank for every group; a rank
    past the mesh gets None. device: the card unless "cpu" is asked for
    (the rank's card is cuda:rank % device_count; two ranks may share one
    under gloo); backend: the groups' backend, NCCL on the card and gloo on
    the CPU by default."""
    device = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group(backend, init_method, world_size, rank) first")
    n = int(np.prod(sizes))
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < n:
        raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {n} ranks, "
                         f"the world has {world}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    grid = np.arange(n).reshape(sizes)
    groups, ranks = {}, {}
    for ax, name in enumerate(names):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax]):
            members = [int(r) for r in line]
            g = dist.new_group(members, backend=backend)
            if rank in members:
                groups[name], ranks[name] = g, members
    if rank >= n:
        return None
    coords = {name: int(c) for name, c in zip(names, np.unravel_index(rank, sizes))}
    mesh = Mesh(dict(zip(names, map(int, sizes))), coords, groups, ranks, device, backend)
    if backend == "nccl":
        torch.cuda.set_device(device)
        probe = torch.zeros(1, device=device)
        for g in groups.values():
            dist.all_reduce(probe, group=g)
        torch.cuda.synchronize(device)
    return mesh


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, device=None,
              backend: str | None = None) -> Mesh | None:
    """The (dp, tp, sp) mesh (build_mesh)."""
    return build_mesh(("dp", "tp", "sp"), (dp, tp, sp), device, backend)


# ------------------------------------------------------------ collectives

def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the group, in place (psum)."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated on `dim` in coordinate order (an
    output sharded over the group's axis, as every rank's global value)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def send_recv(mesh: Mesh, axis: str, send: torch.Tensor | None = None, dst: int | None = None,
              like: torch.Tensor | None = None, src: int | None = None):
    """Point-to-point on the axis's group, both halves posted together
    (dist.batch_isend_irecv): `send` to the rank at coordinate `dst`, and
    a tensor shaped like `like` from the rank at coordinate `src` (either
    half may be None). Returns the received tensor, or None. On a gloo mesh
    CUDA tensors go through pinned host buffers: gloo's point-to-point
    sends take host tensors, where its all_reduce and all_gather stage CUDA
    tensors themselves."""
    stage = mesh.backend == "gloo" and mesh.device.type == "cuda"
    group, peers = mesh.groups[axis], mesh.ranks[axis]
    ops, out = [], None
    if send is not None:
        buf = send.contiguous()
        if stage:
            buf = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True).copy_(buf)
        ops.append(dist.P2POp(dist.isend, buf, peers[dst], group))
    if like is not None:
        out = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True) if stage
               else torch.empty_like(like, memory_format=torch.contiguous_format))
        ops.append(dist.P2POp(dist.irecv, out, peers[src], group))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return out.to(like.device) if stage and out is not None else out


def ppermute(t: torch.Tensor, mesh: Mesh, axis: str, shift: int = 1) -> torch.Tensor:
    """Each rank sends t to the rank `shift` ahead of it on `axis` (ring
    order) and returns what the rank `shift` behind sent (the reference's
    jax.lax.ppermute with perm [(i, (i + shift) % n)])."""
    n, i = mesh.size(axis), mesh.index(axis)
    if n == 1:
        return t.clone()
    return send_recv(mesh, axis, t, (i + shift) % n, t, (i - shift) % n)


# ---------------------------------------------------------------- sharding

def shard_array(mesh: Mesh, x, spec: P) -> torch.Tensor:
    """This rank's part of `x` (a tensor or an array) under `spec`, on the
    mesh's device, in memory of its own (not a view of x); a replicated
    x (no axis named) is moved as it is. Raises where an axis does not
    divide by its mesh axis."""
    x = torch.as_tensor(x)
    part = x
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.size(ax)
        if part.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not divide by {ax}={n}")
        if n == 1:
            continue
        c = part.shape[dim] // n
        part = part.narrow(dim, mesh.index(ax) * c, c)
    if part is x:
        return x.to(mesh.device)
    return part.to(mesh.device, copy=True).contiguous()


def shard_quant_tensor(mesh: Mesh, qt: QuantTensor, spec: P) -> QuantTensor:
    """Shard a quantized weight by its weight-level spec (rows, cols). The
    kernel and wire layouts' fields are (N, nb·bytes) per row
    (ops/quantized.py), so rows split axis 0 of every field and columns
    axis 1, at block boundaries when K / n is a multiple of the type's
    superblock (parallel/tp.py checks it); the tile-major int8 layout keeps
    rows on axis 1 of w8t (Kt, N, tile) / dwt (Kt, N) and K-tiles on axis 0
    (reference :33-46). The shard's logical shape is its own
    (`QuantTensor.localize`): the reference's keeps the whole weight's for
    shard_map, while here each rank computes on its shard alone."""
    if len(spec) > len(qt.shape):
        raise ValueError(f"spec {spec} has more axes than {qt.shape}")
    row = spec[0] if len(spec) > 0 else None
    col = spec[1] if len(spec) > 1 else None

    def fspec(a):
        rest = [None] * (a.ndim - 2)
        return P(col, row, *rest) if qt.layout == "int8" else P(row, col, *rest)

    fields = {k: shard_array(mesh, v, fspec(v)) for k, v in qt.fields.items()}
    return QuantTensor(qt.qtype, qt.shape, fields, qt.layout).localize()


# Sharding rules for transformer param pytrees (gpt2/gptj/llama naming).
# Megatron-style: fused QKV + ffn_up row-split (output features), proj +
# ffn_down col-split (input features) → one all-reduce per sublayer.
GPT2_RULES = {
    "wte": P(None, None),
    "wpe": P(None, None),
    "lm_head": P("tp", None),
    "ln_f_g": P(None), "ln_f_b": P(None),
    "qkv_w": P("tp", None), "qkv_b": P("tp"),
    "proj_w": P(None, "tp"), "proj_b": P(None),
    "up_w": P("tp", None), "up_b": P("tp"),
    "down_w": P(None, "tp"), "down_b": P(None),
    "ln1_g": P(None), "ln1_b": P(None),
    "ln2_g": P(None), "ln2_b": P(None),
}


def shard_gpt2_params(mesh: Mesh, params: dict, rules: dict | None = None) -> dict:
    """Apply per-name specs to a gpt2-style params tree (names without a
    rule are replicated)."""
    rules = rules or GPT2_RULES

    def place(name, x):
        spec = rules.get(name, P())
        if isinstance(x, QuantTensor):
            return shard_quant_tensor(mesh, x, spec)
        return shard_array(mesh, x, spec)

    out = {k: place(k, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [{k: place(k, v) for k, v in blk.items()} for blk in params["blocks"]]
    return out
