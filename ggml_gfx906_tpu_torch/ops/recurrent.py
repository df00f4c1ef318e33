"""Recurrent token-mixing ops and MoE routing — the port of
ggml_gfx906_tpu/ops/recurrent.py, name for name.

ref: src/ggml-cpu/ops.cpp scalar kernels —
rwkv_wkv6 (state' = decay⊙state + k⊗v; out = r·(u⊙(k⊗v) + state)),
rwkv_wkv7 (state' = w⊙state + v⊗k + (state·a)⊗b; out = state·r),
gated_linear_attn (state' = g⊙state + k⊗v; out = scale·q·state');
ggml_mul_mat_id (per-token expert routing, include/ggml.h).

The token recurrences are loops over T (the reference runs lax.scan),
vectorised over batch, heads and channels, with the reference's [i, j]
state layout per head.

MoE routing: the dispatch is static-shape, as the reference's GShard
dispatch is: queue positions from a cumsum of the one-hot, a scatter into
an (E·C + 1, K) buffer whose last row takes the drops, one product per
expert on all C rows, a gather back. No nonzero, no boolean indexing: the
engine's CUDA graphs capture it."""
from __future__ import annotations

import torch


def _steps(*xs):
    """(B, T, H, D) inputs → per-token (B, H, D) f32 slices."""
    return zip(*(x.float().unbind(1) for x in xs))


def rwkv_wkv6(k, v, r, time_faaaa, time_decay, state0):
    """k, v, r, time_decay: (B, T, H, D); time_faaaa: (H, D);
    state0: (B, H, D, D) indexed [i(k/r-dim), j(v-dim)].
    Returns (out (B, T, H, D), state (B, H, D, D))."""
    u = time_faaaa.float()
    state = state0.float()
    outs = []
    for kt, vt, rt, wt in _steps(k, v, r, time_decay):
        kv = kt[..., :, None] * vt[..., None, :]          # (B, H, D, D) [i, j]
        outs.append(torch.einsum("bhi,bhij->bhj", rt, u[None, :, :, None] * kv + state))
        state = state * wt[..., :, None] + kv
    return torch.stack(outs, dim=1), state


def rwkv_wkv7(r, w, k, v, a, b, state0):
    """All of r/w/k/v/a/b: (B, T, H, D); state0: (B, H, D, D) indexed
    [i(v-dim), j(r/w/k-dim)]. Returns (out (B, T, H, D), state)."""
    state = state0.float()
    outs = []
    for rt, wt, kt, vt, at, bt in _steps(r, w, k, v, a, b):
        sa = torch.einsum("bhj,bhij->bhi", at, state)    # (B, H, D_i)
        state = (state * wt[..., None, :]
                 + vt[..., :, None] * kt[..., None, :]
                 + sa[..., :, None] * bt[..., None, :])
        outs.append(torch.einsum("bhij,bhj->bhi", state, rt))
    return torch.stack(outs, dim=1), state


def gated_linear_attn(k, v, q, g, state0, scale: float = 1.0):
    """k, v, q, g: (B, T, H, D); state0 (B, H, D, D) [i(k/q-dim), j(v-dim)].
    Returns (out (B, T, H, D), state)."""
    state = state0.float()
    outs = []
    for kt, vt, qt, gt in _steps(k, v, q, g):
        state = state * gt[..., :, None] + kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", qt * float(scale), state))
    return torch.stack(outs, dim=1), state


def mul_mat_id(experts, x, ids, capacity: int | None = None):
    """Routed matmul: out[t, u] = x[t, u] @ experts[ids[t, u]].T.

    experts: an (E, N, K) tensor or a sequence of E per-expert weights,
    each a dense (N, K) tensor or a QuantTensor. x (T, U, K); ids (T, U)
    integer. Returns (T, U, N) in x.dtype.

    capacity (default T·U, exact for any routing): rows per expert; a
    token past its expert's capacity gets zeros. ids outside [0, E) mark
    dropped tokens: zeros, and no queue position taken.

    Each expert's product runs on all C rows of its buffer, empty ones
    included (reference :120-125), so a quantized expert's kernel route
    (ops/cuda/dispatch.py) is chosen by C, as the reference's is, whatever
    the routing."""
    from .quantized import QuantTensor, qmatmul

    T, U, K = x.shape
    E = len(experts)
    C = T * U if capacity is None else min(capacity, T * U)
    dev = x.device
    xf = x.reshape(T * U, K)
    idf = ids.reshape(T * U).to(torch.int64)
    idc = idf.clamp(0, E - 1)
    onehot = (idf[:, None] == torch.arange(E, device=dev)[None, :]).to(torch.int32)
    # each token's place in its expert's queue; an out-of-range id has an
    # all-zero one-hot row and advances no queue
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1, idc[:, None])[:, 0]
    keep = (pos < C) & (idf >= 0) & (idf < E)
    slot = torch.where(keep, idc * C + pos, torch.full_like(idc, E * C))
    buf = torch.zeros(E * C + 1, K, dtype=torch.float32, device=dev)
    buf[slot] = xf.float()
    buf = buf[:E * C].reshape(E, C, K)
    if isinstance(experts, (list, tuple)):
        y = torch.stack([qmatmul(buf[e], w) if isinstance(w, QuantTensor)
                         else buf[e] @ w.float().T for e, w in enumerate(experts)])
    else:
        y = torch.matmul(buf, experts.float().transpose(1, 2))      # (E, C, N)
    yf = y.reshape(E * C, y.shape[-1])
    out = yf[torch.where(keep, idc * C + pos, torch.zeros_like(idc))]
    out = torch.where(keep[:, None], out, torch.zeros((), dtype=out.dtype, device=dev))
    return out.reshape(T, U, -1).to(x.dtype)
