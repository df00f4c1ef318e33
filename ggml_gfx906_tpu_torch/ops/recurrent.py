"""MoE routing (GGML_OP_MUL_MAT_ID) — the port of ggml_gfx906_tpu/ops/
recurrent.py:76-131. The RWKV and gated-linear-attention ops of that
module are not ported yet.

The dispatch is static-shape, as the reference's GShard dispatch is: queue
positions from a cumsum of the one-hot, a scatter into an (E·C + 1, K)
buffer whose last row takes the drops, one product per expert on all C
rows, a gather back. No nonzero, no boolean indexing: the engine's CUDA
graphs capture it."""
from __future__ import annotations

import torch


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
