"""Speculative decoding with exact greedy verification — the port of
ggml_gfx906_tpu/models/speculative.py.

Verifying k drafted tokens in one forward at M = k+1 reads the weights
once, as one decode step does, so every accepted draft token is almost
free; the emitted stream is the greedy chain whatever the draft proposes.
K/V rows written past the accepted prefix are stale but never read: the
next verify window rewrites them before any query attends past its own
position (the reference's docstring, :1-35).

Device-resident, as the reference's jitted step is. `spec_step` is one
captured program (runtime/graphs.py::StepGraph, held by the cache's graph
cache like the decode steps of models/llama.py): its state is a device
history `hist` (cap + k + 1 entries, the reference's slack) and a device
length L; it proposes k tokens by prompt lookup, runs the verify forward at
M = k+1 from the device position L-1, takes the argmax, the accept count m
(the first mismatch, bounded by a sentinel), appends all k+1 greedy tokens
at L and advances L by m+1. `spec_generate` replays it w times per window,
each step writing its (greedy, m) into a device buffer at a device index,
and reads the window back with one copy; the cache's host `length` is set
from the harvested L. The model-draft variant captures k draft steps at
M = 1 on the draft's own cache and the verify forward in one program. On
the CPU the same bodies run as direct calls.

Exactness holds where the verify forward keeps a row's bits across M, as
the default route does (the f32 body and K2). It does not under
qmm_pipeline="on" (K10 rounds x to bf16 at M = 1 only) or where
int8_min_m <= k+1 (the verify takes the int8 route).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import llama
from ..runtime.graphs import HostCopy
from ..runtime.kv_cache import clamp_start


def _propose_ngram(hist: torch.Tensor, L: torch.Tensor, k: int) -> torch.Tensor:
    """Prompt-lookup proposal (reference :49-75): the k tokens that followed
    the most recent earlier occurrence of the current bigram (hist[L-2],
    hist[L-1]), continued modulo the detected period p = L-1-j so that the
    indices stay below L-1; the current token repeated when no bigram
    recurs. hist (maxlen,) int64, L (1,) int64 on its device → (k,) int64,
    with no host read."""
    dev = hist.device
    idx = torch.arange(hist.shape[0], device=dev)
    t1 = hist.index_select(0, L - 1)
    t2 = hist.index_select(0, L - 2)
    prev = torch.roll(hist, 1)
    cand = (hist == t1) & (prev == t2) & (idx >= 1) & (idx < L - 1)
    j = torch.where(cand, idx, torch.full_like(idx, -1)).max()
    p = torch.clamp(L - 1 - j, min=1)
    offs = torch.clamp(j, min=0) + 1 + torch.arange(k, device=dev) % p
    return torch.where(j >= 0, hist.index_select(0, offs), t1.expand(k))


def _verify(cfg, params, draft: torch.Tensor, kv, start):
    """The full model over the k+1 drafted positions from `start` → (greedy
    (k+1,) int64, m 0-dim int64): greedy[i] is the argmax after position
    start+i, m the first index whose draft the model rejects (k when it
    accepts all: the sentinel)."""
    logits = llama._forward(cfg, params, draft, kv, start)
    greedy = torch.argmax(logits, dim=-1)
    ok = torch.cat([draft[1:] == greedy[:-1],
                    torch.zeros(1, dtype=torch.bool, device=draft.device)])
    return greedy, torch.argmin(ok.to(torch.int32))


def spec_step(cfg, k: int, params, carry):
    """One speculative step (reference :78-104), in place: propose k tokens
    by prompt lookup, verify all k+1 positions in one forward, accept the
    greedy prefix, append to the device history. carry = (hist (maxlen,)
    int64, L (1,) int64, kv): hist[L-1] is the current token, written at
    cache row L-1. Returns (carry, (greedy (k+1,), m)): greedy[:m+1] are
    the emitted tokens and L has advanced by m+1. All k+1 candidates are
    appended at L, the start clamped so that they fit, as the reference's
    dynamic_update_slice clamps; the cache's host length is not touched."""
    hist, L, kv = carry
    draft = torch.cat([hist.index_select(0, L - 1), _propose_ngram(hist, L, k)])
    greedy, m = _verify(cfg, params, draft, kv, L - 1)
    cols = clamp_start(L.reshape(()), k + 1, hist.shape[0]) + torch.arange(k + 1,
                                                                          device=hist.device)
    hist.index_copy_(0, cols, greedy)
    L.add_(m + 1)
    return carry, (greedy, m)


def _spec_buffers(kv, k: int, window: int) -> dict:
    """The static buffers of kv's captured spec step, made once: hist, L,
    the step index i and the window's rows out (window, k+2) = the greedy
    tokens, then m. They live beside the cache's graphs."""
    bufs = llama._decoder(kv).buffers
    name = ("spec", k, window)
    if name not in bufs:
        dev = kv.k[0].device
        bufs[name] = {
            "hist": torch.zeros(kv.max_seq + k + 1, dtype=torch.int64, device=dev),
            "L": torch.zeros(1, dtype=torch.int64, device=dev),
            "i": torch.zeros(1, dtype=torch.int64, device=dev),
            "out": torch.zeros((window, k + 2), dtype=torch.int64, device=dev)}
    return bufs[name]


def _spec_graph(cfg, k: int, params, kv, b: dict):
    """The captured spec_step on kv over the buffers b, which must hold a
    valid history and L already (the capture's warm-up runs one step)."""
    def body():
        _, (greedy, m) = spec_step(cfg, k, params, (b["hist"], b["L"], kv))
        b["out"].index_copy_(0, b["i"], torch.cat([greedy, m.reshape(1)])[None])
        b["i"].add_(1)
        return greedy, m

    key = ("spec", k, b["out"].shape[0], id(params), kv.k[0].data_ptr(),
           b["hist"].data_ptr(), cfg)
    return llama._decoder(kv).graphs.get(key, body, state=(b["hist"], b["L"], b["i"]))


def _prefilled(cfg, params, prompt: list[int], k: int, cap: int, window: int, device):
    """(kv, the captured step, its buffers, the first token's host copy):
    a cap-row cache prefilled with the prompt, the device history holding
    prompt + first token (with k+1 slack rows, so the unconditional
    (k+1)-token append never clamps mid-window) and L = P + 1."""
    P = len(prompt)
    kv = llama.make_cache(cfg, cap, device=device)
    toks = torch.as_tensor(np.asarray(prompt, np.int64), device=device)
    logits, kv = llama.forward(cfg, params, toks, kv, 0)
    b = _spec_buffers(kv, k, window)
    hist = b["hist"]
    hist.zero_()
    hist[:P].copy_(toks)
    hist[P:P + 1].copy_(torch.argmax(logits[-1]).reshape(1))
    b["L"].fill_(P + 1)
    return kv, _spec_graph(cfg, k, params, kv, b), b, HostCopy(hist[P:P + 1])


@torch.inference_mode()
def spec_generate(cfg, params, prompt_tokens, n_predict: int, k: int = 8,
                  max_seq: int | None = None, window: int = 8,
                  return_stats: bool = False, device=None):
    """Greedy decode accelerated by self-lookup speculation; the token
    stream is IDENTICAL to llama.generate(greedy) on the default route
    (reference :114-166). k: drafted tokens per verify step (one captured
    program); window: steps replayed per read-back. Runs on the card
    unless device="cpu"."""
    device = llama._check_device(params, device)
    prompt = list(map(int, prompt_tokens))
    if n_predict < 1:
        return (list(prompt), {"spec_steps": 0, "accepted_per_step": [],
                               "accept_rate": 0.0, "tokens_per_step": 0}
                ) if return_stats else list(prompt)
    P = len(prompt)
    cap = max_seq or cfg.n_ctx
    if P + n_predict + k + 1 > cap:
        raise ValueError(f"need max_seq >= {P + n_predict + k + 1}")
    kv, g, b, first = _prefilled(cfg, params, prompt, k, cap, window, device)

    out: list[int] = []
    steps = 0
    accepts: list[int] = []
    while len(out) < n_predict - 1:
        # a step is safe while L <= cap-k (its writes reach row L-1+k);
        # clamp the window so even all-accept steps stay inside the cache
        L_now = P + 1 + len(out)
        w = min(window, max(1, (cap - k - L_now) // (k + 1) + 1))
        b["i"].zero_()
        for _ in range(w):
            g.replay()
        steps += w
        for row in HostCopy(b["out"][:w]).numpy():
            m = int(row[-1])
            accepts.append(m)
            out.extend(int(t) for t in row[:m + 1])
        kv.length = P + 1 + len(out)
    stream = prompt + [int(first.numpy()[0])] + out[:n_predict - 1]
    if return_stats:
        return stream, {
            "spec_steps": steps,
            "accepted_per_step": accepts,
            "accept_rate": float(np.mean(accepts)) / k if steps else 0.0,
            "tokens_per_step": (1 + float(np.mean(accepts))) if steps else 0,
        }
    return stream


# ---------------------------------------------------------------------------
# model-draft variant (layer-skip self-draft or an independent small model)


def make_layer_draft(cfg, params, n_layers: int):
    """Layer-skip self-draft: the first n_layers blocks of the same model
    (weights shared, no extra device memory)."""
    dcfg = dataclasses.replace(cfg, n_layer=n_layers)
    dparams = dict(params)
    dparams["blocks"] = params["blocks"][:n_layers]
    return dcfg, dparams


def model_spec_step(cfg, dcfg, k: int, params, kv, dparams, dkv, tok, start):
    """One speculative step with a MODEL draft (reference :183-205): k
    greedy draft steps at M = 1 on the draft's own cache, then one
    full-model verify of all k+1 positions. tok (1,) and start (1,) are
    device buffers advanced in place to the next token and position.
    Returns (greedy, m, kv, dkv, tok, start); the emitted tokens are
    greedy[:m+1]."""
    t, drafted = tok, []
    for i in range(k):
        drafted.append(t)
        lg = llama._forward(dcfg, dparams, t, dkv, start + i)
        t = torch.argmax(lg[-1]).reshape(1)
    greedy, m = _verify(cfg, params, torch.cat(drafted + [t]), kv, start)
    tok.copy_(greedy.index_select(0, m.reshape(1)))
    start.add_((m + 1).to(start.dtype))
    return greedy, m, kv, dkv, tok, start


@torch.inference_mode()
def model_spec_generate(cfg, params, prompt_tokens, n_predict: int,
                        draft: tuple | None = None, draft_layers: int = 4,
                        k: int = 4, max_seq: int | None = None,
                        return_stats: bool = False, device=None):
    """Greedy decode with a MODEL draft (default: the layer-skip self-draft
    of the first `draft_layers` blocks, weights shared); the stream is
    identical to llama.generate(greedy) on the default route (reference
    :208-243). draft: an optional (dcfg, dparams) sharing the vocabulary.
    Each step is one replay of a program captured on the main cache, read
    back once."""
    device = llama._check_device(params, device)
    dcfg, dparams = draft or make_layer_draft(cfg, params, draft_layers)
    prompt = list(map(int, prompt_tokens))
    P = len(prompt)
    cap = max_seq or cfg.n_ctx
    if P + n_predict + k + 1 > cap:
        raise ValueError(f"need max_seq >= {P + n_predict + k + 1}")
    kv = llama.make_cache(cfg, cap, device=device)
    dkv = llama.make_cache(dcfg, cap, device=device)
    toks = torch.as_tensor(np.asarray(prompt, np.int64), device=device)
    logits, kv = llama.forward(cfg, params, toks, kv, 0)
    _, dkv = llama.forward(dcfg, dparams, toks, dkv, 0)
    d = llama._decoder(kv)
    d.load(torch.argmax(logits[-1]), P)

    def body():
        greedy, m, *_ = model_spec_step(cfg, dcfg, k, params, kv, dparams, dkv, d.tok, d.pos)
        return torch.cat([greedy, m.reshape(1)])

    key = ("model_spec", k, id(params), id(dparams), kv.k[0].data_ptr(),
           dkv.k[0].data_ptr(), cfg, dcfg)
    g = d.graphs.get(key, body, state=(d.tok, d.pos))
    out = [int(HostCopy(d.tok).numpy()[0])]
    accepts = []
    while len(out) < n_predict:
        row = HostCopy(g.replay()[0]).numpy()
        mi = int(row[-1])
        accepts.append(mi)
        out.extend(int(t) for t in row[:mi + 1])
        kv.length = dkv.length = P + len(out) - 1
    stream = prompt + out[:n_predict]
    if return_stats:
        return stream, {"spec_steps": len(accepts),
                        "accepted_per_step": accepts,
                        "accept_rate": (float(np.mean(accepts)) / k
                                        if accepts else 0.0)}
    return stream
