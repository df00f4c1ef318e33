"""Perplexity evaluation over a token stream — the port of
ggml_gfx906_tpu/models/perplexity.py.

The stream is split into fixed windows of n_ctx; each window is evaluated
in one forward and every in-window next-token prediction past a warm-up
prefix contributes -log p(target) to the running mean (llama.cpp's
tools/perplexity, the quality gate for quantization formats).

The last window is zero-padded to n_ctx and masked, as the reference pads
it, so every window runs at one M, on one matmul route, with one set of
bits (a shorter last window could cross int8_min_m and change route). The
cache is made once and reused: every window starts at 0 and rewrites rows
[0, n_ctx), and the causal mask never reads past them.

    python -m ggml_gfx906_tpu_torch.models.perplexity --model m.gguf \\
        --text corpus.txt [--n-ctx 512] [--device cpu]
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _window_nll(forward_w, params, toks, targets, mask):
    """(sum of -log p(targets[i] | toks[:i+1]) over masked positions, the
    mask's count), both f32 0-dim tensors. forward_w: (params, toks (W,)) →
    logits (W, V)."""
    logits = forward_w(params, toks)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, targets[:, None])[:, 0]
    m = mask.float()
    return (nll * m).sum(), m.sum()


@torch.inference_mode()
def perplexity_stream(forward_w, params, tokens, n_ctx: int = 512,
                      warmup: int | None = None, device=None) -> dict:
    """Evaluate ppl of `tokens` (1-D ints) with window size n_ctx on
    `device` (reference :38-69). Windows are non-overlapping; within each
    window the first `warmup` predictions (default n_ctx//4) are excluded,
    except in the first window. The final partial window is zero-padded and
    masked."""
    toks = np.asarray(tokens, np.int64)
    if toks.size < 2:
        raise ValueError("need at least 2 tokens")
    warmup = n_ctx // 4 if warmup is None else warmup
    total_nll, total_n = 0.0, 0.0
    for s in range(0, toks.size - 1, n_ctx):
        win = toks[s:s + n_ctx + 1]
        inp, tgt = win[:-1], win[1:]
        valid = np.zeros(n_ctx, np.float32)
        valid[:len(tgt)] = 1.0
        start = 0 if s == 0 else warmup       # the first window counts fully
        valid[:start] = 0.0
        pad = n_ctx - len(inp)
        if pad:
            inp = np.pad(inp, (0, pad))
            tgt = np.pad(tgt, (0, pad))
        if valid.sum() == 0:
            continue
        nll, cnt = _window_nll(forward_w, params, *(torch.from_numpy(a).to(device)
                                                    for a in (inp, tgt, valid)))
        total_nll += float(nll)
        total_n += float(cnt)
    mean = total_nll / max(total_n, 1.0)
    return {"ppl": math.exp(mean), "nll": mean, "n_tokens": int(total_n)}


def perplexity_llama(cfg, params, tokens, n_ctx: int = 512, device=None, **kw) -> dict:
    """perplexity_stream over the llama forward, on the card unless
    device="cpu"; one n_ctx-row cache serves every window."""
    from . import llama

    device = llama._check_device(params, device)
    kv = llama.make_cache(cfg, n_ctx, device=device)

    def fw(p, toks):
        return llama._forward(cfg, p, toks, kv, 0)

    return perplexity_stream(fw, params, tokens, n_ctx, device=device, **kw)


def perplexity_gpt2(cfg, params, tokens, n_ctx: int = 512, device=None, **kw) -> dict:
    """perplexity_stream over the gpt2 forward (reference :83-93), on the
    card unless device="cpu"; one n_ctx-row cache serves every window."""
    from . import gpt2, llama

    device = llama._check_device(params, device)
    kv = gpt2.make_cache(cfg, n_ctx, device=device)

    def fw(p, toks):
        return gpt2._forward(cfg, p, toks, kv, 0)

    return perplexity_stream(fw, params, tokens, n_ctx, device=device, **kw)


def main(argv=None):
    """CLI: perplexity of a GGUF llama model over a text file."""
    import argparse

    from ..gguf.format import GGUFReader
    from . import llama, tokenizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True)
    ap.add_argument("--n-ctx", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    cfg, params = llama.load(args.model, device=args.device)
    tok = tokenizer.from_gguf(GGUFReader(args.model))
    with open(args.text) as f:
        ids = tok.encode(f.read())
    res = perplexity_llama(cfg, params, ids, n_ctx=args.n_ctx, device=args.device)
    print(f"ppl = {res['ppl']:.4f}  (nll {res['nll']:.4f} over "
          f"{res['n_tokens']} tokens)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
