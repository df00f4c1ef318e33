"""Importance-matrix collection for quantization.

The port of ggml_gfx906_tpu/models/imatrix.py (the reference ecosystem's
imatrix tool, llama.cpp tools/imatrix): run the model over calibration
text and record, for every matmul weight, the mean squared activation of
each input column, the `quant_weights` the quantizers take
(ggml_quantize_chunk's imatrix, include/ggml.h:2406-2416).

    from ggml_gfx906_tpu_torch.models import imatrix, llama
    im = imatrix.collect_llama(cfg, params, token_chunks)
    imatrix.save(im, "cal.imatrix.npz")
    # python -m ggml_gfx906_tpu_torch.models.quantize_cli in.gguf out.gguf \
    #     q4_K --imatrix cal.imatrix.npz

    python -m ggml_gfx906_tpu_torch.models.imatrix --model m.gguf \
        --text cal.txt -o cal.imatrix.npz [--chunk 512] [--device cpu]

Keys are the GGUF tensor names (blk.N.attn_q.weight, ...), so the quantize
CLI matches them directly, and the .npz is the reference's format. Σx² is
accumulated per column in f32 on the device, by torch's reduction, whose
order differs from XLA's: the entries agree with the reference's to a
relative 1e-5. The mean is taken in float64, as the reference takes it.
The CLI runs on the card unless given --device cpu (a deliberate
difference from the reference's command).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..ops.quantized import embed_rows, qmatmul
from . import llama as llama_mod


def _sq(name, x, acc):
    """Accumulate Σx² per input column (x (..., K)) and the row count."""
    flat = x.reshape(-1, x.shape[-1]).to(torch.float32)
    s, n = acc.get(name, (0.0, 0))
    acc[name] = (s + torch.sum(flat * flat, dim=0), n + flat.shape[0])


@torch.inference_mode()
def collect_llama(cfg, params: dict, token_chunks, max_seq: int = 512,
                  device=None) -> dict[str, np.ndarray]:
    """Run calibration chunks through the llama forward on the params'
    device (the card unless device="cpu"), recording the mean squared
    activation feeding every matmul weight → {GGUF tensor name: (K,) f32}."""
    device = llama_mod._check_device(params, device)
    acc: dict = {}
    HD = cfg.head_dim
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    for chunk in token_chunks:
        toks = torch.as_tensor(np.asarray(chunk, np.int64), device=device)
        kv = llama_mod.make_cache(cfg, min(max_seq, max(32, len(chunk))), device=device)
        x = embed_rows(params["wte"], toks).to(cfg.compute_dtype)
        S = toks.shape[0]
        pos = torch.arange(S, dtype=torch.int32, device=device)
        for li, blk in enumerate(params["blocks"]):
            H = blk["wq"].shape[0] // HD
            KVH = blk["wk"].shape[0] // HD
            h = llama_mod._rms(x, blk["attn_norm"], cfg.rms_eps)
            for nm in ("attn_q", "attn_k", "attn_v"):
                _sq(f"blk.{li}.{nm}.weight", h, acc)
            q = qmatmul(h, blk["wq"]).reshape(S, H, HD)
            k = qmatmul(h, blk["wk"]).reshape(S, KVH, HD)
            v = qmatmul(h, blk["wv"]).reshape(S, KVH, HD)
            q = llama_mod._rope(cfg, q, pos)
            k = llama_mod._rope(cfg, k, pos)
            att = llama_mod.attend(kv, li, q[None], k[None], v[None], 0, zero)[0]
            _sq(f"blk.{li}.attn_output.weight", att, acc)
            x = x + qmatmul(att, blk["wo"])
            h2 = llama_mod._rms(x, blk["ffn_norm"], cfg.rms_eps)
            _sq(f"blk.{li}.ffn_gate.weight", h2, acc)
            _sq(f"blk.{li}.ffn_up.weight", h2, acc)
            gu = ops.silu(qmatmul(h2, blk["w_gate"])) * qmatmul(h2, blk["w_up"])
            _sq(f"blk.{li}.ffn_down.weight", gu, acc)
            x = x + qmatmul(gu, blk["w_down"])
        xf = llama_mod._rms(x, params["out_norm"], cfg.rms_eps)
        _sq("output.weight", xf, acc)
        _sq("token_embd.weight", xf, acc)   # the tied head's input
    return {name: (s.cpu().numpy().astype(np.float64) / max(n, 1)).astype(np.float32)
            for name, (s, n) in acc.items()}


def save(im: dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **im)


def load(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as f:
        return dict(f)


def main(argv=None):
    """Collect an imatrix from a GGUF model and a text file."""
    import argparse

    from ..gguf.format import GGUFReader
    from . import tokenizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True)
    ap.add_argument("-o", "--out", required=True)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default, the card) or cpu")
    args = ap.parse_args(argv)
    device = llama_mod.resolve(args.device)
    cfg, params = llama_mod.load(args.model, device=device)
    tok = tokenizer.from_gguf(GGUFReader(args.model))
    with open(args.text) as f:
        ids = tok.encode(f.read())
    chunks = [ids[i:i + args.chunk] for i in range(0, max(len(ids) - 1, 1), args.chunk)]
    im = collect_llama(cfg, params, [c for c in chunks if len(c) >= 2], device=device)
    save(im, args.out)
    print(f"wrote {len(im)} imatrix entries to {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
