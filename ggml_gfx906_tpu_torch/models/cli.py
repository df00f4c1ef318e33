"""CLI inference drivers — the port of ggml_gfx906_tpu/models/cli.py, with
the reference's flags and defaults.

Single-sequence generate (eager `llama.generate` with a greedy or seeded
top-k/top-p sampler; `--spec K` runs exact-greedy speculative decoding):

    python -m ggml_gfx906_tpu_torch.models.cli -m model.gguf -p "hello" -n 32

Continuous-batching serving through the port's Engine (completions as
`[i] text` on stdout, the aggregate tok/s on stderr):

    python -m ggml_gfx906_tpu_torch.models.cli serve -m model.gguf \\
        --prompts prompts.txt -n 64 --max-batch 8

One flag the reference lacks, `--device` (default cuda), asks for the CPU
as `device=` does on the port's entry points; without a CUDA device and
without `--device cpu` the commands raise. The llama (dense and mixture
of experts), gpt2 and gptj architectures are served, as in the reference:
`--spec` takes the dense llama only, and `serve` takes the models with a
batched forward (llama, the expert llama, gpt2), so on a gptj file it
exits 1 with a message where the reference's Engine would fail.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

def _model_module(reader):
    """(arch, the model module that serves it) from a GGUF's metadata, as
    the reference's :29-43 dispatch; module None for another
    architecture. Nothing is loaded."""
    arch = reader.kv.get("general.architecture")
    if arch == "gpt2":
        from . import gpt2 as mod
    elif arch == "gptj":
        from . import gptj as mod
    elif arch == "llama" and int(reader.kv.get("llama.expert_count", 0)) >= 2:
        from . import moe as mod
    elif arch == "llama":
        from . import llama as mod
    else:
        mod = None
    return arch, mod


def _unsupported(arch) -> int:
    print(f"error: unsupported architecture {arch!r}", file=sys.stderr)
    return 1


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; 'cpu' runs the kernels' plain "
                         "versions)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    return generate_main(argv)


def serve_main(argv):
    """`serve`: N prompts through the continuous-batching Engine, each
    completion printed as it finishes, the aggregate tok/s at the end."""
    ap = argparse.ArgumentParser(prog="cli serve", description="batched GGUF serving")
    ap.add_argument("-m", "--model", required=True, help="GGUF model path")
    ap.add_argument("--prompts", required=True,
                    help="file with one prompt per line ('-' = stdin)")
    ap.add_argument("--tokens", action="store_true",
                    help="prompt lines are comma-separated token ids")
    ap.add_argument("-n", "--n-predict", type=int, default=64,
                    help="max new tokens per request")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine slots (parallel sequences)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="per-slot KV capacity (default: model n_ctx, at most 2048)")
    ap.add_argument("--paged-pages", type=int, default=None,
                    help="use a paged KV pool of this many pages")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (sets config kv_quant)")
    ap.add_argument("--weights-layout", default=None,
                    choices=["kernel", "int8", "auto"],
                    help="execution layout (default: config weights_layout)")
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--temp", type=float, default=0.0,
                    help="0 = greedy (default)")
    ap.add_argument("-s", "--seed", type=int, default=0,
                    help="base seed (request i uses seed+i)")
    ap.add_argument("--no-eos", action="store_true",
                    help="ignore the tokenizer eos id (always run -n)")
    _add_device(ap)
    args = ap.parse_args(argv)

    from ..gguf import GGUFReader
    from ..runtime.engine import Engine
    from ..utils import config
    from ..utils.device import resolve
    from . import tokenizer

    device = resolve(args.device)
    reader = GGUFReader(args.model)
    arch, mod = _model_module(reader)
    if mod is None:
        return _unsupported(arch)
    if not hasattr(mod, "forward_batch"):
        print(f"error: serve needs a batched forward, which the {arch!r} architecture "
              "does not have (as in the reference); use the generate command",
              file=sys.stderr)
        return 1
    cfg, params = mod.load(args.model, device=device, layout=args.weights_layout)
    tok = tokenizer.from_gguf(reader)

    src = sys.stdin if args.prompts == "-" else open(args.prompts)
    with src:
        lines = [ln.rstrip("\n") for ln in src if ln.strip()]
    if not lines:
        print("error: no prompts", file=sys.stderr)
        return 1
    if args.tokens:
        prompt_ids = [[int(t) for t in ln.split(",")] for ln in lines]
    else:
        if tok is None:
            print("error: model has no tokenizer; use --tokens", file=sys.stderr)
            return 1
        prompt_ids = [tok.encode(ln) for ln in lines]

    eos_id = None
    if not args.no_eos and tok is not None:
        eos_id = getattr(tok, "eos_id", None)
    max_seq = args.max_seq or min(cfg.n_ctx, 2048)
    print(f"model: {arch}, {cfg.n_layer} layers, n_embd={cfg.n_embd}, "
          f"slots={args.max_batch}, max_seq={max_seq}, "
          f"device: {_device_name(device)}", file=sys.stderr)

    if args.kv_quant:
        config.set("kv_quant", True)
    eng = Engine(mod, cfg, params, max_batch=args.max_batch, max_seq=max_seq,
                 paged_pages=args.paged_pages, device=device)
    rid2idx = {}
    for i, ids in enumerate(prompt_ids):
        rid = eng.submit(ids, args.n_predict, eos_id=eos_id, temp=args.temp,
                         top_k=args.top_k, top_p=args.top_p, seed=args.seed + i)
        rid2idx[rid] = i

    t0 = time.time()

    def on_finish(req):
        i = rid2idx[req.rid]
        text = tok.decode(req.out) if tok is not None else ",".join(map(str, req.out))
        print(f"[{i}] {text}", flush=True)
        print(f"[{i}] done: {len(req.out)} tokens at +{time.time() - t0:.2f}s",
              file=sys.stderr)

    done = eng.run(on_finish=on_finish)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s aggregate incl. compile)", file=sys.stderr)
    return 0


def generate_main(argv):
    ap = argparse.ArgumentParser(description="GGUF model inference")
    ap.add_argument("-m", "--model", required=True, help="GGUF model path")
    ap.add_argument("-p", "--prompt", default=None, help="text prompt")
    ap.add_argument("--tokens", default=None,
                    help="comma-separated token ids (bypasses tokenizer)")
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--temp", type=float, default=0.9)
    ap.add_argument("-s", "--seed", type=int, default=-1)
    ap.add_argument("--greedy", action="store_true", help="argmax decoding")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative greedy decoding: verify K prompt-lookup-drafted "
                         "tokens per forward (stream identical to --greedy)")
    _add_device(ap)
    args = ap.parse_args(argv)

    from ..gguf import GGUFReader
    from ..runtime.sampling import greedy, prng_key, sample_top_k_top_p, split
    from ..utils.device import resolve
    from . import llama, tokenizer

    device = resolve(args.device)
    reader = GGUFReader(args.model)
    arch, mod = _model_module(reader)
    if mod is None:
        return _unsupported(arch)
    if args.spec and mod is not llama:
        print("error: --spec supports the llama architecture", file=sys.stderr)
        return 1
    cfg, params = mod.load(args.model, device=device)

    tok = tokenizer.from_gguf(reader)
    if args.tokens is not None:
        prompt_ids = [int(t) for t in args.tokens.split(",")]
    elif args.prompt is not None:
        if tok is None:
            print("error: model has no tokenizer; use --tokens", file=sys.stderr)
            return 1
        prompt_ids = tok.encode(args.prompt)
    else:
        print("error: need -p or --tokens", file=sys.stderr)
        return 1
    if not prompt_ids:
        print("error: empty prompt after tokenization", file=sys.stderr)
        return 1

    print(f"model: {arch}, {cfg.n_layer} layers, n_embd={cfg.n_embd}, "
          f"device: {_device_name(device)}", file=sys.stderr)
    print(f"prompt tokens: {prompt_ids}", file=sys.stderr)

    if args.spec:
        from . import speculative

        t0 = time.time()
        out, stats = speculative.spec_generate(cfg, params, prompt_ids, args.n_predict,
                                               k=args.spec, return_stats=True,
                                               device=device)
        dt = time.time() - t0
        n_new = len(out) - len(prompt_ids)
        print(f"generated {n_new} tokens in {dt:.2f}s "
              f"({n_new / dt:.1f} tok/s incl. compile; "
              f"accept {stats['accept_rate']:.2f}, "
              f"{stats['tokens_per_step']:.1f} tok/verify)", file=sys.stderr)
        print(tok.decode(out) if tok is not None else ",".join(map(str, out)))
        return 0

    if args.greedy:
        sampler = greedy
    else:
        seed = args.seed if args.seed >= 0 else int(time.time())
        key_holder = [prng_key(seed)]

        def sampler(logits):
            key_holder[0], sub = split(key_holder[0])
            return sample_top_k_top_p(logits, sub, args.top_k, args.top_p, args.temp)

    t0 = time.time()
    out = mod.generate(cfg, params, prompt_ids, args.n_predict, sampler=sampler,
                       device=device)
    dt = time.time() - t0
    n_new = len(out) - len(prompt_ids)
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s incl. compile)", file=sys.stderr)
    print(tok.decode(out) if tok is not None else ",".join(map(str, out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
