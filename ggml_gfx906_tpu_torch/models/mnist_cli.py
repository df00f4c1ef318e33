"""MNIST train/eval CLI — the port of ggml_gfx906_tpu/models/mnist_cli.py,
the analogue of the reference's mnist-train and mnist-eval binaries
(examples/mnist/mnist-train.cpp, mnist-eval.cpp).

    python -m ggml_gfx906_tpu_torch.models.mnist_cli train --arch fc -o model.gguf
    python -m ggml_gfx906_tpu_torch.models.mnist_cli eval -m model.gguf

Reads idx-format MNIST files when given (--images/--labels, same files the
reference uses); falls back to the synthetic dataset otherwise. `--device`
(default cuda: the card) is the port's own: without a card the command
raises unless given `--device cpu`.
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

from ..utils.device import resolve


def load_idx_images(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, n, h, w = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx image magic {magic}")
        data = np.frombuffer(f.read(n * h * w), dtype=np.uint8)
    return (data.reshape(n, h * w).astype(np.float32)) / 255.0


def load_idx_labels(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx label magic {magic}")
        ys = np.frombuffer(f.read(n), dtype=np.uint8)
    return np.eye(10, dtype=np.float32)[ys]


def main(argv=None):
    from . import mnist

    ap = argparse.ArgumentParser(description="MNIST train/eval")
    ap.add_argument("cmd", choices=["train", "eval"])
    ap.add_argument("--arch", choices=["fc", "cnn"], default="fc")
    ap.add_argument("-m", "--model", help="GGUF model (eval input / train output)")
    ap.add_argument("-o", "--out", help="output GGUF (train)")
    ap.add_argument("--images", help="idx3-ubyte images file")
    ap.add_argument("--labels", help="idx1-ubyte labels file")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--synthetic-n", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    if args.images and args.labels:
        X = load_idx_images(args.images)
        Y = load_idx_labels(args.labels)
        print(f"loaded {len(X)} real MNIST samples", file=sys.stderr)
    else:
        X, Y = mnist.synthetic_mnist(args.synthetic_n, seed=0)
        print(f"using {len(X)} synthetic samples (no idx files given)",
              file=sys.stderr)

    if args.cmd == "train":
        out = args.out or args.model
        if not out:
            print("error: train needs -o/--out", file=sys.stderr)
            return 1
        params, result = mnist.train(args.arch, X, Y, n_epochs=args.epochs,
                                     batch_size=args.batch_size, lr=args.lr, device=device)
        mnist.save_gguf(args.arch, params, out)
        print(f"saved {args.arch} model to {out}", file=sys.stderr)
        return 0

    if not args.model:
        print("error: eval needs -m/--model", file=sys.stderr)
        return 1
    arch, params = mnist.load_gguf(args.model, device=device)
    acc = mnist.evaluate(arch, params, X, Y)
    print(f"accuracy: {acc * 100:.2f}% ({arch}, {len(X)} samples)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
