"""Minimal quantized mul_mat in two styles — the `examples/simple` analogue
(the port of examples/simple.py; ref: examples/simple/simple-ctx.cpp:1-127,
simple-backend.cpp:1-219).

The reference shows the same matmul twice: once with a malloc'd single
context (simple-ctx) and once through an explicit backend with a graph
allocator (simple-backend). The port's two styles:

  1. "ctx" style — eager: quantize A to Q8_0 on the device, multiply through
     `qmatmul` (kernel K5 on the card, its plain version on the CPU), read
     the result back;
  2. "backend" style — the weight placed on the card once, the product
     captured once as a CUDA graph over static input and output buffers
     (runtime/graphs.py::StepGraph) and replayed for each new input: the
     analogue of backend buffer placement + ggml_gallocr planning +
     graph_compute. It needs the card; on the CPU only the ctx style runs.

K is 256 (the reference takes 32): Q8_0's kernel layout wants K % 128 == 0,
and at K = 32 the weight would take the plain "wire" path instead of K5.

Run:  python -m ggml_gfx906_tpu_torch.examples.simple [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import cuda as kernels
from ..ops.quantized import QuantTensor, qmatmul
from ..quant.types import GGMLType
from ..runtime.graphs import StepGraph
from ..utils.device import resolve

K = 256
rng = np.random.default_rng(0)
A = (rng.standard_normal((4, K)) * 0.5).astype(np.float32)   # weights
B = (rng.standard_normal((3, K)) * 0.5).astype(np.float32)   # activations
TOL = 0.1                                                     # Q8_0 rounding of A


def style_ctx(device) -> np.ndarray:
    """Eager: quantize A to Q8_0, multiply, read back (simple-ctx)."""
    qa = QuantTensor.quantize(GGMLType.Q8_0, A, device=device)
    return qmatmul(torch.from_numpy(B).to(device), qa).cpu().numpy()   # (3, K) @ (4, K)^T


def style_backend(device, inputs) -> list[np.ndarray]:
    """The weight placed once; one captured product replayed per input
    (simple-backend)."""
    qa = QuantTensor.quantize(GGMLType.Q8_0, A, device=device)
    x = torch.zeros(B.shape, dtype=torch.float32, device=device)    # the static input
    graph = StepGraph(lambda: qmatmul(x, qa), device)
    outs = []
    for b in inputs:
        x.copy_(torch.from_numpy(b))
        outs.append(graph.replay()[0].cpu().numpy())
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    device = resolve(ap.parse_args(argv).device)
    ref = B @ A.T
    before = kernels.K5.launches
    got = style_ctx(device)
    err = float(np.abs(got - ref).max())
    print(f"style ctx     : out {got.shape}, max |err| vs f32 = {err:.4f}, "
          f"K5 launches {kernels.K5.launches - before}")
    assert err < TOL, err
    if device.type != "cuda":
        print("style backend : skipped (a captured CUDA graph needs the card; on the CPU only "
              "the ctx style runs)")
        return 0
    inputs = [B, B[::-1].copy(), B * 2]
    before = kernels.K5.launches
    outs = style_backend(device, inputs)
    for b, o in zip(inputs, outs):
        err = float(np.abs(o - b @ A.T).max())
        assert err < 2 * TOL, err
    print(f"style backend : {len(inputs)} replays of one captured product, max |err| vs f32 "
          f"= {err:.4f}, K5 launches {kernels.K5.launches - before} (warm-up + replays)")
    print("mul_mat of quantized A against f32 B matches the dense result within Q8_0 "
          "rounding — see models/ for full networks.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
