"""Time the port's M = 1 matmul kernels alone and in a chain of a decode
step's products, on the card.

    python3 scripts/torch_m1_chain.py [--layers N] [--csrc DIR] [--out DIR]

At M = 1 flushed per-call times misrank kernels: alone with L2 flushed
(chip_smoke.py's Timer) the body's decode kernel beat K1's own M = 1
kernel on three of the four llama-7B shapes, yet a traced 32-layer decode
step spent more time in it. This script times, with the same weights and x for the
kernels of one format:
- Q4_K: K1 at M = 1 (`qmm_q4k_f32`, its kernel from before the body),
  the body's decode kernel `small_kernel<Q4K, 1>` (the same bits) and K10
  (`qmm_q4k_pipe`, x rounded to bf16: held against its plain version, nmse
  < 1e-10);
- Q8_0: K5 at M = 1 (`qmm_q8_0_f32`), held against its plain version;
three ways:
- alone, L2 flushed before each call (chip_smoke.py's Timer);
- alone, L2 not flushed (the matrix stays in L2 from one call to the next);
- in a chain like a decode step's products: for each of --layers layers
  (weights of their own) the seven products of a llama-7B layer (wq, wk,
  wv, wo 4096 x 4096, w_gate and w_up 11008 x 4096, w_down 4096 x 11008),
  one CUDA-event interval around the whole chain behind a spin kernel,
  median of 10 (chip_smoke.py's chain_ms); and the chain's time predicted
  from the flushed times, and its bound (the weight bytes over the card's
  memory rate).
--csrc takes the kernels from another version of csrc/ (e.g. a parent
checkout's, whose entry points have the same C signatures), so that two
versions are timed in one call. Each source is built as it is (K10, K5),
and K1 with the body's kernel from a generated source that includes
csrc/qmm_q4k.cu, into build/exp/. Needs one CUDA card; prints one line per
case and writes DIR/m1_chain.json (default build/).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (LAYER_PRODUCTS, Timer, bound, chain_ms, nmse,  # noqa: E402
                        random_q4k)
from ggml_gfx906_tpu_torch.ops.cuda import build, qmm_pipe, qmm_q8_0  # noqa: E402

BODY_SOURCE = r"""
#include "qmm_q4k.cu"

extern "C" int m1_body_q4k(const float* x, const uint8_t* qs, const uint8_t* scm,
                           const float* dd, float* y, int M, int N, int K, void* stream) {
    return (int)qmm_tiled::launch_small<qmm_tiled::Q4K, 1>(x, {qs, nullptr, scm, dd}, y, M, N,
                                                           K, (cudaStream_t)stream);
}
"""
# kernel → (library, format, its int arguments after the pointers); a
# library is a generated source or a csrc/ file
KERNELS = {"qmm_q4k_f32": ("m1_body", "q4_K", "MNK"),      # K1 at M = 1
           "m1_body_q4k": ("m1_body", "q4_K", "MNK"),      # the body's decode kernel
           "qmm_q4k_pipe": ("qmm_q4k_pipe", "q4_K", "NK"),  # K10
           "qmm_q8_0_f32": ("qmm_q8_0", "q8_0", "MNK")}     # K5 at M = 1
FIELDS = {"q4_K": 3, "q8_0": 2}         # weight arrays per format
BITS = {"q4_K": 4.75, "q8_0": 9}        # bits per weight in the port's layout


def load_libraries(csrc: Path) -> dict[str, ctypes.CDLL]:
    """Build (once per content) and load the three libraries, one nvcc each,
    all at once."""
    out = ROOT / "build" / "exp"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for lib, src in (("m1_body", BODY_SOURCE.encode()),
                     ("qmm_q4k_pipe", (csrc / "qmm_q4k_pipe.cu").read_bytes()),
                     ("qmm_q8_0", (csrc / "qmm_q8_0.cu").read_bytes())):
        h = hashlib.sha256(src)
        for f in sorted(csrc.glob("*.cu*")):
            h.update(f.read_bytes())
        so = out / f"m1_chain_{lib}-{h.hexdigest()[:16]}.so"
        jobs[lib] = (so, None)
        if not so.exists():
            cu = so.with_suffix(".cu")
            cu.write_bytes(src)
            jobs[lib] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    dlls = {}
    for lib, (so, proc) in jobs.items():
        if proc is not None and proc.wait():
            raise RuntimeError(f"nvcc {lib} failed:\n{proc.stdout.read()}")
        dlls[lib] = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, (lib, fmt, dims) in KERNELS.items():
        f = getattr(dlls[lib], fn)
        f.argtypes = [P] * (FIELDS[fmt] + 2) + [I] * len(dims) + [P]    # x, fields, y; stream
        f.restype = I
    return dlls


def random_q8_0(n, k, device, gen):
    qs = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=device, generator=gen)
    d = torch.rand((n, k // 32), device=device, generator=gen) * 1e-3
    return qs, d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--csrc", type=Path, default=build.CSRC,
                    help="the csrc/ directory whose kernels are timed")
    ap.add_argument("--out", type=Path, default=ROOT / "build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("m1_chain: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dlls = load_libraries(args.csrc.resolve())
    timer = Timer(device)
    warm_timer = Timer(device)
    warm_timer.flush = torch.empty(0, dtype=torch.uint8, device=device)    # no flush
    gen = torch.Generator(device=device).manual_seed(13)
    make = {"q4_K": random_q4k, "q8_0": random_q8_0}
    layers = {fmt: [[f(n, k, device, gen) for n, k in LAYER_PRODUCTS] for _ in range(args.layers)]
              for fmt, f in make.items()}
    xs = {k: torch.randn((1, k), device=device, generator=gen) for k in (4096, 11008)}
    ys = [[torch.empty((1, n), device=device) for n, _ in LAYER_PRODUCTS]
          for _ in range(args.layers)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn, w, y):
        lib, fmt, dims = KERNELS[fn]
        n, k = w[0].shape[0], w[0].shape[1] * (2 if fmt == "q4_K" else 1)
        ptrs = [xs[k].data_ptr(), *(t.data_ptr() for t in w), y.data_ptr()]
        err = getattr(dlls[lib], fn)(*ptrs, *({"M": 1, "N": n, "K": k}[c] for c in dims), stream)
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err}")

    plain = {"qmm_q4k_pipe": lambda x, w: qmm_pipe.qmm_q4_K_pipelined_plain(x, *w),
             "qmm_q8_0_f32": lambda x, w: qmm_q8_0.qmm_q8_0_plain(x, *w)}
    rows = {"device": smi, "csrc": str(args.csrc), "layers": args.layers, "alone": [],
            "chain": {}}
    for n, k in dict.fromkeys(LAYER_PRODUCTS):
        i = LAYER_PRODUCTS.index((n, k))
        outs = {}
        for fn, (_, fmt, _) in KERNELS.items():
            w = layers[fmt][0][i]
            y = torch.empty((1, n), device=device)
            launch(fn, w, y)
            outs[fn] = y.clone()
            row = {"kernel": fn, "N": n, "K": k,
                   "flushed_ms": timer(lambda: launch(fn, w, y)),
                   "l2_warm_ms": warm_timer(lambda: launch(fn, w, y))}
            if fn in plain:
                row["nmse"] = nmse(outs[fn], plain[fn](xs[k], w))
                if not row["nmse"] < 1e-10:
                    raise AssertionError(f"{fn} N={n} K={k}: nmse {row['nmse']}")
            rows["alone"].append(row)
            print(json.dumps(row), flush=True)
        if not torch.equal(outs["qmm_q4k_f32"], outs["m1_body_q4k"]):
            raise AssertionError(f"N={n} K={k}: K1's and the body's bits differ")
    for fn, (_, fmt, _) in KERNELS.items():
        flushed = {(r["N"], r["K"]): r["flushed_ms"] for r in rows["alone"] if r["kernel"] == fn}

        def chain(fn=fn, fmt=fmt):
            for ws, yl in zip(layers[fmt], ys):
                for w, y in zip(ws, yl):
                    launch(fn, w, y)

        weights = args.layers * sum(n * k for n, k in LAYER_PRODUCTS)
        rows["chain"][fn] = {"ms": chain_ms(chain), "products": len(LAYER_PRODUCTS) * args.layers,
                             "predicted_from_flushed_ms": args.layers * sum(
                                 flushed[s] for s in LAYER_PRODUCTS),
                             "bound_ms": bound(weights * BITS[fmt] / 8, 2.0 * weights, "f32")[0]}
        print(fn, json.dumps(rows["chain"][fn]), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "m1_chain.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
