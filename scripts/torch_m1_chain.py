"""Time K1's M = 1 kernel against the f32 body's decode kernel at M = 1,
alone and in a chain of a decode step's products, on the card.

    python3 scripts/torch_m1_chain.py [--layers N] [--out DIR]

At M = 1, K1 (`csrc/qmm_q4k.cu::qmm_q4k_f32`) keeps its kernel from before
the shared body; the body's `small_kernel<Q4K, 1>` gives the same bits.
Alone with L2 flushed (chip_smoke.py's Timer) the body's kernel is faster
on three of the four llama-7B shapes, yet a traced 32-layer decode step
spends more time in it. This script times both kernels at M = 1 on the
Q4_K format three ways, with the same weights and x:
- alone, L2 flushed before each call (chip_smoke.py's Timer);
- alone, L2 not flushed (the matrix stays in L2 from one call to the next);
- in a chain like a decode step's products: for each of --layers layers
  (weights of their own) the seven products of a llama-7B layer (wq, wk,
  wv, wo 4096 x 4096, w_gate and w_up 11008 x 4096, w_down 4096 x 11008),
  one CUDA-event interval around the whole chain behind a spin kernel,
  median of 10; and the chain's time predicted from the flushed times.
Both kernels' outputs must be equal bit for bit. It builds one library from
a generated source that includes csrc/qmm_q4k.cu (build/exp/), needs one
CUDA card, prints one line per case and writes DIR/m1_chain.json (default
build/).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import Timer, random_q4k  # noqa: E402
from ggml_gfx906_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = r"""
#include "qmm_q4k.cu"

extern "C" int m1_body_q4k(const float* x, const uint8_t* qs, const uint8_t* scm,
                           const float* dd, float* y, int M, int N, int K, void* stream) {
    return (int)qmm_tiled::launch_small<qmm_tiled::Q4K, 1>(x, {qs, nullptr, scm, dd}, y, M, N,
                                                           K, (cudaStream_t)stream);
}
"""
KERNELS = ("qmm_q4k_f32", "m1_body_q4k")        # K1 at M = 1; the body's decode kernel
# (N, K) of a llama-7B layer's seven products, in the order a layer runs them
LAYER = ((4096, 4096),) * 4 + ((11008, 4096),) * 2 + ((4096, 11008),)


def load_library() -> ctypes.CDLL:
    src = SOURCE.encode()
    h = hashlib.sha256(src)
    for f in sorted(build.CSRC.glob("*.cu*")):
        h.update(f.read_bytes())
    out = ROOT / "build" / "exp"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"m1_chain-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        cu = lib.with_suffix(".cu")
        cu.write_bytes(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                        str(cu)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in KERNELS:
        getattr(dll, fn).argtypes = [P] * 5 + [I, I, I, P]
        getattr(dll, fn).restype = I
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--out", type=Path, default=ROOT / "build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("m1_chain: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dll = load_library()
    timer = Timer(device)
    warm_timer = Timer(device)
    warm_timer.flush = torch.empty(0, dtype=torch.uint8, device=device)    # no flush
    gen = torch.Generator(device=device).manual_seed(13)
    layers = [[random_q4k(n, k, device, gen) for n, k in LAYER] for _ in range(args.layers)]
    xs = {k: torch.randn((1, k), device=device, generator=gen) for k in (4096, 11008)}
    ys = [[torch.empty((1, n), device=device) for n, _ in LAYER] for _ in range(args.layers)]

    def launch(fn, w, y):
        qs, scm, dd = w
        n, k = qs.shape[0], qs.shape[1] * 2
        err = getattr(dll, fn)(xs[k].data_ptr(), qs.data_ptr(), scm.data_ptr(), dd.data_ptr(),
                               y.data_ptr(), 1, n, k, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: CUDA error {err}")

    def chain(fn):
        for ws, yl in zip(layers, ys):
            for w, y in zip(ws, yl):
                launch(fn, w, y)

    rows = {"device": smi, "layers": args.layers, "alone": [], "chain": {}}
    for n, k in dict.fromkeys(LAYER):
        w = layers[0][LAYER.index((n, k))]
        outs = {}
        for fn in KERNELS:
            y = torch.empty((1, n), device=device)
            launch(fn, w, y)
            outs[fn] = y.clone()
            rows["alone"].append({"kernel": fn, "N": n, "K": k,
                                  "flushed_ms": timer(lambda: launch(fn, w, y)),
                                  "l2_warm_ms": warm_timer(lambda: launch(fn, w, y))})
            print(json.dumps(rows["alone"][-1]), flush=True)
        if not torch.equal(outs[KERNELS[0]], outs[KERNELS[1]]):
            raise AssertionError(f"N={n} K={k}: the two kernels' bits differ")
    for fn in KERNELS:
        flushed = {(r["N"], r["K"]): r["flushed_ms"] for r in rows["alone"] if r["kernel"] == fn}
        times = []
        chain(fn)
        for _ in range(10):
            torch.cuda._sleep(Timer.SPIN_CYCLES)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            chain(fn)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        rows["chain"][fn] = {"ms": float(np.median(times)), "products": len(LAYER) * args.layers,
                             "predicted_from_flushed_ms": args.layers * sum(flushed[s]
                                                                             for s in LAYER)}
        print(fn, json.dumps(rows["chain"][fn]), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "m1_chain.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
