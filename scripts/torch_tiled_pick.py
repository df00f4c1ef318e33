"""Time the kernels of the port's f32 matmul body against each other on the card.

    python3 scripts/torch_tiled_pick.py [--formats q8_0,q4_K,...] [--out DIR]

`csrc/qmm_f32_tiled.cuh::launch()` picks `tiled_kernel` (BM = 32 or 64) or
`tree_kernel` for M > 8 by the grid the tree kernel would have. This script
times each variant by itself, for every format on the body (K1 Q4_K, K4
Q6_K, K5 Q8_0, K6 Q4_0, K7 Q5_K, K8 Q4_1 / Q5_0 / Q5_1, K9 Q2_K / Q3_K), or
those that --formats names, on the llama-7B shapes at the M around that
choice (K1, K5 and K6 serve M = 16..63 on the main path: the engine's
chunks and prefill tails), beside what
`launch()` picks; every variant's output must equal `launch()`'s bit for
bit (one summation order). It builds one library from a generated source
that includes the format sources (build/exp/; Q4_K is in the header, Q4_0
in qmm_legacy.cu, Q8_0 in qmm_q8_0.cu), needs one CUDA card, prints one line per (format,
shape, M) and writes DIR/tiled_pick.json (default build/).
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

from chip_smoke import Timer  # noqa: E402
from ggml_gfx906_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = r"""
#include <string.h>
#include "qmm_q6k.cu"
#include "qmm_q5k.cu"
#include "qmm_legacy.cu"
#include "qmm_q23k.cu"
#include "qmm_q8_0.cu"

namespace qmm_tiled {
template <class F>
int pick(int v, const float* x, void* const* f, float* y, int M, int N, int K, void* stream) {
    typename F::Ptrs p;
    static_assert(sizeof(p) <= 4 * sizeof(void*), "a format has at most four arrays");
    memcpy(&p, f, sizeof(p));
    const cudaStream_t st = (cudaStream_t)stream;
    switch (v) {
        case 0: return launch<F>(x, p, y, M, N, K, stream);
        case 1: return (int)launch_tiled<F, 32>(x, p, y, M, N, K, st);
        case 2: return (int)launch_tiled<F, 64>(x, p, y, M, N, K, st);
        default: return (int)launch_tree<F>(x, p, y, M, N, K, st);
    }
}
}  // namespace qmm_tiled

extern "C" int tiled_pick(int fmt, int v, const float* x, void* const* f, float* y, int M,
                          int N, int K, void* stream) {
    using namespace qmm_tiled;
    switch (fmt) {
        case 0: return pick<Q6K>(v, x, f, y, M, N, K, stream);
        case 1: return pick<Q5K>(v, x, f, y, M, N, K, stream);
        case 2: return pick<Q41>(v, x, f, y, M, N, K, stream);
        case 3: return pick<Q50>(v, x, f, y, M, N, K, stream);
        case 4: return pick<Q51>(v, x, f, y, M, N, K, stream);
        case 5: return pick<Q2K>(v, x, f, y, M, N, K, stream);
        case 6: return pick<Q3K>(v, x, f, y, M, N, K, stream);
        case 7: return pick<Q4K>(v, x, f, y, M, N, K, stream);
        case 9: return pick<Q80>(v, x, f, y, M, N, K, stream);
        default: return pick<Q40>(v, x, f, y, M, N, K, stream);
    }
}
"""

# format → (index in tiled_pick, four pointer slots, its arrays in Ptrs
# order: name, K elements per value, dtype; None for a slot the format does
# not fill)
U8, I8, F32 = torch.uint8, torch.int8, torch.float32
FORMATS = {
    "q6_K": (0, [("ql", 2, U8), ("qh", 4, U8), ("sc", 16, I8), ("d", 256, F32)]),
    "q5_K": (1, [("qs", 2, U8), ("qh", 8, U8), ("scm", 16, U8), ("dd", 128, F32)]),
    "q4_1": (2, [("qs", 2, U8), None, ("d", 32, F32), ("m", 32, F32)]),
    "q5_0": (3, [("qs", 2, U8), ("qh", 8, U8), ("d", 32, F32), None]),
    "q5_1": (4, [("qs", 2, U8), ("qh", 8, U8), ("d", 32, F32), ("m", 32, F32)]),
    "q2_K": (5, [("qs", 4, U8), ("scales", 16, U8), ("d", 256, F32), ("dmin", 256, F32)]),
    "q3_K": (6, [("qs", 4, U8), ("hmask", 8, U8), ("sc", 16, I8), ("d", 256, F32)]),
    "q4_K": (7, [("qs", 2, U8), None, ("scm", 16, U8), ("dd", 128, F32)]),
    "q4_0": (8, [("qs", 2, U8), None, ("d", 32, F32), None]),
    "q8_0": (9, [("qs", 1, I8), ("d", 32, F32), None, None]),
}
SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008))
MS = (16, 32, 33, 48, 63, 64, 65, 100, 128)
VARIANTS = {1: "tiled32", 2: "tiled64", 3: "tree"}


def load_library() -> ctypes.CDLL:
    src = SOURCE.encode()
    h = hashlib.sha256(src)
    for f in sorted(build.CSRC.glob("*.cu*")):
        h.update(f.read_bytes())
    out = ROOT / "build" / "exp"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"tiled_pick-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        cu = lib.with_suffix(".cu")
        cu.write_bytes(src)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                        str(cu)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.tiled_pick.argtypes = [I, I, P, P, P, I, I, I, P]
    dll.tiled_pick.restype = I
    return dll


def arrays(spec, n, k, device, gen):
    out = []
    for a in spec:
        if a is None:
            out.append(None)
            continue
        _, per, dtype = a
        shape = (n, k // per)
        if dtype == F32:
            out.append(torch.rand(shape, device=device, generator=gen) * 1e-3)
        elif dtype == I8:
            out.append(torch.randint(-32, 32, shape, dtype=I8, device=device, generator=gen))
        else:
            out.append(torch.randint(0, 256, shape, dtype=U8, device=device, generator=gen))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--formats", default=",".join(FORMATS))
    ap.add_argument("--out", type=Path, default=ROOT / "build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tiled_pick: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dll = load_library()
    timer = Timer(device)
    gen = torch.Generator(device=device).manual_seed(12)
    rows = []
    for name in args.formats.split(","):
        fmt, spec = FORMATS[name]
        for n, k in SHAPES:
            ws = arrays(spec, n, k, device, gen)
            ptrs = (ctypes.c_void_p * 4)(*[0 if w is None else w.data_ptr() for w in ws])
            x_all = torch.randn((max(MS), k), device=device, generator=gen)
            for m in MS:
                x = x_all[:m].contiguous()

                def run(v, x=x, m=m):
                    y = torch.empty((m, n), device=device)
                    err = dll.tiled_pick(fmt, v, x.data_ptr(), ptrs, y.data_ptr(), m, n, k,
                                         torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} variant {v}: CUDA error {err}")
                    return y

                ref = run(0)
                row = {"format": name, "N": n, "K": k, "M": m, "launch_ms": timer(lambda: run(0))}
                for v, var in VARIANTS.items():
                    if v == 1 and m > 32:
                        continue
                    if not torch.equal(run(v), ref):
                        raise AssertionError(f"{name} N={n} K={k} M={m}: {var} differs from "
                                             "launch() in its bits")
                    row[f"{var}_ms"] = timer(lambda v=v: run(v))
                rows.append(row)
                print(json.dumps(row), flush=True)
            del ws, x_all
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "tiled_pick.json").write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
