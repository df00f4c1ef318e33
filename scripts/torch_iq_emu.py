"""Run the IQ search kernels S1-S3 on the CPU, emulated, to check them
before a chip run.

    python3 scripts/torch_iq_emu.py [--types iq3_xxs,...] [--rows 8] [--seed 0]

csrc/iq_search.cu, up to its launchers, is compiled with g++ (C++17,
-ffp-contract=off, so that no product and sum fuse, as nvcc's --fmad=false
keeps them apart) under a small header that defines the CUDA keywords away
and gives __float2int_rn (round half to even), __float2half_rn (g++'s
_Float16) and __half_as_ushort. Each block's three phases (sigma2, the
sub-block searches, the epilogues) run thread by thread in turn, which is
what the kernels' __syncthreads order. The tables are the wrapper's
(ops/cuda/iq_search.py::kernel_tables, on the CPU). For each type, with
and without an importance row where the type takes none, on rows like the
tests' (Gaussian rows of three scales, zero blocks, constant blocks, an
outlier per 32-block, a negative maximum, -0.0 entries, a zero row) and an
importance row with zeros, the script checks that the emulated kernel's
bytes equal the plain version's (quant/iquants.py), and prints the result.
It proves nothing about the card (registers, shared memory limits,
nvcc's own code): chip_smoke.py --checks iq_search does that. CPU only; no
CUDA needed.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ggml_gfx906_tpu_torch.ops.cuda import build, iq_search  # noqa: E402
from ggml_gfx906_tpu_torch.quant.types import GGMLType  # noqa: E402

EMU_H = r"""
#pragma once
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
struct Dim { unsigned x = 0, y = 0, z = 0; };
static Dim blockIdx, threadIdx;
inline void __syncthreads() {}
inline int __float2int_rn(float v) { return (int)std::nearbyint(v); }
struct __half { uint16_t u; };
inline __half __float2half_rn(float v) {
    _Float16 h = (_Float16)v;
    __half r;
    std::memcpy(&r.u, &h, 2);
    return r;
}
inline uint16_t __half_as_ushort(__half h) { return h.u; }
"""

RUNNER = r"""
#include "emu.h"
#include "iq_search_body.cu"

template <class S, class F1, class F2, class F3>
static void run(const iqs::Args& a, int sbs, F1 f1, F2 f2, F3 f3) {
    S* s = new S;
    const long long blocks = (a.nsb + sbs - 1) / sbs;
    for (long long b = 0; b < blocks; ++b) {
        std::memset((void*)s, 0xAB, sizeof(S));         // no read of uninitialised shared memory
        for (int t = 0; t < iqs::kThreads; ++t) f1(a, *s, (int)b, t);
        for (int t = 0; t < iqs::kThreads; ++t) f2(a, *s, (int)b, t);
        for (int t = 0; t < iqs::kThreads; ++t) f3(a, *s, (int)b, t);
    }
    delete s;
}

template <class P>
static void grid(const iqs::Args& a) {
    run<iqs::GridSmem<P>>(a, iqs::GridSmem<P>::SBS, iqs::grid_sigma<P>, iqs::grid_sub<P>,
                          iqs::grid_epilogue<P>);
}

template <bool M>
static void iq1(const iqs::Args& a) {
    run<iqs::Iq1Smem<M>>(a, iqs::Iq1Smem<M>::SBS, iqs::iq1_sigma<M>, iqs::iq1_sub<M>,
                         iqs::iq1_epilogue<M>);
}

extern "C" int emu_search(int family, int type, const void* x, const void* qw, int qw_nsb,
                          long long nsb, void* out, const void* grid_, const void* kmap,
                          const void* neigh, int kmap_size) {
    const iqs::Args a{(const float*)x, (const float*)qw, qw_nsb, nsb, (uint8_t*)out,
                      iqs::Tables{(const int8_t*)grid_, (const int*)kmap,
                                  (const uint16_t*)neigh, kmap_size}};
    if (family == 3) { if (type == 0) grid<iqs::Iq3xxs>(a); else grid<iqs::Iq3s>(a); }
    else if (family == 2) {
        if (type == 0) grid<iqs::Iq2xxs>(a);
        else if (type == 1) grid<iqs::Iq2xs>(a);
        else grid<iqs::Iq2s>(a);
    } else { if (type == 0) iq1<false>(a); else iq1<true>(a); }
    return 0;
}
"""

FAMILY = {"iq3_search": 3, "iq2_search": 2, "iq1_search": 1}


def build_emu(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "iq_search.cu").read_text()
    body = src[:src.index("// ------------------------------------------------------------- launchers")]
    body = re.sub(r"#include <cuda[^>]*>\n", "", body)          # the header stands in
    (out_dir / "emu.h").write_text(EMU_H)
    (out_dir / "iq_search_body.cu").write_text(body)
    (out_dir / "runner.cpp").write_text(RUNNER)
    lib = out_dir / "libiq_emu.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", str(lib), str(out_dir / "runner.cpp")],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.emu_search.argtypes = [I, I, P, P, I, L, P, P, P, P, I]
    so.emu_search.restype = ctypes.c_int
    return so


def emu_quantize(so, qtype: GGMLType, x: torch.Tensor, qw: torch.Tensor | None) -> torch.Tensor:
    """The emulated kernel's wire bytes (rows, row size) for f32 (rows, n)."""
    _, fn, code, kind, _ = iq_search.ROUTES[qtype]
    x = x.contiguous()
    ref = iq_search.quantize_plain(qtype, x[:1], qw)            # the row size
    out = torch.zeros(x.shape[0], ref.shape[1], dtype=torch.uint8)
    grid, kmap, neigh = iq_search.kernel_tables(kind, torch.device("cpu"))
    so.emu_search(FAMILY[fn], code, x.data_ptr(), None if qw is None else qw.data_ptr(),
                  x.shape[1] // 256, x.numel() // 256, out.data_ptr(), grid.data_ptr(),
                  kmap.data_ptr(), neigh.data_ptr(), kmap.numel())
    return out


def rows(rng, n_rows: int, n: int) -> np.ndarray:
    """The tests' kinds of rows, at least 8 of them."""
    q = max(1, n_rows // 8)
    g = rng.standard_normal((n_rows - 5 * q, n)).astype(np.float32)
    g *= np.float32([1.0, 1e-3, 30.0])[np.arange(len(g)) % 3][:, None]
    zero = rng.standard_normal((q, n)).astype(np.float32)
    zero[:, :64] = 0
    const = np.repeat(rng.uniform(-1, 1, (q, n // 32)), 32, axis=1).astype(np.float32)
    outl = (0.01 * rng.standard_normal((q, n))).astype(np.float32)
    outl.reshape(q, -1, 32)[:, :, 7] = 5.0
    negz = rng.standard_normal((q, n)).astype(np.float32)
    negz[:, 5::32] = -9.0
    negz[:, ::7] = -0.0
    return np.concatenate([g, zero, const, outl, negz, np.zeros((q, n), np.float32)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--types", default=",".join(t.name.lower() for t in iq_search.ROUTES))
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "emu_iq")
    args = ap.parse_args(argv)
    so = build_emu(args.out)
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rows(rng, args.rows, 512))
    qw = torch.from_numpy(rng.uniform(0.05, 3.0, 512).astype(np.float32))
    qw[::13] = 0
    bad = 0
    for name in args.types.split(","):
        t = GGMLType[name.upper()]
        for w in ([qw] if t in iq_search.IMATRIX_REQUIRED else [None, qw]):
            t0 = time.perf_counter()
            got = emu_quantize(so, t, x, w)
            sec = time.perf_counter() - t0
            want = iq_search.quantize_plain(t, x, w)
            rows_bad = torch.nonzero((got != want).any(1))[:, 0].tolist()
            bad += bool(rows_bad)
            print(f"{name}{'+imatrix' if w is not None else ''}: "
                  f"{'equal' if not rows_bad else f'rows {rows_bad} differ'} ({sec:.2f} s)")
    print("all equal" if not bad else f"{bad} cases differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
