"""Run the f32 matmul body's CUDA kernels and K10 on the CPU, emulated, to
check them before a chip run.

    python3 scripts/torch_body_emu.py [--formats q4_1,q2_K,...,k10] [--ref DIR]

`csrc/qmm_f32_tiled.cuh` and the sources on it (K1 Q4_K, K4 Q6_K, K5
Q8_0, K6 Q4_0, K7 Q5_K, K8 Q4_1 / Q5_0 / Q5_1, K9 Q2_K / Q3_K; with K3,
K5-i8 and K6-i8, which share K1's, K5's and K6's files, compiled but not
run) are rewritten into
plain C++ (one std::thread per CUDA thread, barriers for __syncthreads
and the warp shuffles, synchronous copies for cp.async; the int8 tensor
core dot aborts if it is reached) and built with g++ (C++20, one
translation unit per source) into build/emu/. Each
format then runs at small shapes (K = 512, 1280 and
2816, N not a multiple of the tiles) through all three kernels (small,
tiled and tree: the SM count the emulation reports decides between the
last two), and the script checks, per format and shape:
- nmse < 1e-10 against the wrapper's plain version (ops/cuda/*.py);
- the one-order rule: every row has the same bits at every M and in every
  kernel;
- with --ref DIR (another version of csrc/, e.g. a parent checkout's),
  whether its bits equal that version's at M = 1, 8 and 100 (printed, not
  asserted: a format whose summation order changed differs there).
"k10" in --formats (the default takes it) runs K10, csrc/qmm_q4k_pipe.cu,
with its mbarriers emulated (a phase bit, pending arrivals and a byte
count per barrier, under one lock) and each bulk copy as a memcpy that
then counts its bytes off the barrier: at shapes that take each of its
three tile shapes and wrap its ring, against qmm_q4_K_pipelined_plain
(nmse < 1e-10), and with --ref whether its bits equal that version's.
It proves nothing about the card (alignment, races between asynchronous
copies, registers): chip_smoke.py does that. CPU only; no CUDA needed.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ggml_gfx906_tpu_torch.ops.cuda import (build, qmm, qmm_legacy, qmm_pipe,  # noqa: E402
                                            qmm_q4_0, qmm_q5k, qmm_q6k, qmm_q8_0, qmm_q23k)

EMU_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static       // one block runs at a time
using std::max;
using std::min;
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
typedef void* cudaStream_t;
typedef int cudaDeviceAttr;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1,
          cudaFuncAttributeMaxDynamicSharedMemorySize = 1,
          cudaDevAttrMultiProcessorCount = 2, cudaDevAttrMaxSharedMemoryPerBlockOptin = 3;
template <class T> inline cudaError_t cudaFuncSetAttribute(T, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
extern int emu_sms;
inline cudaError_t cudaDeviceGetAttribute(int* v, int a, int) {
    *v = a == cudaDevAttrMultiProcessorCount ? emu_sms : 232448;     // the H100's opt-in
    return 0;
}
template <class T> inline T __ldg(const T* p) { return *p; }
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) return {(uint16_t)((u >> 16) | 0x40)};   // NaN
    u += 0x7FFFu + ((u >> 16) & 1u);
    return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
    const uint32_t u = (uint32_t)b.x << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
    return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float fmaf_emu(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline int __float2int_rn(float v) { return (int)std::nearbyint(v); }
inline int __dp4a(int a, int b, int c) {
    for (int i = 0; i < 4; ++i) c += (int)(int8_t)(a >> 8 * i) * (int)(int8_t)(b >> 8 * i);
    return c;
}
inline unsigned __brev(unsigned v) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) if (v >> i & 1) r |= 1u << (31 - i);
    return r;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    unsigned long long v = ((unsigned long long)y << 32) | x;
    unsigned r = 0;
    for (int k = 0; k < 4; ++k) r |= (unsigned)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
    return r;
}
struct EmuBlock {
    std::barrier<>* bar;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
    std::vector<std::vector<float>> shfl;
    char* smem;
};
extern thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
extern thread_local EmuBlock* emu_blk;
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
    emu_blk->warp_bar[threadIdx.x >> 5]->arrive_and_wait();
}
// an mbarrier: the parity of its current phase, the arrivals it still waits
// for in that phase, and the bytes still to come (expect_tx less complete_tx)
struct EmuMbar { int count, pending; long long tx; unsigned phase; };
inline std::mutex emu_mb_mu;
inline std::condition_variable emu_mb_cv;
inline std::map<const void*, EmuMbar> emu_mb;
inline void emu_mb_step(EmuMbar& b) {      // under emu_mb_mu
    if (b.pending == 0 && b.tx == 0) {
        b.phase ^= 1u;
        b.pending = b.count;
        emu_mb_cv.notify_all();
    }
}
inline void emu_mbar_init(const void* p, int count) {
    std::lock_guard<std::mutex> g(emu_mb_mu);
    emu_mb[p] = {count, count, 0, 0};
}
inline void emu_mbar_arrive(const void* p, long long tx) {
    std::lock_guard<std::mutex> g(emu_mb_mu);
    EmuMbar& b = emu_mb.at(p);
    b.tx += tx;
    b.pending -= 1;
    emu_mb_step(b);
}
inline void emu_mbar_wait(const void* p, unsigned parity) {
    std::unique_lock<std::mutex> g(emu_mb_mu);
    emu_mb_cv.wait(g, [&] { return emu_mb.at(p).phase != parity; });
}
inline void emu_bulk_copy(void* dst, const void* src, unsigned bytes, const void* p) {
    if ((uintptr_t)dst % 16 || (uintptr_t)src % 16 || bytes % 16) std::abort();
    std::memcpy(dst, src, bytes);
    std::lock_guard<std::mutex> g(emu_mb_mu);
    EmuMbar& b = emu_mb.at(p);
    b.tx -= bytes;
    emu_mb_step(b);
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    auto& b = *emu_blk->warp_bar[w];
    auto& s = emu_blk->shfl[w];
    b.arrive_and_wait();
    s[l] = v;
    b.arrive_and_wait();
    const float r = s[l ^ off];
    b.arrive_and_wait();
    return r;
}
inline char* emu_smem() { return emu_blk->smem; }
inline void emu_launch(dim3 grid, unsigned threads, size_t smem, std::function<void()> fn) {
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            EmuBlock blk;
            std::barrier<> bar(threads);
            blk.bar = &bar;
            for (unsigned w = 0; w < (threads + 31) / 32; ++w) {
                blk.warp_bar.emplace_back(new std::barrier<>(32));
                blk.shfl.emplace_back(32, 0.f);
            }
            std::vector<float4> mem(smem / 16 + 1);
            std::memset(mem.data(), 0x7f, mem.size() * 16);    // not zero: stale reads show
            blk.smem = (char*)mem.data();
            std::vector<std::thread> ts;
            for (unsigned t = 0; t < threads; ++t)
                ts.emplace_back([&, t] {
                    threadIdx = dim3(t); blockIdx = dim3(bx, by); gridDim = grid;
                    blockDim = dim3(threads);
                    emu_blk = &blk; fn();
                });
            for (auto& th : ts) th.join();
        }
}
"""

MAIN_CPP = r"""
#include "emu.h"
int emu_sms = 132;
thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
thread_local EmuBlock* emu_blk;
extern "C" void emu_set_sms(int v) { emu_sms = v; }
"""
SOURCES = ("qmm_q4k", "qmm_q6k", "qmm_q8_0", "qmm_q4_0", "qmm_q5k", "qmm_legacy",
           "qmm_q23k", "qmm_q4k_pipe")
# K10's PTX helpers (the region between its "---- PTX" and "---- end of PTX"
# lines) as the emulation's barriers and copies
EMU_PTX = r"""
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) { emu_mbar_init(bar, count); }
__device__ __forceinline__ void mbar_fence_init() {}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { emu_mbar_arrive(bar, 0); }
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    emu_mbar_arrive(bar, bytes);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    emu_mbar_wait(bar, parity);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    emu_bulk_copy(dst, src, bytes, bar);
}
"""

# format → (C entry point, wrapper module, plain function, field specs:
# name, K elements per value, kind)
FORMATS = {
    "q4_K": ("qmm_q4k_f32", qmm, "qmm_q4_K_plain",
             [("qs", 2, "u8"), ("scm", 16, "u6"), ("dd", 128, "f")]),
    "q4_0": ("qmm_q4_0_f32", qmm_q4_0, "qmm_q4_0_plain", [("qs", 2, "u8"), ("d", 32, "f")]),
    "q8_0": ("qmm_q8_0_f32", qmm_q8_0, "qmm_q8_0_plain", [("qs", 1, "i8"), ("d", 32, "f")]),
    "q6_K": ("qmm_q6k_f32", qmm_q6k, "qmm_q6_K_plain",
             [("ql", 2, "u8"), ("qh", 4, "u8"), ("sc", 16, "i8"), ("d", 256, "f")]),
    "q5_K": ("qmm_q5k_f32", qmm_q5k, "qmm_q5_K_plain",
             [("qs", 2, "u8"), ("qh", 8, "u8"), ("scm", 16, "u6"), ("dd", 128, "f")]),
    "q4_1": ("qmm_q4_1_f32", qmm_legacy, "qmm_q4_1_plain",
             [("qs", 2, "u8"), ("d", 32, "f"), ("m", 32, "-f")]),
    "q5_0": ("qmm_q5_0_f32", qmm_legacy, "qmm_q5_0_plain",
             [("qs", 2, "u8"), ("qh", 8, "u8"), ("d", 32, "f")]),
    "q5_1": ("qmm_q5_1_f32", qmm_legacy, "qmm_q5_1_plain",
             [("qs", 2, "u8"), ("qh", 8, "u8"), ("d", 32, "f"), ("m", 32, "-f")]),
    "q2_K": ("qmm_q2k_f32", qmm_q23k, "qmm_q2_K_plain",
             [("qs", 4, "u8"), ("scales", 16, "u8"), ("d", 256, "f"), ("dmin", 256, "f")]),
    "q3_K": ("qmm_q3k_f32", qmm_q23k, "qmm_q3_K_plain",
             [("qs", 4, "u8"), ("hmask", 8, "u8"), ("sc", 16, "i6"), ("d", 256, "f")]),
}
SHAPES = ((100, 2816), (48, 512), (64, 1280))
MS = (1, 3, 8, 9, 33, 64, 100)
TILED, TREE = 1 << 20, 1        # reported SM counts: launch() picks tiled, or tree at M > 32
# K10's (N, K, reported SM count): its <8, 2> tiles, 19 a block through its
# two stages, the last one ragged; its <4, 2> tiles, 4 or 5 a block; its
# <2, 1> tiles, 5 in one block
PIPE_SHAPES = ((600, 512, 2), (100, 11008, 3), (10, 28672, 1))


def emulated(src: Path, out: Path, sources=SOURCES) -> Path:
    """The `sources` of `src` rewritten for the emulation and built into
    out/libemu.so (each source its own translation unit, compiled in
    parallel: K3 and K6-i8 both define round_i8)."""
    out.mkdir(parents=True, exist_ok=True)
    for f in list(src.glob("*.cuh")) + [src / f"{n}.cu" for n in sources]:
        s = f.read_text().replace("#include <cuda_runtime.h>", '#include "emu.h"')
        s = s.replace("#include <cuda_bf16.h>", '#include "emu.h"')
        s = re.sub(r'// ---- PTX[^\n]*\n.*?// ---- end of PTX\n', lambda _: EMU_PTX, s, flags=re.S)
        s = re.sub(r'(void mma_s8\(.*?\) \{).*?\n\}', r'\1 std::abort(); }', s, flags=re.S)
        s = re.sub(r'asm volatile\("cp\.async\.(commit|wait)_group[^"]*"[^;]*;', ";", s)
        s = re.sub(r'(void cp_async16\(void\* dst, const void\* src, bool valid\) \{).*?\n\}',
                   r'\1 if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16); }',
                   s, flags=re.S)
        s = re.sub(r'(void cp_async_small\(void\* dst, const void\* src\) \{).*?\n\}',
                   r'\1 std::memcpy(dst, src, BYTES); }', s, flags=re.S)
        s = re.sub(r'extern __shared__ __align__\(16\) (\w+(?: \w+)?) (\w+)\[\];',
                   r'\1* \2 = (\1*)emu_smem();', s)
        s = re.sub(r'(\w+(?:<[^<>]*>)?)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(([^;]*)\);',
                   r'emu_launch(\2, \3, \4, [=] { \1(\6); });', s)
        s = re.sub(r'\bfmaf\(', "fmaf_emu(", s)
        (out / f.name).write_text(s)
    (out / "emu.h").write_text(EMU_H)
    (out / "main.cpp").write_text(MAIN_CPP)
    flags = ["-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-pthread",
             "-Wno-unknown-pragmas"]
    units = [out / "main.cpp"] + [out / f"{n}.cu" for n in sources]
    procs = [subprocess.Popen(["g++", *flags, "-x", "c++", "-c", str(u), "-o",
                               str(u.with_suffix(".o"))]) for u in units]
    if any([p.wait() for p in procs]):     # wait for every one
        raise RuntimeError("g++ failed on the emulated sources")
    lib = out / "libemu.so"
    subprocess.run(["g++", "-shared", "-pthread", *(str(u.with_suffix(".o")) for u in units),
                    "-o", str(lib)], check=True)
    return lib


def load(lib: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    dll.emu_set_sms.argtypes = [ctypes.c_int]
    for fn in [f[0] for f in FORMATS.values()] + ["qmm_q4k_pipe"]:
        if hasattr(dll, fn):
            getattr(dll, fn).restype = ctypes.c_int
    return dll


def weights(spec, n, k, gen):
    out = []
    for _, per, kind in spec:
        shape = (n, k // per)
        if kind in ("f", "-f"):
            out.append(torch.rand(shape, generator=gen) * (1e-3 if kind == "f" else -0.1))
        elif kind in ("i8", "i6"):
            lim = 128 if kind == "i8" else 32
            out.append(torch.randint(-lim, lim, shape, dtype=torch.int8, generator=gen))
        else:
            top = 64 if kind == "u6" else 256
            out.append(torch.randint(0, top, shape, dtype=torch.uint8, generator=gen))
    return out


def call(dll, fn, x, fields, n, sms):
    dll.emu_set_sms(sms)
    m, k = x.shape
    y = torch.full((m, n), float("nan"))
    args = [ctypes.c_void_p(t.data_ptr()) for t in (x, *fields, y)]
    if getattr(dll, fn)(*args, m, n, k, None):
        raise RuntimeError(f"{fn}: launch error")
    return y


def nmse(a, b):
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean() / (b ** 2).mean())


def check_pipe(dll, ref, gen):
    """K10 at PIPE_SHAPES against its plain version, and its bits against
    --ref's."""
    for n, k, sms in PIPE_SHAPES:
        t0 = time.perf_counter()
        qs, scm, dd = weights([("qs", 2, "u8"), ("scm", 16, "u6"), ("dd", 128, "f")], n, k, gen)
        x = torch.randn((1, k), generator=gen)

        def run(lib):
            lib.emu_set_sms(sms)
            y = torch.full((1, n), float("nan"))
            args = [ctypes.c_void_p(t.data_ptr()) for t in (x, qs, scm, dd, y)]
            if lib.qmm_q4k_pipe(*args, n, k, None):
                raise RuntimeError(f"qmm_q4k_pipe N={n} K={k}: launch error")
            return y

        y = run(dll)
        e = nmse(y, qmm_pipe.qmm_q4_K_pipelined_plain(x, qs, scm, dd))
        if not e < 1e-10:
            raise AssertionError(f"k10 N={n} K={k}: nmse {e}")
        same = f"; bits equal to --ref's: {torch.equal(run(ref), y)}" if ref is not None else ""
        print(f"k10 N={n} K={k}: plain nmse {e:.2e}{same} ({time.perf_counter() - t0:.1f} s)",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--formats", default=",".join(list(FORMATS) + ["k10"]))
    ap.add_argument("--ref", type=Path, default=None,
                    help="another csrc/ directory whose kernels must give the same bits")
    args = ap.parse_args(argv)
    dll = load(emulated(build.CSRC, ROOT / "build" / "emu" / "this"))
    ref = load(emulated(args.ref, ROOT / "build" / "emu" / "ref")) if args.ref else None
    gen = torch.Generator().manual_seed(0)
    for name in args.formats.split(","):
        if name == "k10":
            check_pipe(dll, ref, gen)
            continue
        fn, mod, plain_name, spec = FORMATS[name]
        plain = getattr(mod, plain_name)
        for n, k in SHAPES:
            t0 = time.perf_counter()
            fields = weights(spec, n, k, gen)
            x = torch.randn((max(MS), k), generator=gen)
            outs = {}
            for m in MS:
                for kern, sms in (("tiled", TILED), ("tree", TREE)):
                    if kern == "tree" and m <= 32:
                        continue
                    y = call(dll, fn, x[:m], fields, n, sms)
                    e = nmse(y, plain(x[:m], *fields))
                    if not e < 1e-10:
                        raise AssertionError(f"{name} N={n} K={k} M={m} {kern}: nmse {e}")
                    outs[(m, kern)] = y
            full = outs[(max(MS), "tree")]
            for (m, kern), y in outs.items():
                if not torch.equal(y, full[:m]):
                    raise AssertionError(f"{name} N={n} K={k}: M={m} {kern} rows differ")
            same = ""
            if ref is not None:
                same = "; bits equal to --ref's at " + ", ".join(
                    f"M={m}: {torch.equal(call(ref, fn, x[:m], fields, n, 132), full[:m])}"
                    for m in (1, 8, 100))
            print(f"{name} N={n} K={k}: plain nmse ok, rows equal across M and kernels"
                  f"{same} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
