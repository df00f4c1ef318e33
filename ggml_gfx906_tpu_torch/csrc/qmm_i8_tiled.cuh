// Shared body of the int8 quantized matmul kernels for Hopper (sm_90a):
//   y (M, N) f32 = sum over K steps s and int8 tiles h of
//                  (dot_int(qx_h[m, s], w8_h[n, s]) * ex_h[m, s]) * dw_h[n, s]
// taken per step in ascending order, tile 0 first, each product and sum
// rounded on its own (the reference's epilogue order,
// ggml_gfx906_tpu/ops/pallas/qmm.py::_i8_call). Used by K3 (Q4_K,
// csrc/qmm_q4k.cu), K5-i8 (Q8_0, csrc/qmm_q8_0.cu) and K6-i8 (Q4_0,
// csrc/qmm_q4_0.cu), each with its x quantization (quant_x below).
//
// Activations come quantized: F::TILES int8 arrays qx_h (M, steps * TK)
// with one f32 scale ex_h (M, steps) per (row, step). A format F supplies
// the packed weights and, per (row, step), the fold of their block scales
// by the tile bound and the expansion to int8:
//   TILES, SPAN                 int8 tiles per step, K elements per step
//   struct Ptrs                 the weight arrays
//   struct Raw                  what one thread loads for its piece of a row
//   zero(Raw&)                  the Raw of a row past N (zero weights)
//   load<BPT>(Raw&, Ptrs, n, s, piece, K)
//                               the bytes of piece `piece` (of TK / BPT)
//                               of row n at step s
//   expand<BPT>(Raw, piece, uint4 (&w)[TILES][BPT / 16], float (&dw)[TILES])
//                               their int8 weights for each tile (BPT per
//                               tile, at tile positions piece * BPT ...)
//                               and each tile's dw; every thread of the
//                               block calls it together, and the TK / BPT
//                               threads of a row are consecutive lanes
//                               (piece = lane % (TK / BPT)), so it may
//                               meet their values in warp shuffles
// Every dot is an exact integer sum (mma.sync s8 x s8 -> s32), so only the
// fold, the expansion and the epilogue round, and they round as the
// reference does: the output's bits do not depend on the tile shape, the
// launch, M or a row's neighbours.
//
// Bound on the H100: operations (2*M*N*K int8 at 1979 TOP/s) at large M;
// at the main path's M = 100..128 the weight bytes (~0.56 B per weight for
// Q4_K, 0.625 for Q4_0, 1.125 for Q8_0) and the expansion on the CUDA
// cores. Design:
// - a block of 8 warps owns BM = 128 activation rows and BN = 64 (or 32
//   when 64 would leave SMs idle) weight rows; warps 4 (M) x 2 (N), a warp
//   32 x BN/2 of mma.sync.m16n8k32 tiles;
// - per step (F::SPAN elements of K: one tile for Q8_0, two for Q4_K and
//   Q4_0) the block expands its BN rows' packed bytes once into shared
//   int8 (every block row of M re-expands: there is no split of K, which
//   would reorder the f32 epilogue); the next step's packed bytes are read
//   into registers before the current step's products, the next step's x
//   tile comes by cp.async into the other of two buffers;
// - fragments come from shared rows padded to TK + 16 bytes (36 words:
//   the 32 lanes of a fragment load hit 32 different banks);
// - one int32 accumulator per output and tile per step; the epilogue adds
//   (acc * ex) * dw into the f32 output in the reference's order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm_i8 {
namespace {   // internal linkage: two builds loaded in one process keep their own statics

constexpr int BM = 128;          // activation rows per block
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int TK = 128;          // K elements of an int8 tile
constexpr int LD = TK + 16;      // shared row stride in bytes

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = valid ? 16 : 0;        // 0: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a (16 x 32, row) . b (32 x 8, col), s8 x s8 -> s32, exact
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// round_half_even(clamp(v, -127, 127)) as an int8 in the low byte: the sum
// with 1.5 * 2^23 rounds v to an integer, ties to even (the constant is
// even), and leaves it two's complement in the low mantissa byte; the same
// value as clip(round(v)) (_round_i8), without a float-to-int conversion.
__device__ __forceinline__ uint32_t round_i8_bits(float v) {     // the byte, above it junk
    v = fminf(fmaxf(v, -127.f), 127.f);
    return __float_as_uint(__fadd_rn(v, 12582912.f));
}
__device__ __forceinline__ uint32_t round_i8_byte(float v) {
    return round_i8_bits(v) & 0xFFu;
}

// The float of a small non-negative integer q: 2^23 + q under the exponent,
// minus 2^23; exact, and no int-to-float conversion.
__device__ __forceinline__ float small_float(uint32_t q) {
    return __fsub_rn(__uint_as_float(0x4B000000u | q), 8388608.f);
}

// The low bytes of a, b, c, d as one word, a's lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The int8 weights round_i8((b_i - c) * s) of the four bytes b_i of w, with
// bias = 2^23 + c: a byte permute puts b_i under the exponent of 2^23, so
// (2^23 + b_i) - bias is b_i - c exactly; the product and the rounding are
// the reference's (_round_i8 on the expansion).
__device__ __forceinline__ uint32_t expand4(uint32_t w, float bias, float s) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        r[i] = round_i8_bits(__fmul_rn(
            __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)), bias), s));
    return pack4(r[0], r[1], r[2], r[3]);
}

template <int TILES>
struct XOps {
    const int8_t* qx[TILES];
    const float* ex[TILES];
};

template <class F, int BN>
__global__ void __launch_bounds__(THREADS, 2)       // two blocks per SM: at most 128 registers
kernel(XOps<F::TILES> x, typename F::Ptrs w, float* __restrict__ y, int M, int N, int K) {
    constexpr int TILES = F::TILES;
    constexpr int NF = BN / 16;              // n fragments of 8 per warp
    constexpr int BPT = TK * BN / THREADS;   // int8 per tile a thread expands
    constexpr int TPR = TK / BPT;            // threads per weight row
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* xs = reinterpret_cast<int8_t*>(smem);            // [2][TILES][BM][LD]
    int8_t* ws = xs + 2 * TILES * BM * LD;                     // [2][TILES][BN][LD]
    float* dws = reinterpret_cast<float*>(ws + 2 * TILES * BN * LD);   // [2][TILES][BN]

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp & 3;
    const int wn = warp >> 2;
    const int g = lane >> 2;
    const int c4 = lane & 3;
    const int m0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    const int steps = K / F::SPAN;
    const size_t xcols = (size_t)steps * TK;
    const int wrow = tid / TPR;              // the weight row and piece this thread expands
    const int piece = tid - wrow * TPR;
    const bool wvalid = n0 + wrow < N;

    auto load_x = [&](int s, int st) {
#pragma unroll
        for (int h = 0; h < TILES; ++h)          // h known at compile time: no indexed copy of x
#pragma unroll
            for (int i = 0; i < BM * (TK / 16) / THREADS; ++i) {
                const int u = tid + i * THREADS;
                const int r = u / (TK / 16);
                const int q16 = u - r * (TK / 16);
                const bool ok = m0 + r < M;
                const int8_t* src = ok ? x.qx[h] + (size_t)(m0 + r) * xcols + (size_t)s * TK + 16 * q16
                                       : x.qx[h];
                cp_async16(xs + ((st * TILES + h) * BM + r) * LD + 16 * q16, src, ok);
            }
    };
    typename F::Raw raw;
    auto expand = [&](int st) {
        uint4 wv[TILES][BPT / 16];
        float dw[TILES];
        F::template expand<BPT>(raw, piece, wv, dw);
#pragma unroll
        for (int h = 0; h < TILES; ++h) {
            int8_t* dst = ws + ((st * TILES + h) * BN + wrow) * LD + piece * BPT;
#pragma unroll
            for (int i = 0; i < BPT / 16; ++i) reinterpret_cast<uint4*>(dst)[i] = wv[h][i];
            if (piece == 0) dws[(st * TILES + h) * BN + wrow] = dw[h];
        }
    };

    if (wvalid) F::template load<BPT>(raw, w, n0 + wrow, 0, piece, K);
    else F::zero(raw);
    expand(0);
    load_x(0, 0);
    cp_async_commit();

    float out[2][NF][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) out[i][j][e] = 0.f;

    for (int s = 0; s < steps; ++s) {
        const int st = s & 1;
        const bool next = s + 1 < steps;
        if (next && wvalid) F::template load<BPT>(raw, w, n0 + wrow, s + 1, piece, K);   // in flight meanwhile
        cp_async_wait_all();
        __syncthreads();                 // step s's x and weights are in; step s-1 is done
        if (next) load_x(s + 1, st ^ 1);
        cp_async_commit();
#pragma unroll
        for (int h = 0; h < TILES; ++h) {
            int acc[2][NF][4];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < NF; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
            const int8_t* xt = xs + (st * TILES + h) * BM * LD;
            const int8_t* wt = ws + (st * TILES + h) * BN * LD;
#pragma unroll
            for (int ks = 0; ks < TK / 32; ++ks) {
                uint32_t a[2][4], b[NF][2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int8_t* p = xt + (wm * 32 + i * 16 + g) * LD + ks * 32 + c4 * 4;
                    a[i][0] = lds32(p);
                    a[i][1] = lds32(p + 8 * LD);
                    a[i][2] = lds32(p + 16);
                    a[i][3] = lds32(p + 8 * LD + 16);
                }
#pragma unroll
                for (int j = 0; j < NF; ++j) {
                    const int8_t* p = wt + (wn * (BN / 2) + j * 8 + g) * LD + ks * 32 + c4 * 4;
                    b[j][0] = lds32(p);
                    b[j][1] = lds32(p + 16);
                }
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < NF; ++j) mma_s8(acc[i][j], a[i], b[j]);
            }
            // epilogue: out += (acc * ex) * dw, tile h of step s
            float exv[2][2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e2 = 0; e2 < 2; ++e2) {
                    const int m = m0 + wm * 32 + i * 16 + g + 8 * e2;
                    exv[i][e2] = m < M ? x.ex[h][(size_t)m * steps + s] : 0.f;
                }
#pragma unroll
            for (int j = 0; j < NF; ++j)
#pragma unroll
                for (int e1 = 0; e1 < 2; ++e1) {
                    const float dwv = dws[(st * TILES + h) * BN + wn * (BN / 2) + j * 8 + 2 * c4 + e1];
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int e2 = 0; e2 < 2; ++e2) {
                            const int e = 2 * e2 + e1;
                            out[i][j][e] = __fadd_rn(out[i][j][e],
                                                     __fmul_rn(__fmul_rn((float)acc[i][j][e], exv[i][e2]), dwv));
                        }
                }
        }
        if (next) expand(st ^ 1);        // its buffer was last read in step s-1
    }
    cp_async_wait_all();

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm * 32 + i * 16 + g + 8 * (e >> 1);
                const int n = n0 + wn * (BN / 2) + j * 8 + 2 * c4 + (e & 1);
                if (m < M && n < N) y[(size_t)m * N + n] = out[i][j][e];
            }
}

template <class F, int BN>
constexpr size_t smem_bytes() {
    return (size_t)2 * F::TILES * (BM + BN) * LD + sizeof(float) * 2 * F::TILES * BN;
}

template <class F, int BN>
int launch_bn(XOps<F::TILES> x, typename F::Ptrs w, float* y, int M, int N, int K,
              cudaStream_t stream) {
    auto kern = kernel<F, BN>;
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem_bytes<F, BN>());
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const size_t smem = smem_bytes<F, BN>();
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    kern<<<grid, THREADS, smem, stream>>>(x, w, y, M, N, K);
    return (int)cudaGetLastError();
}

// BN = 64 where its grid fills the SMs (N >= 11008 at M <= 128), else 32.
template <class F>
int launch(XOps<F::TILES> x, typename F::Ptrs w, float* y, int M, int N, int K,
           cudaStream_t stream) {
    if (M < 1 || N < 1 || K % F::SPAN != 0) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if ((long long)((N + 63) / 64) * ((M + BM - 1) / BM) >= sms)
        return launch_bn<F, 64>(x, w, y, M, N, K, stream);
    return launch_bn<F, 32>(x, w, y, M, N, K, stream);
}

// ------------------------------------------------------- x quantization
// x (M, K) f32 or bf16 -> per (row, 128-element int8 tile) qx int8 and
// ex f32: ex = amax / 127, q = clip(round_half_even(x * (127 / amax)),
// +-127), q = 0 and ex = 0 for an all-zero tile, both divisions true: the
// bits of quantize_x_tiles (ops/cuda/qmm.py). One warp per (row, 256-element
// span), bound by x's bytes; lane l reads the span's elements 8l .. 8l+7. A
// map places them:
//   tile(l)     which of the span's two tiles (0 or 1) they belong to
//   place(l)    their place in that tile (a multiple of 8)
//   X0 .. X3    the lane masks by which the 16 lanes of one tile differ
// and XOut the tiles in memory: tile h of span t of row m starts at
// qx[h] + m * qrow + t * qspan, its scale is ex[h][m * erow + t * espan].
// A lane past K (a Q8_0 row with K % 256 == 128: its last span's second
// tile) reads zeros and writes nothing.

// K3 (Q4_K): the lo and hi nibble tiles of a superblock in qs byte order,
// element 64g + 32h + i at place 32g + i.
struct XQ4K {
    static constexpr int X0 = 1, X1 = 2, X2 = 8, X3 = 16;
    __device__ static int tile(int l) { return (l >> 2) & 1; }
    __device__ static int place(int l) { return 32 * (l >> 3) + 8 * (l & 3); }
};
// K6-i8 (Q4_0): of 32-element block b, elements i < 16 in the lo tile and
// 16 + i in the hi tile, both at place 16b + i (qs byte order).
struct XQ40 {
    static constexpr int X0 = 1, X1 = 4, X2 = 8, X3 = 16;
    __device__ static int tile(int l) { return (l >> 1) & 1; }
    __device__ static int place(int l) { return 16 * (l >> 2) + 8 * (l & 1); }
};
// K5-i8 (Q8_0): the natural 128-element tiles of K.
struct XQ80 {
    static constexpr int X0 = 1, X1 = 2, X2 = 4, X3 = 8;
    __device__ static int tile(int l) { return l >> 4; }
    __device__ static int place(int l) { return 8 * (l & 15); }
};

struct XOut {
    int8_t* qx[2];
    float* ex[2];
    long long qrow, qspan;
    int erow, espan;
};

template <typename T> __device__ __forceinline__ void load8(const T* p, float* v);
template <> __device__ __forceinline__ void load8<float>(const float* p, float* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <> __device__ __forceinline__ void load8<uint16_t>(const uint16_t* p, float* v) {
    const uint4 a = reinterpret_cast<const uint4*>(p)[0];      // 8 bf16
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}

template <class Map, typename T>
__global__ void __launch_bounds__(256)
quant_x_kernel(const T* __restrict__ x, XOut o, int M, int K) {
    const int spans = (K + 255) / 256;
    const int wid = blockIdx.x * 8 + (threadIdx.x >> 5);
    if (wid >= M * spans) return;              // the whole warp
    const int lane = threadIdx.x & 31;
    const int m = wid / spans;
    const int t = wid - m * spans;
    const bool valid = 256 * t + 8 * lane < K;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) load8<T>(x + (size_t)m * K + (size_t)t * 256 + 8 * lane, v);
    float a = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) a = fmaxf(a, fabsf(v[u]));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, Map::X0));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, Map::X1));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, Map::X2));
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, Map::X3));
    if (!valid) return;
    const float ex = __fdiv_rn(a, 127.f);
    const float inv = a > 0.f ? __fdiv_rn(127.f, a) : 0.f;
    uint32_t w[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int qv = min(127, max(-127, __float2int_rn(__fmul_rn(v[u], inv))));
        w[u >> 2] |= ((uint32_t)qv & 0xFFu) << (8 * (u & 3));
    }
    const bool h = Map::tile(lane);
    const int place = Map::place(lane);
    int8_t* qx = h ? o.qx[1] : o.qx[0];        // selects: no indexed copy of o
    float* exd = h ? o.ex[1] : o.ex[0];
    *reinterpret_cast<uint2*>(qx + m * o.qrow + t * o.qspan + place) = make_uint2(w[0], w[1]);
    if (place == 0) exd[(size_t)m * o.erow + (size_t)t * o.espan] = ex;
}

// Quantize x (f32 with x_bf16 = 0, bf16 with 1; 16-byte aligned) with map
// Map; K % 128 == 0.
template <class Map>
int quant_x(const void* x, int x_bf16, const XOut& o, int M, int K, cudaStream_t stream) {
    if (M < 1 || K < 1 || K % 128 != 0) return (int)cudaErrorInvalidValue;
    const long long warps = (long long)M * ((K + 255) / 256);
    const dim3 grid((unsigned)((warps + 7) / 8));
    if (x_bf16)
        quant_x_kernel<Map, uint16_t><<<grid, 256, 0, stream>>>((const uint16_t*)x, o, M, K);
    else
        quant_x_kernel<Map, float><<<grid, 256, 0, stream>>>((const float*)x, o, M, K);
    return (int)cudaGetLastError();
}

}  // namespace
}  // namespace qmm_i8
