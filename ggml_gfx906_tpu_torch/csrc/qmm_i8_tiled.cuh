// Shared body of the int8 quantized matmul kernels for Hopper (sm_90a):
//   y (M, N) f32 = sum over K steps s and int8 tiles h of
//                  (dot_int(qx_h[m, s], w8_h[n, s]) * ex_h[m, s]) * dw_h[n, s]
// taken per step in ascending order, tile 0 first, each product and sum
// rounded on its own (the reference's epilogue order,
// ggml_gfx906_tpu/ops/pallas/qmm.py::_i8_call). Used by K3 (Q4_K,
// csrc/qmm_q4k.cu); K5-i8 and K6-i8 keep their own kernels for now.
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
//                               and each tile's dw
// Every dot is an exact integer sum (mma.sync s8 x s8 -> s32), so only the
// fold, the expansion and the epilogue round, and they round as the
// reference does: the output's bits do not depend on the tile shape, the
// launch, M or a row's neighbours.
//
// Bound on the H100: operations (2*M*N*K int8 at 1979 TOP/s) at large M;
// at the main path's M = 100..128 the weight bytes (~0.56 B per weight)
// and the expansion on the CUDA cores. Design:
// - a block of 8 warps owns BM = 128 activation rows and BN = 64 (or 32
//   when 64 would leave SMs idle) weight rows; warps 4 (M) x 2 (N), a warp
//   32 x BN/2 of mma.sync.m16n8k32 tiles;
// - per step the block expands its BN rows' packed bytes once into shared
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
__device__ __forceinline__ uint32_t round_i8_byte(float v) {
    v = fminf(fmaxf(v, -127.f), 127.f);
    return __float_as_uint(__fadd_rn(v, 12582912.f)) & 0xFFu;
}

// The float of a small non-negative integer q: 2^23 + q under the exponent,
// minus 2^23; exact, and no int-to-float conversion.
__device__ __forceinline__ float small_float(uint32_t q) {
    return __fsub_rn(__uint_as_float(0x4B000000u | q), 8388608.f);
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
        for (int u = tid; u < TILES * BM * (TK / 16); u += THREADS) {
            const int h = u / (BM * (TK / 16));
            const int rem = u - h * (BM * (TK / 16));
            const int r = rem / (TK / 16);
            const int q16 = rem - r * (TK / 16);
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

}  // namespace
}  // namespace qmm_i8
