// Q8_0 fused dequant + matmul kernels for Hopper (sm_90a).
//
// Q8_0 weight layout (ggml wire order, struct of arrays, per row n of N):
//   qs (N, K)    i8 : the quants, in element order
//   d  (N, K/32) f32: one scale per 32-element block
// w = q * d, exact in f32.
//
// Both kernels are deterministic: each output element is summed in an order
// fixed by K alone, never by M, by the row's place in its tile, or by the
// launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include "qmm_i8_tiled.cuh"

// ------------------------------------------------------------------ K5
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q8_0 (_q8_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T, for M < int8_min_m (decode, short
// prefill chunks).
// Bound on the H100: bytes. The weight stream is 1.125 B per weight
// (1 qs + 1/8 d) and is read once; the FMAs are 2*M flops per weight, far
// below the 67 TFLOP/s f32 rate at M <= 63.
// Design: K1's (csrc/qmm_q4k.cu). One warp owns K5_ROWS weight rows and
// walks K in 512-element spans, K5_SPANS at a time; lane l owns elements
// 16l..16l+15 of every span (half a block: one 16-byte load of each row,
// one scale), so one warp-wide 16-byte load of x touches 16 cache lines,
// as K1's do (a lane owning a whole 32-element block made it 32 lines, and
// the kernel 1.5x slower at M=8). Each lane forms its f32 weights in registers and FMAs them
// against up to K5_MT activation rows; lanes then reduce with a fixed
// xor-shuffle butterfly. FP32 FMA on the CUDA cores, never TF32: the
// reference dot is HIGHEST precision.

#define K5_WARPS 4
#define K5_ROWS 2
#define K5_MT 8
#define K5_SPANS 2       // 512-element spans whose weights are loaded at once

__global__ void __launch_bounds__(K5_WARPS * 32)
qmm_q8_0_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ qs,
                    const float* __restrict__ d, float* __restrict__ y,
                    int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K5_WARPS + warp) * K5_ROWS;
    const int m0 = blockIdx.y * K5_MT;
    const int chunks = K / 16;          // 16-element chunks per row
    const int nblk = K / 32;

    float acc[K5_ROWS][K5_MT];
#pragma unroll
    for (int r = 0; r < K5_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K5_MT; ++m) acc[r][m] = 0.f;

    for (int c0 = lane; c0 < chunks; c0 += 32 * K5_SPANS) {
        // all weight loads of this group of spans first, then the arithmetic
        uint4 q16[K5_ROWS][K5_SPANS];
        float dv[K5_ROWS][K5_SPANS];
#pragma unroll
        for (int j = 0; j < K5_SPANS; ++j) {
            const int c = c0 + 32 * j;
#pragma unroll
            for (int r = 0; r < K5_ROWS; ++r) {
                const int n = n0 + r;
                const bool ok = n < N && c < chunks;
                q16[r][j] = ok ? *reinterpret_cast<const uint4*>(qs + (size_t)n * K + (size_t)c * 16)
                               : make_uint4(0u, 0u, 0u, 0u);
                dv[r][j] = ok ? d[(size_t)n * nblk + (c >> 1)] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < K5_SPANS; ++j) {
            const int c = c0 + 32 * j;
            if (c < chunks) {
                float w[K5_ROWS][16];
#pragma unroll
                for (int r = 0; r < K5_ROWS; ++r) {
                    const uint32_t words[4] = {q16[r][j].x, q16[r][j].y, q16[r][j].z, q16[r][j].w};
#pragma unroll
                    for (int i = 0; i < 16; ++i)
                        w[r][i] = __fmul_rn(
                            (float)(int)(int8_t)((words[i >> 2] >> (8 * (i & 3))) & 0xFFu),
                            dv[r][j]);
                }
#pragma unroll
                for (int m = 0; m < K5_MT; ++m) {
                    if (m0 + m < M) {
                        const float* xr = x + (size_t)(m0 + m) * K + (size_t)c * 16;
#pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * v);
#pragma unroll
                            for (int r = 0; r < K5_ROWS; ++r) {
                                acc[r][m] = fmaf(xv.x, w[r][4 * v + 0], acc[r][m]);
                                acc[r][m] = fmaf(xv.y, w[r][4 * v + 1], acc[r][m]);
                                acc[r][m] = fmaf(xv.z, w[r][4 * v + 2], acc[r][m]);
                                acc[r][m] = fmaf(xv.w, w[r][4 * v + 3], acc[r][m]);
                            }
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < K5_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K5_MT; ++m) {
            float v = acc[r][m];
            // butterfly: every lane ends with the same bits (a+b == b+a)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            const int n = n0 + r;
            if (lane == 0 && n < N && m0 + m < M) y[(size_t)(m0 + m) * N + n] = v;
        }
    }
}

extern "C" int qmm_q8_0_f32(const float* x, const int8_t* qs, const float* d,
                            float* y, int M, int N, int K, void* stream) {
    dim3 grid((N + K5_WARPS * K5_ROWS - 1) / (K5_WARPS * K5_ROWS),
              (M + K5_MT - 1) / K5_MT);
    qmm_q8_0_f32_kernel<<<grid, K5_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, qs, d, y, M, N, K);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K5-i8
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q8_0_i8 (_qd_i8_kernel
// with nblk=4, launcher _i8_call): y (M, N) f32 for M >= int8_min_m
// (prefill), in two launches.
// 1. `qmm_i8::quant_x` with the map XQ80 (qmm_i8_tiled.cuh, shared with K3
//    and K6-i8): x (M, K) f32 or bf16 -> qx (M, K) int8 and ex (M, K/128)
//    f32 per (row, natural 128-element tile), the bits of quantize_x_tiles
//    (the reference's q8_split_x only permutes lanes inside a tile). Bound
//    by x's bytes.
// 2. The int8 body (qmm_i8_tiled.cuh) with the format Q80I8 below, one
//    tile per step: per (row, tile) the fold of the 4 block scales by the
//    tile bound, 127 |d| per block, its amax, dw = amax / 127, inv = 127 /
//    amax (0 when amax = 0), d' = d * inv, then w8 = clip(round_half_even(
//    q * d'), +-127) (q = -128 clips at -127): every step one IEEE
//    operation (__fmul_rn / __fdiv_rn), the bits of tile_fold(d, None, 4,
//    127) + expand_w8. Integer dots on the int8 tensor cores (mma.sync),
//    then out += (acc * ex) * dw per tile in ascending order, as the
//    reference and the earlier dp4a kernel sum: the output keeps their bits
//    at every M and shape.
// Bound on the H100: the weight bytes (1.125 B per weight) at M = 64..128,
// operations (2*M*N*K int8) at larger M; the expansion on the CUDA cores
// (a byte permute, a subtraction, a product and the rounding per weight,
// once per block row of 128 activation rows) sets the pace between them.
// What bounded the earlier design (PERF.md): the operand preparation ran
// as eager torch ops per call, the weights' fold recomputed every call,
// and the dots ran on dp4a with no load in flight.

namespace q80_i8 {

struct Q80I8 {
    static constexpr int TILES = 1;
    static constexpr int SPAN = 128;
    struct Ptrs {
        const int8_t* qs;
        const float* d;
    };
    // BN = 64 (BPT = 32, one block a thread): d.x is the thread's block's
    // scale, and the tile's amax meets in an xor butterfly over the row's 4
    // lanes (max is exact: any order). BN = 32 (BPT = 16, half a block):
    // d holds the tile's 4 scales; there a butterfly over 8 lanes took
    // longer than the loads it saves (one block per SM, latency-bound).
    struct Raw {
        uint4 q[2];                      // BPT (16 or 32) quants
        float4 d;
    };
    __device__ static void zero(Raw& r) {
        r.q[0] = r.q[1] = make_uint4(0, 0, 0, 0);
        r.d = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    template <int BPT>
    __device__ static void load(Raw& r, const Ptrs& p, int n, int s, int piece, int K) {
        const int8_t* q = p.qs + (size_t)n * K + (size_t)s * 128 + piece * BPT;
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i) r.q[i] = __ldg(reinterpret_cast<const uint4*>(q) + i);
        const float* d = p.d + (size_t)n * (K / 32) + 4 * (size_t)s;
        if constexpr (BPT == 32) r.d.x = __ldg(d + piece);
        else r.d = __ldg(reinterpret_cast<const float4*>(d));
    }
    template <int BPT>
    __device__ static void expand(const Raw& r, int piece, uint4 (&wv)[1][BPT / 16],
                                  float (&dw)[1]) {
        float amax, db;
        if constexpr (BPT == 32) {
            db = r.d.x;
            amax = __fmul_rn(127.f, fabsf(db));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        } else {
            const float d[4] = {r.d.x, r.d.y, r.d.z, r.d.w};
            amax = 0.f;
            db = 0.f;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                amax = fmaxf(amax, __fmul_rn(127.f, fabsf(d[b])));
                if (b == piece / 2) db = d[b];
            }
        }
        dw[0] = __fdiv_rn(amax, 127.f);
        const float inv = amax > 0.f ? __fdiv_rn(127.f, amax) : 0.f;
        const float ds = __fmul_rn(db, inv);
        // q + 128 in each byte: its float minus 2^23 + 128 is q
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i)
            wv[0][i] = make_uint4(qmm_i8::expand4(r.q[i].x ^ 0x80808080u, 8388736.f, ds),
                                  qmm_i8::expand4(r.q[i].y ^ 0x80808080u, 8388736.f, ds),
                                  qmm_i8::expand4(r.q[i].z ^ 0x80808080u, 8388736.f, ds),
                                  qmm_i8::expand4(r.q[i].w ^ 0x80808080u, 8388736.f, ds));
    }
};

}  // namespace q80_i8

// K5-i8's x quantization: x (M, K) f32 (x_bf16 = 0) or bf16 (1), 16-byte
// aligned, K % 128 == 0 -> qx (M, K) int8, ex (M, K/128) f32.
extern "C" int qmm_q8_0_i8_quant_x(const void* x, int x_bf16, int8_t* qx, float* ex,
                                   int M, int K, void* stream) {
    const qmm_i8::XOut o = {{qx, qx + 128}, {ex, ex + 1}, K, 256, K / 128, 2};
    return qmm_i8::quant_x<qmm_i8::XQ80>(x, x_bf16, o, M, K, (cudaStream_t)stream);
}

// K5-i8's product on quantized x: qx (M, K) int8, ex (M, K/128) f32, the
// Q8_0 weights as K5 takes them.
extern "C" int qmm_q8_0_i8(const int8_t* qx, const float* ex, const int8_t* qs,
                           const float* d, float* y, int M, int N, int K, void* stream) {
    qmm_i8::XOps<1> x = {{qx}, {ex}};
    return qmm_i8::launch<q80_i8::Q80I8>(x, {qs, d}, y, M, N, K, (cudaStream_t)stream);
}
