// Q8_0 fused dequant + matmul kernels for Hopper (sm_90a).
//
// Q8_0 weight layout (ggml wire order, struct of arrays, per row n of N):
//   qs (N, K)    i8 : the quants, in element order
//   d  (N, K/32) f32: one scale per 32-element block
// w = q * d, exact in f32.
//
// Both kernels are deterministic: each output element is summed by one warp
// or one thread in an order fixed by K alone, never by M, by the row's place
// in its tile, or by the launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

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
// (prefill).
// x arrives quantized per (row, 128-element tile) — qx int8 + ex f32 (M,
// K/128). The weights are expanded to int8 in shared memory with the
// folded scales (block scales pre-divided by the per-tile bound dw, N x
// K/128): w8 = round_half_even(q * dsc'), clipped to +-127, exactly as
// _round_i8. int8.int8 -> int32 products run on __dp4a and are exact; the
// epilogue applies
//   acc += ((float)p * ex[m,t]) * dw[n,t]
// in the reference's order.
// Bound on the H100: bytes at M≈128 (the 9-bit weights), operations (2*M*N*K
// int8 ops) at larger M; this first version uses dp4a on the CUDA cores,
// not the int8 tensor cores, so it sits well above both (mma.sync / wgmma
// are a later step).
// Design: K3's (csrc/qmm_q4k.cu) with one 128-element tile per step: a
// block owns a 64 (M) x 64 (N) output tile and walks K one tile at a time.
// The TPU kernel expands each weight tile once per N tile and reuses it
// across M through its sequential grid; GPU blocks run in no order, so
// here the expansion lives in each block's shared memory.

#define K5I_BM 64
#define K5I_BN 64
#define K5I_THREADS 256
#define K5I_WORDS 32     // 128 int8 per tile = 32 words
#define K5I_PAD 33       // padded row stride in words: no bank conflicts

__device__ __forceinline__ int round_i8(float v) {
    int r = __float2int_rn(v);           // round half to even, like jnp.round
    return min(127, max(-127, r));
}

__global__ void __launch_bounds__(K5I_THREADS)
qmm_q8_0_i8_kernel(const int8_t* __restrict__ qx, const float* __restrict__ ex,
                   const int8_t* __restrict__ qs, const float* __restrict__ dsc,
                   const float* __restrict__ dw, float* __restrict__ y,
                   int M, int N, int K) {
    __shared__ int xs[K5I_BM][K5I_PAD];
    __shared__ int ws[K5I_BN][K5I_PAD];
    const int tid = threadIdx.x;
    const int tx = tid & 15;      // n = tx + 16*j
    const int ty = tid >> 4;      // m = ty + 16*i
    const int m0 = blockIdx.y * K5I_BM;
    const int n0 = blockIdx.x * K5I_BN;
    const int kt = K / 128;

    float out[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = 0.f;

    for (int t = 0; t < kt; ++t) {
        __syncthreads();          // the previous tile's reads are done
        for (int i = tid; i < K5I_BM * K5I_WORDS; i += K5I_THREADS) {
            const int r = i / K5I_WORDS;
            const int w = i - r * K5I_WORDS;
            const int m = m0 + r;
            xs[r][w] = m < M ? reinterpret_cast<const int*>(
                                   qx + (size_t)m * K + (size_t)t * 128)[w]
                             : 0;
        }
        for (int i = tid; i < K5I_BN * K5I_WORDS; i += K5I_THREADS) {
            const int r = i / K5I_WORDS;
            const int w = i - r * K5I_WORDS;
            const int n = n0 + r;
            uint32_t word = 0;
            if (n < N) {
                const uint32_t q4 = reinterpret_cast<const uint32_t*>(
                    qs + (size_t)n * K + (size_t)t * 128)[w];
                // word w holds elements 4w..4w+3 of the tile: block w/8
                const float s = dsc[(size_t)n * (K / 32) + (size_t)t * 4 + (w >> 3)];
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const int q = (int)(int8_t)((q4 >> (8 * b)) & 0xFFu);
                    const int v = round_i8(__fmul_rn((float)q, s));
                    word |= ((uint32_t)(v & 0xFF)) << (8 * b);
                }
            }
            ws[r][w] = (int)word;
        }
        __syncthreads();

        int acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 8
        for (int w = 0; w < K5I_WORDS; ++w) {
            int a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][w];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = ws[tx + 16 * j][w];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + ty + 16 * i;
            const float exv = m < M ? ex[(size_t)m * kt + t] : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + tx + 16 * j;
                const float dwv = n < N ? dw[(size_t)n * kt + t] : 0.f;
                out[i][j] = __fadd_rn(out[i][j],
                                      __fmul_rn(__fmul_rn((float)acc[i][j], exv), dwv));
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 16 * j;
            if (m < M && n < N) y[(size_t)m * N + n] = out[i][j];
        }
    }
}

extern "C" int qmm_q8_0_i8(const int8_t* qx, const float* ex, const int8_t* qs,
                           const float* dsc, const float* dw, float* y,
                           int M, int N, int K, void* stream) {
    dim3 grid((N + K5I_BN - 1) / K5I_BN, (M + K5I_BM - 1) / K5I_BM);
    qmm_q8_0_i8_kernel<<<grid, K5I_THREADS, 0, (cudaStream_t)stream>>>(
        qx, ex, qs, dsc, dw, y, M, N, K);
    return (int)cudaGetLastError();
}
