// Q4_0 fused dequant + matmul kernels for Hopper (sm_90a).
//
// Q4_0 weight layout (ggml wire order, struct of arrays, per row n of N,
// per 32-element block b of K/32):
//   qs (N, K/2)  u8 : byte 16*b + j holds element 32*b + j in its low nibble
//                     and element 32*b + 16 + j in its high nibble
//   d  (N, K/32) f32: one scale per block
// w = (q - 8) * d; q - 8 is exact, so the one product rounds once and the
// weights formed in registers equal the plain dequantization bit for bit.
//
// Both kernels are deterministic: each output element is summed by one warp
// or one thread in an order fixed by K alone, never by M, by the row's place
// in its tile, or by the launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ K6
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_0 (_q40_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T, for M < int8_min_m (decode, short
// prefill chunks).
// Bound on the H100: bytes. The weight stream is 0.625 B per weight
// (0.5 qs + 1/8 d) and is read once; the FMAs are 2*M flops per weight, far
// below the 67 TFLOP/s f32 rate at M <= 63.
// Design: K5's (csrc/qmm_q8_0.cu). One warp owns K6_ROWS weight rows and
// walks K in 512-element spans, K6_SPANS at a time; lane l owns half a
// block (8 qs bytes: 8 low-nibble and 8 high-nibble elements, one scale) of
// every span. Two lanes share a block, so one warp-wide 16-byte load of x
// touches 16 cache lines, as K1's and K5's do; a lane owning a whole block
// would make it 32 (K5's first design, 1.5x slower at M=8). Each lane forms
// its f32 weights in registers and FMAs them against up to K6_MT activation
// rows; lanes then reduce with a fixed xor-shuffle butterfly. FP32 FMA on
// the CUDA cores, never TF32: the reference dot is HIGHEST precision.

#define K6_WARPS 4
#define K6_ROWS 2
#define K6_MT 8
#define K6_SPANS 4       // 512-element spans whose weights are loaded at once

__global__ void __launch_bounds__(K6_WARPS * 32)
qmm_q4_0_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                    const float* __restrict__ d, float* __restrict__ y,
                    int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K6_WARPS + warp) * K6_ROWS;
    const int m0 = blockIdx.y * K6_MT;
    const int chunks = K / 16;          // half blocks (8 qs bytes) per row
    const int nblk = K / 32;
    const size_t row_qs = (size_t)K / 2;

    float acc[K6_ROWS][K6_MT];
#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K6_MT; ++m) acc[r][m] = 0.f;

    for (int c0 = lane; c0 < chunks; c0 += 32 * K6_SPANS) {
        // all weight loads of this group of spans first, then the arithmetic
        uint2 q8[K6_ROWS][K6_SPANS];
        float dv[K6_ROWS][K6_SPANS];
#pragma unroll
        for (int j = 0; j < K6_SPANS; ++j) {
            const int c = c0 + 32 * j;
#pragma unroll
            for (int r = 0; r < K6_ROWS; ++r) {
                const int n = n0 + r;
                const bool ok = n < N && c < chunks;
                q8[r][j] = ok ? *reinterpret_cast<const uint2*>(qs + (size_t)n * row_qs + (size_t)c * 8)
                              : make_uint2(0u, 0u);
                dv[r][j] = ok ? d[(size_t)n * nblk + (c >> 1)] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < K6_SPANS; ++j) {
            const int c = c0 + 32 * j;
            if (c < chunks) {
                const int e_lo = (c >> 1) * 32 + (c & 1) * 8;   // low nibbles
                const int e_hi = e_lo + 16;                      // high nibbles
                float wlo[K6_ROWS][8], whi[K6_ROWS][8];
#pragma unroll
                for (int r = 0; r < K6_ROWS; ++r) {
                    const uint32_t words[2] = {q8[r][j].x, q8[r][j].y};
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const uint32_t b = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                        wlo[r][i] = __fmul_rn((float)((int)(b & 0xFu) - 8), dv[r][j]);
                        whi[r][i] = __fmul_rn((float)((int)(b >> 4) - 8), dv[r][j]);
                    }
                }
#pragma unroll
                for (int m = 0; m < K6_MT; ++m) {
                    if (m0 + m < M) {
                        const float* xr = x + (size_t)(m0 + m) * K;
#pragma unroll
                        for (int v = 0; v < 2; ++v) {
                            const float4 xl = *reinterpret_cast<const float4*>(xr + e_lo + 4 * v);
#pragma unroll
                            for (int r = 0; r < K6_ROWS; ++r) {
                                acc[r][m] = fmaf(xl.x, wlo[r][4 * v + 0], acc[r][m]);
                                acc[r][m] = fmaf(xl.y, wlo[r][4 * v + 1], acc[r][m]);
                                acc[r][m] = fmaf(xl.z, wlo[r][4 * v + 2], acc[r][m]);
                                acc[r][m] = fmaf(xl.w, wlo[r][4 * v + 3], acc[r][m]);
                            }
                        }
#pragma unroll
                        for (int v = 0; v < 2; ++v) {
                            const float4 xh = *reinterpret_cast<const float4*>(xr + e_hi + 4 * v);
#pragma unroll
                            for (int r = 0; r < K6_ROWS; ++r) {
                                acc[r][m] = fmaf(xh.x, whi[r][4 * v + 0], acc[r][m]);
                                acc[r][m] = fmaf(xh.y, whi[r][4 * v + 1], acc[r][m]);
                                acc[r][m] = fmaf(xh.z, whi[r][4 * v + 2], acc[r][m]);
                                acc[r][m] = fmaf(xh.w, whi[r][4 * v + 3], acc[r][m]);
                            }
                        }
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < K6_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K6_MT; ++m) {
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

extern "C" int qmm_q4_0_f32(const float* x, const uint8_t* qs, const float* d,
                            float* y, int M, int N, int K, void* stream) {
    dim3 grid((N + K6_WARPS * K6_ROWS - 1) / (K6_WARPS * K6_ROWS),
              (M + K6_MT - 1) / K6_MT);
    qmm_q4_0_f32_kernel<<<grid, K6_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, qs, d, y, M, N, K);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K6-i8
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_0_i8 (_q40_i8_kernel,
// launcher _i8_call): y (M, N) f32 for M >= int8_min_m (prefill).
// Each 256-element span t gives two 128-element int8 tiles: (lo, t) holds
// the first 16 elements of each of its 8 blocks, (hi, t) their last 16 —
// the low and the high nibbles of qs bytes [128t, 128t + 128), here in qs
// byte order (the reference's q40_split_x groups the same elements). x
// arrives quantized per (row, tile) — qx int8 + ex f32. The packed bytes
// are expanded to int8 in shared memory with the folded scales (block
// scales pre-divided by the per-span bound dw, which both tiles share):
// w8 = round_half_even((q - 8) * dsc'), clipped to +-127, exactly as
// _round_i8. int8.int8 -> int32 products run on __dp4a and are exact; the
// epilogue applies
//   acc += ((float)p * ex[m,t]) * dw[n,t]     (lo tile, then hi tile)
// in the reference's order.
// Bound on the H100: bytes at M≈128 (the 5-bit weights), operations
// (2*M*N*K int8 ops) at larger M; this first version uses dp4a on the CUDA
// cores, not the int8 tensor cores, so it sits well above both (mma.sync /
// wgmma are a later step).
// Design: K3's (csrc/qmm_q4k.cu): a block owns a 64 (M) x 64 (N) output
// tile and walks K one 256-element span at a time. The TPU kernel expands
// each weight tile once per N tile and reuses it across M through its
// sequential grid; GPU blocks run in no order, so here the expansion lives
// in each block's shared memory. The weights stay packed in device memory.

#define K6I_BM 64
#define K6I_BN 64
#define K6I_THREADS 256
#define K6I_WORDS 32     // 128 int8 per tile = 32 words
#define K6I_PAD 33       // padded row stride in words: no bank conflicts

__device__ __forceinline__ int round_i8(float v) {
    int r = __float2int_rn(v);           // round half to even, like jnp.round
    return min(127, max(-127, r));
}

__global__ void __launch_bounds__(K6I_THREADS)
qmm_q4_0_i8_kernel(const int8_t* __restrict__ qxlo, const float* __restrict__ exlo,
                   const int8_t* __restrict__ qxhi, const float* __restrict__ exhi,
                   const uint8_t* __restrict__ qs, const float* __restrict__ dsc,
                   const float* __restrict__ dw, float* __restrict__ y,
                   int M, int N, int K) {
    __shared__ int xs[2][K6I_BM][K6I_PAD];
    __shared__ int ws[2][K6I_BN][K6I_PAD];
    const int tid = threadIdx.x;
    const int tx = tid & 15;      // n = tx + 16*j
    const int ty = tid >> 4;      // m = ty + 16*i
    const int m0 = blockIdx.y * K6I_BM;
    const int n0 = blockIdx.x * K6I_BN;
    const int kt = K / 256;
    const size_t half = (size_t)K / 2;

    float out[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = 0.f;

    for (int t = 0; t < kt; ++t) {
        __syncthreads();          // the previous tile's reads are done
        for (int i = tid; i < 2 * K6I_BM * K6I_WORDS; i += K6I_THREADS) {
            const int h = i / (K6I_BM * K6I_WORDS);
            const int rem = i - h * K6I_BM * K6I_WORDS;
            const int r = rem / K6I_WORDS;
            const int w = rem - r * K6I_WORDS;
            const int m = m0 + r;
            int val = 0;
            if (m < M) {
                const int8_t* src = (h ? qxhi : qxlo) + (size_t)m * half + (size_t)t * 128;
                val = reinterpret_cast<const int*>(src)[w];
            }
            xs[h][r][w] = val;
        }
        for (int i = tid; i < K6I_BN * K6I_WORDS; i += K6I_THREADS) {
            const int r = i / K6I_WORDS;
            const int w = i - r * K6I_WORDS;
            const int n = n0 + r;
            uint32_t lo_word = 0, hi_word = 0;
            if (n < N) {
                const uint32_t q4 = reinterpret_cast<const uint32_t*>(
                    qs + (size_t)n * half + (size_t)t * 128)[w];
                // word w holds bytes 4w..4w+3 of the span: block w/4 (16 bytes each)
                const float s = dsc[(size_t)n * (K / 32) + (size_t)t * 8 + (w >> 2)];
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const uint32_t byte = (q4 >> (8 * b)) & 0xFFu;
                    const int vl = round_i8(__fmul_rn((float)((int)(byte & 0xFu) - 8), s));
                    const int vh = round_i8(__fmul_rn((float)((int)(byte >> 4) - 8), s));
                    lo_word |= ((uint32_t)(vl & 0xFF)) << (8 * b);
                    hi_word |= ((uint32_t)(vh & 0xFF)) << (8 * b);
                }
            }
            ws[0][r][w] = (int)lo_word;
            ws[1][r][w] = (int)hi_word;
        }
        __syncthreads();

#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0;
#pragma unroll 8
            for (int w = 0; w < K6I_WORDS; ++w) {
                int a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = xs[h][ty + 16 * i][w];
#pragma unroll
                for (int j = 0; j < 4; ++j) b[j] = ws[h][tx + 16 * j][w];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
            }
            const float* ex = h ? exhi : exlo;
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

extern "C" int qmm_q4_0_i8(const int8_t* qxlo, const float* exlo,
                           const int8_t* qxhi, const float* exhi,
                           const uint8_t* qs, const float* dsc, const float* dw,
                           float* y, int M, int N, int K, void* stream) {
    dim3 grid((N + K6I_BN - 1) / K6I_BN, (M + K6I_BM - 1) / K6I_BM);
    qmm_q4_0_i8_kernel<<<grid, K6I_THREADS, 0, (cudaStream_t)stream>>>(
        qxlo, exlo, qxhi, exhi, qs, dsc, dw, y, M, N, K);
    return (int)cudaGetLastError();
}
