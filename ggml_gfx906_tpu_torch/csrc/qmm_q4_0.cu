// Q4_0 int8 matmul kernel K6-i8 for Hopper (sm_90a). K6, the f32 product
// for M < int8_min_m, is a format on the shared f32 body
// (csrc/qmm_f32_tiled.cuh; its entry point qmm_q4_0_f32 is in
// csrc/qmm_legacy.cu, beside K8's).
//
// Q4_0 weight layout (ggml wire order, struct of arrays, per row n of N,
// per 32-element block b of K/32):
//   qs (N, K/2)  u8 : byte 16*b + j holds element 32*b + j in its low nibble
//                     and element 32*b + 16 + j in its high nibble
//   d  (N, K/32) f32: one scale per block
//
// The kernel is deterministic: each output element is summed by one thread
// in an order fixed by K alone, never by M, by the row's place in its tile,
// or by the launch shape. No atomics, no split-K.
//
// Returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

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
