// Q4_K fused dequant + matmul kernels for Hopper (sm_90a).
//
// Q4_K weight layout (ggml wire order, struct of arrays, per row n of N,
// per 256-element superblock sb of nb = K/256):
//   qs  (N, nb*128) u8 : byte 32*g + j of a superblock holds element
//                        64*g + j in its low nibble (sub-block 2g) and
//                        64*g + 32 + j in its high nibble (sub-block 2g+1)
//   scm (N, nb*16)  u8 : unpacked 6-bit [sc0..sc7 | m0..m7]
//   dd  (N, nb*2)   f32: [d, dmin]
// w = q * (d*sc) - (dmin*m), every product and the difference rounded on
// its own (__fmul_rn/__fsub_rn keep nvcc from contracting them into an FMA),
// so the weights formed in registers equal the plain dequantization bit for
// bit.
//
// Both kernels are deterministic: each output element is summed in an
// order fixed by K alone, never by M, by the row's place in its tile, or
// by the launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include "qmm_f32_tiled.cuh"

// ------------------------------------------------------------------ K1
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_K (_q4k_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T, for M < int8_min_m (decode, short
// prefill chunks); K3 takes the larger M.
// The body is qmm_f32_tiled.cuh's, shared with K4, K6, K7, K8 and K9: the
// format Q4K there is K7's Q5_K without the fifth bits (HBYTES = 0). The
// entry point picks its kernel by M (fuller notes in the header):
// - M = 1 (single-stream decode): `qmm_q4k_f32_kernel` below, K1's kernel
//   from before the body: one warp owns 2 weight rows, each lane reads 16
//   packed bytes (32 weights) per step, forms the weights in registers and
//   reads x through L1/L2. On an H100 the body's decode kernel took 13%
//   longer at M = 1 on 4096 x 4096, and 10% longer over a 32-layer decode
//   step (PERF.md), so this kernel stays for M = 1; it sums in the body's
//   order, so the bits are the same.
// - 2 <= M <= 8 (the engine's decode steps): `small_kernel`, lanes over the
//   K chunks, 2 weight rows per warp, x staged per 32 chunks in shared
//   memory.
//   Both decode kernels are bound by the weight bytes (~0.59 B per weight:
//   0.5 qs + 1/16 scm + 1/32 dd, read once: 0.0080 ms for 11008 x 4096 on
//   the H100), then latency.
// - M > 8 (the engine's chunks, prefill tails shorter than int8_min_m):
//   `tiled_kernel` or `tree_kernel`, each weight read and dequantized once
//   per 32 or 64 activation rows (the earlier design: once per 8). Bound:
//   the f32 FMA rate (2*M*N*K flops at 67 TFLOP/s: 0.0848 ms for 11008 x
//   4096 at M = 63), then shared memory and the L2 traffic of x.
// Reduction order: the body's, which was K1's before it: lane (slot) l
// takes the chunks c ≡ l (mod 32) in order, each chunk's 16 low then 16
// high elements, then the xor-butterfly tree. So K1's results kept their
// bits when it came onto the body. FP32 FMA on the CUDA cores, never TF32:
// the reference dot is HIGHEST precision.

#define K1_WARPS 4
#define K1_ROWS 2
#define K1_MT 8

__global__ void __launch_bounds__(K1_WARPS * 32)
qmm_q4k_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                   const uint8_t* __restrict__ scm, const float* __restrict__ dd,
                   float* __restrict__ y, int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K1_WARPS + warp) * K1_ROWS;
    const int m0 = blockIdx.y * K1_MT;
    const int nb = K / 256;
    const int chunks = K / 32;          // 16-byte chunks of qs per row
    const size_t row_qs = (size_t)K / 2;

    float acc[K1_ROWS][K1_MT];
#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K1_MT; ++m) acc[r][m] = 0.f;

    for (int c = lane; c < chunks; c += 32) {
        const int sb = c >> 3;
        const int o = (c & 7) * 16;     // byte offset inside the superblock
        const int g = o >> 5;           // 64-element group
        const int e_lo = sb * 256 + g * 64 + (o & 31);
        const int e_hi = e_lo + 32;

        float wlo[K1_ROWS][16], whi[K1_ROWS][16];
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
            const int n = n0 + r;
            if (n < N) {
                const uint4 q4 = *reinterpret_cast<const uint4*>(
                    qs + (size_t)n * row_qs + (size_t)c * 16);
                const uint8_t* s = scm + (size_t)n * nb * 16 + sb * 16;
                const float d = dd[(size_t)n * nb * 2 + sb * 2];
                const float dmin = dd[(size_t)n * nb * 2 + sb * 2 + 1];
                const float dsl = __fmul_rn((float)s[2 * g], d);
                const float dsh = __fmul_rn((float)s[2 * g + 1], d);
                const float dml = __fmul_rn((float)s[8 + 2 * g], dmin);
                const float dmh = __fmul_rn((float)s[8 + 2 * g + 1], dmin);
                const uint32_t words[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    const uint32_t b = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                    wlo[r][i] = __fsub_rn(__fmul_rn((float)(b & 0xFu), dsl), dml);
                    whi[r][i] = __fsub_rn(__fmul_rn((float)(b >> 4), dsh), dmh);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 16; ++i) { wlo[r][i] = 0.f; whi[r][i] = 0.f; }
            }
        }
#pragma unroll
        for (int m = 0; m < K1_MT; ++m) {
            if (m0 + m < M) {
                const float* xr = x + (size_t)(m0 + m) * K;
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    const float4 xl = *reinterpret_cast<const float4*>(xr + e_lo + 4 * v);
#pragma unroll
                    for (int r = 0; r < K1_ROWS; ++r) {
                        acc[r][m] = fmaf(xl.x, wlo[r][4 * v + 0], acc[r][m]);
                        acc[r][m] = fmaf(xl.y, wlo[r][4 * v + 1], acc[r][m]);
                        acc[r][m] = fmaf(xl.z, wlo[r][4 * v + 2], acc[r][m]);
                        acc[r][m] = fmaf(xl.w, wlo[r][4 * v + 3], acc[r][m]);
                    }
                }
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    const float4 xh = *reinterpret_cast<const float4*>(xr + e_hi + 4 * v);
#pragma unroll
                    for (int r = 0; r < K1_ROWS; ++r) {
                        acc[r][m] = fmaf(xh.x, whi[r][4 * v + 0], acc[r][m]);
                        acc[r][m] = fmaf(xh.y, whi[r][4 * v + 1], acc[r][m]);
                        acc[r][m] = fmaf(xh.z, whi[r][4 * v + 2], acc[r][m]);
                        acc[r][m] = fmaf(xh.w, whi[r][4 * v + 3], acc[r][m]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K1_MT; ++m) {
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

extern "C" int qmm_q4k_f32(const float* x, const uint8_t* qs, const uint8_t* scm,
                           const float* dd, float* y, int M, int N, int K,
                           void* stream) {
    if (M > 1)
        return qmm_tiled::launch<qmm_tiled::Q4K>(x, {qs, nullptr, scm, dd}, y, M, N, K, stream);
    dim3 grid((N + K1_WARPS * K1_ROWS - 1) / (K1_WARPS * K1_ROWS), 1);
    qmm_q4k_f32_kernel<<<grid, K1_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, qs, scm, dd, y, M, N, K);
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K3
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_K_i8 (_q4k_i8_kernel,
// launcher _i8_call): y (M, N) f32 for M >= int8_min_m (prefill).
// x arrives quantized per (row, 128-element tile) — qx int8 + ex f32, where
// the lo tile of superblock t is its 128 low-nibble elements and the hi tile
// its 128 high-nibble elements, in qs byte order. The packed Q4_K bytes are
// expanded to int8 in shared memory with the folded scales (block scales
// pre-divided by the per-tile bound dw): w8 = round_half_even(q*dsc' - dm'),
// clipped to +-127, exactly as _round_i8. int8.int8 -> int32 products run on
// __dp4a and are exact; the epilogue applies
//   acc += ((float)p * ex[m,t]) * dw[n,t]     (lo tile, then hi tile)
// in the reference's order.
// Bound on the H100: operations (2*M*N*K int8 ops) at prefill sizes; this
// first version uses dp4a on the CUDA cores, not the int8 tensor cores, so
// it sits well above that bound (mma.sync / wgmma are a later step).
// Design: a block owns a 64 (M) x 64 (N) output tile and walks K one
// superblock at a time. The TPU kernel expands each weight tile once per N
// tile and reuses it across M through its sequential grid; GPU blocks run
// in no order, so here the expansion lives in each block's shared memory.
// The weights stay packed in device memory (4.5 bits per weight).

#define K3_BM 64
#define K3_BN 64
#define K3_THREADS 256
#define K3_WORDS 32      // 128 int8 per tile = 32 words
#define K3_PAD 33        // padded row stride in words: no bank conflicts

__device__ __forceinline__ int round_i8(float v) {
    int r = __float2int_rn(v);           // round half to even, like jnp.round
    return min(127, max(-127, r));
}

__global__ void __launch_bounds__(K3_THREADS)
qmm_q4k_i8_kernel(const int8_t* __restrict__ qxlo, const float* __restrict__ exlo,
                  const int8_t* __restrict__ qxhi, const float* __restrict__ exhi,
                  const uint8_t* __restrict__ qs,
                  const float* __restrict__ dsclo, const float* __restrict__ dschi,
                  const float* __restrict__ dmlo, const float* __restrict__ dmhi,
                  const float* __restrict__ dwlo, const float* __restrict__ dwhi,
                  float* __restrict__ y, int M, int N, int K) {
    __shared__ int xs[2][K3_BM][K3_PAD];
    __shared__ int ws[2][K3_BN][K3_PAD];
    const int tid = threadIdx.x;
    const int tx = tid & 15;      // n = tx + 16*j
    const int ty = tid >> 4;      // m = ty + 16*i
    const int m0 = blockIdx.y * K3_BM;
    const int n0 = blockIdx.x * K3_BN;
    const int nb = K / 256;
    const size_t half = (size_t)K / 2;

    float out[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] = 0.f;

    for (int t = 0; t < nb; ++t) {
        __syncthreads();          // the previous tile's reads are done
        for (int i = tid; i < 2 * K3_BM * K3_WORDS; i += K3_THREADS) {
            const int h = i / (K3_BM * K3_WORDS);
            const int rem = i - h * K3_BM * K3_WORDS;
            const int r = rem / K3_WORDS;
            const int w = rem - r * K3_WORDS;
            const int m = m0 + r;
            int val = 0;
            if (m < M) {
                const int8_t* src = (h ? qxhi : qxlo) + (size_t)m * half + (size_t)t * 128;
                val = reinterpret_cast<const int*>(src)[w];
            }
            xs[h][r][w] = val;
        }
        for (int i = tid; i < K3_BN * K3_WORDS; i += K3_THREADS) {
            const int r = i / K3_WORDS;
            const int w = i - r * K3_WORDS;
            const int n = n0 + r;
            uint32_t lo_word = 0, hi_word = 0;
            if (n < N) {
                const uint32_t q4 = reinterpret_cast<const uint32_t*>(
                    qs + (size_t)n * half + (size_t)t * 128)[w];
                const int g = w >> 3;                  // 32 bytes per group
                const size_t si = (size_t)n * nb * 4 + (size_t)t * 4 + g;
                const float sl = dsclo[si], ml = dmlo[si];
                const float sh = dschi[si], mh = dmhi[si];
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const uint32_t byte = (q4 >> (8 * b)) & 0xFFu;
                    const int vl = round_i8(__fsub_rn(__fmul_rn((float)(byte & 0xFu), sl), ml));
                    const int vh = round_i8(__fsub_rn(__fmul_rn((float)(byte >> 4), sh), mh));
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
            for (int w = 0; w < K3_WORDS; ++w) {
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
            const float* dw = h ? dwhi : dwlo;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int m = m0 + ty + 16 * i;
                const float exv = m < M ? ex[(size_t)m * nb + t] : 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = n0 + tx + 16 * j;
                    const float dwv = n < N ? dw[(size_t)n * nb + t] : 0.f;
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

extern "C" int qmm_q4k_i8(const int8_t* qxlo, const float* exlo,
                          const int8_t* qxhi, const float* exhi,
                          const uint8_t* qs,
                          const float* dsclo, const float* dschi,
                          const float* dmlo, const float* dmhi,
                          const float* dwlo, const float* dwhi,
                          float* y, int M, int N, int K, void* stream) {
    dim3 grid((N + K3_BN - 1) / K3_BN, (M + K3_BM - 1) / K3_BM);
    qmm_q4k_i8_kernel<<<grid, K3_THREADS, 0, (cudaStream_t)stream>>>(
        qxlo, exlo, qxhi, exhi, qs, dsclo, dschi, dmlo, dmhi, dwlo, dwhi,
        y, M, N, K);
    return (int)cudaGetLastError();
}
