// Q4_1, Q5_0 and Q5_1 fused dequant + matmul kernel for Hopper (sm_90a).
//
// Weight layouts (ggml wire order, struct of arrays, per row n of N, per
// 32-element block b of K/32):
//   qs (N, K/2)  u8 : byte 16*b + j holds element 32*b + j in its low nibble
//                     and element 32*b + 16 + j in its high nibble
//   qh (N, K/8)  u8 : Q5_0 and Q5_1: bytes 4*b .. 4*b + 3 are the block's
//                     little-endian 32-bit word, whose bit j is the fifth bit
//                     of element 32*b + j
//   d  (N, K/32) f32: one scale per block
//   m  (N, K/32) f32: Q4_1 and Q5_1: one min per block
// Q4_1: w = q*d + m with q the nibble; Q5_0: w = (q - 16)*d and Q5_1:
// w = q*d + m with q = nibble | fifth bit << 4.
// q has at most 5 bits and d is an f16 widened to f32, so q*d (at most 16
// significant bits) is exact in f32: q*d + m rounds once, contracted into an
// FMA or not, and (q - 16)*d does not round. The weights formed in registers
// equal the plain dequantization bit for bit.
//
// The kernel is deterministic: each output element is summed by one warp in
// an order fixed by K alone, never by M, by the row's place in its tile, or
// by the launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ K8
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_1 (_q41_kernel),
// ::qmm_q5_0 (_q50_kernel) and ::qmm_q5_1 (_q51_kernel), both through
// _q5l_body: y (M, N) f32 = x (M, K) f32 . W^T at every M (none of the three
// has an int8 twin, so prefill chunks take it too).
// Bound on the H100: bytes at decode. The weight stream is 0.75 B per weight
// for Q4_1 (0.5 qs + 1/8 d + 1/8 m) and Q5_0 (0.5 qs + 1/8 qh + 1/8 d),
// 0.875 B for Q5_1, read once; the FMAs are 2*M flops per weight, so from
// M = 8 on the f32 rate (67 TFLOP/s) bounds Q4_1 and Q5_0 instead.
// Design: K6's (csrc/qmm_q4_0.cu), one template over the two optional
// fields. One warp owns K8_ROWS weight rows and walks K in 512-element
// spans, K8_SPANS at a time; lane l owns half a block (8 qs bytes: 8
// low-nibble and 8 high-nibble elements) of every span, so two lanes share
// each 128-byte x line. The fifth bits of a lane's elements 32b + 8h + i and
// 32b + 16 + 8h + i are bits 8h + i and 16 + 8h + i of the block's qh word,
// i.e. qh bytes h and 2 + h: each lane loads the word itself, no exchange
// between lanes. Each lane forms its f32 weights in registers and FMAs them
// against up to K8_MT activation rows; lanes then reduce with a fixed
// xor-shuffle butterfly. FP32 FMA on the CUDA cores, never TF32: the
// reference dot is HIGHEST precision. The reference's lane interleaves and
// its 32-block chunk padding (qmm.py:901-1004) are Mosaic layouts the port
// does not keep: a K of 11008 (344 blocks) ends in a partial group of spans
// that the chunk bound masks.

#define K8_WARPS 4
#define K8_ROWS 2
#define K8_MT 8
#define K8_SPANS 4       // 512-element spans whose weights are loaded at once

template <bool HAS_QH, bool HAS_MIN>
__global__ void __launch_bounds__(K8_WARPS * 32)
qmm_legacy_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                      const uint8_t* __restrict__ qh, const float* __restrict__ d,
                      const float* __restrict__ mn, float* __restrict__ y,
                      int M, int N, int K) {
    static_assert(HAS_QH || HAS_MIN, "Q4_0 is K6 (csrc/qmm_q4_0.cu)");
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K8_WARPS + warp) * K8_ROWS;
    const int m0 = blockIdx.y * K8_MT;
    const int chunks = K / 16;          // half blocks (8 qs bytes) per row
    const int nblk = K / 32;
    const size_t row_qs = (size_t)K / 2;

    float acc[K8_ROWS][K8_MT];
#pragma unroll
    for (int r = 0; r < K8_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K8_MT; ++m) acc[r][m] = 0.f;

    for (int c0 = lane; c0 < chunks; c0 += 32 * K8_SPANS) {
        // all weight loads of this group of spans first, then the arithmetic
        uint2 q8[K8_ROWS][K8_SPANS];
        uint32_t hb[K8_ROWS][K8_SPANS];  // bits 0-7: low-nibble elements' fifth
                                         // bits, 8-15: the high nibbles'
        float dv[K8_ROWS][K8_SPANS], mv[K8_ROWS][K8_SPANS];
#pragma unroll
        for (int j = 0; j < K8_SPANS; ++j) {
            const int c = c0 + 32 * j;
#pragma unroll
            for (int r = 0; r < K8_ROWS; ++r) {
                const int n = n0 + r;
                const bool ok = n < N && c < chunks;
                const size_t blk = (size_t)n * nblk + (c >> 1);
                q8[r][j] = ok ? *reinterpret_cast<const uint2*>(qs + (size_t)n * row_qs + (size_t)c * 8)
                              : make_uint2(0u, 0u);
                dv[r][j] = ok ? d[blk] : 0.f;
                mv[r][j] = HAS_MIN && ok ? mn[blk] : 0.f;
                if (HAS_QH) {
                    const uint32_t w = ok ? reinterpret_cast<const uint32_t*>(qh)[blk] : 0u;
                    const int sh = 8 * (c & 1);
                    hb[r][j] = ((w >> sh) & 0xFFu) | (((w >> (16 + sh)) & 0xFFu) << 8);
                } else {
                    hb[r][j] = 0u;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < K8_SPANS; ++j) {
            const int c = c0 + 32 * j;
            if (c < chunks) {
                const int e_lo = (c >> 1) * 32 + (c & 1) * 8;   // low nibbles
                const int e_hi = e_lo + 16;                      // high nibbles
                float wlo[K8_ROWS][8], whi[K8_ROWS][8];
#pragma unroll
                for (int r = 0; r < K8_ROWS; ++r) {
                    const uint32_t words[2] = {q8[r][j].x, q8[r][j].y};
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const uint32_t b = (words[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                        uint32_t ql = b & 0xFu, qu = b >> 4;
                        if (HAS_QH) {
                            ql |= ((hb[r][j] >> i) & 1u) << 4;
                            qu |= ((hb[r][j] >> (8 + i)) & 1u) << 4;
                        }
                        if (HAS_MIN) {
                            wlo[r][i] = __fmaf_rn((float)ql, dv[r][j], mv[r][j]);
                            whi[r][i] = __fmaf_rn((float)qu, dv[r][j], mv[r][j]);
                        } else {
                            wlo[r][i] = __fmul_rn((float)((int)ql - 16), dv[r][j]);
                            whi[r][i] = __fmul_rn((float)((int)qu - 16), dv[r][j]);
                        }
                    }
                }
#pragma unroll
                for (int m = 0; m < K8_MT; ++m) {
                    if (m0 + m < M) {
                        const float* xr = x + (size_t)(m0 + m) * K;
#pragma unroll
                        for (int v = 0; v < 2; ++v) {
                            const float4 xl = *reinterpret_cast<const float4*>(xr + e_lo + 4 * v);
#pragma unroll
                            for (int r = 0; r < K8_ROWS; ++r) {
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
                            for (int r = 0; r < K8_ROWS; ++r) {
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
    for (int r = 0; r < K8_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K8_MT; ++m) {
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

template <bool HAS_QH, bool HAS_MIN>
static int launch(const float* x, const uint8_t* qs, const uint8_t* qh,
                  const float* d, const float* m, float* y, int M, int N, int K,
                  void* stream) {
    dim3 grid((N + K8_WARPS * K8_ROWS - 1) / (K8_WARPS * K8_ROWS),
              (M + K8_MT - 1) / K8_MT);
    qmm_legacy_f32_kernel<HAS_QH, HAS_MIN><<<grid, K8_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, qs, qh, d, m, y, M, N, K);
    return (int)cudaGetLastError();
}

extern "C" int qmm_q4_1_f32(const float* x, const uint8_t* qs, const float* d,
                            const float* m, float* y, int M, int N, int K, void* stream) {
    return launch<false, true>(x, qs, nullptr, d, m, y, M, N, K, stream);
}

extern "C" int qmm_q5_0_f32(const float* x, const uint8_t* qs, const uint8_t* qh,
                            const float* d, float* y, int M, int N, int K, void* stream) {
    return launch<true, false>(x, qs, qh, d, nullptr, y, M, N, K, stream);
}

extern "C" int qmm_q5_1_f32(const float* x, const uint8_t* qs, const uint8_t* qh,
                            const float* d, const float* m, float* y, int M, int N, int K,
                            void* stream) {
    return launch<true, true>(x, qs, qh, d, m, y, M, N, K, stream);
}
