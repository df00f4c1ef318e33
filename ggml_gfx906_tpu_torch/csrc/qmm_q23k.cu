// Q2_K and Q3_K fused dequant + matmul kernel for Hopper (sm_90a).
//
// Weight layouts (ggml wire order, struct of arrays, per row n of N, per
// 256-element superblock sb of nb = K/256; h = 128-element half, t = 2-bit
// plane, l = 0..31):
//   qs     (N, nb*64) u8 : byte 32*h + l holds element 128*h + 32*t + l at
//                          bits 2t..2t+1 (both types)
//   scales (N, nb*16) u8 : Q2_K: byte e/16 is element e's scale (low nibble)
//                          and min (high nibble)
//   hmask  (N, nb*32) u8 : Q3_K: bit 4*h + t of byte l is element
//                          128*h + 32*t + l's high bit
//   sc     (N, nb*16) i8 : Q3_K: element e's signed 6-bit scale (-32..31)
//   d, dmin (N, nb)   f32: Q2_K d and dmin; Q3_K d
// Q2_K: w = q*(d*(sc & 15)) - dmin*(sc >> 4). d*sc and dmin*m (an f16 times
// 4 bits) and q*(d*sc) (2 bits more) are exact in f32, so w rounds once, at
// the difference. Q3_K: w = (q | hbit << 2) - 4, times d*sc; d*sc (f16 times
// 6 bits) and the product (3 bits more) are exact. The weights formed in
// registers equal the plain dequantization bit for bit.
//
// The kernel is deterministic: each output element is summed by one warp in
// an order fixed by K alone, never by M, by the row's place in its tile, or
// by the launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ K9
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q2_K (_q2k_kernel) and
// ::qmm_q3_K (_q3k_kernel): y (M, N) f32 = x (M, K) f32 . W^T at every M
// (neither type has an int8 twin, so prefill chunks take it too).
// Bound on the H100: bytes at decode. The weight stream is 0.34 B per weight
// for Q2_K (0.25 qs + 1/16 scales + 1/32 d and dmin) and 0.45 B for Q3_K
// (0.25 qs + 1/8 hmask + 1/16 sc + 1/64 d), read once; the FMAs are 2*M
// flops per weight, so from M of about 4 on the f32 rate (67 TFLOP/s)
// bounds them instead.
// Design: K8's (csrc/qmm_legacy.cu). One warp owns K9_ROWS weight rows and
// walks K in 64-element chunks, K9_SPANS at a time: a chunk is 16
// consecutive qs bytes of one 128-element half, i.e. four planes of 16
// consecutive elements, each plane under one scale byte. For Q3_K the lane
// also loads the 16 hmask bytes that hold those elements' high bits (the
// lanes of the two halves load the same bytes; they are not stored twice).
// Each lane loads its chunks' fields first, then forms the f32 weights of
// one plane at a time in registers and FMAs them against up to K9_MT
// activation rows; lanes then reduce with a fixed xor-shuffle butterfly.
// FP32 FMA on the CUDA cores, never TF32: the reference dot is HIGHEST
// precision. The 2-bit quants become floats by the exponent trick (an OR
// and a subtraction, exact) rather than by integer conversions, which run
// at a quarter of the FMA rate. The reference's two-superblock chunks, its
// pad to an even superblock count, its per-half hmask copies and its lane
// interleave (qmm.py:1040-1133) serve 128-lane tiles; the port has none of
// them: a K of 11008 (43 superblocks) ends in a partial group of chunks
// that the chunk bound masks.

#define K9_WARPS 4
#define K9_ROWS 2
#define K9_MT 8
#define K9_SPANS 2       // chunks whose fields are loaded at once

// v + 2^23 as a float, minus `bias` + 2^23: exact for 0 <= v < 2^23 and a
// small integer bias.
__device__ __forceinline__ float small_int(uint32_t v, float bias_plus_2p23) {
    return __fsub_rn(__uint_as_float(0x4B000000u | v), bias_plus_2p23);
}

template <bool Q3>
__global__ void __launch_bounds__(K9_WARPS * 32)
qmm_q23k_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                    const uint8_t* __restrict__ hmask, const uint8_t* __restrict__ scales,
                    const float* __restrict__ d, const float* __restrict__ dmin,
                    float* __restrict__ y, int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K9_WARPS + warp) * K9_ROWS;
    const int m0 = blockIdx.y * K9_MT;
    const int chunks = K / 64;          // 16-byte qs chunks per row
    const int nb = K / 256;

    float acc[K9_ROWS][K9_MT];
#pragma unroll
    for (int r = 0; r < K9_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K9_MT; ++m) acc[r][m] = 0.f;

    for (int c0 = lane; c0 < chunks; c0 += 32 * K9_SPANS) {
        // all weight loads of this group of chunks first, then the arithmetic
        uint4 q16[K9_ROWS][K9_SPANS], h16[K9_ROWS][K9_SPANS];
        uint2 s8[K9_ROWS][K9_SPANS];    // the half's 8 scale bytes
        float dv[K9_ROWS][K9_SPANS], mv[K9_ROWS][K9_SPANS];
#pragma unroll
        for (int j = 0; j < K9_SPANS; ++j) {
            const int c = c0 + 32 * j;
            const int sb = c >> 2, h = (c >> 1) & 1, l0 = (c & 1) * 16;
#pragma unroll
            for (int r = 0; r < K9_ROWS; ++r) {
                const int n = n0 + r;
                const bool ok = n < N && c < chunks;
                const size_t blk = (size_t)n * nb + sb;
                q16[r][j] = ok ? *reinterpret_cast<const uint4*>(qs + blk * 64 + h * 32 + l0)
                               : make_uint4(0u, 0u, 0u, 0u);
                h16[r][j] = Q3 && ok ? *reinterpret_cast<const uint4*>(hmask + blk * 32 + l0)
                                     : make_uint4(0u, 0u, 0u, 0u);
                s8[r][j] = ok ? *reinterpret_cast<const uint2*>(scales + blk * 16 + h * 8)
                              : make_uint2(0u, 0u);
                dv[r][j] = ok ? d[blk] : 0.f;
                mv[r][j] = !Q3 && ok ? dmin[blk] : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < K9_SPANS; ++j) {
            const int c = c0 + 32 * j;
            if (c >= chunks) continue;
            const int sb = c >> 2, h = (c >> 1) & 1, l0 = (c & 1) * 16;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int e0 = sb * 256 + h * 128 + t * 32 + l0;
                const int sbyte = 2 * t + (l0 >> 4);     // byte of s8: scale 8h + 2t + s
                float w[K9_ROWS][16];
#pragma unroll
                for (int r = 0; r < K9_ROWS; ++r) {
                    const uint32_t sw = sbyte < 4 ? s8[r][j].x : s8[r][j].y;
                    const uint32_t sv = (sw >> (8 * (sbyte & 3))) & 0xFFu;
                    const uint32_t qw[4] = {q16[r][j].x, q16[r][j].y, q16[r][j].z, q16[r][j].w};
                    const uint32_t hw[4] = {h16[r][j].x, h16[r][j].y, h16[r][j].z, h16[r][j].w};
                    if (Q3) {
                        const float dsc = __fmul_rn(dv[r][j], (float)(int8_t)sv);
#pragma unroll
                        for (int i = 0; i < 16; ++i) {
                            const uint32_t sh = 8 * (i & 3);
                            const uint32_t q = (qw[i >> 2] >> (sh + 2 * t)) & 3u;
                            const uint32_t hb = (hw[i >> 2] >> (sh + 4 * h + t)) & 1u;
                            w[r][i] = __fmul_rn(small_int(q | (hb << 2), 8388612.f), dsc);
                        }
                    } else {
                        const float dsc = __fmul_rn(dv[r][j], (float)(sv & 0xFu));
                        const float dm = __fmul_rn(mv[r][j], (float)(sv >> 4));
#pragma unroll
                        for (int i = 0; i < 16; ++i) {
                            const uint32_t q = (qw[i >> 2] >> (8 * (i & 3) + 2 * t)) & 3u;
                            w[r][i] = __fsub_rn(__fmul_rn(small_int(q, 8388608.f), dsc), dm);
                        }
                    }
                }
#pragma unroll
                for (int m = 0; m < K9_MT; ++m) {
                    if (m0 + m < M) {
                        const float* xr = x + (size_t)(m0 + m) * K + e0;
#pragma unroll
                        for (int v = 0; v < 4; ++v) {
                            const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * v);
#pragma unroll
                            for (int r = 0; r < K9_ROWS; ++r) {
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
    for (int r = 0; r < K9_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K9_MT; ++m) {
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

template <bool Q3>
static int launch(const float* x, const uint8_t* qs, const uint8_t* hmask,
                  const uint8_t* scales, const float* d, const float* dmin, float* y,
                  int M, int N, int K, void* stream) {
    dim3 grid((N + K9_WARPS * K9_ROWS - 1) / (K9_WARPS * K9_ROWS),
              (M + K9_MT - 1) / K9_MT);
    qmm_q23k_f32_kernel<Q3><<<grid, K9_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, qs, hmask, scales, d, dmin, y, M, N, K);
    return (int)cudaGetLastError();
}

extern "C" int qmm_q2k_f32(const float* x, const uint8_t* qs, const uint8_t* scales,
                           const float* d, const float* dmin, float* y, int M, int N, int K,
                           void* stream) {
    return launch<false>(x, qs, nullptr, scales, d, dmin, y, M, N, K, stream);
}

extern "C" int qmm_q3k_f32(const float* x, const uint8_t* qs, const uint8_t* hmask,
                           const int8_t* sc, const float* d, float* y, int M, int N, int K,
                           void* stream) {
    return launch<true>(x, qs, hmask, reinterpret_cast<const uint8_t*>(sc), d, nullptr, y,
                        M, N, K, stream);
}
