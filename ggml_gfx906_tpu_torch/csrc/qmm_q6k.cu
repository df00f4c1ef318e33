// Q6_K fused dequant + matmul kernel for Hopper (sm_90a).
//
// Q6_K weight layout (ggml wire order, struct of arrays, per row n of N,
// per 256-element superblock sb of nb = K/256; h = 128-element half,
// k = 0/1, l = 0..31):
//   ql (N, nb*128) u8 : byte h*64 + 32*k + l holds element h*128 + 32*k + l
//                       in its low nibble and element h*128 + 64 + 32*k + l
//                       in its high nibble
//   qh (N, nb*64)  u8 : byte h*32 + l holds those elements' two high bits:
//                       bits 2k..2k+1 for the low nibble's element,
//                       bits 4+2k..5+2k for the high nibble's
//   sc (N, nb*16)  i8 : one scale per 16 elements, in element order
//   d  (N, nb)     f32
// w = (q - 32) * (d*sc). d is an f16 value (11-bit significand) and sc an
// int8, so d*sc is exact in f32 and w rounds once: the weights formed in
// registers equal the plain dequantization bit for bit.
//
// Deterministic: each output element is summed by one warp in an order
// fixed by K alone, never by M, by the row's place in its tile, or by the
// launch shape. No atomics, no split-K.
//
// Returns the cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ K4
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q6_K (_q6k_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T at every M (Q6_K has no int8 twin, so
// this kernel also runs the prefill rows, the head's among them).
// Bound on the H100: bytes at decode. The packed weight stream is 0.83 B
// per weight (0.5 ql + 0.25 qh + 1/16 sc + 1/64 d) and is read once; the
// FMAs are 2*M flops per weight, below the 67 TFLOP/s f32 rate at small M.
// Design: K1's (csrc/qmm_q4k.cu). One warp owns K4_ROWS weight rows; each
// lane reads 16 ql bytes and the 16 qh bytes that hold their high bits
// (one 16-byte load each) per step, forms 32 f32 weights in registers and
// FMAs them against up to K4_MT activation rows; lanes then reduce with a
// fixed xor-shuffle butterfly. The TPU kernel's two-superblock chunks and
// their padding have no counterpart here: a step never crosses a
// superblock. FP32 FMA on the CUDA cores, never TF32: the reference dot
// is HIGHEST precision. Each further 8-row M tile reads the weights again
// (from L2 when they fit), so the time grows with M.

#define K4_WARPS 4
#define K4_ROWS 2
#define K4_MT 8

__global__ void __launch_bounds__(K4_WARPS * 32)
qmm_q6k_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ ql,
                   const uint8_t* __restrict__ qh, const int8_t* __restrict__ sc,
                   const float* __restrict__ d, float* __restrict__ y,
                   int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K4_WARPS + warp) * K4_ROWS;
    const int m0 = blockIdx.y * K4_MT;
    const int nb = K / 256;
    const int chunks = K / 32;          // 16-byte chunks of ql per row

    float acc[K4_ROWS][K4_MT];
#pragma unroll
    for (int r = 0; r < K4_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K4_MT; ++m) acc[r][m] = 0.f;

    for (int c = lane; c < chunks; c += 32) {
        const int sb = c >> 3;
        const int o = (c & 7) * 16;     // ql byte offset inside the superblock
        const int h = o >> 6;
        const int k = (o >> 5) & 1;
        const int l0 = o & 31;
        const int e_lo = sb * 256 + h * 128 + k * 32 + l0;
        const int e_hi = e_lo + 64;
        const int s_lo = 2 * k;
        const int s_hi = 4 + 2 * k;

        float wlo[K4_ROWS][16], whi[K4_ROWS][16];
#pragma unroll
        for (int r = 0; r < K4_ROWS; ++r) {
            const int n = n0 + r;
            if (n < N) {
                const uint4 q4 = *reinterpret_cast<const uint4*>(
                    ql + (size_t)n * (K / 2) + (size_t)c * 16);
                const uint4 h4 = *reinterpret_cast<const uint4*>(
                    qh + (size_t)n * (K / 4) + (size_t)sb * 64 + h * 32 + l0);
                const float dv = d[(size_t)n * nb + sb];
                const int8_t* s = sc + (size_t)n * (K / 16);
                const float dsl = __fmul_rn(dv, (float)s[e_lo >> 4]);
                const float dsh = __fmul_rn(dv, (float)s[e_hi >> 4]);
                const uint32_t qw[4] = {q4.x, q4.y, q4.z, q4.w};
                const uint32_t hw[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    const uint32_t b = (qw[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                    const uint32_t hb = (hw[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                    const int vlo = (int)((b & 0xFu) | (((hb >> s_lo) & 3u) << 4)) - 32;
                    const int vhi = (int)((b >> 4) | (((hb >> s_hi) & 3u) << 4)) - 32;
                    wlo[r][i] = __fmul_rn((float)vlo, dsl);
                    whi[r][i] = __fmul_rn((float)vhi, dsh);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 16; ++i) { wlo[r][i] = 0.f; whi[r][i] = 0.f; }
            }
        }
#pragma unroll
        for (int m = 0; m < K4_MT; ++m) {
            if (m0 + m < M) {
                const float* xr = x + (size_t)(m0 + m) * K;
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    const float4 xl = *reinterpret_cast<const float4*>(xr + e_lo + 4 * v);
#pragma unroll
                    for (int r = 0; r < K4_ROWS; ++r) {
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
                    for (int r = 0; r < K4_ROWS; ++r) {
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
    for (int r = 0; r < K4_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K4_MT; ++m) {
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

extern "C" int qmm_q6k_f32(const float* x, const uint8_t* ql, const uint8_t* qh,
                           const int8_t* sc, const float* d, float* y,
                           int M, int N, int K, void* stream) {
    dim3 grid((N + K4_WARPS * K4_ROWS - 1) / (K4_WARPS * K4_ROWS),
              (M + K4_MT - 1) / K4_MT);
    qmm_q6k_f32_kernel<<<grid, K4_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, ql, qh, sc, d, y, M, N, K);
    return (int)cudaGetLastError();
}
