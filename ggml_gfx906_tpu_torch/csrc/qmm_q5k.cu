// Q5_K fused dequant + matmul kernel for Hopper (sm_90a).
//
// Q5_K weight layout (ggml wire order, struct of arrays, per row n of N,
// per 256-element superblock sb of nb = K/256; g = 64-element group,
// l = 0..31):
//   qs  (N, nb*128) u8 : byte 32*g + l holds element 64*g + l in its low
//                        nibble (sub-block 2g) and element 64*g + 32 + l in
//                        its high nibble (sub-block 2g+1)
//   qh  (N, nb*32)  u8 : byte l holds those elements' fifth bits, at bits
//                        2g (low nibble's) and 2g+1 (high nibble's)
//   scm (N, nb*16)  u8 : unpacked 6-bit [sc0..sc7 | m0..m7]
//   dd  (N, nb*2)   f32: [d, dmin]
// w = q * (d*sc) - (dmin*m), q = nibble | fifth bit << 4. d and dmin are
// f16 values (11-bit significands), sc and m 6-bit and q 5-bit integers,
// so d*sc, q*(d*sc) and dmin*m are exact in f32 and w rounds once, at the
// difference: the weights formed in registers equal the plain
// dequantization bit for bit.
//
// Deterministic: each output element is summed by one warp in an order
// fixed by K alone, never by M, by the row's place in its tile, or by the
// launch shape. No atomics, no split-K.
//
// Returns the cudaError_t of the launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ K7
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q5_K (_q5k_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T at every M (Q5_K has no int8 twin, so
// this kernel also runs the prefill rows).
// Bound on the H100: bytes at decode. The packed weight stream is 0.72 B
// per weight (0.5 qs + 0.125 qh + 1/16 scm + 1/32 dd) and is read once; the
// FMAs are 2*M flops per weight, below the 67 TFLOP/s f32 rate at small M.
// Design: K4's (csrc/qmm_q6k.cu), itself K1's. One warp owns K7_ROWS
// weight rows; each lane reads 16 qs bytes and the 16 qh bytes that hold
// their fifth bits (one 16-byte load each) per step, forms 32 f32 weights
// in registers and FMAs them against up to K7_MT activation rows; lanes
// then reduce with a fixed xor-shuffle butterfly. The TPU kernel's
// four-superblock chunks and their padding have no counterpart here: a
// step never crosses a superblock. FP32 FMA on the CUDA cores, never TF32:
// the reference dot is HIGHEST precision. Each further 8-row M tile reads
// the weights again (from L2 when they fit), so the time grows with M.

#define K7_WARPS 4
#define K7_ROWS 2
#define K7_MT 8

__global__ void __launch_bounds__(K7_WARPS * 32)
qmm_q5k_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                   const uint8_t* __restrict__ qh, const uint8_t* __restrict__ scm,
                   const float* __restrict__ dd, float* __restrict__ y,
                   int M, int N, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * K7_WARPS + warp) * K7_ROWS;
    const int m0 = blockIdx.y * K7_MT;
    const int nb = K / 256;
    const int chunks = K / 32;          // 16-byte chunks of qs per row

    float acc[K7_ROWS][K7_MT];
#pragma unroll
    for (int r = 0; r < K7_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < K7_MT; ++m) acc[r][m] = 0.f;

    for (int c = lane; c < chunks; c += 32) {
        const int sb = c >> 3;
        const int o = (c & 7) * 16;     // qs byte offset inside the superblock
        const int g = o >> 5;           // 64-element group
        const int l0 = o & 31;
        const int e_lo = sb * 256 + g * 64 + l0;
        const int e_hi = e_lo + 32;
        const int s_lo = 2 * g;         // fifth-bit positions in the qh bytes
        const int s_hi = 2 * g + 1;

        float wlo[K7_ROWS][16], whi[K7_ROWS][16];
#pragma unroll
        for (int r = 0; r < K7_ROWS; ++r) {
            const int n = n0 + r;
            if (n < N) {
                const uint4 q4 = *reinterpret_cast<const uint4*>(
                    qs + (size_t)n * (K / 2) + (size_t)c * 16);
                const uint4 h4 = *reinterpret_cast<const uint4*>(
                    qh + (size_t)n * (K / 8) + (size_t)sb * 32 + l0);
                const uint8_t* s = scm + (size_t)n * nb * 16 + sb * 16;
                const float d = dd[(size_t)n * nb * 2 + sb * 2];
                const float dmin = dd[(size_t)n * nb * 2 + sb * 2 + 1];
                const float dsl = __fmul_rn((float)s[2 * g], d);
                const float dsh = __fmul_rn((float)s[2 * g + 1], d);
                const float dml = __fmul_rn((float)s[8 + 2 * g], dmin);
                const float dmh = __fmul_rn((float)s[8 + 2 * g + 1], dmin);
                const uint32_t qw[4] = {q4.x, q4.y, q4.z, q4.w};
                const uint32_t hw[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    const uint32_t b = (qw[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                    const uint32_t hb = (hw[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                    const uint32_t vlo = (b & 0xFu) | (((hb >> s_lo) & 1u) << 4);
                    const uint32_t vhi = (b >> 4) | (((hb >> s_hi) & 1u) << 4);
                    wlo[r][i] = __fsub_rn(__fmul_rn((float)vlo, dsl), dml);
                    whi[r][i] = __fsub_rn(__fmul_rn((float)vhi, dsh), dmh);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 16; ++i) { wlo[r][i] = 0.f; whi[r][i] = 0.f; }
            }
        }
#pragma unroll
        for (int m = 0; m < K7_MT; ++m) {
            if (m0 + m < M) {
                const float* xr = x + (size_t)(m0 + m) * K;
#pragma unroll
                for (int v = 0; v < 4; ++v) {
                    const float4 xl = *reinterpret_cast<const float4*>(xr + e_lo + 4 * v);
#pragma unroll
                    for (int r = 0; r < K7_ROWS; ++r) {
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
                    for (int r = 0; r < K7_ROWS; ++r) {
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
    for (int r = 0; r < K7_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < K7_MT; ++m) {
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

extern "C" int qmm_q5k_f32(const float* x, const uint8_t* qs, const uint8_t* qh,
                           const uint8_t* scm, const float* dd, float* y,
                           int M, int N, int K, void* stream) {
    dim3 grid((N + K7_WARPS * K7_ROWS - 1) / (K7_WARPS * K7_ROWS),
              (M + K7_MT - 1) / K7_MT);
    qmm_q5k_f32_kernel<<<grid, K7_WARPS * 32, 0, (cudaStream_t)stream>>>(
        x, qs, qh, scm, dd, y, M, N, K);
    return (int)cudaGetLastError();
}
