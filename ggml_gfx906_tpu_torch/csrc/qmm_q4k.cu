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
#include "qmm_i8_tiled.cuh"

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
// launcher _i8_call): y (M, N) f32 for M >= int8_min_m (prefill), in two
// launches.
// 1. `qmm_i8::quant_x` with the map XQ4K (qmm_i8_tiled.cuh, shared with
//    K5-i8 and K6-i8): x (M, K) f32 or bf16 -> qxlo, qxhi (M, K/2) int8
//    and exlo, exhi (M, K/256) f32: per superblock t the lo tile is
//    its 128 elements under the low nibbles (64g + i, g < 4, i < 32) and
//    the hi tile those under the high ones (64g + 32 + i), in qs byte
//    order (32g + i); each tile is quantized by its amax: ex = amax / 127,
//    q = clip(round_half_even(x * (127 / amax)), +-127) (0 when amax = 0),
//    true divisions. The bits of split_x + quantize_x_tiles
//    (ops/cuda/qmm.py), which replaced a dozen eager torch ops per call.
//    One warp per (row, superblock); bound by x's bytes.
// 2. The int8 body (qmm_i8_tiled.cuh) with the format Q4KI8 below, which
//    reads qs, scm and dd as K1 does and folds the scales in the kernel,
//    per (row, superblock) and half (lo: sub-blocks 0, 2, 4, 6; hi: 1, 3,
//    5, 7): dsc = sc * d, dm = m * dmin, the bound max(|15 dsc - dm|, |dm|),
//    its amax over the half's 4 sub-blocks, dw = amax / 127, inv = 127 /
//    amax (0 when amax = 0), dsc' = dsc * inv, dm' = dm * inv, then
//    w8 = clip(round_half_even(q * dsc' - dm'), +-127): every step one IEEE
//    operation (__fmul_rn / __fsub_rn / __fdiv_rn), the bits of scale_arrays
//    + tile_fold + expand_w8. Integer dots on the int8 tensor cores
//    (mma.sync), then out += (acc * ex) * dw per superblock, lo then hi, as
//    the reference and the earlier dp4a kernel sum: the output keeps their
//    bits at every M and shape.
// What bounded the earlier design (PERF.md): the operand preparation ran
// as ~20 eager torch ops per call (as long as the kernel), recomputing the
// weights' fold every call, and the dots ran on dp4a.

namespace q4k_i8 {

struct Q4KI8 {
    static constexpr int TILES = 2;      // lo and hi nibbles of a superblock
    static constexpr int SPAN = 256;
    struct Ptrs {
        const uint8_t* qs;
        const uint8_t* scm;
        const float* dd;
    };
    struct Raw {
        uint4 q[2];                      // BPT (16 or 32) packed bytes
        uint4 sc;                        // sc0..7, m0..7
        float2 d;                        // d, dmin
    };
    __device__ static void zero(Raw& r) {
        r.q[0] = r.q[1] = r.sc = make_uint4(0, 0, 0, 0);
        r.d = make_float2(0.f, 0.f);
    }
    template <int BPT>
    __device__ static void load(Raw& r, const Ptrs& p, int n, int s, int piece, int K) {
        const uint8_t* q = p.qs + (size_t)n * (K / 2) + (size_t)s * 128 + piece * BPT;
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i) r.q[i] = __ldg(reinterpret_cast<const uint4*>(q) + i);
        r.sc = __ldg(reinterpret_cast<const uint4*>(p.scm + (size_t)n * (K / 16) + (size_t)s * 16));
        r.d = __ldg(reinterpret_cast<const float2*>(p.dd + (size_t)n * (K / 128) + 2 * (size_t)s));
    }
    template <int BPT>
    __device__ static void expand(const Raw& r, int piece, uint4 (&wv)[2][BPT / 16],
                                  float (&dw)[2]) {
        const int g = piece * BPT / 32;  // the 32-byte group: sub-blocks 2g (lo), 2g+1 (hi)
        const uint32_t scw[4] = {r.sc.x, r.sc.y, r.sc.z, r.sc.w};
        float amax[2] = {0.f, 0.f}, dsg[2] = {0.f, 0.f}, dmg[2] = {0.f, 0.f};
#pragma unroll
        for (int sb = 0; sb < 8; ++sb) {
            const float dsc = __fmul_rn(qmm_i8::small_float((scw[sb >> 2] >> (8 * (sb & 3))) & 0xFFu),
                                        r.d.x);
            const float dm = __fmul_rn(qmm_i8::small_float((scw[2 + (sb >> 2)] >> (8 * (sb & 3))) & 0xFFu),
                                       r.d.y);
            const float bnd = fmaxf(fabsf(__fsub_rn(__fmul_rn(15.f, dsc), dm)), fabsf(dm));
            amax[sb & 1] = fmaxf(amax[sb & 1], bnd);
            if ((sb >> 1) == g) {
                dsg[sb & 1] = dsc;
                dmg[sb & 1] = dm;
            }
        }
        float ds[2], dmf[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            dw[h] = __fdiv_rn(amax[h], 127.f);
            const float inv = amax[h] > 0.f ? __fdiv_rn(127.f, amax[h]) : 0.f;
            ds[h] = __fmul_rn(dsg[h], inv);
            dmf[h] = __fmul_rn(dmg[h], inv);
        }
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i) {
            const uint32_t qw[4] = {r.q[i].x, r.q[i].y, r.q[i].z, r.q[i].w};
            uint32_t lo[4], hi[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                lo[k] = hi[k] = 0;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                    const uint32_t byte = (qw[k] >> (8 * b)) & 0xFFu;
                    const float vl = __fsub_rn(__fmul_rn(qmm_i8::small_float(byte & 0xFu), ds[0]), dmf[0]);
                    const float vh = __fsub_rn(__fmul_rn(qmm_i8::small_float(byte >> 4), ds[1]), dmf[1]);
                    lo[k] |= qmm_i8::round_i8_byte(vl) << (8 * b);
                    hi[k] |= qmm_i8::round_i8_byte(vh) << (8 * b);
                }
            }
            wv[0][i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
            wv[1][i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
    }
};

}  // namespace q4k_i8

// K3's x quantization: x (M, K) f32 (x_bf16 = 0) or bf16 (1), 16-byte aligned,
// K % 256 == 0.
extern "C" int qmm_q4k_i8_quant_x(const void* x, int x_bf16, int8_t* qxlo, float* exlo,
                                  int8_t* qxhi, float* exhi, int M, int K, void* stream) {
    if (K % 256 != 0) return (int)cudaErrorInvalidValue;
    const qmm_i8::XOut o = {{qxlo, qxhi}, {exlo, exhi}, K / 2, 128, K / 256, 1};
    return qmm_i8::quant_x<qmm_i8::XQ4K>(x, x_bf16, o, M, K, (cudaStream_t)stream);
}

// K3's product on quantized x: qxlo/qxhi (M, K/2) int8, exlo/exhi (M, K/256)
// f32, the Q4_K weights as K1 takes them.
extern "C" int qmm_q4k_i8(const int8_t* qxlo, const float* exlo, const int8_t* qxhi,
                          const float* exhi, const uint8_t* qs, const uint8_t* scm,
                          const float* dd, float* y, int M, int N, int K, void* stream) {
    qmm_i8::XOps<2> x = {{qxlo, qxhi}, {exlo, exhi}};
    return qmm_i8::launch<q4k_i8::Q4KI8>(x, {qs, scm, dd}, y, M, N, K, (cudaStream_t)stream);
}
