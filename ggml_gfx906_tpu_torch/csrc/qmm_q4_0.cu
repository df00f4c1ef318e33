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
// The kernel is deterministic: each output element is summed in an order
// fixed by K alone, never by M, by the row's place in its tile, or by the
// launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include "qmm_i8_tiled.cuh"

// ------------------------------------------------------------------ K6-i8
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_0_i8 (_q40_i8_kernel,
// launcher _i8_call): y (M, N) f32 for M >= int8_min_m (prefill), in two
// launches. Each 256-element span t gives two 128-element int8 tiles:
// (lo, t) holds the first 16 elements of each of its 8 blocks, (hi, t)
// their last 16 — the low and the high nibbles of qs bytes [128t, 128t +
// 128), here in qs byte order (the reference's q40_split_x groups the same
// elements).
// 1. `qmm_i8::quant_x` with the map XQ40 (qmm_i8_tiled.cuh, shared with K3
//    and K5-i8): x (M, K) f32 or bf16 -> qxlo, qxhi (M, K/2) int8 and
//    exlo, exhi (M, K/256) f32, the bits of split_x + quantize_x_tiles.
//    Bound by x's bytes.
// 2. The int8 body (qmm_i8_tiled.cuh) with the format Q40I8 below: per
//    (row, span) the fold of the 8 block scales by the span bound, shared
//    by both tiles (_q40_i8_kernel): 8 |d| per block, its amax, dw = amax /
//    127, inv = 127 / amax (0 when amax = 0), d' = d * inv, then w8 =
//    clip(round_half_even((q - 8) * d'), +-127): every step one IEEE
//    operation (__fmul_rn / __fdiv_rn), the bits of tile_fold(d, None, 8,
//    8) + expand_w8. Integer dots on the int8 tensor cores (mma.sync), then
//    out += (acc * ex) * dw per span, lo then hi, as the reference and the
//    earlier dp4a kernel sum: the output keeps their bits at every M and
//    shape.
// Bound on the H100: the weight bytes (0.625 B per weight) at M = 64..128,
// operations (2*M*N*K int8) at larger M; the expansion on the CUDA cores
// (two nibble masks per word, then a byte permute, a subtraction, a product
// and the rounding per weight, once per block row of 128 activation rows)
// sets the pace between them: K3's work without its min term.
// What bounded the earlier design (PERF.md): the operand preparation ran
// as eager torch ops per call, the weights' fold recomputed every call,
// and the dots ran on dp4a with no load in flight.

namespace q40_i8 {

struct Q40I8 {
    static constexpr int TILES = 2;      // lo and hi nibbles of a span
    static constexpr int SPAN = 256;
    struct Ptrs {
        const uint8_t* qs;
        const float* d;
    };
    // 16 bytes of a span are the nibbles of one block. BN = 64 (BPT = 32,
    // two blocks a thread): d[0].x, .y are the thread's blocks' scales, and
    // the span's amax meets in an xor butterfly over the row's 4 lanes (max
    // is exact: any order). BN = 32 (BPT = 16, one block): d holds the
    // span's 8 scales; there a butterfly over 8 lanes took longer than the
    // loads it saves (one block per SM, latency-bound).
    struct Raw {
        uint4 q[2];                      // BPT (16 or 32) packed bytes
        float4 d[2];
    };
    __device__ static void zero(Raw& r) {
        r.q[0] = r.q[1] = make_uint4(0, 0, 0, 0);
        r.d[0] = r.d[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    template <int BPT>
    __device__ static void load(Raw& r, const Ptrs& p, int n, int s, int piece, int K) {
        const uint8_t* q = p.qs + (size_t)n * (K / 2) + (size_t)s * 128 + piece * BPT;
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i) r.q[i] = __ldg(reinterpret_cast<const uint4*>(q) + i);
        const float* d = p.d + (size_t)n * (K / 32) + 8 * (size_t)s;
        if constexpr (BPT == 32) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(d) + piece);
            r.d[0].x = v.x;
            r.d[0].y = v.y;
        } else {
            r.d[0] = __ldg(reinterpret_cast<const float4*>(d));
            r.d[1] = __ldg(reinterpret_cast<const float4*>(d) + 1);
        }
    }
    template <int BPT>
    __device__ static void expand(const Raw& r, int piece, uint4 (&wv)[2][BPT / 16],
                                  float (&dw)[2]) {
        float amax, d[2];
        if constexpr (BPT == 32) {
            d[0] = r.d[0].x;
            d[1] = r.d[0].y;
            amax = fmaxf(__fmul_rn(8.f, fabsf(d[0])), __fmul_rn(8.f, fabsf(d[1])));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        } else {
            const float d8[8] = {r.d[0].x, r.d[0].y, r.d[0].z, r.d[0].w,
                                 r.d[1].x, r.d[1].y, r.d[1].z, r.d[1].w};
            amax = 0.f;
            d[0] = d[1] = 0.f;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                amax = fmaxf(amax, __fmul_rn(8.f, fabsf(d8[b])));
                if (b == piece) d[0] = d8[b];
            }
        }
        dw[0] = dw[1] = __fdiv_rn(amax, 127.f);
        const float inv = amax > 0.f ? __fdiv_rn(127.f, amax) : 0.f;
        // a nibble's float minus 2^23 + 8 is q - 8
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i) {
            const float ds = __fmul_rn(d[i], inv);
            const uint32_t qw[4] = {r.q[i].x, r.q[i].y, r.q[i].z, r.q[i].w};
            uint32_t lo[4], hi[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                lo[k] = qmm_i8::expand4(qw[k] & 0x0F0F0F0Fu, 8388616.f, ds);
                hi[k] = qmm_i8::expand4((qw[k] >> 4) & 0x0F0F0F0Fu, 8388616.f, ds);
            }
            wv[0][i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
            wv[1][i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
    }
};

}  // namespace q40_i8

// K6-i8's x quantization: x (M, K) f32 (x_bf16 = 0) or bf16 (1), 16-byte
// aligned, K % 256 == 0 -> qxlo, qxhi (M, K/2) int8, exlo, exhi (M, K/256)
// f32.
extern "C" int qmm_q4_0_i8_quant_x(const void* x, int x_bf16, int8_t* qxlo, float* exlo,
                                   int8_t* qxhi, float* exhi, int M, int K, void* stream) {
    if (K % 256 != 0) return (int)cudaErrorInvalidValue;
    const qmm_i8::XOut o = {{qxlo, qxhi}, {exlo, exhi}, K / 2, 128, K / 256, 1};
    return qmm_i8::quant_x<qmm_i8::XQ40>(x, x_bf16, o, M, K, (cudaStream_t)stream);
}

// K6-i8's product on quantized x: qxlo/qxhi (M, K/2) int8, exlo/exhi
// (M, K/256) f32, the Q4_0 weights as K6 takes them.
extern "C" int qmm_q4_0_i8(const int8_t* qxlo, const float* exlo, const int8_t* qxhi,
                           const float* exhi, const uint8_t* qs, const float* d, float* y,
                           int M, int N, int K, void* stream) {
    qmm_i8::XOps<2> x = {{qxlo, qxhi}, {exlo, exhi}};
    return qmm_i8::launch<q40_i8::Q40I8>(x, {qs, d}, y, M, N, K, (cudaStream_t)stream);
}
