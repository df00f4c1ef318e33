// Q8_0 fused dequant + matmul kernels for Hopper (sm_90a).
//
// Q8_0 weight layout (ggml wire order, struct of arrays, per row n of N):
//   qs (N, K)    i8 : the quants, in element order
//   d  (N, K/32) f32: one scale per 32-element block
// w = q * d, exact in f32: an 8-bit quant times an f16-born d (11-bit
// significand) has at most 19 significant bits.
//
// Both kernels are deterministic: each output element is summed in an order
// fixed by K alone, never by M, by the row's place in its tile, or by the
// launch shape. No atomics, no split-K.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include "qmm_f32_tiled.cuh"
#include "qmm_i8_tiled.cuh"

// ------------------------------------------------------------------ K5
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q8_0 (_q8_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T, for M < int8_min_m (decode, short
// prefill chunks).
// The body is qmm_f32_tiled.cuh's, shared with K1, K4, K6, K7, K8 and K9,
// with the format Q80 below; launch() picks its kernel by M (fuller notes
// there):
// - M <= 8 (decode, M = 1 included), `small_kernel`. Bound: the weight
//   bytes, 1.125 B per weight (1 qs + 1/8 d), read once: 0.0152 ms for
//   11008 x 4096 on the H100; then loads issued and their latency.
// - M > 8 (the engine's chunks, prefill tails), `tiled_kernel` or
//   `tree_kernel`. Bound: the f32 FMA rate (2*M*N*K flops at 67 TFLOP/s),
//   then shared memory and the L2 traffic of x. Each weight is read and
//   dequantized once per block row of activations.
// A block is one body chunk: chunk c = block c, its lo run the block's
// quants 0..15 (the chunk's 16 "packed" bytes, qptr) and its hi run quants
// 16..31 (its 16 "high-bit" bytes, hptr: HBYTES = 16, so every kernel of
// the body hands dequant4 the word of the hi run beside that of the lo
// run). dequant4 takes the word of its run and turns each signed byte into
// a float without an I2F: the xor with 0x80 makes it q + 128, and
// byte_minus takes 2^23 + 128 off the float 2^23 + q + 128.
// Reduction order: the body's, 32 slots over the blocks (block c in slot c
// mod 32, ascending, its 16 low then 16 high elements), then the
// xor-butterfly tree; fixed by K alone, so a row's bits do not depend on M
// or on the kernel and the engine's streams equal `generate`'s. The earlier
// K5 (lanes over half blocks of 512-element spans) summed in another
// order, so its results differ from these in the last bits. FP32 FMA on
// the CUDA cores, never TF32: the reference dot is HIGHEST precision.

namespace qmm_tiled {

struct Q80 {
    struct Ptrs {
        const int8_t* qs;
        const float* d;
    };
    struct Sraw {
        float d;
    };
    static constexpr int HBYTES = 16;
    static __device__ __forceinline__ int run(int c, int half) { return 32 * c + 16 * half; }
    static __device__ __forceinline__ const uint8_t* qptr(const Ptrs& p, int n, int c, int K) {
        return reinterpret_cast<const uint8_t*>(p.qs + (size_t)n * K + (size_t)c * 32);
    }
    static __device__ __forceinline__ const uint8_t* hptr(const Ptrs& p, int n, int c, int K) {
        return qptr(p, n, c, K) + 16;
    }
    static __device__ __forceinline__ Sraw sload(const Ptrs& p, int n, int c, int K) {
        return {p.d[(size_t)n * (K / 32) + c]};
    }
    // sload's bytes by cp.async into a 16-byte slot: d
    static __device__ __forceinline__ void copy_sraw(uint8_t* dst, const Ptrs& p, int n, int c,
                                                     int K) {
        cp_async_small<4>(dst, p.d + (size_t)n * (K / 32) + c);
    }
    static __device__ __forceinline__ Sraw sraw_of(const uint8_t* src, int) {
        return {*reinterpret_cast<const float*>(src)};
    }
    static __device__ __forceinline__ Scale scale(const Sraw& r, int) { return {r.d, 0.f}; }
    static __device__ __forceinline__ uint32_t hword(uint32_t h, int) { return h; }
    // the 4 quants of packed word j of the run: the lo run's word (q), or
    // the hi run's (h)
    static __device__ __forceinline__ float4 dequant4(uint32_t q, uint32_t h, int, int half,
                                                      const Scale& s) {
        const uint32_t b4 = (half ? h : q) ^ 0x80808080u;
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __fmul_rn(byte_minus(b4, i, 8388736.f), s.mul);
        return make_float4(w[0], w[1], w[2], w[3]);
    }
};

}  // namespace qmm_tiled

extern "C" int qmm_q8_0_f32(const float* x, const int8_t* qs, const float* d, float* y,
                            int M, int N, int K, void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q80>(x, {qs, d}, y, M, N, K, stream);
}

// ------------------------------------------------------------------ K5-i8
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q8_0_i8 (_qd_i8_kernel
// with nblk=4, launcher _i8_call): y (M, N) f32 for M >= int8_min_m
// (prefill), in two launches.
// 1. `qmm_i8::quant_x` with the map XQ80 (qmm_i8_tiled.cuh, shared with K3
//    and K6-i8): x (M, K) f32 or bf16 -> qx (M, K) int8 and ex (M, K/128)
//    f32 per (row, natural 128-element tile), the bits of quantize_x_tiles
//    (the reference's q8_split_x only permutes lanes inside a tile). Bound
//    by x's bytes.
// 2. The int8 body (qmm_i8_tiled.cuh) with the format Q80I8 below, one
//    tile per step: per (row, tile) the fold of the 4 block scales by the
//    tile bound, 127 |d| per block, its amax, dw = amax / 127, inv = 127 /
//    amax (0 when amax = 0), d' = d * inv, then w8 = clip(round_half_even(
//    q * d'), +-127) (q = -128 clips at -127): every step one IEEE
//    operation (__fmul_rn / __fdiv_rn), the bits of tile_fold(d, None, 4,
//    127) + expand_w8. Integer dots on the int8 tensor cores (mma.sync),
//    then out += (acc * ex) * dw per tile in ascending order, as the
//    reference and the earlier dp4a kernel sum: the output keeps their bits
//    at every M and shape.
// Bound on the H100: the weight bytes (1.125 B per weight) at M = 64..128,
// operations (2*M*N*K int8) at larger M; the expansion on the CUDA cores
// (a byte permute, a subtraction, a product and the rounding per weight,
// once per block row of 128 activation rows) sets the pace between them.
// What bounded the earlier design (PERF.md): the operand preparation ran
// as eager torch ops per call, the weights' fold recomputed every call,
// and the dots ran on dp4a with no load in flight.

namespace q80_i8 {

struct Q80I8 {
    static constexpr int TILES = 1;
    static constexpr int SPAN = 128;
    struct Ptrs {
        const int8_t* qs;
        const float* d;
    };
    // BN = 64 (BPT = 32, one block a thread): d.x is the thread's block's
    // scale, and the tile's amax meets in an xor butterfly over the row's 4
    // lanes (max is exact: any order). BN = 32 (BPT = 16, half a block):
    // d holds the tile's 4 scales; there a butterfly over 8 lanes took
    // longer than the loads it saves (one block per SM, latency-bound).
    struct Raw {
        uint4 q[2];                      // BPT (16 or 32) quants
        float4 d;
    };
    __device__ static void zero(Raw& r) {
        r.q[0] = r.q[1] = make_uint4(0, 0, 0, 0);
        r.d = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    template <int BPT>
    __device__ static void load(Raw& r, const Ptrs& p, int n, int s, int piece, int K) {
        const int8_t* q = p.qs + (size_t)n * K + (size_t)s * 128 + piece * BPT;
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i) r.q[i] = __ldg(reinterpret_cast<const uint4*>(q) + i);
        const float* d = p.d + (size_t)n * (K / 32) + 4 * (size_t)s;
        if constexpr (BPT == 32) r.d.x = __ldg(d + piece);
        else r.d = __ldg(reinterpret_cast<const float4*>(d));
    }
    template <int BPT>
    __device__ static void expand(const Raw& r, int piece, uint4 (&wv)[1][BPT / 16],
                                  float (&dw)[1]) {
        float amax, db;
        if constexpr (BPT == 32) {
            db = r.d.x;
            amax = __fmul_rn(127.f, fabsf(db));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
            amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        } else {
            const float d[4] = {r.d.x, r.d.y, r.d.z, r.d.w};
            amax = 0.f;
            db = 0.f;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                amax = fmaxf(amax, __fmul_rn(127.f, fabsf(d[b])));
                if (b == piece / 2) db = d[b];
            }
        }
        dw[0] = __fdiv_rn(amax, 127.f);
        const float inv = amax > 0.f ? __fdiv_rn(127.f, amax) : 0.f;
        const float ds = __fmul_rn(db, inv);
        // q + 128 in each byte: its float minus 2^23 + 128 is q
#pragma unroll
        for (int i = 0; i < BPT / 16; ++i)
            wv[0][i] = make_uint4(qmm_i8::expand4(r.q[i].x ^ 0x80808080u, 8388736.f, ds),
                                  qmm_i8::expand4(r.q[i].y ^ 0x80808080u, 8388736.f, ds),
                                  qmm_i8::expand4(r.q[i].z ^ 0x80808080u, 8388736.f, ds),
                                  qmm_i8::expand4(r.q[i].w ^ 0x80808080u, 8388736.f, ds));
    }
};

}  // namespace q80_i8

// K5-i8's x quantization: x (M, K) f32 (x_bf16 = 0) or bf16 (1), 16-byte
// aligned, K % 128 == 0 -> qx (M, K) int8, ex (M, K/128) f32.
extern "C" int qmm_q8_0_i8_quant_x(const void* x, int x_bf16, int8_t* qx, float* ex,
                                   int M, int K, void* stream) {
    const qmm_i8::XOut o = {{qx, qx + 128}, {ex, ex + 1}, K, 256, K / 128, 2};
    return qmm_i8::quant_x<qmm_i8::XQ80>(x, x_bf16, o, M, K, (cudaStream_t)stream);
}

// K5-i8's product on quantized x: qx (M, K) int8, ex (M, K/128) f32, the
// Q8_0 weights as K5 takes them.
extern "C" int qmm_q8_0_i8(const int8_t* qx, const float* ex, const int8_t* qs,
                           const float* d, float* y, int M, int N, int K, void* stream) {
    qmm_i8::XOps<1> x = {{qx}, {ex}};
    return qmm_i8::launch<q80_i8::Q80I8>(x, {qs, d}, y, M, N, K, (cudaStream_t)stream);
}
