// K6 and K8: the Q4_0, Q4_1, Q5_0 and Q5_1 fused dequant + matmul for
// Hopper (sm_90a).
//
// K8 replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_1 (_q41_kernel),
// ::qmm_q5_0 and ::qmm_q5_1 (both through _q5l_body): y (M, N) f32 = x (M,
// K) f32 . W^T at every M. None of the three has an int8 twin, so this
// kernel runs every product of the Q4_1, Q5_0 and Q5_1 files but their
// Q6_K head, decode rows and prefill rows alike.
// K6 replaces ::qmm_q4_0 (_q40_kernel): the same product for Q4_0, at M <
// int8_min_m (decode, short prefill chunks); K6-i8 (csrc/qmm_q4_0.cu)
// takes the larger M.
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
// Q4_0: w = (q - 8)*d and Q4_1: w = q*d + m with q the nibble; Q5_0:
// w = (q - 16)*d and Q5_1: w = q*d + m with q = nibble | fifth bit << 4. q
// has at most 5 bits and d is an f16 widened to f32, so q*d is exact in
// f32: q*d + m rounds once, and the body's q*mul - sub with sub = -m is
// the same sum bit for bit (x - (-m) is x + m in IEEE arithmetic, signed
// zeros included). (q - 16)*d and (q - 8)*d do not round. The weights
// formed in registers and in shared memory equal the plain dequantization
// bit for bit.
//
// The body is qmm_f32_tiled.cuh's, shared with K1, K4, K7 and K9. A block is
// one of its chunks as it stands: chunk c = block c, its lo run the 16 low
// nibbles (elements 32c .. 32c + 15), its hi run the 16 high nibbles; 344
// chunks on K = 11008, as Q5_K has. The fifth bits do not have the body's
// 16-byte form: Q5_0 and Q5_1 carry one 4-byte word per chunk (HBYTES = 4),
// whose bits 4j .. 4j + 3 (lo run) and 16 + 4j .. 16 + 4j + 3 (hi run) go
// with packed word j of qs; Q4_0 and Q4_1 carry none (HBYTES = 0), so the
// body loads nothing for them. dequant4 gathers a packed word's four quants as
// the bytes of one word (the fifth bits spread by one multiply) and turns
// each into a float by byte_minus (a PRMT and an FADD), not by an I2F.
//
// Bound on the H100, per entry point (chip_smoke.py computes it per call):
// - M <= 8 (decode), `small_kernel`: the weight bytes, 0.625 B per weight
//   for Q4_0 (0.5 qs + 1/8 d), 0.75 B for Q4_1 (0.5 qs + 1/8 d + 1/8 m) and
//   Q5_0 (0.5 qs + 1/8 qh + 1/8 d), 0.875 B for Q5_1, read once: 0.0084 /
//   0.0101 / 0.0101 / 0.0118 ms for 11008 x 4096, then latency. At most 128
//   registers.
// - M > 8 (prefill, the engine's chunks), `tiled_kernel` or `tree_kernel`:
//   the f32 FMA rate, 2*M*N*K flops at 67 TFLOP/s (0.1723 ms for 11008 x
//   4096 at M = 128), then shared memory and the L2 traffic of x. Each
//   weight is read and dequantized once per 64 activation rows (the
//   earlier design read it once per 8: 16 passes at M = 128).
// The ptxas lines that chip_smoke.py prints give each kernel's registers
// and spills.
// Reduction order: the body's, 32 slots over the blocks (block c in slot c
// mod 32, ascending, its 16 low then 16 high elements), then the
// xor-butterfly tree; fixed by K alone, so a row's bits do not depend on M
// or on the kernel. The earlier K6 and K8 (lanes over half blocks of
// 512-element spans) summed in another order, so their results differ
// from these in the last bits. No atomics, no split-K, no TF32.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include "qmm_f32_tiled.cuh"

namespace qmm_tiled {

template <bool HAS_QH, bool HAS_MIN>
struct Legacy {
    struct Ptrs {
        const uint8_t* qs;
        const uint8_t* qh;
        const float* d;
        const float* m;
    };
    struct Sraw {
        float d, m;
    };
    static constexpr int HBYTES = HAS_QH ? 4 : 0;
    static __device__ __forceinline__ int run(int c, int half) { return 32 * c + 16 * half; }
    static __device__ __forceinline__ const uint8_t* qptr(const Ptrs& p, int n, int c, int K) {
        return p.qs + (size_t)n * (K / 2) + (size_t)c * 16;
    }
    static __device__ __forceinline__ const uint8_t* hptr(const Ptrs& p, int n, int c, int K) {
        return p.qh + (size_t)n * (K / 8) + (size_t)c * 4;
    }
    static __device__ __forceinline__ Sraw sload(const Ptrs& p, int n, int c, int K) {
        const size_t blk = (size_t)n * (K / 32) + c;
        return {p.d[blk], HAS_MIN ? p.m[blk] : 0.f};
    }
    // sload's bytes by cp.async into a 16-byte slot: d, then m
    static __device__ __forceinline__ void copy_sraw(uint8_t* dst, const Ptrs& p, int n, int c,
                                                     int K) {
        const size_t blk = (size_t)n * (K / 32) + c;
        cp_async_small<4>(dst, p.d + blk);
        if (HAS_MIN) cp_async_small<4>(dst + 4, p.m + blk);
    }
    static __device__ __forceinline__ Sraw sraw_of(const uint8_t* src, int) {
        return {*reinterpret_cast<const float*>(src),
                HAS_MIN ? *reinterpret_cast<const float*>(src + 4) : 0.f};
    }
    // w = q*d + m as q*d - (-m); Q4_0's w = (q - 8)*d and Q5_0's (q - 16)*d
    // use mul alone
    static __device__ __forceinline__ Scale scale(const Sraw& r, int) { return {r.d, -r.m}; }
    // the bias a quant loses before the product, plus 2^23 (byte_minus)
    static constexpr float BIAS = 8388608.f + (HAS_MIN ? 0.f : HAS_QH ? 16.f : 8.f);
    // packed word j holds elements 4j .. 4j + 3 of each run: their fifth
    // bits are bits 4j + i (lo) and 16 + 4j + i (hi) of the chunk's word
    static __device__ __forceinline__ uint32_t hword(uint32_t h, int j) {
        return HAS_QH ? h >> (4 * j) : 0u;
    }
    static __device__ __forceinline__ float4 dequant4(uint32_t q, uint32_t h, int, int half,
                                                      const Scale& s) {
        // byte i: the nibble of element 4j + i of the run, its fifth bit at 4
        // (bits 0..3 of h >> 16*half times 0x2040810 land at 4, 12, 20, 28)
        uint32_t b4 = (q >> (4 * half)) & 0x0F0F0F0Fu;
        if (HAS_QH) b4 |= (((h >> (16 * half)) & 0xFu) * 0x2040810u) & 0x10101010u;
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = HAS_MIN ? __fsub_rn(__fmul_rn(byte_minus(b4, i, BIAS), s.mul), s.sub)
                           : __fmul_rn(byte_minus(b4, i, BIAS), s.mul);
        return make_float4(w[0], w[1], w[2], w[3]);
    }
};

using Q40 = Legacy<false, false>;
using Q41 = Legacy<false, true>;
using Q50 = Legacy<true, false>;
using Q51 = Legacy<true, true>;

}  // namespace qmm_tiled

extern "C" int qmm_q4_0_f32(const float* x, const uint8_t* qs, const float* d, float* y,
                            int M, int N, int K, void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q40>(x, {qs, nullptr, d, nullptr}, y, M, N, K, stream);
}

extern "C" int qmm_q4_1_f32(const float* x, const uint8_t* qs, const float* d,
                            const float* m, float* y, int M, int N, int K, void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q41>(x, {qs, nullptr, d, m}, y, M, N, K, stream);
}

extern "C" int qmm_q5_0_f32(const float* x, const uint8_t* qs, const uint8_t* qh,
                            const float* d, float* y, int M, int N, int K, void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q50>(x, {qs, qh, d, nullptr}, y, M, N, K, stream);
}

extern "C" int qmm_q5_1_f32(const float* x, const uint8_t* qs, const uint8_t* qh,
                            const float* d, const float* m, float* y, int M, int N, int K,
                            void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q51>(x, {qs, qh, d, m}, y, M, N, K, stream);
}
