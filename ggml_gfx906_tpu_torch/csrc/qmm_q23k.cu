// K9: the Q2_K and Q3_K fused dequant + matmul for Hopper (sm_90a).
//
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q2_K (_q2k_kernel) and
// ::qmm_q3_K (_q3k_kernel): y (M, N) f32 = x (M, K) f32 . W^T at every M.
// Neither type has an int8 twin, so this kernel runs every product of the
// Q2_K file but its Q6_K head and the Q3_K products of the Q3_K_M file,
// decode rows and prefill rows alike.
//
// Weight layouts (ggml wire order, struct of arrays, per row n of N, per
// 256-element superblock sb of K/256; h = 128-element half, t = 2-bit
// plane, l = 0..31):
//   qs     (N, K/4)  u8 : byte 64*sb + 32*h + l holds element 256*sb +
//                         128*h + 32*t + l at bits 2t..2t+1 (both types)
//   scales (N, K/16) u8 : Q2_K: byte e/16 is element e's scale (low nibble)
//                         and min (high nibble)
//   hmask  (N, K/8)  u8 : Q3_K: bit 4*h + t of byte 32*sb + l is element
//                         256*sb + 128*h + 32*t + l's high bit
//   sc     (N, K/16) i8 : Q3_K: element e's signed 6-bit scale (-32..31)
//   d, dmin (N, K/256) f32: Q2_K d and dmin; Q3_K d
// Q2_K: w = q*(d*(sc & 15)) - dmin*(sc >> 4). d*sc and dmin*m (an f16 times
// 4 bits) and q*(d*sc) (2 bits more) are exact in f32, so w rounds once, at
// the difference. Q3_K: w = ((q | hbit << 2) - 4) * (d*sc); d*sc (f16 times
// 6 bits) and the product (3 bits more) are exact. The weights formed in
// registers and in shared memory equal the plain dequantization bit for
// bit.
//
// The body is qmm_f32_tiled.cuh's, shared with K4, K7 and K8. Its chunk is
// 32 weights in two runs of 16; 16 qs bytes of one half hold 64 weights in
// four planes of 16 consecutive elements, so each 16-byte qs group makes
// two chunks: chunk c = 8*sb + 4*h + 2*lh + p (lh: which 16 bytes of the
// half, p: the plane pair) has planes 2p (lo run) and 2p + 1 (hi run):
// run(c, half) = 256*sb + 128*h + 32*(2p + half) + 16*lh. The chunk count
// stays K/32 and the x staging the body's own. The two chunks of a group
// load the same 16 qs bytes: adjacent lanes in one instruction in the
// small and tiled kernels (one transaction), two slots apart in the tree
// kernel, whose second read finds the bytes in L2 (the qs of an 11008 x
// 4096 matrix are 11 MB): HBM reads qs once, 0.25 B per weight, L2 serves
// 0.5 B per weight there. For Q3_K, HBYTES = 16: the 16 hmask bytes of
// (sb, lh) hold the high bits of all four planes of both halves, byte i
// with qs byte i, so packed word j of hmask goes with packed word j of qs
// (bit 4h + 2p + half of each byte). Q2_K has no high bits (HBYTES = 0).
// The chunk's two scale bytes (8h + 4p + lh and + 2) lie in one aligned
// 4-byte word. dequant4 shifts a packed word once to its plane, masks the
// four quants as the bytes of one word (Q3_K ORs in the high bits the same
// way) and turns each into a float by byte_minus (a PRMT and an FADD), not
// by an I2F.
//
// Bound on the H100, per entry point (chip_smoke.py computes it per call):
// - M <= 8 (decode), `small_kernel`: the weight bytes, 0.34 B per weight
//   for Q2_K (0.25 qs + 1/16 scales + 1/32 d and dmin) and 0.45 B for Q3_K
//   (0.25 qs + 1/8 hmask + 1/16 sc + 1/64 d), read once: 0.0046 / 0.0061 ms
//   for 11008 x 4096; from M of about 4 the FMAs (2*M flops per weight at
//   67 TFLOP/s) bound them instead, then latency. At most 128 registers.
// - M > 8 (prefill, the engine's chunks), `tiled_kernel` or `tree_kernel`:
//   the f32 FMA rate (0.1723 ms for 11008 x 4096 at M = 128), then shared
//   memory and the L2 traffic of x. Each weight is read and dequantized
//   once per 64 activation rows (the earlier design read it once per 8).
// The ptxas lines that chip_smoke.py prints give each kernel's registers
// and spills.
// Reduction order: the body's, 32 slots over the chunks (chunk c in slot c
// mod 32, ascending, its 16 lo then 16 hi elements), then the
// xor-butterfly tree; fixed by K alone, so a row's bits do not depend on M
// or on the kernel. The earlier K9 (lanes over 64-weight groups) summed in
// another order, so its results differ from these in the last bits. No
// atomics, no split-K, no TF32.
//
// Every function returns the cudaError_t of its launch (0 = success).

#include "qmm_f32_tiled.cuh"

namespace qmm_tiled {

// chunk c = 8*sb + 4*h + 2*lh + p, as the note above says
struct K23Chunk {
    static __device__ __forceinline__ int run(int c, int half) {
        const int q = c & 7;
        return (c >> 3) * 256 + (q >> 2) * 128 + 32 * (2 * (q & 1) + half) + ((q >> 1) & 1) * 16;
    }
    static __device__ __forceinline__ size_t qoff(int n, int c, int K) {
        return (size_t)n * (K / 4) + (size_t)(c >> 1) * 16;
    }
    // the 4-byte word of a row's scale bytes that holds the chunk's two
    // (bytes 8h + 4p .. 8h + 4p + 3 of its superblock), and the shift that
    // brings the lo run's byte to bits 0..7 and the hi run's to 16..23
    static __device__ __forceinline__ size_t sword(int n, int c, int K) {
        const int q = c & 7;
        return (size_t)n * (K / 16) + (size_t)(c >> 3) * 16 + (q >> 2) * 8 + (q & 1) * 4;
    }
    static __device__ __forceinline__ int sshift(int c) { return 8 * ((c >> 1) & 1); }
};

struct Q2K : K23Chunk {
    struct Ptrs {
        const uint8_t* qs;
        const uint8_t* scales;
        const float* d;
        const float* dmin;
    };
    struct Sraw {
        float d, dmin;
        uint32_t sc;         // lo run's scale byte at bits 0..7, hi run's at 16..23
    };
    static constexpr int HBYTES = 0;
    static __device__ __forceinline__ const uint8_t* qptr(const Ptrs& p, int n, int c, int K) {
        return p.qs + qoff(n, c, K);
    }
    static __device__ __forceinline__ Sraw sload(const Ptrs& p, int n, int c, int K) {
        const size_t blk = (size_t)n * (K / 256) + (c >> 3);
        return {p.d[blk], p.dmin[blk],
                *reinterpret_cast<const uint32_t*>(p.scales + sword(n, c, K)) >> sshift(c)};
    }
    // sload's bytes by cp.async into a 16-byte slot: the scale word, d, dmin
    static __device__ __forceinline__ void copy_sraw(uint8_t* dst, const Ptrs& p, int n, int c,
                                                     int K) {
        const size_t blk = (size_t)n * (K / 256) + (c >> 3);
        cp_async_small<4>(dst, p.scales + sword(n, c, K));
        cp_async_small<4>(dst + 4, p.d + blk);
        cp_async_small<4>(dst + 8, p.dmin + blk);
    }
    static __device__ __forceinline__ Sraw sraw_of(const uint8_t* src, int c) {
        return {*reinterpret_cast<const float*>(src + 4), *reinterpret_cast<const float*>(src + 8),
                *reinterpret_cast<const uint32_t*>(src) >> sshift(c)};
    }
    static __device__ __forceinline__ Scale scale(const Sraw& r, int half) {
        const uint32_t b = (r.sc >> (16 * half)) & 0xFFu;
        return {__fmul_rn(r.d, (float)(b & 0xFu)), __fmul_rn(r.dmin, (float)(b >> 4))};
    }
    static __device__ __forceinline__ uint32_t hword(uint32_t, int) { return 0u; }
    static __device__ __forceinline__ float4 dequant4(uint32_t q, uint32_t, int c, int half,
                                                      const Scale& s) {
        const uint32_t b4 = (q >> (2 * (2 * (c & 1) + half))) & 0x03030303u;
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            w[i] = __fsub_rn(__fmul_rn(byte_minus(b4, i, 8388608.f), s.mul), s.sub);
        return make_float4(w[0], w[1], w[2], w[3]);
    }
};

struct Q3K : K23Chunk {
    struct Ptrs {
        const uint8_t* qs;
        const uint8_t* hmask;
        const int8_t* sc;
        const float* d;
    };
    struct Sraw {
        float d;
        uint32_t sc;         // lo run's scale byte at bits 0..7, hi run's at 16..23
    };
    static constexpr int HBYTES = 16;
    static __device__ __forceinline__ const uint8_t* qptr(const Ptrs& p, int n, int c, int K) {
        return p.qs + qoff(n, c, K);
    }
    static __device__ __forceinline__ const uint8_t* hptr(const Ptrs& p, int n, int c, int K) {
        return p.hmask + (size_t)n * (K / 8) + (size_t)(c >> 3) * 32 + ((c >> 1) & 1) * 16;
    }
    static __device__ __forceinline__ Sraw sload(const Ptrs& p, int n, int c, int K) {
        return {p.d[(size_t)n * (K / 256) + (c >> 3)],
                *reinterpret_cast<const uint32_t*>(p.sc + sword(n, c, K)) >> sshift(c)};
    }
    // sload's bytes by cp.async into a 16-byte slot: the scale word, then d
    static __device__ __forceinline__ void copy_sraw(uint8_t* dst, const Ptrs& p, int n, int c,
                                                     int K) {
        cp_async_small<4>(dst, p.sc + sword(n, c, K));
        cp_async_small<4>(dst + 4, p.d + (size_t)n * (K / 256) + (c >> 3));
    }
    static __device__ __forceinline__ Sraw sraw_of(const uint8_t* src, int c) {
        return {*reinterpret_cast<const float*>(src + 4),
                *reinterpret_cast<const uint32_t*>(src) >> sshift(c)};
    }
    static __device__ __forceinline__ Scale scale(const Sraw& r, int half) {
        const int v = (int8_t)((r.sc >> (16 * half)) & 0xFFu);
        return {__fmul_rn(r.d, (float)v), 0.f};
    }
    static __device__ __forceinline__ uint32_t hword(uint32_t h, int) { return h; }
    static __device__ __forceinline__ float4 dequant4(uint32_t q, uint32_t h, int c, int half,
                                                      const Scale& s) {
        const int t = 2 * (c & 1) + half;               // the plane
        const int hshift = 4 * ((c >> 2) & 1) + t;      // its bit in hmask: 4h + t
        const uint32_t b4 = ((q >> (2 * t)) & 0x03030303u) | (((h >> hshift) & 0x01010101u) << 2);
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __fmul_rn(byte_minus(b4, i, 8388612.f), s.mul);
        return make_float4(w[0], w[1], w[2], w[3]);
    }
};

}  // namespace qmm_tiled

extern "C" int qmm_q2k_f32(const float* x, const uint8_t* qs, const uint8_t* scales,
                           const float* d, const float* dmin, float* y, int M, int N, int K,
                           void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q2K>(x, {qs, scales, d, dmin}, y, M, N, K, stream);
}

extern "C" int qmm_q3k_f32(const float* x, const uint8_t* qs, const uint8_t* hmask,
                           const int8_t* sc, const float* d, float* y, int M, int N, int K,
                           void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q3K>(x, {qs, hmask, sc, d}, y, M, N, K, stream);
}
