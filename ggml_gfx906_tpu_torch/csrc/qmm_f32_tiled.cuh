// Shared body of the f32 quantized matmul kernels for Hopper (sm_90a):
//   y (M, N) f32 = x (M, K) f32 . W^T, W dequantized on the fly,
// for K1 (Q4_K, csrc/qmm_q4k.cu), K4 (Q6_K, csrc/qmm_q6k.cu), K7 (Q5_K,
// csrc/qmm_q5k.cu), K6 and K8 (Q4_0; Q4_1, Q5_0, Q5_1: csrc/qmm_legacy.cu)
// and K9 (Q2_K, Q3_K, csrc/qmm_q23k.cu).
//
// A chunk is 16 bytes of a row's packed low-bit array (ql / qs): 32 weights
// in two runs of 16 consecutive K positions, "lo" and "hi" (the low and
// high nibbles of the 16 bytes, or two 2-bit planes of them), plus the
// high bits that go with them: 16 bytes (F::HBYTES = 16: Q6_K, Q5_K,
// Q3_K), one 4-byte word (4: Q5_0, Q5_1) or none (0: Q4_K, Q4_0, Q4_1,
// Q2_K). A format F supplies where a chunk's runs and bytes
// lie, its scales, and the dequantization of one packed 32-bit word (4
// weights of a run):
//   struct Ptrs;                       the weight arrays
//   HBYTES                             high-bit bytes per chunk: 16, 4 or 0
//   int run(c, half)                   K index of chunk c's lo (0) / hi (1) run
//   const uint8_t* qptr(p, n, c, K)    chunk c's 16 packed bytes, row n
//   const uint8_t* hptr(p, n, c, K)    their HBYTES high-bit bytes (HBYTES > 0)
//   Sraw sload(p, n, c, K)             the scale words the chunk needs
//   copy_sraw(dst, p, n, c, K)         the same bytes by cp.async (16-byte slot)
//   Sraw sraw_of(src, c)               ... read back from that slot
//   Scale scale(Sraw, half)            w = q * mul (- sub)
//   uint32_t hword(h, j)               the high bits of packed word j, from the
//                                      word the body loaded for it: word j of
//                                      16 bytes, the chunk's one word of 4
//                                      (0 without high bits)
//   float4 dequant4(q, h, c, half, s)  the 4 weights of one packed word
// The body loads only the HBYTES bytes: a 16-byte, one 4-byte or no load
// (or cp.async) per chunk, never past a row's end. Every weight is formed
// with __fmul_rn / __fsub_rn exactly as the plain dequantization forms it
// (nvcc would otherwise contract a*b - c into an FMA), so the weights in
// registers and in shared memory equal it bit for bit.
//
// Reduction order (one order for every M, kernel and launch shape): each
// output y[m, n] is the sum of 32 slot sums. Slot l (0..31) takes the
// chunks c ≡ l (mod 32) in ascending order; inside a chunk, the 16 lo
// elements in K order, then the 16 hi ones, each with fmaf(x, w, acc) from
// acc = +0. The 32 slot sums are then added in the xor-butterfly tree with
// offsets 16, 8, 4, 2, 1. Nothing in that order depends on M, on a row's
// place in its tile or on the launch shape, so a row of x gives the same
// bits alone and in any batch: the engine's streams equal `generate`'s.
// No split-K across blocks, no atomics. It is the order K4 and K7 had
// before this body, and K1 had too, so their results kept their bits;
// K6's, K8's and K9's earlier kernels summed in another order, so their
// results moved in the last bits when they came onto the body.
//
// Three kernels share the format step and the order; launch() picks one
// by M and by the grid the tree kernel would have:
// - small (M <= 8, decode): lanes are slots. A warp owns SMALL_ROWS = 2
//   weight rows and all of M (a 2 x MT register tile, MT the next of 1, 2,
//   4, 8 >= M); lane l walks the chunks c ≡ l (mod 32), loading its next
//   chunk's bytes and scales before it forms and uses the current chunk's
//   32 weights; the slot sums meet in the butterfly. A block of 8 warps
//   stages x one round (32 chunks) at a time in shared memory by cp.async,
//   double-buffered (2 x MT x 4 KB), so x comes from L2 once per 16 weight
//   rows, not once per warp. At most 128 registers (two blocks per SM).
//   Bound: the weight bytes (HBM), then latency.
// - tiled (8 < M <= 32, and M <= 64 where the tree kernel's grid would
//   leave half the SMs idle): lanes are slots. A block of 8 warps owns BM = 64 (32 at
//   M <= 32) activation rows and BN = 16 (32) weight rows; each warp a
//   16 x 8 register tile of one K slot per lane (128 accumulators). K
//   advances in stages of 8 elements (two packed words of one run) of 32
//   consecutive chunks: x's 32-byte pieces come by cp.async, 3 buffers
//   deep, and the block dequantizes the stage's BN x 32 x 8 weights once
//   into shared memory (2 buffers, the next stage's bytes in registers
//   meanwhile); the tile's sums meet in a reduce-scatter form of the
//   butterfly. 224 KB (160 KB) of shared memory, one block per SM. Bound:
//   shared memory, which feeds every FMA (no broadcast: the lanes of a warp
//   read different K), and the L2 traffic of x (M x K x 4 x N / BN bytes).
// - tree (M > 32, when its 64 x 64 tiles keep more than half of the SMs
//   busy: every main-path shape at M = 65..128, N >= 11008 at M = 33..64):
//   lanes are outputs. A block of 256 threads owns a 64 x 64 output tile, a
//   thread 4 x 4 of it. The block takes the 32 slots one after another in
//   bit-reversed order (phase p: slot bitrev5(p) = 0, 16, 8, 24, 4, ...),
//   one chunk per stage: x's 64 x 32 floats of the chunk and the packed
//   bytes of its 64 weight rows come by cp.async, 3 stages ahead of the one
//   computed, and the block dequantizes each stage's weights once into
//   shared memory. After a slot, each thread adds its 16 slot sums into a
//   5-level stack like a binary counter (a level whose bit of p is set is
//   added, left + right, and passed up): the adds pair exactly the sums the
//   butterfly pairs, so the result is the butterfly's, bit for bit. A warp
//   touches 4 x rows and 8 weight float4s per element (broadcast reads).
//   A stage's packed bytes come as one 16-byte copy per row, its high bits
//   as one 16- or 4-byte copy per row (none without), its scales as one
//   copy per row. 64 KB of shared memory, ~238 registers, one block per
//   SM.
// Every kernel reads each weight from HBM and dequantizes it once per
// block row of activations: at most twice for M <= 128.
// FP32 FMA on the CUDA cores, never TF32: the reference dot is HIGHEST.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm_tiled {

struct Scale {
    float mul, sub;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int bytes = valid ? 16 : 0;        // 0: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

template <int BYTES>                         // 4 or 8
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(BYTES) : "memory");
}

// Byte i of v as the float byte - bias: one PRMT puts the byte under the
// exponent of 2^23 (the float 2^23 + byte), an FADD takes bias + 2^23 off;
// exact for a small integer bias. It spares the I2F conversion, which
// runs at a fraction of the FMA rate, on formats whose quants are bytes
// of a packed word.
__device__ __forceinline__ float byte_minus(uint32_t v, int i, float bias_plus_2p23) {
    return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u | i)), bias_plus_2p23);
}

// ------------------------------------------------------------ formats

// Q6_K (ggml wire order, struct of arrays, per row n, superblock sb of
// nb = K/256): ql (N, K/2) u8: chunk c = 8*sb + 4*h + 2*k + j2 holds, for
// i < 16, element sb*256 + h*128 + k*32 + 16*j2 + i in its low nibble (lo)
// and that + 64 in its high nibble (hi); qh (N, K/4) u8: byte sb*64 + h*32
// + 16*j2 + i holds their high bits at 2k (lo) and 4 + 2k (hi); sc (N,
// K/16) i8, one per 16 elements; d (N, nb) f32. w = (q - 32) * (d*sc): d
// has an 11-bit significand and sc 8 bits, so d*sc is exact and w rounds
// once.
struct Q6K {
    struct Ptrs {
        const uint8_t* ql;
        const uint8_t* qh;
        const int8_t* sc;
        const float* d;
    };
    struct Sraw {
        float d;
        int lo, hi;
    };
    static constexpr int HBYTES = 16;
    static __device__ __forceinline__ int run(int c, int half) {
        const int q = c & 7;
        return (c >> 3) * 256 + (q >> 2) * 128 + ((q >> 1) & 1) * 32 + (q & 1) * 16 + half * 64;
    }
    static __device__ __forceinline__ const uint8_t* qptr(const Ptrs& p, int n, int c, int K) {
        return p.ql + (size_t)n * (K / 2) + (size_t)c * 16;
    }
    static __device__ __forceinline__ const uint8_t* hptr(const Ptrs& p, int n, int c, int K) {
        const int q = c & 7;
        return p.qh + (size_t)n * (K / 4) + (size_t)(c >> 3) * 64 + (q >> 2) * 32 + (q & 1) * 16;
    }
    static __device__ __forceinline__ Sraw sload(const Ptrs& p, int n, int c, int K) {
        const int8_t* s = p.sc + (size_t)n * (K / 16);
        return {p.d[(size_t)n * (K / 256) + (c >> 3)], s[run(c, 0) >> 4], s[run(c, 1) >> 4]};
    }
    static __device__ __forceinline__ Scale scale(const Sraw& r, int half) {
        return {__fmul_rn(r.d, (float)(half ? r.hi : r.lo)), 0.f};
    }
    // sload's bytes by cp.async into a 16-byte slot: the 4-byte words of sc
    // that hold the lo and hi runs' scales, then d
    static __device__ __forceinline__ void copy_sraw(uint8_t* dst, const Ptrs& p, int n, int c,
                                                     int K) {
        const int8_t* s = p.sc + (size_t)n * (K / 16);
        cp_async_small<4>(dst, s + ((run(c, 0) >> 4) & ~3));
        cp_async_small<4>(dst + 4, s + ((run(c, 1) >> 4) & ~3));
        cp_async_small<4>(dst + 8, p.d + (size_t)n * (K / 256) + (c >> 3));
    }
    static __device__ __forceinline__ Sraw sraw_of(const uint8_t* src, int c) {
        const int8_t* s = reinterpret_cast<const int8_t*>(src);
        return {*reinterpret_cast<const float*>(src + 8), s[(run(c, 0) >> 4) & 3],
                s[4 + ((run(c, 1) >> 4) & 3)]};
    }
    static __device__ __forceinline__ uint32_t hword(uint32_t h, int) { return h; }
    static __device__ __forceinline__ float4 dequant4(uint32_t q, uint32_t h, int c, int half,
                                                      const Scale& s) {
        const int shift = 2 * ((c >> 1) & 1) + 4 * half;
        const int nshift = 4 * half;
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t b = (q >> (8 * i + nshift)) & 0xFu;
            const uint32_t hb = (h >> (8 * i + shift)) & 3u;
            w[i] = __fmul_rn((float)((int)(b | (hb << 4)) - 32), s.mul);
        }
        return make_float4(w[0], w[1], w[2], w[3]);
    }
};

// Q5_K (HIGH) and Q4_K: qs (N, K/2) u8: chunk c = 8*sb + 2*g + j2 holds,
// for i < 16, element sb*256 + g*64 + 16*j2 + i in its low nibble (lo,
// sub-block 2g) and that + 32 in its high nibble (hi, sub-block 2g+1); qh
// (N, K/8) u8, Q5_K only: byte sb*32 + 16*j2 + i holds their fifth bits at
// 2g (lo) and 2g+1 (hi); scm (N, K/16) u8 = [sc0..sc7 | m0..m7] per
// superblock; dd (N, K/128) f32 = [d, dmin]. w = q * (d*sc) - dmin*m:
// every product is exact (11-bit significands times 6- and 5-bit
// integers), so w rounds once, at the difference. Q4_K has no high bits
// (HBYTES = 0, qh unused) and turns its nibbles into floats by byte_minus.
template <bool HIGH>
struct QK45 {
    struct Ptrs {
        const uint8_t* qs;
        const uint8_t* qh;
        const uint8_t* scm;
        const float* dd;
    };
    struct Sraw {
        float d, dmin;
        uint32_t sc, m;      // sub-blocks 2g (bits 0..7) and 2g+1 (bits 8..15)
    };
    static constexpr int HBYTES = HIGH ? 16 : 0;
    static __device__ __forceinline__ int run(int c, int half) {
        const int q = c & 7;
        return (c >> 3) * 256 + (q >> 1) * 64 + (q & 1) * 16 + half * 32;
    }
    static __device__ __forceinline__ const uint8_t* qptr(const Ptrs& p, int n, int c, int K) {
        return p.qs + (size_t)n * (K / 2) + (size_t)c * 16;
    }
    static __device__ __forceinline__ const uint8_t* hptr(const Ptrs& p, int n, int c, int K) {
        return p.qh + (size_t)n * (K / 8) + (size_t)(c >> 3) * 32 + (c & 1) * 16;
    }
    static __device__ __forceinline__ Sraw sload(const Ptrs& p, int n, int c, int K) {
        const size_t blk = (size_t)n * (K / 256) + (c >> 3);
        const uint16_t* s = reinterpret_cast<const uint16_t*>(p.scm + blk * 16);
        const float2 dd = *reinterpret_cast<const float2*>(p.dd + blk * 2);
        const int g = (c & 7) >> 1;
        return {dd.x, dd.y, s[g], s[4 + g]};
    }
    // sload's bytes by cp.async into a 16-byte slot: the 4-byte words of scm
    // that hold sub-blocks 2g, 2g+1's scales and their mins, then [d, dmin]
    static __device__ __forceinline__ void copy_sraw(uint8_t* dst, const Ptrs& p, int n, int c,
                                                     int K) {
        const size_t blk = (size_t)n * (K / 256) + (c >> 3);
        const int g = (c & 7) >> 1;
        cp_async_small<4>(dst, p.scm + blk * 16 + 4 * (g >> 1));
        cp_async_small<4>(dst + 4, p.scm + blk * 16 + 8 + 4 * (g >> 1));
        cp_async_small<8>(dst + 8, p.dd + blk * 2);
    }
    static __device__ __forceinline__ Sraw sraw_of(const uint8_t* src, int c) {
        const int o = 2 * (((c & 7) >> 1) & 1);
        return {*reinterpret_cast<const float*>(src + 8), *reinterpret_cast<const float*>(src + 12),
                *reinterpret_cast<const uint16_t*>(src + o),
                *reinterpret_cast<const uint16_t*>(src + 4 + o)};
    }
    static __device__ __forceinline__ Scale scale(const Sraw& r, int half) {
        const int sh = 8 * half;
        return {__fmul_rn((float)((r.sc >> sh) & 0xFFu), r.d),
                __fmul_rn((float)((r.m >> sh) & 0xFFu), r.dmin)};
    }
    static __device__ __forceinline__ uint32_t hword(uint32_t h, int) { return h; }
    static __device__ __forceinline__ float4 dequant4(uint32_t q, uint32_t h, int c, int half,
                                                      const Scale& s) {
        const int nshift = 4 * half;
        float w[4];
        if constexpr (HIGH) {
            const int shift = 2 * ((c & 7) >> 1) + half;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint32_t b = (q >> (8 * i + nshift)) & 0xFu;
                const uint32_t hb = (h >> (8 * i + shift)) & 1u;
                w[i] = __fsub_rn(__fmul_rn((float)(b | (hb << 4)), s.mul), s.sub);
            }
        } else {
            // byte i: the nibble of element 4j + i of the run
            const uint32_t b4 = (q >> nshift) & 0x0F0F0F0Fu;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                w[i] = __fsub_rn(__fmul_rn(byte_minus(b4, i, 8388608.f), s.mul), s.sub);
        }
        return make_float4(w[0], w[1], w[2], w[3]);
    }
};

using Q5K = QK45<true>;
using Q4K = QK45<false>;

// ------------------------------------------------------------ small M

#define SMALL_WARPS 8
#define SMALL_ROWS 2

template <class F>
struct ChunkRaw {
    uint4 q, h;              // h: 16 high-bit bytes, or the one word in h.x
    typename F::Sraw s;
};

template <class F>
__device__ __forceinline__ void load_chunk(ChunkRaw<F>& r, const typename F::Ptrs& p,
                                           int n, int c, int K) {
    r.q = *reinterpret_cast<const uint4*>(F::qptr(p, n, c, K));
    if constexpr (F::HBYTES == 16)
        r.h = *reinterpret_cast<const uint4*>(F::hptr(p, n, c, K));
    else if constexpr (F::HBYTES == 4)
        r.h = make_uint4(*reinterpret_cast<const uint32_t*>(F::hptr(p, n, c, K)), 0u, 0u, 0u);
    else
        r.h = make_uint4(0u, 0u, 0u, 0u);
    r.s = F::sload(p, n, c, K);
}

// x of one round (32 chunks) for MT rows in shared memory, [MT][8][32]
// float4: lane l's chunk's lo run is j = 0..3, its hi run j = 4..7.
template <int MT>
__host__ __device__ constexpr size_t small_smem() {
    return (size_t)2 * MT * 8 * 32 * 16;
}

template <class F, int MT>
__global__ void __launch_bounds__(SMALL_WARPS * 32, 2)
small_kernel(const float* __restrict__ x, const typename F::Ptrs p, float* __restrict__ y,
             int M, int N, int K) {
    extern __shared__ __align__(16) float4 xs4[];     // [2][MT][8][32]
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int n0 = (blockIdx.x * SMALL_WARPS + warp) * SMALL_ROWS;
    const int m0 = blockIdx.y * MT;
    const int chunks = K / 32;
    const int rounds = (chunks + 31) / 32;

    // adjacent threads copy the two 16-byte halves of one 32-byte piece
    auto copy_x = [&](int r) {
        float4* dst = xs4 + (r & 1) * MT * 256;
        for (int idx = tid; idx < MT * 256; idx += SMALL_WARPS * 32) {
            const int l = (idx >> 1) & 31, j = ((idx >> 6) & 3) * 2 + (idx & 1), m = idx >> 8;
            const int c = r * 32 + l;
            const bool ok = m0 + m < M && c < chunks;
            const float* src = ok ? x + (size_t)(m0 + m) * K + F::run(c, j >> 2) + 4 * (j & 3) : x;
            cp_async16(dst + (m * 8 + j) * 32 + l, src, ok);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    float acc[SMALL_ROWS][MT];
#pragma unroll
    for (int r = 0; r < SMALL_ROWS; ++r)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

    ChunkRaw<F> nxt[SMALL_ROWS];
#pragma unroll
    for (int r = 0; r < SMALL_ROWS; ++r)
        if (lane < chunks && n0 + r < N) load_chunk<F>(nxt[r], p, n0 + r, lane, K);
    copy_x(0);

    for (int rd = 0; rd < rounds; ++rd) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();                      // round rd's x visible; rd-1's buffer free
        if (rd + 1 < rounds) copy_x(rd + 1);
        const int c = rd * 32 + lane;
        if (c >= chunks) continue;
        // the chunk's 32 weights of each row: w[r][0..3] lo, w[r][4..7] hi
        float4 w[SMALL_ROWS][8];
#pragma unroll
        for (int r = 0; r < SMALL_ROWS; ++r) {
            const ChunkRaw<F> cur = nxt[r];
            if (c + 32 < chunks && n0 + r < N) load_chunk<F>(nxt[r], p, n0 + r, c + 32, K);
            const uint32_t qw[4] = {cur.q.x, cur.q.y, cur.q.z, cur.q.w};
            const uint32_t hw[4] = {cur.h.x, cur.h.y, cur.h.z, cur.h.w};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const Scale s = F::scale(cur.s, half);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    w[r][4 * half + j] =
                        n0 + r < N ? F::dequant4(qw[j], F::hword(hw[F::HBYTES == 16 ? j : 0], j),
                                                 c, half, s)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        const float4* xb = xs4 + (rd & 1) * MT * 256 + lane;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            if (m0 + m < M) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float4 xv = xb[(m * 8 + j) * 32];
#pragma unroll
                    for (int r = 0; r < SMALL_ROWS; ++r) {
                        acc[r][m] = fmaf(xv.x, w[r][j].x, acc[r][m]);
                        acc[r][m] = fmaf(xv.y, w[r][j].y, acc[r][m]);
                        acc[r][m] = fmaf(xv.z, w[r][j].z, acc[r][m]);
                        acc[r][m] = fmaf(xv.w, w[r][j].w, acc[r][m]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < SMALL_ROWS; ++r) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            float v = acc[r][m];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            const int n = n0 + r;
            if (lane == 0 && n < N && m0 + m < M) y[(size_t)(m0 + m) * N + n] = v;
        }
    }
}

// ------------------------------------------------------------ tiled

#define TILED_WARPS 8
#define TILED_TM 16          // activation rows of a warp's tile
#define TILED_TN 8           // weight rows of a warp's tile

template <int BM>
struct TiledShape {
    static constexpr int WARPS = TILED_WARPS, TM = TILED_TM, TN = TILED_TN;
    static constexpr int THREADS = WARPS * 32;
    static constexpr int WM = BM / TM;                  // warps along M
    static constexpr int BN = TN * (WARPS / WM);
    static constexpr int V = TM * TN;                   // accumulators per lane
    static constexpr int XS = BM * 64;                  // float4s of x per stage: [BM][2][32]
    static constexpr int WS = BN * 64;                  // float4s of w per stage: [BN][2][32]
    static constexpr int XCOPIES = XS / THREADS;        // x copies per thread and stage
    static constexpr int WPAIRS = BN * 32 / THREADS;    // (row, chunk) per thread and stage
    static constexpr size_t SMEM = (size_t)(3 * XS + 2 * WS) * 16;   // x: 3 stages, w: 2
    static_assert(WM * TM == BM && WARPS % WM == 0, "BM must split into warp tiles");
    static_assert(XCOPIES * THREADS == XS && WPAIRS * THREADS == BN * 32, "uneven loaders");
    static_assert(V % 32 == 0, "the reduce-scatter ends with V/32 values per lane");
};

// The butterfly's tree as a reduce-scatter over V values: at offset O the
// lane keeps the half that its bit O selects and adds the partner's copy of
// the same values, so every sum pairs the same two partial sums as the full
// butterfly (offsets 16, 8, 4, 2, 1); the lane ends with V/32 outputs.
template <int V, int O>
__device__ __forceinline__ void scatter(float* acc, int lane) {
    if constexpr (O > 0) {
        constexpr int H = V / 2;
        const bool upper = lane & O;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float keep = upper ? acc[i + H] : acc[i];
            const float send = upper ? acc[i] : acc[i + H];
            acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        scatter<H, O / 2>(acc, lane);
    }
}

template <class F>
struct StageRaw {
    uint2 q, h;              // h: the stage's 8 high-bit bytes, or the chunk's one word in h.x
    typename F::Sraw s;
    bool ok;
};

template <class F, int BM>
__global__ void __launch_bounds__(TiledShape<BM>::THREADS, 1)
tiled_kernel(const float* __restrict__ x, const typename F::Ptrs p, float* __restrict__ y,
             int M, int N, int K) {
    using S = TiledShape<BM>;
    extern __shared__ __align__(16) float4 smem4[];
    float4* xs = smem4;                       // [3][XS]
    float4* ws = smem4 + 3 * S::XS;           // [2][WS]
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int wm = warp % S::WM;
    const int wn = warp / S::WM;
    const int mb = blockIdx.y * BM;
    const int nb = blockIdx.x * S::BN;
    const int chunks = K / 32;
    const int stages = (chunks + 31) / 32 * 4;

    // stage g: round g/4 (chunks 32*(g/4) + 0..31), run half = (g/2)&1,
    // packed words 2*(g&1) and 2*(g&1)+1 of it (elements 8*(g&1) + 0..7).
    // A thread copies x for one chunk (l) and 16-byte piece (t), rows
    // m_x + i*THREADS/64, and dequantizes chunk l of weight rows n_w +
    // i*WARPS: only the rows change between its copies.
    const int t_x = tid & 1, l_x = (tid >> 1) & 31, m_x = tid >> 6;
    const int n_w = tid >> 5;
    auto copy_x = [&](int g) {
        const int half = (g >> 1) & 1, c = (g >> 2) * 32 + l_x;
        float4* dst = xs + (g % 3) * S::XS + (m_x * 2 + t_x) * 32 + l_x;
        const float* src = x + (c < chunks ? F::run(c, half) + 8 * (g & 1) + 4 * t_x : 0);
#pragma unroll
        for (int i = 0; i < S::XCOPIES; ++i) {
            const int m = m_x + i * (S::THREADS / 64);
            const bool ok = mb + m < M && c < chunks;
            cp_async16(dst + i * (S::THREADS / 64) * 64, ok ? src + (size_t)(mb + m) * K : x, ok);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    auto load_w = [&](int g, StageRaw<F> (&raw)[S::WPAIRS]) {
        const int c = (g >> 2) * 32 + lane;
#pragma unroll
        for (int i = 0; i < S::WPAIRS; ++i) {
            const int n = nb + n_w + i * S::WARPS;
            raw[i].ok = n < N && c < chunks;
            if (raw[i].ok) {
                raw[i].q = *reinterpret_cast<const uint2*>(F::qptr(p, n, c, K) + 8 * (g & 1));
                if constexpr (F::HBYTES == 16)
                    raw[i].h = *reinterpret_cast<const uint2*>(F::hptr(p, n, c, K) + 8 * (g & 1));
                else if constexpr (F::HBYTES == 4)
                    raw[i].h.x = *reinterpret_cast<const uint32_t*>(F::hptr(p, n, c, K));
                raw[i].s = F::sload(p, n, c, K);
            }
        }
    };
    auto store_w = [&](int g, const StageRaw<F> (&raw)[S::WPAIRS]) {
        const int half = (g >> 1) & 1, c = (g >> 2) * 32 + lane;
        float4* dst = ws + (g & 1) * S::WS + (n_w * 2) * 32 + lane;
#pragma unroll
        for (int i = 0; i < S::WPAIRS; ++i) {
            float4 w0 = make_float4(0.f, 0.f, 0.f, 0.f), w1 = w0;
            if (raw[i].ok) {
                const Scale s = F::scale(raw[i].s, half);
                const int j = 2 * (g & 1);        // the packed word of q.x
                const uint32_t h0 = F::HBYTES ? raw[i].h.x : 0u;
                const uint32_t h1 = F::HBYTES == 16 ? raw[i].h.y : h0;
                w0 = F::dequant4(raw[i].q.x, F::hword(h0, j), c, half, s);
                w1 = F::dequant4(raw[i].q.y, F::hword(h1, j + 1), c, half, s);
            }
            dst[i * S::WARPS * 64] = w0;
            dst[i * S::WARPS * 64 + 32] = w1;
        }
    };

    float acc[S::V];
#pragma unroll
    for (int i = 0; i < S::V; ++i) acc[i] = 0.f;

    StageRaw<F> raw[S::WPAIRS];
    copy_x(0);
    copy_x(1);
    load_w(0, raw);
    store_w(0, raw);

    for (int g = 0; g < stages; ++g) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // stage g's x is in
        __syncthreads();                      // stage g visible; stage g-1's buffers free
        if (g + 2 < stages) copy_x(g + 2);
        else asm volatile("cp.async.commit_group;\n" ::: "memory");   // keep the count
        const bool more = g + 1 < stages;
        if (more) load_w(g + 1, raw);
        const int c = (g >> 2) * 32 + lane;
        if (c < chunks) {
            const float4* xb = xs + (g % 3) * S::XS + (wm * S::TM * 2) * 32 + lane;
            const float4* wb = ws + (g & 1) * S::WS + (wn * S::TN * 2) * 32 + lane;
#pragma unroll
            for (int t = 0; t < 2; ++t) {
                float4 w[S::TN];
#pragma unroll
                for (int j = 0; j < S::TN; ++j) w[j] = wb[(j * 2 + t) * 32];
#pragma unroll
                for (int mi = 0; mi < S::TM; ++mi) {
                    const float4 xv = xb[(mi * 2 + t) * 32];
                    float* a = acc + mi * S::TN;
#pragma unroll
                    for (int j = 0; j < S::TN; ++j) a[j] = fmaf(xv.x, w[j].x, a[j]);
#pragma unroll
                    for (int j = 0; j < S::TN; ++j) a[j] = fmaf(xv.y, w[j].y, a[j]);
#pragma unroll
                    for (int j = 0; j < S::TN; ++j) a[j] = fmaf(xv.z, w[j].z, a[j]);
#pragma unroll
                    for (int j = 0; j < S::TN; ++j) a[j] = fmaf(xv.w, w[j].w, a[j]);
                }
            }
        }
        if (more) store_w(g + 1, raw);
    }

    scatter<S::V, 16>(acc, lane);
    int base = 0;                             // the first of the lane's V/32 outputs
#pragma unroll
    for (int k = 0; k < 5; ++k)
        if (lane & (16 >> k)) base += S::V >> (k + 1);
    const int m = mb + wm * S::TM + base / S::TN;
    const int n0 = nb + wn * S::TN + base % S::TN;
    if (m < M) {
#pragma unroll
        for (int i = 0; i < S::V / 32; ++i)
            if (n0 + i < N) y[(size_t)m * N + n0 + i] = acc[i];
    }
}

// ------------------------------------------------------------ tree

#define TREE_THREADS 256
#define TREE_BM 64          // activation rows of a block
#define TREE_BN 64          // weight rows of a block
#define TREE_XLD 36         // floats per x row in shared memory (32 + 4: no bank conflicts)
#define TREE_NBUF 4         // x / raw-byte stages in flight
#define TREE_AHEAD 3        // stages issued ahead of the one computed

// one stage = one chunk c of every row of the tile: x [BM][XLD] f32 (its lo
// run at 0..15, hi run at 16..31), the dequantized weights [32][BN] f32,
// and each row's packed bytes, high bits and scale words in a 48-byte slot
struct TreeSmem {
    static constexpr int XS = TREE_BM * TREE_XLD;         // floats
    static constexpr int WS = 32 * TREE_BN;                // floats
    static constexpr int RS = TREE_BN * 48;                // bytes: [BN][q 16 | qh 16 | scales 16]
    static constexpr size_t BYTES = (size_t)(TREE_NBUF * XS + 2 * WS) * 4
                                  + (size_t)TREE_NBUF * RS;
};

__device__ __forceinline__ int slot_chunks(int l, int chunks) {
    return l < chunks ? (chunks - l + 31) / 32 : 0;
}

__device__ __forceinline__ int bitrev5(int p) {
    return (int)(__brev((unsigned)p) >> 27);
}

// Lanes = outputs here, not K slots: the 32 slot sums of every output are
// taken one slot after another, slot l = bitrev5(p) in phase p (0, 16, 8,
// 24, 4, ...), each over its chunks c = l, l + 32, ... in ascending order
// with the elements in chunk order. After phase p the slot sum is merged
// into a 5-level stack like a binary counter: it is added to the pending
// sum of each level whose bit of p is set (left + right), so each add
// pairs exactly the two sums that the xor butterfly (offsets 16, 8, 4, 2,
// 1) pairs; after phase 31 the bottom of the stack is the butterfly's
// result, bit for bit. A thread owns a 4 x 4 output tile (rows wm*16 +
// lane/8 + 4a, columns wn*32 + 4*(lane%8) + b): per element it reads one
// x float of each of its 4 rows (a warp touches 4 rows: broadcasts) and a
// float4 of weights (8 distinct per warp).
template <class F>
__global__ void __launch_bounds__(TREE_THREADS, 1)
tree_kernel(const float* __restrict__ x, const typename F::Ptrs p, float* __restrict__ y,
             int M, int N, int K) {
    extern __shared__ __align__(16) float smemf[];
    float* xs = smemf;                                        // [NBUF][XS]
    float* ws = xs + TREE_NBUF * TreeSmem::XS;              // [2][WS]
    uint8_t* rs = reinterpret_cast<uint8_t*>(ws + 2 * TreeSmem::WS);   // [NBUF][RS]
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int mb = blockIdx.y * TREE_BM;
    const int nb = blockIdx.x * TREE_BN;
    const int chunks = K / 32;
    const int row0 = (warp & 3) * 16 + (lane >> 3);           // + 4a
    const int col0 = (warp >> 2) * 32 + 4 * (lane & 7);       // + b
    const int wrow = tid & 63, wword = tid >> 6;              // this thread's packed word

    // the loader's cursor: phase lp, chunk index li of slot bitrev5(lp)
    int lp = 0, li = 0;
    auto issue = [&](int g) {                 // stage g: x and the packed bytes of its chunk
        if (lp < 32) {
            const int c = li * 32 + bitrev5(lp);
            float* xd = xs + (g % TREE_NBUF) * TreeSmem::XS;
#pragma unroll
            for (int i = 0; i < TREE_BM * 8 / TREE_THREADS; ++i) {
                const int idx = tid + i * TREE_THREADS;
                const int m = idx >> 3, q = idx & 7;
                const bool ok = mb + m < M;
                const float* src = ok ? x + (size_t)(mb + m) * K + F::run(c, q >> 2) + 4 * (q & 3) : x;
                cp_async16(xd + m * TREE_XLD + 4 * q, src, ok);
            }
            // the chunk's packed bytes and high bits, one copy per thread
            // (16 bytes, or 4 for a 4-byte high-bit word), and the scale
            // bytes of each row
            uint8_t* rd = rs + (g % TREE_NBUF) * TreeSmem::RS;
            if (tid < 2 * TREE_BN) {
                const int r = tid >> 1, n = nb + r;
                if constexpr (F::HBYTES == 16) {
                    const uint8_t* src = (tid & 1) ? F::hptr(p, n, c, K) : F::qptr(p, n, c, K);
                    cp_async16(rd + r * 48 + (tid & 1) * 16,
                               n < N ? static_cast<const void*>(src) : static_cast<const void*>(x),
                               n < N);
                } else if (!(tid & 1)) {
                    cp_async16(rd + r * 48,
                               n < N ? static_cast<const void*>(F::qptr(p, n, c, K))
                                     : static_cast<const void*>(x), n < N);
                } else if constexpr (F::HBYTES == 4) {
                    if (n < N) cp_async_small<4>(rd + r * 48 + 16, F::hptr(p, n, c, K));
                }
            } else if (tid < 3 * TREE_BN) {
                const int r = tid - 2 * TREE_BN, n = nb + r;
                if (n < N) F::copy_sraw(rd + r * 48 + 32, p, n, c, K);
            }
            // next stage: skip the empty slots (chunks < 32)
            if (++li >= slot_chunks(bitrev5(lp), chunks)) {
                li = 0;
                do { ++lp; } while (lp < 32 && slot_chunks(bitrev5(lp), chunks) == 0);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // this thread's word of stage g (chunk c) → 4 lo and 4 hi weights of row wrow
    auto dequant = [&](int g, int c) {
        float* wd = ws + (g & 1) * TreeSmem::WS;
        float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
        if (nb + wrow < N) {
            const uint8_t* rd = rs + (g % TREE_NBUF) * TreeSmem::RS + wrow * 48;
            const uint32_t q = *reinterpret_cast<const uint32_t*>(rd + 4 * wword);
            const uint32_t h = F::HBYTES == 0 ? 0u : F::hword(*reinterpret_cast<const uint32_t*>(
                rd + 16 + (F::HBYTES == 16 ? 4 * wword : 0)), wword);
            const typename F::Sraw sr = F::sraw_of(rd + 32, c);
            lo = F::dequant4(q, h, c, 0, F::scale(sr, 0));
            hi = F::dequant4(q, h, c, 1, F::scale(sr, 1));
        }
        const float l4[4] = {lo.x, lo.y, lo.z, lo.w}, h4[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            wd[(4 * wword + i) * TREE_BN + wrow] = l4[i];
            wd[(16 + 4 * wword + i) * TREE_BN + wrow] = h4[i];
        }
    };

    float acc[4][4], stk[5][4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    // the stage of phase 0 comes first (slot 0 always has a chunk)
    for (int g = 0; g < TREE_AHEAD; ++g) issue(g);
    asm volatile("cp.async.wait_group %0;\n" :: "n"(TREE_AHEAD - 1) : "memory");
    __syncthreads();                          // stage 0's bytes, copied by other threads
    dequant(0, 0);

    int s = 0;                                // stages computed
    const int stages = chunks;
    for (int ph = 0; ph < 32; ++ph) {
        const int l = bitrev5(ph);
        const int n_l = slot_chunks(l, chunks);
        for (int i = 0; i < n_l; ++i, ++s) {
            asm volatile("cp.async.wait_group %0;\n" :: "n"(TREE_AHEAD - 2) : "memory");
            __syncthreads();                  // stage s's x and weights, stage s+1's bytes visible
            issue(s + TREE_AHEAD);
            const float* xb = xs + (s % TREE_NBUF) * TreeSmem::XS + row0 * TREE_XLD;
            const float* wb = ws + (s & 1) * TreeSmem::WS + col0;
#pragma unroll
            for (int e4 = 0; e4 < 8; ++e4) {
                float4 xv[4];
#pragma unroll
                for (int a = 0; a < 4; ++a)
                    xv[a] = *reinterpret_cast<const float4*>(xb + 4 * a * TREE_XLD + 4 * e4);
#pragma unroll
                for (int ee = 0; ee < 4; ++ee) {
                    const float4 wv = *reinterpret_cast<const float4*>(wb + (4 * e4 + ee) * TREE_BN);
                    const float wb4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
                    for (int a = 0; a < 4; ++a) {
                        const float xa = ee == 0 ? xv[a].x : ee == 1 ? xv[a].y
                                       : ee == 2 ? xv[a].z : xv[a].w;
#pragma unroll
                        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa, wb4[b], acc[a][b]);
                    }
                }
            }
            if (s + 1 < stages) {
                // the next stage's chunk: the next of this slot, else the
                // first of the next slot that has one
                int c1;
                if (i + 1 < n_l) {
                    c1 = (i + 1) * 32 + l;
                } else {
                    int q = ph + 1;
                    while (slot_chunks(bitrev5(q), chunks) == 0) ++q;
                    c1 = bitrev5(q);
                }
                dequant(s + 1, c1);
            }
        }
        // merge the slot sum (+0 for an empty slot) like a binary counter
        bool open = true;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            if (open) {
                if ((ph >> k) & 1) {
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b) acc[a][b] = stk[k][a][b] + acc[a][b];
                } else {
#pragma unroll
                    for (int a = 0; a < 4; ++a)
#pragma unroll
                        for (int b = 0; b < 4; ++b) { stk[k][a][b] = acc[a][b]; acc[a][b] = 0.f; }
                    open = false;
                }
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");

    // after phase 31 every level merged: acc is the whole sum
#pragma unroll
    for (int a = 0; a < 4; ++a) {
        const int m = mb + row0 + 4 * a;
        if (m < M) {
#pragma unroll
            for (int b = 0; b < 4; ++b)
                if (nb + col0 + b < N) y[(size_t)m * N + nb + col0 + b] = acc[a][b];
        }
    }
}

// ------------------------------------------------------------ launch

template <class F, int MT>
cudaError_t launch_small(const float* x, const typename F::Ptrs& p, float* y, int M, int N,
                         int K, cudaStream_t st) {
    const size_t smem = small_smem<MT>();
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            small_kernel<F, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int rows = SMALL_WARPS * SMALL_ROWS;
    dim3 grid((N + rows - 1) / rows, (M + MT - 1) / MT);
    small_kernel<F, MT><<<grid, SMALL_WARPS * 32, smem, st>>>(x, p, y, M, N, K);
    return cudaGetLastError();
}

template <class F, int BM>
cudaError_t launch_tiled(const float* x, const typename F::Ptrs& p, float* y, int M, int N,
                         int K, cudaStream_t st) {
    using S = TiledShape<BM>;
    const cudaError_t err = cudaFuncSetAttribute(
        tiled_kernel<F, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid((N + S::BN - 1) / S::BN, (M + BM - 1) / BM);
    tiled_kernel<F, BM><<<grid, S::THREADS, S::SMEM, st>>>(x, p, y, M, N, K);
    return cudaGetLastError();
}

template <class F>
cudaError_t launch_tree(const float* x, const typename F::Ptrs& p, float* y, int M, int N,
                        int K, cudaStream_t st) {
    const cudaError_t err = cudaFuncSetAttribute(
        tree_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TreeSmem::BYTES);
    if (err != cudaSuccess) return err;
    dim3 grid((N + TREE_BN - 1) / TREE_BN, (M + TREE_BM - 1) / TREE_BM);
    tree_kernel<F><<<grid, TREE_THREADS, TreeSmem::BYTES, st>>>(x, p, y, M, N, K);
    return cudaGetLastError();
}

inline int sm_count() {
    static int sms[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 132;
    if (sms[dev] == 0 &&
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 132;
    return sms[dev];
}

// The variant by M; every variant sums in the same order.
template <class F>
int launch(const float* x, const typename F::Ptrs& p, float* y, int M, int N, int K,
           void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (M <= 1) err = launch_small<F, 1>(x, p, y, M, N, K, st);
    else if (M <= 2) err = launch_small<F, 2>(x, p, y, M, N, K, st);
    else if (M <= 4) err = launch_small<F, 4>(x, p, y, M, N, K, st);
    else if (M <= 8) err = launch_small<F, 8>(x, p, y, M, N, K, st);
    else {
        // the tree kernel's 64 x 64 tiles when they keep more than half of
        // the SMs busy; else the slot-lane tiles
        const int tree_blocks = ((N + TREE_BN - 1) / TREE_BN) * ((M + TREE_BM - 1) / TREE_BM);
        if (M > 32 && 2 * tree_blocks > sm_count())
            err = launch_tree<F>(x, p, y, M, N, K, st);
        else if (M <= 32) err = launch_tiled<F, 32>(x, p, y, M, N, K, st);
        else err = launch_tiled<F, 64>(x, p, y, M, N, K, st);
    }
    return (int)err;
}

}  // namespace qmm_tiled
