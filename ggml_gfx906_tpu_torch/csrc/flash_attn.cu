// Causal flash attention (online softmax) for Hopper (sm_90a): K2.
//
// Replaces ggml_gfx906_tpu/ops/pallas/flash_attn.py::causal_flash_attention
// (kernel _kernel): out = softmax(q.k^T * scale [softcap] + causal mask).v
// for q (B, H, N, D) f32 at absolute positions pos[b] + n, against a K/V
// cache (B, KVH, M, D) of f32, bf16, or int8 with per-(b, head, position)
// f32 scales (kd scales the score columns, vd scales P after the row sum).
// GQA folds the G = H/KVH query heads of one KV head into rows
// (row = n*G + g), so each K/V tile is loaded once for all of them.
//
// Bound on the H100: bytes at decode (the K/V stream, read once per KV
// head: 0.0192 ms for 8 slots x 32 heads at window 1024, bf16), operations
// at long prefill chunks (4*B*H*rows*D f32 FMAs on the CUDA cores; never
// TF32, the reference dot is f32).
//
// What held the first design back at decode: one block per (b*KVH, row
// tile) walked the whole window serially (32 blocks for a single stream on
// 132 SMs), loaded K/V one element per thread (about 8 KB in flight per
// block) and kept 3 of 4 warps idle on a one-row tile. This design:
//  - Chunks at fixed absolute positions. A row's causal range is cut at
//    multiples of FA_C = 128 positions. Each chunk's partial (m, l, acc)
//    starts from (NEG_INF, 0, 0); its row max m is exact, its probabilities
//    p = exp(s - m) (0 on masked columns), l and acc = sum p.v are summed
//    in an order fixed by the chunk alone. A row's result is the left fold
//    of its chunks 0..last in ascending order with one formula (merge
//    below: m = max, l = l*a + l_c*b, acc likewise, a and b exponentials of
//    the max differences, every product and sum rounded on its own), then
//    acc * (1/l) with l == 0 giving 0. Masked columns add exact zeros, so
//    a row's bits do not depend on M (the window), N, B, its neighbours in
//    a tile, or the launch's split.
//  - Split-KV. The grid's z dimension cuts each row tile's chunks into
//    ranges of `cps` chunks. With one range a block folds its chunks in
//    registers as it goes and writes the output; with more, every block
//    writes each chunk's partial to a buffer the wrapper allocates
//    (B*KVH*rows*nchunk*(D+2) floats) and combine_kernel folds them in
//    the same order with the same merge, so the split is free per launch
//    (the wrapper picks it to fill the SMs). No atomics. A block whose
//    range lies past its rows' last chunk exits at once.
//  - Bytes in flight. K and V tiles of 32 positions (the row slab is
//    contiguous, so a tile is one contiguous run) move by 16-byte
//    cp.async into a ring of 4 tiles (3 of f32); the block consumes tile
//    i while the next ones load. A chunk is 4 K tiles (scores), then 4 V
//    tiles (P.V). The ragged end of the window is zero-filled.
//  - All warps busy at N = 1. A score is a D-long dot over 16 lanes: lane
//    j takes the 16-byte segments j, j+16, ... of the row (8 bf16, 4 f32
//    or 16 int8 elements each), in order, with fmaf from +0; the 16 lane
//    sums meet in an xor butterfly (8, 4, 2, 1). A warp computes two
//    columns per instruction, the 8 half-warps 32 columns of a tile per
//    row. Tiles of 16 rows (prefill, GQA) take the reduce-scatter form of
//    the same butterfly: a half-warp forms one column's partial dots for
//    all 16 rows at once and each level adds the same pairs of lane sums,
//    so a row gets the same bits in a tile of 4 or of 16. P.V spreads rows
//    and D over the threads: each acc element is one fmaf chain over the
//    chunk's columns in order.
// Precision as before: f32 scores, softmax state and P.V, FMA on the CUDA
// cores, q and P never rounded below f32. D * sizeof(KV) must be a
// multiple of 16 and each (b, kvh) slab 16-byte aligned (the wrapper pads
// or copies otherwise).
//
// K/V may be views with any stride between (b, kvh) slabs, as long as each
// slab is a contiguous (M, D) block and stride(b) == KVH * stride(kvh)
// (the engine's attention-window slices of the cache qualify).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BK 32                     // positions per K/V tile
#define FA_C 128                     // positions per chunk: fixes every row's order
#define FA_TILES (FA_C / FA_BK)
#define FA_THREADS 128
#define FA_WARPS (FA_THREADS / 32)
#define FA_MAX_D 256
#define FA_NEG_INF (-0.7f * 3.402823466e+38f)   // finite: NEG_INF - NEG_INF stays defined

namespace fa {
namespace {   // internal linkage: two builds loaded in one process keep their own statics

// A K/V element type: W elements per 16-byte segment, their conversion to f32
template <typename KV> struct KVT;
template <> struct KVT<float> {
    static constexpr int W = 4;
    __device__ static void cvt(const uint4& u, float* f) {
        f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
    }
    __device__ static float one(const unsigned char* t, int i) {
        return reinterpret_cast<const float*>(t)[i];
    }
    __device__ static float2 two(const unsigned char* t, int i) {     // i even
        return *reinterpret_cast<const float2*>(t + 4 * i);
    }
};
template <> struct KVT<__nv_bfloat16> {
    static constexpr int W = 8;
    __device__ static void cvt(const uint4& u, float* f) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
        }
    }
    __device__ static float one(const unsigned char* t, int i) {
        return __uint_as_float((uint32_t)reinterpret_cast<const uint16_t*>(t)[i] << 16);
    }
    __device__ static float2 two(const unsigned char* t, int i) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(t + 2 * i);
        return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
    }
};
template <> struct KVT<int8_t> {
    static constexpr int W = 16;
    __device__ static void cvt(const uint4& u, float* f) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 16; ++i) f[i] = (float)(int8_t)(w[i >> 2] >> (8 * (i & 3)));
    }
    __device__ static float one(const unsigned char* t, int i) {
        return (float)reinterpret_cast<const int8_t*>(t)[i];
    }
    __device__ static float2 two(const unsigned char* t, int i) {
        const uint32_t w = *reinterpret_cast<const uint16_t*>(t + i);
        return make_float2((float)(int8_t)w, (float)(int8_t)(w >> 8));
    }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");   // bytes < 16: the rest is zero
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The fold of a chunk's partial (mc, lc, accc) into a running (m, l, acc):
// merge_coef gives the two factors and moves m; merge applies them. Both
// kernels fold with these two functions, so the fold has one set of bits.
__device__ __forceinline__ void merge_coef(float& m, float mc, float& a, float& b) {
    const float mn = fmaxf(m, mc);
    a = expf(m - mn);
    b = expf(mc - mn);
    m = mn;
}
__device__ __forceinline__ float merge(float x, float a, float y, float b) {
    return __fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b));
}

// K/V tiles in the ring: 4 of bf16 or int8, 3 of f32 (a deeper f32 ring
// costs more in occupancy than it gains in bytes in flight)
template <typename KV>
__host__ __device__ constexpr int stages() { return sizeof(KV) == 4 ? 3 : 4; }

template <typename KV, bool QUANT, int BR>
__global__ void __launch_bounds__(FA_THREADS)
fwd_kernel(const float* __restrict__ q, const KV* __restrict__ k, const KV* __restrict__ v,
           const float* __restrict__ kd, const float* __restrict__ vd,
           const int* __restrict__ pos, float* __restrict__ out, float* __restrict__ part,
           int H, int KVH, int N, int M, int D, long long kv_stride, long long sc_stride,
           float scale, float softcap, float inv_softcap, int cps, int nchunk) {
    using T = KVT<KV>;
    constexpr int ES = sizeof(KV);
    constexpr int STAGES = stages<KV>();
    constexpr int W = T::W;
    constexpr int NSEG = FA_MAX_D / (16 * W);      // segments per lane at most
    constexpr int TR = BR == 4 ? 1 : 4;           // P.V: thread rows x threads across D
    constexpr int TD = FA_THREADS / TR;
    constexpr int VEC = BR == 4 ? 1 : 2;          // consecutive d per thread and load
    constexpr int RPT = BR / TR;
    constexpr int DPT = FA_MAX_D / TD;            // d per thread: VEC*td + VEC*TD*jj + e
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile_bytes = FA_BK * D * ES;
    unsigned char* ring = smem;                                   // STAGES tiles
    float* q_s = reinterpret_cast<float*>(smem + STAGES * tile_bytes);      // BR x D
    float* s_s = q_s + BR * D;                                    // BR x FA_C scores, then p
    float* m_s = s_s + BR * FA_C;                                 // BR chunk maxima
    float* l_s = m_s + BR;                                        // BR chunk sums

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.x;
    const int b = bh / KVH;
    const int kvh = bh - b * KVH;
    const int G = H / KVH;
    const int rows = N * G;
    const int row0 = blockIdx.y * BR;
    const int nr = min(BR, rows - row0);
    const int p0 = pos[b];
    // columns any row of the block reads, and the block's chunk range
    const int limit = min(M, p0 + (row0 + nr - 1) / G + 1);
    const int c_begin = blockIdx.z * cps;
    const int c_end = min(c_begin + cps, (limit - 1) / FA_C + 1);
    if (c_begin >= c_end) return;
    const bool split = gridDim.z > 1;
    const int nfull = c_end - c_begin - 1;       // chunks before the last, all 4 tiles
    const int nt_last = (min(limit, c_end * FA_C) - (c_end - 1) * FA_C + FA_BK - 1) / FA_BK;
    const int n_tiles = 2 * FA_TILES * nfull + 2 * nt_last;
    // tile i of the block: chunk ch, K (isv = 0) or V, tile t of the chunk
    auto tile_of = [&](int i, int& ch, int& isv, int& t) {
        if (i < 2 * FA_TILES * nfull) {
            ch = c_begin + i / (2 * FA_TILES);
            const int j = i % (2 * FA_TILES);
            isv = j >= FA_TILES;
            t = j % FA_TILES;
        } else {
            const int j = i - 2 * FA_TILES * nfull;
            ch = c_end - 1;
            isv = j >= nt_last;
            t = isv ? j - nt_last : j;
        }
    };
    const size_t slab = (size_t)bh * kv_stride;
    const long long slab_bytes = (long long)M * D * ES;
    auto issue = [&](int i) {
        int ch, isv, t;
        tile_of(i, ch, isv, t);
        const long long off0 = (long long)(ch * FA_C + t * FA_BK) * D * ES;
        const unsigned char* src = reinterpret_cast<const unsigned char*>((isv ? v : k) + slab);
        unsigned char* dst = ring + (i % STAGES) * tile_bytes;
        for (int u = tid; u < tile_bytes / 16; u += FA_THREADS) {
            const long long off = off0 + 16LL * u;
            const int n = (int)max(0LL, min(16LL, slab_bytes - off));
            cp_async16(dst + 16 * u, n ? src + off : src, n);
        }
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {    // the first tiles load while q arrives
        if (i < n_tiles) issue(i);
        cp_async_commit();
    }
    for (int i = tid; i < nr * D; i += FA_THREADS) {
        const int r = i / D;
        const int d = i - r * D;
        const int R = row0 + r;
        const int n = R / G;
        const int h = kvh * G + (R - n * G);
        q_s[i] = q[(((size_t)b * H + h) * N + n) * D + d];
    }

    const float* kdb = QUANT ? kd + (size_t)bh * sc_stride : nullptr;
    const float* vdb = QUANT ? vd + (size_t)bh * sc_stride : nullptr;
    const int tr = tid / TD;
    const int td = tid - tr * TD;
    float accr[RPT][DPT], accc[RPT][DPT], mrun[RPT], lrun[RPT];
#pragma unroll
    for (int ii = 0; ii < RPT; ++ii) {
        mrun[ii] = FA_NEG_INF;
        lrun[ii] = 0.f;
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) accr[ii][jj] = accc[ii][jj] = 0.f;
    }
    const size_t prow = (size_t)bh * rows + row0;       // partials' first row
    float* part_ml = split ? part + (size_t)gridDim.x * rows * nchunk * D : nullptr;

    for (int i = 0; i < n_tiles; ++i) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();                 // tile i is in; tile i-1 consumed by all
        if (i + STAGES - 1 < n_tiles) issue(i + STAGES - 1);
        cp_async_commit();
        int ch, isv, t;
        tile_of(i, ch, isv, t);
        const unsigned char* tile = ring + (i % STAGES) * tile_bytes;
        const int col0 = ch * FA_C + t * FA_BK;
        const int nt = ch == c_end - 1 ? nt_last : FA_TILES;
        if (!isv) {
            const int hw = tid >> 4;
            const int j = tid & 15;
            if constexpr (BR == 4) {
                // scores: half-warp hw takes columns hw, hw+8, hw+16, hw+24 of every
                // row; the 16 lane sums of a dot meet in the xor butterfly
                for (int r = 0; r < nr; ++r) {
                    float qr[NSEG][W];
#pragma unroll
                    for (int s = 0; s < NSEG; ++s)
#pragma unroll
                        for (int e = 0; e < W; ++e) {
                            const int d = (j + 16 * s) * W + e;
                            qr[s][e] = d < D ? q_s[r * D + d] : 0.f;
                        }
#pragma unroll
                    for (int u = 0; u < FA_BK / 8; ++u) {
                        const int c = hw + 8 * u;
                        float a = 0.f;
#pragma unroll
                        for (int s = 0; s < NSEG; ++s) {
                            const int seg = j + 16 * s;
                            if (seg * W < D) {
                                const uint4 raw = *reinterpret_cast<const uint4*>(
                                    tile + (size_t)(c * D + seg * W) * ES);
                                float kf[W];
                                T::cvt(raw, kf);
#pragma unroll
                                for (int e = 0; e < W; ++e) a = fmaf(qr[s][e], kf[e], a);
                            }
                        }
#pragma unroll
                        for (int off = 8; off > 0; off >>= 1)
                            a += __shfl_xor_sync(0xffffffffu, a, off);
                        if (j == 0) s_s[r * FA_C + t * FA_BK + c] = a;
                    }
                }
            } else {
                // scores of 16 rows: half-warp hw takes columns hw + 8u, two at a
                // time, each lane its segments of every row's dot; the lane sums
                // meet in the reduce-scatter form of the same butterfly (8, 4, 2,
                // 1: each level adds the same pairs), after which lane j holds row
                // j's dot. Rows past nr hold garbage that no row reads.
#pragma unroll
                for (int u = 0; u < FA_BK / 16; ++u) {
                    float kf[2][NSEG][W];
#pragma unroll
                    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
                        for (int s = 0; s < NSEG; ++s) {
                            const int seg = j + 16 * s;
                            uint4 raw = make_uint4(0, 0, 0, 0);
                            if (seg * W < D)
                                raw = *reinterpret_cast<const uint4*>(
                                    tile + (size_t)((hw + 8 * (2 * u + cc)) * D + seg * W) * ES);
                            T::cvt(raw, kf[cc][s]);
                        }
                    float acc[2][16];
#pragma unroll
                    for (int r = 0; r < 16; ++r) {
                        float a0 = 0.f, a1 = 0.f;
#pragma unroll
                        for (int s = 0; s < NSEG; ++s) {
                            if ((j + 16 * s) * W < D) {
#pragma unroll
                                for (int e = 0; e < W; e += 4) {
                                    const float4 q4 = *reinterpret_cast<const float4*>(
                                        q_s + r * D + (j + 16 * s) * W + e);
                                    const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
                                    for (int x = 0; x < 4; ++x) {
                                        a0 = fmaf(qv[x], kf[0][s][e + x], a0);
                                        a1 = fmaf(qv[x], kf[1][s][e + x], a1);
                                    }
                                }
                            }
                        }
                        acc[0][r] = a0;
                        acc[1][r] = a1;
                    }
#pragma unroll
                    for (int off = 8; off > 0; off >>= 1) {
                        const bool up = j & off;
#pragma unroll
                        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
                            for (int i = 0; i < off; ++i) {
                                const float lo = acc[cc][i];
                                const float hi = acc[cc][i + off];
                                const float recv = __shfl_xor_sync(0xffffffffu, up ? lo : hi, off);
                                acc[cc][i] = (up ? hi : lo) + recv;
                            }
                    }
#pragma unroll
                    for (int cc = 0; cc < 2; ++cc)
                        s_s[j * FA_C + t * FA_BK + hw + 8 * (2 * u + cc)] = acc[cc][0];
                }
            }
            if (t == nt - 1) {
                // the chunk's softmax: warp w takes rows w, w+4, ...; lane l columns l + 32u
                __syncthreads();
                for (int r = warp; r < nr; r += FA_WARPS) {
                    const int qpos = p0 + (row0 + r) / G;
                    float sv[FA_TILES];
                    float mx = FA_NEG_INF;
#pragma unroll
                    for (int u = 0; u < FA_TILES; ++u) {
                        const int col = ch * FA_C + lane + 32 * u;
                        float s = FA_NEG_INF;
                        if (col <= qpos && col < M) {
                            s = s_s[r * FA_C + lane + 32 * u];
                            if (QUANT) s = s * kdb[col];
                            s = s * scale;
                            if (softcap != 0.f) s = tanhf(s * inv_softcap) * softcap;
                        }
                        sv[u] = s;
                        mx = fmaxf(mx, s);
                    }
                    mx = warp_max(mx);
                    float ps = 0.f;
#pragma unroll
                    for (int u = 0; u < FA_TILES; ++u) {
                        const int col = ch * FA_C + lane + 32 * u;
                        const bool ok = col <= qpos && col < M;
                        const float p = ok ? expf(sv[u] - mx) : 0.f;
                        ps = ps + p;
                        s_s[r * FA_C + lane + 32 * u] = QUANT && ok ? p * vdb[col] : p;
                    }
                    ps = warp_sum(ps);
                    if (lane == 0) {
                        m_s[r] = mx;
                        l_s[r] = ps;
                        if (split && ch <= min(qpos, M - 1) / FA_C) {
                            part_ml[((prow + r) * nchunk + ch) * 2] = mx;
                            part_ml[((prow + r) * nchunk + ch) * 2 + 1] = ps;
                        }
                    }
                }
            }
        } else {
            // P.V: one fmaf chain per (row, d) over the chunk's columns in order
            const int ncol = min(FA_BK, limit - col0);
            if constexpr (VEC == 1) {
                for (int c = 0; c < ncol; ++c) {
                    float vv[DPT];
#pragma unroll
                    for (int jj = 0; jj < DPT; ++jj) {
                        const int d = td + TD * jj;
                        vv[jj] = d < D ? T::one(tile, c * D + d) : 0.f;
                    }
#pragma unroll
                    for (int ii = 0; ii < RPT; ++ii) {
                        const int r = tr + TR * ii;
                        if (r < nr) {
                            const float p = s_s[r * FA_C + t * FA_BK + c];
#pragma unroll
                            for (int jj = 0; jj < DPT; ++jj)
                                if (td + TD * jj < D) accc[ii][jj] = fmaf(p, vv[jj], accc[ii][jj]);
                        }
                    }
                }
            } else {
                // a thread takes d pairs 2*td + 64*jj and columns four at a time
                const int c4 = ncol & ~3;
                for (int c = 0; c < ncol; c += 4) {
                    float p[RPT][4];
#pragma unroll
                    for (int ii = 0; ii < RPT; ++ii) {
                        const float* pr = s_s + (tr + TR * ii) * FA_C + t * FA_BK + c;
                        if (c < c4) {
                            const float4 p4 = *reinterpret_cast<const float4*>(pr);
                            p[ii][0] = p4.x;
                            p[ii][1] = p4.y;
                            p[ii][2] = p4.z;
                            p[ii][3] = p4.w;
                        } else {
#pragma unroll
                            for (int x = 0; x < 4; ++x) p[ii][x] = c + x < ncol ? pr[x] : 0.f;
                        }
                    }
#pragma unroll
                    for (int x = 0; x < 4; ++x) {
                        if (c + x >= ncol) break;
#pragma unroll
                        for (int jj = 0; jj < DPT / 2; ++jj) {
                            const int d = 2 * td + 2 * TD * jj;
                            if (d < D) {
                                const float2 v2 = T::two(tile, (c + x) * D + d);
#pragma unroll
                                for (int ii = 0; ii < RPT; ++ii) {
                                    accc[ii][2 * jj] = fmaf(p[ii][x], v2.x, accc[ii][2 * jj]);
                                    accc[ii][2 * jj + 1] = fmaf(p[ii][x], v2.y, accc[ii][2 * jj + 1]);
                                }
                            }
                        }
                    }
                }
            }
            if (t == nt - 1) {
                // the chunk is done: fold it (one range) or write its partial
#pragma unroll
                for (int ii = 0; ii < RPT; ++ii) {
                    const int r = tr + TR * ii;
                    if (r < nr && ch <= min(p0 + (row0 + r) / G, M - 1) / FA_C) {
                        if (split) {
                            float* dst = part + ((prow + r) * nchunk + ch) * D;
#pragma unroll
                            for (int jj = 0; jj < DPT; ++jj) {
                                const int d = VEC * td + VEC * TD * (jj / VEC) + jj % VEC;
                                if (d < D) dst[d] = accc[ii][jj];
                            }
                        } else {
                            float a, bb;
                            merge_coef(mrun[ii], m_s[r], a, bb);
                            lrun[ii] = merge(lrun[ii], a, l_s[r], bb);
#pragma unroll
                            for (int jj = 0; jj < DPT; ++jj)
                                accr[ii][jj] = merge(accr[ii][jj], a, accc[ii][jj], bb);
                        }
                    }
#pragma unroll
                    for (int jj = 0; jj < DPT; ++jj) accc[ii][jj] = 0.f;
                }
            }
        }
    }
    cp_async_wait<0>();
    if (split) return;
#pragma unroll
    for (int ii = 0; ii < RPT; ++ii) {
        const int r = tr + TR * ii;
        if (r >= nr) continue;
        const float inv = 1.f / (lrun[ii] == 0.f ? 1.f : lrun[ii]);
        const int R = row0 + r;
        const int n = R / G;
        const int h = kvh * G + (R - n * G);
        float* o = out + (((size_t)b * H + h) * N + n) * D;
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) {
            const int d = VEC * td + VEC * TD * (jj / VEC) + jj % VEC;
            if (d < D) o[d] = accr[ii][jj] * inv;
        }
    }
}

// The left fold of every row's chunk partials, 0..last, then acc * (1/l):
// one block per (b*KVH, row), threads across D.
__global__ void __launch_bounds__(FA_THREADS)
combine_kernel(const float* __restrict__ part, const int* __restrict__ pos,
               float* __restrict__ out, int H, int KVH, int N, int M, int D, int nchunk,
               int bkvh) {
    const int G = H / KVH;
    const int rows = N * G;
    const int idx = blockIdx.x;
    const int bh = idx / rows;
    const int R = idx - bh * rows;
    const int b = bh / KVH;
    const int kvh = bh - b * KVH;
    const int n = R / G;
    const int h = kvh * G + (R - n * G);
    const int last = min(pos[b] + n, M - 1) / FA_C;
    const float* ml = part + (size_t)bkvh * rows * nchunk * D + (size_t)idx * nchunk * 2;
    const float* pa = part + (size_t)idx * nchunk * D;
    float m = FA_NEG_INF, l = 0.f, acc[FA_MAX_D / FA_THREADS];
#pragma unroll
    for (int j = 0; j < FA_MAX_D / FA_THREADS; ++j) acc[j] = 0.f;
    for (int c = 0; c <= last; ++c) {
        float a, bb;
        merge_coef(m, ml[2 * c], a, bb);
        l = merge(l, a, ml[2 * c + 1], bb);
#pragma unroll
        for (int j = 0; j < FA_MAX_D / FA_THREADS; ++j) {
            const int d = threadIdx.x + FA_THREADS * j;
            if (d < D) acc[j] = merge(acc[j], a, pa[(size_t)c * D + d], bb);
        }
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    float* o = out + (((size_t)b * H + h) * N + n) * D;
#pragma unroll
    for (int j = 0; j < FA_MAX_D / FA_THREADS; ++j) {
        const int d = threadIdx.x + FA_THREADS * j;
        if (d < D) o[d] = acc[j] * inv;
    }
}

template <typename KV, bool QUANT, int BR>
int launch(const float* q, const void* k, const void* v, const float* kd, const float* vd,
           const int* pos, float* out, float* part, int B, int H, int KVH, int N, int M,
           int D, long long kv_stride, long long sc_stride, float scale, float softcap,
           float inv_softcap, int split, cudaStream_t stream) {
    auto smem_of = [](int d) {
        return (size_t)stages<KV>() * FA_BK * d * sizeof(KV) +
               sizeof(float) * ((size_t)BR * d + (size_t)BR * FA_C + 2 * BR);
    };
    auto kern = fwd_kernel<KV, QUANT, BR>;
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem_of(FA_MAX_D));
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const int rows = N * (H / KVH);
    const int nchunk = (M + FA_C - 1) / FA_C;
    const int cps = (nchunk + split - 1) / split;
    const int nsplit = (nchunk + cps - 1) / cps;
    if (nsplit > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
    dim3 grid(B * KVH, (rows + BR - 1) / BR, nsplit);
    kern<<<grid, FA_THREADS, smem_of(D), stream>>>(
        q, (const KV*)k, (const KV*)v, kd, vd, pos, out, part, H, KVH, N, M, D, kv_stride,
        sc_stride, scale, softcap, inv_softcap, cps, nchunk);
    if (nsplit > 1)
        combine_kernel<<<B * KVH * rows, FA_THREADS, 0, stream>>>(part, pos, out, H, KVH, N, M,
                                                                  D, nchunk, B * KVH);
    return (int)cudaGetLastError();
}

template <int BR>
int dispatch_kv(int kv_type, const float* q, const void* k, const void* v, const float* kd,
                const float* vd, const int* pos, float* out, float* part, int B, int H,
                int KVH, int N, int M, int D, long long kv_stride, long long sc_stride,
                float scale, float softcap, float inv_softcap, int split, cudaStream_t s) {
    switch (kv_type) {
        case 0:
            return launch<float, false, BR>(q, k, v, kd, vd, pos, out, part, B, H, KVH, N, M,
                                            D, kv_stride, sc_stride, scale, softcap,
                                            inv_softcap, split, s);
        case 1:
            return launch<__nv_bfloat16, false, BR>(q, k, v, kd, vd, pos, out, part, B, H, KVH,
                                                    N, M, D, kv_stride, sc_stride, scale,
                                                    softcap, inv_softcap, split, s);
        case 2:
            return launch<int8_t, true, BR>(q, k, v, kd, vd, pos, out, part, B, H, KVH, N, M,
                                            D, kv_stride, sc_stride, scale, softcap,
                                            inv_softcap, split, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace
}  // namespace fa

// kv_type: 0 f32, 1 bf16, 2 int8 (kd/vd required). q/out f32 contiguous
// (B, H, N, D); pos int32 (B,) on the device. D <= 256 with D * sizeof(KV)
// a multiple of 16 and 16-byte aligned slabs. split: the number of chunk
// ranges per row tile (1: no partials; more: `part` holds
// B*KVH*rows*ceil(M/128)*(D+2) floats and a second kernel folds them).
extern "C" int flash_attn_fwd(const float* q, const void* k, const void* v,
                              const float* kd, const float* vd, const int* pos,
                              float* out, float* part, int B, int H, int KVH, int N, int M,
                              int D, long long kv_stride, long long sc_stride,
                              float scale, float softcap, float inv_softcap,
                              int kv_type, int split, void* stream) {
    if (D > FA_MAX_D || D < 1 || H % KVH != 0 || M < 1 || split < 1)
        return (int)cudaErrorInvalidValue;
    const int es = kv_type == 0 ? 4 : kv_type == 1 ? 2 : 1;
    if ((D * es) % 16 != 0) return (int)cudaErrorInvalidValue;
    const int rows = N * (H / KVH);
    cudaStream_t s = (cudaStream_t)stream;
    if (rows <= 4)
        return fa::dispatch_kv<4>(kv_type, q, k, v, kd, vd, pos, out, part, B, H, KVH, N, M,
                                  D, kv_stride, sc_stride, scale, softcap, inv_softcap, split, s);
    return fa::dispatch_kv<16>(kv_type, q, k, v, kd, vd, pos, out, part, B, H, KVH, N, M, D,
                               kv_stride, sc_stride, scale, softcap, inv_softcap, split, s);
}
