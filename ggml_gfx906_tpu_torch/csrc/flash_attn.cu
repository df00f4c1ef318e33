// Causal flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces ggml_gfx906_tpu/ops/pallas/flash_attn.py::causal_flash_attention
// (kernel _kernel): out = softmax(q.k^T * scale [softcap] + causal mask).v
// for q (B, H, N, D) f32 at absolute positions pos[b] + n, against a K/V
// cache (B, KVH, M, D) of f32, bf16, or int8 with per-(b, head, position)
// f32 scales (kd scales the score columns, vd scales P after the row sum).
// GQA folds the G = H/KVH query heads of one KV head into rows
// (row = n*G + g), so each K/V tile is loaded once for all of them.
//
// Bound on the H100: bytes at decode (the K/V stream, read once per KV head;
// 4*B*H*N*M*D flops are small next to it) and flops at long prefill chunks.
// This first version keeps f32 tiles in shared memory and computes with
// f32 FMAs on the CUDA cores (wgmma and TMA are a later step).
//
// Design:
//  - one block per (b*KVH + kvh, tile of BR folded rows); a loop inside the
//    block over KV tiles replaces the TPU's sequential grid dimension, and
//    stops at the last tile with an unmasked column for the block's last
//    valid row;
//  - the KV tile size BK is fixed (never chosen from M) and the ragged last
//    tile is masked, so the kernel takes any M and a row's result does not
//    depend on M (the attention window), on N, or on the other rows of its
//    tile: masked columns give p = exp(NEG_INF - m) = 0 exactly and leave
//    m, l and acc unchanged;
//  - a thread fills its share of a K/V tile with FA_LOADS loads in flight
//    before it stores any, and rows past the last valid one (padding of
//    the last row tile) are skipped in the score and P.V loops;
//  - m/l/acc are f32; NEG_INF is finite (-0.7 * FLT_MAX); l == 0 gives 0;
//  - sums run in a fixed order: the q.k dot sequentially over D, row max and
//    row sum by an xor-shuffle butterfly over the BK = 32 columns, P.V
//    sequentially over the tile. No atomics.
//
// K/V may be views with any stride between (b, kvh) slabs, as long as each
// slab is a contiguous (M, D) block and stride(b) == KVH * stride(kvh)
// (the engine's attention-window slices of the cache qualify).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BK 32
#define FA_THREADS 128
#define FA_WARPS (FA_THREADS / 32)
#define FA_MAX_D 256
#define FA_LOADS 16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

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

template <int BR, typename KV, bool QUANT>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, const float* __restrict__ kd,
                 const float* __restrict__ vd, const int* __restrict__ pos,
                 float* __restrict__ out, int H, int KVH, int N, int M, int D,
                 long long kv_stride, long long sc_stride, float scale,
                 float softcap, float inv_softcap) {
    extern __shared__ float smem[];
    float* q_s = smem;                       // BR * D
    float* k_s = q_s + BR * D;               // BK * (D + 1)
    float* v_s = k_s + FA_BK * (D + 1);      // BK * D
    float* p_s = v_s + FA_BK * D;            // BR * BK
    float* m_s = p_s + BR * FA_BK;           // BR
    float* l_s = m_s + BR;                   // BR
    float* a_s = l_s + BR;                   // BR

    const float NEG_INF = -0.7f * 3.402823466e+38f;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int bh = blockIdx.x;
    const int b = bh / KVH;
    const int kvh = bh - b * KVH;
    const int G = H / KVH;
    const int rows = N * G;
    const int row0 = blockIdx.y * BR;
    const int p0 = pos[b];
    const int n_kv = (M + FA_BK - 1) / FA_BK;
    const int rlast = min(row0 + BR, rows) - 1;
    const int kmax = min((p0 + rlast / G) / FA_BK, n_kv - 1);

    for (int i = tid; i < BR * D; i += FA_THREADS) {
        const int r = i / D;
        const int d = i - r * D;
        const int R = row0 + r;
        float val = 0.f;
        if (R < rows) {
            const int n = R / G;
            const int h = kvh * G + (R - n * G);
            val = q[(((size_t)b * H + h) * N + n) * D + d];
        }
        q_s[i] = val;
    }
    if (tid < BR) {
        m_s[tid] = NEG_INF;
        l_s[tid] = 0.f;
    }
    float acc[BR][FA_MAX_D / FA_THREADS];
#pragma unroll
    for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int j = 0; j < FA_MAX_D / FA_THREADS; ++j) acc[r][j] = 0.f;

    const KV* kb = k + (size_t)bh * kv_stride;
    const KV* vb = v + (size_t)bh * kv_stride;
    const float* kdb = QUANT ? kd + (size_t)bh * sc_stride : nullptr;
    const float* vdb = QUANT ? vd + (size_t)bh * sc_stride : nullptr;

    const int tile_el = FA_BK * D;
    const size_t kv_el = (size_t)M * D;
    for (int kt = 0; kt <= kmax; ++kt) {
        __syncthreads();                  // q/m/l ready; last tile consumed
        // FA_LOADS loads per thread in flight before any store waits on one
        // (a load-then-store loop would serialise on memory latency)
        const size_t g0 = (size_t)kt * tile_el;
        for (int base = 0; base < tile_el; base += FA_LOADS * FA_THREADS) {
            float kr[FA_LOADS], vr[FA_LOADS];
#pragma unroll
            for (int u = 0; u < FA_LOADS; ++u) {
                const int i = base + u * FA_THREADS + tid;
                kr[u] = vr[u] = 0.f;
                if (i < tile_el && g0 + i < kv_el) {
                    kr[u] = to_f(kb[g0 + i]);
                    vr[u] = to_f(vb[g0 + i]);
                }
            }
#pragma unroll
            for (int u = 0; u < FA_LOADS; ++u) {
                const int i = base + u * FA_THREADS + tid;
                if (i < tile_el) {
                    k_s[i + i / D] = kr[u];       // row c at c * (D + 1)
                    v_s[i] = vr[u];
                }
            }
        }
        __syncthreads();

        const int col = kt * FA_BK + lane;
        float kdc = 1.f, vdc = 1.f;
        if (QUANT && col < M) {
            kdc = kdb[col];
            vdc = vdb[col];
        }
        for (int r = warp; r < BR && row0 + r < rows; r += FA_WARPS) {
            float s = 0.f;
            for (int d = 0; d < D; ++d) s = fmaf(q_s[r * D + d], k_s[lane * (D + 1) + d], s);
            if (QUANT) s = s * kdc;
            s = s * scale;
            if (softcap != 0.f) s = tanhf(s * inv_softcap) * softcap;
            const int qpos = p0 + (row0 + r) / G;
            if (!(col <= qpos && col < M)) s = NEG_INF;
            const float m_prev = m_s[r];
            const float m_next = fmaxf(m_prev, warp_max(s));
            const float alpha = expf(m_prev - m_next);
            float p = expf(s - m_next);
            const float psum = warp_sum(p);
            __syncwarp();
            if (lane == 0) {
                l_s[r] = l_s[r] * alpha + psum;
                m_s[r] = m_next;
                a_s[r] = alpha;
            }
            if (QUANT) p = p * vdc;
            p_s[r * FA_BK + lane] = p;
        }
        __syncthreads();

#pragma unroll
        for (int r = 0; r < BR; ++r) {
            if (row0 + r >= rows) break;  // padding rows of the last tile
            const float alpha = a_s[r];
#pragma unroll
            for (int j = 0; j < FA_MAX_D / FA_THREADS; ++j) {
                const int d = tid + j * FA_THREADS;
                if (d < D) {
                    float pv = 0.f;
#pragma unroll 8
                    for (int c = 0; c < FA_BK; ++c) pv = fmaf(p_s[r * FA_BK + c], v_s[c * D + d], pv);
                    acc[r][j] = acc[r][j] * alpha + pv;
                }
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < BR; ++r) {
        const int R = row0 + r;
        if (R >= rows) break;
        const float l = l_s[r];
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        const int n = R / G;
        const int h = kvh * G + (R - n * G);
        float* o = out + (((size_t)b * H + h) * N + n) * D;
#pragma unroll
        for (int j = 0; j < FA_MAX_D / FA_THREADS; ++j) {
            const int d = tid + j * FA_THREADS;
            if (d < D) o[d] = acc[r][j] * inv;
        }
    }
}

template <int BR, typename KV, bool QUANT>
static int launch(const float* q, const void* k, const void* v, const float* kd,
                  const float* vd, const int* pos, float* out, int B, int H,
                  int KVH, int N, int M, int D, long long kv_stride,
                  long long sc_stride, float scale, float softcap,
                  float inv_softcap, cudaStream_t stream) {
    const size_t smem = sizeof(float) *
        ((size_t)BR * D + (size_t)FA_BK * (D + 1) + (size_t)FA_BK * D +
         (size_t)BR * FA_BK + 3 * BR);
    auto kern = flash_fwd_kernel<BR, KV, QUANT>;
    static bool attr_set = false;
    if (!attr_set) {
        const size_t max_smem = sizeof(float) *
            ((size_t)BR * FA_MAX_D + (size_t)FA_BK * (FA_MAX_D + 1) +
             (size_t)FA_BK * FA_MAX_D + (size_t)BR * FA_BK + 3 * BR);
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    const int rows = N * (H / KVH);
    dim3 grid(B * KVH, (rows + BR - 1) / BR);
    kern<<<grid, FA_THREADS, smem, stream>>>(
        q, (const KV*)k, (const KV*)v, kd, vd, pos, out, H, KVH, N, M, D,
        kv_stride, sc_stride, scale, softcap, inv_softcap);
    return (int)cudaGetLastError();
}

template <int BR>
static int dispatch_kv(int kv_type, const float* q, const void* k, const void* v,
                       const float* kd, const float* vd, const int* pos,
                       float* out, int B, int H, int KVH, int N, int M, int D,
                       long long kv_stride, long long sc_stride, float scale,
                       float softcap, float inv_softcap, cudaStream_t stream) {
    switch (kv_type) {
        case 0:
            return launch<BR, float, false>(q, k, v, kd, vd, pos, out, B, H, KVH, N, M, D,
                                            kv_stride, sc_stride, scale, softcap, inv_softcap, stream);
        case 1:
            return launch<BR, __nv_bfloat16, false>(q, k, v, kd, vd, pos, out, B, H, KVH, N, M, D,
                                                    kv_stride, sc_stride, scale, softcap, inv_softcap,
                                                    stream);
        case 2:
            return launch<BR, int8_t, true>(q, k, v, kd, vd, pos, out, B, H, KVH, N, M, D,
                                            kv_stride, sc_stride, scale, softcap, inv_softcap, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// kv_type: 0 f32, 1 bf16, 2 int8 (kd/vd required). q/out f32 contiguous
// (B, H, N, D); pos int32 (B,) on the device. D <= 256.
extern "C" int flash_attn_fwd(const float* q, const void* k, const void* v,
                              const float* kd, const float* vd, const int* pos,
                              float* out, int B, int H, int KVH, int N, int M,
                              int D, long long kv_stride, long long sc_stride,
                              float scale, float softcap, float inv_softcap,
                              int kv_type, void* stream) {
    if (D > FA_MAX_D || H % KVH != 0 || M < 1) return (int)cudaErrorInvalidValue;
    const int rows = N * (H / KVH);
    cudaStream_t s = (cudaStream_t)stream;
    if (rows <= 4)
        return dispatch_kv<4>(kv_type, q, k, v, kd, vd, pos, out, B, H, KVH, N, M, D,
                              kv_stride, sc_stride, scale, softcap, inv_softcap, s);
    return dispatch_kv<16>(kv_type, q, k, v, kd, vd, pos, out, B, H, KVH, N, M, D,
                           kv_stride, sc_stride, scale, softcap, inv_softcap, s);
}
