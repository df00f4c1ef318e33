// Q4_K single-stream decode matvec with bf16 activations for Hopper (sm_90a).
//
// Q4_K weight layout: as csrc/qmm_q4k.cu (ggml wire order, struct of arrays):
//   qs  (N, nb*128) u8 : byte 32*g + j of a superblock holds element
//                        64*g + j in its low nibble (sub-block 2g) and
//                        64*g + 32 + j in its high nibble (sub-block 2g+1)
//   scm (N, nb*16)  u8 : unpacked 6-bit [sc0..sc7 | m0..m7]
//   dd  (N, nb*2)   f32: [d, dmin]
// It computes what the reference's pipelined kernel computes, which is not
// K1's function: x is rounded to bf16 (round half to even) for the quant
// sums, and the scales are applied to per-(row, group) partial sums:
//   y[n] = sum_g d*(sc_2g*S_lo[g] + sc_2g+1*S_hi[g])
//        - sum_g dmin*(m_2g*X_lo[g] + m_2g+1*X_hi[g])
// where S are sums of nibble * bf16(x) (exact products, f32 sums) and X are
// sums of the f32 x. The min term is computed here, in the same pass over
// scm and dd (the reference computes it outside its kernel).
//
// Deterministic: each output element is summed by one warp in an order fixed
// by K alone. No atomics, no split-K.
//
// Returns the cudaError_t of the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ------------------------------------------------------------------ K10
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_K_pipelined
// (_q4k_pipe_kernel): y (1, N) f32 for a (1, K) x, the Q4_K decode matvec
// behind `qmm_pipeline`.
// Bound on the H100: bytes. The packed weight stream is ~0.59 B per weight
// (0.5 qs + 1/16 scm + 1/32 dd), read once; the FMAs are 2 flops per weight.
// Design: the Hopper counterpart of the TPU kernel's DMA ring into VMEM
// (qmm.py:240-320, its `slots`, `sem` and `qs_s`). One persistent block per
// SM owns an even share of the N rows, contiguous, and walks it in tiles of
// TN rows. A tile's rows are contiguous in each array, so one tile is three
// 1-D bulk copies (cp.async.bulk, no tensor map): qs TN*K/2 bytes, scm
// TN*K/16, dd TN*K/32, every address and size a multiple of 16 (K % 256 ==
// 0, and tiles start on even rows: a dd row is K/32 bytes, a multiple of 8).
// A producer warp's first thread issues them into a ring of two stages in
// shared memory, with a "full" mbarrier per stage that carries
// the stage's byte count; C consumer warps wait on it, sum from shared
// memory and arrive on the stage's "empty" mbarrier, which the producer
// waits on before it refills the stage. So a stage costs one thread four
// instructions, where the earlier design issued three loads per 16 bytes
// of qs in every lane and waited on them. The producer sets up the barriers and
// fills the ring before anything else; meanwhile the consumers stage x once
// per block in shared memory (16 loads in flight a thread) as f32 values
// rounded to bf16, in the order the qs bytes are read (a warp's 16-byte
// reads are contiguous), with its 16-element f32 sums.
// Consumer warp w takes R rows of each tile; lane l sums the chunks (16
// qs bytes, 32 weights) c = l, l + 32, ... of each row in ascending order,
// nibble * x in f32 FMAs (the nibbles become floats by the exponent trick,
// not by integer conversions), loading the next chunk from shared memory
// into a second set of registers while it sums the current one; the
// per-chunk sums are scaled and the 32 lanes meet in an xor butterfly. That
// is the order of the earlier design (lanes over chunks, 16-byte register
// loads), so the outputs keep its bits.
// Shapes: <C, R> = <8, 2> (TN = 16) where two such stages fit beside x
// (K <= 9984; K = 4096: 38 KB stages beside 17 KB of x); else <4, 2> (TN =
// 8, K <= 16896; K = 11008: 52 KB stages beside 47 KB of x); else <2, 1>
// (TN = 2) for K up to 34816. Two rows a warp halve x's shared-memory reads per weight. A third
// stage, a split qs copy, 7 warps of 14 rows at K = 11008 or one row a warp
// streamed no faster (scripts/torch_m1_chain.py's chain); the time left
// above the bytes is the start of each call (the first stage's latency)
// and the sums of the last tile, which nothing overlaps. FP32 FMA on
// the CUDA cores (wgmma has nothing to do at M = 1). N must be even.

namespace q4k_pipe {
namespace {   // internal linkage: two builds loaded in one process keep their own statics

constexpr int STAGES = 2;                         // the ring's stages
constexpr int XBATCH = 16;                        // x loads in flight per thread while staging
constexpr int BAR_BYTES = 16 * STAGES;            // full[STAGES], empty[STAGES]

// ---- PTX: mbarriers and bulk copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// ---- end of PTX

// byte i of v as a float, exact: the byte under the exponent of 2^23
// (e23 = 0x4B000000). e23 comes in a register: given two constants, ptxas
// puts 0x4B000000 in the immediate slot and spends a move on the selector
// of every byte_perm (cuobjdump -sass shows one beside each PRMT).
__device__ __forceinline__ float byte_float(uint32_t v, int i, uint32_t e23) {
    return __fsub_rn(__uint_as_float(__byte_perm(v, e23, 0x7540u | i)), 8388608.f);
}

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// shared memory: the barriers, x as xf[v][c] float4 (v = 0..3: elements
// 4v..4v+3 of chunk c's low-nibble run, v = 4..7 of its high-nibble run),
// xsum[c][half], then the ring: per stage qs [TN][K/2], scm [TN][K/16], dd
// [TN][K/32] bytes
__host__ __device__ inline size_t fixed_bytes(int K) {
    return (size_t)BAR_BYTES + (size_t)K * 4 + (size_t)K / 4;
}
__host__ __device__ inline size_t row_bytes(int K) {
    return (size_t)K / 2 + (size_t)K / 16 + (size_t)K / 32;
}

// One chunk of R rows as a lane reads it from shared memory.
template <int R>
struct Chunk {
    float4 x[8];
    float2 xs;
    uint4 q[R];
    uint32_t sc[R], mm[R];   // [sc_2g | sc_2g+1 << 8], [m_2g | m_2g+1 << 8]
    float2 dv[R];            // [d, dmin]
};

// The sums of chunk ch of R rows into acc and mn, in the earlier design's
// order.
template <int R>
__device__ __forceinline__ void sum_chunk(const Chunk<R>& ch, float (&acc)[R], float (&mn)[R],
                                          uint32_t e23) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const uint32_t qw[4] = {ch.q[r].x, ch.q[r].y, ch.q[r].z, ch.q[r].w};
        float slo = 0.f, shi = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const uint32_t lo = qw[w] & 0x0F0F0F0Fu, hi = (qw[w] >> 4) & 0x0F0F0F0Fu;
            const float xl[4] = {ch.x[w].x, ch.x[w].y, ch.x[w].z, ch.x[w].w};
            const float xh[4] = {ch.x[4 + w].x, ch.x[4 + w].y, ch.x[4 + w].z, ch.x[4 + w].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                slo = fmaf(byte_float(lo, i, e23), xl[i], slo);
                shi = fmaf(byte_float(hi, i, e23), xh[i], shi);
            }
        }
        const uint32_t sc = ch.sc[r], mm = ch.mm[r];
        const float d = ch.dv[r].x, dmin = ch.dv[r].y;
        const float tt = __fmaf_rn(byte_float(sc, 0, e23), slo,
                                   __fmul_rn(byte_float(sc, 1, e23), shi));
        acc[r] = __fmaf_rn(d, tt, acc[r]);
        mn[r] = __fmaf_rn(__fmul_rn(byte_float(mm, 0, e23), dmin), ch.xs.x, mn[r]);
        mn[r] = __fmaf_rn(__fmul_rn(byte_float(mm, 1, e23), dmin), ch.xs.y, mn[r]);
    }
}

template <int C, int R>
__global__ void __launch_bounds__((C + 1) * 32, 1)
pipe_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
            const uint8_t* __restrict__ scm, const float* __restrict__ dd,
            float* __restrict__ y, int N, int K) {
    constexpr int TN = C * R;
    extern __shared__ __align__(16) uint8_t smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + STAGES;
    const int chunks = K / 32;
    float4* xf = reinterpret_cast<float4*>(smem + BAR_BYTES);
    float* xsum = reinterpret_cast<float*>(xf + 8 * chunks);
    uint8_t* ring = smem + fixed_bytes(K);
    const size_t qrow = K / 2, srow = K / 16, drow = K / 32;
    const size_t stage_bytes = (size_t)TN * row_bytes(K);

    // the block's rows: an even share of N, contiguous
    const int pairs = N / 2;
    const int row0 = 2 * (int)((long long)pairs * blockIdx.x / gridDim.x);
    const int rows = 2 * (int)((long long)pairs * (blockIdx.x + 1) / gridDim.x) - row0;
    const int tiles = (rows + TN - 1) / TN;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const uint32_t e23 = 0x4B000000u | ((uint32_t)N >> 31);    // N > 0: a register holding 2^23

    // tile t of the block's rows into stage t % STAGES
    auto issue = [&](int t) {
        const int s = t % STAGES;
        const size_t n = (size_t)row0 + (size_t)t * TN;
        const uint32_t cnt = min(TN, rows - t * TN);
        uint8_t* st = ring + s * stage_bytes;
        mbar_expect_tx(&full[s], cnt * (uint32_t)row_bytes(K));
        bulk_copy(st, qs + n * qrow, cnt * (uint32_t)qrow, &full[s]);
        bulk_copy(st + TN * qrow, scm + n * srow, cnt * (uint32_t)srow, &full[s]);
        bulk_copy(st + TN * (qrow + srow), reinterpret_cast<const uint8_t*>(dd) + n * drow,
                  cnt * (uint32_t)drow, &full[s]);
    };
    // the producer thread sets up the barriers and fills the empty ring
    // first, so that the weights stream while the consumers stage x
    if (warp == C && lane == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], C);
        }
        mbar_fence_init();
        for (int t = 0; t < tiles && t < STAGES; ++t) issue(t);
    }

    // stage x: consumer thread t takes elements 4t..4t+3 (one 16-element
    // run per 4 threads, which K % 256 == 0 keeps inside whole warps),
    // XBATCH loads in flight per thread
    const int quarter = warp < C ? K / 4 : 0;
    for (int t0 = 0; t0 < quarter; t0 += XBATCH * C * 32) {
        float4 v[XBATCH];
#pragma unroll
        for (int b = 0; b < XBATCH; ++b) {
            const int t = t0 + b * C * 32 + threadIdx.x;
            v[b] = t < quarter ? __ldg(reinterpret_cast<const float4*>(x) + t)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int b = 0; b < XBATCH; ++b) {
            const int t = t0 + b * C * 32 + threadIdx.x;
            float s = __fadd_rn(__fadd_rn(v[b].x, v[b].y), __fadd_rn(v[b].z, v[b].w));
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
            if (t < quarter) {
                const int e = 4 * t;
                const int r = e & 255, g = r >> 6, high = (r >> 5) & 1, j = r & 31;
                const int c = (e >> 8) * 8 + g * 2 + (j >> 4);
                xf[(high * 4 + ((j & 15) >> 2)) * chunks + c] =
                    make_float4(bf16_round(v[b].x), bf16_round(v[b].y), bf16_round(v[b].z),
                                bf16_round(v[b].w));
                if ((t & 3) == 0) xsum[c * 2 + high] = s;
            }
        }
    }
    __syncthreads();                          // the barriers set up, x staged

    if (warp == C) {
        // the producer: one thread refills each stage once it is consumed
        if (lane == 0) {
            for (int t = STAGES; t < tiles; ++t) {
                mbar_wait(&empty[t % STAGES], ((t / STAGES) & 1) ^ 1);
                issue(t);
            }
        }
        return;
    }

    for (int t = 0; t < tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        const int cnt = min(TN, rows - t * TN);
        const int r0 = warp * R;              // cnt is even: all R rows, or none
        if (r0 < cnt) {
            const uint8_t* st = ring + s * stage_bytes;
            auto load = [&](Chunk<R>& ch, int c) {
#pragma unroll
                for (int v = 0; v < 8; ++v) ch.x[v] = xf[v * chunks + c];
                ch.xs = *reinterpret_cast<const float2*>(xsum + 2 * c);
                const int sb = c >> 3, g = (c & 7) >> 1;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    ch.q[r] = *reinterpret_cast<const uint4*>(st + (r0 + r) * qrow + 16 * c);
                    const uint8_t* sp = st + TN * qrow + (r0 + r) * srow + 16 * sb;
                    ch.sc[r] = *reinterpret_cast<const uint16_t*>(sp + 2 * g);
                    ch.mm[r] = *reinterpret_cast<const uint16_t*>(sp + 8 + 2 * g);
                    ch.dv[r] = *reinterpret_cast<const float2*>(
                        st + TN * (qrow + srow) + (r0 + r) * drow + 8 * sb);
                }
            };
            float acc[R], mn[R];
#pragma unroll
            for (int r = 0; r < R; ++r) { acc[r] = 0.f; mn[r] = 0.f; }
            // two chunk buffers in turn: the next chunk loads while this one
            // is summed, and no registers are copied between them
            Chunk<R> ca, cb;
            if (lane < chunks) load(ca, lane);
            for (int c = lane; c < chunks; c += 64) {
                if (c + 32 < chunks) load(cb, c + 32);
                sum_chunk<R>(ca, acc, mn, e23);
                if (c + 32 >= chunks) break;
                if (c + 64 < chunks) load(ca, c + 64);
                sum_chunk<R>(cb, acc, mn, e23);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float a = acc[r], m = mn[r];
                // butterfly: every lane ends with the same bits (a+b == b+a)
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    a += __shfl_xor_sync(0xffffffffu, a, off);
                    m += __shfl_xor_sync(0xffffffffu, m, off);
                }
                if (lane == 0) y[row0 + t * TN + r0 + r] = __fsub_rn(a, m);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }
}

int device_attr(cudaDeviceAttr attr, int fallback) {
    static int cache[2][64] = {{0}};
    const int which = attr == cudaDevAttrMultiProcessorCount ? 0 : 1;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return fallback;
    if (cache[which][dev] == 0 &&
        cudaDeviceGetAttribute(&cache[which][dev], attr, dev) != cudaSuccess)
        return fallback;
    return cache[which][dev];
}

// whether the ring's stages of TN rows fit beside x
bool fits(int TN, int K, int cap) {
    return fixed_bytes(K) + (size_t)STAGES * TN * row_bytes(K) <= (size_t)cap;
}

template <int C, int R>
cudaError_t launch(const float* x, const uint8_t* qs, const uint8_t* scm, const float* dd,
                   float* y, int N, int K, cudaStream_t st) {
    const size_t smem = fixed_bytes(K) + (size_t)STAGES * C * R * row_bytes(K);
    const cudaError_t err = cudaFuncSetAttribute(
        pipe_kernel<C, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int n_sm = device_attr(cudaDevAttrMultiProcessorCount, 132);
    const int blocks = N / 2 < n_sm ? N / 2 : n_sm;
    pipe_kernel<C, R><<<blocks, (C + 1) * 32, smem, st>>>(x, qs, scm, dd, y, N, K);
    return cudaGetLastError();
}

}  // namespace
}  // namespace q4k_pipe

// x (1, K), the Q4_K weights (N, K), y (1, N): K % 256 == 0, N even, every
// pointer 16-byte aligned; K too large for two stages of the smallest tile
// (K > 34816) returns cudaErrorInvalidValue.
extern "C" int qmm_q4k_pipe(const float* x, const uint8_t* qs, const uint8_t* scm,
                            const float* dd, float* y, int N, int K, void* stream) {
    using namespace q4k_pipe;
    if (N <= 0 || N % 2 || K <= 0 || K % 256) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int cap = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 232448);
    if (fits(16, K, cap)) return (int)launch<8, 2>(x, qs, scm, dd, y, N, K, st);
    if (fits(8, K, cap)) return (int)launch<4, 2>(x, qs, scm, dd, y, N, K, st);
    if (fits(2, K, cap)) return (int)launch<2, 1>(x, qs, scm, dd, y, N, K, st);
    return (int)cudaErrorInvalidValue;
}
