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
// Design: the TPU kernel streams wire bytes through a manual DMA ring into
// VMEM and sums with the MXU. Here each block first stages x once in shared
// memory, as bf16 in the order the qs bytes are read (so a warp's 16-byte
// reads are contiguous), with its 16-element f32 sums; then each warp
// streams K10_ROWS rows at a time with 16-byte loads, K10_SPANS chunks per
// row in flight before any arithmetic, and sums nibble * bf16(x) in f32
// FMAs (the nibbles become floats by the exponent trick, not by integer
// conversions). Blocks stay resident and walk over row groups, so x is
// staged once per block, not once per row group. wgmma, TMA and warp
// specialisation are later work.

#define K10_WARPS 8
#define K10_ROWS 2
#define K10_SPANS 4      // 16-byte qs chunks per row loaded at once
#define K10_BLOCKS_PER_SM 2

__device__ __forceinline__ float nib(uint32_t v) {   // 0 <= v < 16, exact
    return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.f);
}

__device__ __forceinline__ float bf(uint32_t bits16) {
    return __uint_as_float(bits16 << 16);
}

// x16: 4 arrays of K/4 bf16 bits: [k][c*8 + i] for chunk c (16 qs bytes)
// with k = 2*high + (i >= 8): the low (k = 0, 1) and high (k = 2, 3)
// nibbles' x values of the chunk. xsum: [c*2 + high], the f32 sums of the
// chunk's 16 low- and 16 high-nibble x values.
__global__ void __launch_bounds__(K10_WARPS * 32, K10_BLOCKS_PER_SM)
qmm_q4k_pipe_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
                    const uint8_t* __restrict__ scm, const float* __restrict__ dd,
                    float* __restrict__ y, int N, int K) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* x16 = reinterpret_cast<uint16_t*>(smem);
    float* xsum = reinterpret_cast<float*>(smem + (size_t)K * 2);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int chunks = K / 32;
    const int nb = K / 256;
    const int quarter = K / 4;

    // stage x: thread t takes elements 4t..4t+3 (one 16-element run per 4
    // threads, which K % 256 == 0 keeps inside whole warps)
    for (int t0 = 0; t0 < quarter; t0 += blockDim.x) {
        const int t = t0 + tid;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < quarter) v = *reinterpret_cast<const float4*>(x + 4 * (size_t)t);
        float s = __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
        if (t < quarter) {
            const int e = 4 * t;
            const int r = e & 255, g = r >> 6, high = (r >> 5) & 1, j = r & 31;
            const int c = (e >> 8) * 8 + g * 2 + (j >> 4);
            const int i = j & 15;
            const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
            const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
            uint2 packed;
            packed.x = *reinterpret_cast<const uint32_t*>(&a);
            packed.y = *reinterpret_cast<const uint32_t*>(&b);
            *reinterpret_cast<uint2*>(x16 + (size_t)(2 * high + (i >> 3)) * quarter + c * 8 + (i & 7)) = packed;
            if ((t & 3) == 0) xsum[c * 2 + high] = s;
        }
    }
    __syncthreads();

    const int groups = (N + K10_WARPS * K10_ROWS - 1) / (K10_WARPS * K10_ROWS);
    for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
        const int n0 = (grp * K10_WARPS + warp) * K10_ROWS;
        float acc[K10_ROWS], mn[K10_ROWS];
#pragma unroll
        for (int r = 0; r < K10_ROWS; ++r) { acc[r] = 0.f; mn[r] = 0.f; }

        for (int c0 = lane; c0 < chunks; c0 += 32 * K10_SPANS) {
            uint4 q16[K10_ROWS][K10_SPANS];
            uint32_t scw[K10_ROWS][K10_SPANS];   // sc_2g | sc_2g+1 << 8 | m_2g << 16 | m_2g+1 << 24
            float2 dv[K10_ROWS][K10_SPANS];
#pragma unroll
            for (int j = 0; j < K10_SPANS; ++j) {
                const int c = c0 + 32 * j;
                const int sb = c >> 3, g = (c & 7) >> 1;
#pragma unroll
                for (int r = 0; r < K10_ROWS; ++r) {
                    const int n = n0 + r;
                    const bool ok = n < N && c < chunks;
                    q16[r][j] = ok ? *reinterpret_cast<const uint4*>(qs + (size_t)n * (K / 2) + (size_t)c * 16)
                                   : make_uint4(0u, 0u, 0u, 0u);
                    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(
                        scm + ((size_t)n * nb + sb) * 16);
                    scw[r][j] = ok ? (uint32_t)s16[g] | ((uint32_t)s16[4 + g] << 16) : 0u;
                    dv[r][j] = ok ? *reinterpret_cast<const float2*>(dd + ((size_t)n * nb + sb) * 2)
                                  : make_float2(0.f, 0.f);
                }
            }
#pragma unroll
            for (int j = 0; j < K10_SPANS; ++j) {
                const int c = c0 + 32 * j;
                if (c >= chunks) continue;
                uint4 xk[4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    xk[k] = *reinterpret_cast<const uint4*>(x16 + (size_t)k * quarter + c * 8);
                const float2 xs = *reinterpret_cast<const float2*>(xsum + c * 2);
#pragma unroll
                for (int r = 0; r < K10_ROWS; ++r) {
                    const uint32_t qw[4] = {q16[r][j].x, q16[r][j].y, q16[r][j].z, q16[r][j].w};
                    float slo = 0.f, shi = 0.f;
#pragma unroll
                    for (int i = 0; i < 16; ++i) {
                        const uint32_t b = (qw[i >> 2] >> (8 * (i & 3))) & 0xFFu;
                        const uint4 xl = xk[i >> 3], xh = xk[2 + (i >> 3)];
                        const uint32_t wl[4] = {xl.x, xl.y, xl.z, xl.w};
                        const uint32_t wh[4] = {xh.x, xh.y, xh.z, xh.w};
                        const uint32_t pl = wl[(i & 7) >> 1], ph = wh[(i & 7) >> 1];
                        const uint32_t bl = (i & 1) ? (pl >> 16) : (pl & 0xFFFFu);
                        const uint32_t bh = (i & 1) ? (ph >> 16) : (ph & 0xFFFFu);
                        slo = fmaf(nib(b & 0xFu), bf(bl), slo);
                        shi = fmaf(nib(b >> 4), bf(bh), shi);
                    }
                    const uint32_t sw = scw[r][j];
                    const float d = dv[r][j].x, dmin = dv[r][j].y;
                    const float t = __fmaf_rn((float)(sw & 0xFFu), slo,
                                              __fmul_rn((float)((sw >> 8) & 0xFFu), shi));
                    acc[r] = __fmaf_rn(d, t, acc[r]);
                    mn[r] = __fmaf_rn(__fmul_rn((float)((sw >> 16) & 0xFFu), dmin), xs.x, mn[r]);
                    mn[r] = __fmaf_rn(__fmul_rn((float)(sw >> 24), dmin), xs.y, mn[r]);
                }
            }
        }

#pragma unroll
        for (int r = 0; r < K10_ROWS; ++r) {
            float a = acc[r], m = mn[r];
            // butterfly: every lane ends with the same bits (a+b == b+a)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                a += __shfl_xor_sync(0xffffffffu, a, off);
                m += __shfl_xor_sync(0xffffffffu, m, off);
            }
            const int n = n0 + r;
            if (lane == 0 && n < N) y[n] = __fsub_rn(a, m);
        }
    }
}

extern "C" int qmm_q4k_pipe(const float* x, const uint8_t* qs, const uint8_t* scm,
                            const float* dd, float* y, int N, int K, void* stream) {
    static int sms[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64 && sms[dev] == 0) {
        err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    const int n_sm = dev < 64 ? sms[dev] : 132;
    const size_t smem = (size_t)K * 2 + (size_t)(K / 16) * 4;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(qmm_q4k_pipe_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int groups = (N + K10_WARPS * K10_ROWS - 1) / (K10_WARPS * K10_ROWS);
    const int blocks = groups < n_sm * K10_BLOCKS_PER_SM ? groups : n_sm * K10_BLOCKS_PER_SM;
    qmm_q4k_pipe_kernel<<<blocks, K10_WARPS * 32, smem, (cudaStream_t)stream>>>(
        x, qs, scm, dd, y, N, K);
    return (int)cudaGetLastError();
}
