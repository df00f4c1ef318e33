// K11 dma_copy: a streaming copy y <- x of an f32 array (the autotuner's
// probe of the card's memory stream, utils/autotune.py::dma_gbs).
//
// Replaces ggml_gfx906_tpu/utils/autotune.py::pallas_dma_gbs (its body
// copy_kernel, :173): a (4096, 4096) f32 array copied in (128, 4096) row
// blocks, one grid step each. On the TPU that isolates the HBM->VMEM DMA
// that every Pallas kernel rides on. Here the copy has no reuse: it is bound
// by bytes, each element read once and written once (2 x 64 MiB for the
// probe's array, 0.040 ms at 3.35 TB/s).
//
// Design: the 32 row blocks of the TPU version would be 32 CTAs on 132 SMs,
// so the array is treated as flat instead: one 16-byte float4 load and store
// per thread, neighbour threads on neighbour addresses, and a grid of 256-
// thread blocks that covers the array once (4096 blocks for the probe),
// so that every SM keeps as many loads in flight as its occupancy allows.
// The n % 4 tail floats go to block 0. Measured on the H100 against other
// shapes of the same copy (PERF.md §6, row K11): a grid-stride loop over eight
// blocks per SM with four loads in flight per thread was 7% slower, and
// streaming cache hints (ld/st.global.cs) did not help. The wrapper
// (ops/cuda/dma_copy.py) checks dtype, shape, contiguity and 16-byte
// alignment; the launcher returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dma_copy_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                const float* __restrict__ xs, float* __restrict__ ys,
                long long n4, int tail) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n4) y[i] = x[i];
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const long long j = n4 * 4 + threadIdx.x;
    ys[j] = xs[j];
  }
}

}  // namespace

extern "C" int dma_copy_f32(const void* x, void* y, long long n, void* stream) {
  const long long n4 = n / 4;
  const int tail = (int)(n - n4 * 4);
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dma_copy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)y, (const float*)x, (float*)y, n4, tail);
  return (int)cudaGetLastError();
}
