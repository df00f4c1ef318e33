// K4: the Q6_K fused dequant + matmul for Hopper (sm_90a).
//
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q6_K (_q6k_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T at every M. Q6_K has no int8 twin, so
// this kernel runs the decode rows and the prefill rows, the head's among
// them (the head of eight of the ten file recipes, and attn_v / ffn_down in
// half the layers of the Q4_K_M and Q5_K_M files).
//
// Weight layout (ggml wire order, struct of arrays; the Q6K format of
// qmm_f32_tiled.cuh gives it in full): ql (N, K/2) u8, qh (N, K/4) u8, sc
// (N, K/16) i8, d (N, K/256) f32: 6.625 bits per weight. w = (q - 32) *
// (d*sc), formed with __fmul_rn as the plain dequantization forms it, so
// the weights equal it bit for bit.
//
// The body is qmm_f32_tiled.cuh's, shared with K7; the entry point picks
// its kernel by M (fuller notes there):
// - M <= 8 (decode): `small_kernel`, lanes over the K chunks, 2 weight rows
//   per warp, x staged per 32 chunks in shared memory (2 x MT x 4 KB).
//   Bound: the weight bytes (0.83 B per weight, read once: 0.0324 ms for the 32000 x 4096 head
//   on the H100), then latency. At most 128 registers.
// - M > 8 (prefill, the engine's chunks): `tiled_kernel`, a 64 x 16 (32 x
//   32 at M <= 32) block tile, x and the dequantized weights staged in 224
//   (160) KB of shared memory, 128 accumulators per lane; or, at M > 32
//   where its 64 x 64 tiles keep more than half of the SMs busy,
//   `tree_kernel`, lanes as outputs, 64 KB of shared memory. Bound at M =
//   128: the f32 FMA rate (2*M*N*K flops at 67 TFLOP/s: 0.50 ms for the head),
//   then shared memory and the L2 traffic of x. The ptxas lines that
//   chip_smoke.py prints give each kernel's registers and spills.
// Reduction order: 32 slots, slot l summing chunks c ≡ l (mod 32) in
// order, then the xor-butterfly tree; fixed by K alone, so a row's bits do
// not depend on M or on the kernel (qmm_f32_tiled.cuh). No atomics, no
// split-K, no TF32.
//
// Returns the cudaError_t of the launch (0 = success).

#include "qmm_f32_tiled.cuh"

extern "C" int qmm_q6k_f32(const float* x, const uint8_t* ql, const uint8_t* qh,
                           const int8_t* sc, const float* d, float* y,
                           int M, int N, int K, void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q6K>(x, {ql, qh, sc, d}, y, M, N, K, stream);
}
