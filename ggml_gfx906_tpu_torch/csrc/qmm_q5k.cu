// K7: the Q5_K fused dequant + matmul for Hopper (sm_90a).
//
// Replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q5_K (_q5k_kernel):
// y (M, N) f32 = x (M, K) f32 . W^T at every M. Q5_K has no int8 twin, so
// this kernel runs the decode rows and the prefill rows (every matrix of
// the Q5_K_M file but its Q6_K ones, and attn_v / ffn_down of the first
// layers of the Q3_K_M file).
//
// Weight layout (ggml wire order, struct of arrays; the Q5K format of
// qmm_f32_tiled.cuh gives it in full): qs (N, K/2) u8, qh (N, K/8) u8, scm
// (N, K/16) u8 = [sc0..sc7 | m0..m7] per superblock, dd (N, K/128) f32 =
// [d, dmin]: 5.75 bits per weight. w = q * (d*sc) - dmin*m, formed with
// __fmul_rn / __fsub_rn as the plain dequantization forms it, so the
// weights equal it bit for bit.
//
// The body is qmm_f32_tiled.cuh's, shared with K4; the entry point picks
// its kernel by M (fuller notes there):
// - M <= 8 (decode): `small_kernel`, lanes over the K chunks, 2 weight rows
//   per warp, x staged per 32 chunks in shared memory (2 x MT x 4 KB).
//   Bound: the weight bytes (0.72 B per weight, read once: 0.0097 ms for 11008 x 4096
//   on the H100), then latency. At most 128 registers.
// - M > 8 (prefill, the engine's chunks): `tiled_kernel`, a 64 x 16 (32 x
//   32 at M <= 32) block tile, x and the dequantized weights staged in 224
//   (160) KB of shared memory, 128 accumulators per lane; or, at M > 32
//   where its 64 x 64 tiles keep more than half of the SMs busy,
//   `tree_kernel`, lanes as outputs, 64 KB of shared memory. Bound at M =
//   128: the f32 FMA rate (2*M*N*K flops at 67 TFLOP/s: 0.17 ms for 11008 x 4096),
//   then shared memory and the L2 traffic of x. The ptxas lines that
//   chip_smoke.py prints give each kernel's registers and spills.
// Reduction order: 32 slots, slot l summing chunks c ≡ l (mod 32) in
// order, then the xor-butterfly tree; fixed by K alone, so a row's bits do
// not depend on M or on the kernel (qmm_f32_tiled.cuh). No atomics, no
// split-K, no TF32.
//
// Returns the cudaError_t of the launch (0 = success).

#include "qmm_f32_tiled.cuh"

extern "C" int qmm_q5k_f32(const float* x, const uint8_t* qs, const uint8_t* qh,
                           const uint8_t* scm, const float* dd, float* y,
                           int M, int N, int K, void* stream) {
    return qmm_tiled::launch<qmm_tiled::Q5K>(x, {qs, qh, scm, dd}, y, M, N, K, stream);
}
