// S1, S2, S3: the IQ grid-search quantizers on the card, wire bytes equal
// to the reference's.
//
// S1 iq3_search (IQ3_XXS, IQ3_S), S2 iq2_search (IQ2_XXS, IQ2_XS, IQ2_S) and
// S3 iq1_search (IQ1_S, IQ1_M) replace no TPU kernel: the JAX package runs
// these searches as per-super-block numpy loops
// (ggml_gfx906_tpu/quant/iquants.py::_quantize_iq3 :351, quantize_iq3_s
// :482, quantize_iq2_xxs :648, quantize_iq2_xs :748, quantize_iq2_s :857,
// quantize_iq1_s :983, quantize_iq1_m :1100; ggml's quantize_row_iq*_impl).
// They are the port's counterpart of those loops; their plain versions are
// quant/iquants.py's quantize_iq*.
//
// Bound: operations, and of a kind the tensor cores do not do. Per scale
// sub-block a thread sweeps 13-31 candidate scales (iq1: all 1122 or 612
// splits of the sorted sub-block), each snapping 2-8 groups to the lattice
// and, off it, scanning a neighbour list (up to 292 points) with a
// sequential sum per point. The f32 input and the wire bytes out are a few
// bytes per weight, far below what the arithmetic costs.
//
// Design:
// - One thread per scale sub-block (32 elements for iq3_xxs, iq3_s,
//   iq2_xxs, iq1_s; 16 for iq2_xs, iq2_s, iq1_m), 64 threads a block, so a
//   block holds whole super-blocks (8 or 4). The phases, split by
//   __syncthreads: one thread per super-block sums x² (sigma2); every thread
//   searches its sub-block; one thread per super-block runs the epilogue
//   (max_scale, d, the 4- or 3-bit scale codes, iq1_m's block-global refit)
//   and writes the block's bytes, zeros included.
// - Inside a thread every sum runs left to right, every candidate sweep in
//   the reference's order with its strict-greater update, every argmin
//   keeps the first minimum: none is split across threads, since a parallel
//   argmax of sumqx²/sumq2 picks another candidate on near-ties.
// - Exactness: this source is built with --fmad=false (ops/cuda/build.py's
//   per-source flags), so no a*b+c is contracted into an FMA and every
//   product and sum rounds as numpy's f32 does; division and sqrtf keep
//   nvcc's correctly rounded defaults. nearest_int is np.rint's round half
//   to even, and its int32 cast gives INT_MIN outside int32 or on NaN, as
//   x86 does (rint_i32). f16 is __float2half_rn. The constants are the f32
//   roundings of the reference's decimals, as hex literals.
// - x, the weights, |x| (xval) and sqrt(w) of a sub-block are staged in
//   shared memory, element-major ([element][thread]) so that a warp's
//   accesses fall on 32 banks. The lattice tables are read-only in global
//   memory (L2-resident, at most ~3 MB): the grid as int8, kmap as int32,
//   the neighbour lists as uint16.
//
// The wrapper (ops/cuda/iq_search.py) checks shapes and devices, uploads
// the tables once per device, and raises if the launcher does not return 0.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace iqs {

constexpr int kThreads = 64;
constexpr int kQK = 256;

struct Tables {
  const int8_t* grid;      // (S, dim) odd coordinates 2l + 1
  const int* kmap;         // packed point -> grid index, or -(list start + 1)
  const uint16_t* neigh;   // [count, index...] per point off the grid
  int kmap_size;
};

struct Args {
  const float* x;          // (nsb, 256) f32
  const float* qw;         // the importance row as (qw_nsb, 256), or null
  int qw_nsb;
  long long nsb;
  uint8_t* out;            // (nsb, block bytes)
  Tables t;
};

// np.rint(v).astype(np.int32) on x86: round half to even; INT_MIN outside
// int32 and on NaN.
__device__ __forceinline__ int rint_i32(float v) {
  return fabsf(v) < 2147483648.0f ? __float2int_rn(v) : (int)0x80000000;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint16_t f16_bits(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

__device__ __forceinline__ int kmap_at(const Tables& t, int u) {
  return (u >= 0 && u < t.kmap_size) ? t.kmap[u] : -1;
}

// The codebook values of a grid coordinate: the coordinate itself (iq2,
// iq3) or its level through x_p / x_m (iq1).
struct GridValue {
  __device__ __forceinline__ float operator()(int g) const { return (float)g; }
};
struct Iq1Value {
  bool minus;
  __device__ __forceinline__ float operator()(int g) const {
    const int l = (g - 1) >> 1;
    return minus ? (l == 0 ? -1.125f : (l == 1 ? -0.125f : 0.875f))
                 : (l == 0 ? -0.875f : (l == 1 ? 0.125f : 1.125f));
  }
};

// The first minimum of sum_i w_i (scale v_i - x_i)^2 over the neighbour
// list of the packed point u (off the grid); x and w strided by kThreads.
template <int DIM, class V>
__device__ int best_neighbour(const Tables& t, int u, const float* xv, const float* w,
                              float scale, V value) {
  const int start = -t.kmap[u] - 1;
  const int n = t.neigh[start];
  int besti = t.neigh[start + 1];
  float best = INFINITY;
  for (int p = 0; p < n; ++p) {
    const int gi = t.neigh[start + 1 + p];
    const int8_t* g = t.grid + gi * DIM;
    float d2 = 0.0f;
    for (int i = 0; i < DIM; ++i) {
      const float diff = scale * value(g[i]) - xv[i * kThreads];
      const float term = (w[i * kThreads] * diff) * diff;
      d2 = i == 0 ? term : d2 + term;
    }
    if (d2 < best) {
      best = d2;
      besti = gi;
    }
  }
  return besti;
}

// sigma2 = (2?)·Σx²/256 of super-block ibl, the sum left to right.
__device__ __forceinline__ float sigma2_of(const float* xs, bool twice) {
  float s = xs[0] * xs[0];
  for (int j = 1; j < kQK; ++j) s = s + xs[j] * xs[j];
  return (twice ? s * 2.0f : s) / 256.0f;
}

// ------------------------------------------------------------- S1 and S2

// What the iq2 / iq3 searches differ in (the reference's five functions).
struct Iq3xxs {
  static constexpr int BSZ = 32, DIM = 4, BITS = 3, KMAXQ = 8, IS_LO = -15, IS_HI = 15;
  static constexpr bool FOLD = true, QP = false, ON_GRID_INIT = false, SKIP_ON_GRID = true;
  static constexpr bool DEAD_EQ0 = false, SIGMA_TWICE = true, SIGMA_FALLBACK = false;
  static constexpr float STEP = 0x1.99999ap-3f, EPS = 0x1.5798eep-27f;   // 0.2, 1e-8
};
struct Iq3s {
  static constexpr int BSZ = 32, DIM = 4, BITS = 3, KMAXQ = 8, IS_LO = -9, IS_HI = 9;
  static constexpr bool FOLD = false, QP = false, ON_GRID_INIT = false, SKIP_ON_GRID = false;
  static constexpr bool DEAD_EQ0 = true, SIGMA_TWICE = true, SIGMA_FALLBACK = false;
  static constexpr float STEP = 0x1.99999ap-3f, EPS = 0.0f;
};
struct Iq2xxs {
  static constexpr int BSZ = 32, DIM = 8, BITS = 2, KMAXQ = 3, IS_LO = -6, IS_HI = 6;
  static constexpr bool FOLD = true, QP = true, ON_GRID_INIT = true, SKIP_ON_GRID = false;
  static constexpr bool DEAD_EQ0 = false, SIGMA_TWICE = false, SIGMA_FALLBACK = false;
  static constexpr float STEP = 0x1.99999ap-4f, EPS = 0x1.203afap-50f;   // 0.1, 1e-15
};
struct Iq2xs {
  static constexpr int BSZ = 16, DIM = 8, BITS = 2, KMAXQ = 3, IS_LO = -9, IS_HI = 9;
  static constexpr bool FOLD = true, QP = false, ON_GRID_INIT = true, SKIP_ON_GRID = true;
  static constexpr bool DEAD_EQ0 = false, SIGMA_TWICE = false, SIGMA_FALLBACK = false;
  static constexpr float STEP = 0x1.99999ap-4f, EPS = 0x1.203afap-50f;
};
struct Iq2s {
  static constexpr int BSZ = 16, DIM = 8, BITS = 2, KMAXQ = 3, IS_LO = -9, IS_HI = 9;
  static constexpr bool FOLD = false, QP = false, ON_GRID_INIT = true, SKIP_ON_GRID = true;
  static constexpr bool DEAD_EQ0 = false, SIGMA_TWICE = true, SIGMA_FALLBACK = true;
  static constexpr float STEP = 0x1.99999ap-4f, EPS = 0x1.5798eep-27f;   // 1e-8
};

template <class P>
struct GridSmem {
  static constexpr int SUBS = kQK / P::BSZ, SBS = kThreads / SUBS, G = P::BSZ / P::DIM;
  float xval[P::BSZ][kThreads];
  float w[P::BSZ][kThreads];
  float waux[P::BSZ][kThreads];
  int8_t lc[P::BSZ][kThreads];        // the candidate's levels
  int8_t lb[P::BSZ][kThreads];        // the best levels
  float sigma2[SBS];
  float scale[kThreads];
  uint16_t gidx[kThreads][G];
  uint32_t signs[kThreads];           // the sign words, 8 bits apart
};

template <class P>
__device__ void grid_sigma(const Args& a, GridSmem<P>& s, int block, int tid) {
  constexpr int SUBS = GridSmem<P>::SUBS;
  const long long ibl = (long long)block * GridSmem<P>::SBS + tid / SUBS;
  if (tid % SUBS == 0 && ibl < a.nsb)
    s.sigma2[tid / SUBS] = sigma2_of(a.x + ibl * kQK, P::SIGMA_TWICE);
}

// make_qp_quants (nmax = KMAXQ + 1) of iq2_xxs on the thread's xval and w,
// levels into lb (then clipped to the grid's 0..KMAXQ-1, as the plain
// version does: larger ones reach the packing only where the reference
// raises); returns the scale.
template <class P>
__device__ float make_qp(GridSmem<P>& s, int tid) {
  constexpr int N = P::BSZ, NMAX = P::KMAXQ + 1;
  int8_t L[N];
  float maxv = s.xval[0][tid];
  for (int j = 1; j < N; ++j) maxv = s.xval[j][tid] > maxv ? s.xval[j][tid] : maxv;
  if (maxv < 0x1.203afap-50f) {
    for (int j = 0; j < N; ++j) s.lb[j][tid] = 0;
    return 0.0f;
  }
  float iscale = (float)NMAX / maxv;
  float best_mse = 0.0f;
  {
    const float sc = 1.0f / iscale;
    for (int j = 0; j < N; ++j) {
      const float xj = s.xval[j][tid];
      const float diff = xj - sc * (float)rint_i32(iscale * xj);
      const float term = (s.w[j][tid] * diff) * diff;
      best_mse = j == 0 ? term : best_mse + term;
    }
  }
  for (int is = -4; is <= 4; ++is) {
    if (is == 0) continue;
    const float isc = (0x1.99999ap-4f * (float)is + (float)NMAX) / maxv;
    const float sc = 1.0f / isc;
    float mse = 0.0f;
    for (int j = 0; j < N; ++j) {
      const float xj = s.xval[j][tid];
      const int l = min(rint_i32(isc * xj), NMAX);
      const float diff = xj - sc * (float)l;
      const float term = (s.w[j][tid] * diff) * diff;
      mse = j == 0 ? term : mse + term;
    }
    if (mse < best_mse) {
      best_mse = mse;
      iscale = isc;
    }
  }
  float sumlx = 0.0f, suml2 = 0.0f;
  for (int j = 0; j < N; ++j) {
    const float xj = s.xval[j][tid], wj = s.w[j][tid];
    L[j] = (int8_t)min(rint_i32(iscale * xj), NMAX);
    const float lf = (float)L[j];
    sumlx = j == 0 ? (wj * xj) * lf : sumlx + (wj * xj) * lf;
    suml2 = j == 0 ? (wj * lf) * lf : suml2 + (wj * lf) * lf;
  }
  for (int it = 0; it < 5; ++it) {
    int changed = 0;
    for (int i = 0; i < N; ++i) {
      const float wi = s.w[i][tid], xi = s.xval[i][tid], li = (float)L[i];
      float slx = sumlx - (wi * xi) * li;
      float sl2 = suml2 - (wi * li) * li;
      if (slx > 0.0f && sl2 > 0.0f) {
        const int nl = min(rint_i32((xi * sl2) / slx), NMAX);
        if (nl != L[i]) {
          const float nf = (float)nl;
          slx = slx + (wi * xi) * nf;
          sl2 = sl2 + (wi * nf) * nf;
          if ((slx * slx) * suml2 > (sumlx * sumlx) * sl2) {
            L[i] = (int8_t)nl;
            sumlx = slx;
            suml2 = sl2;
            ++changed;
          }
        }
      }
    }
    if (!changed) break;
  }
  for (int j = 0; j < N; ++j) s.lb[j][tid] = (int8_t)clampi(L[j], 0, P::KMAXQ - 1);
  return suml2 > 0.0f ? sumlx / suml2 : 0.0f;
}

// Snap the levels `l` of group g to the lattice: on the grid, its index;
// off it, the best neighbour's, whose levels replace the group's.
template <class P>
__device__ __forceinline__ int snap_group(const Tables& t, GridSmem<P>& s, int8_t (*l)[kThreads],
                                          int g, float scale, int tid, bool* on) {
  int u = 0;
  for (int i = 0; i < P::DIM; ++i) u |= (int)l[g * P::DIM + i][tid] << (P::BITS * i);
  int gi = kmap_at(t, u);
  *on = gi >= 0;
  if (gi < 0) {
    gi = best_neighbour<P::DIM>(t, u, &s.xval[g * P::DIM][tid], &s.waux[g * P::DIM][tid], scale,
                                GridValue());
    for (int i = 0; i < P::DIM; ++i) l[g * P::DIM + i][tid] = (int8_t)((t.grid[gi * P::DIM + i] - 1) >> 1);
  }
  return gi;
}

template <class P>
__device__ __forceinline__ void level_sums(GridSmem<P>& s, int8_t (*l)[kThreads], int tid,
                                           float* sumqx, float* sumq2) {
  float sx = 0.0f, s2 = 0.0f;
  for (int j = 0; j < P::BSZ; ++j) {
    const float q = 2.0f * (float)l[j][tid] + 1.0f;
    const float wj = s.w[j][tid];
    const float tx = (wj * s.xval[j][tid]) * q, t2 = (wj * q) * q;
    sx = j == 0 ? tx : sx + tx;
    s2 = j == 0 ? t2 : s2 + t2;
  }
  *sumqx = sx;
  *sumq2 = s2;
}

template <class P>
__device__ void grid_sub(const Args& a, GridSmem<P>& s, int block, int tid) {
  constexpr int SUBS = GridSmem<P>::SUBS, G = GridSmem<P>::G, BSZ = P::BSZ, TOP = P::KMAXQ - 1;
  const long long ibl = (long long)block * GridSmem<P>::SBS + tid / SUBS;
  const int ib = tid % SUBS;
  s.scale[tid] = 0.0f;
  s.signs[tid] = 0;
  for (int g = 0; g < G; ++g) s.gidx[tid][g] = 0;
  if (ibl >= a.nsb) return;
  const Tables& t = a.t;
  const float* xb = a.x + ibl * kQK + ib * BSZ;
  const float* qw = a.qw ? a.qw + (ibl % a.qw_nsb) * kQK + ib * BSZ : nullptr;
  const float sigma2 = s.sigma2[tid / SUBS];
  for (int j = 0; j < BSZ; ++j) {
    const float xj = xb[j];
    float wj;
    if (qw) wj = qw[j] * sqrtf(sigma2 + xj * xj);
    else if (P::SIGMA_FALLBACK) wj = sigma2 * 0.25f + xj * xj;
    else wj = xj * xj;
    s.w[j][tid] = wj;
    s.waux[j][tid] = sqrtf(wj);
    s.xval[j][tid] = fabsf(xj);
  }
  // the signs: a byte per 8-group; folded (iq3_xxs, iq2_xxs, iq2_xs) to
  // even parity by negating the least important element, 7 bits kept
  uint32_t signs = 0;
  for (int k = 0; k < BSZ / 8; ++k) {
    int bits = 0, count = 0;
    for (int i = 0; i < 8; ++i)
      if (xb[8 * k + i] < 0.0f) {
        bits |= 1 << i;
        ++count;
      }
    if (P::FOLD && (count & 1)) {
      int imin = 0;
      float amin = 0.0f;
      for (int i = 0; i < 8; ++i) {
        const float xi = xb[8 * k + i];
        const float ax = (s.w[8 * k + i][tid] * xi) * xi;
        if (i == 0 || ax < amin) {
          amin = ax;
          imin = i;
        }
      }
      s.xval[8 * k + imin][tid] = -s.xval[8 * k + imin][tid];
      bits ^= 1 << imin;
    }
    signs |= (uint32_t)(P::FOLD ? bits & 127 : bits) << (8 * k);
  }
  float maxv = s.xval[0][tid];
  for (int j = 1; j < BSZ; ++j) maxv = s.xval[j][tid] > maxv ? s.xval[j][tid] : maxv;
  if (P::DEAD_EQ0 ? maxv == 0.0f : maxv < P::EPS) return;

  float scale, denom;
  unsigned on_grid = P::ON_GRID_INIT ? (1u << G) - 1 : 0u;
  if (P::QP) {
    scale = make_qp<P>(s, tid);
    denom = scale * (float)P::KMAXQ;
  } else {
    scale = maxv / (float)(2 * P::KMAXQ - 1);
    denom = maxv;
    for (int j = 0; j < BSZ; ++j) s.lb[j][tid] = 0;
  }
  float best = 0.0f;
  for (int is = P::IS_LO; is <= P::IS_HI; ++is) {
    const float id = ((float)(2 * P::KMAXQ - 1) + (float)is * P::STEP) / denom;
    const float this_scale = 1.0f / id;
    for (int j = 0; j < BSZ; ++j)
      s.lc[j][tid] = (int8_t)clampi(rint_i32(0.5f * (id * s.xval[j][tid] - 1.0f)), 0, TOP);
    unsigned on_aux = 0;
    for (int g = 0; g < G; ++g) {
      bool on;
      snap_group<P>(t, s, s.lc, g, this_scale, tid, &on);
      on_aux |= (unsigned)on << g;
    }
    float sumqx, sumq2;
    level_sums<P>(s, s.lc, tid, &sumqx, &sumq2);
    if (sumq2 > 0.0f && sumqx * sumqx > best * sumq2) {
      scale = sumqx / sumq2;
      best = scale * sumqx;
      for (int j = 0; j < BSZ; ++j) s.lb[j][tid] = s.lc[j][tid];
      on_grid = on_aux;
    }
  }
  // the refit at the best scale: iq2_xxs and iq3_s redo every group,
  // the others only those off the grid, if any
  const bool redo = P::QP ? scale > 0.0f : (on_grid != (1u << G) - 1 && scale > 0.0f);
  if (redo) {
    const float id = 1.0f / scale;
    for (int g = 0; g < G; ++g) {
      if (!P::QP && P::SKIP_ON_GRID && (on_grid >> g & 1)) continue;
      for (int i = 0; i < P::DIM; ++i) {
        const int j = g * P::DIM + i;
        s.lb[j][tid] = (int8_t)clampi(rint_i32(0.5f * (id * s.xval[j][tid] - 1.0f)), 0, TOP);
      }
      bool on;
      snap_group<P>(t, s, s.lb, g, scale, tid, &on);
    }
    float sumqx, sumq2;
    level_sums<P>(s, s.lb, tid, &sumqx, &sumq2);
    if (sumq2 > 0.0f) scale = sumqx / sumq2;
  }
  if (scale < 0.0f) {
    scale = -scale;
    const uint32_t mask = P::FOLD ? 0x7F7F7F7Fu : 0xFFFFFFFFu;
    signs = ~signs & mask & (BSZ == 32 ? 0xFFFFFFFFu : 0xFFFFu);
  }
  for (int g = 0; g < G; ++g) {
    int u = 0;
    for (int i = 0; i < P::DIM; ++i) u |= (int)s.lb[g * P::DIM + i][tid] << (P::BITS * i);
    const int gi = kmap_at(t, u);
    s.gidx[tid][g] = (uint16_t)(gi < 0 ? 0 : gi);
  }
  s.scale[tid] = scale;
  s.signs[tid] = signs;
}

// d = max_scale / 31 and a sub-block's 4-bit code.
__device__ __forceinline__ int scale_code(float id, float scale, int top) {
  return clampi(rint_i32(0.5f * (id * scale - 1.0f)), 0, top);
}

__device__ __forceinline__ void put16(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
}
__device__ __forceinline__ void put32(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; ++i) p[i] = (uint8_t)(v >> (8 * i));
}

template <class P>
__device__ void grid_epilogue(const Args& a, GridSmem<P>& s, int block, int tid);

template <>
__device__ void grid_epilogue<Iq3xxs>(const Args& a, GridSmem<Iq3xxs>& s, int block, int tid) {
  const long long ibl = (long long)block * 8 + tid / 8;
  if (tid % 8 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 98;
  float mx = 0.0f;
  for (int ib = 0; ib < 8; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  const float d = mx / 31.0f, id = 1.0f / d;
  put16(o, mx == 0.0f ? 0 : f16_bits(d * 0x1.033334p+0f));     // 1.0125
  for (int ib = 0; ib < 8; ++ib) {
    const int r = tid + ib;
    for (int k = 0; k < 8; ++k) o[2 + 8 * ib + k] = (uint8_t)s.gidx[r][k];
    const uint32_t sg = s.signs[r];
    uint32_t sas = (sg & 127) | ((sg >> 8 & 127) << 7) | ((sg >> 16 & 127) << 14) |
                   ((sg >> 24 & 127) << 21);
    if (mx != 0.0f) sas |= (uint32_t)scale_code(id, s.scale[r], 15) << 28;
    put32(o + 66 + 4 * ib, sas);
  }
}

template <>
__device__ void grid_epilogue<Iq3s>(const Args& a, GridSmem<Iq3s>& s, int block, int tid) {
  const long long ibl = (long long)block * 8 + tid / 8;
  if (tid % 8 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 110;
  float mx = 0.0f;
  for (int ib = 0; ib < 8; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  const float d = mx / 31.0f, id = 1.0f / d;
  put16(o, mx == 0.0f ? 0 : f16_bits(d * 0x1.0872b0p+0f));     // 1.033
  for (int ib = 0; ib < 8; ++ib) {
    const int r = tid + ib;
    int qh = 0;
    for (int k = 0; k < 8; ++k) {
      o[2 + 8 * ib + k] = (uint8_t)s.gidx[r][k];
      qh |= (s.gidx[r][k] >> 8) << k;
    }
    o[66 + ib] = (uint8_t)qh;
    put32(o + 74 + 4 * ib, s.signs[r]);
  }
  for (int j = 0; j < 4; ++j) {
    const int l1 = mx == 0.0f ? 0 : scale_code(id, s.scale[tid + 2 * j], 15);
    const int l2 = mx == 0.0f ? 0 : scale_code(id, s.scale[tid + 2 * j + 1], 15);
    o[106 + j] = (uint8_t)(l1 | (l2 << 4));
  }
}

template <>
__device__ void grid_epilogue<Iq2xxs>(const Args& a, GridSmem<Iq2xxs>& s, int block, int tid) {
  const long long ibl = (long long)block * 8 + tid / 8;
  if (tid % 8 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 66;
  float mx = 0.0f;
  for (int ib = 0; ib < 8; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  const float d = mx / 31.0f, id = 1.0f / d;
  put16(o, mx == 0.0f ? 0 : f16_bits(d));
  for (int ib = 0; ib < 8; ++ib) {
    const int r = tid + ib;
    uint32_t w0 = 0, w1 = 0;
    if (mx != 0.0f) {
      for (int k = 0; k < 4; ++k) {
        w0 |= (uint32_t)s.gidx[r][k] << (8 * k);
        w1 |= ((s.signs[r] >> (8 * k)) & 127) << (7 * k);
      }
      w1 |= (uint32_t)scale_code(id, s.scale[r], 15) << 28;
    }
    put32(o + 2 + 8 * ib, w0);
    put32(o + 6 + 8 * ib, w1);
  }
}

template <>
__device__ void grid_epilogue<Iq2xs>(const Args& a, GridSmem<Iq2xs>& s, int block, int tid) {
  const long long ibl = (long long)block * 4 + tid / 16;
  if (tid % 16 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 74;
  float mx = 0.0f;
  for (int ib = 0; ib < 16; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  const float d = mx / 31.0f, id = 1.0f / d;
  put16(o, mx == 0.0f ? 0 : f16_bits(d));
  for (int ib = 0; ib < 16; ++ib) {
    const int r = tid + ib;
    for (int k = 0; k < 2; ++k)
      put16(o + 2 + 2 * (2 * ib + k),
            mx == 0.0f ? 0 : s.gidx[r][k] | (((s.signs[r] >> (8 * k)) & 127) << 9));
  }
  for (int j = 0; j < 8; ++j) {
    const int l1 = mx == 0.0f ? 0 : scale_code(id, s.scale[tid + 2 * j], 15);
    const int l2 = mx == 0.0f ? 0 : scale_code(id, s.scale[tid + 2 * j + 1], 15);
    o[66 + j] = (uint8_t)(l1 | (l2 << 4));
  }
}

template <>
__device__ void grid_epilogue<Iq2s>(const Args& a, GridSmem<Iq2s>& s, int block, int tid) {
  const long long ibl = (long long)block * 4 + tid / 16;
  if (tid % 16 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 82;
  float mx = 0.0f;
  for (int ib = 0; ib < 16; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  const float d = mx / 31.0f, id = 1.0f / d;
  put16(o, mx == 0.0f ? 0 : f16_bits(d * 0x1.f9999ap-1f));     // 0.9875
  for (int j = 0; j < 8; ++j) o[66 + j] = 0;
  for (int ib = 0; ib < 16; ++ib) {
    const int r = tid + ib;
    for (int k = 0; k < 2; ++k) {
      const int i8 = 2 * ib + k;
      o[2 + i8] = (uint8_t)s.gidx[r][k];
      o[34 + i8] = (uint8_t)(s.signs[r] >> (8 * k));
      o[66 + i8 / 4] |= (uint8_t)((s.gidx[r][k] >> 8) << (2 * (i8 % 4)));
    }
  }
  for (int j = 0; j < 8; ++j) {
    const int l1 = mx == 0.0f ? 0 : scale_code(id, s.scale[tid + 2 * j], 15);
    const int l2 = mx == 0.0f ? 0 : scale_code(id, s.scale[tid + 2 * j + 1], 15);
    o[74 + j] = (uint8_t)(l1 | (l2 << 4));
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads) grid_kernel(Args a) {
  __shared__ GridSmem<P> s;
  grid_sigma<P>(a, s, blockIdx.x, threadIdx.x);
  __syncthreads();
  grid_sub<P>(a, s, blockIdx.x, threadIdx.x);
  __syncthreads();
  grid_epilogue<P>(a, s, blockIdx.x, threadIdx.x);
}

// ------------------------------------------------------------------- S3

template <bool M>
struct Iq1Smem {
  static constexpr int BSZ = M ? 16 : 32, SUBS = kQK / BSZ, SBS = kThreads / SUBS;
  float xs[BSZ][kThreads];
  float w[BSZ][kThreads];
  float sa[BSZ + 1][kThreads];        // iq1_s: prefix sums of w·x; iq1_m: sorted w
  float sb[BSZ + 1][kThreads];        // iq1_s: prefix sums of w;   iq1_m: sorted x
  uint8_t order[BSZ][kThreads];
  int8_t l[BSZ][kThreads];
  float sigma2[SBS];
  float scale[kThreads];
  int8_t shift[kThreads];             // iq1_s: +1 / -1; iq1_m: the combination 0..3
  uint16_t gidx[kThreads][BSZ / 8];
};

template <bool M>
__device__ void iq1_sigma(const Args& a, Iq1Smem<M>& s, int block, int tid) {
  constexpr int SUBS = Iq1Smem<M>::SUBS;
  const long long ibl = (long long)block * Iq1Smem<M>::SBS + tid / SUBS;
  if (tid % SUBS == 0 && ibl < a.nsb) s.sigma2[tid / SUBS] = sigma2_of(a.x + ibl * kQK, true);
}

// The iq1 weight of element j: with an importance row qw·sqrt(sigma2 + x²),
// else x² (iq1_m; iq1_s requires the row).
__device__ __forceinline__ float iq1_weight(const float* qw, int j, float sigma2, float xj) {
  return qw ? qw[j] * sqrtf(sigma2 + xj * xj) : xj * xj;
}

template <bool M>
__device__ void iq1_sub(const Args& a, Iq1Smem<M>& s, int block, int tid) {
  constexpr int BSZ = Iq1Smem<M>::BSZ, SUBS = Iq1Smem<M>::SUBS, G = BSZ / 8;
  const long long ibl = (long long)block * Iq1Smem<M>::SBS + tid / SUBS;
  const int ib = tid % SUBS;
  s.scale[tid] = 0.0f;
  s.shift[tid] = 0;
  for (int g = 0; g < G; ++g) s.gidx[tid][g] = 0;
  if (ibl >= a.nsb) return;
  const Tables& t = a.t;
  const float* xb = a.x + ibl * kQK + ib * BSZ;
  const float* qw = a.qw ? a.qw + (ibl % a.qw_nsb) * kQK + ib * BSZ : nullptr;
  const float sigma2 = s.sigma2[tid / SUBS];
  float maxv = 0.0f;
  for (int j = 0; j < BSZ; ++j) {
    const float xj = xb[j];
    s.xs[j][tid] = xj;
    s.w[j][tid] = iq1_weight(qw, j, sigma2, xj);
    const float ax = fabsf(xj);
    maxv = j == 0 || ax > maxv ? ax : maxv;
  }
  if (maxv < (M ? 0x1.ad7f2ap-24f : 0x1.197998p-40f)) return;      // 1e-7, 1e-12
  // a stable sort of the sub-block (insertion on <: -0.0 == 0.0)
  for (int j = 0; j < BSZ; ++j) s.order[j][tid] = (uint8_t)j;
  for (int i = 1; i < BSZ; ++i) {
    const uint8_t key = s.order[i][tid];
    const float kv = s.xs[key][tid];
    int j = i - 1;
    while (j >= 0 && kv < s.xs[s.order[j][tid]][tid]) {
      s.order[j + 1][tid] = s.order[j][tid];
      --j;
    }
    s.order[j + 1][tid] = key;
  }
  float best = -INFINITY, scale = maxv;
  int pick = -1;
  if (!M) {
    // prefix sums over the sorted sub-block, from 0
    s.sa[0][tid] = 0.0f;
    s.sb[0][tid] = 0.0f;
    for (int j = 0; j < BSZ; ++j) {
      const int o = s.order[j][tid];
      s.sa[j + 1][tid] = s.sa[j][tid] + s.w[o][tid] * s.xs[o][tid];
      s.sb[j + 1][tid] = s.sb[j][tid] + s.w[o][tid];
    }
    const float x0 = s.sa[0][tid], w0 = s.sb[0][tid], xn = s.sa[BSZ][tid], wn = s.sb[BSZ][tid];
    int c = 0;
    for (int i1 = 0; i1 <= BSZ; ++i1) {
      const float x1 = s.sa[i1][tid], w1 = s.sb[i1][tid];
      for (int i2 = i1; i2 <= BSZ; ++i2) {
        const float x2 = s.sa[i2][tid], w2 = s.sb[i2][tid];
        const float a0 = x1 - x0, b0 = x2 - x1, c0 = xn - x2;
        const float aw = w1 - w0, bw = w2 - w1, cw = wn - w2;
        for (int sh = 0; sh < 2; ++sh, ++c) {
          const float v0 = sh ? -1.125f : -0.875f, v1 = sh ? -0.125f : 0.125f,
                      v2 = sh ? 0.875f : 1.125f;
          const float sumqx = (a0 * v0 + b0 * v1) + c0 * v2;
          const float sumq2 = ((aw * v0) * v0 + (bw * v1) * v1) + (cw * v2) * v2;
          if (sumq2 > 0.0f && sumqx * sumqx > best * sumq2) {
            scale = sumqx / sumq2;
            best = scale * sumqx;
            pick = c;
          }
        }
      }
    }
  } else {
    unsigned lower = 0;
    for (int j = 0; j < BSZ; ++j) {
      const int o = s.order[j][tid];
      s.sa[j][tid] = s.w[o][tid];
      s.sb[j][tid] = s.xs[o][tid];
      lower |= (unsigned)(o < BSZ / 2) << j;
    }
    int c = 0;
    for (int i1 = 0; i1 <= BSZ; ++i1)
      for (int i2 = i1; i2 <= BSZ; ++i2)
        for (int k = 0; k < 4; ++k, ++c) {
          const bool first_m = k >= 2, second_m = k % 2 == 1;
          float sumqx = 0.0f, sumq2 = 0.0f;
          for (int j = 0; j < BSZ; ++j) {
            const int lv = (j >= i1) + (j >= i2);
            const bool minus = (lower >> j & 1) ? first_m : second_m;
            const float q = minus ? (lv == 0 ? -1.125f : (lv == 1 ? -0.125f : 0.875f))
                                  : (lv == 0 ? -0.875f : (lv == 1 ? 0.125f : 1.125f));
            const float wq = s.sa[j][tid] * q;
            const float tx = wq * s.sb[j][tid], t2 = wq * q;
            sumqx = j == 0 ? tx : sumqx + tx;
            sumq2 = j == 0 ? t2 : sumq2 + t2;
          }
          if (sumq2 > 0.0f && sumqx * sumqx > best * sumq2) {
            scale = sumqx / sumq2;
            best = scale * sumqx;
            pick = c;
          }
        }
  }
  if (pick < 0) pick = 0;     // no candidate won: the reference asserts there
  const int per = M ? 4 : 2;
  int pair = pick / per, i1 = 0, i2 = 0;
  for (int p = 0, a1 = 0; a1 <= BSZ; ++a1)
    for (int a2 = a1; a2 <= BSZ; ++a2, ++p)
      if (p == pair) {
        i1 = a1;
        i2 = a2;
      }
  int sel = M ? pick % 4 : (pick % 2 ? -1 : 1);
  for (int j = 0; j < BSZ; ++j) s.l[s.order[j][tid]][tid] = (int8_t)((j >= i1) + (j >= i2));
  if (scale < 0.0f) {
    for (int j = 0; j < BSZ; ++j) s.l[j][tid] = (int8_t)(2 - s.l[j][tid]);
    scale = -scale;
    sel = M ? 3 - sel : -sel;
  }
  bool any_off = false;
  int gidx[G];
  bool minus[G];
  for (int g = 0; g < G; ++g) {
    minus[g] = M ? (g == 0 ? sel >= 2 : sel % 2 == 1) : sel == -1;
    int u = 0;
    for (int i = 0; i < 8; ++i) u |= (int)s.l[8 * g + i][tid] << (2 * i);
    int gi = kmap_at(t, u);
    if (gi < 0) {
      any_off = true;
      gi = best_neighbour<8>(t, u, &s.xs[8 * g][tid], &s.w[8 * g][tid], scale, Iq1Value{minus[g]});
    }
    gidx[g] = gi;
  }
  if (any_off) {
    float sumqx = 0.0f, sumq2 = 0.0f;
    for (int g = 0; g < G; ++g) {
      const Iq1Value v{minus[g]};
      float sx = 0.0f, s2 = 0.0f;
      for (int i = 0; i < 8; ++i) {
        const float q = v(t.grid[gidx[g] * 8 + i]);
        const float wq = s.w[8 * g + i][tid] * q;
        const float tx = wq * s.xs[8 * g + i][tid], t2 = wq * q;
        sx = i == 0 ? tx : sx + tx;
        s2 = i == 0 ? t2 : s2 + t2;
      }
      sumqx = sumqx + sx;
      sumq2 = sumq2 + s2;
    }
    if (sumqx > 0.0f && sumq2 > 0.0f) scale = sumqx / sumq2;
  }
  s.scale[tid] = scale;
  s.shift[tid] = (int8_t)sel;
  for (int g = 0; g < G; ++g) s.gidx[tid][g] = (uint16_t)gidx[g];
}

template <bool M>
__device__ void iq1_epilogue(const Args& a, Iq1Smem<M>& s, int block, int tid);

template <>
__device__ void iq1_epilogue<false>(const Args& a, Iq1Smem<false>& s, int block, int tid) {
  const long long ibl = (long long)block * 8 + tid / 8;
  if (tid % 8 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 50;
  float mx = 0.0f;
  for (int ib = 0; ib < 8; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  const float d = mx / 15.0f, id = 1.0f / d;
  put16(o, mx == 0.0f ? 0 : f16_bits(d * 1.125f));
  for (int ib = 0; ib < 8; ++ib) {
    const int r = tid + ib;
    uint32_t h = 0;
    for (int k = 0; k < 4; ++k) {
      o[2 + 4 * ib + k] = (uint8_t)s.gidx[r][k];
      h |= (uint32_t)(s.gidx[r][k] >> 8) << (3 * k);
    }
    if (mx != 0.0f) h |= (uint32_t)(scale_code(id, s.scale[r], 7) | (s.shift[r] == -1 ? 8 : 0)) << 12;
    put16(o + 34 + 2 * ib, h);
  }
}

template <>
__device__ void iq1_epilogue<true>(const Args& a, Iq1Smem<true>& s, int block, int tid) {
  const long long ibl = (long long)block * 4 + tid / 16;
  if (tid % 16 || ibl >= a.nsb) return;
  uint8_t* o = a.out + ibl * 56;
  float mx = 0.0f;
  for (int ib = 0; ib < 16; ++ib) mx = s.scale[tid + ib] > mx ? s.scale[tid + ib] : mx;
  for (int ib = 0; ib < 16; ++ib) {
    const int r = tid + ib;
    o[2 * ib] = (uint8_t)s.gidx[r][0];
    o[2 * ib + 1] = (uint8_t)s.gidx[r][1];
    int qh = (s.gidx[r][0] >> 8) | ((s.gidx[r][1] >> 8) << 4);
    if (mx != 0.0f) qh |= s.shift[r] == 1 ? 0x80 : (s.shift[r] == 2 ? 0x08 : (s.shift[r] == 3 ? 0x88 : 0));
    o[32 + ib] = (uint8_t)qh;
  }
  if (mx == 0.0f) {
    for (int j = 0; j < 8; ++j) o[48 + j] = 0;
    return;
  }
  // the block-global refit of d over every group, in order, at the coded
  // sub-block scales
  float d = mx / 15.0f;
  const float id = 1.0f / d;
  const float* xs = a.x + ibl * kQK;
  const float* qw = a.qw ? a.qw + (ibl % a.qw_nsb) * kQK : nullptr;
  const float sigma2 = s.sigma2[tid / 16];
  uint32_t sc[4] = {0, 0, 0, 0};
  float sumqx = 0.0f, sumq2 = 0.0f;
  for (int ib = 0; ib < 16; ++ib) {
    const int r = tid + ib, l = scale_code(id, s.scale[r], 7);
    sc[ib / 4] |= (uint32_t)l << (3 * (ib % 4));
    const float mult = (float)(2 * l + 1);
    for (int k = 0; k < 2; ++k) {
      const Iq1Value v{k == 0 ? s.shift[r] >= 2 : s.shift[r] % 2 == 1};
      float sx = 0.0f, s2 = 0.0f;
      for (int i = 0; i < 8; ++i) {
        const int j = 16 * ib + 8 * k + i;
        const float xj = xs[j];
        const float wj = iq1_weight(qw, j, sigma2, xj);
        const float gq = v(a.t.grid[s.gidx[r][k] * 8 + i]) * mult;
        const float wq = wj * gq;
        const float tx = wq * xj, t2 = wq * gq;
        sx = i == 0 ? tx : sx + tx;
        s2 = i == 0 ? t2 : s2 + t2;
      }
      sumqx = sumqx + sx;
      sumq2 = sumq2 + s2;
    }
  }
  if (sumq2 > 0.0f) d = sumqx / sumq2;
  const uint32_t su = f16_bits(d * 0x1.1cccccp+0f);     // 1.1125
  sc[0] |= (su & 0x000F) << 12;
  sc[1] |= (su & 0x00F0) << 8;
  sc[2] |= (su & 0x0F00) << 4;
  sc[3] |= su & 0xF000;
  for (int j = 0; j < 4; ++j) put16(o + 48 + 2 * j, sc[j]);
}

template <bool M>
__global__ void __launch_bounds__(kThreads) iq1_kernel(Args a) {
  __shared__ Iq1Smem<M> s;
  iq1_sigma<M>(a, s, blockIdx.x, threadIdx.x);
  __syncthreads();
  iq1_sub<M>(a, s, blockIdx.x, threadIdx.x);
  __syncthreads();
  iq1_epilogue<M>(a, s, blockIdx.x, threadIdx.x);
}

}  // namespace iqs

// ------------------------------------------------------------- launchers

namespace {

iqs::Args make_args(const void* x, const void* qw, int qw_nsb, long long nsb, void* out,
                    const void* grid, const void* kmap, const void* neigh, int kmap_size) {
  return iqs::Args{(const float*)x, (const float*)qw, qw_nsb, nsb, (uint8_t*)out,
                   iqs::Tables{(const int8_t*)grid, (const int*)kmap, (const uint16_t*)neigh,
                               kmap_size}};
}

unsigned grid_blocks(long long nsb, int per_block) {
  return (unsigned)((nsb + per_block - 1) / per_block);
}

}  // namespace

// type 0: IQ3_XXS (the 256-point tables), 1: IQ3_S (512)
extern "C" int iq3_search(int type, const void* x, const void* qw, int qw_nsb, long long nsb,
                          void* out, const void* grid, const void* kmap, const void* neigh,
                          int kmap_size, void* stream) {
  if (nsb <= 0 || nsb > 0x3fffffffLL || type < 0 || type > 1) return (int)cudaErrorInvalidValue;
  const iqs::Args a = make_args(x, qw, qw_nsb, nsb, out, grid, kmap, neigh, kmap_size);
  cudaStream_t st = (cudaStream_t)stream;
  if (type == 0) iqs::grid_kernel<iqs::Iq3xxs><<<grid_blocks(nsb, 8), iqs::kThreads, 0, st>>>(a);
  else iqs::grid_kernel<iqs::Iq3s><<<grid_blocks(nsb, 8), iqs::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// type 0: IQ2_XXS, 1: IQ2_XS, 2: IQ2_S
extern "C" int iq2_search(int type, const void* x, const void* qw, int qw_nsb, long long nsb,
                          void* out, const void* grid, const void* kmap, const void* neigh,
                          int kmap_size, void* stream) {
  if (nsb <= 0 || nsb > 0x3fffffffLL || type < 0 || type > 2) return (int)cudaErrorInvalidValue;
  const iqs::Args a = make_args(x, qw, qw_nsb, nsb, out, grid, kmap, neigh, kmap_size);
  cudaStream_t st = (cudaStream_t)stream;
  if (type == 0) iqs::grid_kernel<iqs::Iq2xxs><<<grid_blocks(nsb, 8), iqs::kThreads, 0, st>>>(a);
  else if (type == 1) iqs::grid_kernel<iqs::Iq2xs><<<grid_blocks(nsb, 4), iqs::kThreads, 0, st>>>(a);
  else iqs::grid_kernel<iqs::Iq2s><<<grid_blocks(nsb, 4), iqs::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// type 0: IQ1_S, 1: IQ1_M
extern "C" int iq1_search(int type, const void* x, const void* qw, int qw_nsb, long long nsb,
                          void* out, const void* grid, const void* kmap, const void* neigh,
                          int kmap_size, void* stream) {
  if (nsb <= 0 || nsb > 0x3fffffffLL || type < 0 || type > 1) return (int)cudaErrorInvalidValue;
  const iqs::Args a = make_args(x, qw, qw_nsb, nsb, out, grid, kmap, neigh, kmap_size);
  cudaStream_t st = (cudaStream_t)stream;
  if (type == 0) iqs::iq1_kernel<false><<<grid_blocks(nsb, 8), iqs::kThreads, 0, st>>>(a);
  else iqs::iq1_kernel<true><<<grid_blocks(nsb, 4), iqs::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
