// Backward of the multi-scale multi-view bilinear sampling over y-fold and
// pair-mode tables (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_sampling.py::_msmv_yfold_bwd (:857), the
// jax.vjp of the all-fp32 half-row primal _msmv_halfrow (:775; run-major twin
// _halfrow_runmajor :701; weights _separable_slot_weights :600; geometry
// _flat_point_geometry :672). On the TPU that VJP is XLA's transposed graph
// (single-row scatter-adds, gathers and reductions); here it is one kernel.
//
// For each point k (query-major order (q, s, p)), its output gradient
// g[k, 0:C] and each level l, with the forward's geometry
//   (sx, ry, wxa, wxb, wya, wyb), lw = sw[k, l], the four table pieces
//   A0 = (row ry, column sx), B0 = (row ry, column sx+1) and A1, B1 the same
//   columns of row ry+1 (y-fold: the second half of the same table row; pair:
//   the next image row, clamped) that the primal reads as
//   val = wxa * (wya*A0 + wyb*A1) + wxb * (wya*B0 + wyb*B1), out += lw * val:
//   (a) table gradient: dA0 += (g * (wxa*lw)) * wya, dA1 += (g * (wxa*lw)) *
//       wyb, dB0 += (g * (wxb*lw)) * wya, dB1 += (g * (wxb*lw)) * wyb (pair
//       levels: g * ((wx*wy) * lw)), the products in JAX's order, each
//       contribution rounded to the table dtype and added in the table dtype,
//       skipped where the weight is 0;
//   (b) d sw[k, l] = g . val;
//   (c) d loc[k, x] += (w-1) * d lx and d loc[k, y] += (h-1) * d ly, from the
//       derivatives of the piecewise-linear slot weights: floor, clip and the
//       in-range masks have zero derivative, so d wx0/d lx = -inx0 and
//       d wx1/d lx = +inx1; at ix0 = -1 the window shift has moved wx1 into
//       the first slot and the derivative moves with it (the same in y).
//       d loc[k, view] = 0: the view goes through round.
// All arithmetic is fp32 (the primal is fp32 whatever the table dtype); g and
// the tables are read in the table dtype (bf16 or fp32).
//
// The table gradient follows the JAX VJP's rounding. There the adjoint of
// take(...).astype(float32) rounds every contribution to bf16 and the
// scatter-add adds in bf16, one rounding per add. Here each lane rounds its
// eight contributions to bf16 (round to nearest even), packs them into four
// bf16x2 and issues one red.global.add.noftz.v4.bf16x2: one 16-byte request
// that adds them into the gradient in the table dtype, each add rounded to
// bf16. Only the order of the adds differs from JAX's, and from run to run.
// fp32 tables take red.global.add.v4.f32 into the fp32 gradient. Either way
// the caller's gradient buffer is added to, with no scratch and no cast: the
// buffer may be shared by every sampling call of a training step.
//
// Bound: bytes. Per call at flagship r50 training (Q = 900 + 640, S = 32,
// P = 4: K = 197,120 points, 4 levels, C = 64, bf16): the table pieces that
// these points touch with a nonzero weight, each read once in bf16 for the
// point gradients and read and written once in bf16 for the table gradient
// (6 bytes a channel), plus g 25 MB and loc / sw and their gradients 11 MB.
// For one recorded r50 layer (876,507 touched pieces) that is 372 MB, 0.111
// ms at 3.35 TB/s; chip_smoke.py computes it from the pieces its points
// really touch. What sets the pace instead is the reductions: without the
// table gradient the kernel reads at the forward's rate, and the 16-byte
// reductions, several into each touched piece, take the rest of its time
// (PERF.md). Binning points by table row, so that a block sums a piece's
// contributions before one reduction, is the next lever.
//
// Design: the forward's lane layout. A group of lanes shares a point, 16
// bytes of a table row per lane (C = 64: 8 lanes in bf16, 16 in fp32), so the
// P = 4 points of one (query, slice) sit in one warp and a warp-level load
// moves 512 bytes. Each lane multiplies its run of g with its runs of the
// four pieces; the four dot products of a level are reduced over the group's
// lanes with xor shuffles, after which every lane of the group holds the
// point's d sw, d lx and d ly and the group's first lane stores them: d loc
// and d sw belong to one point each and need no atomics. The table gradient
// does: points share pieces, so each lane adds its run with one vector
// reduction a piece. The sum order varies from run to run, so the result is
// compared with the plain version within a tolerance, not bit for bit. The
// level count is a template parameter and the level loop is unrolled, so the
// table pointers are read from the kernel parameters at fixed offsets (no
// stack frame). Whole warps run to the end (no early return before the
// shuffles); lanes without a point or a run contribute zeros. Built with
// --fmad=false like the other kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;

struct Levels {
  const void* table[kMaxLevels];
  void* grad[kMaxLevels];  // gradient in the table dtype, or null
  int h[kMaxLevels];
  int w[kMaxLevels];
  int yfold[kMaxLevels];  // 1: rows [w+1, 2c] (y-fold), 0: [w+1, c] (pair)
};

// One lane's 16 bytes of a table row (or of g) as floats.
template <typename T>
struct Run;

template <>
struct Run<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& v, float (&f)[kVec]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <>
struct Run<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& v, float (&f)[kVec]) {
    // a bf16 is the upper half of its fp32
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
    f[4] = __uint_as_float(v.z << 16);
    f[5] = __uint_as_float(v.z & 0xffff0000u);
    f[6] = __uint_as_float(v.w << 16);
    f[7] = __uint_as_float(v.w & 0xffff0000u);
  }
};

__device__ __forceinline__ uint4 load16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// dst[0:4] += (v[0:4] * s) * t in fp32: one 16-byte vector reduction
// (red.global.add.v4.f32), dst 16-byte aligned; skipped where s * t is 0
__device__ __forceinline__ void add_run(float* dst, const float (&v)[4],
                                        float s, float t) {
  if (s == 0.f || t == 0.f) return;
  atomicAdd(reinterpret_cast<float4*>(dst),
            make_float4((v[0] * s) * t, (v[1] * s) * t, (v[2] * s) * t,
                        (v[3] * s) * t));
}

// two fp32 values rounded to bf16 (nearest even) and packed, lo first
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&r);
}

// dst[0:8] += bf16((v[0:8] * s) * t), each add rounded to bf16: one 16-byte
// vector reduction (red.global.add.noftz.v4.bf16x2, sm_90), dst 16-byte
// aligned; skipped where s * t is 0
__device__ __forceinline__ void add_run(__nv_bfloat16* dst,
                                        const float (&v)[8], float s,
                                        float t) {
  if (s == 0.f || t == 0.f) return;
  unsigned r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    r[j] = bf16x2((v[2 * j] * s) * t, (v[2 * j + 1] * s) * t);
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
               ::"l"(__cvta_generic_to_global(dst)), "r"(r[0]), "r"(r[1]),
               "r"(r[2]), "r"(r[3])
               : "memory");
}

template <int kVec>
__device__ __forceinline__ float dot(const float (&a)[kVec],
                                     const float (&b)[kVec]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) s = s + a[j] * b[j];
  return s;
}

// lanes_log2: log2 of the lanes that share a point (a power of two >=
// c * sizeof(T) / 16; lanes past the last run contribute zeros).
template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    msmv_sample_bwd_kernel(const Levels lv, const float* __restrict__ loc,
                           const float* __restrict__ sw,
                           const int* __restrict__ slice_map,
                           const T* __restrict__ gout,
                           float* __restrict__ dloc, float* __restrict__ dsw,
                           unsigned num_points, unsigned s, unsigned p,
                           unsigned n, unsigned g, int c, int lanes_log2,
                           bool want_tables) {
  constexpr int kVec = Run<T>::kVec;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned kk = tid >> lanes_log2;
  const unsigned lane = tid & ((1u << lanes_log2) - 1u);
  const int cc = (int)lane * kVec;
  const bool has_point = kk < num_points;
  const bool live = has_point && cc < c;
  const unsigned k = has_point ? kk : 0u;  // a valid point for the geometry

  const unsigned si = (k / p) % s;
  const float x = __ldg(loc + (size_t)k * 3 + 0);
  const float y = __ldg(loc + (size_t)k * 3 + 1);
  const float v = __ldg(loc + (size_t)k * 3 + 2);
  const float vf = fminf(fmaxf(rintf(v * (float)(n - 1)), 0.f),
                         (float)(n - 1));
  const unsigned view = (unsigned)vf;
  const unsigned phys = (unsigned)__ldg(slice_map + si);
  const unsigned bt = phys / g;
  const unsigned gi = phys % g;
  const unsigned cb = (unsigned)c * (unsigned)sizeof(T);  // C channels' bytes
  const unsigned ccb = (unsigned)cc * (unsigned)sizeof(T);

  float gr[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) gr[j] = 0.f;
  if (live)
    Run<T>::unpack(load16(reinterpret_cast<const char*>(gout) +
                          (uint64_t)k * cb + ccb), gr);

  float dx = 0.f, dy = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    // the forward's geometry (msmv_sample.cu), masks kept for the derivative
    const float xp = fminf(fmaxf(x * (float)(w - 1), -2.f), (float)(w + 1));
    const float yp = fminf(fmaxf(y * (float)(h - 1), -2.f), (float)(h + 1));
    const float x0f = floorf(xp);
    const float y0f = floorf(yp);
    const float lx = xp - x0f;
    const float ly = yp - y0f;
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    const float inx0 = (ix0 >= 0 && ix0 <= w - 1) ? 1.f : 0.f;
    const float inx1 = (ix0 + 1 >= 0 && ix0 + 1 <= w - 1) ? 1.f : 0.f;
    const float iny0 = (iy0 >= 0 && iy0 <= h - 1) ? 1.f : 0.f;
    const float iny1 = (iy0 + 1 >= 0 && iy0 + 1 <= h - 1) ? 1.f : 0.f;
    const float wx0 = (1.f - lx) * inx0;
    const float wx1 = lx * inx1;
    const float wy0 = (1.f - ly) * iny0;
    const float wy1 = ly * iny1;
    const bool shx = ix0 < 0;
    const bool shy = iy0 < 0;
    const int sx = min(max(ix0, 0), w - 1);
    const int ry = min(max(iy0, 0), h - 1);
    const float wxa = shx ? wx1 : wx0;
    const float wxb = shx ? 0.f : wx1;
    const float wya = shy ? wy1 : wy0;
    const float wyb = shy ? 0.f : wy1;
    const float lw = __ldg(sw + (size_t)k * L + l);
    const bool yf = lv.yfold[l] != 0;

    const unsigned row =
        ((bt * n + view) * (unsigned)h + (unsigned)ry) * g + gi;
    const unsigned col = row * (unsigned)(w + 1) + (unsigned)sx;
    // elements between the two columns of a window, and from row ry to row
    // ry+1 (pair levels: clamped at the last row, where wyb is 0)
    const unsigned stepx = yf ? 2u * (unsigned)c : (unsigned)c;
    const unsigned stepy =
        yf ? (unsigned)c
           : (ry < h - 1 ? g * (unsigned)(w + 1) * (unsigned)c : 0u);
    const uint64_t top = (uint64_t)col * stepx + (unsigned)cc;  // elements
    const uint64_t bot = top + stepy;

    float a0[kVec], b0[kVec], a1[kVec], b1[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) a0[j] = b0[j] = a1[j] = b1[j] = 0.f;
    if (live) {
      const char* base = static_cast<const char*>(lv.table[l]);
      Run<T>::unpack(load16(base + top * sizeof(T)), a0);
      Run<T>::unpack(load16(base + (top + stepx) * sizeof(T)), b0);
      Run<T>::unpack(load16(base + bot * sizeof(T)), a1);
      Run<T>::unpack(load16(base + (bot + stepx) * sizeof(T)), b1);
    }

    // g . piece, summed over the lanes of the point
    float da0 = dot<kVec>(gr, a0);
    float db0 = dot<kVec>(gr, b0);
    float da1 = dot<kVec>(gr, a1);
    float db1 = dot<kVec>(gr, b1);
    for (int m = 1; m < (1 << lanes_log2); m <<= 1) {
      da0 = da0 + __shfl_xor_sync(0xffffffffu, da0, m);
      db0 = db0 + __shfl_xor_sync(0xffffffffu, db0, m);
      da1 = da1 + __shfl_xor_sync(0xffffffffu, da1, m);
      db1 = db1 + __shfl_xor_sync(0xffffffffu, db1, m);
    }
    const float ya = wya * da0 + wyb * da1;   // g . (wya*A0 + wyb*A1)
    const float yb = wya * db0 + wyb * db1;
    const float d_lw = wxa * ya + wxb * yb;
    const float d_wxa = lw * ya;
    const float d_wxb = lw * yb;
    const float d_wya = lw * (wxa * da0 + wxb * db0);
    const float d_wyb = lw * (wxa * da1 + wxb * db1);
    // through the window shift: the first slot holds wx1 when shifted
    const float d_wx0 = shx ? 0.f : d_wxa;
    const float d_wx1 = shx ? d_wxa : d_wxb;
    const float d_wy0 = shy ? 0.f : d_wya;
    const float d_wy1 = shy ? d_wya : d_wyb;
    dx = dx + (inx1 * d_wx1 - inx0 * d_wx0) * (float)(w - 1);
    dy = dy + (iny1 * d_wy1 - iny0 * d_wy0) * (float)(h - 1);
    if (has_point && lane == 0) dsw[(size_t)k * L + l] = d_lw;

    if (want_tables && live) {
      T* gbase = static_cast<T*>(lv.grad[l]);
      if (yf) {  // (g * (wx*lw)) * wy, the order of the JAX transpose
        const float ca = wxa * lw;
        const float cbw = wxb * lw;
        add_run(gbase + top, gr, ca, wya);
        add_run(gbase + top + stepx, gr, cbw, wya);
        add_run(gbase + bot, gr, ca, wyb);
        add_run(gbase + bot + stepx, gr, cbw, wyb);
      } else {   // g * ((wx*wy) * lw)
        add_run(gbase + top, gr, wxa * wya * lw, 1.f);
        add_run(gbase + top + stepx, gr, wxb * wya * lw, 1.f);
        add_run(gbase + bot, gr, wxa * wyb * lw, 1.f);
        add_run(gbase + bot + stepx, gr, wxb * wyb * lw, 1.f);
      }
    }
  }
  if (has_point && lane == 0) {
    dloc[(size_t)k * 3 + 0] = dx;
    dloc[(size_t)k * 3 + 1] = dy;
    dloc[(size_t)k * 3 + 2] = 0.f;
  }
}

template <typename T, int L>
void launch_levels(const Levels& lv, const float* loc, const float* sw,
                   const int* slice_map, const void* gout, float* dloc,
                   float* dsw, unsigned num_points, int s, int p, int n,
                   int g, int c, int lanes_log2, bool want_tables,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)(
      (((uint64_t)num_points << lanes_log2) + kThreads - 1) / kThreads);
  msmv_sample_bwd_kernel<T, L><<<blocks, kThreads, 0, st>>>(
      lv, loc, sw, slice_map, static_cast<const T*>(gout), dloc, dsw,
      num_points, (unsigned)s, (unsigned)p, (unsigned)n, (unsigned)g, c,
      lanes_log2, want_tables);
}

template <typename T>
int launch(const Levels& lv, int num_levels, const float* loc,
           const float* sw, const int* slice_map, const void* gout,
           float* dloc, float* dsw, unsigned num_points, int s, int p, int n,
           int g, int c, int lanes_log2, bool want_tables, cudaStream_t st) {
#define SAMPLE_BWD_CASE(L)                                                  \
  case L:                                                                   \
    launch_levels<T, L>(lv, loc, sw, slice_map, gout, dloc, dsw,            \
                        num_points, s, p, n, g, c, lanes_log2, want_tables, \
                        st);                                                \
    break;
  switch (num_levels) {
    SAMPLE_BWD_CASE(1) SAMPLE_BWD_CASE(2) SAMPLE_BWD_CASE(3)
    SAMPLE_BWD_CASE(4) SAMPLE_BWD_CASE(5) SAMPLE_BWD_CASE(6)
    SAMPLE_BWD_CASE(7) SAMPLE_BWD_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SAMPLE_BWD_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tables/grads/heights/widths/yfold: host arrays of num_levels entries. Each
// table is [rows, w+1, 2c] (yfold 1) or [rows, w+1, c] (yfold 0) contiguous
// in the table dtype, 16-byte aligned, with rows * (w+1) below 2^31; each
// grad is a buffer of its table's shape and dtype, 16-byte aligned, that the
// table gradient is added to (read only when want_tables is set). loc [K, 3] and sw [K, L] fp32, slice_map [s] int32,
// gout [K, c] in the table dtype, 16-byte aligned; dloc [K, 3] and dsw
// [K, L] fp32 are written in full. K = num_points = Q * s * p. c, itemsize
// and lanes_per_point as in msmv_sample_forward.
int msmv_sample_backward(const void* const* tables, void* const* grads,
                         const int* heights, const int* widths,
                         const int* yfold, int num_levels, const float* loc,
                         const float* sw, const int* slice_map,
                         const void* gout, float* dloc, float* dsw,
                         long long num_points, int s, int p, int n, int g,
                         int c, int is_bf16, int want_tables,
                         int lanes_per_point, void* stream) {
  const int itemsize = is_bf16 ? 2 : 4;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes_per_point) ++lanes_log2;
  if (num_levels < 1 || num_levels > kMaxLevels || c < 1 ||
      (c * itemsize) % 16 != 0 || lanes_per_point > 32 ||
      (1 << lanes_log2) != lanes_per_point ||
      lanes_per_point * 16 < c * itemsize || s < 1 || p < 1 || n < 1 ||
      g < 1 || num_points < 0 || (num_points << lanes_log2) >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(gout) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    if ((reinterpret_cast<uintptr_t>(tables[l]) & 15) != 0 ||
        heights[l] < 1 || widths[l] < 1)
      return (int)cudaErrorInvalidValue;
    if (want_tables && (grads[l] == nullptr ||
                        (reinterpret_cast<uintptr_t>(grads[l]) & 15) != 0))
      return (int)cudaErrorInvalidValue;
    lv.table[l] = tables[l];
    lv.grad[l] = want_tables ? grads[l] : nullptr;
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.yfold[l] = yfold[l] != 0;
  }
  if (num_points == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(lv, num_levels, loc, sw, slice_map, gout,
                                 dloc, dsw, (unsigned)num_points, s, p, n, g,
                                 c, lanes_log2, want_tables != 0, st);
  return launch<float>(lv, num_levels, loc, sw, slice_map, gout, dloc, dsw,
                       (unsigned)num_points, s, p, n, g, c, lanes_log2,
                       want_tables != 0, st);
}

const char* msmv_sample_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
