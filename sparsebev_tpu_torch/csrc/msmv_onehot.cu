// Bilinear sampling of the small pyramid levels from bf16 [S, N*H, W*C]
// tables, for the hybrid sampling path (sm_90a). Two kernels: every one-hot
// level of a sampling call in one launch, with the point geometry computed
// inside and the level sum kept in the caller's accumulator; and one level
// from precomputed per-point arguments.
//
// Replaces: sparsebev_tpu/ops/msmv_pallas.py::onehot_sample_level
// (pallas_call at :132, body _onehot_sample_kernel :54) and, in the fused
// kernel, the XLA code around it in
// sparsebev_tpu/ops/msmv_sampling.py::_yfold_forward (:1088-1125: the
// per-point arguments and `out + res.astype(out.dtype)`). The TPU kernel
// builds dense one-hot matrices (row weights a [K, N*H], x weights
// xsel [K, W]) and runs three skinny matmuls per query block, only because
// the TPU gathers slowly. Here each point reads its taps directly.
//
// One level, for point k of slice si (contract of the JAX function, :89-108):
//   a0 = bf16(wy0 + wy1) and a1 = 0   where rows0 == rows1
//   a0 = bf16(wy0),     a1 = bf16(wy1) otherwise
//   b0 = bf16(wx0), b1 = bf16(wx1)
//   g(col) = a0 * F[si, rows0, col] + a1 * F[si, rows1, col]       (fp32)
//   res[si, k] = bf16(g(x0) * b0) + bf16(g(x0 + 1) * b1)           (fp32)
// where F[si, r, col] is the C channels at column col of table row r. These
// are the four roundings of the JAX code (the bf16 one-hot matrices :124-125
// and gx = (g * xsel).astype(bf16) :81); XLA keeps all four on the CPU, under
// jax.jit as well as op by op. A bf16 weight times a bf16 tap is exact in
// fp32, so the matmul g = a @ F is the fp32 sum of the two products in any
// order.
//
// The fused kernel, for point k = (si, q, p) of loc [S, Q, P, 3] and each
// level l in the order given (msmv_sampling.py :1088-1115):
//   view = clip(round(v * (N-1)), 0, N-1)      (round half to even)
//   xp = clip(x * (W-1), -2, W+1), x0 = floor(xp), lx = xp - x0; y alike
//   wy0 = (1 - ly) * [0 <= y0 <= H-1] * lw,  wy1 = ly * [0 <= y0+1 <= H-1] * lw
//   s0 = clip(x0, 0, W-2); the weights (1 - lx) * [x0 in range] of column x0
//   and lx * [x0+1 in range] of column x0+1 go to whichever of the window's
//   columns s0, s0+1 they fall on (both image edges remap)
//   rows0 = view * H + clip(y0, 0, H-1), rows1 = view * H + clip(y0+1, 0, H-1)
//   acc[k] = round_acc(acc[k] + round_acc(res_l[k]))
// with lw = sw[k, index_l] and acc the caller's [K, C] accumulator in bf16 or
// fp32 (round_acc rounds to bf16 or does nothing), read and written in place.
// Built with --fmad=false, so every product and sum rounds on its own as in
// the plain PyTorch versions, which gives the same bits.
//
// Bound: bytes. The fused kernel reads the table runs of C bf16 values that
// its points touch (at most four a point and level: two rows x two columns;
// runs that points share are read once at the bound), 12 bytes of location
// and the scale weights a point, and reads and writes the accumulator once:
// at C = 64 with a bf16 accumulator 256 bytes a point against the 256 bytes
// a point AND LEVEL that fp32 [S, K, C] results cost the per-level kernel,
// which also reads 28 bytes of arguments a point. The arithmetic is some 60
// scalar operations a point and level and 6 products and sums a channel.
//
// Design: a group of lanes per point, 16 bytes per lane, as msmv_sample.cu.
// Each lane owns one 16-byte run of the C channels (8 bf16 values), so C = 64
// takes 8 lanes and a warp carries 4 points: the P = 4 points of one (slice,
// query), which often share windows. One warp-level load instruction moves
// 512 bytes. A slice is a blockIdx.y and its points run along blockIdx.x, so
// no lane divides to find its slice. In the fused kernel the level count is
// a template parameter and the level loop is unrolled, so the table pointers
// and sizes are read from the kernel parameters at fixed offsets (a run-time
// index would copy the parameter block to the stack), and it runs in two
// passes: the first computes every level's weights and starts all 4 * L tap
// loads (ld.global.nc.v4) and the accumulator's, the second folds them in
// level order. Rows and columns are 32-bit, the byte offset takes one 64-bit
// multiply. Both kernels fold a level through the same device function. No
// shared memory, no atomics: each output run is written once, by one lane.
//
// With the tables of a few slices resident in L2, the fused kernel is bound
// by the operations it executes as much as by memory: with every tap an L1
// hit it still takes most of its time. So the integer-to-float
// conversions of the level sizes are made on the host, and every rounding to
// bf16 is one cvt.rn.bf16x2.f32 whose upper half is the rounded value as a
// float (round_bf16). Every lane of a group computes its point's scalars
// itself: sharing the levels' geometry between the lanes of a group by
// shuffle ran fewer operations but started the tap loads later and was
// no faster on points that miss L1; forcing more blocks an SM spilled; 64 and
// 256 threads a block made no difference.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, L2
// flushed, on one r50 decoder layer's recorded points (K = 115,200, C = 64,
// levels 32x88, 16x44, 8x22): the fused kernel 0.038 ms onto a bf16
// accumulator (bound 0.019: 63 MB) and 0.043 ms onto an fp32 one (bound
// 0.028); the per-level kernel 0.070 ms for the three levels (bound 0.0385;
// the one-warp-a-point kernel before it: 0.116). 48 registers at 3 levels, 80
// at 8, no stack frame, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;
constexpr int kMaxSlices = 65535;  // a slice a blockIdx.y
constexpr int kVec = 8;  // bf16 values in a lane's 16 bytes

struct Levels {
  const void* table[kMaxLevels];  // bf16 [s, n*h, w*c]
  int h[kMaxLevels];
  int w[kMaxLevels];
  int sw_index[kMaxLevels];       // the level's entry of a point's weights
  float wm1[kMaxLevels];          // (float)(w - 1) and (float)(h - 1): the
  float hm1[kMaxLevels];          // conversions are made once, on the host
};

// v rounded to bf16, as a float: one two-way conversion with a zero in the
// low half leaves the bf16 in the upper half of the word, which is its fp32.
// (__float2bfloat16_rn and a shift take two operations, the first on the
// slow conversion unit.)
__device__ __forceinline__ float round_bf16(float v) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(0.f, v);
  return __uint_as_float(*reinterpret_cast<const unsigned*>(&r));
}

// The halves of a word of two bf16 values as floats.
__device__ __forceinline__ float lo_float(unsigned v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float hi_float(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ uint4 load16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack_bf16(const uint4& v, float (&f)[kVec]) {
  f[0] = lo_float(v.x);
  f[1] = hi_float(v.x);
  f[2] = lo_float(v.y);
  f[3] = hi_float(v.y);
  f[4] = lo_float(v.z);
  f[5] = hi_float(v.z);
  f[6] = lo_float(v.w);
  f[7] = hi_float(v.w);
}

// The bf16 weights of one level's taps: rows (a0, a1) and columns (b0, b1).
struct TapWeights {
  float a0, a1, b0, b1;
};

__device__ __forceinline__ TapWeights tap_weights(bool same_row, float wy0,
                                                  float wy1, float wx0,
                                                  float wx1) {
  TapWeights t;
  t.a0 = round_bf16(same_row ? wy0 + wy1 : wy0);
  t.a1 = same_row ? 0.f : round_bf16(wy1);
  t.b0 = round_bf16(wx0);
  t.b1 = round_bf16(wx1);
  return t;
}

// One lane's 8 channels of one level: t00/t01 row rows0 at columns x0, x0+1,
// t10/t11 row rows1. The roundings are the header's.
__device__ __forceinline__ void fold_taps(const uint4& t00, const uint4& t01,
                                          const uint4& t10, const uint4& t11,
                                          const TapWeights& t,
                                          float (&res)[kVec]) {
  float f00[kVec], f01[kVec], f10[kVec], f11[kVec];
  unpack_bf16(t00, f00);
  unpack_bf16(t01, f01);
  unpack_bf16(t10, f10);
  unpack_bf16(t11, f11);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float gl = t.a0 * f00[j] + t.a1 * f10[j];
    const float gr = t.a0 * f01[j] + t.a1 * f11[j];
    res[j] = round_bf16(gl * t.b0) + round_bf16(gr * t.b1);
  }
}

// A lane's 8 channels of the accumulator: 16 bytes in bf16, 32 in fp32.
template <typename A>
struct Acc;

template <>
struct Acc<float> {
  static constexpr int kRuns = 2;
  __device__ static void unpack(const uint4 (&v)[kRuns], float (&f)[kVec]) {
    f[0] = __uint_as_float(v[0].x);
    f[1] = __uint_as_float(v[0].y);
    f[2] = __uint_as_float(v[0].z);
    f[3] = __uint_as_float(v[0].w);
    f[4] = __uint_as_float(v[1].x);
    f[5] = __uint_as_float(v[1].y);
    f[6] = __uint_as_float(v[1].z);
    f[7] = __uint_as_float(v[1].w);
  }
  __device__ static void pack(const float (&f)[kVec], uint4 (&v)[kRuns]) {
    v[0] = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
    v[1] = make_uint4(__float_as_uint(f[4]), __float_as_uint(f[5]),
                      __float_as_uint(f[6]), __float_as_uint(f[7]));
  }
  // acc + res in fp32
  __device__ static void add(float (&acc)[kVec], const float (&res)[kVec]) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = acc[j] + res[j];
  }
};

template <>
struct Acc<__nv_bfloat16> {
  static constexpr int kRuns = 1;
  __device__ static void unpack(const uint4 (&v)[kRuns], float (&f)[kVec]) {
    unpack_bf16(v[0], f);
  }
  // f holds values already rounded to bf16: the upper halves are exact
  __device__ static void pack(const float (&f)[kVec], uint4 (&v)[kRuns]) {
    v[0] = make_uint4(
        (__float_as_uint(f[0]) >> 16) | (__float_as_uint(f[1]) & 0xffff0000u),
        (__float_as_uint(f[2]) >> 16) | (__float_as_uint(f[3]) & 0xffff0000u),
        (__float_as_uint(f[4]) >> 16) | (__float_as_uint(f[5]) & 0xffff0000u),
        (__float_as_uint(f[6]) >> 16) | (__float_as_uint(f[7]) & 0xffff0000u));
  }
  // bf16(acc + bf16(res))
  __device__ static void add(float (&acc)[kVec], const float (&res)[kVec]) {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      acc[j] = round_bf16(acc[j] + round_bf16(res[j]));
  }
};

// Every level of the call for one point per lane group. lanes_log2: log2 of
// the lanes that share a point (a power of two >= c * 2 / 16; lanes past the
// last run idle). blockIdx.y is the slice and blockIdx.x a run of its
// qp = Q * P points, so no lane divides; nm1 = (float)(N - 1); sw holds
// sw_levels weights a point, bf16 or fp32.
template <typename A, int L>
__global__ void __launch_bounds__(kThreads)
    onehot_levels_kernel(const Levels lv, const float* __restrict__ loc,
                         const void* __restrict__ sw, A* out, unsigned qp,
                         unsigned n, float nm1, int c, int sw_levels,
                         bool sw_bf16, int lanes_log2) {
  constexpr int kRuns = Acc<A>::kRuns;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned pi = tid >> lanes_log2;  // point of the slice
  const int cc = (int)(tid & ((1u << lanes_log2) - 1u)) * kVec;
  if (pi >= qp || cc >= c) return;

  const unsigned si = blockIdx.y;
  const unsigned k = si * qp + pi;
  const float x = __ldg(loc + (size_t)k * 3 + 0);
  const float y = __ldg(loc + (size_t)k * 3 + 1);
  const float v = __ldg(loc + (size_t)k * 3 + 2);
  const unsigned view = (unsigned)fminf(fmaxf(rintf(v * nm1), 0.f), nm1);
  const unsigned cb = (unsigned)c * 2u;  // bytes of C bf16 channels
  const unsigned ccb = (unsigned)cc * 2u;

  // pass 1: every level's weights, all of its four tap loads and the
  // accumulator's load in flight
  char* acc_ptr = reinterpret_cast<char*>(out) +
                  ((uint64_t)k * (unsigned)c + (unsigned)cc) * sizeof(A);
  uint4 acc_raw[kRuns];
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
    acc_raw[r] = *reinterpret_cast<const uint4*>(acc_ptr + 16 * r);
  uint4 t00[L], t01[L], t10[L], t11[L];
  TapWeights tw[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    const size_t swi =
        (size_t)k * (unsigned)sw_levels + (unsigned)lv.sw_index[l];
    const float lw =
        sw_bf16 ? lo_float(__ldg(static_cast<const unsigned short*>(sw) +
                                 swi))
                : __ldg(static_cast<const float*>(sw) + swi);
    // clamping far-out pixels to [-2, size+1] keeps the int conversion in
    // range and leaves every weight unchanged (all taps are masked there)
    const float xp = fminf(fmaxf(x * lv.wm1[l], -2.f), lv.wm1[l] + 2.f);
    const float yp = fminf(fmaxf(y * lv.hm1[l], -2.f), lv.hm1[l] + 2.f);
    const float x0f = floorf(xp);
    const float y0f = floorf(yp);
    const float lx = xp - x0f;
    const float ly = yp - y0f;
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    // a weight times its in-range flag: lx, ly are in [0, 1), so the
    // product with a false flag is +0
    const float wy0 = ((iy0 >= 0 && iy0 <= h - 1) ? 1.f - ly : 0.f) * lw;
    const float wy1 = ((iy0 + 1 >= 0 && iy0 + 1 <= h - 1) ? ly : 0.f) * lw;
    // the window [s0, s0+1] stays inside the row; at x0 = -1 and x0 = W-1
    // the one live column's weight moves to the slot it falls on
    const int s0 = min(max(ix0, 0), w - 2);
    // the weights of columns x0 and x0 + 1
    const float u0 = (ix0 >= 0 && ix0 <= w - 1) ? 1.f - lx : 0.f;
    const float u1 = (ix0 + 1 >= 0 && ix0 + 1 <= w - 1) ? lx : 0.f;
    const float wx0 = (s0 == ix0 ? u0 : 0.f) + (s0 == ix0 + 1 ? u1 : 0.f);
    const float wx1 =
        (s0 + 1 == ix0 ? u0 : 0.f) + (s0 + 1 == ix0 + 1 ? u1 : 0.f);
    const int r0 = min(max(iy0, 0), h - 1);
    const int r1 = min(max(iy0 + 1, 0), h - 1);  // r0 or r0 + 1
    tw[l] = tap_weights(r0 == r1, wy0, wy1, wx0, wx1);
    const unsigned col =
        ((si * n + view) * (unsigned)h + (unsigned)r0) * (unsigned)w +
        (unsigned)s0;
    const char* top =
        static_cast<const char*>(lv.table[l]) + (uint64_t)col * cb + ccb;
    const char* bot = top + (r1 != r0 ? (unsigned)w * cb : 0u);
    t00[l] = load16(top);
    t01[l] = load16(top + cb);
    t10[l] = load16(bot);
    t11[l] = load16(bot + cb);
  }

  // pass 2: fold, level by level, into the accumulator in its own dtype
  float acc[kVec];
  Acc<A>::unpack(acc_raw, acc);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float res[kVec];
    fold_taps(t00[l], t01[l], t10[l], t11[l], tw[l], res);
    Acc<A>::add(acc, res);
  }
  Acc<A>::pack(acc, acc_raw);
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
    *reinterpret_cast<uint4*>(acc_ptr + 16 * r) = acc_raw[r];
}

// One level from precomputed arguments; blockIdx.y is the slice, blockIdx.x
// a run of its kq points.
__global__ void __launch_bounds__(kThreads)
    onehot_level_kernel(const char* __restrict__ table,
                        const int* __restrict__ rows0,
                        const int* __restrict__ rows1,
                        const float* __restrict__ wy0,
                        const float* __restrict__ wy1,
                        const int* __restrict__ x0,
                        const float* __restrict__ wx0,
                        const float* __restrict__ wx1, float* __restrict__ out,
                        unsigned kq, int nh, int w, int c, int lanes_log2) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned pi = tid >> lanes_log2;  // point of the slice
  const int cc = (int)(tid & ((1u << lanes_log2) - 1u)) * kVec;
  if (pi >= kq || cc >= c) return;
  const unsigned si = blockIdx.y;
  const unsigned pt = si * kq + pi;
  // in range by contract; clamped so that a bad index cannot read outside
  // the slice's table
  const int r0 = min(max(__ldg(rows0 + pt), 0), nh - 1);
  const int r1 = min(max(__ldg(rows1 + pt), 0), nh - 1);
  const int xx = min(max(__ldg(x0 + pt), 0), w - 2);
  const TapWeights tw =
      tap_weights(r0 == r1, __ldg(wy0 + pt), __ldg(wy1 + pt), __ldg(wx0 + pt),
                  __ldg(wx1 + pt));
  const unsigned cb = (unsigned)c * 2u;
  const unsigned slice_col = si * (unsigned)nh * (unsigned)w + (unsigned)xx;
  const char* p0 = table +
                   (uint64_t)(slice_col + (unsigned)r0 * (unsigned)w) * cb +
                   (unsigned)cc * 2u;
  const char* p1 = table +
                   (uint64_t)(slice_col + (unsigned)r1 * (unsigned)w) * cb +
                   (unsigned)cc * 2u;
  const uint4 t00 = load16(p0);
  const uint4 t01 = load16(p0 + cb);
  const uint4 t10 = load16(p1);
  const uint4 t11 = load16(p1 + cb);
  float res[kVec];
  fold_taps(t00, t01, t10, t11, tw, res);
  uint4 o[2];
  Acc<float>::pack(res, o);
  uint4* dst = reinterpret_cast<uint4*>(out + (uint64_t)pt * (unsigned)c + cc);
  dst[0] = o[0];
  dst[1] = o[1];
}

// Blocks for s slices of `points` points each: x runs over a slice's points,
// y over the slices.
dim3 slice_grid(int s, long long points, int lanes_log2) {
  return dim3((unsigned)(((points << lanes_log2) + kThreads - 1) / kThreads),
              (unsigned)s);
}

template <typename A, int L>
void launch_levels(const Levels& lv, const float* loc, const void* sw,
                   void* out, int s, unsigned qp, int n, int c, int sw_levels,
                   bool sw_bf16, int lanes_log2, cudaStream_t st) {
  const dim3 grid = slice_grid(s, qp, lanes_log2);
  onehot_levels_kernel<A, L><<<grid, kThreads, 0, st>>>(
      lv, loc, sw, static_cast<A*>(out), qp, (unsigned)n, (float)(n - 1), c,
      sw_levels, sw_bf16, lanes_log2);
}

template <typename A>
int launch(const Levels& lv, int num_levels, const float* loc, const void* sw,
           void* out, int s, unsigned qp, int n, int c, int sw_levels,
           bool sw_bf16, int lanes_log2, cudaStream_t st) {
#define ONEHOT_CASE(L)                                                    \
  case L:                                                                 \
    launch_levels<A, L>(lv, loc, sw, out, s, qp, n, c, sw_levels, sw_bf16, \
                        lanes_log2, st);                                  \
    break;
  switch (num_levels) {
    ONEHOT_CASE(1) ONEHOT_CASE(2) ONEHOT_CASE(3) ONEHOT_CASE(4)
    ONEHOT_CASE(5) ONEHOT_CASE(6) ONEHOT_CASE(7) ONEHOT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ONEHOT_CASE
  return (int)cudaGetLastError();
}

// log2 of lanes_per_point if it is a power of two of at most 32 that covers
// c bf16 channels in 16-byte runs, else -1
int lanes_log2_of(int lanes_per_point, int c) {
  int lg = 0;
  while ((1 << lg) < lanes_per_point) ++lg;
  if (c < 1 || (c * 2) % 16 != 0 || lanes_per_point > 32 ||
      (1 << lg) != lanes_per_point || lanes_per_point * 16 < c * 2)
    return -1;
  return lg;
}

}  // namespace

extern "C" {

// table: [s, nh, w*c] bf16 contiguous, 16-byte aligned, s * nh * w below
// 2^31; rows0/rows1/x0 int32 and wy0/wy1/wx0/wx1 fp32, each [s, k]
// contiguous; out: [s, k, c] fp32. c * 2 is a multiple of 16 and at most 512;
// lanes_per_point is the power of two >= c * 2 / 16 that the caller chose.
int msmv_onehot_sample_level(const void* table, const int* rows0,
                             const int* rows1, const float* wy0,
                             const float* wy1, const int* x0,
                             const float* wx0, const float* wx1, float* out,
                             int s, long long k, int nh, int w, int c,
                             int lanes_per_point, void* stream) {
  const int lanes_log2 = lanes_log2_of(lanes_per_point, c);
  const long long num_points = (long long)s * k;
  if (lanes_log2 < 0 || s < 0 || s > kMaxSlices || k < 0 || nh < 1 || w < 2 ||
      (num_points << lanes_log2) >= (1LL << 31) ||
      (long long)s * nh * w >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (num_points == 0) return (int)cudaGetLastError();
  const dim3 grid = slice_grid(s, k, lanes_log2);
  onehot_level_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(table), rows0, rows1, wy0, wy1, x0, wx0, wx1,
      out, (unsigned)k, nh, w, c, lanes_log2);
  return (int)cudaGetLastError();
}

// tables/heights/widths/sw_index: host arrays of num_levels (1..8) entries;
// each table is [s, n*h, w*c] bf16 contiguous, 16-byte aligned, with
// s * n*h * w below 2^31 and w >= 2. loc [s, qp, 3] fp32; sw [s, qp,
// sw_levels] fp32 or bf16 (sw_is_bf16), level l reading entry sw_index[l];
// out [s * qp, c] fp32 or bf16 (out_is_bf16), 16-byte aligned, read and
// written in place. c and lanes_per_point as above.
int msmv_onehot_sample_levels(const void* const* tables, const int* heights,
                              const int* widths, const int* sw_index,
                              int num_levels, const float* loc,
                              const void* sw, int sw_is_bf16, int sw_levels,
                              void* out, int out_is_bf16, int s, long long qp,
                              int n, int c, int lanes_per_point,
                              void* stream) {
  const int lanes_log2 = lanes_log2_of(lanes_per_point, c);
  const long long num_points = (long long)s * qp;
  if (lanes_log2 < 0 || num_levels < 1 || num_levels > kMaxLevels || s < 0 ||
      s > kMaxSlices || qp < 0 || n < 1 || sw_levels < 1 ||
      (num_points << lanes_log2) >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  for (int l = 0; l < num_levels; ++l) {
    if ((reinterpret_cast<uintptr_t>(tables[l]) & 15) != 0 ||
        heights[l] < 1 || widths[l] < 2 || sw_index[l] < 0 ||
        sw_index[l] >= sw_levels ||
        (long long)s * n * heights[l] * widths[l] >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    lv.table[l] = tables[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.sw_index[l] = sw_index[l];
    lv.wm1[l] = (float)(widths[l] - 1);
    lv.hm1[l] = (float)(heights[l] - 1);
  }
  if (num_points == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_is_bf16)
    return launch<__nv_bfloat16>(lv, num_levels, loc, sw, out, s,
                                 (unsigned)qp, n, c, sw_levels,
                                 sw_is_bf16 != 0, lanes_log2, st);
  return launch<float>(lv, num_levels, loc, sw, out, s, (unsigned)qp, n, c,
                       sw_levels, sw_is_bf16 != 0, lanes_log2, st);
}

const char* msmv_onehot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
