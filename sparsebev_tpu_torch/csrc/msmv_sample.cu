// Multi-scale multi-view bilinear sampling forward over y-fold and pair-mode
// tables (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_sampling.py::_yfold_forward (:1011): the
// XLA window gathers (:1171 y-fold, :1215 pair) plus the tap folds
// (_fold_window_taps :893, the pair fold :1220-1228), and its group-major
// twin _gmajor_forward (:910, pair branch :981-1003). That op is not Pallas
// on the TPU; it is the reference model's one custom CUDA op, written here
// by hand.
//
// For each point k (query-major order (q, s, p)) and each level l:
//   view  = clip(round(v * (N-1)), 0, N-1); pixel = loc * (size - 1)
//   (sx, ry, wxa, wxb, wya, wyb) = the separable slot weights with the
//   shifted-window remap at x0/y0 = -1 (_separable_slot_weights :600)
//   row(y) = ((bt * N + view) * H + y) * G + gi, (bt, gi) = divmod(slice_map[s], G)
//   y-fold level: window = table[row(ry), sx:sx+2, 0:2C] (all four taps)
//   pair level:   windows table[row(ry), sx:sx+2, 0:C] and
//                 table[row(min(ry+1, H-1)), sx:sx+2, 0:C]
//   out[k] += fold(windows) weighted by sw[k, l]
// Output [Q, S, P, C] in the table dtype (bf16 or fp32).
//
// Numerics follow the bits XLA gives for the JAX code under jit: y-fold
// levels round the x weights to the table dtype; pair levels round the
// products wx * wy * lw to it. A bf16 tap times its bf16 weight is exact in
// fp32 and is not rounded (XLA's excess-precision rewrite drops that
// rounding). Taps add in fp32; each level's sum is rounded to the table
// dtype and added to an accumulator kept in the table dtype. A pair level
// adds its two y taps in fp32 and rounds once when `gmajor` is set (the
// group-major forward, taken when any level is group-split), and rounds and
// adds each y tap on its own otherwise (the unsplit forward). Built with
// --fmad=false, so every product and sum rounds on its own as in the plain
// PyTorch version.
//
// Bound: bytes. Per call at flagship r50 (Q=900, S=32, P=4, 4 levels, C=64,
// bf16): 115,200 points x 4 levels x 512-byte windows = 236 MB if no window
// is shared, 14.7 MB of output and 3.2 MB of geometry, about 76 us at
// 3.35 TB/s. At vov99 (Q=1600, S=60, P=4, 5 levels, the pair level reading
// two 256-byte windows): 384,000 points x 5 x 512 B = 983 MB if no window is
// shared, 49 MB of output and about 12 MB of geometry, at most about
// 0.31 ms. The arithmetic is far below the card's rate.
//
// Design: one warp per point, all levels. Each lane owns two channels and
// reads them from the four tap half-rows of each window: a warp's loads of
// one half-row are 128 contiguous bytes (bf16, C = 64). The per-point
// geometry (3 + L floats and one slice-map entry) is read by every lane of
// the warp as a broadcast. No shared memory, no atomics: each output
// element is written once by one lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPairsPerLane = 4;  // C <= 256

struct Levels {
  const void* table[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int yfold[kMaxLevels];  // 1: rows [w+1, 2c] (y-fold), 0: [w+1, c] (pair)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  __device__ static float2 load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    const __nv_bfloat162 v =
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
    return __bfloat1622float2(v);
  }
  __device__ static void store(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <bool kBf16>
__device__ __forceinline__ float to_table(float v) {
  return kBf16 ? round_bf16(v) : v;
}

template <typename T, bool kBf16>
__global__ void msmv_sample_kernel(Levels lv, int num_levels,
                                   const float* __restrict__ loc,
                                   const float* __restrict__ sw,
                                   const int* __restrict__ slice_map,
                                   T* __restrict__ out, int64_t num_points,
                                   int s, int p, int n, int g, int c,
                                   bool gmajor) {
  const int lane = threadIdx.x & 31;
  const int64_t k = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (k >= num_points) return;

  const int si = (int)((k / p) % s);
  const float x = loc[k * 3 + 0];
  const float y = loc[k * 3 + 1];
  const float v = loc[k * 3 + 2];
  const float vf = fminf(fmaxf(rintf(v * (float)(n - 1)), 0.f),
                         (float)(n - 1));
  const int view = (int)vf;
  const int phys = slice_map[si];
  const int bt = phys / g;
  const int gi = phys % g;

  float acc0[kMaxPairsPerLane], acc1[kMaxPairsPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j) acc0[j] = acc1[j] = 0.f;

  for (int l = 0; l < num_levels; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    // clamping far-out pixels to [-2, size+1] keeps the int conversion in
    // range and leaves every weight unchanged (all taps are masked there)
    const float xp = fminf(fmaxf(x * (float)(w - 1), -2.f), (float)(w + 1));
    const float yp = fminf(fmaxf(y * (float)(h - 1), -2.f), (float)(h + 1));
    const float x0f = floorf(xp);
    const float y0f = floorf(yp);
    const float lx = xp - x0f;
    const float ly = yp - y0f;
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    const float wx0 = (ix0 >= 0 && ix0 <= w - 1) ? 1.f - lx : 0.f;
    const float wx1 = (ix0 + 1 >= 0 && ix0 + 1 <= w - 1) ? lx : 0.f;
    const float wy0 = (iy0 >= 0 && iy0 <= h - 1) ? 1.f - ly : 0.f;
    const float wy1 = (iy0 + 1 >= 0 && iy0 + 1 <= h - 1) ? ly : 0.f;
    const bool shx = ix0 < 0;
    const bool shy = iy0 < 0;
    const int sx = min(max(ix0, 0), w - 1);
    const int ry = min(max(iy0, 0), h - 1);
    const float wxa = shx ? wx1 : wx0;
    const float wxb = shx ? 0.f : wx1;
    const float wya = shy ? wy1 : wy0;
    const float wyb = shy ? 0.f : wy1;
    const float lw = sw[k * num_levels + l];
    const T* table = static_cast<const T*>(lv.table[l]);

    if (lv.yfold[l]) {
      // x weights in the table dtype (_fold_window_taps :902)
      const float xa = to_table<kBf16>(wxa);
      const float xb = to_table<kBf16>(wxb);
      const float fya = wya * lw;
      const float fyb = wyb * lw;
      const int64_t row = (((int64_t)bt * n + view) * h + ry) * g + gi;
      const T* col0 = table + (row * (w + 1) + sx) * (int64_t)(2 * c);
      const T* col1 = col0 + 2 * c;
#pragma unroll
      for (int j = 0; j < kMaxPairsPerLane; ++j) {
        const int cc = 2 * (lane + 32 * j);
        if (cc < c) {
          const float2 a0 = Pair<T>::load(col0 + cc);
          const float2 b0 = Pair<T>::load(col0 + c + cc);
          const float2 a1 = Pair<T>::load(col1 + cc);
          const float2 b1 = Pair<T>::load(col1 + c + cc);
          const float r0 = (a0.x * xa + a1.x * xb) * fya +
                           (b0.x * xa + b1.x * xb) * fyb;
          const float r1 = (a0.y * xa + a1.y * xb) * fya +
                           (b0.y * xa + b1.y * xb) * fyb;
          acc0[j] = to_table<kBf16>(acc0[j] + to_table<kBf16>(r0));
          acc1[j] = to_table<kBf16>(acc1[j] + to_table<kBf16>(r1));
        }
      }
      continue;
    }

    // pair level: rows ry and min(ry+1, h-1); wyb is 0 wherever row ry+1
    // is invalid, so the clamp changes no weight. Weights wx * (wy * lw)
    // rounded to the table dtype (:1223-1225).
    const float wyl0 = wya * lw;
    const float wyl1 = wyb * lw;
    const float w00 = to_table<kBf16>(wxa * wyl0);
    const float w01 = to_table<kBf16>(wxb * wyl0);
    const float w10 = to_table<kBf16>(wxa * wyl1);
    const float w11 = to_table<kBf16>(wxb * wyl1);
    const int64_t row0 = (((int64_t)bt * n + view) * h + ry) * g + gi;
    const int64_t row1 =
        (((int64_t)bt * n + view) * h + min(ry + 1, h - 1)) * g + gi;
    const T* top = table + (row0 * (w + 1) + sx) * (int64_t)c;
    const T* bot = table + (row1 * (w + 1) + sx) * (int64_t)c;
#pragma unroll
    for (int j = 0; j < kMaxPairsPerLane; ++j) {
      const int cc = 2 * (lane + 32 * j);
      if (cc < c) {
        const float2 a0 = Pair<T>::load(top + cc);
        const float2 a1 = Pair<T>::load(top + c + cc);
        const float2 b0 = Pair<T>::load(bot + cc);
        const float2 b1 = Pair<T>::load(bot + c + cc);
        const float t0x = a0.x * w00 + a1.x * w01;
        const float t0y = a0.y * w00 + a1.y * w01;
        const float t1x = b0.x * w10 + b1.x * w11;
        const float t1y = b0.y * w10 + b1.y * w11;
        if (gmajor) {  // _gmajor_forward :986-1003: one add per level
          acc0[j] = to_table<kBf16>(acc0[j] + to_table<kBf16>(t0x + t1x));
          acc1[j] = to_table<kBf16>(acc1[j] + to_table<kBf16>(t0y + t1y));
        } else {       // _yfold_forward :1211-1228: one add per y tap
          acc0[j] = to_table<kBf16>(acc0[j] + to_table<kBf16>(t0x));
          acc1[j] = to_table<kBf16>(acc1[j] + to_table<kBf16>(t0y));
          acc0[j] = to_table<kBf16>(acc0[j] + to_table<kBf16>(t1x));
          acc1[j] = to_table<kBf16>(acc1[j] + to_table<kBf16>(t1y));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j) {
    const int cc = 2 * (lane + 32 * j);
    if (cc < c) Pair<T>::store(out + k * c + cc, acc0[j], acc1[j]);
  }
}

}  // namespace

extern "C" {

// tables/heights/widths/yfold: host arrays of num_levels entries; each
// table is [rows, w+1, 2c] (yfold 1) or [rows, w+1, c] (yfold 0) contiguous
// in the output dtype. loc [K, 3] and sw [K, L] fp32, slice_map [s] int32,
// out [K, c]; K = num_points = Q * s * p. gmajor selects the pair levels'
// accumulation order (see the header).
int msmv_sample_forward(const void* const* tables, const int* heights,
                        const int* widths, const int* yfold, int num_levels,
                        const float* loc, const float* sw,
                        const int* slice_map, void* out,
                        long long num_points, int s, int p, int n, int g,
                        int c, int is_bf16, int gmajor, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || c % 2 != 0 ||
      c > 64 * kMaxPairsPerLane || s < 1 || p < 1 || n < 1 || g < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.table[l] = tables[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.yfold[l] = yfold[l] != 0;
  }
  if (num_points == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // 8 points per block
  const int64_t blocks = (num_points * 32 + threads - 1) / threads;
  if (is_bf16) {
    msmv_sample_kernel<__nv_bfloat16, true><<<(unsigned)blocks, threads, 0, st>>>(
        lv, num_levels, loc, sw, slice_map,
        static_cast<__nv_bfloat16*>(out), num_points, s, p, n, g, c,
        gmajor != 0);
  } else {
    msmv_sample_kernel<float, false><<<(unsigned)blocks, threads, 0, st>>>(
        lv, num_levels, loc, sw, slice_map, static_cast<float*>(out),
        num_points, s, p, n, g, c, gmajor != 0);
  }
  return (int)cudaGetLastError();
}

const char* msmv_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
