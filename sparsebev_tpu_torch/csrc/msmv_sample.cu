// Multi-scale multi-view bilinear sampling forward over y-fold tables (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_sampling.py::_yfold_forward (:1011): the
// XLA window gather (:1171) plus the tap fold _fold_window_taps (:893), and
// its group-major twin _gmajor_forward (:910) for group-split levels. That
// op is not Pallas on the TPU; it is the reference model's one custom CUDA
// op, written here by hand.
//
// For each point k (query-major order (q, s, p)) and each level l:
//   view  = clip(round(v * (N-1)), 0, N-1); pixel = loc * (size - 1)
//   (sx, ry, wxa, wxb, wya, wyb) = the separable slot weights with the
//   shifted-window remap at x0/y0 = -1 (_separable_slot_weights :600)
//   row   = ((bt * N + view) * H + ry) * G + gi, (bt, gi) = divmod(slice_map[s], G)
//   window = table[row, sx:sx+2, 0:2C]  (all four bilinear taps)
//   out[k] += fold(window) weighted by sw[k, l]
// Output [Q, S, P, C] in the table dtype (bf16 or fp32).
//
// Numerics follow the JAX order exactly: the x weights are rounded to the
// table dtype and multiplied with the taps in that dtype; the two x taps add
// in fp32, the y and level weights fold in fp32; each level's result is
// rounded to the table dtype and added to an accumulator kept in the table
// dtype. Built with --fmad=false, so every product and sum rounds on its own
// as in the plain PyTorch version.
//
// Bound: bytes. Per call at flagship r50 (Q=900, S=32, P=4, 4 levels, C=64,
// bf16): 115,200 points x 4 levels x 512-byte windows = 236 MB if no window
// is shared, 14.7 MB of output and 3.2 MB of geometry, about 76 us at
// 3.35 TB/s. The arithmetic (about 0.2 GFLOP) is far below the card's rate.
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

// One tap-pair fold of one channel: x fold of both y halves, then y/level.
template <bool kBf16>
__device__ __forceinline__ float fold(float a0, float a1, float b0, float b1,
                                      float xa, float xb, float fya,
                                      float fyb) {
  if (kBf16) {
    const float ta = round_bf16(a0 * xa) + round_bf16(a1 * xb);
    const float tb = round_bf16(b0 * xa) + round_bf16(b1 * xb);
    return ta * fya + tb * fyb;
  }
  return (a0 * xa + a1 * xb) * fya + (b0 * xa + b1 * xb) * fyb;
}

template <typename T, bool kBf16>
__global__ void msmv_sample_kernel(Levels lv, int num_levels,
                                   const float* __restrict__ loc,
                                   const float* __restrict__ sw,
                                   const int* __restrict__ slice_map,
                                   T* __restrict__ out, int64_t num_points,
                                   int s, int p, int n, int g, int c) {
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
    float wxa = shx ? wx1 : wx0;
    float wxb = shx ? 0.f : wx1;
    const float wya = shy ? wy1 : wy0;
    const float wyb = shy ? 0.f : wy1;
    if (kBf16) {  // x weights in the table dtype (_fold_window_taps :902)
      wxa = round_bf16(wxa);
      wxb = round_bf16(wxb);
    }
    const float lw = sw[k * num_levels + l];
    const float fya = wya * lw;
    const float fyb = wyb * lw;

    const int64_t row = (((int64_t)bt * n + view) * h + ry) * g + gi;
    const T* col0 = static_cast<const T*>(lv.table[l]) +
                    (row * (w + 1) + sx) * (int64_t)(2 * c);
    const T* col1 = col0 + 2 * c;
#pragma unroll
    for (int j = 0; j < kMaxPairsPerLane; ++j) {
      const int cc = 2 * (lane + 32 * j);
      if (cc < c) {
        const float2 a0 = Pair<T>::load(col0 + cc);
        const float2 b0 = Pair<T>::load(col0 + c + cc);
        const float2 a1 = Pair<T>::load(col1 + cc);
        const float2 b1 = Pair<T>::load(col1 + c + cc);
        const float r0 = fold<kBf16>(a0.x, a1.x, b0.x, b1.x, wxa, wxb, fya, fyb);
        const float r1 = fold<kBf16>(a0.y, a1.y, b0.y, b1.y, wxa, wxb, fya, fyb);
        if (kBf16) {
          acc0[j] = round_bf16(acc0[j] + round_bf16(r0));
          acc1[j] = round_bf16(acc1[j] + round_bf16(r1));
        } else {
          acc0[j] += r0;
          acc1[j] += r1;
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

// tables/heights/widths: host arrays of num_levels entries; each table is
// [rows, w+1, 2c] contiguous in the output dtype. loc [K, 3] and sw [K, L]
// fp32, slice_map [s] int32, out [K, c]; K = num_points = Q * s * p.
int msmv_sample_forward(const void* const* tables, const int* heights,
                        const int* widths, int num_levels, const float* loc,
                        const float* sw, const int* slice_map, void* out,
                        long long num_points, int s, int p, int n, int g,
                        int c, int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || c % 2 != 0 ||
      c > 64 * kMaxPairsPerLane || s < 1 || p < 1 || n < 1 || g < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.table[l] = tables[l];
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
  }
  if (num_points == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;  // 8 points per block
  const int64_t blocks = (num_points * 32 + threads - 1) / threads;
  if (is_bf16) {
    msmv_sample_kernel<__nv_bfloat16, true><<<(unsigned)blocks, threads, 0, st>>>(
        lv, num_levels, loc, sw, slice_map,
        static_cast<__nv_bfloat16*>(out), num_points, s, p, n, g, c);
  } else {
    msmv_sample_kernel<float, false><<<(unsigned)blocks, threads, 0, st>>>(
        lv, num_levels, loc, sw, slice_map, static_cast<float*>(out),
        num_points, s, p, n, g, c);
  }
  return (int)cudaGetLastError();
}

const char* msmv_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
