// Tap-weight epilogue of the y-fold sampling forward over gathered windows
// (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_epilogue_pallas.py::tap_fold_epilogue
// (pallas_call at :100, body _tap_fold_kernel :51). Not wired into the
// sampling forward, in the JAX package or in the port: it is reached through
// its own entry point.
//
// Input per level l: the gathered windows g_l [K, 2, 2C] (bf16 or fp32; the
// two window columns, each a y-fold row feat[y] || feat[y+1]) and the
// weights w_l [K, 4] fp32 = (wxa, wxb, wya * lw, wyb * lw). For each point k
// and lane j of 2C, in fp32:
//   acc[j] += (g_l[k, 0, j] * wxa + g_l[k, 1, j] * wxb) * wy(j)
// with wy(j) = w_l[k, 2] on the first C lanes and w_l[k, 3] on the second,
// levels in order, then out[k, j] = acc[j] + acc[C + j] cast to the output
// dtype. The TPU kernel folds the two halves with a [2C, C] stacked-identity
// matmul; that product is this one add. Built with --fmad=false, so every
// product and sum rounds on its own: the plain PyTorch version, which keeps
// the same order, gives the same bits.
//
// Bound: bytes. At r50 (K = 900 * 32 * 4 = 115,200 points, 4 levels, C = 64,
// bf16 windows and output): 235.9 MB of windows, 7.4 MB of weights and
// 14.7 MB of output, 258 MB, 77 us at 3.35 TB/s. Five fp32 operations per
// lane and level (2C lanes per point), far below the fp32 rate.
//
// Design: one warp per point, all levels, as in msmv_sample.cu. Each lane
// owns two channels of each half and loads them as one 2-element vector from
// each of the window's four half-rows: a warp's load of one half-row is
// C * itemsize contiguous bytes (128 at C = 64 in bf16). The weights are one
// float4 per point and level, read by every lane as a broadcast. The level
// loop is unrolled over kMaxLevels, so the per-level pointers are read from
// the kernel parameters at fixed offsets (a loop with a run-time index copies
// the parameter block to the stack).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxPairsPerLane = 4;  // C <= 256

struct Levels {
  const void* g[kMaxLevels];
  const float4* w[kMaxLevels];
};

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename Tin, typename Tout>
__global__ void tap_fold_kernel(Levels lv, int num_levels,
                                Tout* __restrict__ out, int64_t k, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t pt = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pt >= k) return;
  float lo0[kMaxPairsPerLane], lo1[kMaxPairsPerLane];
  float hi0[kMaxPairsPerLane], hi1[kMaxPairsPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j)
    lo0[j] = lo1[j] = hi0[j] = hi1[j] = 0.f;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= num_levels) break;
    const float4 w = __ldg(lv.w[l] + pt);  // wxa, wxb, wya*lw, wyb*lw
    const Tin* col0 = static_cast<const Tin*>(lv.g[l]) + pt * 4 * c;
    const Tin* col1 = col0 + 2 * c;
#pragma unroll
    for (int j = 0; j < kMaxPairsPerLane; ++j) {
      const int cc = 2 * (lane + 32 * j);
      if (cc < c) {
        const float2 a0 = load2(col0 + cc);
        const float2 b0 = load2(col0 + c + cc);
        const float2 a1 = load2(col1 + cc);
        const float2 b1 = load2(col1 + c + cc);
        lo0[j] = lo0[j] + (a0.x * w.x + a1.x * w.y) * w.z;
        lo1[j] = lo1[j] + (a0.y * w.x + a1.y * w.y) * w.z;
        hi0[j] = hi0[j] + (b0.x * w.x + b1.x * w.y) * w.w;
        hi1[j] = hi1[j] + (b0.y * w.x + b1.y * w.y) * w.w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j) {
    const int cc = 2 * (lane + 32 * j);
    if (cc < c) store2(out + pt * c + cc, lo0[j] + hi0[j], lo1[j] + hi1[j]);
  }
}

template <typename Tin, typename Tout>
void launch(const Levels& lv, int num_levels, void* out, int64_t k, int c,
            cudaStream_t st) {
  const int threads = 256;  // 8 points per block
  const int64_t blocks = (k * 32 + threads - 1) / threads;
  tap_fold_kernel<Tin, Tout><<<(unsigned)blocks, threads, 0, st>>>(
      lv, num_levels, static_cast<Tout*>(out), k, c);
}

}  // namespace

extern "C" {

// gathered: host array of num_levels pointers to [k, 2, 2c] windows (bf16
// when in_bf16, else fp32); weights: host array of num_levels pointers to
// [k, 4] fp32 (16-byte aligned); out: [k, c], bf16 when out_bf16 else fp32.
int tap_fold_epilogue(const void* const* gathered,
                      const void* const* weights, int num_levels, void* out,
                      long long k, int c, int in_bf16, int out_bf16,
                      void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || k < 0 || c < 2 ||
      c % 2 != 0 || c > 64 * kMaxPairsPerLane)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < num_levels; ++l) {
    lv.g[l] = gathered[l];
    lv.w[l] = static_cast<const float4*>(weights[l]);
  }
  if (k == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(lv, num_levels, out, k, c, st);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(lv, num_levels, out, k, c, st);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(lv, num_levels, out, k, c, st);
  else
    launch<float, float>(lv, num_levels, out, k, c, st);
  return (int)cudaGetLastError();
}

const char* tap_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
