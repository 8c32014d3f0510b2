// Bilinear sampling of one small pyramid level from a bf16 [S, N*H, W*C]
// table, for the hybrid sampling path (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_pallas.py::onehot_sample_level
// (pallas_call at :132, body _onehot_sample_kernel :54). The TPU kernel
// builds dense one-hot matrices (row weights a [K, N*H], x weights
// xsel [K, W]) and runs three skinny matmuls per query block, only because
// the TPU gathers slowly. Here each point reads its taps directly.
//
// For each point k of slice si (contract of the JAX function, :89-108):
//   a0 = bf16(wy0 + wy1) and a1 = 0   where rows0 == rows1
//   a0 = bf16(wy0),     a1 = bf16(wy1) otherwise
//   b0 = bf16(wx0), b1 = bf16(wx1)
//   g(col) = a0 * F[si, rows0, col] + a1 * F[si, rows1, col]       (fp32)
//   out[si, k] = bf16(g(x0) * b0) + bf16(g(x0 + 1) * b1)           (fp32)
// where F[si, r, col] is the C channels at column col of table row r. These
// are the four roundings of the JAX code (the bf16 one-hot matrices :124-125
// and gx = (g * xsel).astype(bf16) :81); XLA keeps all four on the CPU, under
// jax.jit as well as op by op. A bf16 weight times a bf16 tap is exact in
// fp32, so the matmul g = a @ F is the fp32 sum of the two products in any
// order. Built with --fmad=false, so every product and sum rounds on its
// own as in the plain PyTorch version, which gives the same bits.
//
// Bound: bytes. Per point at most four runs of C bf16 values (two rows x
// two columns: at C = 64 two 256-byte windows), 28 bytes of scalars and C
// fp32 outputs (256 bytes at C = 64). The table bytes that points share are
// read once at the bound. The arithmetic is 6 products and sums per channel.
//
// Design: one warp per point. Each lane owns two channels and loads them as
// one bf16x2 from each of the four tap runs, so a warp's load of one run is
// C * 2 contiguous bytes (128 bytes at C = 64). The point's seven scalars
// are read by every lane as a broadcast. No shared memory, no atomics: each
// output element is written once by one lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairsPerLane = 4;  // C <= 256

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__global__ void onehot_sample_kernel(const __nv_bfloat16* __restrict__ table,
                                     const int* __restrict__ rows0,
                                     const int* __restrict__ rows1,
                                     const float* __restrict__ wy0,
                                     const float* __restrict__ wy1,
                                     const int* __restrict__ x0,
                                     const float* __restrict__ wx0,
                                     const float* __restrict__ wx1,
                                     float* __restrict__ out, int64_t k,
                                     int64_t num_points, int nh, int w,
                                     int c) {
  const int lane = threadIdx.x & 31;
  const int64_t pt = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (pt >= num_points) return;
  const int64_t si = pt / k;
  // in range by contract; clamped so that a bad index cannot read outside
  // the slice's table
  const int r0 = min(max(rows0[pt], 0), nh - 1);
  const int r1 = min(max(rows1[pt], 0), nh - 1);
  const int xx = min(max(x0[pt], 0), w - 2);
  const bool same = r0 == r1;
  const float a0 = round_bf16(same ? wy0[pt] + wy1[pt] : wy0[pt]);
  const float a1 = same ? 0.f : round_bf16(wy1[pt]);
  const float b0 = round_bf16(wx0[pt]);
  const float b1 = round_bf16(wx1[pt]);
  const __nv_bfloat16* slice = table + si * nh * (int64_t)w * c;
  const __nv_bfloat16* t0 = slice + ((int64_t)r0 * w + xx) * c;
  const __nv_bfloat16* t1 = slice + ((int64_t)r1 * w + xx) * c;
  float* o = out + pt * c;
#pragma unroll
  for (int j = 0; j < kMaxPairsPerLane; ++j) {
    const int cc = 2 * (lane + 32 * j);
    if (cc < c) {
      const float2 f00 = load2(t0 + cc);      // row r0, column x0
      const float2 f01 = load2(t0 + c + cc);  // row r0, column x0 + 1
      const float2 f10 = load2(t1 + cc);
      const float2 f11 = load2(t1 + c + cc);
      const float gl_x = a0 * f00.x + a1 * f10.x;
      const float gl_y = a0 * f00.y + a1 * f10.y;
      const float gr_x = a0 * f01.x + a1 * f11.x;
      const float gr_y = a0 * f01.y + a1 * f11.y;
      *reinterpret_cast<float2*>(o + cc) =
          make_float2(round_bf16(gl_x * b0) + round_bf16(gr_x * b1),
                      round_bf16(gl_y * b0) + round_bf16(gr_y * b1));
    }
  }
}

}  // namespace

extern "C" {

// table: [s, nh, w*c] bf16 contiguous; rows0/rows1/x0 int32 and
// wy0/wy1/wx0/wx1 fp32, each [s, k] contiguous; out: [s, k, c] fp32.
int msmv_onehot_sample_level(const void* table, const int* rows0,
                             const int* rows1, const float* wy0,
                             const float* wy1, const int* x0,
                             const float* wx0, const float* wx1, float* out,
                             int s, long long k, int nh, int w, int c,
                             void* stream) {
  if (s < 0 || k < 0 || nh < 1 || w < 2 || c < 2 || c % 2 != 0 ||
      c > 64 * kMaxPairsPerLane)
    return (int)cudaErrorInvalidValue;
  const int64_t num_points = (int64_t)s * k;
  if (num_points == 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 points per block
  const int64_t blocks = (num_points * 32 + threads - 1) / threads;
  onehot_sample_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(table), rows0, rows1, wy0, wy1, x0,
      wx0, wx1, out, k, num_points, nh, w, c);
  return (int)cudaGetLastError();
}

const char* msmv_onehot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
