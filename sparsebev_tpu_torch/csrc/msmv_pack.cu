// y-fold pack of one pyramid level into grouped sampling tables (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_pack_pallas.py::pack_level_tpu
// (pallas_call at :83, body _pack_kernel :32).
//
// Computes feat [M, H, W, C] -> out [M, H, G, W+1, 2Cg] (Cg = C / G):
//   out[m, h, g, x, 0:Cg]    = feat[m, h,   x, g*Cg:(g+1)*Cg]
//   out[m, h, g, x, Cg:2Cg]  = feat[m, h+1, x, g*Cg:(g+1)*Cg]   (0 at h = H-1)
//   out[m, h, g, W, :]       = 0                                 (guard column)
// A pure copy: the result equals the plain version bit for bit in any dtype.
//
// Bound: bytes. One pass reads each input element once and writes each
// output element once (flagship r50 frame, 4 levels, bf16: 45.9 MB read,
// 92.7 MB written). No arithmetic.
//
// Design: one thread per 16-byte vector of an INPUT pixel's group slice
// (plus the guard column). A thread loads its vector once and stores it
// twice: into row h's first half and into row h-1's second half; the
// bottom row's second half and the guard column are stored as zeros by the
// threads that own those positions. Threads run (vector, group, column)
// fastest, so a warp reads 512 contiguous input bytes and writes whole
// 128-byte half-rows. The vector width drops to 8/4/2 bytes when Cg does
// not fill 16-byte vectors (tiny test shapes).
//
// The adjoint (msmv_pack_level_bwd) replaces the XLA chain of
// sparsebev_tpu/ops/msmv_pack_pallas.py::_pack_level_bwd (:125):
//   dfeat[m, h, x, g*Cg + c] = dT[m, h, g, x, c] + dT[m, h-1, g, x, Cg + c]
// with the second term 0 at h = 0 and the guard column dropped. The one add
// is an fp32 add rounded once to the table dtype, which for bf16 operands is
// what a bf16 add gives (JAX adds in the table dtype): bit-equal to the
// plain version. Bound: bytes, dT read once (guard column excepted) and
// dfeat written once; at r50 (T=8, 48 images a level, bf16) 740 MB read and
// 368 MB written a step, 0.33 ms at 3.35 TB/s. Design: one thread per
// 16-byte vector of dfeat, the mirror of the forward: it loads the two
// vectors that the forward stored from this position, adds and stores.
// Threads run (vector, group, column) fastest, so a warp writes 512
// contiguous bytes of dfeat and reads whole 128-byte half-rows of dT.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void pack_yfold_kernel(const V* __restrict__ feat,
                                  V* __restrict__ out,
                                  int64_t total, int h, int w, int g,
                                  int vg) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx -> (m, y, x in [0, W], gi, v), v fastest
  const int v = (int)(idx % vg);
  int64_t r = idx / vg;
  const int gi = (int)(r % g);
  r /= g;
  const int x = (int)(r % (w + 1));
  r /= (w + 1);
  const int y = (int)(r % h);
  const int64_t m = r / h;

  // out[m, y, gi, x, half, v] with half-rows of vg vectors
  auto out_at = [&](int yy, int half) -> V* {
    return out + (((((m * h + yy) * g + gi) * (int64_t)(w + 1) + x) * 2
                   + half) * vg + v);
  };
  const V zero = V{};
  if (x == w) {  // zero guard column, both halves
    *out_at(y, 0) = zero;
    *out_at(y, 1) = zero;
    return;
  }
  const V val = feat[(((m * h + y) * (int64_t)w + x) * g + gi) * vg + v];
  *out_at(y, 0) = val;
  if (y > 0) *out_at(y - 1, 1) = val;
  if (y == h - 1) *out_at(y, 1) = zero;
}

template <typename V>
cudaError_t launch(const void* feat, void* out, int m, int h, int w, int g,
                   int vg, cudaStream_t stream) {
  const int64_t total = (int64_t)m * h * (w + 1) * g * vg;
  if (total == 0) return cudaGetLastError();
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pack_yfold_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(feat), static_cast<V*>(out), total, h, w, g, vg);
  return cudaGetLastError();
}

// a + b per element of a vector V of bf16 (fp32 add, one rounding) or fp32
template <typename V, bool BF16>
__device__ __forceinline__ V add_elements(const V& a, const V& b) {
  V r;
  if constexpr (BF16) {
    constexpr int kN = sizeof(V) / 2;
    const uint16_t* pa = reinterpret_cast<const uint16_t*>(&a);
    const uint16_t* pb = reinterpret_cast<const uint16_t*>(&b);
    uint16_t* pr = reinterpret_cast<uint16_t*>(&r);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const float fa = __uint_as_float((uint32_t)pa[i] << 16);
      const float fb = __uint_as_float((uint32_t)pb[i] << 16);
      pr[i] = __bfloat16_as_ushort(__float2bfloat16_rn(fa + fb));
    }
  } else {
    constexpr int kN = sizeof(V) / 4;
    const float* pa = reinterpret_cast<const float*>(&a);
    const float* pb = reinterpret_cast<const float*>(&b);
    float* pr = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int i = 0; i < kN; ++i) pr[i] = pa[i] + pb[i];
  }
  return r;
}

template <typename V, bool BF16>
__global__ void pack_yfold_bwd_kernel(const V* __restrict__ dt,
                                      V* __restrict__ dfeat, int64_t total,
                                      int h, int w, int g, int vg) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx -> (m, y, x in [0, W), gi, v), v fastest: dfeat's own order
  const int v = (int)(idx % vg);
  int64_t r = idx / vg;
  const int gi = (int)(r % g);
  r /= g;
  const int x = (int)(r % w);
  r /= w;
  const int y = (int)(r % h);
  const int64_t m = r / h;
  // dT[m, yy, gi, x, half, v] with half-rows of vg vectors
  auto dt_at = [&](int yy, int half) -> const V* {
    return dt + (((((m * h + yy) * g + gi) * (int64_t)(w + 1) + x) * 2
                  + half) * vg + v);
  };
  const V first = *dt_at(y, 0);
  const V second = y > 0 ? *dt_at(y - 1, 1) : V{};
  dfeat[idx] = add_elements<V, BF16>(first, second);
}

template <typename V, bool BF16>
cudaError_t launch_bwd(const void* dt, void* dfeat, int m, int h, int w,
                       int g, int vg, cudaStream_t stream) {
  const int64_t total = (int64_t)m * h * w * g * vg;
  if (total == 0) return cudaGetLastError();
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pack_yfold_bwd_kernel<V, BF16><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(dt), static_cast<V*>(dfeat), total, h, w, g, vg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feat: [m, h, w, c] contiguous, out: [m, h, g, w+1, 2*c/g] contiguous;
// half_row_bytes = (c / g) * itemsize; vec_bytes in {16, 8, 4, 2} divides
// half_row_bytes and both pointers' alignment (the wrapper picks it).
int msmv_pack_level(const void* feat, void* out, int m, int h, int w,
                    int g, int half_row_bytes, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vg = half_row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: return (int)launch<uint4>(feat, out, m, h, w, g, vg, s);
    case 8: return (int)launch<uint2>(feat, out, m, h, w, g, vg, s);
    case 4: return (int)launch<uint32_t>(feat, out, m, h, w, g, vg, s);
    case 2: return (int)launch<uint16_t>(feat, out, m, h, w, g, vg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dt: [m, h, g, w+1, 2*c/g] contiguous, dfeat: [m, h, w, c] contiguous, bf16
// (is_bf16 1) or fp32 (0); half_row_bytes and vec_bytes as above.
int msmv_pack_level_bwd(const void* dt, void* dfeat, int m, int h, int w,
                        int g, int half_row_bytes, int vec_bytes,
                        int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vg = half_row_bytes / vec_bytes;
  if (is_bf16) {
    switch (vec_bytes) {
      case 16: return (int)launch_bwd<uint4, true>(dt, dfeat, m, h, w, g, vg, s);
      case 8: return (int)launch_bwd<uint2, true>(dt, dfeat, m, h, w, g, vg, s);
      case 4: return (int)launch_bwd<uint32_t, true>(dt, dfeat, m, h, w, g, vg, s);
      case 2: return (int)launch_bwd<uint16_t, true>(dt, dfeat, m, h, w, g, vg, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (vec_bytes) {
    case 16: return (int)launch_bwd<uint4, false>(dt, dfeat, m, h, w, g, vg, s);
    case 8: return (int)launch_bwd<uint2, false>(dt, dfeat, m, h, w, g, vg, s);
    case 4: return (int)launch_bwd<uint32_t, false>(dt, dfeat, m, h, w, g, vg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msmv_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
