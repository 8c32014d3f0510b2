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

const char* msmv_pack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
