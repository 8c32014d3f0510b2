// Pair-mode pack of one pyramid level into grouped sampling tables (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_pack_pallas.py::pack_level_pair_tpu
// (pallas_call at :177, body _pack_pair_kernel :142).
//
// Computes feat [M, H, W, C] -> out [M, H, G, W+1, Cg] (Cg = C / G):
//   out[m, h, g, x, :] = feat[m, h, x, g*Cg:(g+1)*Cg]   (x < W)
//   out[m, h, g, W, :] = 0                              (guard column)
// The (W <-> G) permute plus the guard column, with no y-interleave: the
// sampling op reads two rows per point instead. A pure copy: the result
// equals the plain version bit for bit in any dtype.
//
// Bound: bytes. One pass reads each input element once and writes each
// output element once. At vov99 level 0 (M = 6 views, 160 x 400, C = 256,
// G = 4, bf16) a frame reads 196.6 MB and writes 197.1 MB
// (6 * 160 * 4 * 401 * 64 * 2 B): about 118 us at 3.35 TB/s. No arithmetic.
//
// Design: as the y-fold pack (csrc/msmv_pack.cu). One thread per 16-byte
// vector of an input pixel's group slice, plus the guard column's vectors,
// which their threads store as zeros. Threads run (vector, group, column)
// fastest, so a warp reads 512 contiguous input bytes and writes whole
// 128-byte output rows (Cg = 64 in bf16). The vector width drops to
// 8/4/2 bytes when Cg does not fill 16-byte vectors (tiny test shapes).
//
// The adjoint (msmv_pack_pair_level_bwd) replaces the XLA chain of
// sparsebev_tpu/ops/msmv_pack_pallas.py::_pack_pair_bwd (:214):
//   dfeat[m, h, x, g*Cg + c] = dT[m, h, g, x, c]
// the guard column dropped and (G, W) permuted back; each feature element
// has one table copy, so it is a pure copy again, bit-equal in any dtype.
// Bound: bytes, dT read once (guard column excepted) and dfeat written
// once; at vov99 level 0 (6 x 160 x 400 x 256, bf16) 196.6 MB each way,
// about 117 us at 3.35 TB/s. Design: one thread per 16-byte vector of
// dfeat, in dfeat's order, so a warp writes 512 contiguous bytes and reads
// whole 128-byte rows of dT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void pack_pair_kernel(const V* __restrict__ feat,
                                 V* __restrict__ out, int64_t total, int w,
                                 int g, int vg) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx -> (image row r = m * H + y, x in [0, W], gi, v), v fastest
  const int v = (int)(idx % vg);
  int64_t r = idx / vg;
  const int gi = (int)(r % g);
  r /= g;
  const int x = (int)(r % (w + 1));
  r /= (w + 1);

  V* dst = out + ((r * g + gi) * (int64_t)(w + 1) + x) * vg + v;
  if (x == w) {  // zero guard column
    *dst = V{};
    return;
  }
  *dst = feat[((r * w + x) * g + gi) * vg + v];
}

template <typename V>
cudaError_t launch(const void* feat, void* out, int m, int h, int w, int g,
                   int vg, cudaStream_t stream) {
  const int64_t total = (int64_t)m * h * (w + 1) * g * vg;
  if (total == 0) return cudaGetLastError();
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pack_pair_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(feat), static_cast<V*>(out), total, w, g, vg);
  return cudaGetLastError();
}

template <typename V>
__global__ void pack_pair_bwd_kernel(const V* __restrict__ dt,
                                     V* __restrict__ dfeat, int64_t total,
                                     int w, int g, int vg) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx -> (image row r = m * H + y, x in [0, W), gi, v), v fastest
  const int v = (int)(idx % vg);
  int64_t r = idx / vg;
  const int gi = (int)(r % g);
  r /= g;
  const int x = (int)(r % w);
  r /= w;
  dfeat[idx] = dt[((r * g + gi) * (int64_t)(w + 1) + x) * vg + v];
}

template <typename V>
cudaError_t launch_bwd(const void* dt, void* dfeat, int m, int h, int w,
                       int g, int vg, cudaStream_t stream) {
  const int64_t total = (int64_t)m * h * w * g * vg;
  if (total == 0) return cudaGetLastError();
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pack_pair_bwd_kernel<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(dt), static_cast<V*>(dfeat), total, w, g, vg);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// feat: [m, h, w, c] contiguous, out: [m, h, g, w+1, c/g] contiguous;
// row_bytes = (c / g) * itemsize; vec_bytes in {16, 8, 4, 2} divides
// row_bytes and both pointers' alignment (the wrapper picks it).
int msmv_pack_pair_level(const void* feat, void* out, int m, int h, int w,
                         int g, int row_bytes, int vec_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vg = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: return (int)launch<uint4>(feat, out, m, h, w, g, vg, s);
    case 8: return (int)launch<uint2>(feat, out, m, h, w, g, vg, s);
    case 4: return (int)launch<uint32_t>(feat, out, m, h, w, g, vg, s);
    case 2: return (int)launch<uint16_t>(feat, out, m, h, w, g, vg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dt: [m, h, g, w+1, c/g] contiguous, dfeat: [m, h, w, c] contiguous;
// row_bytes and vec_bytes as above. is_bf16 is not read (a copy).
int msmv_pack_pair_level_bwd(const void* dt, void* dfeat, int m, int h,
                             int w, int g, int row_bytes, int vec_bytes,
                             int is_bf16, void* stream) {
  (void)is_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vg = row_bytes / vec_bytes;
  switch (vec_bytes) {
    case 16: return (int)launch_bwd<uint4>(dt, dfeat, m, h, w, g, vg, s);
    case 8: return (int)launch_bwd<uint2>(dt, dfeat, m, h, w, g, vg, s);
    case 4: return (int)launch_bwd<uint32_t>(dt, dfeat, m, h, w, g, vg, s);
    case 2: return (int)launch_bwd<uint16_t>(dt, dfeat, m, h, w, g, vg, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* msmv_pack_pair_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
