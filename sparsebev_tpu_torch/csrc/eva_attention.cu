// Exact softmax attention of the EVA02 ViT's windowed and global blocks, fp32
// (sm_90a).
//
// Replaces: sparsebev_tpu/models/eva02.py::EvaAttention (:182), whose
// jax.nn.dot_product_attention calls (XLA, not Pallas) run directly for the
// windowed blocks (:213) and inside _chunked_attention for the global ones
// (:151, call at :175). The JAX EVA02 trunk runs in fp32 under a bf16
// compute dtype (its Linear and LayerNorm promote against fp32 parameters),
// so q, k and v are fp32 here.
//
// Input: q, k, v [B, N, H, HD] fp32 in the JAX layout (token-major, heads
// inside a token), out the same. For each (b, h) and query t:
//   s_j = (q_t . k_j) * HD^-0.5,
//   out_t = sum_j exp(s_j - m) v_j / sum_j exp(s_j - m)
// with m the row's maximum. The plain PyTorch version
// (ops/eva_attention.py::eva_attention_plain) normalises the probabilities
// before the product with v and sums in another order, so the two differ by
// fp32 rounding only.
//
// Bound: operations. 4 * B * H * N^2 * HD flops (two products of N x N x HD
// multiply-adds) against the fp32 rate outside the tensor cores (67 TFLOP/s
// on the H100 SXM). Global blocks at 1600x640: B = 6, N = 4000, H = 16, HD =
// 64: 393 GFLOP, 5.9 ms; q, k, v and out are 393 MB, 0.12 ms at 3.35 TB/s.
// Windowed blocks: B = 126 (21 padded 16x16 windows a view), N = 256: 33.8
// GFLOP, 0.50 ms.
//
// Design: flash-style online softmax; no N x N scores reach device memory.
// A block takes 128 queries of one (b, h), one query a thread: its q row and
// its fp32 accumulator (HD values each) live in registers. Key and value
// tiles of 64 rows are staged through shared memory by the whole block (16-
// byte loads, each row HD contiguous floats) and read back as broadcast
// float4s, so every shared-memory load feeds four multiply-adds. Scores are
// taken 16 keys at a time (16 independent dot products for the scheduler to
// interleave); the running maximum and sum stay in fp32 registers, the
// accumulator is rescaled by exp(m_old - m_new) for each group of 16 and
// divided by the sum at the end. Keys past N in the last tile are zero-
// filled and their scores set to -inf; queries past N compute and store
// nothing. The multiply-adds are explicit fmaf (the build's --fmad=false
// keeps the compiler from contracting, not these); exponentials are expf,
// no fast math. A TF32 mma.sync / wgmma design is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // queries a block, one a thread
constexpr int kKeys = 64;      // key / value rows a shared-memory tile
constexpr int kGroup = 16;     // scores a thread holds at once

template <int HD>
__global__ void __launch_bounds__(kThreads)
eva_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int n, int heads, float scale) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  constexpr int kVec = HD / 4;  // float4s a row
  __shared__ __align__(16) float4 ks[kKeys * kVec];
  __shared__ __align__(16) float4 vs[kKeys * kVec];

  const long long stride = static_cast<long long>(heads) * HD;  // a token
  const long long base = static_cast<long long>(blockIdx.z) * n * stride +
                         static_cast<long long>(blockIdx.y) * HD;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < n;

  float qr[HD];
  float acc[HD];
  {
    const float4* src = reinterpret_cast<const float4*>(q + base + t * stride);
#pragma unroll
    for (int d = 0; d < kVec; ++d) {
      const float4 x =
          active ? __ldg(src + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * d] = x.x;
      qr[4 * d + 1] = x.y;
      qr[4 * d + 2] = x.z;
      qr[4 * d + 3] = x.w;
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int j0 = 0; j0 < n; j0 += kKeys) {
    const int nk = min(kKeys, n - j0);
    __syncthreads();  // the previous tile is consumed
    for (int f = threadIdx.x; f < kKeys * kVec; f += kThreads) {
      const int r = f / kVec;
      const int c = f - r * kVec;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (r < nk) {
        const long long off = base + (j0 + r) * stride;
        kx = __ldg(reinterpret_cast<const float4*>(k + off) + c);
        vx = __ldg(reinterpret_cast<const float4*>(v + off) + c);
      }
      ks[f] = kx;
      vs[f] = vx;
    }
    __syncthreads();

    for (int g0 = 0; g0 < nk; g0 += kGroup) {
      float s[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < kVec; ++d) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float4 kx = ks[(g0 + j) * kVec + d];
          s[j] = fmaf(qr[4 * d], kx.x, s[j]);
          s[j] = fmaf(qr[4 * d + 1], kx.y, s[j]);
          s[j] = fmaf(qr[4 * d + 2], kx.z, s[j]);
          s[j] = fmaf(qr[4 * d + 3], kx.w, s[j]);
        }
      }
      float gmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        s[j] = g0 + j < nk ? s[j] * scale : -INFINITY;
        gmax = fmaxf(gmax, s[j]);
      }
      // the group holds at least one key, so m_new is finite; the first
      // group's correction is exp(-inf) = 0 on a zero accumulator
      const float m_new = fmaxf(m, gmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float p = expf(s[j] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < kVec; ++d) {
          const float4 vx = vs[(g0 + j) * kVec + d];
          acc[4 * d] = fmaf(p, vx.x, acc[4 * d]);
          acc[4 * d + 1] = fmaf(p, vx.y, acc[4 * d + 1]);
          acc[4 * d + 2] = fmaf(p, vx.z, acc[4 * d + 2]);
          acc[4 * d + 3] = fmaf(p, vx.w, acc[4 * d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    float4* dst = reinterpret_cast<float4*>(out + base + t * stride);
#pragma unroll
    for (int d = 0; d < kVec; ++d) {
      dst[d] = make_float4(acc[4 * d] / l, acc[4 * d + 1] / l,
                           acc[4 * d + 2] / l, acc[4 * d + 3] / l);
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, out: [batch, n, heads, head_dim] fp32, contiguous, 16-byte
// aligned. head_dim 64 only (the EVA02 configs' 1024 / 16); anything else is
// cudaErrorInvalidValue. Launches one kernel on `stream`.
int eva_attention_forward(const void* q, const void* k, const void* v,
                          void* out, int batch, int n, int heads,
                          int head_dim, void* stream) {
  if (head_dim != 64 || batch <= 0 || n <= 0 || heads <= 0 ||
      batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, heads, batch);
  eva_attention_kernel<64><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, heads,
      1.0f / sqrtf(64.0f));
  return (int)cudaGetLastError();
}

const char* eva_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
