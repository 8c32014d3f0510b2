// Fused adaptive-mixing core: relu(LN2d(s @ relu(LN2d(x @ m)))) per item
// (sm_90a).
//
// Replaces: sparsebev_tpu/ops/mixing_pallas.py::mixing_core_tpu (pallas_call
// at :92, body _mixing_kernel :40; two-pass LN statistics) and
// ::mixing_core_tpu_batched (pallas_call at :177, body
// _mixing_kernel_batched :115; one-pass statistics). Neither is wired into
// the decoder, in the JAX package or in the port: both keep x @ m and s @ h1
// in fp32 up to each LN, where the decoder's bf16 matmuls round them first.
//
// Per item b (b runs over BQ * G), with LN2d a parameter-free layer norm
// over both trailing dims in fp32 and eps = 1e-5:
//   h1 = x[b] @ m[b]                    [P, C] fp32 (exact bf16 products)
//   h1 = relu((h1 - mu) / sqrt(var + eps)), rounded to the input dtype
//   h2 = s[b] @ h1                      [O, C] fp32
//   out[b] = relu((h2 - mu2) / sqrt(var2 + eps)) in the input dtype
// Two-pass statistics (mixing_core_twopass): mu = mean(h),
// var = mean((h - mu)^2) (_mixing_kernel :56-60, :66-71). One-pass
// (mixing_core_onepass): mu = mean(h), var = max(mean(h^2) - mu^2, 0)
// (_mixing_kernel_batched :134-140, :148-154). fp32 sums run in another
// order than PyTorch's, so the plain version agrees within a tolerance,
// not bit for bit.
//
// Bound: bytes. At r50 (BQ = 900, G = 4, P = 32, C = 64, O = 128, bf16) each
// of the 3,600 items reads 4 KB of x, 8 KB of m and 8 KB of s and writes
// 16 KB: 132.7 MB, 40 us at 3.35 TB/s. At vov99 (BQ = 1600, P = 60):
// 304.7 MB, 91 us. The 2.8 GFLOP (r50) would take about 3 us on the bf16
// tensor cores.
//
// Design: one block of 256 threads per item. The block loads x, m and s
// once, as fp32, into shared memory (x and s rows padded to an odd stride so
// the A-operand reads of a warp fall in different banks), runs both products
// as fp32 FMA loops in which each thread owns 4 rows x 4 columns of the
// output (one float4 of B per k step feeds 16 FMAs), keeps h1 and h2 in
// shared memory, and takes each LN's statistics with a warp-shuffle and
// shared-memory block reduction. Nothing but the output goes back to device
// memory. About 82 KB of shared memory per item at r50 and 111 KB at vov99:
// two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sums (a, b) over the block; every thread gets the totals, added in the
// same order in every thread.
__device__ float2 block_sum2(float a, float b, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    ta += red[i];
    tb += red[kWarps + i];
  }
  return make_float2(ta, tb);
}

// LN2d statistics of h [n] in shared memory: the mean and 1/sqrt(var+eps).
template <bool kTwoPass>
__device__ float2 ln_stats(const float* h, int n, float eps, float* red) {
  float a = 0.f, b = 0.f;
  float mu, var;
  if (kTwoPass) {
    for (int e = threadIdx.x; e < n; e += kThreads) a += h[e];
    mu = block_sum2(a, 0.f, red).x / n;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const float d = h[e] - mu;
      b += d * d;
    }
    var = block_sum2(b, 0.f, red).x / n;
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const float v = h[e];
      a += v;
      b += v * v;
    }
    const float2 t = block_sum2(a, b, red);
    mu = t.x / n;
    var = fmaxf(t.y / n - mu * mu, 0.f);
  }
  return make_float2(mu, 1.f / sqrtf(var + eps));
}

// D[rows, ncols] = A[rows, kdim] @ B[kdim, ncols], all in shared memory;
// A has row stride lda, B and D have row stride ncols (a multiple of 4 whose
// quarter divides the block). Each thread owns kRowsPerThread rows (every
// rgs-th) x 4 adjacent columns per pass.
__device__ void gemm_smem(const float* A, int lda, const float* B, float* D,
                          int rows, int kdim, int ncols) {
  const int cgs = ncols >> 2;
  const int rgs = kThreads / cgs;
  const int cg = threadIdx.x % cgs;
  const int rg = threadIdx.x / cgs;
  for (int r0 = rg; r0 < rows; r0 += rgs * kRowsPerThread) {
    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int kk = 0; kk < kdim; ++kk) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + kk * ncols + 4 * cg);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = r0 + i * rgs;
        const float a = r < rows ? A[r * lda + kk] : 0.f;
        acc[i][0] = __fmaf_rn(a, b.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(a, b.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(a, b.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(a, b.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + i * rgs;
      if (r < rows)
        *reinterpret_cast<float4*>(D + r * ncols + 4 * cg) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

__host__ __device__ __forceinline__ int align4(int n) { return (n + 3) & ~3; }

struct Layout {
  int ldx, lds, off_m, off_s, off_h1, off_h2, off_red, floats;
};

__host__ __device__ inline Layout layout(int p, int c, int o) {
  Layout l;
  l.ldx = c | 1;
  l.lds = p | 1;
  l.off_m = align4(p * l.ldx);
  l.off_s = l.off_m + align4(c * c);
  l.off_h1 = l.off_s + align4(o * l.lds);
  l.off_h2 = l.off_h1 + align4(p * c);
  l.off_red = l.off_h2 + align4(o * c);
  l.floats = l.off_red + 2 * kWarps;
  return l;
}

template <typename T, bool kTwoPass>
__global__ void __launch_bounds__(kThreads)
    mixing_kernel(const T* __restrict__ x, const T* __restrict__ m,
                  const T* __restrict__ s, T* __restrict__ out, int p, int c,
                  int o, float eps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout l = layout(p, c, o);
  float* xs = smem;
  float* ms = smem + l.off_m;
  float* ss = smem + l.off_s;
  float* h1 = smem + l.off_h1;
  float* h2 = smem + l.off_h2;
  float* red = smem + l.off_red;
  const int64_t item = blockIdx.x;
  const T* xg = x + item * p * c;
  const T* mg = m + item * c * c;
  const T* sg = s + item * o * p;
  T* og = out + item * o * c;

  for (int e = threadIdx.x; e < p * c; e += kThreads)
    xs[(e / c) * l.ldx + e % c] = to_f(xg[e]);
  for (int e = threadIdx.x; e < c * c; e += kThreads) ms[e] = to_f(mg[e]);
  for (int e = threadIdx.x; e < o * p; e += kThreads)
    ss[(e / p) * l.lds + e % p] = to_f(sg[e]);
  __syncthreads();

  gemm_smem(xs, l.ldx, ms, h1, p, c, c);
  __syncthreads();
  const float2 st1 = ln_stats<kTwoPass>(h1, p * c, eps, red);
  for (int e = threadIdx.x; e < p * c; e += kThreads)
    h1[e] = to_f(from_f<T>(fmaxf((h1[e] - st1.x) * st1.y, 0.f)));
  __syncthreads();

  gemm_smem(ss, l.lds, h1, h2, o, p, c);
  __syncthreads();
  const float2 st2 = ln_stats<kTwoPass>(h2, o * c, eps, red);
  for (int e = threadIdx.x; e < o * c; e += kThreads)
    og[e] = from_f<T>(fmaxf((h2[e] - st2.x) * st2.y, 0.f));
}

template <bool kTwoPass>
int launch(const void* x, const void* m, const void* s, void* out,
           long long n, int p, int c, int o, int is_bf16, float eps,
           void* stream) {
  if (n < 0 || p < 1 || o < 1 || c < 4 || c % 4 != 0 ||
      kThreads % (c / 4) != 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)layout(p, c, o).floats * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    auto kern = mixing_kernel<__nv_bfloat16, kTwoPass>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    kern<<<(unsigned)n, kThreads, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(s),
        static_cast<__nv_bfloat16*>(out), p, c, o, eps);
  } else {
    auto kern = mixing_kernel<float, kTwoPass>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    kern<<<(unsigned)n, kThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(m),
        static_cast<const float*>(s), static_cast<float*>(out), p, c, o,
        eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [n, p, c], m [n, c, c], s [n, o, p] and out [n, o, c], contiguous, all
// bf16 (is_bf16 = 1) or all fp32; n = BQ * G items.
int mixing_core_twopass(const void* x, const void* m, const void* s,
                        void* out, long long n, int p, int c, int o,
                        int is_bf16, float eps, void* stream) {
  return launch<true>(x, m, s, out, n, p, c, o, is_bf16, eps, stream);
}

int mixing_core_onepass(const void* x, const void* m, const void* s,
                        void* out, long long n, int p, int c, int o,
                        int is_bf16, float eps, void* stream) {
  return launch<false>(x, m, s, out, n, p, c, o, is_bf16, eps, stream);
}

const char* mixing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
