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
// Design: two kernels, chosen by the caller (ops/mixing.py::mixing_route).
//
// bf16 with C = 64, O = 128 and an even P <= 64 (the shapes of both model
// paths) takes the tensor-core kernel, mixing_mma_kernel. A persistent block
// of four warps walks the items blockIdx.x, blockIdx.x + gridDim.x, ...
// with two stages of operands in shared memory: while it works on one item
// every thread has the next item's x, m and s in flight as asynchronous
// copies (cp.async, 16 bytes a thread; 8 or 4 where a row of s is no
// multiple of 16 bytes, as the 120-byte rows at P = 60), so no load is
// waited for after the first. The operands stay bf16; each row lands at a
// stride 16 bytes past its length, which puts the eight rows of every
// ldmatrix in different banks (whole-operand cp.async.bulk copies would land
// the rows unpadded, eight-way bank conflicts in every ldmatrix of x and m,
// and cannot pad s's 120-byte rows). Both products are mma.sync.m16n8k16
// (bf16 in, fp32 accumulators): bf16 x bf16 is exact in fp32, so only the
// order of the sums differs from the plain version. wgmma is not used: its
// 64-row tile would be mostly padding in the first product (P = 32 rows) and
// the kernel is bound by bytes, not by the tensor cores. P is padded to PP,
// the next multiple of 16 (the caller computes it): x's padding rows are never
// read back (their products are masked out of the statistics and their h1
// rows are written as zeros), and s's padding columns are zeroed once per
// stage and never overwritten, so the second product adds exact zeros. The
// accumulators stay in registers through each LN: the statistics are taken
// from the fragments over exactly P * C and O * C values (warp shuffles,
// one shared-memory exchange per block sum), h1 goes to shared memory once,
// as bf16, as the B operand of the second product, and h2 is normalised in
// registers, transposed through the (by then dead) m buffer one 16-row tile
// a warp at a time, and written to device memory as 16-byte stores.
//
// Everything else (fp32 inputs; bf16 at other shapes) takes the FMA kernel,
// mixing_kernel: TF32 tensor cores would not compute this function, so fp32
// keeps full fp32. One block of 256 threads per item loads x, m and s as
// fp32 into shared memory (rows padded to an odd stride), runs both products
// as fp32 FMA loops in which each thread owns 4 rows x 4 columns, keeps h1
// and h2 in shared memory and takes each LN's statistics with a block
// reduction. About 82 KB of shared memory per item at r50, 111 KB at vov99.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, on the
// operands of one AdaptiveMixing call: bf16 0.057 ms at r50 (70% of its
// bound; the FMA kernel took 0.262) and 0.116 ms at vov99 (78%; 0.633),
// one-pass within 3% of two-pass; fp32 (FMA kernel) 0.269 and 0.645 ms.
// 96 to 127 registers, no stack frame, no spills; 52.9 KB of shared memory
// a block at P = 32 (four blocks an SM), 83.1 KB at P = 60 (two). A third
// block an SM at P = 60 (h1 stored over x) was no faster: the kernel sits
// at the rate the card's memory gives mixed reads and writes.

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

// ---------------------------------------------------------------------
// The tensor-core kernel (bf16, C = 64, O = 128, P padded to PP <= 64).

constexpr int kC = 64;               // channels per group
constexpr int kO = 128;              // out points
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kLdc = 2 * kC + 16;    // byte stride of a C-wide bf16 row
static_assert(kO == kMmaWarps * 32, "each warp owns 32 rows of h2");
static_assert(kO / 2 == kC, "the output tiles are staged in m's buffer");

__host__ __device__ constexpr int lds_bytes(int pp) { return 2 * pp + 16; }
__host__ __device__ constexpr int stage_bytes(int pp) {
  return pp * kLdc + kC * kLdc + kO * lds_bytes(pp);  // x, m, s
}
__host__ __device__ constexpr int mma_smem_bytes(int pp) {
  // two stages, h1, and four block sums of kMmaWarps float2
  return 2 * stage_bytes(pp) + pp * kLdc + 4 * kMmaWarps * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const char* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes)
                 : "memory");
}

// rows x row_bytes contiguous in device memory -> rows at byte stride ld in
// shared memory, kBytes per copy, the copies dealt round-robin to the
// block's threads.
template <int kBytes>
__device__ __forceinline__ void copy_rows(uint32_t dst, const char* src,
                                          int rows, int row_bytes, int ld) {
  const int per_row = row_bytes / kBytes;
  const int total = rows * per_row;
  const int drow = kMmaThreads / per_row;
  const int dcol = kMmaThreads % per_row;
  int row = (int)threadIdx.x / per_row;
  int col = (int)threadIdx.x % per_row;
  for (int i = threadIdx.x; i < total; i += kMmaThreads) {
    cp_async<kBytes>(dst + row * ld + col * kBytes, src + (size_t)i * kBytes);
    row += drow;
    col += dcol;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row-major fragment) @ b (16x8, column fragment), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sums (a, b) over the four warps; every thread gets the totals, added in
// the same order in every thread. `red` is this call site's own slot, so
// one barrier is enough.
__device__ __forceinline__ float2 mma_block_sum2(float a, float b,
                                                 float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float ta = 0.f, tb = 0.f;
#pragma unroll
  for (int i = 0; i < kMmaWarps; ++i) {
    ta += red[i].x;
    tb += red[i].y;
  }
  return make_float2(ta, tb);
}

// The mean and 1/sqrt(var + eps) over the `count` values of the accumulator
// tiles acc[tile][0..4) whose row is valid (valid[tile][0] for elements 0-1,
// the tile's row g; valid[tile][1] for elements 2-3, row g+8), as ln_stats
// defines them. red: two slots of kMmaWarps float2.
template <bool kTwoPass, int kT>
__device__ __forceinline__ float2 frag_stats(const float (&acc)[kT][4],
                                             const bool (&valid)[kT][2],
                                             int count, float eps,
                                             float2* red) {
  float a = 0.f, b = 0.f;
  float mu, var;
  if (kTwoPass) {
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a += valid[i][j >> 1] ? acc[i][j] : 0.f;
    mu = mma_block_sum2(a, 0.f, red).x / count;
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = acc[i][j] - mu;
        b += valid[i][j >> 1] ? d * d : 0.f;
      }
    var = mma_block_sum2(b, 0.f, red + kMmaWarps).x / count;
  } else {
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = valid[i][j >> 1] ? acc[i][j] : 0.f;
        a += v;
        b += v * v;
      }
    const float2 t = mma_block_sum2(a, b, red);
    mu = t.x / count;
    var = fmaxf(t.y / count - mu * mu, 0.f);
  }
  return make_float2(mu, 1.f / sqrtf(var + eps));
}

__device__ __forceinline__ uint32_t relu_ln_bf162(float v0, float v1,
                                                  float2 st, bool keep) {
  const float r0 = keep ? fmaxf((v0 - st.x) * st.y, 0.f) : 0.f;
  const float r1 = keep ? fmaxf((v1 - st.x) * st.y, 0.f) : 0.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int kPP, bool kTwoPass>
__global__ void __launch_bounds__(kMmaThreads)
    mixing_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ m,
                      const __nv_bfloat16* __restrict__ s,
                      __nv_bfloat16* __restrict__ out, int n, int p,
                      float eps) {
  constexpr int kMT1 = kPP / 16;         // row tiles of h1 = depth tiles of s
  constexpr int kLds = lds_bytes(kPP);
  constexpr int kStage = stage_bytes(kPP);
  constexpr int kOffM = kPP * kLdc;
  constexpr int kOffS = kOffM + kC * kLdc;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* h1 = smem + 2 * kStage;
  float2* red = reinterpret_cast<float2*>(h1 + kPP * kLdc);
  const uint32_t smem_a = smem_addr(smem);
  const uint32_t h1_a = smem_a + 2 * kStage;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;               // fragment row within a tile
  const int t = lane & 3;                // fragment column pair
  // this lane's row and 16-byte column within a 16x16 tile, for ldmatrix
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 16;
  const int s_row_bytes = 2 * p;

  // s's padding columns [p, kPP): zero once in both stages; no copy ever
  // writes them
  for (int e = threadIdx.x; e < 2 * kO * (kPP - p); e += kMmaThreads) {
    const int st = e / (kO * (kPP - p));
    const int r = (e / (kPP - p)) % kO;
    const int col = p + e % (kPP - p);
    *reinterpret_cast<__nv_bfloat16*>(smem + st * kStage + kOffS + r * kLds +
                                      2 * col) = __float2bfloat16_rn(0.f);
  }

  auto prefetch = [&](int item, int stage) {
    const uint32_t base = smem_a + stage * kStage;
    copy_rows<16>(base,
                  reinterpret_cast<const char*>(x + (size_t)item * p * kC), p,
                  2 * kC, kLdc);
    copy_rows<16>(base + kOffM,
                  reinterpret_cast<const char*>(m + (size_t)item * kC * kC),
                  kC, 2 * kC, kLdc);
    const char* sg = reinterpret_cast<const char*>(s + (size_t)item * kO * p);
    if (s_row_bytes % 16 == 0)
      copy_rows<16>(base + kOffS, sg, kO, s_row_bytes, kLds);
    else if (s_row_bytes % 8 == 0)
      copy_rows<8>(base + kOffS, sg, kO, s_row_bytes, kLds);
    else
      copy_rows<4>(base + kOffS, sg, kO, s_row_bytes, kLds);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if ((int)blockIdx.x < n) prefetch(blockIdx.x, 0);
  int stage = 0;
  for (int item = blockIdx.x; item < n; item += gridDim.x, stage ^= 1) {
    // the other stage was last read before the barrier that ended the
    // previous item; an empty group keeps the wait count the same
    if (item + (int)gridDim.x < n)
      prefetch(item + gridDim.x, stage ^ 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const uint32_t xs = smem_a + stage * kStage;
    const uint32_t ms = xs + kOffM;
    const uint32_t ss = xs + kOffS;

    // h1 = x @ m: this warp's 16 columns of every row tile
    // tile mi*2 + nt: rows mi*16.., columns warp*16 + nt*8..
    float acc1[kMT1 * 2][4];
#pragma unroll
    for (int i = 0; i < kMT1 * 2; ++i)
      acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kC / 16; ++kt) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ms + (kt * 16 + lrow) * kLdc + warp * 32 + lcol);
#pragma unroll
      for (int mi = 0; mi < kMT1; ++mi) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + (mi * 16 + lrow) * kLdc + kt * 32 + lcol);
        mma_bf16(acc1[mi * 2], a, b[0], b[1]);
        mma_bf16(acc1[mi * 2 + 1], a, b[2], b[3]);
      }
    }
    // x's padding rows [p, kPP) stay out of the LN and are zero in h1
    bool valid1[kMT1 * 2][2];
#pragma unroll
    for (int i = 0; i < kMT1 * 2; ++i) {
      valid1[i][0] = (i / 2) * 16 + g < p;
      valid1[i][1] = (i / 2) * 16 + g + 8 < p;
    }
    const float2 st1 = frag_stats<kTwoPass>(acc1, valid1, p * kC, eps, red);
#pragma unroll
    for (int mi = 0; mi < kMT1; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = mi * 2 + nt;
          const int row = mi * 16 + g + half * 8;
          *reinterpret_cast<uint32_t*>(h1 + row * kLdc + warp * 32 + nt * 16 +
                                       t * 4) =
              relu_ln_bf162(acc1[i][half * 2], acc1[i][half * 2 + 1], st1,
                            valid1[i][half]);
        }
    __syncthreads();

    // h2 = s @ h1: this warp's 32 rows, all 64 columns
    // tile mi*8 + nt: rows warp*32 + mi*16.., columns nt*8..
    float acc2[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kMT1; ++kt) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], ss + (warp * 32 + mi * 16 + lrow) * kLds +
                               kt * 32 + lcol);
#pragma unroll
      for (int np = 0; np < kC / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, h1_a + (kt * 16 + lrow) * kLdc + np * 32 + lcol);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc2[mi * 8 + 2 * np], a[mi], b[0], b[1]);
          mma_bf16(acc2[mi * 8 + 2 * np + 1], a[mi], b[2], b[3]);
        }
      }
    }
    bool valid2[16][2];
#pragma unroll
    for (int i = 0; i < 16; ++i) valid2[i][0] = valid2[i][1] = true;
    const float2 st2 =
        frag_stats<kTwoPass>(acc2, valid2, kO * kC, eps, red + 2 * kMmaWarps);

    // out: one 16-row tile at a time through this warp's 16 rows of m's
    // buffer (every warp is past its reads of m: the LN1 sums came after
    // them), then 16 bytes a lane to device memory
    unsigned char* tile = smem + stage * kStage + kOffM + warp * 16 * kLdc;
    __nv_bfloat16* og = out + ((size_t)item * kO + warp * 32) * kC;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = mi * 8 + nt;
          *reinterpret_cast<uint32_t*>(tile + (g + half * 8) * kLdc +
                                       nt * 16 + t * 4) =
              relu_ln_bf162(acc2[i][half * 2], acc2[i][half * 2 + 1], st2,
                            true);
        }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int chunk = lane + 32 * r;   // 16 rows x 8 runs of 16 bytes
        const int row = chunk >> 3;
        const int col = (chunk & 7) * 16;
        const uint4 v =
            *reinterpret_cast<const uint4*>(tile + row * kLdc + col);
        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(
                                      og + (mi * 16 + row) * kC) +
                                  col) = v;
      }
      __syncwarp();
    }
    __syncthreads();  // every read of this stage and of h1 is done
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int kPP, bool kTwoPass>
int launch_mma(const void* x, const void* m, const void* s, void* out, int n,
               int p, float eps, cudaStream_t st) {
  auto kern = mixing_mma_kernel<kPP, kTwoPass>;
  constexpr int bytes = mma_smem_bytes(kPP);
  // blocks that fit on the card at once: set up once per instantiation
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kMmaThreads, bytes);
    if (err != cudaSuccess) return (int)err;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidValue;
    resident = sms * per_sm;
  }
  const int blocks = n < resident ? n : resident;
  kern<<<blocks, kMmaThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(m),
      static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out),
      n, p, eps);
  return (int)cudaGetLastError();
}

// padded_p > 0 selects the tensor-core kernel: bf16, c = 64, o = 128, p
// even, padded_p the next multiple of 16 (at most 64). padded_p = 0 selects
// the FMA kernel.
template <bool kTwoPass>
int launch(const void* x, const void* m, const void* s, void* out,
           long long n, int p, int c, int o, int is_bf16, int padded_p,
           float eps, void* stream) {
  if (n < 0 || p < 1 || o < 1 || c < 4 || c % 4 != 0 ||
      kThreads % (c / 4) != 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (padded_p != 0) {
    if (!is_bf16 || c != kC || o != kO || p % 2 != 0 ||
        padded_p != (p + 15) / 16 * 16 || padded_p > 64)
      return (int)cudaErrorInvalidValue;
    if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(m) |
          reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(out)) &
         15) != 0)
      return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    switch (padded_p) {
      case 16:
        return launch_mma<16, kTwoPass>(x, m, s, out, (int)n, p, eps, st);
      case 32:
        return launch_mma<32, kTwoPass>(x, m, s, out, (int)n, p, eps, st);
      case 48:
        return launch_mma<48, kTwoPass>(x, m, s, out, (int)n, p, eps, st);
      default:
        return launch_mma<64, kTwoPass>(x, m, s, out, (int)n, p, eps, st);
    }
  }
  const size_t bytes = (size_t)layout(p, c, o).floats * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
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
// bf16 (is_bf16 = 1) or all fp32; n = BQ * G items. padded_p: p rounded up
// to a multiple of 16 for the tensor-core kernel (bf16, c = 64, o = 128, p
// even and at most 64, 16-byte aligned pointers), or 0 for the FMA kernel.
int mixing_core_twopass(const void* x, const void* m, const void* s,
                        void* out, long long n, int p, int c, int o,
                        int is_bf16, int padded_p, float eps, void* stream) {
  return launch<true>(x, m, s, out, n, p, c, o, is_bf16, padded_p, eps,
                      stream);
}

int mixing_core_onepass(const void* x, const void* m, const void* s,
                        void* out, long long n, int p, int c, int o,
                        int is_bf16, int padded_p, float eps, void* stream) {
  return launch<false>(x, m, s, out, n, p, c, o, is_bf16, padded_p, eps,
                       stream);
}

const char* mixing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
