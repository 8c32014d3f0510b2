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
// 304.7 MB, 91 us; at EVA02 (BQ = 1600, P = 8 x 15 frames = 120): 452.2 MB,
// 135 us. fp32 moves twice the bytes (r50 79 us, vov99 182 us, EVA02
// 270 us). The work is 2.83 / 9.44 / 18.87 GFLOP: on the fp32 FMA units
// (67 TFLOP/s) EVA02 would take 282 us, longer than its bytes, so no FMA
// kernel reaches the byte bound there; as 3xTF32 on the tensor cores
// (3 x 18.87 GFLOP at 495 TFLOP/s) 114 us.
//
// Design: three kernels, chosen by the caller (ops/mixing.py::mixing_route)
// by dtype and shape. C = 64 and O = 128 with P padded to PP <= 128 (every
// config: P = 32, 60 and 120) run on the tensor cores, in both dtypes; the
// FMA kernel serves only shapes no config has.
//
// bf16 with an even P takes mixing_mma_kernel. A persistent block of four
// warps walks the items blockIdx.x, blockIdx.x + gridDim.x, ... with two
// stages of operands in shared memory: while it works on one item every
// thread has the next item's x, m and s in flight as asynchronous copies
// (cp.async, 16 bytes a thread; 8 or 4 where a row of s is no multiple of 16
// bytes, as the 120-byte rows at P = 60), so no load is waited for after the
// first. The operands stay bf16; each row lands at a stride 16 bytes past
// its length, which puts the eight rows of every ldmatrix in different banks
// (whole-operand cp.async.bulk copies would land the rows unpadded,
// eight-way bank conflicts in every ldmatrix of x and m, and cannot pad s's
// 120-byte rows). Both products are mma.sync.m16n8k16 (bf16 in, fp32
// accumulators): bf16 x bf16 is exact in fp32, so only the order of the sums
// differs from the plain version. wgmma is not used: its 64-row tile would
// be mostly padding in the first product (P = 32 rows) and the kernel is
// bound by bytes, not by the tensor cores. P is padded to PP, the next of
// 32, 64 and 128 (the caller computes it): x's padding rows are never read
// back (their products are masked out of the statistics and their h1 rows
// are written as zeros), and s's padding columns are zeroed once per stage
// and never overwritten, so the second product adds exact zeros. The
// accumulators stay in registers through each LN: the statistics are taken
// from the fragments over exactly P * C and O * C values (warp shuffles, one
// shared-memory exchange per block sum), h1 goes to shared memory once, as
// bf16, as the B operand of the second product, and h2 is normalised in
// registers, transposed through the (by then dead) m buffer one 16-row tile
// a warp at a time, and written to device memory as 16-byte stores. PP =
// 128 (EVA02's 120 in-points) is one more instantiation of the same code:
// 143.5 KB of shared memory a block (one block an SM). Three widths, not
// every multiple of 16 up to 128: those 36 instantiations took 27.3 s to
// build on the H100 host, the longest of the port's builds.
//
// fp32 takes mixing_tf32_kernel: the same persistent walk and LN scheme,
// eight warps, both products in 3xTF32 on mma.sync.m16n8k8. One TF32
// product (10 mantissa bits) would not compute this function in fp32: its
// error, about 2^-11 of each product, lands 5e-4 of the output scale from
// the plain version, fifty times the fp32 tolerance. Three keep fp32's
// accuracy: every fp32 operand x is split into hi = x rounded to TF32 (to
// nearest, ties away, as cvt.rna.tf32.f32, by an integer add and mask) and
// lo = x - hi (exact in fp32), and each 8-deep k-step runs lo*hi, hi*lo and
// hi*hi into one fp32 accumulator; a*b loses only the lo*lo term and lo's
// last bits, about 2^-21 of |a b|. The tensor cores truncate each sum they
// add into the accumulator; over the 8 (x @ m) and 16 (s @ h1, PP = 128)
// k-steps that stays near 1e-6 of the output scale, so one accumulator a
// tile is enough (tests/test_torch_kernel_layouts.py replays this order on
// the CPU: within 1e-6 of the scale, where one TF32 product lands 5e-4).
// Fragments are read from shared memory as 4-byte loads and split in
// registers: x's rows sit at a stride of 68 floats (A fragments: eight rows
// g at four columns t land in 32 distinct banks), m's and h1's at 72 (B
// fragments: four rows t at eight columns g), s's at PP + 4.
//   - Shared memory: x, m two stages (double-buffered), s one (PP = 128:
//     two stages of all three, 242 KB, would not fit the 227 KB a block may
//     have). s of the next item is issued as soon as every warp is past its
//     second product (after the first barrier of LN2), so it lands during
//     this item's output and the next item's first product; h1 is written
//     in fp32 over x's buffer, dead by then (the LN1 barrier follows every
//     read of x). 73,984 bytes a block at PP = 32, 108,800 at PP = 64 (two
//     blocks an SM), 178,432 at PP = 128 (one).
//   - Product 1 (PP x 64 x 64): each warp owns a group of row tiles by a
//     group of 8-column tiles (PP = 128: 2 x 4 tiles; PP = 32: 1 x 2);
//     product 2 (128 x 64 x PP): each warp 32 rows by 32 columns (2 x 4
//     tiles). The A fragment of a k-step is split once for all its column
//     tiles, each B fragment once for both row tiles.
//   - The first LN's statistics skip x's padding rows, h1's padding rows are
//     written as zeros and s's padding columns are zeroed once and never
//     copied over, as in the bf16 kernel.
//   - h2 is normalised in registers; lanes t and t ^ 1 trade a column pair
//     by shuffle so that each holds four adjacent floats, stored as one
//     16-byte store.
//
// Everything else (C != 64, O != 128, P > 128; bf16 with an odd P) takes the
// FMA kernel, mixing_kernel: one block of 256 threads per item loads x, m
// and s as fp32 into shared memory (rows padded to an odd stride), runs both
// products as fp32 FMA loops in which each thread owns 4 rows x 4 columns,
// keeps h1 and h2 in shared memory and takes each LN's statistics with a
// block reduction. It served fp32 at every shape before the 3xTF32
// kernel: 0.269 ms at r50 and 0.645 ms at vov99 (28-31% of the bound),
// measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W
// (check_mixing and mixing_ab; both entry points, one-pass within 5% of
// two-pass):
//   bf16, mixing_mma_kernel: r50 0.057 ms (68-70% of its bound), vov99
//     0.116 ms (78-79%), as before PP = 128 was added (bit-equal to
//     that kernel, the same times, in one call); EVA02 0.194-0.208 ms
//     (65-70%; the FMA kernel took 1.60-1.66), 135 / 127 registers and
//     143,488 bytes of shared memory a block at PP = 128 (one block an SM).
//   fp32, mixing_tf32_kernel: r50 0.106-0.108 ms (73-75%; the FMA kernel
//     0.256-0.268), vov99 0.251-0.264 ms (69-72%; 0.620-0.645), EVA02
//     0.459-0.476 ms (57-59%; 1.69-1.72), within 1e-6 of the output scale
//     of the plain version. 93 to 109 registers, no stack frame, no
//     spills. At PP = 128 one block an SM holds the kernel back: no second
//     block hides the barriers and the wait for s (one stage), and the
//     4,608 m16n8k8 products an item, three times the work, take about as
//     long on mma.sync as the item's bytes.
//   bf16 at 95 to 135 registers, no stack frame, no spills; 52.9 KB of
//   shared memory a block at P = 32 (four blocks an SM), 83.1 KB at
//   P = 60 (two). A third bf16 block an SM at P = 60 (h1 stored over x)
//   was no faster: the kernel sits at the rate the card's memory gives
//   mixed reads and writes.

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
// block's kN threads.
template <int kBytes, int kN = kMmaThreads>
__device__ __forceinline__ void copy_rows(uint32_t dst, const char* src,
                                          int rows, int row_bytes, int ld) {
  const int per_row = row_bytes / kBytes;
  const int total = rows * per_row;
  const int drow = kN / per_row;
  const int dcol = kN % per_row;
  int row = (int)threadIdx.x / per_row;
  int col = (int)threadIdx.x % per_row;
  for (int i = threadIdx.x; i < total; i += kN) {
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

// Sums (a, b) over the block's kW warps; every thread gets the totals,
// added in the same order in every thread. `red` is this call site's own
// slot, so one barrier is enough.
template <int kW = kMmaWarps>
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
  for (int i = 0; i < kW; ++i) {
    ta += red[i].x;
    tb += red[i].y;
  }
  return make_float2(ta, tb);
}

// The mean and 1/sqrt(var + eps) over the `count` values of the accumulator
// tiles acc[tile][0..4) whose row is valid (valid[tile][0] for elements 0-1,
// the tile's row g; valid[tile][1] for elements 2-3, row g+8), as ln_stats
// defines them, over a block of kW warps. red: two slots of kW float2.
template <bool kTwoPass, int kT, int kW = kMmaWarps>
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
    mu = mma_block_sum2<kW>(a, 0.f, red).x / count;
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = acc[i][j] - mu;
        b += valid[i][j >> 1] ? d * d : 0.f;
      }
    var = mma_block_sum2<kW>(b, 0.f, red + kW).x / count;
  } else {
#pragma unroll
    for (int i = 0; i < kT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = valid[i][j >> 1] ? acc[i][j] : 0.f;
        a += v;
        b += v * v;
      }
    const float2 t = mma_block_sum2<kW>(a, b, red);
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

// ---------------------------------------------------------------------
// The 3xTF32 kernel (fp32, C = 64, O = 128, P padded to PP <= 128).

constexpr int kTfWarps = 8;
constexpr int kTfThreads = kTfWarps * 32;
constexpr int kLdx = kC + 4;  // floats a row of x: A fragments conflict-free
constexpr int kLdb = kC + 8;  // floats a row of m and h1: B fragments too
static_assert(kO == 4 * 32 && kC == 2 * 32,
              "product 2: four row groups of 32 x two column groups of 32");

// d += a (16x8, row fragment) @ b (8x8, column fragment), TF32 in, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32),
// and the rest, exact in fp32 (the tensor cores read its top 19 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h =
      __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// acc += a * b in 3xTF32: lo*hi, hi*lo, hi*hi
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(acc, al, bh0, bh1);
  mma_tf32(acc, ah, bl0, bl1);
  mma_tf32(acc, ah, bh0, bh1);
}

// The A fragment of rows r, r + 8 and columns k, k + 4 of a shared tile of
// row stride ld, split into hi and lo.
__device__ __forceinline__ void load_a(const float* a, int ld, int r, int k,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  split(a[r * ld + k], h[0], l[0]);
  split(a[(r + 8) * ld + k], h[1], l[1]);
  split(a[r * ld + k + 4], h[2], l[2]);
  split(a[(r + 8) * ld + k + 4], h[3], l[3]);
}

__host__ __device__ constexpr int tf32_ldsf(int pp) { return pp + 4; }
__host__ __device__ constexpr int tf32_stage_floats(int pp) {
  return (pp + kC) * kLdb;  // x (h1 over it), m
}
__host__ __device__ constexpr int tf32_smem_bytes(int pp) {
  // two stages, one s, and four block sums of kTfWarps float2
  return 4 * (2 * tf32_stage_floats(pp) + kO * tf32_ldsf(pp)) +
         4 * kTfWarps * 8;
}

template <int kPP, bool kTwoPass>
__global__ void __launch_bounds__(kTfThreads, kPP <= 64 ? 2 : 1)
    mixing_tf32_kernel(const float* __restrict__ x,
                       const float* __restrict__ m,
                       const float* __restrict__ s, float* __restrict__ out,
                       int n, int p, float eps) {
  constexpr int kMT1 = kPP / 16;         // row tiles of h1
  // product 1: kRG row groups of kR1 tiles x kNG column groups of kN1
  // 8-column tiles, one group pair a warp
  constexpr int kRG = kMT1 % 4 == 0 ? 4 : kMT1 % 2 == 0 ? 2 : 1;
  constexpr int kR1 = kMT1 / kRG;
  constexpr int kNG = kTfWarps / kRG;
  constexpr int kN1 = (kC / 8) / kNG;
  constexpr int kLds = tf32_ldsf(kPP);
  constexpr int kStage = tf32_stage_floats(kPP);
  extern __shared__ __align__(16) float smf[];
  float* ss = smf + 2 * kStage;
  float2* red = reinterpret_cast<float2*>(ss + kO * kLds);
  const uint32_t smem_a = smem_addr(smf);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;               // fragment row within a tile
  const int t = lane & 3;                // fragment column
  const int s_row_bytes = 4 * p;

  // s's padding columns [p, kPP): zero once; no copy ever writes them
  for (int e = threadIdx.x; e < kO * (kPP - p); e += kTfThreads)
    ss[(e / (kPP - p)) * kLds + p + e % (kPP - p)] = 0.f;

  auto prefetch_xm = [&](int item, int stage) {
    const uint32_t base = smem_a + 4 * stage * kStage;
    copy_rows<16, kTfThreads>(
        base, reinterpret_cast<const char*>(x + (size_t)item * p * kC), p,
        4 * kC, 4 * kLdx);
    copy_rows<16, kTfThreads>(
        base + 4 * kPP * kLdb,
        reinterpret_cast<const char*>(m + (size_t)item * kC * kC), kC,
        4 * kC, 4 * kLdb);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto prefetch_s = [&](int item) {
    const uint32_t base = smem_a + 4 * 2 * kStage;
    const char* sg = reinterpret_cast<const char*>(s + (size_t)item * kO * p);
    if (s_row_bytes % 16 == 0)
      copy_rows<16, kTfThreads>(base, sg, kO, s_row_bytes, 4 * kLds);
    else if (s_row_bytes % 8 == 0)
      copy_rows<8, kTfThreads>(base, sg, kO, s_row_bytes, 4 * kLds);
    else
      copy_rows<4, kTfThreads>(base, sg, kO, s_row_bytes, 4 * kLds);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if ((int)blockIdx.x < n) {
    prefetch_xm(blockIdx.x, 0);
    prefetch_s(blockIdx.x);
  }
  int stage = 0;
  for (int item = blockIdx.x; item < n; item += gridDim.x, stage ^= 1) {
    const int next = item + gridDim.x;
    // the other stage (x / h1 and m of the previous item) was last read
    // before the LN2 barrier of the previous item; groups in flight: s of
    // this item, then x and m of the next one
    if (next < n)
      prefetch_xm(next, stage ^ 1);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    __syncthreads();
    float* xs = smf + stage * kStage;
    const float* ms = xs + kPP * kLdb;

    // h1 = x @ m: row tiles rg * kR1 + i, column tiles cg * kN1 + j
    const int rg = warp / kNG;
    const int cg = warp % kNG;
    float acc1[kR1 * kN1][4];
#pragma unroll
    for (int i = 0; i < kR1 * kN1; ++i)
      acc1[i][0] = acc1[i][1] = acc1[i][2] = acc1[i][3] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kC; k += 8) {
      uint32_t ah[kR1][4], al[kR1][4];
#pragma unroll
      for (int i = 0; i < kR1; ++i)
        load_a(xs, kLdx, (rg * kR1 + i) * 16 + g, k + t, ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < kN1; ++j) {
        const int col = (cg * kN1 + j) * 8 + g;
        uint32_t bh0, bh1, bl0, bl1;
        split(ms[(k + t) * kLdb + col], bh0, bl0);
        split(ms[(k + t + 4) * kLdb + col], bh1, bl1);
#pragma unroll
        for (int i = 0; i < kR1; ++i)
          mma3(acc1[i * kN1 + j], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
    // x's padding rows [p, kPP) (never copied) stay out of the LN and are
    // zero in h1
    bool valid1[kR1 * kN1][2];
#pragma unroll
    for (int i = 0; i < kR1 * kN1; ++i) {
      const int row = (rg * kR1 + i / kN1) * 16 + g;
      valid1[i][0] = row < p;
      valid1[i][1] = row + 8 < p;
    }
    const float2 st1 =
        frag_stats<kTwoPass, kR1 * kN1, kTfWarps>(acc1, valid1, p * kC, eps,
                                                  red);
    // h1 over x (every warp is past its reads of x: the LN1 sums came
    // after them), fp32 at row stride kLdb
    float* h1 = xs;
#pragma unroll
    for (int i = 0; i < kR1 * kN1; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (rg * kR1 + i / kN1) * 16 + g + half * 8;
        const int col = (cg * kN1 + i % kN1) * 8 + 2 * t;
        const bool keep = valid1[i][half];
        *reinterpret_cast<float2*>(h1 + row * kLdb + col) = make_float2(
            keep ? fmaxf((acc1[i][2 * half] - st1.x) * st1.y, 0.f) : 0.f,
            keep ? fmaxf((acc1[i][2 * half + 1] - st1.x) * st1.y, 0.f)
                 : 0.f);
      }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // s landed
    __syncthreads();

    // h2 = s @ h1: rows rg2 * 32 .., columns cg2 * 32 ..; tile i * 4 + j
    const int rg2 = warp >> 1;
    const int cg2 = warp & 1;
    float acc2[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc2[i][0] = acc2[i][1] = acc2[i][2] = acc2[i][3] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kPP; k += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_a(ss, kLds, rg2 * 32 + i * 16 + g, k + t, ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg2 * 32 + j * 8 + g;
        uint32_t bh0, bh1, bl0, bl1;
        split(h1[(k + t) * kLdb + col], bh0, bl0);
        split(h1[(k + t + 4) * kLdb + col], bh1, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma3(acc2[i * 4 + j], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
    bool valid2[8][2];
#pragma unroll
    for (int i = 0; i < 8; ++i) valid2[i][0] = valid2[i][1] = true;
    const float2 st2 = frag_stats<kTwoPass, 8, kTfWarps>(
        acc2, valid2, kO * kC, eps, red + 2 * kTfWarps);
    // every warp is past its reads of s and h1: the next item's s
    if (next < n)
      prefetch_s(next);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");

    // out: lanes t and t ^ 1 trade the column pairs of tiles j and j + 1,
    // so that each holds four adjacent columns: one 16-byte store
    float* og = out + ((size_t)item * kO + rg2 * 32) * kC + cg2 * 32;
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int jp = 0; jp < 4; jp += 2) {
          const float(&a)[4] = acc2[i * 4 + jp];
          const float(&b)[4] = acc2[i * 4 + jp + 1];
          const float a0 = fmaxf((a[2 * half] - st2.x) * st2.y, 0.f);
          const float a1 = fmaxf((a[2 * half + 1] - st2.x) * st2.y, 0.f);
          const float b0 = fmaxf((b[2 * half] - st2.x) * st2.y, 0.f);
          const float b1 = fmaxf((b[2 * half + 1] - st2.x) * st2.y, 0.f);
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
          const int row = i * 16 + g + half * 8;
          const int col = odd ? (jp + 1) * 8 + 2 * (t - 1) : jp * 8 + 2 * t;
          *reinterpret_cast<float4*>(og + row * kC + col) =
              odd ? make_float4(r0, r1, b0, b1) : make_float4(a0, a1, r0, r1);
        }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Blocks of `kern` (threads, bytes of dynamic shared memory) that fit on
// the card at once, set up once per kernel into `resident`.
template <typename Kern>
cudaError_t fill_card(Kern kern, int threads, int bytes, int& resident) {
  if (resident != 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, bytes);
  if (err != cudaSuccess) return err;
  if (sms < 1 || per_sm < 1) return cudaErrorInvalidValue;
  resident = sms * per_sm;
  return cudaSuccess;
}

// The tensor-core kernel for (is_bf16, kPP, kTwoPass): its threads, its
// dynamic shared memory, and the blocks of it the card holds at once.
template <int kPP, bool kTwoPass>
cudaError_t tc_card(int is_bf16, int& threads, int& bytes, int& resident) {
  static int res[2] = {0, 0};
  threads = is_bf16 ? kMmaThreads : kTfThreads;
  bytes = is_bf16 ? mma_smem_bytes(kPP) : tf32_smem_bytes(kPP);
  const cudaError_t err =
      is_bf16 ? fill_card(mixing_mma_kernel<kPP, kTwoPass>, threads, bytes,
                          res[1])
              : fill_card(mixing_tf32_kernel<kPP, kTwoPass>, threads, bytes,
                          res[0]);
  resident = res[is_bf16 ? 1 : 0];
  return err;
}

// A persistent grid of the tensor-core kernel: at most the blocks the card
// holds at once, each walking items blockIdx.x, blockIdx.x + gridDim.x, ...
template <int kPP, bool kTwoPass>
int launch_tc(int is_bf16, const void* x, const void* m, const void* s,
              void* out, int n, int p, float eps, cudaStream_t st) {
  int threads = 0, bytes = 0, res = 0;
  const cudaError_t err = tc_card<kPP, kTwoPass>(is_bf16, threads, bytes,
                                                 res);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = n < res ? n : res;
  if (is_bf16)
    mixing_mma_kernel<kPP, kTwoPass><<<blocks, threads, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(m),
        static_cast<const __nv_bfloat16*>(s),
        static_cast<__nv_bfloat16*>(out), n, p, eps);
  else
    mixing_tf32_kernel<kPP, kTwoPass><<<blocks, threads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(m),
        static_cast<const float*>(s), static_cast<float*>(out), n, p, eps);
  return (int)cudaGetLastError();
}

// padded_p > 0 selects a tensor-core kernel (c = 64, o = 128, padded_p
// the next of 32, 64 and 128 from p): bf16 (p even) on
// mixing_mma_kernel, fp32 on mixing_tf32_kernel. padded_p = 0 selects the
// FMA kernel.
template <bool kTwoPass>
int launch(const void* x, const void* m, const void* s, void* out,
           long long n, int p, int c, int o, int is_bf16, int padded_p,
           float eps, void* stream) {
  if (n < 0 || p < 1 || o < 1 || c < 4 || c % 4 != 0 ||
      kThreads % (c / 4) != 0 || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (padded_p != 0) {
    if (c != kC || o != kO || (is_bf16 && p % 2 != 0) || p > 128 ||
        padded_p != (p <= 32 ? 32 : p <= 64 ? 64 : 128))
      return (int)cudaErrorInvalidValue;
    if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(m) |
          reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(out)) &
         15) != 0)
      return (int)cudaErrorInvalidValue;
    const int ni = (int)n;
    switch (padded_p) {
#define MIXING_TC(PP)                                                      \
  case PP:                                                                 \
    return launch_tc<PP, kTwoPass>(is_bf16, x, m, s, out, ni, p, eps, st);
      MIXING_TC(32)
      MIXING_TC(64)
      MIXING_TC(128)
#undef MIXING_TC
      default:
        return (int)cudaErrorInvalidValue;
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

template <bool kTwoPass>
int tc_info(int is_bf16, int padded_p, int* info) {
  switch (padded_p) {
    case 32:
      return (int)tc_card<32, kTwoPass>(is_bf16, info[0], info[1], info[2]);
    case 64:
      return (int)tc_card<64, kTwoPass>(is_bf16, info[0], info[1], info[2]);
    case 128:
      return (int)tc_card<128, kTwoPass>(is_bf16, info[0], info[1], info[2]);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [n, p, c], m [n, c, c], s [n, o, p] and out [n, o, c], contiguous, all
// bf16 (is_bf16 = 1) or all fp32; n = BQ * G items. padded_p: p rounded up
// to 32, 64 or 128 for the tensor-core kernels (c = 64, o = 128, p <= 128,
// 16-byte aligned pointers; bf16 p even), or 0 for the FMA kernel.
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

// What the tensor-core kernel at padded_p (32, 64 or 128) launches:
// info[0] threads a block, info[1] bytes of dynamic shared memory a block,
// info[2] blocks resident on the card at once (its persistent grid is at
// most that). Launches nothing.
int mixing_route_info(int is_bf16, int padded_p, int two_pass, int* info) {
  return two_pass ? tc_info<true>(is_bf16, padded_p, info)
                  : tc_info<false>(is_bf16, padded_p, info);
}

const char* mixing_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
