// Exact softmax attention of the EVA02 ViT's windowed and global blocks, fp32
// operands on the tensor cores in 3xTF32 (sm_90a).
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
// with m the row's maximum. No mask: the zero-padded tokens of the windows
// are keys like any other, as in JAX. The plain PyTorch version
// (ops/eva_attention.py::eva_attention_plain) normalises the probabilities
// before the product with v and sums in another order, so the two differ by
// rounding only.
//
// Arithmetic: 3xTF32. Every fp32 operand x of both products is split into
// hi = x rounded to TF32 (10 mantissa bits, to nearest with ties away from
// zero, as cvt.rna.tf32.f32, done with an integer add and mask) and
// lo = x - hi (exact in fp32), and each product of 8-deep tiles runs as
// three mma.sync.m16n8k8 TF32 products: lo*hi, hi*lo and hi*hi. The tensor
// cores read a TF32 operand's top 19 bits, so lo is passed as it is (its
// low bits are ignored); a*b loses only the lo*lo term and lo's last bits,
// about 2^-21 of |a b|, where one TF32 product would lose 2^-11. The
// tensor cores truncate the sum each mma.sync adds into its accumulator,
// so no accumulator runs long at full size: S keeps hi*hi and the two
// small products in two accumulators added once, and each 64-key tile's
// P V goes into a fresh accumulator that is added to O with one fmaf (a
// single running O lands 3e-5 of the output scale from the plain version
// at N = 4000 on an H100). Replayed on the CPU with
// truncating accumulators, this order lands within 2e-6 of the output
// scale of exact attention at N = 4000, and one TF32 product a k-step
// 4e-4 - 7e-4 away (tests/test_torch_kernel_layouts.py); chip_smoke.py
// holds the kernel within 1e-5 of the scale of the plain version.
//
// Bound: operations. 3 x 4 * B * H * N^2 * HD flops (two products of
// N x N x HD multiply-adds, each three times) against the dense TF32 rate
// (495 TFLOP/s on the H100 SXM). Global blocks at 1600x640: B = 6,
// N = 4000, H = 16, HD = 64: 3 x 393.2 GFLOP, 2.38 ms (the one-product fp32
// FMA route it replaced was bound at 5.87 ms by the 67 TFLOP/s fp32 rate);
// the 1.54e9 exponentials take about 0.4 ms on the MUFU units and q, k, v
// and out (393 MB) 0.12 ms at 3.35 TB/s. Windowed blocks: B = 126 (21
// padded 16x16 windows a view), N = 256: 3 x 33.8 GFLOP, 0.205 ms.
//
// Design: a flash-attention-2 forward on mma.sync. A block takes 64 query
// rows of one (b, h), 16 a warp (grid: query blocks x heads x batch). Each
// warp loads its q rows once, splits them and keeps hi and lo as A
// fragments in registers (64 registers); its output accumulator O
// (16 x 64) is 32 fp32 registers a thread. K and V arrive in tiles of 64
// keys by cp.async (16 bytes a thread), two stages: the next tile is in
// flight while the block works on this one. A tile is taken as two steps
// of 32 keys of the online softmax, so S (16 x 32), its small products and
// a step's P V take 16 registers each.
// Keys past N in the last tile are zero-filled (src-size 0) and their
// scores set to -inf; queries past N compute and store nothing.
//   - S = q k^T: the contraction over the head dim may run in any order, so
//     k-step 2p takes dims 16p + 4t (+1) and k-step 2p + 1 dims 16p + 4t + 2
//     (+3) at fragment column t (t + 4): one 16-byte shared-memory load of a
//     key row feeds the B fragments of two k-steps. K rows sit at a stride
//     of 80 floats, which puts the eight 16-byte loads of a quarter warp in
//     distinct banks.
//   - Online softmax on the fragments: scores scaled by 1/8 (exact), the
//     row maximum reduced over the four threads of a quad with
//     __shfl_xor_sync, O and the thread's partial row sum rescaled by
//     expf(m_old - m_new), p = expf(s - m_new) (expf, not exp2f of
//     pre-scaled logits: the scale by 1/8 stays exact). The partial sums are
//     reduced over the quad once, at the end.
//   - O += P V without a shuffle: the m16n8k8 C fragment holds keys 2t and
//     2t + 1 of each 8-key group, the A fragment wants columns t and t + 4,
//     so the product's key order is permuted (column t <- key 2t, t + 4 <-
//     key 2t + 1) and the B fragment reads V's rows in the same order. The
//     output dims are permuted too: n-tile 4m + r, column c takes dim
//     32m + 4c + r, so one 16-byte load of a V row feeds the B fragments of
//     four n-tiles and each thread owns 8 consecutive dims of a row, stored
//     as two 16-byte stores after the division by the row sum. V rows sit at
//     a stride of 68 floats (rows 2t and 2t + 1 of a quarter warp land in
//     distinct banks).
//   - The multiply-adds outside the tensor cores are explicit (the build's
//     --fmad=false keeps the compiler from contracting the rest).
// Shared memory: two stages of K (64 x 80) and V (64 x 68) floats, 75,776
// bytes, set once per device with cudaFuncSetAttribute; two blocks an SM.
// Splitting K and V as the fragments are read beat splitting each arrived
// tile once into hi and lo tiles in shared memory (113,664 bytes a block),
// and two blocks an SM beat a register cap for three (which spills); both
// measured on an H100, see PERF.md.
//
// Why mma.sync and not wgmma: TF32 wgmma takes both operands K-major, so
// O = P V would need V transposed in shared memory, which TMA does not do;
// that step, and a producer warp feeding wgmma through TMA, is for a later
// change if this kernel stays under half its bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 64;                 // the kernel's one head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;      // query rows a block
constexpr int kKeys = 64;               // keys a tile
constexpr int kSub = 32;                // keys a step of the online softmax
constexpr int kKStride = kHD + 16;      // floats a K row in shared memory
constexpr int kVStride = kHD + 4;       // floats a V row
constexpr int kTileFloats = kKeys * (kKStride + kVStride);
constexpr int kChunks = kHD / 4;        // 16-byte chunks a row
constexpr size_t kSmemBytes = 2 * kTileFloats * sizeof(float);  // 2 stages

// ------------------------------------------------------ PTX wrappers --

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------------------------------------------ helpers --

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32.f32)
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// acc += a * b in 3xTF32 (a given as hi / lo fragments)
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(acc, al, bh0, bh1);
  mma_tf32(acc, ah, bl0, bl1);
  mma_tf32(acc, ah, bh0, bh1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Issue the copies of keys j0 .. j0 + 63 of one (b, h) into a stage.
__device__ __forceinline__ void load_tile(float* ks, float* vs,
                                          const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          long long base, long long stride,
                                          int j0, int n) {
  for (int f = threadIdx.x; f < kKeys * kChunks; f += kThreads) {
    const int r = f / kChunks;
    const int c = f - r * kChunks;
    const bool ok = j0 + r < n;
    // a key past N reads nothing (zero fill) from a valid address
    const long long off = base + (ok ? (j0 + r) * stride : 0) + 4 * c;
    cp_async16(ks + r * kKStride + 4 * c, k + off, ok ? 16 : 0);
    cp_async16(vs + r * kVStride + 4 * c, v + off, ok ? 16 : 0);
  }
}


__global__ void __launch_bounds__(kThreads, 2)
eva_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int n, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and B column)
  const int t = lane & 3;   // thread in the quad
  const long long stride = static_cast<long long>(heads) * kHD;  // a token
  const long long base = static_cast<long long>(blockIdx.z) * n * stride +
                         static_cast<long long>(blockIdx.y) * kHD;
  // this thread's rows: row0 (fragment row g) and row0 + 8
  const int row0 = blockIdx.x * kRows + (threadIdx.x >> 5) * 16 + g;

  const int tiles = (n + kKeys - 1) / kKeys;
  load_tile(smem, smem + kKeys * kKStride, k, v, base, stride, 0, n);
  cp_async_commit();

  // q as A fragments, hi and lo: k-step 2p holds dims 16p + 4t (column t)
  // and 16p + 4t + 1 (t + 4), k-step 2p + 1 dims 16p + 4t + 2 and + 3;
  // register 0 / 2 of a fragment is row g, 1 / 3 row g + 8
  uint32_t qh[kHD / 8][4], ql[kHD / 8][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const float4* src =
        reinterpret_cast<const float4*>(q + base + row * stride);
#pragma unroll
    for (int p = 0; p < kHD / 16; ++p) {
      const float4 x =
          row < n ? __ldg(src + 4 * p + t) : make_float4(0.f, 0.f, 0.f, 0.f);
      split(x.x, qh[2 * p][half], ql[2 * p][half]);
      split(x.y, qh[2 * p][2 + half], ql[2 * p][2 + half]);
      split(x.z, qh[2 * p + 1][half], ql[2 * p + 1][half]);
      split(x.w, qh[2 * p + 1][2 + half], ql[2 * p + 1][2 + half]);
    }
  }

  // O fragments: n-tile 4m + r, column c is dim 32m + 4c + r
  float o[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i) {
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY;  // running maxima, rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial sums

  for (int it = 0; it < tiles; ++it) {
    float* ks = smem + (it & 1) * kTileFloats;
    float* vs = ks + kKeys * kKStride;
    if (it + 1 < tiles) {
      float* nk = smem + ((it + 1) & 1) * kTileFloats;
      load_tile(nk, nk + kKeys * kKStride, k, v, base, stride,
                (it + 1) * kKeys, n);
    }
    cp_async_commit();  // (empty on the last tile)
    cp_async_wait_all_but_one();
    __syncthreads();

    // the tile in two halves of 32 keys, each a step of the online softmax
    // (S of one half is 16 registers)
    const int valid = n - it * kKeys;  // keys of this tile, if under 64
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // S = q k^T: n-tile jj holds keys 8j .. 8j + 7, j = 4 half + jj (B
      // column g = key 8j + g). hi*hi goes into s, the two small products
      // into sm, added once at the end: the tensor cores truncate each sum,
      // so the small products are not truncated at the size of the big ones
      float s[kSub / 8][4], sm[kSub / 8][4];
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
        sm[jj][0] = sm[jj][1] = sm[jj][2] = sm[jj][3] = 0.f;
      }
#pragma unroll
      for (int p = 0; p < kHD / 16; ++p) {
#pragma unroll
        for (int jj = 0; jj < kSub / 8; ++jj) {
          const int j = 4 * half + jj;
          const int at = (8 * j + g) * kKStride + 16 * p + 4 * t;
          const float4 x = lds4(ks + at);
          uint32_t h[4], l[4];
          split(x.x, h[0], l[0]);
          split(x.y, h[1], l[1]);
          split(x.z, h[2], l[2]);
          split(x.w, h[3], l[3]);
          mma_tf32(sm[jj], ql[2 * p], h[0], h[1]);
          mma_tf32(sm[jj], qh[2 * p], l[0], l[1]);
          mma_tf32(s[jj], qh[2 * p], h[0], h[1]);
          mma_tf32(sm[jj], ql[2 * p + 1], h[2], h[3]);
          mma_tf32(sm[jj], qh[2 * p + 1], l[2], l[3]);
          mma_tf32(s[jj], qh[2 * p + 1], h[2], h[3]);
        }
      }

      // scale, mask the keys past N, online softmax; register c of n-tile
      // jj is row g (c < 2) or g + 8, key 8j + 2t + (c & 1)
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = 8 * (4 * half + jj) + 2 * t + (c & 1);
          s[jj][c] = valid < kKeys && key >= valid
                         ? -INFINITY
                         : (s[jj][c] + sm[jj][c]) * scale;
        }
      }
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
        x0 = fmaxf(x0, fmaxf(s[jj][0], s[jj][1]));
        x1 = fmaxf(x1, fmaxf(s[jj][2], s[jj][3]));
      }
      // the first half of a tile holds a key, so the maxima are finite
      // from the first step on (a second half past N leaves them as they
      // are); the first correction is expf(-inf) = 0 on zero accumulators
      const float n0 = fmaxf(m0, quad_max(x0));
      const float n1 = fmaxf(m1, quad_max(x1));
      const float c0 = expf(m0 - n0);
      const float c1 = expf(m1 - n1);
      m0 = n0;
      m1 = n1;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
        s[jj][0] = expf(s[jj][0] - n0);
        s[jj][1] = expf(s[jj][1] - n0);
        s[jj][2] = expf(s[jj][2] - n1);
        s[jj][3] = expf(s[jj][3] - n1);
        l0 += s[jj][0];
        l0 += s[jj][1];
        l1 += s[jj][2];
        l1 += s[jj][3];
      }

      // O += P V: for key group j the A fragment is P's C fragment as it
      // stands (column t = key 8j + 2t, t + 4 = key 8j + 2t + 1), so the B
      // fragment takes V rows 8j + 2t and 8j + 2t + 1. The half's product
      // goes into a fresh accumulator, one half of the dims at a time (16
      // registers), and is added as o = o * corr + ot in one rounding: a
      // running accumulator would be truncated at its full size by every
      // product (3e-5 of the output scale at N = 4000 on an H100, where
      // this takes 2e-6)
#pragma unroll
      for (int m = 0; m < kHD / 32; ++m) {
        float ot[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ot[r][0] = ot[r][1] = ot[r][2] = ot[r][3] = 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kSub / 8; ++jj) {
          uint32_t ph[4], pl[4];
          split(s[jj][0], ph[0], pl[0]);
          split(s[jj][2], ph[1], pl[1]);
          split(s[jj][1], ph[2], pl[2]);
          split(s[jj][3], ph[3], pl[3]);
          const int at =
              (8 * (4 * half + jj) + 2 * t) * kVStride + 4 * g + 32 * m;
          const float4 x = lds4(vs + at);
          const float4 y = lds4(vs + at + kVStride);
          const float b0[4] = {x.x, x.y, x.z, x.w};
          const float b1[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t h0, h1, lo0, lo1;
            split(b0[r], h0, lo0);
            split(b1[r], h1, lo1);
            mma3(ot[r], ph, pl, h0, h1, lo0, lo1);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float* acc = o[4 * m + r];
          acc[0] = fmaf(acc[0], c0, ot[r][0]);
          acc[1] = fmaf(acc[1], c0, ot[r][1]);
          acc[2] = fmaf(acc[2], c1, ot[r][2]);
          acc[3] = fmaf(acc[3], c1, ot[r][3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  // divide by the row sums and store: row g holds dims 32m + 8t .. + 7 in
  // o[4m + 0..3][0] (the first four) and [1] (the next four); row g + 8 in
  // registers 2 and 3
  const float s0 = quad_sum(l0);
  const float s1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= n) continue;
    const float sum = half ? s1 : s0;
    float* dst = out + base + row * stride;
#pragma unroll
    for (int m = 0; m < kHD / 32; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * half + e;
        *reinterpret_cast<float4*>(dst + 32 * m + 8 * t + 4 * e) =
            make_float4(o[4 * m][c] / sum, o[4 * m + 1][c] / sum,
                        o[4 * m + 2][c] / sum, o[4 * m + 3][c] / sum);
      }
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
  if (head_dim != kHD || batch <= 0 || n <= 0 || heads <= 0 ||
      batch > 65535 || heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the dynamic shared memory above 48 KB, allowed once per device
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(eva_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = true;
  }
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  eva_attention_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, heads,
      1.0f / sqrtf(static_cast<float>(kHD)));
  return (int)cudaGetLastError();
}

const char* eva_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
