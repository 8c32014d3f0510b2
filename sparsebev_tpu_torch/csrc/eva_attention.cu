// Exact softmax attention of the EVA02 ViT's windowed and global blocks and
// its gradient, fp32 operands on the tensor cores in 3xTF32 (sm_90a).
//
// Replaces: sparsebev_tpu/models/eva02.py::EvaAttention (:182), whose
// jax.nn.dot_product_attention calls (XLA, not Pallas) run directly for the
// windowed blocks (:213) and inside _chunked_attention for the global ones
// (:151, call at :175), and jax.grad of those calls in the training step
// (XLA's autodiff: the JAX package defines no custom VJP here). The JAX
// EVA02 trunk runs in fp32 under a bf16 compute dtype (its Linear and
// LayerNorm promote against fp32 parameters), so q, k and v are fp32 here.
//
// Forward. Input: q, k, v [B, N, H, HD] fp32 in the JAX layout
// (token-major, heads inside a token), out the same. For each (b, h) and
// query t:
//   s_j = (q_t . k_j) * HD^-0.5,
//   out_t = sum_j exp(s_j - m) v_j / sum_j exp(s_j - m)
// with m the row's maximum. No mask: the zero-padded tokens of the windows
// are keys like any other, as in JAX. The plain PyTorch version
// (ops/eva_attention.py::eva_attention_plain) normalises the probabilities
// before the product with v and sums in another order, so the two differ by
// rounding only. A call that will be differentiated also writes the row's
// log-sum-exp lse_t = m + log(sum_j exp(s_j - m)), fp32 [B, H, N], for the
// backward (a null pointer writes none).
//
// Backward (eva_attention_backward). Given dO = d out and the forward's out
// and lse, as jax.grad differentiates the attention:
//   D_t = sum_d dO_td o_td,   P_tj = exp(s_tj - lse_t),
//   dv = P^T dO,   dP = dO v^T,   dS = P * (dP - D),
//   dq = dS k * HD^-0.5,   dk = dS^T q * HD^-0.5.
// No score matrix reaches device memory. Three kernels, as
// FlashAttention-2 lays them out: D for every (b, h, t) into a scratch the
// wrapper allocates; a dK / dV kernel over 64-key tiles that walks the query
// tiles; a dQ kernel over 64-query tiles that walks the key tiles. Each
// output element is summed by one thread, so the result is deterministic
// (no atomics).
//
// Arithmetic: 3xTF32. Every fp32 operand x of every product is split into
// hi = x rounded to TF32 (10 mantissa bits, to nearest with ties away from
// zero, as cvt.rna.tf32.f32, done with an integer add and mask) and
// lo = x - hi (exact in fp32), and each product of 8-deep tiles runs as
// three mma.sync.m16n8k8 TF32 products: lo*hi, hi*lo and hi*hi. The tensor
// cores read a TF32 operand's top 19 bits, so lo is passed as it is (its
// low bits are ignored); a*b loses only the lo*lo term and lo's last bits,
// about 2^-21 of |a b|, where one TF32 product would lose 2^-11. The
// tensor cores truncate the sum each mma.sync adds into its accumulator,
// so no accumulator runs long at full size: a score product (S, dP) keeps
// hi*hi and the two small products in two accumulators added once, and
// each 32-row step of a product that sums over the sequence (P V, P^T dO,
// dS^T q, dS k) goes into a fresh accumulator that is added to the running
// one in one fp32 rounding (a single running O lands 3e-5 of the output
// scale from the plain version at N = 4000 on an H100). Replayed on the
// CPU with truncating accumulators, this order lands within 2e-6 of the
// output scale of exact attention at N = 4000, and one TF32 product a
// k-step 4e-4 - 7e-4 away (tests/test_torch_kernel_layouts.py, which also
// replays the backward's order); chip_smoke.py holds the forward within
// 1e-5 of the scale of the plain version and the backward within
// ops/eva_attention.py::ATTENTION_BWD_TOL.
//
// Bound: operations. Forward: 3 x 4 * B * H * N^2 * HD flops (two products
// of N x N x HD multiply-adds, each three times) against the dense TF32
// rate (495 TFLOP/s on the H100 SXM). Global blocks at 1600x640 streaming:
// B = 6, N = 4000, H = 16, HD = 64: 3 x 393.2 GFLOP, 2.38 ms; the 1.54e9
// exponentials take about 0.4 ms on the MUFU units and q, k, v and out
// (393 MB) 0.12 ms at 3.35 TB/s. Windowed blocks: B = 126 (21 padded 16x16
// windows a view), N = 256: 3 x 33.8 GFLOP, 0.205 ms. Backward: five
// products (S again, dP, dv, dq, dk), 3 x 10 * B * H * N^2 * HD flops. In
// the training step (24 images carry gradients): B = 24, N = 4000:
// 3 x 3.93 TFLOP, 23.8 ms (the fp32-FMA bound 58.7 ms), 3.1 GB of q, k, v,
// o, dO, dq, dk, dv (0.94 ms); B = 504, N = 256: 3 x 338 GFLOP, 2.05 ms.
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
// The backward reuses the two fragment products above. A score-shaped
// product (S = q k^T, S^T = k q^T, dP = dO v^T, dP^T = v dO^T) takes its A
// rows in registers or, split as read, from shared memory, and its B rows
// from a shared tile at the stride of 80; a sequence-summed product takes
// the score tile's C fragments as its A operand (the permuted order of
// O += P V) and its B rows from a shared tile.
//   - dK / dV kernel: a block holds 64 keys of one (b, h), 16 a warp; the
//     warp's k rows are A fragments in registers (hi and lo, 64 registers),
//     the block's v rows sit in shared memory, and its dK and dV
//     accumulators are 64 registers. Tiles of 64 query rows of q and dO,
//     with their lse and D, arrive by cp.async in two stages; a tile is
//     taken as two steps of 32 queries: S^T (16 keys x 32 queries),
//     P^T = exp(S^T / 8 - lse), dV += P^T dO, dP^T, dS^T = P^T (dP^T - D),
//     dK += dS^T q. Queries past N read lse = +inf and D = 0, so their P
//     and dS are 0. 103,424 bytes of shared memory, two blocks an SM. The
//     k fragments, dK, dV and a step's P and dP tiles live at once: ptxas
//     caps the kernel at 255 registers and spills 28 bytes (keeping k raw
//     and splitting it as read spilled the same on an H100).
//   - dQ kernel: a block holds 64 query rows, 16 a warp, as the forward
//     (q's hi and lo fragments, its rows' lse and D in registers), the
//     block's dO rows in shared memory; 64-key tiles of k and v arrive in
//     two stages; per 32-key step: S exactly as the forward computes it,
//     P = exp(S / 8 - lse) (keys past N at 0), dP = dO v^T,
//     dS = P (dP - D), dQ += dS k. 102,400 bytes, two blocks an SM.
//   - D: one 16-byte chunk of a (token, head) row a thread, summed over the
//     16 threads of the row with __shfl_xor_sync.
// Rows past N of a block's own keys (dK / dV) or queries (dQ) are computed
// on zeros and not stored.
//
// Why mma.sync and not wgmma: TF32 wgmma takes both operands K-major, so
// O = P V would need V transposed in shared memory, which TMA does not do;
// that step, and a producer warp feeding wgmma through TMA, is for a later
// change if these kernels stay under half their bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 64;                 // the kernels' one head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;      // query (dK / dV: key) rows a block
constexpr int kKeys = 64;               // rows a streamed tile
constexpr int kSub = 32;                // rows a step of a tile
constexpr int kKStride = kHD + 16;      // floats a K row in shared memory
constexpr int kVStride = kHD + 4;       // floats a forward V row
constexpr int kTileFloats = kKeys * (kKStride + kVStride);
constexpr int kChunks = kHD / 4;        // 16-byte chunks a row
constexpr size_t kSmemBytes = 2 * kTileFloats * sizeof(float);  // 2 stages
// the backward's tiles: 64 rows at the stride of 80
constexpr int kBTile = kKeys * kKStride;
// a dK / dV stage: q rows, dO rows, their lse and D
constexpr int kDkdvStage = 2 * kBTile + 2 * kKeys;
constexpr size_t kDkdvSmemBytes = (kBTile + 2 * kDkdvStage) * sizeof(float);
// dQ: the block's dO rows, then two stages of k and v rows
constexpr size_t kDqSmemBytes = (kBTile + 2 * 2 * kBTile) * sizeof(float);
constexpr int kDeltaThreads = 256;

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

// Issue the copies of rows r0 .. r0 + 63 of one (b, h) of x into a shared
// tile at kStride floats a row, and of the same rows of y (if given) into
// a tile at kStrideY; rows past N are zero-filled.
template <int kStride, int kStrideY = kStride>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ x,
                                          float* dst_y,
                                          const float* __restrict__ y,
                                          long long base, long long stride,
                                          int r0, int n) {
  for (int f = threadIdx.x; f < kKeys * kChunks; f += kThreads) {
    const int r = f / kChunks;
    const int c = f - r * kChunks;
    const bool ok = r0 + r < n;
    // a row past N reads nothing (zero fill) from a valid address
    const long long off = base + (ok ? (r0 + r) * stride : 0) + 4 * c;
    cp_async16(dst + r * kStride + 4 * c, x + off, ok ? 16 : 0);
    if (y != nullptr) {
      cp_async16(dst_y + r * kStrideY + 4 * c, y + off, ok ? 16 : 0);
    }
  }
}

// The A fragments of k-steps 2p and 2p + 1 (dims 16p + 4t .. 16p + 4t + 3,
// loaded as x from row g and y from row g + 8), hi and lo: k-step 2p holds
// dims 16p + 4t (column t) and 16p + 4t + 1 (t + 4), k-step 2p + 1 dims
// 16p + 4t + 2 and + 3; register 0 / 2 of a fragment is row g, 1 / 3 row
// g + 8
__device__ __forceinline__ void split_a(float4 x, float4 y,
                                        uint32_t (&h)[2][4],
                                        uint32_t (&l)[2][4]) {
  split(x.x, h[0][0], l[0][0]);
  split(y.x, h[0][1], l[0][1]);
  split(x.y, h[0][2], l[0][2]);
  split(y.y, h[0][3], l[0][3]);
  split(x.z, h[1][0], l[1][0]);
  split(y.z, h[1][1], l[1][1]);
  split(x.w, h[1][2], l[1][2]);
  split(y.w, h[1][3], l[1][3]);
}

// A score product over dims 16p .. 16p + 15 against the 32 B rows of step
// `half` of a shared tile (stride kKStride): n-tile jj holds B rows
// 8j .. 8j + 7, j = 4 half + jj (B column g = row 8j + g). hi*hi goes into
// s, the two small products into sm, added once by the caller: the tensor
// cores truncate each sum, so the small products are not truncated at the
// size of the big ones.
__device__ __forceinline__ void score_step(float (&s)[kSub / 8][4],
                                           float (&sm)[kSub / 8][4],
                                           const uint32_t (&ah)[2][4],
                                           const uint32_t (&al)[2][4],
                                           const float* bs, int half, int p,
                                           int g, int t) {
#pragma unroll
  for (int jj = 0; jj < kSub / 8; ++jj) {
    const int j = 4 * half + jj;
    const float4 x = lds4(bs + (8 * j + g) * kKStride + 16 * p + 4 * t);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    mma_tf32(sm[jj], al[0], h[0], h[1]);
    mma_tf32(sm[jj], ah[0], l[0], l[1]);
    mma_tf32(s[jj], ah[0], h[0], h[1]);
    mma_tf32(sm[jj], al[1], h[2], h[3]);
    mma_tf32(sm[jj], ah[1], l[2], l[3]);
    mma_tf32(s[jj], ah[1], h[2], h[3]);
  }
}

__device__ __forceinline__ void zero(float (&x)[kSub / 8][4]) {
#pragma unroll
  for (int jj = 0; jj < kSub / 8; ++jj) {
    x[jj][0] = x[jj][1] = x[jj][2] = x[jj][3] = 0.f;
  }
}

// acc = acc * (c0 | c1) + P B over the 32 rows of step `half` of a shared
// tile at kStride floats a row. P is a score tile's C fragments as they
// stand: for row group j = 4 half + jj the A fragment's column t is row
// 8j + 2t of B and t + 4 row 8j + 2t + 1, so the B fragment reads B rows
// 8j + 2t and 8j + 2t + 1. The output dims are permuted: acc[4m + r],
// column c is dim 32m + 4c + r. The step's product goes into a fresh
// accumulator, one half of the dims at a time (16 registers), and is added
// as acc * corr + step in one rounding (fmaf; corr = 1 adds it).
template <int kStride>
__device__ __forceinline__ void pv_step(float (&acc)[kHD / 8][4],
                                        const float (&pf)[kSub / 8][4],
                                        const float* bs, int half, int g,
                                        int t, float c0, float c1) {
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
      split(pf[jj][0], ph[0], pl[0]);
      split(pf[jj][2], ph[1], pl[1]);
      split(pf[jj][1], ph[2], pl[2]);
      split(pf[jj][3], ph[3], pl[3]);
      const int at = (8 * (4 * half + jj) + 2 * t) * kStride + 4 * g + 32 * m;
      const float4 x = lds4(bs + at);
      const float4 y = lds4(bs + at + kStride);
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
      float* a = acc[4 * m + r];
      a[0] = fmaf(a[0], c0, ot[r][0]);
      a[1] = fmaf(a[1], c0, ot[r][1]);
      a[2] = fmaf(a[2], c1, ot[r][2]);
      a[3] = fmaf(a[3], c1, ot[r][3]);
    }
  }
}

// The A fragments (hi, lo) of this thread's rows r and r + 8 of x (16 dims
// a p), zeros past N, from device memory
__device__ __forceinline__ void load_a_global(const float* __restrict__ x,
                                              long long base,
                                              long long stride, int r, int n,
                                              int t, uint32_t (&h)[4][2][4],
                                              uint32_t (&l)[4][2][4]) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* r0 = reinterpret_cast<const float4*>(x + base + r * stride);
  const float4* r8 =
      reinterpret_cast<const float4*>(x + base + (r + 8) * stride);
#pragma unroll
  for (int p = 0; p < kHD / 16; ++p) {
    split_a(r < n ? __ldg(r0 + 4 * p + t) : zero4,
            r + 8 < n ? __ldg(r8 + 4 * p + t) : zero4, h[p], l[p]);
  }
}

// Store acc * mul for rows r (registers 0, 1) and r + 8 (2, 3): row r holds
// dims 32m + 8t .. + 7 in acc[4m + 0..3][0] (the first four) and [1] (the
// next four)
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           long long base, long long stride,
                                           int r, int n, int t,
                                           const float (&acc)[kHD / 8][4],
                                           float mul0, float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= n) continue;
    const float mul = half ? mul1 : mul0;
    float* dst = out + base + row * stride;
#pragma unroll
    for (int m = 0; m < kHD / 32; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * half + e;
        *reinterpret_cast<float4*>(dst + 32 * m + 8 * t + 4 * e) =
            make_float4(acc[4 * m][c] * mul, acc[4 * m + 1][c] * mul,
                        acc[4 * m + 2][c] * mul, acc[4 * m + 3][c] * mul);
      }
    }
  }
}

// ----------------------------------------------------------- forward --

__global__ void __launch_bounds__(kThreads, 2)
eva_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int n, int heads,
                     float scale) {
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
  load_rows<kKStride, kVStride>(smem, k, smem + kKeys * kKStride, v, base,
                                stride, 0, n);
  cp_async_commit();

  uint32_t qh[kHD / 16][2][4], ql[kHD / 16][2][4];
  load_a_global(q, base, stride, row0, n, t, qh, ql);

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
      load_rows<kKStride, kVStride>(nk, k, nk + kKeys * kKStride, v, base,
                                    stride, (it + 1) * kKeys, n);
    }
    cp_async_commit();  // (empty on the last tile)
    cp_async_wait_all_but_one();
    __syncthreads();

    // the tile in two halves of 32 keys, each a step of the online softmax
    // (S of one half is 16 registers)
    const int valid = n - it * kKeys;  // keys of this tile, if under 64
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[kSub / 8][4], sm[kSub / 8][4];
      zero(s);
      zero(sm);
#pragma unroll
      for (int p = 0; p < kHD / 16; ++p) {
        score_step(s, sm, qh[p], ql[p], ks, half, p, g, t);
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

      // O = O * corr + P V: a running accumulator would be truncated at its
      // full size by every product (3e-5 of the output scale at N = 4000
      // on an H100, where this takes 2e-6)
      pv_step<kVStride>(o, s, vs, half, g, t, c0, c1);
    }
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  // divide by the row sums and store; the log-sum-exp of each row
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
    if (lse != nullptr && t == 0) {
      const long long at =
          (static_cast<long long>(blockIdx.z) * heads + blockIdx.y) * n + row;
      lse[at] = (half ? m1 : m0) + logf(sum);
    }
  }
}

// ---------------------------------------------------------- backward --

// D = rowsum(dO * o) of each (b, token, head) into delta [B, H, N]; 16
// threads a row, one 16-byte chunk each
__global__ void __launch_bounds__(kDeltaThreads)
eva_attention_delta_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int n,
                           int heads) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x;
  const long long row = gid / kChunks;  // (b, token, head), token-major
  const int c = threadIdx.x % kChunks;
  float s = 0.f;
  if (row < rows) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(o) +
                           row * kChunks + c);
    const float4 b = __ldg(reinterpret_cast<const float4*>(dout) +
                           row * kChunks + c);
    s = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
  // all 32 lanes shuffle; a row's 16 lanes are aligned within the warp
#pragma unroll
  for (int off = kChunks / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (row < rows && c == 0) {
    const long long token = row / heads;
    const long long h = row - token * heads;
    const long long b = token / n;
    const long long i = token - b * n;
    delta[(b * heads + h) * n + i] = s;
  }
}

// Issue the copies of query tile i0 .. i0 + 63 of one (b, h) into a dK / dV
// stage: q and dO rows by cp.async, their lse and D by plain loads and
// stores (the stage is not being read); queries past N get lse = +inf and
// D = 0, which make their P and dS zero.
__device__ __forceinline__ void load_query_stage(
    float* st, const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    long long base, long long stride, long long rows_at, int i0, int n) {
  load_rows<kKStride>(st, q, st + kBTile, dout, base, stride, i0, n);
  float* ls = st + 2 * kBTile;
  for (int r = threadIdx.x; r < kKeys; r += kThreads) {
    const bool ok = i0 + r < n;
    ls[r] = ok ? __ldg(lse + rows_at + i0 + r) : INFINITY;
    ls[kKeys + r] = ok ? __ldg(delta + rows_at + i0 + r) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
eva_attention_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int n, int heads, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* vt = smem;                // the block's v rows
  float* stages = smem + kBTile;   // two query stages
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(heads) * kHD;
  const long long base = static_cast<long long>(blockIdx.z) * n * stride +
                         static_cast<long long>(blockIdx.y) * kHD;
  const long long rows_at =
      (static_cast<long long>(blockIdx.z) * heads + blockIdx.y) * n;
  const int key0 = blockIdx.x * kRows;
  const int tiles = (n + kKeys - 1) / kKeys;

  load_rows<kKStride>(vt, v, nullptr, nullptr, base, stride, key0, n);
  load_query_stage(stages, q, dout, lse, delta, base, stride, rows_at, 0, n);
  cp_async_commit();

  // this warp's k rows (keys r and r + 8) as A fragments
  const int r = key0 + warp * 16 + g;
  uint32_t kh[kHD / 16][2][4], kl[kHD / 16][2][4];
  load_a_global(k, base, stride, r, n, t, kh, kl);
  const float* vrow = vt + (warp * 16 + g) * kKStride + 4 * t;

  float dka[kHD / 8][4], dva[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const float* st = stages + (it & 1) * kDkdvStage;
    if (it + 1 < tiles) {
      load_query_stage(stages + ((it + 1) & 1) * kDkdvStage, q, dout, lse,
                       delta, base, stride, rows_at, (it + 1) * kKeys, n);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    const float* qs = st;
    const float* ds = st + kBTile;
    const float* ls = st + 2 * kBTile;
    const float* dl = ls + kKeys;

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      // S^T = k q^T (16 keys x 32 queries); register c of n-tile jj is key
      // g (c < 2) or g + 8, query 8j + 2t + (c & 1)
      float s[kSub / 8][4], sm[kSub / 8][4];
      zero(s);
      zero(sm);
#pragma unroll
      for (int p = 0; p < kHD / 16; ++p) {
        score_step(s, sm, kh[p], kl[p], qs, half, p, g, t);
      }
      // P^T = exp(S^T / 8 - lse)
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 8 * (4 * half + jj) + 2 * t + (c & 1);
          s[jj][c] = expf((s[jj][c] + sm[jj][c]) * scale - ls[i]);
        }
      }
      // dV += P^T dO
      pv_step<kKStride>(dva, s, ds, half, g, t, 1.f, 1.f);
      // dP^T = v dO^T, v's A fragments split as read
      float dp[kSub / 8][4], dpm[kSub / 8][4];
      zero(dp);
      zero(dpm);
#pragma unroll
      for (int p = 0; p < kHD / 16; ++p) {
        uint32_t ah[2][4], al[2][4];
        split_a(lds4(vrow + 16 * p), lds4(vrow + 8 * kKStride + 16 * p), ah,
                al);
        score_step(dp, dpm, ah, al, ds, half, p, g, t);
      }
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 8 * (4 * half + jj) + 2 * t + (c & 1);
          dp[jj][c] = s[jj][c] * ((dp[jj][c] + dpm[jj][c]) - dl[i]);
        }
      }
      // dK += dS^T q
      pv_step<kKStride>(dka, dp, qs, half, g, t, 1.f, 1.f);
    }
    __syncthreads();  // this stage is consumed before the next copy into it
  }

  store_rows(dk, base, stride, r, n, t, dka, scale, scale);
  store_rows(dv, base, stride, r, n, t, dva, 1.f, 1.f);
}

__global__ void __launch_bounds__(kThreads, 2)
eva_attention_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int n, int heads,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  float* dot = smem;               // the block's dO rows
  float* stages = smem + kBTile;   // two stages of k and v rows
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(heads) * kHD;
  const long long base = static_cast<long long>(blockIdx.z) * n * stride +
                         static_cast<long long>(blockIdx.y) * kHD;
  const long long rows_at =
      (static_cast<long long>(blockIdx.z) * heads + blockIdx.y) * n;
  const int q0 = blockIdx.x * kRows;
  const int row0 = q0 + warp * 16 + g;
  const int tiles = (n + kKeys - 1) / kKeys;

  load_rows<kKStride>(dot, dout, nullptr, nullptr, base, stride, q0, n);
  load_rows<kKStride>(stages, k, stages + kBTile, v, base, stride, 0, n);
  cp_async_commit();

  uint32_t qh[kHD / 16][2][4], ql[kHD / 16][2][4];
  load_a_global(q, base, stride, row0, n, t, qh, ql);
  // rows past N: lse +inf, so P = 0
  const float lse0 = row0 < n ? __ldg(lse + rows_at + row0) : INFINITY;
  const float lse1 = row0 + 8 < n ? __ldg(lse + rows_at + row0 + 8)
                                  : INFINITY;
  const float d0 = row0 < n ? __ldg(delta + rows_at + row0) : 0.f;
  const float d1 = row0 + 8 < n ? __ldg(delta + rows_at + row0 + 8) : 0.f;
  const float* orow = dot + (warp * 16 + g) * kKStride + 4 * t;

  float dqa[kHD / 8][4];
#pragma unroll
  for (int i = 0; i < kHD / 8; ++i) {
    dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const float* ks = stages + (it & 1) * 2 * kBTile;
    const float* vs = ks + kBTile;
    if (it + 1 < tiles) {
      float* nk = stages + ((it + 1) & 1) * 2 * kBTile;
      load_rows<kKStride>(nk, k, nk + kBTile, v, base, stride,
                          (it + 1) * kKeys, n);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();

    const int valid = n - it * kKeys;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      // S = q k^T as the forward computes it; P = exp(S / 8 - lse), the
      // keys past N at 0
      float s[kSub / 8][4], sm[kSub / 8][4];
      zero(s);
      zero(sm);
#pragma unroll
      for (int p = 0; p < kHD / 16; ++p) {
        score_step(s, sm, qh[p], ql[p], ks, half, p, g, t);
      }
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = 8 * (4 * half + jj) + 2 * t + (c & 1);
          s[jj][c] = valid < kKeys && key >= valid
                         ? 0.f
                         : expf((s[jj][c] + sm[jj][c]) * scale -
                                (c < 2 ? lse0 : lse1));
        }
      }
      // dP = dO v^T, dO's A fragments split as read
      float dp[kSub / 8][4], dpm[kSub / 8][4];
      zero(dp);
      zero(dpm);
#pragma unroll
      for (int p = 0; p < kHD / 16; ++p) {
        uint32_t ah[2][4], al[2][4];
        split_a(lds4(orow + 16 * p), lds4(orow + 8 * kKStride + 16 * p), ah,
                al);
        score_step(dp, dpm, ah, al, vs, half, p, g, t);
      }
      // dS = P (dP - D)
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dp[jj][c] = s[jj][c] *
                      ((dp[jj][c] + dpm[jj][c]) - (c < 2 ? d0 : d1));
        }
      }
      // dQ += dS k
      pv_step<kKStride>(dqa, dp, ks, half, g, t, 1.f, 1.f);
    }
    __syncthreads();
  }

  store_rows(dq, base, stride, row0, n, t, dqa, scale, scale);
}

// Dynamic shared memory above 48 KB for `kernel`, allowed once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool (&allowed)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

bool bad_shape(int batch, int n, int heads, int head_dim) {
  return head_dim != kHD || batch <= 0 || n <= 0 || heads <= 0 ||
         batch > 65535 || heads > 65535;
}

}  // namespace

extern "C" {

// q, k, v, out: [batch, n, heads, head_dim] fp32, contiguous, 16-byte
// aligned; lse: [batch, heads, n] fp32 or null (not written). head_dim 64
// only (the EVA02 configs' 1024 / 16); anything else is
// cudaErrorInvalidValue. Launches one kernel on `stream`.
int eva_attention_forward(const void* q, const void* k, const void* v,
                          void* out, void* lse, int batch, int n, int heads,
                          int head_dim, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(eva_attention_kernel, kSmemBytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  eva_attention_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), n, heads,
      1.0f / sqrtf(static_cast<float>(kHD)));
  return (int)cudaGetLastError();
}

// The gradient of eva_attention_forward. q, k, v, out (the forward's
// output), dout, dq, dk, dv: [batch, n, heads, head_dim] fp32, contiguous,
// 16-byte aligned; lse (the forward's) and delta (scratch, overwritten):
// [batch, heads, n] fp32. Launches three kernels on `stream` (D, dK / dV,
// dQ) and returns the first error.
int eva_attention_backward(const void* q, const void* k, const void* v,
                           const void* out, const void* lse,
                           const void* dout, void* dq, void* dk, void* dv,
                           void* delta, int batch, int n, int heads,
                           int head_dim, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool allowed_dkdv[64] = {};
  static bool allowed_dq[64] = {};
  cudaError_t err =
      allow_smem(eva_attention_dkdv_kernel, kDkdvSmemBytes, allowed_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(eva_attention_dq_kernel, kDqSmemBytes, allowed_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHD));
  const long long rows = static_cast<long long>(batch) * n * heads;
  const long long blocks = (rows * kChunks + kDeltaThreads - 1) /
                           kDeltaThreads;
  eva_attention_delta_kernel<<<static_cast<unsigned>(blocks), kDeltaThreads,
                               0, s>>>(static_cast<const float*>(out),
                                       static_cast<const float*>(dout),
                                       static_cast<float*>(delta), rows, n,
                                       heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  eva_attention_dkdv_kernel<<<grid, kThreads, kDkdvSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  eva_attention_dq_kernel<<<grid, kThreads, kDqSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), n, heads, scale);
  return (int)cudaGetLastError();
}

const char* eva_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
