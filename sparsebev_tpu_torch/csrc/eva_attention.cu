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
// FlashAttention-2 lays them out: D (beside each row's lse, in 32-row
// tiles padded past N) into a scratch the wrapper allocates; a dK / dV
// kernel over blocks of 128 keys that walks 32-query tiles; a dQ kernel
// over blocks of 128 queries that walks 32-key tiles. The two recompute S
// and dP, seven products for the bound's five (at most 5/7 of the bound);
// one kernel adding dq with fp32 reductions would save two but move about
// 25 GB of them a global call at B = 24 (63 key blocks x 393 MB of dq) and
// make dq change from run to run. Each output element is summed in a fixed
// order with no atomics, so two calls give the same bits.
//
// Arithmetic: 3xTF32. Every fp32 operand x of every product is split into
// hi = x rounded to TF32 (10 mantissa bits, to nearest with ties away from
// zero, as cvt.rna.tf32.f32, done with an integer add and mask) and
// lo = x - hi (exact in fp32), and each product of 8-deep tiles runs as
// three TF32 tensor-core products (mma.sync.m16n8k8 in the forward, wgmma
// in the backward): lo*hi, hi*lo and hi*hi. The tensor cores read a TF32
// operand's top 19 bits, so lo is passed as it is (its low bits are
// ignored); a*b loses only the lo*lo term and lo's last bits, about 2^-21
// of |a b|, where one TF32 product would lose 2^-11. The
// tensor cores truncate the sum each product adds into its accumulator,
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
// The backward runs on TF32 wgmma (wgmma.mma_async m64n32k8, 3xTF32 as
// above), its operands fed by TMA (cp.async.bulk.tensor into 128-byte
// swizzled tiles, mbarrier-tracked). TF32 wgmma reads both operands K-major
// and has no transpose, so each product needs its operands with the
// contracted index contiguous:
//   - score products (S^T = k q^T, dP^T = v dO^T in dK / dV; S = q k^T,
//     dP = dO v^T in dQ) contract the head dim: the own rows are A, the
//     streamed tile as it lies in memory is B;
//   - sequence-summed products (dV += P^T dO, dK += dS^T q; dQ += dS k)
//     contract the streamed rows: P^T / dS^T (P / dS) from the score
//     accumulators are A in registers, and B is the streamed tile
//     transposed (head-dim rows, the 32 streamed rows contiguous), which
//     TMA cannot produce.
// A block: two consumer warpgroups of 64 own rows each and a producer
// warpgroup. Thread 0 of the producer copies the own rows once and the
// streamed tiles into a ring of raw slots (two in dK / dV, three in dQ);
// all 128 producer threads then build, once a tile, into one of two built
// slots: the lo tiles of the streamed operands and the transposed tiles as
// hi (raw) and lo, in the permuted K order that lets the accumulator serve
// as the A fragment (column t <- streamed row 2t, t + 4 <- 2t + 1, as the
// forward's P V), with the swizzle wgmma reads (fence.proxy.async, then an
// mbarrier). The hi of a shared or raw-register operand is the raw fp32
// value itself (the tensor cores read its top 19 bits: hi = x truncated to
// TF32, lo = x - hi); P and dS split to nearest in registers.
//   - dK / dV: k as raw A fragments in registers (32) beside its lo tile, v
//     as raw and lo tiles; per 32-query tile: S^T (big and small
//     accumulators), P^T = exp(S^T / 8 - lse), dP^T, dS^T = P^T (dP^T - D),
//     dV += P^T dO and dK += dS^T q in fresh accumulators, a head-dim half
//     at a time. Queries past N read lse = +inf and D = 0, so their P and dS
//     are 0. 231,040 bytes of shared memory (one block an SM).
//   - dQ: q in registers and lo, dO raw and lo; per 32-key tile: S, dP,
//     P = exp(S / 8 - lse) (keys past N at 0), dS = P (dP - D),
//     dQ += dS k. 214,144 bytes.
//   - D: one 16-byte chunk of a (token, head) row a thread, summed over the
//     16 threads of the row with __shfl_xor_sync.
// Rows past N of a block's own rows are computed on zeros (TMA fills them)
// and not stored. Nothing is pre-split or pre-transposed in device memory:
// at the windowed shape each such copy of an operand is 528 MB.
//
// Why the forward stays on mma.sync: on wgmma, O = P V would need V
// transposed in shared memory as the backward builds it; the forward is
// left as it is (PERF.md).

#include <cuda.h>
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

// A block of either backward kernel: two consumer warpgroups of 64 own rows
// each (warps 0-7: wgmma and the softmax algebra) and one producer
// warpgroup (warps 8-11: thread 0 issues the TMA copies, all 128 build the
// split and transposed tiles). Each consumer keeps the A operand of one
// score product as raw fp32 fragments in registers (dK / dV: k; dQ: q) and
// the other's as a raw tile in shared memory (v; dO), beside both lo
// tiles; the streamed operand arrives in tiles of 32 rows into a ring of
// raw slots, and each tile's built tiles go into one of two built slots.
// Every thread holds at most 168 registers (384 threads an SM): ptxas keeps
// a consumer there even after setmaxnreg.inc, so the kernels do without it.
constexpr int kStream = 32;                      // rows of a streamed tile
constexpr int kOwn = 64;                         // own rows a consumer
constexpr int kConsumerWGs = 2;
constexpr int kBlockRows = kOwn * kConsumerWGs;  // own rows a block
constexpr int kBuilders = 128;                   // the producer warpgroup
constexpr int kBwdThreads = 128 * kConsumerWGs + kBuilders;
constexpr int kOwnFloats = kOwn * kHD;           // 16 KB
constexpr int kStreamFloats = kStream * kHD;     // 8 KB
constexpr int kLseD = 2 * kStream;  // a streamed tile's lse, then its D
// dK / dV: each consumer's k_lo, v, v_lo; two raw slots of q, dO (TMA);
// two built slots of q_lo, dO_lo, q^T, q^T_lo, dO^T, dO^T_lo; the raw
// slots' lse / D
constexpr int kDkdvSlots = 2;
constexpr int kDkdvOwn = 3 * kConsumerWGs * kOwnFloats;
constexpr int kDkdvRaw = 2 * kStreamFloats;
constexpr int kDkdvBuilt = 6 * kStreamFloats;
constexpr int kDkdvBuiltOff = kDkdvOwn + kDkdvSlots * kDkdvRaw;
constexpr int kDkdvLse = kDkdvBuiltOff + 2 * kDkdvBuilt;
constexpr int kDkdvBar = kDkdvLse + kDkdvSlots * kLseD;
// dQ: each consumer's q_lo, dO, dO_lo; three raw slots of k, v; two built
// slots of k_lo, v_lo, k^T, k^T_lo
constexpr int kDqSlots = 3;
constexpr int kDqOwn = 3 * kConsumerWGs * kOwnFloats;
constexpr int kDqRaw = 2 * kStreamFloats;
constexpr int kDqBuilt = 4 * kStreamFloats;
constexpr int kDqBuiltOff = kDqOwn + kDqSlots * kDqRaw;
constexpr int kDqBar = kDqBuiltOff + 2 * kDqBuilt;
// barriers (8 bytes each; see Bars)
constexpr size_t kDkdvSmem = kDkdvBar * 4 + 128 + 1024;  // + alignment slack
constexpr size_t kDqSmem = kDqBar * 4 + 128 + 1024;

// The operand tiles are K-major for wgmma with the 128-byte swizzle: two
// halves (values 0..31 and 32..63 of each row; a transposed tile has one),
// each kRowsT rows of 128 bytes whose 16-byte chunk c sits at c ^ (row % 8).
// TMA writes this layout (CU_TENSOR_MAP_SWIZZLE_128B, 1024-byte aligned
// tiles) and the threads write theirs through sw_off, so a lo tile sits at
// the offsets of its raw tile. Float offset of value k of row r:
template <int kRowsT>
__device__ __forceinline__ int sw_off(int r, int k) {
  return (k >> 5) * (kRowsT * 32) + r * 32 +
         ((((k >> 2) & 7) ^ (r & 7)) << 2) + (k & 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of a tile (K-major, 128-byte swizzle: leading offset
// 1, 8-row groups 1024 bytes apart) and of its k-step kk (values
// 8kk .. 8kk + 7 of each row)
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int kRowsT>
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk) {
  return desc +
         static_cast<uint64_t>(((kk >> 2) * kRowsT * 128 + (kk & 3) * 32) >> 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of `parity` to complete; a phase that never completes
// (a lost copy) traps after 2^26 tries instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// rows row .. row + kRowsT - 1 of one (b, h) of a [B, N, H, 64] tensor, two
// TMA boxes of 32 values (rows past N: zeros)
template <int kRowsT>
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int row,
                                         int b) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
            smem_u32(dst + half * kRowsT * 32)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(32 * half),
        "r"(h), "r"(row), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the threads' shared-memory writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one consumer warpgroup alone (named barrier 1 + its index)
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// issue or wait
template <int kN>
__device__ __forceinline__ void pin(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int kK>
__device__ __forceinline__ void pin(uint32_t (&a)[kK][4]) {
#pragma unroll
  for (int i = 0; i < kK; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

#define EVA_ACC16(c)                                                      \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), \
      c(d[15])
#define EVA_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define EVA_WGMMA32 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "

// d = A B^T (kAcc: d += A B^T) over one 8-deep k-step, A 64 x 8 and B
// 32 x 8, K-major: A in shared memory (ss) or in registers (rs: a[0] row
// g, column t; a[1] row g + 8, column t; a[2] row g, column t + 4; a[3]
// row g + 8, column t + 4, of the warp's 16 rows), B in shared memory.
// Register 4j + c of d: row 16 * warp + g (c < 2) or + 8, column
// 8j + 2t + (c & 1).
template <bool kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  if constexpr (kAcc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" EVA_WGMMA32
                 EVA_D16 ", %16, %17, p, 1, 1;\n}\n"
                 : EVA_ACC16("+f")
                 : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" EVA_WGMMA32
                 EVA_D16 ", %16, %17, p, 1, 1;\n}\n"
                 : EVA_ACC16("=f")
                 : "l"(a), "l"(b), "r"(0));
  }
}

template <bool kAcc>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kAcc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" EVA_WGMMA32
                 EVA_D16 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : EVA_ACC16("+f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" EVA_WGMMA32
                 EVA_D16 ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : EVA_ACC16("=f")
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
                   "r"(0));
  }
}

// A score product over the head dim in 3xTF32 (64 own rows x 32 streamed
// rows): big = A_hi B_hi, small = A_lo B_hi + A_hi B_lo, k-step by k-step.
// A_hi: the own rows' raw fp32 fragments (the tensor cores read an fp32
// value's top 19 bits, so a raw value is its own truncated hi); A_lo: the
// own lo tile; B_hi: the raw streamed tile; B_lo: its lo tile.
__device__ __forceinline__ void score3(float (&big)[16], float (&small)[16],
                                       const uint32_t (&ah)[8][4],
                                       uint64_t al, uint64_t bh,
                                       uint64_t bl) {
  wgmma_ss<false>(small, kstep<kOwn>(al, 0), kstep<kStream>(bh, 0));
  wgmma_rs<true>(small, ah[0], kstep<kStream>(bl, 0));
  wgmma_rs<false>(big, ah[0], kstep<kStream>(bh, 0));
#pragma unroll
  for (int kk = 1; kk < kHD / 8; ++kk) {
    wgmma_ss<true>(small, kstep<kOwn>(al, kk), kstep<kStream>(bh, kk));
    wgmma_rs<true>(small, ah[kk], kstep<kStream>(bl, kk));
    wgmma_rs<true>(big, ah[kk], kstep<kStream>(bh, kk));
  }
}

// The same with A_hi the own raw tile in shared memory
__device__ __forceinline__ void score3_ss(float (&big)[16],
                                          float (&small)[16], uint64_t ah,
                                          uint64_t al, uint64_t bh,
                                          uint64_t bl) {
  wgmma_ss<false>(small, kstep<kOwn>(al, 0), kstep<kStream>(bh, 0));
  wgmma_ss<true>(small, kstep<kOwn>(ah, 0), kstep<kStream>(bl, 0));
  wgmma_ss<false>(big, kstep<kOwn>(ah, 0), kstep<kStream>(bh, 0));
#pragma unroll
  for (int kk = 1; kk < kHD / 8; ++kk) {
    wgmma_ss<true>(small, kstep<kOwn>(al, kk), kstep<kStream>(bh, kk));
    wgmma_ss<true>(small, kstep<kOwn>(ah, kk), kstep<kStream>(bl, kk));
    wgmma_ss<true>(big, kstep<kOwn>(ah, kk), kstep<kStream>(bh, kk));
  }
}

// One 32-row step of a sequence-summed product in 3xTF32, for head dims
// 32m .. 32m + 31, into a fresh accumulator: d = P B, P (hi, lo) in
// registers as split_rows gives it, B's transposed tiles (64 head-dim rows,
// K = the 32 streamed rows in the permuted order; hi raw, lo)
__device__ __forceinline__ void sum3(float (&d)[16],
                                     const uint32_t (&ph)[4][4],
                                     const uint32_t (&pl)[4][4], uint64_t bh,
                                     uint64_t bl, int m) {
  const uint64_t off = static_cast<uint64_t>(m * 32 * 128 >> 4);
  wgmma_rs<false>(d, pl[0], kstep<kOwn>(bh, 0) + off);
  wgmma_rs<true>(d, ph[0], kstep<kOwn>(bl, 0) + off);
  wgmma_rs<true>(d, ph[0], kstep<kOwn>(bh, 0) + off);
#pragma unroll
  for (int kk = 1; kk < kStream / 8; ++kk) {
    wgmma_rs<true>(d, pl[kk], kstep<kOwn>(bh, kk) + off);
    wgmma_rs<true>(d, ph[kk], kstep<kOwn>(bl, kk) + off);
    wgmma_rs<true>(d, ph[kk], kstep<kOwn>(bh, kk) + off);
  }
}

// acc[16m ..] += P B over the streamed tile, both halves of the head dim,
// one fresh accumulator a half, each added in one rounding
__device__ __forceinline__ void sum_tile(float (&acc)[32],
                                         uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4], uint64_t bh,
                                         uint64_t bl) {
  pin(ph);
  pin(pl);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float step[16];
    wgmma_fence();
    sum3(step, ph, pl, bh, bl, m);
    wgmma_commit();
    wgmma_wait<0>();
    pin(step);
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[16 * m + i] += step[i];
  }
}

// A score tile's accumulator as the A operand of a sequence-summed
// product, split into hi (to nearest) and lo: k-step kk covers columns
// 8kk .. 8kk + 7; the accumulator holds columns 2t and 2t + 1 where the A
// fragment wants columns t and t + 4, so A column t takes sequence row
// 8kk + 2t and t + 4 row 8kk + 2t + 1 (the transposed tiles are stored in
// that order)
__device__ __forceinline__ void split_rows(const float (&x)[16],
                                           uint32_t (&h)[4][4],
                                           uint32_t (&l)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(x[4 * kk + 0], h[kk][0], l[kk][0]);
    split(x[4 * kk + 2], h[kk][1], l[kk][1]);
    split(x[4 * kk + 1], h[kk][2], l[kk][2]);
    split(x[4 * kk + 3], h[kk][3], l[kk][3]);
  }
}

// the raw A fragments of this warp's 16 rows of an own tile, k-step by
// k-step (as wgmma_rs takes them)
__device__ __forceinline__ void load_frags(const float* tile, int warp,
                                           int lane, uint32_t (&a)[8][4]) {
  const int r = 16 * warp + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    a[kk][0] = __float_as_uint(tile[sw_off<kOwn>(r, 8 * kk + t)]);
    a[kk][1] = __float_as_uint(tile[sw_off<kOwn>(r + 8, 8 * kk + t)]);
    a[kk][2] = __float_as_uint(tile[sw_off<kOwn>(r, 8 * kk + t + 4)]);
    a[kk][3] = __float_as_uint(tile[sw_off<kOwn>(r + 8, 8 * kk + t + 4)]);
  }
}

__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ float4 lo4(float4 x) {
  return make_float4(x.x - tf32_trunc(x.x), x.y - tf32_trunc(x.y),
                     x.z - tf32_trunc(x.z), x.w - tf32_trunc(x.w));
}

// lo = x - trunc(x) of a raw tile of kFloats values, at the same offsets
// (in place when lo == raw), by kN threads
template <int kFloats, int kN>
__device__ __forceinline__ void build_lo(float* lo, const float* raw,
                                         int tid) {
#pragma unroll 4
  for (int i = tid; i < kFloats / 4; i += kN) {
    *reinterpret_cast<float4*>(lo + 4 * i) = lo4(lds4(raw + 4 * i));
  }
}

// From a raw streamed tile (32 sequence rows, K = the head dim), in 128
// parts: its lo tile, and its transpose (64 head-dim rows, K = the
// sequence in the permuted order: row s at K position (s & ~7) |
// (s & 1) << 2 | (s >> 1) & 3) as hi (raw) and lo. Part f: sequence rows
// 8 g8 + 2u + par (u = 0..3), head dims 4e .. 4e + 3, whose four transposed
// chunks hold K positions 8 g8 + 4 par .. + 3 (the bits of f so laid out
// that 32 consecutive parts meet at most two-way bank conflicts).
__device__ __forceinline__ void build_t(const float* raw, float* lo,
                                        float* thi, float* tlo, int f) {
  const int e = (f & 3) | ((f >> 1) & 12);
  const int g8 = ((f >> 2) & 1) | ((f >> 4) & 2);
  const int par = (f >> 6) & 1;
  float4 x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int at = sw_off<kStream>(8 * g8 + 2 * u + par, 4 * e);
    x[u] = lds4(raw + at);
    *reinterpret_cast<float4*>(lo + at) = lo4(x[u]);
  }
  const int kp = 8 * g8 + 4 * par;
  const float4 c[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                       make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                       make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                       make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int at = sw_off<kOwn>(4 * e + j, kp);
    *reinterpret_cast<float4*>(thi + at) = c[j];
    *reinterpret_cast<float4*>(tlo + at) = lo4(c[j]);
  }
}

// Store acc * mul for this thread's rows row0 (registers 4j, 4j + 1) and
// row0 + 8 (4j + 2, 4j + 3), columns 8j + 2t, 8j + 2t + 1; rows past N
// are not stored
__device__ __forceinline__ void store_acc(float* __restrict__ out,
                                          long long base, long long stride,
                                          int row0, int n, int t,
                                          const float (&acc)[32], float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= n) continue;
    float* dst = out + base + row * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(acc[4 * j + 2 * half] * mul,
                      acc[4 * j + 2 * half + 1] * mul);
    }
  }
}

__device__ __forceinline__ float* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return reinterpret_cast<float*>(p + ((1024 - (a & 1023)) & 1023));
}

// The block's barriers: the own rows landed; a raw slot landed (full) and
// was read (raw_empty); a built slot was built (built) and read (empty).
template <int kSlots>
struct Bars {
  uint32_t at;
  __device__ explicit Bars(uint32_t base) : at(base) {}
  __device__ uint32_t own() const { return at; }
  __device__ uint32_t full(int r) const { return at + 8 + 8 * r; }
  __device__ uint32_t raw_empty(int r) const {
    return at + 8 + 8 * kSlots + 8 * r;
  }
  __device__ uint32_t built(int d) const {
    return at + 8 + 16 * kSlots + 8 * d;
  }
  __device__ uint32_t empty(int d) const {
    return at + 24 + 16 * kSlots + 8 * d;
  }
  __device__ void init() const {
    mbar_init(own(), 1);
    for (int r = 0; r < kSlots; ++r) {
      mbar_init(full(r), 1);
      mbar_init(raw_empty(r), 4 * kConsumerWGs);
    }
    for (int d = 0; d < 2; ++d) {
      mbar_init(built(d), kBuilders);
      mbar_init(empty(d), 4 * kConsumerWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// D = rowsum(dO * o) and the forward's lse, for each (b, h) and query, into
// lsed [B * H, tiles, 2, 32]: tile i holds the lse of queries 32i .. 32i + 31
// then their D; queries past N read lse = +inf and D = 0, which make their
// P and dS zero. 16 threads a row (one 16-byte chunk each) over the padded
// rows of each (b, h), in that order.
__global__ void __launch_bounds__(kDeltaThreads)
eva_attention_delta_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ lsed, long long rows, int n,
                           int heads, int tiles) {
  const long long gid =
      static_cast<long long>(blockIdx.x) * kDeltaThreads + threadIdx.x;
  const long long row = gid / kChunks;  // (b, h, padded query)
  const int c = threadIdx.x % kChunks;
  const long long padded = static_cast<long long>(tiles) * kStream;
  const long long bh = row / padded;
  const int i = static_cast<int>(row - bh * padded);
  const bool live = row < rows && i < n;
  float s = 0.f;
  if (live) {
    const long long b = bh / heads;
    const long long h = bh - b * heads;
    const long long at = ((b * n + i) * heads + h) * kChunks + c;
    const float4 x = __ldg(reinterpret_cast<const float4*>(o) + at);
    const float4 y = __ldg(reinterpret_cast<const float4*>(dout) + at);
    s = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  // all 32 lanes shuffle; a row's 16 lanes are aligned within the warp
#pragma unroll
  for (int off = kChunks / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (row < rows && c == 0) {
    float* dst = lsed + (bh * tiles + i / kStream) * kLseD + i % kStream;
    dst[0] = live ? __ldg(lse + bh * n + i) : INFINITY;
    dst[kStream] = live ? s : 0.f;
  }
}

// dK and dV of 128 keys of one (b, h) (grid: key blocks x heads x batch),
// 64 a consumer warpgroup. The producer copies each consumer's k and v
// once, then q, dO and the lse / D of each 32-query tile into a raw slot,
// and builds q_lo, dO_lo and the transposed q^T, dO^T (hi, lo) into a
// built slot. Per query tile a consumer computes S^T = k q^T and
// dP^T = v dO^T (one wgmma group), P^T = exp(S^T / 8 - lse),
// dS^T = P^T (dP^T - D), then dV += P^T dO and dK += dS^T q (fresh
// accumulators).
__global__ void __launch_bounds__(kBwdThreads, 1)
eva_attention_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lsed,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int n, int heads, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sm = align1024(smem_raw);
  float* raw_slots = sm + kDkdvOwn;
  float* built_slots = sm + kDkdvBuiltOff;
  float* lsd = sm + kDkdvLse;
  const Bars<kDkdvSlots> bars(smem_u32(sm + kDkdvBar));
  const int wg = threadIdx.x / 128;           // 2: the producer
  const int tid = threadIdx.x % 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int key0 = blockIdx.x * kBlockRows;
  const int tiles = (n + kStream - 1) / kStream;
  const long long bh = static_cast<long long>(b) * heads + h;

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == kConsumerWGs) {                   // the producer
    // q, dO and the lse / D of query tile `it` into raw slot it % 3
    auto copy = [&](int it) {
      const int r = it % kDkdvSlots;
      float* raw = raw_slots + r * kDkdvRaw;
      mbar_expect_tx(bars.full(r), kDkdvRaw * 4 + kLseD * 4);
      tma_tile<kStream>(raw, &tm_q, bars.full(r), h, it * kStream, b);
      tma_tile<kStream>(raw + kStreamFloats, &tm_do, bars.full(r), h,
                        it * kStream, b);
      bulk_load(lsd + r * kLseD, lsed + (bh * tiles + it) * kLseD,
                kLseD * 4, bars.full(r));
    };
    if (tid == 0) {                           // the first copies
      mbar_expect_tx(bars.own(), kDkdvOwn * 4);
      for (int c = 0; c < kConsumerWGs; ++c) {   // k_lo, v, v_lo (raw)
        float* own = sm + 3 * c * kOwnFloats;
        tma_tile<kOwn>(own, &tm_k, bars.own(), h, key0 + kOwn * c, b);
        tma_tile<kOwn>(own + kOwnFloats, &tm_v, bars.own(), h,
                       key0 + kOwn * c, b);
        tma_tile<kOwn>(own + 2 * kOwnFloats, &tm_v, bars.own(), h,
                       key0 + kOwn * c, b);
      }
      for (int it = 0; it < kDkdvSlots && it < tiles; ++it) copy(it);
    }
    for (int it = 0; it < tiles; ++it) {
      const int d = it & 1;
      const float* raw = raw_slots + (it % kDkdvSlots) * kDkdvRaw;
      float* out = built_slots + d * kDkdvBuilt;
      if (it >= 2) mbar_wait(bars.empty(d), ((it >> 1) + 1) & 1);
      mbar_wait(bars.full(it % kDkdvSlots), (it / kDkdvSlots) & 1);
      // q (x = 0), then dO: lo at x, transposed hi / lo at 2 + 2x, 3 + 2x
#pragma unroll 2
      for (int f = tid; f < 256; f += kBuilders) {
        const int x = f >> 7;
        build_t(raw + x * kStreamFloats, out + x * kStreamFloats,
                out + (2 + 2 * x) * kStreamFloats,
                out + (3 + 2 * x) * kStreamFloats, f & 127);
      }
      fence_async_smem();
      mbar_arrive(bars.built(d));
      // refill the slot of the tile before, whose scores the consumers are
      // about to finish, two tiles ahead of the one just built
      const int next = it - 1 + kDkdvSlots;
      if (tid == 0 && it >= 1 && next < tiles) {
        mbar_wait(bars.raw_empty((it - 1) % kDkdvSlots),
                  ((it - 1) / kDkdvSlots) & 1);
        copy(next);
      }
    }
  } else {                                    // a consumer
    const int c = wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    float* kt = sm + 3 * c * kOwnFloats;
    float* vt = kt + 2 * kOwnFloats;
    mbar_wait(bars.own(), 0);
    uint32_t kh[8][4];
    load_frags(kt, warp, lane, kh);
    consumer_sync(c);
    build_lo<kOwnFloats, 128>(kt, kt, tid);
    build_lo<kOwnFloats, 128>(vt, vt, tid);
    fence_async_smem();
    consumer_sync(c);
    const uint64_t dk_l = tile_desc(kt);
    const uint64_t dv_h = tile_desc(kt + kOwnFloats), dv_l = tile_desc(vt);

    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    for (int it = 0; it < tiles; ++it) {
      const int r = it % kDkdvSlots;
      const int d = it & 1;
      const float* raw = raw_slots + r * kDkdvRaw;
      const float* bt = built_slots + d * kDkdvBuilt;
      const float* ls = lsd + r * kLseD;
      mbar_wait(bars.full(r), (it / kDkdvSlots) & 1);
      mbar_wait(bars.built(d), (it >> 1) & 1);

      // S^T = k q^T (64 keys x 32 queries); P^T = exp(S^T / 8 - lse)
      // (queries past N: lse = +inf, P = 0); register 4j + c is query
      // column 8j + 2t + (c & 1)
      float sb[16], ss[16];
      pin(kh);
      wgmma_fence();
      score3(sb, ss, kh, dk_l, tile_desc(raw), tile_desc(bt));
      wgmma_commit();
      wgmma_wait<0>();
      pin(sb);
      pin(ss);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = 8 * j + 2 * t + (cc & 1);
          sb[4 * j + cc] =
              expf((sb[4 * j + cc] + ss[4 * j + cc]) * scale - ls[i]);
        }
      }
      // dP^T = v dO^T; dS^T = P^T (dP^T - D) into pb
      float pb[16], ps[16];
      wgmma_fence();
      score3_ss(pb, ps, dv_h, dv_l, tile_desc(raw + kStreamFloats),
                tile_desc(bt + kStreamFloats));
      wgmma_commit();
      wgmma_wait<0>();
      pin(pb);
      pin(ps);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int i = 8 * j + 2 * t + (cc & 1);
          const float dp = pb[4 * j + cc] + ps[4 * j + cc];
          pb[4 * j + cc] = sb[4 * j + cc] * (dp - ls[kStream + i]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.raw_empty(r));   // q, dO, lse, D read
      // dV += P^T dO, dK += dS^T q
      uint32_t ah[4][4], al[4][4];
      split_rows(sb, ah, al);
      sum_tile(dva, ah, al, tile_desc(bt + 4 * kStreamFloats),
               tile_desc(bt + 5 * kStreamFloats));
      split_rows(pb, ah, al);
      sum_tile(dka, ah, al, tile_desc(bt + 2 * kStreamFloats),
               tile_desc(bt + 3 * kStreamFloats));
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.empty(d));   // the built tiles read
    }

    const long long stride = static_cast<long long>(heads) * kHD;
    const long long base = static_cast<long long>(b) * n * stride +
                           static_cast<long long>(h) * kHD;
    const int row0 = key0 + kOwn * c + warp * 16 + (lane >> 2);
    store_acc(dk, base, stride, row0, n, t, dka, scale);
    store_acc(dv, base, stride, row0, n, t, dva, 1.f);
  }
}

// dQ of 128 queries of one (b, h), 64 a consumer warpgroup: the same roles;
// each consumer's q and dO once, then k and v of each 32-key tile into a
// raw slot, from which the producer builds k_lo, v_lo and k^T (hi, lo).
// Per key tile: S = q k^T and dP = dO v^T, P = exp(S / 8 - lse) (keys past
// N: 0), dS = P (dP - D), dQ += dS k (fresh accumulators).
__global__ void __launch_bounds__(kBwdThreads, 1)
eva_attention_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lsed,
                        float* __restrict__ dq, int n, int heads,
                        float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sm = align1024(smem_raw);
  float* raw_slots = sm + kDqOwn;
  float* built_slots = sm + kDqBuiltOff;
  const Bars<kDqSlots> bars(smem_u32(sm + kDqBar));
  const int wg = threadIdx.x / 128;           // 2: the producer
  const int tid = threadIdx.x % 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockRows;
  const int tiles = (n + kStream - 1) / kStream;
  const long long bh = static_cast<long long>(b) * heads + h;

  if (threadIdx.x == 0) bars.init();
  __syncthreads();

  if (wg == kConsumerWGs) {                   // the producer
    // k and v of key tile `it` into raw slot it % 3
    auto copy = [&](int it) {
      const int r = it % kDqSlots;
      float* raw = raw_slots + r * kDqRaw;
      mbar_expect_tx(bars.full(r), kDqRaw * 4);
      tma_tile<kStream>(raw, &tm_k, bars.full(r), h, it * kStream, b);
      tma_tile<kStream>(raw + kStreamFloats, &tm_v, bars.full(r), h,
                        it * kStream, b);
    };
    if (tid == 0) {                           // the first copies
      mbar_expect_tx(bars.own(), kDqOwn * 4);
      for (int c = 0; c < kConsumerWGs; ++c) {   // q_lo, dO, dO_lo (raw)
        float* own = sm + 3 * c * kOwnFloats;
        tma_tile<kOwn>(own, &tm_q, bars.own(), h, q0 + kOwn * c, b);
        tma_tile<kOwn>(own + kOwnFloats, &tm_do, bars.own(), h,
                       q0 + kOwn * c, b);
        tma_tile<kOwn>(own + 2 * kOwnFloats, &tm_do, bars.own(), h,
                       q0 + kOwn * c, b);
      }
      for (int it = 0; it < kDqSlots && it < tiles; ++it) copy(it);
    }
    for (int it = 0; it < tiles; ++it) {
      const int d = it & 1;
      const float* raw = raw_slots + (it % kDqSlots) * kDqRaw;
      float* out = built_slots + d * kDqBuilt;
      if (it >= 2) mbar_wait(bars.empty(d), ((it >> 1) + 1) & 1);
      mbar_wait(bars.full(it % kDqSlots), (it / kDqSlots) & 1);
      // k_lo at 0, v_lo at 1, k^T hi / lo at 2, 3
#pragma unroll 2
      for (int f = tid; f < 128; f += kBuilders) {
        build_t(raw, out, out + 2 * kStreamFloats, out + 3 * kStreamFloats,
                f);
      }
      build_lo<kStreamFloats, kBuilders>(out + kStreamFloats,
                                         raw + kStreamFloats, tid);
      fence_async_smem();
      mbar_arrive(bars.built(d));
      const int next = it - 1 + kDqSlots;
      if (tid == 0 && it >= 1 && next < tiles) {
        mbar_wait(bars.raw_empty((it - 1) % kDqSlots),
                  ((it - 1) / kDqSlots) & 1);
        copy(next);
      }
    }
  } else {                                    // a consumer
    const int c = wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;
    float* qt = sm + 3 * c * kOwnFloats;
    float* dot = qt + 2 * kOwnFloats;
    // this thread's rows r and r + 8: their lse and D (rows past N: +inf, 0)
    const int r = q0 + kOwn * c + warp * 16 + (lane >> 2);
    const float* ld = lsed + bh * tiles * kLseD;
    const float* ld0 = ld + (r / kStream) * kLseD + r % kStream;
    const float* ld1 = ld + ((r + 8) / kStream) * kLseD + (r + 8) % kStream;
    const float lse0 = r < n ? ld0[0] : INFINITY;
    const float d0 = r < n ? ld0[kStream] : 0.f;
    const float lse1 = r + 8 < n ? ld1[0] : INFINITY;
    const float d1 = r + 8 < n ? ld1[kStream] : 0.f;
    mbar_wait(bars.own(), 0);
    uint32_t qh[8][4];
    load_frags(qt, warp, lane, qh);
    consumer_sync(c);
    build_lo<kOwnFloats, 128>(qt, qt, tid);
    build_lo<kOwnFloats, 128>(dot, dot, tid);
    fence_async_smem();
    consumer_sync(c);
    const uint64_t dq_l = tile_desc(qt);
    const uint64_t ddo_h = tile_desc(qt + kOwnFloats), ddo_l = tile_desc(dot);

    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;

    for (int it = 0; it < tiles; ++it) {
      const int rs = it % kDqSlots;
      const int d = it & 1;
      const float* raw = raw_slots + rs * kDqRaw;
      const float* bt = built_slots + d * kDqBuilt;
      mbar_wait(bars.full(rs), (it / kDqSlots) & 1);
      mbar_wait(bars.built(d), (it >> 1) & 1);

      // S = q k^T, dP = dO v^T (64 queries x 32 keys), two wgmma groups:
      // P is computed while dP runs
      float sb[16], ss[16], pb[16], ps[16];
      pin(qh);
      wgmma_fence();
      score3(sb, ss, qh, dq_l, tile_desc(raw), tile_desc(bt));
      wgmma_commit();
      score3_ss(pb, ps, ddo_h, ddo_l, tile_desc(raw + kStreamFloats),
                tile_desc(bt + kStreamFloats));
      wgmma_commit();
      wgmma_wait<1>();
      pin(sb);
      pin(ss);
      // P = exp(S / 8 - lse), keys past N at 0, into sb; register 4j + c is
      // row r (c < 2) or r + 8, key column 8j + 2t + (c & 1)
      const int valid = n - it * kStream;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int key = 8 * j + 2 * t + (cc & 1);
          sb[4 * j + cc] =
              key < valid ? expf((sb[4 * j + cc] + ss[4 * j + cc]) * scale -
                                 (cc < 2 ? lse0 : lse1))
                          : 0.f;
        }
      }
      wgmma_wait<0>();
      pin(pb);
      pin(ps);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.raw_empty(rs));   // k, v read
      // dS = P (dP - D) into pb
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pb[i] = sb[i] * ((pb[i] + ps[i]) - ((i & 3) < 2 ? d0 : d1));
      }
      // dQ += dS k
      uint32_t ah[4][4], al[4][4];
      split_rows(pb, ah, al);
      sum_tile(dqa, ah, al, tile_desc(bt + 2 * kStreamFloats),
               tile_desc(bt + 3 * kStreamFloats));
      __syncwarp();
      if (lane == 0) mbar_arrive(bars.empty(d));   // the built tiles read
    }

    const long long stride = static_cast<long long>(heads) * kHD;
    const long long base = static_cast<long long>(b) * n * stride +
                           static_cast<long long>(h) * kHD;
    store_acc(dq, base, stride, r, n, t, dqa, scale);
  }
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The TMA map of a [batch, n, heads, 64] fp32 tensor as 4-d (head dim,
// head, token, batch): boxes of 32 values x 1 head x `rows` tokens x 1,
// the 128-byte swizzle, tokens past N (of each batch) read as zeros.
cudaError_t token_map(CUtensorMap* map, const void* x, int batch, int n,
                      int heads, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(kHD) * 4,
      static_cast<cuuint64_t>(heads) * kHD * 4,
      static_cast<cuuint64_t>(n) * heads * kHD * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        const_cast<void*>(x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
// 16-byte aligned; lse: the forward's, [batch, heads, n] fp32; lsed:
// scratch of batch * heads * eva_attention_backward_scratch(n) fp32,
// overwritten. Launches three kernels on `stream` (D, dK / dV, dQ) and
// returns the first error.
int eva_attention_backward(const void* q, const void* k, const void* v,
                           const void* out, const void* lse,
                           const void* dout, void* dq, void* dk, void* dv,
                           void* lsed, int batch, int n, int heads,
                           int head_dim, void* stream) {
  if (bad_shape(batch, n, heads, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool allowed_dkdv[64] = {};
  static bool allowed_dq[64] = {};
  cudaError_t err =
      allow_smem(eva_attention_dkdv_kernel, kDkdvSmem, allowed_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(eva_attention_dq_kernel, kDqSmem, allowed_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dK / dV streams q and dO (32-row boxes) past its own k and v (64-row);
  // dQ the other way round
  CUtensorMap own[4], streamed[4];
  const void* xs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    err = token_map(&own[i], xs[i], batch, n, heads, kOwn);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = token_map(&streamed[i], xs[i], batch, n, heads, kStream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHD));
  const int tiles = (n + kStream - 1) / kStream;
  const long long rows =
      static_cast<long long>(batch) * heads * tiles * kStream;
  const long long blocks = (rows * kChunks + kDeltaThreads - 1) /
                           kDeltaThreads;
  eva_attention_delta_kernel<<<static_cast<unsigned>(blocks), kDeltaThreads,
                               0, s>>>(static_cast<const float*>(out),
                                       static_cast<const float*>(dout),
                                       static_cast<const float*>(lse),
                                       static_cast<float*>(lsed), rows, n,
                                       heads, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kBlockRows - 1) / kBlockRows, heads, batch);
  eva_attention_dkdv_kernel<<<grid, kBwdThreads, kDkdvSmem, s>>>(
      streamed[0], own[1], own[2], streamed[3],
      static_cast<const float*>(lsed), static_cast<float*>(dk),
      static_cast<float*>(dv), n, heads, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  eva_attention_dq_kernel<<<grid, kBwdThreads, kDqSmem, s>>>(
      own[0], streamed[1], streamed[2], own[3],
      static_cast<const float*>(lsed), static_cast<float*>(dq), n, heads,
      scale);
  return (int)cudaGetLastError();
}

// fp32 values of eva_attention_backward's lsed a (batch, head) for n tokens:
// each 32-token tile's lse and D
int eva_attention_backward_scratch(int n) {
  return (n + kStream - 1) / kStream * kLseD;
}

// Dynamic shared memory of each kernel, bytes: 0 the forward, 1 dK / dV,
// 2 dQ (-1 for anything else).
int eva_attention_smem_bytes(int kernel) {
  return kernel == 0   ? static_cast<int>(kSmemBytes)
         : kernel == 1 ? static_cast<int>(kDkdvSmem)
         : kernel == 2 ? static_cast<int>(kDqSmem)
                       : -1;
}

const char* eva_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
