// Dense fp32 products of the EVA02 ViT trunk, y = x W^T + b, on the tensor
// cores in 3xTF32 (sm_90a).
//
// Replaces: no Pallas kernel. It stands in for the XLA dots of the JAX
// trunk's Linear layers, sparsebev_tpu/models/eva02.py:144-148 (SwiGLU's
// w1, w2 and w3) and :199-215 (EvaAttention's q / k / v projections and
// proj), which XLA computes in fp32: the trunk runs in fp32 under a bf16
// compute dtype (its Linear promotes against fp32 parameters). On the card
// PyTorch's fp32 matmul runs them on the FMA units (an sm80 fp32 kernel),
// at ~74% of the 67 TFLOP/s fp32 peak; TF32 alone would lower the
// precision the configuration states.
//
// Operands: x [M, K] and W [N, K] (nn.Linear's layout) fp32, row-major,
// contiguous; b [N] fp32 or null; y [M, N] fp32. Both operands are K-major,
// which is what TF32 wgmma requires (it has no transpose for 4-byte types).
//
// Arithmetic: 3xTF32. Every fp32 operand v is split into hi and lo, and
// each 8-deep k-step runs three TF32 products lo*hi, hi*lo and hi*hi into
// fp32 accumulators, in that order (as csrc/mixing.cu and
// csrc/eva_attention.cu). The hi of a raw fp32 tile is the tile itself: the
// tensor cores read a TF32 operand's top 19 bits, so a raw value is its own
// hi truncated to TF32, and lo = v - trunc(v) is exact in fp32. a*b loses
// the lo*lo term and lo's last bits, about 2^-21 of |a b|, where one TF32
// product would lose 2^-11. The tensor cores truncate each sum into the
// accumulator; over K = 1024 and 2730 (128 and 342 k-steps, three sums a
// k-step) that truncation, biased toward zero, grows with K, so the wgmma
// accumulator is promoted: every kPromote slices (16 k-steps) it is added
// into a second set of fp32 registers with a rounded add and restarted.
// tests/test_torch_eva_linear.py replays this order on the CPU: within
// ops/eva_linear.py::LINEAR_TOL of the fp64 product, where one TF32 product
// a k-step and an unpromoted accumulator land outside.
//
// Bound: operations. 2 M N K flops, three times, at the dense TF32 rate
// (495 TFLOP/s on the H100 SXM). The trunk's shapes, calls a frame:
// (24000, 1024, 1024) global q / k / v / proj, 32 calls, 0.305 ms each;
// (32256, 1024, 1024) windowed q / k / v / proj, 64 calls, 0.410 ms;
// (24000, 2730, 1024) w1 and w2, 48 calls, 0.813 ms; (24000, 1024, 2730) w3,
// 24 calls, 0.813 ms. Their bytes (x, W and y once) take 0.06 - 0.2 ms at
// 3.35 TB/s. The same products on the FMA units bound 0.75 - 2.0 ms.
//
// Design: a persistent, warp-specialized wgmma GEMM.
//   - Tiles of 128 x 128 outputs, walked by at most one block an SM in the
//     order blockIdx.x, blockIdx.x + gridDim.x, ..., N-tiles fastest, so the
//     blocks running together share their rows of x and all of W in L2.
//   - Two consumer warpgroups (64 rows x 128 columns each: a 64-register
//     wgmma accumulator and a 64-register promoted sum a thread) and two
//     producer warps: 320 threads, at most 200 registers a thread.
//   - The producers copy K-slices of 32 values (one 128-byte row, the
//     128-byte swizzle that wgmma reads) of the x and W tiles into a ring of
//     kRaw raw slots, and build each slice's W lo tile (lo = v - trunc(v),
//     at the raw tile's offsets) into one of kLo lo slots, all sixteen
//     16-byte loads of a thread in flight at once; fence.proxy.async and an
//     mbarrier hand the slice to the consumers. Loads run kAhead slices
//     ahead of the build, the build up to kLo - 1 ahead of the products.
//   - Each consumer splits its x lo in registers, as the A fragments of
//     wgmma (16 values a thread a slice, read from the raw tile), and issues
//     twelve wgmma.m64n128k8 a slice: lo*hi with A in registers, hi*lo and
//     hi*hi with A and B in shared memory. It keeps one slice in flight
//     (wgmma.wait_group 1) and frees a slice's slots when its products are
//     done. Splitting x in registers halves the build and the lo slots:
//     with both lo tiles built by the producers, the build holds the kernel
//     near 30% of its bound, no faster than the FMA route (PERF.md).
//   - Producer and consumers run across tile boundaries, so one tile's
//     epilogue (the bias and fp32 stores straight from the promoted
//     registers) overlaps the next tile's loads.
//   - The load route follows from what the kernel can see (route_of).
//     Where K is a multiple of 4 and x and W are 16-byte aligned, every row
//     of both is 16-byte aligned and TMA copies each slice (boxes of
//     32 x 128; rows past M or N and values past K read as zeros).
//     Elsewhere (K = 2730: rows of 10,920 bytes, 8-byte aligned, which a
//     TMA map cannot describe, and whose odd rows no 16-byte aligned box
//     start reaches) the 64 producer threads copy the slice as 8-byte
//     cp.async pieces into the same swizzled layout, zero-filling past K
//     (the k-tail of 2730 = 85 x 32 + 10), M and N; each thread's pieces
//     arrive on the slot's mbarrier (cp.async.mbarrier.arrive.noinc).
//     Stores are masked past M and N (N = 2730 leaves a last tile of 42
//     columns). K and N must be even (8-byte pieces and float2 stores).
//   - Nothing is pre-split, padded or copied in device memory: no workspace
//     beyond y (a lo copy of the trunk's fp32 weights would hold another
//     1.2 GB).
// On an H100 the TMA route runs at 56-58% of its bound at the trunk's
// shapes and the cp.async route (w3) at 37% (PERF.md, kernel table row B).
// Shared memory: kRaw raw slots of 32 KB (x and W slices of 128 x 32 fp32)
// and kLo lo slots of 16 KB, 214,120 bytes with the barriers and the
// alignment slack: one block an SM.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBM = 128;                 // output rows a tile
constexpr int kBN = 128;                 // output columns a tile
constexpr int kBK = 32;                  // K values a slice (128 bytes)
constexpr int kConsumerWGs = 2;          // 64 rows each
constexpr int kProducers = 64;           // two producer warps
constexpr int kRowStep = kProducers / 16;  // cp.async: rows between pieces
constexpr int kThreads = 128 * kConsumerWGs + kProducers;
constexpr int kRaw = 5;                  // raw slots (x and W slices)
constexpr int kLo = 3;                   // lo slots (W's lo slices)
constexpr int kAhead = 2;                // slices loaded ahead of the build
constexpr int kPromote = 4;              // slices (16 k-steps) a promotion
constexpr int kTileA = kBM * kBK;        // floats of an x slice
constexpr int kTileB = kBN * kBK;        // floats of a W slice
constexpr int kSlot = kTileA + kTileB;   // 32 KB
constexpr int kLoOff = kRaw * kSlot;
constexpr int kBarOff = kLoOff + kLo * kTileB;
constexpr int kBars = 2 * kRaw + kLo;
constexpr size_t kSmemBytes = kBarOff * 4 + kBars * 8 + 1024;
static_assert(kBM == kBN, "one TMA box shape serves x and W");
static_assert(kAhead + kLo <= kRaw, "a load takes the raw slot of a slice "
              "no later than the one whose release frees the lo slot");

// ------------------------------------------------------ PTX wrappers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// (a lost copy) traps after 10 s of the global timer instead of hanging the
// card. The loop lives inside the asm: a loop the compiler sees would be a
// divergent path before the wgmma issues, which ptxas then serializes.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 10000000000;\n"
      "@p bra WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 2-d map (32 K values x its rows) at (k0, row0)
__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        uint32_t bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// 8 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// the threads' shared-memory writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LIN_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B^T over one 8-deep k-step, A 64 x 8 and B 128 x 8, both
// K-major in shared memory; acc 0 overwrites d. Register 4j + c of d: row
// 16 * warp + g (c < 2) or + 8, column 8j + 2t + (c & 1) (g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : LIN_D8(0), LIN_D8(8), LIN_D8(16), LIN_D8(24), LIN_D8(32), LIN_D8(40),
        LIN_D8(48), LIN_D8(56)
      : "l"(a), "l"(b), "r"(acc));
}

// ------------------------------------------------------------ helpers --

// The wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle (leading offset 1, 8-row groups 1024 bytes apart); k-step kk of
// it (values 8kk .. 8kk + 7 of each row) is the descriptor plus 2 kk.
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Float offset of value k of row r in a swizzled tile: 16-byte chunk c of
// row r sits at c ^ (r % 8), as TMA writes CU_TENSOR_MAP_SWIZZLE_128B into
// a 1024-byte aligned tile.
__device__ __forceinline__ int sw_off(int r, int k) {
  return r * kBK + ((((k >> 2) & 7) ^ (r & 7)) << 2) + (k & 3);
}

__device__ __forceinline__ float4 lo4(float4 x) {
  auto lo = [](float v) {
    return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);
  };
  return make_float4(lo(x.x), lo(x.y), lo(x.z), lo(x.w));
}

__device__ __forceinline__ float* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return reinterpret_cast<float*>(p + ((1024 - (a & 1023)) & 1023));
}

struct Bars {
  uint32_t at;
  __device__ explicit Bars(uint32_t base) : at(base) {}
  // a raw slot landed
  __device__ uint32_t full(int r) const { return at + 8 * r; }
  // a slice's products are done: its raw slot and its lo slot are free
  __device__ uint32_t done(int r) const { return at + 8 * (kRaw + r); }
  // a lo slot is built
  __device__ uint32_t built(int d) const { return at + 8 * (2 * kRaw + d); }
};

// d (+)= A B^T over one 8-deep k-step with A in registers (a[0] row g,
// column t; a[1] row g + 8, column t; a[2] row g, column t + 4; a[3] row
// g + 8, column t + 4 of the warp's 16 rows) and B in shared memory
__device__ __forceinline__ void wgmma128_rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1;\n}\n"
      : LIN_D8(0), LIN_D8(8), LIN_D8(16), LIN_D8(24), LIN_D8(32), LIN_D8(40),
        LIN_D8(48), LIN_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// The load routes (see the note above): both operands as 8-byte cp.async
// pieces, or both by TMA.
enum Route { kCpAsync = 0, kTma = 1 };

// 8-byte cp.async pieces of rows row0, row0 + kRowStep, ... (below `rows`)
// of a [*, k] matrix whose tile starts at `base`, K-slice k0, into a
// swizzled 128-row tile: this thread's piece is value kc .. kc + 1
__device__ __forceinline__ void copy_pieces(float* to, const float* base,
                                            int rows, int k, int k0,
                                            int tid) {
  const int kc = 2 * (tid & 15);
  const int row0 = tid >> 4;
  const bool k_live = k0 + kc < k;
  const float* src = base + static_cast<long long>(row0) * k + k0 + kc;
  const long long step = static_cast<long long>(kRowStep) * k;
#pragma unroll 8
  for (int j = 0; j < kBM / kRowStep; ++j) {
    const bool live = k_live && row0 + kRowStep * j < rows;
    cp_async8(to + sw_off(row0 + kRowStep * j, kc), live ? src : base,
              live ? 8 : 0);
    src += step;
  }
}

// y = x W^T + b over 128 x 128 tiles (see the note above).
template <int kRoute>
__global__ void __launch_bounds__(kThreads, 1)
eva_linear_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y,
                  int m, int n, int k) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* sm = align1024(smem_raw);
  const Bars bars(smem_u32(sm + kBarOff));
  const int tiles_n = (n + kBN - 1) / kBN;
  const long long tiles =
      static_cast<long long>((m + kBM - 1) / kBM) * tiles_n;
  const int nk = (k + kBK - 1) / kBK;
  const long long mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = mine * nk;         // slices this block runs

  if (threadIdx.x == 0) {
    for (int r = 0; r < kRaw; ++r) {
      // arrivals a slot's loads make: TMA's expect_tx, or one a producer
      // thread for its cp.async pieces
      mbar_init(bars.full(r), kRoute == kTma ? 1 : kProducers);
      mbar_init(bars.done(r), 4 * kConsumerWGs);
    }
    for (int d = 0; d < kLo; ++d) mbar_init(bars.built(d), kProducers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, uniform across each warp as the compiler sees it
  // (a role test it takes for divergent would serialize the wgmma issues)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumerWGs) {                  // the producers
    const int tid = threadIdx.x - 128 * kConsumerWGs;
    // slice g (tile g / nk, K-slice g % nk) into raw slot g % kRaw
    auto load = [&](long long g) {
      const long long tile = blockIdx.x + (g / nk) * gridDim.x;
      const int ks = static_cast<int>(g % nk);
      const int m0 = static_cast<int>(tile / tiles_n) * kBM;
      const int n0 = static_cast<int>(tile % tiles_n) * kBN;
      const int k0 = ks * kBK;
      const int r = static_cast<int>(g % kRaw);
      float* dst = sm + r * kSlot;
      if (kRoute == kTma) {
        if (tid == 0) {
          mbar_expect_tx(bars.full(r), kSlot * 4);
          tma_box(dst, &tm_x, bars.full(r), k0, m0);
          tma_box(dst + kTileA, &tm_w, bars.full(r), k0, n0);
        }
      } else {
        copy_pieces(dst, x + static_cast<long long>(m0) * k, m - m0, k, k0,
                    tid);
        copy_pieces(dst + kTileA, w + static_cast<long long>(n0) * k, n - n0,
                    k, k0, tid);
        cp_async_arrive(bars.full(r));
      }
    };
    for (long long g = 0; g < kAhead && g < total; ++g) load(g);
    for (long long g = 0; g < total; ++g) {
      // the products of slice g - kLo are done: its lo slot is free, and so
      // is every raw slot up to it, which slice g + kAhead takes
      if (g >= kLo) {
        mbar_wait(bars.done((g - kLo) % kRaw), ((g - kLo) / kRaw) & 1);
      }
      if (g + kAhead < total) load(g + kAhead);
      const int r = static_cast<int>(g % kRaw);
      const int d = static_cast<int>(g % kLo);
      mbar_wait(bars.full(r), (g / kRaw) & 1);
      const float* raw = sm + r * kSlot;
      // W's lo tile, 16 float4 a thread, all loads in flight at once
      const float4* bh = reinterpret_cast<const float4*>(raw + kTileA);
      float4* bl = reinterpret_cast<float4*>(sm + kLoOff + d * kTileB);
      float4 v[kTileB / 4 / kProducers];
#pragma unroll
      for (int i = 0; i < kTileB / 4 / kProducers; ++i) {
        v[i] = bh[tid + kProducers * i];
      }
#pragma unroll
      for (int i = 0; i < kTileB / 4 / kProducers; ++i) {
        bl[tid + kProducers * i] = lo4(v[i]);
      }
      fence_async_smem();
      mbar_arrive(bars.built(d));
    }
  } else {                                   // a consumer
    const int c = wg;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int g8 = lane >> 2;
    const int t = lane & 3;
    const int fr = c * 64 + 16 * warp + g8;  // the fragments' first tile row
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    long long g = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = static_cast<int>(tile / tiles_n) * kBM;
      const int n0 = static_cast<int>(tile % tiles_n) * kBN;
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      bool pending = false;                  // slice g - 1 not yet freed
      for (int ks = 0; ks < nk; ++ks, ++g) {
        const int r = static_cast<int>(g % kRaw);
        const int d = static_cast<int>(g % kLo);
        mbar_wait(bars.full(r), (g / kRaw) & 1);
        mbar_wait(bars.built(d), (g / kLo) & 1);
        if (kRoute != kTma) fence_async_smem();   // cp.async's raw tiles
        const float* raw = sm + r * kSlot;
        // x's lo as A fragments, split in registers: k-step kk, columns
        // 8kk + t and + 4 of rows fr and fr + 8
        uint32_t alo[kBK / 8][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float v =
                raw[sw_off(fr + 8 * (q & 1), 8 * kk + t + 4 * (q >> 1))];
            alo[kk][q] = __float_as_uint(
                v - __uint_as_float(__float_as_uint(v) & 0xffffe000u));
          }
        }
        const uint64_t ah = tile_desc(raw + c * 64 * kBK);
        const uint64_t bh = tile_desc(raw + kTileA);
        const uint64_t bl = tile_desc(sm + kLoOff + d * kTileB);
        const int fresh = ks % kPromote == 0;
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          wgmma128_rs(acc, alo[kk], bh + 2 * kk, kk > 0 || !fresh);
          wgmma128(acc, ah + 2 * kk, bl + 2 * kk, 1);
          wgmma128(acc, ah + 2 * kk, bh + 2 * kk, 1);
        }
        wgmma_commit();
        const bool promote = ks % kPromote == kPromote - 1 || ks == nk - 1;
        if (promote) {
          wgmma_wait<0>();
          pin(acc);
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] += acc[i];
        } else {
          wgmma_wait<1>();
        }
        __syncwarp();
        if (lane == 0) {
          if (pending) mbar_arrive(bars.done((g - 1) % kRaw));
          if (promote) mbar_arrive(bars.done(r));
        }
        pending = !promote;
      }
      // the epilogue: rows fr and fr + 8, columns 8j + 2t and + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + fr + 8 * h;
        if (row >= m) continue;
        float* out = y + static_cast<long long>(row) * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col >= n) continue;
          const float2 bv =
              bias != nullptr
                  ? __ldg(reinterpret_cast<const float2*>(bias + col))
                  : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(out + col) =
              make_float2(sum[4 * j + 2 * h] + bv.x,
                          sum[4 * j + 2 * h + 1] + bv.y);
        }
      }
    }
  }
}

// Dynamic shared memory above 48 KB for `kernel`, allowed once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&allowed)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

// streaming multiprocessors of the current device (cached a device)
cudaError_t sm_count(int* out) {
  static int counts[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (counts[device] == 0) {
    err = cudaDeviceGetAttribute(&counts[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *out = counts[device];
  return cudaSuccess;
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

// The TMA map of a [rows, k] fp32 matrix: boxes of 32 values x 128 rows,
// the 128-byte swizzle, values past k and rows past `rows` read as zeros.
cudaError_t matrix_map(CUtensorMap* map, const void* a, int rows, int k) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 4};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<void*>(a), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int route_of(const void* x, const void* w, int k) {
  if (k <= 0 || k % 2 != 0 || !aligned(x, 8) || !aligned(w, 8)) return -1;
  return k % 4 == 0 && aligned(x, 16) && aligned(w, 16) ? kTma : kCpAsync;
}

template <int kRoute>
int launch(const float* x, const float* w, const float* b, float* y, int m,
           int n, int k, cudaStream_t s) {
  static bool allowed[64] = {};
  cudaError_t err = allow_smem(eva_linear_kernel<kRoute>, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) *
                          ((n + kBN - 1) / kBN);
  const unsigned grid =
      static_cast<unsigned>(tiles < sms ? tiles : static_cast<long long>(sms));
  CUtensorMap tm_x, tm_w;
  memset(&tm_x, 0, sizeof(tm_x));
  memset(&tm_w, 0, sizeof(tm_w));
  if (kRoute == kTma) {
    err = matrix_map(&tm_x, x, m, k);
    if (err == cudaSuccess) err = matrix_map(&tm_w, w, n, k);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  eva_linear_kernel<kRoute><<<grid, kThreads, kSmemBytes, s>>>(
      tm_x, tm_w, x, w, b, y, m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The load route of a call: 1 TMA (K a multiple of 4, x and w 16-byte
// aligned), 0 8-byte cp.async pieces (K even, x and w 8-byte aligned), -1
// no route.
int eva_linear_route(const void* x, const void* w, int k) {
  return route_of(x, w, k);
}

// y = x w^T + b. x: [m, k], w: [n, k], y: [m, n] fp32, contiguous; b: [n]
// fp32 or null. n and k even; y and b 8-byte aligned; x and w as
// eva_linear_route takes them. Anything else is cudaErrorInvalidValue.
// Launches one kernel on `stream`.
int eva_linear_forward(const void* x, const void* w, const void* b, void* y,
                       int m, int n, int k, void* stream) {
  const int route = route_of(x, w, k);
  if (route < 0 || m <= 0 || n <= 0 || n % 2 != 0 || !aligned(y, 8) ||
      (b != nullptr && !aligned(b, 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float *xf = static_cast<const float*>(x),
              *wf = static_cast<const float*>(w),
              *bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return route == kTma ? launch<kTma>(xf, wf, bf, yf, m, n, k, s)
                       : launch<kCpAsync>(xf, wf, bf, yf, m, n, k, s);
}

// Dynamic shared memory of the kernel, bytes.
int eva_linear_smem_bytes() { return static_cast<int>(kSmemBytes); }

const char* eva_linear_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
