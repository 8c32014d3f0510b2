// Multi-scale multi-view bilinear sampling forward over y-fold and pair-mode
// tables (sm_90a).
//
// Replaces: sparsebev_tpu/ops/msmv_sampling.py::_yfold_forward (:1011): the
// XLA window gathers (:1171 y-fold, :1215 pair) plus the tap folds
// (_fold_window_taps :893, the pair fold :1220-1228), and its group-major
// twin _gmajor_forward (:910, pair branch :981-1003). That op is not Pallas
// on the TPU; it is the reference model's one custom CUDA op, written here
// by hand.
//
// For each point k (query-major order (q, s, p)) and each level l:
//   view  = clip(round(v * (N-1)), 0, N-1); pixel = loc * (size - 1)
//   (sx, ry, wxa, wxb, wya, wyb) = the separable slot weights with the
//   shifted-window remap at x0/y0 = -1 (_separable_slot_weights :600)
//   row(y) = ((bt * N + view) * H + y) * G + gi, (bt, gi) = divmod(slice_map[s], G)
//   y-fold level: window = table[row(ry), sx:sx+2, 0:2C] (all four taps)
//   pair level:   windows table[row(ry), sx:sx+2, 0:C] and
//                 table[row(min(ry+1, H-1)), sx:sx+2, 0:C]
//   out[k] += fold(windows) weighted by sw[k, l]
// Output [Q, S, P, C] in the accumulator dtype (``table_acc_dtype``): the
// table dtype for bf16 or fp32 tables, fp32 when level 0 is e4m3.
//
// e4m3 levels (streaming rings with ``table_fp8``, the JAX ring stores them
// as float8_e4m3fn): a level's table may hold e4m3 values beside bf16 or
// fp32 levels (the ring keeps the frame's dtype for the others,
// sparsebev_tpu/inference.py:55-77). As the JAX fold does (:900-901
// y-fold, :996-997 group-major pair, :1221-1222 pair), each e4m3 tap is
// upcast to bf16 (exact: every e4m3 value is a bf16 value) and folds as a
// bf16 tap, x weights (or pair products) rounded to bf16, whatever the
// other levels' dtype. An e4m3 lane keeps the lane width of its tables:
// beside bf16 levels eight channels from 8 bytes (a bf16 lane loads 16),
// beside fp32 levels four channels from 4 bytes (an fp32 lane loads 16);
// cvt.rn.f16x2.e4m3x2 widens two at a time to f16, then to f32, both
// exact. With an fp32 output (level 0 e4m3, or fp32 tables) each level's
// fp32 fold is added to the fp32 accumulator unrounded, as JAX adds
// ``lvl_out.astype(f32)``; with a bf16 output (bf16 tables, only later
// levels e4m3) each level rounds to bf16 as before.
//
// Chunk-split levels (streaming rings with ``table_split``, the JAX ring
// keeps such a level as ``split`` separate buffers, each holding
// num_slots / split consecutive ring slots, and gathers chunk by chunk,
// _yfold_forward :1028-1060, :1135-1170): such a level's table is the list
// of its chunk base pointers and its frames per chunk. A point resolves its
// physical frame bt (slice_map[s] / G, the ring slot) to (chunk bt / cf,
// frame in chunk bt % cf) and takes its row in that chunk as the unsplit
// ring would hold it there, so the split route reads the same values and
// gives the unsplit route's bits. The chunk pointers ride in a
// __grid_constant__ parameter block, indexed at run time in place (no
// copy to the stack); unsplit levels take no extra instruction but the
// test of their chunk count.
//
// Numerics follow the bits XLA gives for the JAX code under jit: y-fold
// levels round the x weights to the table dtype; pair levels round the
// products wx * wy * lw to it. A bf16 tap times its bf16 weight is exact in
// fp32 and is not rounded (XLA's excess-precision rewrite drops that
// rounding). Taps add in fp32; each level's sum is rounded to the table
// dtype and added to an accumulator kept in the table dtype. A pair level
// adds its two y taps in fp32 and rounds once when `gmajor` is set (the
// group-major forward, taken when any level is group-split), and rounds and
// adds each y tap on its own otherwise (the unsplit forward). Built with
// --fmad=false, so every product and sum rounds on its own as in the plain
// PyTorch version.
//
// Bound: bytes. Per call at flagship r50 (Q=900, S=32, P=4, 4 levels, C=64,
// bf16): 115,200 points x 4 levels x 512-byte windows = 236 MB if no window
// is shared, 14.7 MB of output and 3.2 MB of geometry; the table pieces
// that uniform random points touch with a nonzero weight come to about
// 152 MB in all, 45 us at 3.35 TB/s. At vov99 (Q=1600, S=60, P=4, 5 levels,
// the pair level reading two 256-byte windows): 384,000 points x 5 x 512 B
// = 983 MB if no window is shared, about 659 MB needed, 0.197 ms. The
// arithmetic is far below the card's rate.
//
// Design: a group of lanes per point, 16 bytes per lane. Each lane owns one
// 16-byte run of the C channels (8 bf16 or 4 fp32 values), so C = 64 takes
// 8 lanes in bf16 (16 in fp32) and a warp carries 4 (2) points: the P = 4
// points of one (query, slice) in the query-major order. One warp-level
// load instruction now moves 512 bytes where the one-warp-per-point kernel
// before it moved 128, and the point geometry (some 60 instructions a
// level) runs once for four points instead of once for each. The level
// count is a template parameter and the level loop is unrolled, so the
// per-level table pointers and sizes are read from the kernel parameters at
// fixed offsets (a run-time index would copy the parameter block to the
// stack) and the kernel is written in two passes: the first computes every
// level's weights and starts all 4 * L tap loads (ld.global.nc.v4) of the
// point, the second folds them. The rounding per level and the order of
// accumulation do not depend on when a tap was loaded, so the bits are
// those of the plain version. The integer divisions (slice, frame, group)
// are 32-bit and happen once per lane; rows and columns are 32-bit, only
// the final byte offset is 64-bit. No shared memory, no atomics: each
// output run is written once, by one lane, as 16 bytes.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W, bf16,
// L2 flushed: 0.088 ms a call at r50 and 0.353 ms at vov99 on uniform random
// points (the one-warp-per-point kernel before it: 0.154 and 0.582), 0.060 ms
// on one r50 decoder layer's recorded points (bound 0.029). At the uniform
// points that is the windows' 236 MB / 983 MB plus output and geometry at
// about 2.9 TB/s: the kernel moves every window it is asked for at the
// card's memory rate, and only windows shared between points (the bound
// counts each once) could make it faster. Block sizes of 64 and 256
// threads and L1 no-allocate or evict-first loads were no faster. With the
// e4m3 route beside it: 123 / 128 registers at 4 / 5 levels (bf16 tables,
// either output), no stack frame, no spills; on uniform points an e4m3 L0
// at the vov99 shapes (fp32 output) takes 0.322 ms a call against 0.343
// for the same values as bf16 tables (bound 0.185), r50 with an e4m3 L1
// 0.078 against 0.086 (same card).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 16;
constexpr int kThreads = 128;

struct Levels {
  const void* table[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int yfold[kMaxLevels];  // 1: rows [w+1, 2c] (y-fold), 0: [w+1, c] (pair)
  int fp8[kMaxLevels];    // 1: e4m3 entries (beside bf16 or fp32 levels)
};

// chunk-split levels: frames a chunk (0: the level is one table) and the
// chunks' base pointers, indexed by the chunk a point's frame lies in
struct Chunks {
  int frames[kMaxLevels];
  const void* base[kMaxLevels][kMaxChunks];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One lane's 16 bytes of a table row as floats, and back.
template <typename T>
struct Run;

template <>
struct Run<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& v, float (&f)[kVec]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[kVec]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float v) { return v; }
};

template <>
struct Run<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& v, float (&f)[kVec]) {
    // a bf16 is the upper half of its fp32
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
    f[4] = __uint_as_float(v.z << 16);
    f[5] = __uint_as_float(v.z & 0xffff0000u);
    f[6] = __uint_as_float(v.w << 16);
    f[7] = __uint_as_float(v.w & 0xffff0000u);
  }
  // f holds values already rounded to bf16: the upper halves are exact
  __device__ static uint4 pack(const float (&f)[kVec]) {
    return make_uint4(
        (__float_as_uint(f[0]) >> 16) | (__float_as_uint(f[1]) & 0xffff0000u),
        (__float_as_uint(f[2]) >> 16) | (__float_as_uint(f[3]) & 0xffff0000u),
        (__float_as_uint(f[4]) >> 16) | (__float_as_uint(f[5]) & 0xffff0000u),
        (__float_as_uint(f[6]) >> 16) | (__float_as_uint(f[7]) & 0xffff0000u));
  }
  __device__ static float round(float v) { return round_bf16(v); }
};

__device__ __forceinline__ uint4 load16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 8 e4m3 bytes (one lane's eight channels) in .x / .y
__device__ __forceinline__ uint4 load8(const char* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_uint4(v.x, v.y, 0u, 0u);
}

// 4 e4m3 bytes (an fp32-width lane's four channels) in .x
__device__ __forceinline__ uint4 load4(const char* p) {
  return make_uint4(__ldg(reinterpret_cast<const unsigned*>(p)), 0u, 0u, 0u);
}

// two e4m3 values (the low byte first) -> two exact floats
__device__ __forceinline__ void e4m3x2(unsigned v, float& lo, float& hi) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(v & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  lo = f.x;
  hi = f.y;
}

// one lane's kVec (8 or 4) e4m3 channels (byte j = channel j) as floats
template <int kVec>
__device__ __forceinline__ void unpack_e4m3(const uint4& v,
                                            float (&f)[kVec]) {
  e4m3x2(v.x, f[0], f[1]);
  e4m3x2(v.x >> 16, f[2], f[3]);
  if constexpr (kVec == 8) {
    e4m3x2(v.y, f[4], f[5]);
    e4m3x2(v.y >> 16, f[6], f[7]);
  }
}

// a lane's run of the table dtype TB, or of e4m3 at TB's lane width
template <typename TB>
__device__ __forceinline__ void unpack_level(const uint4& v, bool fp8,
                                             float (&f)[Run<TB>::kVec]) {
  if (fp8) {
    unpack_e4m3<Run<TB>::kVec>(v, f);
    return;
  }
  Run<TB>::unpack(v, f);
}

// a lane's kVec accumulated values written as TO (16 bytes a store)
template <typename TO, int kVec>
__device__ __forceinline__ void store_run(char* p, const float (&f)[kVec]) {
  if constexpr (sizeof(TO) == 2) {
    static_assert(kVec == 8, "a bf16 output run is 8 values");
    *reinterpret_cast<uint4*>(p) = Run<__nv_bfloat16>::pack(f);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<uint4*>(p + 4 * i) = make_uint4(
          __float_as_uint(f[i]), __float_as_uint(f[i + 1]),
          __float_as_uint(f[i + 2]), __float_as_uint(f[i + 3]));
  }
}

// lanes_log2: log2 of the lanes that share a point (a power of two >=
// c * sizeof(TB) / 16; lanes past the last run idle). TB: the tables' dtype
// (an e4m3 level reads as TB's lanes); TO: the output and accumulator
// dtype.
template <typename TB, typename TO, int L>
__global__ void __launch_bounds__(kThreads)
    msmv_sample_kernel(const Levels lv, const __grid_constant__ Chunks ch,
                       const float* __restrict__ loc,
                       const float* __restrict__ sw,
                       const int* __restrict__ slice_map, TO* __restrict__ out,
                       unsigned num_points, unsigned s, unsigned p, unsigned n,
                       unsigned g, int c, int lanes_log2, bool gmajor) {
  constexpr int kVec = Run<TB>::kVec;
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned k = tid >> lanes_log2;
  const int cc = (int)(tid & ((1u << lanes_log2) - 1u)) * kVec;
  if (k >= num_points || cc >= c) return;

  const unsigned si = (k / p) % s;
  const float x = __ldg(loc + (size_t)k * 3 + 0);
  const float y = __ldg(loc + (size_t)k * 3 + 1);
  const float v = __ldg(loc + (size_t)k * 3 + 2);
  const float vf = fminf(fmaxf(rintf(v * (float)(n - 1)), 0.f),
                         (float)(n - 1));
  const unsigned view = (unsigned)vf;
  const unsigned phys = (unsigned)__ldg(slice_map + si);
  const unsigned bt = phys / g;
  const unsigned gi = phys % g;

  // pass 1: every level's weights, and all of its four tap loads in flight.
  // t00/t01: row ry at columns sx, sx+1; t10/t11: row ry+1 (y-fold: the
  // second half of the same table row; pair: the next image row, clamped).
  uint4 t00[L], t01[L], t10[L], t11[L];
  float q0[L], q1[L], q2[L], q3[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    // clamping far-out pixels to [-2, size+1] keeps the int conversion in
    // range and leaves every weight unchanged (all taps are masked there)
    const float xp = fminf(fmaxf(x * (float)(w - 1), -2.f), (float)(w + 1));
    const float yp = fminf(fmaxf(y * (float)(h - 1), -2.f), (float)(h + 1));
    const float x0f = floorf(xp);
    const float y0f = floorf(yp);
    const float lx = xp - x0f;
    const float ly = yp - y0f;
    const int ix0 = (int)x0f;
    const int iy0 = (int)y0f;
    const float wx0 = (ix0 >= 0 && ix0 <= w - 1) ? 1.f - lx : 0.f;
    const float wx1 = (ix0 + 1 >= 0 && ix0 + 1 <= w - 1) ? lx : 0.f;
    const float wy0 = (iy0 >= 0 && iy0 <= h - 1) ? 1.f - ly : 0.f;
    const float wy1 = (iy0 + 1 >= 0 && iy0 + 1 <= h - 1) ? ly : 0.f;
    const bool shx = ix0 < 0;
    const bool shy = iy0 < 0;
    const int sx = min(max(ix0, 0), w - 1);
    const int ry = min(max(iy0, 0), h - 1);
    const float wxa = shx ? wx1 : wx0;
    const float wxb = shx ? 0.f : wx1;
    const float wya = shy ? wy1 : wy0;
    const float wyb = shy ? 0.f : wy1;
    const float lw = __ldg(sw + (size_t)k * L + l);
    const float fya = wya * lw;
    const float fyb = wyb * lw;
    const bool yf = lv.yfold[l] != 0;
    const bool f8 = lv.fp8[l] != 0;
    // weights in the table dtype; an e4m3 level's taps are upcast to bf16
    // first, so its weights round to bf16 whatever TB is
    if (yf) {
      // x weights in the table dtype (_fold_window_taps :902)
      q0[l] = f8 ? round_bf16(wxa) : Run<TB>::round(wxa);
      q1[l] = f8 ? round_bf16(wxb) : Run<TB>::round(wxb);
      q2[l] = fya;
      q3[l] = fyb;
    } else {
      // weights wx * (wy * lw) rounded to the table dtype (:1223-1225)
      q0[l] = f8 ? round_bf16(wxa * fya) : Run<TB>::round(wxa * fya);
      q1[l] = f8 ? round_bf16(wxb * fya) : Run<TB>::round(wxb * fya);
      q2[l] = f8 ? round_bf16(wxa * fyb) : Run<TB>::round(wxa * fyb);
      q3[l] = f8 ? round_bf16(wxb * fyb) : Run<TB>::round(wxb * fyb);
    }
    // C channels' bytes and this lane's offset in this level's dtype
    const unsigned isz = f8 ? 1u : (unsigned)sizeof(TB);
    const unsigned cb = (unsigned)c * isz;
    const unsigned ccb = (unsigned)cc * isz;
    // a split level: the chunk that holds frame bt, and bt's frame in it
    const char* table = static_cast<const char*>(lv.table[l]);
    unsigned btl = bt;
    if (ch.frames[l] > 0) {
      const unsigned ci = bt / (unsigned)ch.frames[l];
      btl = bt - ci * (unsigned)ch.frames[l];
      table = static_cast<const char*>(ch.base[l][ci]);
    }
    const unsigned row =
        ((btl * n + view) * (unsigned)h + (unsigned)ry) * g + gi;
    const unsigned col = row * (unsigned)(w + 1) + (unsigned)sx;
    // bytes between the two columns of a window, and from row ry to row
    // ry+1: wyb is 0 wherever row ry+1 is invalid, so the clamp (a step of
    // 0) changes no weight
    const unsigned stepx = yf ? 2u * cb : cb;
    const unsigned stepy =
        yf ? cb : (ry < h - 1 ? g * (unsigned)(w + 1) * cb : 0u);
    const char* top = table + (uint64_t)col * stepx + ccb;
    const char* bot = top + stepy;
    if (f8 && kVec == 8) {
      t00[l] = load8(top);
      t01[l] = load8(top + stepx);
      t10[l] = load8(bot);
      t11[l] = load8(bot + stepx);
    } else if (f8) {
      t00[l] = load4(top);
      t01[l] = load4(top + stepx);
      t10[l] = load4(bot);
      t11[l] = load4(bot + stepx);
    } else {
      t00[l] = load16(top);
      t01[l] = load16(top + stepx);
      t10[l] = load16(bot);
      t11[l] = load16(bot + stepx);
    }
  }

  // pass 2: fold, level by level, into the output dtype's accumulator
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const bool f8 = lv.fp8[l] != 0;
    float a0[kVec], a1[kVec], b0[kVec], b1[kVec];
    unpack_level<TB>(t00[l], f8, a0);
    unpack_level<TB>(t01[l], f8, a1);
    unpack_level<TB>(t10[l], f8, b0);
    unpack_level<TB>(t11[l], f8, b1);
    if (lv.yfold[l] != 0) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float r = (a0[j] * q0[l] + a1[j] * q1[l]) * q2[l] +
                        (b0[j] * q0[l] + b1[j] * q1[l]) * q3[l];
        acc[j] = Run<TO>::round(acc[j] + Run<TO>::round(r));
      }
    } else if (gmajor) {  // _gmajor_forward :986-1003: one add per level
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float u0 = a0[j] * q0[l] + a1[j] * q1[l];
        const float u1 = b0[j] * q2[l] + b1[j] * q3[l];
        acc[j] = Run<TO>::round(acc[j] + Run<TO>::round(u0 + u1));
      }
    } else {              // _yfold_forward :1211-1228: one add per y tap
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float u0 = a0[j] * q0[l] + a1[j] * q1[l];
        const float u1 = b0[j] * q2[l] + b1[j] * q3[l];
        acc[j] = Run<TO>::round(acc[j] + Run<TO>::round(u0));
        acc[j] = Run<TO>::round(acc[j] + Run<TO>::round(u1));
      }
    }
  }
  store_run<TO>(reinterpret_cast<char*>(out) +
                    ((uint64_t)k * (unsigned)c + (unsigned)cc) * sizeof(TO),
                acc);
}

template <typename TB, typename TO, int L>
void launch_levels(const Levels& lv, const Chunks& ch, const float* loc,
                   const float* sw,
                   const int* slice_map, void* out, unsigned num_points,
                   int s, int p, int n, int g, int c, int lanes_log2,
                   bool gmajor, cudaStream_t st) {
  const unsigned blocks = (unsigned)(
      (((uint64_t)num_points << lanes_log2) + kThreads - 1) / kThreads);
  msmv_sample_kernel<TB, TO, L><<<blocks, kThreads, 0, st>>>(
      lv, ch, loc, sw, slice_map, static_cast<TO*>(out), num_points,
      (unsigned)s, (unsigned)p, (unsigned)n, (unsigned)g, c, lanes_log2,
      gmajor);
}

template <typename TB, typename TO>
int launch(const Levels& lv, const Chunks& ch, int num_levels,
           const float* loc, const float* sw, const int* slice_map, void* out,
           unsigned num_points, int s, int p, int n, int g, int c,
           int lanes_log2, bool gmajor, cudaStream_t st) {
#define SAMPLE_CASE(L)                                                     \
  case L:                                                                  \
    launch_levels<TB, TO, L>(lv, ch, loc, sw, slice_map, out, num_points,  \
                             s, p, n, g, c, lanes_log2, gmajor, st);       \
    break;
  switch (num_levels) {
    SAMPLE_CASE(1) SAMPLE_CASE(2) SAMPLE_CASE(3) SAMPLE_CASE(4)
    SAMPLE_CASE(5) SAMPLE_CASE(6) SAMPLE_CASE(7) SAMPLE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SAMPLE_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tables/heights/widths/yfold/fp8/splits/chunk_frames: host arrays of
// num_levels entries; each table is [rows, w+1, 2c] (yfold 1) or
// [rows, w+1, c] (yfold 0)
// contiguous, of the table dtype (table_bf16: bf16, else fp32) or, where
// fp8 is set, of e4m3; 16-byte aligned, with rows * (w+1)
// below 2^31. loc [K, 3] and sw [K, L] fp32, slice_map [s] int32, out [K, c]
// 16-byte aligned in bf16 (out_bf16) or fp32; K = num_points = Q * s * p.
// c * itemsize (of the table dtype) is a multiple of 16 and at most 512;
// lanes_per_point is the power of two >= c * itemsize / 16 that the caller
// chose (at most 32). gmajor selects the pair levels' accumulation order
// (see the header). The supported pairs (table, output): (bf16, bf16),
// (bf16, fp32) and (fp32, fp32). A level with splits[l] > 1 (y-fold only)
// is that many chunk tables of chunk_frames[l] ring frames each
// ([chunk_frames * n * h * g, w+1, 2c], the same alignment and limits);
// chunks holds their base pointers, the split levels' in level order, and
// tables[l] is ignored for such a level.
int msmv_sample_forward(const void* const* tables, const int* heights,
                        const int* widths, const int* yfold, const int* fp8,
                        const int* splits, const int* chunk_frames,
                        const void* const* chunks, int num_levels,
                        const float* loc, const float* sw,
                        const int* slice_map, void* out,
                        long long num_points, int s, int p, int n, int g,
                        int c, int table_bf16, int out_bf16, int gmajor,
                        int lanes_per_point, void* stream) {
  const int itemsize = table_bf16 ? 2 : 4;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes_per_point) ++lanes_log2;
  if (num_levels < 1 || num_levels > kMaxLevels || c < 1 ||
      (c * itemsize) % 16 != 0 || lanes_per_point > 32 ||
      (1 << lanes_log2) != lanes_per_point ||
      lanes_per_point * 16 < c * itemsize || s < 1 || p < 1 || n < 1 ||
      g < 1 || num_points < 0 || (num_points << lanes_log2) >= (1LL << 31) ||
      (out_bf16 && !table_bf16) ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  Chunks ch = {};
  int next_chunk = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (splits[l] < 1 || splits[l] > kMaxChunks ||
        (splits[l] > 1 && (yfold[l] == 0 || chunk_frames[l] < 1)))
      return (int)cudaErrorInvalidValue;
    if (splits[l] > 1) {
      ch.frames[l] = chunk_frames[l];
      for (int i = 0; i < splits[l]; ++i) {
        const void* base = chunks[next_chunk++];
        if ((reinterpret_cast<uintptr_t>(base) & 15) != 0)
          return (int)cudaErrorInvalidValue;
        ch.base[l][i] = base;
      }
    }
    const void* table = splits[l] > 1 ? ch.base[l][0] : tables[l];
    if ((reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
        heights[l] < 1 || widths[l] < 1)
      return (int)cudaErrorInvalidValue;
    lv.table[l] = table;
    lv.h[l] = heights[l];
    lv.w[l] = widths[l];
    lv.yfold[l] = yfold[l] != 0;
    lv.fp8[l] = fp8[l] != 0;
  }
  if (num_points == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        lv, ch, num_levels, loc, sw, slice_map, out, (unsigned)num_points, s,
        p, n, g, c, lanes_log2, gmajor != 0, st);
  if (table_bf16)
    return launch<__nv_bfloat16, float>(
        lv, ch, num_levels, loc, sw, slice_map, out, (unsigned)num_points, s,
        p, n, g, c, lanes_log2, gmajor != 0, st);
  return launch<float, float>(lv, ch, num_levels, loc, sw, slice_map, out,
                              (unsigned)num_points, s, p, n, g, c,
                              lanes_log2, gmajor != 0, st);
}

const char* msmv_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
