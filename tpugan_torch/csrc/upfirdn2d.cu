// upfirdn2d: upsample by zero-stuffing, pad, FIR-filter, downsample — NCHW, fp32 or bf16.
//
// Replaces the two Pallas TPU kernels of tpugan/ops/pallas/upfirdn2d.py:
//   * upfirdn2d_pallas         (B1: C % 128 == 0; up, down in {1, 2})
//   * upfirdn2d_pallas_small_c (B2: 128 % C == 0; same-size FIR, with (W, C)
//                               flattened onto the TPU's 128-wide lane axis)
// The lane trick exists only because of the TPU's (8, 128) tiling. On this
// card channel planes are contiguous in NCHW, so one kernel covers both
// contracts, whatever C is.
//
// Function (the same as tpugan/ops/upfirdn.py::_upfirdn2d_xla):
// cross-correlation with the taps as given (not flipped),
//   y[n, c, oy, ox] = sum_{ty, tx} k[ty, tx] * s[n, c, oy*down + ty - pad0, ox*down + tx - pad0]
// where s is x zero-stuffed by `up` (s[up*i, up*j] = x[i, j], zero elsewhere
// and outside), and Ho = (H*up + pad0 + pad1 - kh) / down + 1 (same for W).
// The gain is folded into the taps by the caller. Any kh, kw <= 8 (kh != kw
// and non-separable taps included), pads >= 0.
//
// Bound: bytes. The same-size 3x3 blur reads and writes each activation
// element once (8 bytes in fp32) against 9 FMAs, far below the card's
// operations-per-byte balance. The first design (one thread per output,
// four 64-bit divisions to find it, nine scalar loads through L1) ran at
// 6-19% of the byte bound. This design is about bytes in flight and
// instructions per output:
//  * A block owns an output tile of one plane, or several whole small
//    planes (so the 8x8 and 16x16 planes still give a few hundred blocks of
//    useful size), and stages the input rows and columns the tile reads,
//    halo included, in shared memory with cp.async: 16-byte copies when
//    every row starts 16-byte aligned (w % 4 == 0 and an aligned base; the
//    tile's first column is then rounded down to a multiple of 4 and the
//    compute starts `lead` columns in), 4-byte copies otherwise. Padding
//    and the halo outside the plane are the copies' zero fill. A row of the
//    tile is copied by the smallest power-of-two group of lanes that covers
//    it, so narrow planes keep the lanes busy.
//  * The launch plan (tile rows and columns, staged rows and row stride,
//    planes per block, the up-2 phase, the copy width, threads and blocks)
//    comes from tpugan_torch/ops/upfirdn.py::fir_plan, where the CPU tests
//    run it tile by tile; the entry point checks every property of it that
//    the kernel relies on and refuses the launch otherwise. The block's
//    index arithmetic is done once, in 32 bits, from blockIdx.
//  * Each thread computes a strip of kStripRows = 4 rows by RW columns from
//    shared memory, neighbouring threads on neighbouring strips: RW = 4 for
//    a same-size FIR on rows of 32 or more (one 16-byte store per strip
//    row), RW = 1 on narrower rows, where more threads per plane finish a
//    latency-bound launch sooner (chip_smoke.py times every path blur with
//    both widths; PERF.md), RW = 2 for up 2 (a column pair, so each
//    column's phase is fixed), RW = 1 for down 2. Blocks of at most 128
//    threads; small planes share a block while the launch keeps two blocks
//    per SM.
//  * The path's FIRs are compile-time cases: the 3x3 blur and the 4x4 FIRs
//    at (up, down) = (1, 1), (2, 1) and (1, 2); one runtime-tap case per
//    (up, down) takes any other size up to 8x8. With compile-time taps a
//    thread reads each staged row its strip needs once into registers and
//    adds it into every output row that reads it.
//  * Polyphase up-2, as the TPU kernel's _fir_axis_up2: a strip's first
//    output row and column are even, so each output's phase is known at
//    compile time (the pad's parity, PH, is a template parameter) and it
//    sums only the taps that land on real samples. Down-2 computes only the
//    kept outputs.
// Each output sums its taps row-major (ty, then tx) with fmaf from 0, as
// the first design did: on the card it equals the plain version (cuDNN's
// depthwise conv) exactly in every parity case.
// ptxas (sm_90a): 29-40 registers, no spills; no static shared memory, and
// a dynamic tile of at most 48 KB (kMaxSharedBytes; 9.8 KB for a 32x64
// band, 10.6 KB for an 8x256 band), so no opt-in attribute is needed.
// Measured at the SGv1 decode's six blur shapes (chip_smoke.py, H100 SXM
// at 700 W): 73-84% of the byte bound at 128x128 and 64x256x256, 47-60% at
// 32x32 and 64x64, and launch latency at 8x8 and 16x16 (PERF.md). Left
// for later work: overlapping a block's next tile with its current one.
//
// bf16 (tpugan_upfirdn2d_bf16), as the Pallas kernels take it: they stage x
// in its own dtype, compute in fp32 and write x's dtype
// (tpugan/ops/pallas/upfirdn2d.py:96-105, :291, :304; :153, :180, :191).
// The kernel is templated on the element type T: the tile is staged in T
// (bf16 halves its shared memory and its copies, as in Pallas), each
// staged element is widened to fp32 where it is read, the taps stay fp32
// and the sums are the fp32 kernel's, in the same order, and each output
// is rounded once to bf16, to nearest even (__float2bfloat16_rn, what
// JAX's astype does). A 16-byte copy holds 8 bf16 (w % 8 == 0 and an
// aligned base; the tile's first column is then rounded down to a
// multiple of 8); otherwise cp.async, whose smallest copy is 4 bytes, does
// not apply and each bf16 is loaded and stored by its thread. A strip row
// of 4 bf16 is one 8-byte store, of 2 one 4-byte store. The launch plan
// carries the element size it was made for, and each entry point refuses
// a plan of the other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kMaxThreads = 128;
constexpr int kStripRows = 4;
constexpr int kMaxSharedBytes = 48 * 1024;

// the launch plan, as tpugan_torch/ops/upfirdn.py::PLAN_FIELDS orders it
enum PlanField {
  kRh, kRw, kTileRows, kTileCols, kTilesY, kTilesX, kPlanesPerBlock, kInRows, kInStride,
  kPhase, kVec, kThreads, kBlocks, kSharedBytes, kElemBytes, kPlanFields
};

// elements of T in one 16-byte copy
template <typename T>
constexpr int kVecElems = 16 / static_cast<int>(sizeof(T));

struct Taps {
  float v[kMaxTaps * kMaxTaps];
};

struct Geometry {
  int64_t planes;
  int h, w, ho, wo, pad0, kh, kw;
  int tile_rows, tile_cols, tiles_y, tiles_x, planes_per_block, in_rows, in_stride;
  int vec;         // 16-byte copies
  int wide_store;  // a strip row is stored as one RW-element vector
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// asynchronous global -> shared copies; an invalid source fills zeros
__device__ __forceinline__ void copy4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// Stages `rows` = planes x in_rows input rows, in_stride elements each,
// from input row iy0 and column gx0 on, WIDTH elements a copy: 16 bytes
// (kVecElems), or one element (4-byte cp.async for fp32; for bf16 a load
// and a store by the thread, cp.async having no 2-byte copy). A row of
// `chunks` copies is taken by a group of lanes, the smallest power of two
// that covers it (at most a warp), so narrow planes keep every lane busy
// without a division per copy.
template <typename T, int WIDTH>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ x, const Geometry& g,
                                      int64_t plane0, int rows, int iy0, int gx0) {
  static_assert(WIDTH == 1 || WIDTH == kVecElems<T>, "one element or 16 bytes a copy");
  const int chunks = g.in_stride / WIDTH;
  int lg = 0;
  while (lg < 5 && (1 << lg) < chunks) ++lg;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 >> lg;
  const int step = (blockDim.x >> 5) * per_warp;
  const int c0 = lane & ((1 << lg) - 1);
  for (int row = (threadIdx.x >> 5) * per_warp + (lane >> lg); row < rows; row += step) {
    const int p = row / g.in_rows;
    const int iy = iy0 + row - p * g.in_rows;
    const bool row_ok = iy >= 0 && iy < g.h;
    const T* src = x + ((plane0 + p) * g.h + (row_ok ? iy : 0)) * static_cast<int64_t>(g.w);
    T* dst = tile + row * g.in_stride;
    for (int c = c0; c < chunks; c += 1 << lg) {
      const int ix = gx0 + c * WIDTH;
      const bool ok = row_ok && ix >= 0 && ix < g.w;  // 16-byte copies: w % WIDTH == 0, all or nothing
      if constexpr (WIDTH > 1) {
        copy16(dst + c * WIDTH, ok ? src + ix : x, ok);
      } else if constexpr (sizeof(T) == 4) {
        copy4(dst + c, ok ? src + ix : x, ok);
      } else {
        dst[c] = ok ? src[ix] : from_float<T>(0.f);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One strip with compile-time taps. `s` is the staged element of the
// strip's first output row and column at tap (0, 0)'s phase origin: output
// (da, db) reads staged row (PH + da*DOWN + ty) / UP and column
// (PH + db*DOWN + tx) / UP, for the taps that land on real samples. Each
// staged row is read once into registers, widened to fp32.
template <int KH, int KW, int UP, int DOWN, int PH, int RW, typename T>
__device__ __forceinline__ void strip_fixed(const T* s, int stride, const Taps& t,
                                            float (&acc)[kStripRows][RW]) {
  constexpr int kRows = (PH + (kStripRows - 1) * DOWN + KH - 1) / UP + 1;
  constexpr int kCols = (PH + (RW - 1) * DOWN + KW - 1) / UP + 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = to_float(s[r * stride + c]);
#pragma unroll
    for (int da = 0; da < kStripRows; ++da) {
#pragma unroll
      for (int ty = 0; ty < KH; ++ty) {
        const int sy = PH + da * DOWN + ty;
        if (sy % UP != 0 || sy / UP != r) continue;
#pragma unroll
        for (int db = 0; db < RW; ++db) {
#pragma unroll
          for (int tx = 0; tx < KW; ++tx) {
            const int sx = PH + db * DOWN + tx;
            if (sx % UP != 0) continue;
            acc[da][db] = fmaf(t.v[ty * KW + tx], v[sx / UP], acc[da][db]);
          }
        }
      }
    }
  }
}

// One strip with runtime taps: each output phase starts at its first tap
// on a real sample and steps by UP, with no test in the loop.
template <int UP, int DOWN, int PH, int RW, typename T>
__device__ __forceinline__ void strip_any(const T* s, int stride, int kh, int kw,
                                          const Taps& t, float (&acc)[kStripRows][RW]) {
#pragma unroll
  for (int da = 0; da < kStripRows; ++da) {
    const int sy0 = PH + da * DOWN;
    for (int ty = (UP - sy0 % UP) % UP; ty < kh; ty += UP) {
      const T* row = s + ((sy0 + ty) / UP) * stride;
#pragma unroll
      for (int db = 0; db < RW; ++db) {
        const int sx0 = PH + db * DOWN;
        for (int tx = (UP - sx0 % UP) % UP; tx < kw; tx += UP) {
          acc[da][db] = fmaf(t.v[ty * kw + tx], to_float(row[(sx0 + tx) / UP]), acc[da][db]);
        }
      }
    }
  }
}

// a strip row of RW outputs (RW = 2 or 4) as one vector store: 16 or 8
// bytes of fp32, 8 or 4 bytes of bf16
__device__ __forceinline__ void store_wide(float* row, const float (&a)[4]) {
  *reinterpret_cast<float4*>(row) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_wide(float* row, const float (&a)[2]) {
  *reinterpret_cast<float2*>(row) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the lower address, is lo
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ void store_wide(__nv_bfloat16* row, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(row) = make_uint2(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]));
}
__device__ __forceinline__ void store_wide(__nv_bfloat16* row, const float (&a)[2]) {
  *reinterpret_cast<unsigned*>(row) = bf16_pair(a[0], a[1]);
}

// KH = KW = 0: runtime taps (g.kh, g.kw)
template <typename T, int KH, int KW, int UP, int DOWN, int PH, int RW>
__global__ void __launch_bounds__(kMaxThreads)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Taps taps) {
  static_assert(kStripRows * DOWN % UP == 0 && RW * DOWN % UP == 0,
                "a strip must start on an even stuffed row and column");
  extern __shared__ __align__(16) unsigned char shared[];
  T* tile = reinterpret_cast<T*>(shared);

  // the block's tile, once, in 32 bits
  int b = blockIdx.x;
  const int tile_x = b % g.tiles_x;
  b /= g.tiles_x;
  const int tile_y = b % g.tiles_y;
  const int64_t plane0 = static_cast<int64_t>(b / g.tiles_y) * g.planes_per_block;
  const int planes = static_cast<int>(
      g.planes - plane0 < g.planes_per_block ? g.planes - plane0 : g.planes_per_block);
  const int oy0 = tile_y * g.tile_rows;
  const int ox0 = tile_x * g.tile_cols;
  // the first input row and column the tile reads: oy0*DOWN - pad0 - PH is
  // a multiple of UP (PH = -pad0 mod UP, oy0*DOWN even when UP = 2)
  const int iy0 = (oy0 * DOWN - g.pad0 - PH) / UP;
  const int ix0 = (ox0 * DOWN - g.pad0 - PH) / UP;
  // rounded down to a 16-byte boundary
  const int gx0 = g.vec ? (ix0 & ~(kVecElems<T> - 1)) : ix0;

  if (g.vec) {
    stage<T, kVecElems<T>>(tile, x, g, plane0, planes * g.in_rows, iy0, gx0);
  } else {
    stage<T, 1>(tile, x, g, plane0, planes * g.in_rows, iy0, gx0);
  }
  __syncthreads();

  const int strip_cols = g.tile_cols / RW;
  const int per_plane = strip_cols * (g.tile_rows / kStripRows);
  const int tid = threadIdx.x;
  if (tid >= planes * per_plane) return;
  const int p = tid / per_plane;
  const int rest = tid - p * per_plane;
  const int sr = rest / strip_cols;
  const int sc = rest - sr * strip_cols;
  const T* s = tile + (p * g.in_rows + sr * (kStripRows * DOWN / UP)) * g.in_stride +
               (ix0 - gx0) + sc * (RW * DOWN / UP);

  float acc[kStripRows][RW];
#pragma unroll
  for (int da = 0; da < kStripRows; ++da) {
#pragma unroll
    for (int db = 0; db < RW; ++db) acc[da][db] = 0.f;
  }
  if constexpr (KH > 0) {
    strip_fixed<KH, KW, UP, DOWN, PH, RW>(s, g.in_stride, taps, acc);
  } else {
    strip_any<UP, DOWN, PH, RW>(s, g.in_stride, g.kh, g.kw, taps, acc);
  }

  const int oy = oy0 + sr * kStripRows;
  const int ox = ox0 + sc * RW;
  T* out = y + (plane0 + p) * static_cast<int64_t>(g.ho) * g.wo + ox;
#pragma unroll
  for (int da = 0; da < kStripRows; ++da) {
    if (oy + da >= g.ho) break;
    T* row = out + static_cast<int64_t>(oy + da) * g.wo;
    if constexpr (RW > 1) {
      if (g.wide_store && ox + RW <= g.wo) {
        store_wide(row, acc[da]);
        continue;
      }
    }
#pragma unroll
    for (int db = 0; db < RW; ++db) {
      if (ox + db < g.wo) row[db] = from_float<T>(acc[da][db]);
    }
  }
}

template <typename T, int KH, int KW, int UP, int DOWN, int PH, int RW>
cudaError_t launch(const T* x, T* y, const Geometry& g, const Taps& t, const int* plan,
                   cudaStream_t stream) {
  upfirdn2d_kernel<T, KH, KW, UP, DOWN, PH, RW>
      <<<static_cast<unsigned>(plan[kBlocks]), plan[kThreads], plan[kSharedBytes], stream>>>(x, y, g, t);
  return cudaGetLastError();
}

// the compile-time tap cases of this (up, down), else runtime taps
template <typename T, int UP, int DOWN, int PH, int RW>
cudaError_t launch_taps(const T* x, T* y, const Geometry& g, const Taps& t, const int* plan,
                        cudaStream_t stream) {
  if constexpr (UP == 1 && DOWN == 1) {
    if (g.kh == 3 && g.kw == 3) return launch<T, 3, 3, UP, DOWN, PH, RW>(x, y, g, t, plan, stream);
  }
  if constexpr (UP * DOWN <= 2) {
    if (g.kh == 4 && g.kw == 4) return launch<T, 4, 4, UP, DOWN, PH, RW>(x, y, g, t, plan, stream);
  }
  return launch<T, 0, 0, UP, DOWN, PH, RW>(x, y, g, t, plan, stream);
}

// strip columns of each (up, down): a whole number of stuffed-sample pairs
// for up 2 (so each column's phase is fixed), one column otherwise
constexpr int strip_width(int up, int down) { return up == 2 && down == 1 ? 2 : 1; }

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Every property of the plan that the kernel relies on; false refuses it.
template <typename T>
bool plan_is_valid(const int* p, int64_t planes, int h, int w, int ho, int wo, int up, int down,
                   int pad0, int kh, int kw, const T* x) {
  constexpr int vec_elems = kVecElems<T>;
  if (p[kElemBytes] != static_cast<int>(sizeof(T))) return false;
  if (p[kRh] != kStripRows ||
      (p[kRw] != strip_width(up, down) && !(up == 1 && down == 1 && p[kRw] == 4))) {
    return false;
  }
  if (p[kTileRows] < kStripRows || p[kTileRows] % kStripRows != 0 || p[kTileCols] < p[kRw] ||
      p[kTileCols] % p[kRw] != 0 || p[kPlanesPerBlock] < 1 || p[kTilesY] < 1 || p[kTilesX] < 1) {
    return false;
  }
  if (static_cast<int64_t>(p[kTilesY]) * p[kTileRows] < ho ||
      static_cast<int64_t>(p[kTilesX]) * p[kTileCols] < wo) {
    return false;
  }
  if (p[kPhase] != (up - pad0 % up) % up) return false;
  const int64_t rows = (p[kPhase] + static_cast<int64_t>(p[kTileRows] - 1) * down + kh - 1) / up + 1;
  const int64_t cols = (p[kPhase] + static_cast<int64_t>(p[kTileCols] - 1) * down + kw - 1) / up + 1;
  if (p[kInRows] < rows) return false;
  if (p[kVec]) {
    if (w % vec_elems != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        p[kInStride] % vec_elems != 0 || p[kInStride] < cols + vec_elems - 1) {
      return false;
    }
  } else if (p[kVec] != 0 || p[kInStride] < cols) {
    return false;
  }
  const int64_t strips = static_cast<int64_t>(p[kPlanesPerBlock]) * (p[kTileRows] / kStripRows) *
                         (p[kTileCols] / p[kRw]);
  if (p[kThreads] % 32 != 0 || p[kThreads] < strips || p[kThreads] > kMaxThreads) return false;
  const int64_t shared =
      static_cast<int64_t>(p[kPlanesPerBlock]) * p[kInRows] * p[kInStride] * sizeof(T);
  if (p[kSharedBytes] != shared || shared > kMaxSharedBytes) return false;
  const int64_t blocks = cdiv(planes, p[kPlanesPerBlock]) * p[kTilesY] * p[kTilesX];
  return p[kBlocks] == blocks && blocks <= 0x7fffffffLL;
}

template <typename T>
int run(const T* x, T* y, int64_t planes, int h, int w, int ho, int wo, int up, int down, int pad0,
        int kh, int kw, const float* taps, const int* plan, int device, void* stream) {
  if (planes < 0 || h < 1 || w < 1 || ho < 1 || wo < 1 || pad0 < 0 || kh < 1 ||
      kh > kMaxTaps || kw < 1 || kw > kMaxTaps || (up != 1 && up != 2) ||
      (down != 1 && down != 2) || static_cast<int64_t>(h) * w > 0x7fffffffLL ||
      static_cast<int64_t>(ho) * wo > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planes == 0) return 0;
  if (!plan_is_valid(plan, planes, h, w, ho, wo, up, down, pad0, kh, kw, x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Taps t{};
  for (int i = 0; i < kh * kw; ++i) t.v[i] = taps[i];
  const int rw = plan[kRw];
  Geometry g{planes, h, w, ho, wo, pad0, kh, kw, plan[kTileRows], plan[kTileCols], plan[kTilesY],
             plan[kTilesX], plan[kPlanesPerBlock], plan[kInRows], plan[kInStride], plan[kVec],
             rw > 1 && wo % rw == 0 && reinterpret_cast<uintptr_t>(y) % (sizeof(T) * rw) == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (up == 1 && down == 1) {
    err = rw == 4 ? launch_taps<T, 1, 1, 0, 4>(x, y, g, t, plan, s)
                  : launch_taps<T, 1, 1, 0, strip_width(1, 1)>(x, y, g, t, plan, s);
  } else if (up == 2 && down == 1) {
    err = plan[kPhase] ? launch_taps<T, 2, 1, 1, strip_width(2, 1)>(x, y, g, t, plan, s)
                       : launch_taps<T, 2, 1, 0, strip_width(2, 1)>(x, y, g, t, plan, s);
  } else if (up == 1 && down == 2) {
    err = launch_taps<T, 1, 2, 0, strip_width(1, 2)>(x, y, g, t, plan, s);
  } else {
    err = plan[kPhase] ? launch_taps<T, 2, 2, 1, strip_width(2, 2)>(x, y, g, t, plan, s)
                       : launch_taps<T, 2, 2, 0, strip_width(2, 2)>(x, y, g, t, plan, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes, one per element type: x and y
// fp32, or bf16 (the taps and the sums fp32 in both). `taps` is a host
// array of kh*kw floats (row-major, gain folded in); `plan` is a host
// array of kPlanFields ints from tpugan_torch/ops/upfirdn.py::fir_plan,
// made for this element size. Both are copied into the launch, so the
// caller may free them on return. `device` is the ordinal that holds x, y
// and `stream` (this library has its own runtime state, so it sets the
// device itself). Launches on `stream` and does not synchronise. Returns
// 0, or the cudaError_t of a refused launch (cudaErrorInvalidValue for
// arguments or a plan outside the kernel's contract).
extern "C" int tpugan_upfirdn2d_f32(const float* x, float* y, int64_t planes, int h, int w,
                                    int ho, int wo, int up, int down, int pad0, int kh, int kw,
                                    const float* taps, const int* plan, int device, void* stream) {
  return run(x, y, planes, h, w, ho, wo, up, down, pad0, kh, kw, taps, plan, device, stream);
}

extern "C" int tpugan_upfirdn2d_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int64_t planes,
                                     int h, int w, int ho, int wo, int up, int down, int pad0,
                                     int kh, int kw, const float* taps, const int* plan,
                                     int device, void* stream) {
  return run(x, y, planes, h, w, ho, wo, up, down, pad0, kh, kw, taps, plan, device, stream);
}
