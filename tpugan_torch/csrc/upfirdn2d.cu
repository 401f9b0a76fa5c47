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
// Function (the same as tpugan/ops/upfirdn.py::_upfirdn2d_xla, with the
// front pads taken per axis):
//   y[n, c, oy, ox] = sum_{ty, tx} k[ty, tx] * s[n, c, oy*down + ty - pad_y0, ox*down + tx - pad_x0]
// cross-correlation with the taps as given (not flipped), where s is x
// zero-stuffed by `up` (s[up*i, up*j] = x[i, j], zero elsewhere and
// outside). The output size (ho, wo) gives the back pads. The gain is
// folded into the taps by the caller. Any kh, kw <= 8 (kh != kw and
// non-separable taps included); front pads >= 0 with the same parity at
// up 2 (each output column's phase is then the same on both axes).
//
// Bound: bytes. A 3x3 or 4x4 FIR does 9-16 FMAs for every element it reads
// and writes, far below the card's operations-per-byte balance, so the
// design is about bytes in flight and instructions per byte:
//  * Tiles. A block owns an output tile of one plane, or several whole
//    small planes (so the 8x8 and 16x16 planes still give a few hundred
//    blocks of useful size), and stages the input rows and columns the tile
//    reads, halo included, in shared memory with cp.async. Each thread
//    computes a strip of kStripRows = 4 rows by RW columns, neighbouring
//    threads on neighbouring strips: for a same-size FIR RW = 4 on rows of
//    32 or more (a 16-byte store a strip row in fp32, 8 bytes in bf16) and
//    RW = 8 for bf16 (16 bytes) on rows of 128 or more, or of 64 or more
//    that are 16-byte aligned; RW = 1 on narrower rows, where more threads
//    per plane finish a latency-bound launch sooner; RW = 2 for up 2 (a
//    column pair, so each column's phase is fixed), RW = 1 for down 2. Blocks of at most 128 threads, a strip each;
//    wide planes are cut into row bands or 2-D tiles, the columns split
//    evenly. The plan (tile_rows .. elem_bytes, PlanField) comes from
//    tpugan_torch/ops/upfirdn.py::fir_plan, where the CPU tests run it tile
//    by tile; the entry point checks every property of it that the kernel
//    relies on and refuses the launch otherwise.
//  * Staging, chosen by the plan's `vec` from the rows' alignment and the
//    element type:
//    - every row 16-byte aligned (w a multiple of a 16-byte copy, an
//      aligned base; `vec`): 16-byte copies from the tile's first column
//      rounded down to a copy, the compute `lead` columns in. Padding and
//      the halo outside the plane are the copies' zero fill;
//    - fp32 rows off 16-byte boundaries: 4-byte copies, one element each;
//    - bf16 rows off 16-byte boundaries (cp.async has no 2-byte copy): each
//      staged row gets its own window of 16-byte copies, from the 16-byte
//      boundary at or below its own first column, and the compute reads it
//      through that row's lead (0 to 7). No copy reads outside its row:
//      the chunk across the row's end copies the row's bytes alone
//      (cp.async's source size; it fills the rest with zeros), and the
//      chunk that starts before the row is loaded element by element.
//      Chunks wholly in the padding are zero stores. (Copying those two
//      chunks whole and zeroing the neighbouring rows' elements after the
//      wait took a second pass over the rows and measured 1.03-1.27x this
//      at the step's odd widths.)
//    A row is copied by the smallest power-of-two group of lanes that
//    covers it, so narrow planes keep the lanes busy. fp32 takes per-row
//    windows nowhere: its 4-byte copies measured faster at the odd widths
//    of a StyleGAN2-1024 step (PERF.md).
//  * Reads. A staged row a strip needs is read once into registers: fp32
//    one load an element; bf16 rows of 6 or more elements as 32-bit pairs
//    realigned by a funnel shift, each half widened exactly (a bf16 value
//    is the high half of its fp32 value).
//  * Stores. A strip row of RW > 1 outputs is one vector store where the
//    output rows allow it. A 16-byte strip into rows that are not 16-byte
//    aligned (the adjoint of the 4-tap FIR into 2r+1 columns) stores the
//    aligned 16-byte chunk across its tail and its right neighbour's head,
//    taken by a warp shuffle, so each row gets a scalar head and tail and
//    16-byte stores between.
//  * The path's FIRs are compile-time cases: the 3x3 blur and the 4x4 FIRs
//    at (up, down) = (1, 1), (2, 1) and (1, 2); one runtime-tap case per
//    (up, down) takes any other size up to 8x8. Polyphase up-2 as the TPU
//    kernel's _fir_axis_up2: a strip's first output row and column are
//    even, so each output's phase is known at compile time (PH) and it sums
//    only the taps on real samples. Down-2 computes only the kept outputs.
// Each output sums its taps row-major (ty, then tx) with fmaf from 0, the
// staged element widened exactly and the taps in fp32, and is rounded once
// to the element type (bf16 to nearest even, __float2bfloat16_rn, as JAX's
// astype). So the bf16 kernel's output is bitwise the fp32 kernel's on the
// same values rounded to bf16, and the fp32 kernel equals the plain
// version (cuDNN's depthwise conv) in every parity case. The bf16 forms
// stage x in its own dtype and write x's dtype, as the Pallas kernels do
// (tpugan/ops/pallas/upfirdn2d.py:96-105, :153, :180, :191). The launch
// plan carries the element size it was made for; each entry point refuses
// a plan of the other.
// A tile stays within 48 KB of dynamic shared memory (kMaxSharedBytes), so
// no opt-in attribute is needed. Tried on the card and left out (PERF.md):
// a two-stage cp.async ring of tiles a block, an output tile in shared
// memory for odd widths, bf16 tiles of twice the strips, per-row windows
// for fp32.
// Measured (tools/fir_ab.py at a StyleGAN2-1024 step's and a StyleGANv1
// decode's shapes, NVIDIA H100 80GB HBM3, 700.00 W): planes of 256^2 and
// more at 61-78% of the byte bound in fp32 and 38-73% in bf16 (the bf16
// adjoints into odd widths lowest); the 31 shapes together at 69% (fp32)
// and 48% (bf16); planes of 8^2 to 33^2 bound by launch latency (3.3-9.5
// us a launch against bounds under 2.6). PERF.md's kernel table has the
// rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kMaxThreads = 128;
constexpr int kStripRows = 4;
constexpr int kCopyBytes = 16;
constexpr int kMaxSharedBytes = 48 * 1024;

// the launch plan, as tpugan_torch/ops/upfirdn.py::PLAN_FIELDS orders it
enum PlanField {
  kRh, kRw, kTileRows, kTileCols, kTilesY, kTilesX, kPlanesPerBlock, kInRows, kInStride,
  kPhase, kVec, kThreads, kBlocks, kSharedBytes, kElemBytes, kPlanFields
};

// elements of T in one 16-byte copy
template <typename T>
constexpr int kVecElems = kCopyBytes / static_cast<int>(sizeof(T));

struct Taps {
  float v[kMaxTaps * kMaxTaps];
};

struct Geometry {
  int64_t planes;
  int h, w, ho, wo, pad_y0, pad_x0, kh, kw;
  int tile_rows, tile_cols, tiles_y, tiles_x, planes_per_block, in_rows, in_stride;
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

// asynchronous global -> shared copies: the first `bytes` of the copy from
// src, zeros after them (no byte past them is read)
__device__ __forceinline__ void copy4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// elements of T that p lies past a 16-byte boundary
template <typename T>
__device__ __forceinline__ int lead_of(const T* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (kVecElems<T> - 1);
}

// A staged row of `chunks` copies is taken by a group of lanes, the
// smallest power of two that covers it (at most a warp), so narrow planes
// keep every lane busy without a division per copy.
struct RowLanes {
  int first, step, c0, group;
};
__device__ __forceinline__ RowLanes row_lanes(int chunks) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < chunks) ++lg;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 >> lg;
  return {static_cast<int>(threadIdx.x >> 5) * per_warp + (lane >> lg),
          static_cast<int>(blockDim.x >> 5) * per_warp, lane & ((1 << lg) - 1), 1 << lg};
}

// Stages `rows` = planes x in_rows input rows, in_stride elements each,
// from input row iy0 and column gx0 on, WIDTH elements a copy: 16 bytes
// (every row 16-byte aligned, gx0 a multiple of the copy) or one fp32.
template <typename T, int WIDTH>
__device__ __forceinline__ void stage_rows(T* tile, const T* __restrict__ x, const Geometry& g,
                                           int64_t plane0, int rows, int iy0, int gx0) {
  static_assert(WIDTH == kVecElems<T> || (WIDTH == 1 && sizeof(T) == 4),
                "16 bytes a copy, or one fp32 (cp.async has no 2-byte copy)");
  const int chunks = g.in_stride / WIDTH;
  const RowLanes l = row_lanes(chunks);
  for (int row = l.first; row < rows; row += l.step) {
    const int p = row / g.in_rows;
    const int iy = iy0 + row - p * g.in_rows;
    const bool row_ok = iy >= 0 && iy < g.h;
    const T* src = x + ((plane0 + p) * g.h + (row_ok ? iy : 0)) * static_cast<int64_t>(g.w);
    T* dst = tile + row * g.in_stride;
    for (int c = l.c0; c < chunks; c += l.group) {
      const int ix = gx0 + c * WIDTH;
      const bool ok = row_ok && ix >= 0 && ix < g.w;  // 16-byte copies: w % WIDTH == 0, all or nothing
      if constexpr (WIDTH > 1) {
        copy16(dst + c * WIDTH, ok ? src + ix : x, ok ? kCopyBytes : 0);
      } else {
        copy4(dst + c, ok ? src + ix : x, ok ? 4 : 0);
      }
    }
  }
  wait_copies();
}

// A block's planes for per-row windows: x from its first plane on, and how
// many elements past a 16-byte boundary that plane starts.
template <typename T>
struct Planes {
  const T* x;
  int lead;
};

// Stages the tile's input rows (planes x in_rows, in_stride elements each)
// as per-row windows: each row from the 16-byte boundary at or below its
// column ix0, in 16-byte cp.async copies. A chunk that runs past the row's
// end copies only the row's bytes (cp.async fills the rest with zeros); a
// chunk that starts before the row (its first chunk, where the row starts
// off a boundary) is loaded element by element; chunks wholly in the
// padding are zero stores. No copy reads outside the row it stages.
template <typename T>
__device__ __forceinline__ void stage_windows(T* buf, const Geometry& g, const Planes<T>& s,
                                              int planes, int iy0, int ix0) {
  constexpr int V = kVecElems<T>;
  const int chunks = g.in_stride / V;
  const RowLanes l = row_lanes(chunks);
  const int rows = planes * g.in_rows;
  for (int row = l.first; row < rows; row += l.step) {
    const int p = row / g.in_rows;
    const int iy = iy0 + row - p * g.in_rows;
    T* dst = buf + row * g.in_stride;
    if (iy < 0 || iy >= g.h) {
      for (int c = l.c0; c < chunks; c += l.group) zero16(dst + c * V);
      continue;
    }
    const int at = (p * g.h + iy) * g.w + ix0;           // column ix0 of the row, from s.x
    const int ax = ix0 - ((s.lead + at) & (V - 1));      // the window's first column
    for (int c = l.c0; c < chunks; c += l.group) {
      const int col = ax + c * V;
      const T* src = s.x + (at - ix0 + col);  // the chunk's first element
      if (col + V <= 0 || col >= g.w) {
        zero16(dst + c * V);
      } else if (col >= 0) {
        copy16(dst + c * V, src, (g.w - col < V ? g.w - col : V) * static_cast<int>(sizeof(T)));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          dst[c * V + j] = col + j >= 0 && col + j < g.w ? src[j] : from_float<T>(0.f);
        }
      }
    }
  }
  wait_copies();
}

// N consecutive staged elements from p, widened to fp32: fp32 one load
// each; bf16 from 6 on as the 32-bit words that hold them, realigned by a
// funnel shift where p is not 4-byte aligned, each half widened exactly
// (fewer, one load each: pairs measured slower for the ToRGB up-2's 3 and
// its adjoint's 4).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = p[j];
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N < 6) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = __bfloat162float(p[j]);
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const unsigned* w = reinterpret_cast<const unsigned*>(a & ~static_cast<uintptr_t>(3));
    const unsigned shift = (a & 2) ? 16u : 0u;
    constexpr int kWords = N / 2 + 1;
    unsigned word[kWords];
#pragma unroll
    for (int i = 0; i < kWords - 1; ++i) word[i] = w[i];
    // the last word holds a wanted element only where the row is odd-aligned
    // or N is odd (words never cross a staged row's 16-byte end)
    word[kWords - 1] = (N % 2 || shift) ? w[kWords - 1] : 0u;
#pragma unroll
    for (int i = 0; 2 * i < N; ++i) {
      const unsigned pair = __funnelshift_r(word[i], word[i + 1], shift);  // element 2i low, 2i+1 high
      v[2 * i] = __uint_as_float(pair << 16);
      if (2 * i + 1 < N) v[2 * i + 1] = __uint_as_float(pair & 0xffff0000u);
    }
  }
}

// Staged row r of a strip whose first row starts at s: with per-row
// windows it is read through its own lead, (l0 + r * wl) mod a copy;
// otherwise every row shares the lead already added to s.
template <bool PER_ROW, typename T>
__device__ __forceinline__ const T* staged_row(const T* s, int r, int stride, int l0, int wl) {
  return s + r * stride + (PER_ROW ? (l0 + r * wl) & (kVecElems<T> - 1) : 0);
}

// One strip with compile-time taps. Output (da, db) reads staged row (PH +
// da*DOWN + ty) / UP and column (PH + db*DOWN + tx) / UP, for the taps that
// land on real samples. Each staged row is read once into registers.
template <int KH, int KW, int UP, int DOWN, int PH, int RW, bool PER_ROW, typename T>
__device__ __forceinline__ void strip_fixed(const T* s, int stride, int l0, int wl, const Taps& t,
                                            float (&acc)[kStripRows][RW]) {
  constexpr int kRows = (PH + (kStripRows - 1) * DOWN + KH - 1) / UP + 1;
  constexpr int kCols = (PH + (RW - 1) * DOWN + KW - 1) / UP + 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v[kCols];
    load_row(staged_row<PER_ROW>(s, r, stride, l0, wl), v);
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
template <int UP, int DOWN, int PH, int RW, bool PER_ROW, typename T>
__device__ __forceinline__ void strip_any(const T* s, int stride, int l0, int wl, int kh, int kw,
                                          const Taps& t, float (&acc)[kStripRows][RW]) {
#pragma unroll
  for (int da = 0; da < kStripRows; ++da) {
    const int sy0 = PH + da * DOWN;
    for (int ty = (UP - sy0 % UP) % UP; ty < kh; ty += UP) {
      const T* row = staged_row<PER_ROW>(s, (sy0 + ty) / UP, stride, l0, wl);
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

// a strip row of RW outputs as one vector store: fp32 RW = 4 or 2 (16 or
// 8 bytes), bf16 RW = 8, 4 or 2 (16, 8 or 4 bytes)
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
__device__ __forceinline__ void store_wide(__nv_bfloat16* row, const float (&a)[8]) {
  *reinterpret_cast<uint4*>(row) = make_uint4(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]),
                                              bf16_pair(a[4], a[5]), bf16_pair(a[6], a[7]));
}
__device__ __forceinline__ void store_wide(__nv_bfloat16* row, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(row) = make_uint2(bf16_pair(a[0], a[1]), bf16_pair(a[2], a[3]));
}
__device__ __forceinline__ void store_wide(__nv_bfloat16* row, const float (&a)[2]) {
  *reinterpret_cast<unsigned*>(row) = bf16_pair(a[0], a[1]);
}

// word i + s of w, s in 0..3 (a select, not an indexed load from local memory)
__device__ __forceinline__ unsigned pick(const unsigned* w, int i, int s) {
  return s == 0 ? w[i] : s == 1 ? w[i + 1] : s == 2 ? w[i + 2] : w[i + 3];
}

// A lane's 16-byte strip rows into output rows that are not 16-byte
// aligned: each lane stores the aligned 16-byte chunk across its row's
// tail and its right neighbour's head (taken by a warp shuffle), its head
// where no left neighbour covers it and its tail where no right neighbour
// does, element by element. `y` is the block's first output plane, `key`
// the strip's index in the tile (-1 for an idle lane); neighbours are the
// lanes of the next and previous strips of one strip row. Every lane of
// the warp calls it.
template <typename T>
__device__ __forceinline__ void shuffle_store(const float (&acc)[kStripRows][kVecElems<T>], T* y,
                                              const Geometry& g, int key, int p, int oy, int ox,
                                              int sc, int strip_cols) {
  constexpr int V = kVecElems<T>;
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const int y_lead = lead_of(y);
  const int up_key = __shfl_up_sync(kAll, key, 1);
  const int down_key = __shfl_down_sync(kAll, key, 1);
  const bool left = key >= 0 && lane > 0 && sc > 0 && up_key == key - 1;
  const bool right = key >= 0 && lane < 31 && sc + 1 < strip_cols && down_key == key + 1;
#pragma unroll
  for (int da = 0; da < kStripRows; ++da) {
    unsigned w[8];  // this strip row's 16 bytes, then the right neighbour's
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(acc[da][i]);
      } else {
        w[i] = bf16_pair(acc[da][2 * i], acc[da][2 * i + 1]);
      }
      w[4 + i] = __shfl_down_sync(kAll, w[i], 1);
    }
    if (key < 0 || oy + da >= g.ho) continue;
    const int at = (p * g.ho + oy + da) * g.wo + ox;
    T* dst = y + at;
    const int limit = g.wo - ox;                                   // outputs of this strip row inside the row
    const int split = (V - ((y_lead + at) & (V - 1))) & (V - 1);  // its outputs before a 16-byte boundary
    if (split == 0 && limit >= V) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      continue;
    }
    if (!(left && limit >= split)) {  // the head, where no left neighbour's chunk holds it
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j < split && j < limit) dst[j] = from_float<T>(acc[da][j]);
      }
    }
    if (split > 0 && right && limit >= V + split) {  // the chunk across the tail and the neighbour's head
      unsigned c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (sizeof(T) == 4) {
          c[i] = pick(w, i, split);
        } else {
          c[i] = __funnelshift_r(pick(w, i, split >> 1), pick(w, i + 1, split >> 1), (split & 1) ? 16u : 0u);
        }
      }
      *reinterpret_cast<uint4*>(dst + split) = make_uint4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j >= split && j < limit) dst[j] = from_float<T>(acc[da][j]);
      }
    }
  }
}

// KH = KW = 0: runtime taps (g.kh, g.kw). VEC: every staged row is
// 16-byte aligned (the plan's `vec`); otherwise fp32 rows take 4-byte
// copies and bf16 rows per-row windows.
template <typename T, int KH, int KW, int UP, int DOWN, int PH, int RW, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g, Taps taps) {
  static_assert(kStripRows * DOWN % UP == 0 && RW * DOWN % UP == 0,
                "a strip must start on an even stuffed row and column");
  constexpr int V = kVecElems<T>;
  constexpr bool kWindows = !VEC && sizeof(T) == 2;
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
  // the first input row and column the tile reads: oy0*DOWN - pad - PH is
  // a multiple of UP (PH = -pad mod UP on both axes, oy0*DOWN even when UP = 2)
  const int iy0 = (oy0 * DOWN - g.pad_y0 - PH) / UP;
  const int ix0 = (ox0 * DOWN - g.pad_x0 - PH) / UP;

  Planes<T> s{};  // per-row windows only
  int lead = 0;   // the lead every staged row shares otherwise
  if constexpr (kWindows) {
    s.x = x + plane0 * g.h * g.w;
    s.lead = lead_of(s.x);
    stage_windows(tile, g, s, planes, iy0, ix0);
  } else {
    const int gx0 = VEC ? (ix0 & ~(V - 1)) : ix0;  // rounded down to a 16-byte boundary
    stage_rows<T, VEC ? V : 1>(tile, x, g, plane0, planes * g.in_rows, iy0, gx0);
    lead = ix0 - gx0;
  }
  __syncthreads();

  const int strip_cols = g.tile_cols / RW;
  const int per_plane = strip_cols * (g.tile_rows / kStripRows);
  const int tid = threadIdx.x;
  const bool active = tid < planes * per_plane;
  // 16-byte strips into rows off 16-byte boundaries: stored through warp
  // shuffles, which every lane of the warp joins
  const bool shuffled = RW == V && !g.wide_store;
  if (!active && !shuffled) return;
  const int k = active ? tid : 0;
  const int p = k / per_plane;
  const int rest = k - p * per_plane;
  const int sr = rest / strip_cols;
  const int sc = rest - sr * strip_cols;

  float acc[kStripRows][RW];
#pragma unroll
  for (int da = 0; da < kStripRows; ++da) {
#pragma unroll
    for (int db = 0; db < RW; ++db) acc[da][db] = 0.f;
  }
  if (active) {
    const int r0 = sr * (kStripRows * DOWN / UP);  // the strip's first staged row
    const T* sp = tile + (p * g.in_rows + r0) * g.in_stride + lead + sc * (RW * DOWN / UP);
    const int l0 = kWindows ? (s.lead + (p * g.h + iy0 + r0) * g.w + ix0) & (V - 1) : 0;
    const int wl = g.w & (V - 1);
    if constexpr (KH > 0) {
      strip_fixed<KH, KW, UP, DOWN, PH, RW, kWindows>(sp, g.in_stride, l0, wl, taps, acc);
    } else {
      strip_any<UP, DOWN, PH, RW, kWindows>(sp, g.in_stride, l0, wl, g.kh, g.kw, taps, acc);
    }
  }

  const int oy = oy0 + sr * kStripRows;
  const int ox = ox0 + sc * RW;
  if constexpr (RW == V) {
    if (shuffled) {
      shuffle_store<T>(acc, y + plane0 * g.ho * g.wo, g, active ? tid : -1, p, oy, ox, sc, strip_cols);
      return;
    }
  }
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

template <typename T, int KH, int KW, int UP, int DOWN, int PH, int RW, bool VEC>
cudaError_t launch(const T* x, T* y, const Geometry& g, const Taps& t, const int* plan,
                   cudaStream_t stream) {
  upfirdn2d_kernel<T, KH, KW, UP, DOWN, PH, RW, VEC>
      <<<static_cast<unsigned>(plan[kBlocks]), plan[kThreads], plan[kSharedBytes], stream>>>(x, y, g, t);
  return cudaGetLastError();
}

// the compile-time tap cases of this (up, down), else runtime taps
template <typename T, int UP, int DOWN, int PH, int RW, bool VEC>
cudaError_t launch_taps(const T* x, T* y, const Geometry& g, const Taps& t, const int* plan,
                        cudaStream_t stream) {
  if constexpr (UP == 1 && DOWN == 1) {
    if (g.kh == 3 && g.kw == 3) return launch<T, 3, 3, UP, DOWN, PH, RW, VEC>(x, y, g, t, plan, stream);
  }
  if constexpr (UP * DOWN <= 2) {
    if (g.kh == 4 && g.kw == 4) return launch<T, 4, 4, UP, DOWN, PH, RW, VEC>(x, y, g, t, plan, stream);
  }
  return launch<T, 0, 0, UP, DOWN, PH, RW, VEC>(x, y, g, t, plan, stream);
}

// strip columns of each (up, down) but a same-size FIR's wide strips: a
// whole number of stuffed-sample pairs for up 2 (so each column's phase is
// fixed), one column otherwise
constexpr int strip_width(int up, int down) { return up == 2 && down == 1 ? 2 : 1; }

template <typename T, bool VEC>
cudaError_t launch_plan(const T* x, T* y, int up, int down, const Geometry& g, const Taps& t,
                        const int* plan, cudaStream_t s) {
  constexpr int V = kVecElems<T>;
  if (up == 1 && down == 1) {
    if (plan[kRw] == V) return launch_taps<T, 1, 1, 0, V, VEC>(x, y, g, t, plan, s);
    if (plan[kRw] == 4) return launch_taps<T, 1, 1, 0, 4, VEC>(x, y, g, t, plan, s);  // bf16's 8-byte strips
    return launch_taps<T, 1, 1, 0, strip_width(1, 1), VEC>(x, y, g, t, plan, s);
  }
  if (up == 2 && down == 1) {
    return plan[kPhase] ? launch_taps<T, 2, 1, 1, strip_width(2, 1), VEC>(x, y, g, t, plan, s)
                        : launch_taps<T, 2, 1, 0, strip_width(2, 1), VEC>(x, y, g, t, plan, s);
  }
  if (up == 1 && down == 2) return launch_taps<T, 1, 2, 0, strip_width(1, 2), VEC>(x, y, g, t, plan, s);
  return plan[kPhase] ? launch_taps<T, 2, 2, 1, strip_width(2, 2), VEC>(x, y, g, t, plan, s)
                      : launch_taps<T, 2, 2, 0, strip_width(2, 2), VEC>(x, y, g, t, plan, s);
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Every property of the plan that the kernel relies on; false refuses it.
template <typename T>
bool plan_is_valid(const int* p, int64_t planes, int h, int w, int ho, int wo, int up, int down,
                   int pad_y0, int pad_x0, int kh, int kw, const T* x) {
  constexpr int V = kVecElems<T>;
  if (p[kElemBytes] != static_cast<int>(sizeof(T))) return false;
  if (p[kRh] != kStripRows ||
      (p[kRw] != strip_width(up, down) && !(up == 1 && down == 1 && (p[kRw] == 4 || p[kRw] == V)))) {
    return false;
  }
  if (p[kTileRows] < kStripRows || p[kTileRows] % kStripRows != 0 || p[kTileCols] < p[kRw] ||
      p[kTileCols] % p[kRw] != 0 || p[kPlanesPerBlock] < 1 || p[kTilesY] < 1 || p[kTilesX] < 1) {
    return false;
  }
  // a block's planes are addressed in 32 bits by the windows and the shuffled stores
  if ((static_cast<int64_t>(p[kPlanesPerBlock]) + 1) * h * w > 0x7fff0000LL ||
      static_cast<int64_t>(p[kPlanesPerBlock]) * ho * wo > 0x7fffffffLL) {
    return false;
  }
  if (static_cast<int64_t>(p[kTilesY]) * p[kTileRows] < ho ||
      static_cast<int64_t>(p[kTilesX]) * p[kTileCols] < wo) {
    return false;
  }
  if (p[kPhase] != (up - pad_y0 % up) % up || p[kPhase] != (up - pad_x0 % up) % up) return false;
  const int64_t rows = (p[kPhase] + static_cast<int64_t>(p[kTileRows] - 1) * down + kh - 1) / up + 1;
  const int64_t cols = (p[kPhase] + static_cast<int64_t>(p[kTileCols] - 1) * down + kw - 1) / up + 1;
  if (p[kInRows] < rows) return false;
  if (p[kVec] != 0 && p[kVec] != 1) return false;
  if (p[kVec] && (w % V != 0 || reinterpret_cast<uintptr_t>(x) % kCopyBytes != 0)) return false;
  if (p[kVec] || sizeof(T) == 2) {  // 16-byte copies: up to a copy before the tile's first column
    if (p[kInStride] % V != 0 || p[kInStride] < cols + V - 1) return false;
  } else if (p[kInStride] < cols) {
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
int run(const T* x, T* y, int64_t planes, int h, int w, int ho, int wo, int up, int down,
        int pad_y0, int pad_x0, int kh, int kw, const float* taps, const int* plan, int device,
        void* stream) {
  if (planes < 0 || h < 1 || w < 1 || ho < 1 || wo < 1 || pad_y0 < 0 || pad_x0 < 0 || kh < 1 ||
      kh > kMaxTaps || kw < 1 || kw > kMaxTaps || (up != 1 && up != 2) ||
      (down != 1 && down != 2) || static_cast<int64_t>(h) * w > 0x7fffffffLL ||
      static_cast<int64_t>(ho) * wo > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % sizeof(T) != 0 ||
      reinterpret_cast<uintptr_t>(y) % sizeof(T) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (planes == 0) return 0;
  if (!plan_is_valid<T>(plan, planes, h, w, ho, wo, up, down, pad_y0, pad_x0, kh, kw, x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Taps t{};
  for (int i = 0; i < kh * kw; ++i) t.v[i] = taps[i];
  const int rw = plan[kRw];
  Geometry g{planes, h, w, ho, wo, pad_y0, pad_x0, kh, kw, plan[kTileRows], plan[kTileCols],
             plan[kTilesY], plan[kTilesX], plan[kPlanesPerBlock], plan[kInRows], plan[kInStride],
             rw > 1 && wo % rw == 0 && reinterpret_cast<uintptr_t>(y) % (sizeof(T) * rw) == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = plan[kVec] ? launch_plan<T, true>(x, y, up, down, g, t, plan, s)
                                     : launch_plan<T, false>(x, y, up, down, g, t, plan, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points, bound with ctypes, one per element type: x and y
// fp32, or bf16 (the taps and the sums fp32 in both), each aligned to its
// element. `pad_y0` and `pad_x0` are the front pads of H and W (>= 0, of
// one parity at up 2); ho and wo give the back pads. `taps` is a host
// array of kh*kw floats (row-major, gain folded in); `plan` is a host
// array of kPlanFields ints from tpugan_torch/ops/upfirdn.py::fir_plan,
// made for this element size. Both are copied into the launch, so the
// caller may free them on return. `device` is the ordinal that holds x, y
// and `stream` (this library has its own runtime state, so it sets the
// device itself). Launches on `stream` and does not synchronise. Returns
// 0, or the cudaError_t of a refused launch (cudaErrorInvalidValue for
// arguments or a plan outside the kernel's contract).
extern "C" int tpugan_upfirdn2d_f32(const float* x, float* y, int64_t planes, int h, int w,
                                    int ho, int wo, int up, int down, int pad_y0, int pad_x0,
                                    int kh, int kw, const float* taps, const int* plan,
                                    int device, void* stream) {
  return run(x, y, planes, h, w, ho, wo, up, down, pad_y0, pad_x0, kh, kw, taps, plan, device,
             stream);
}

extern "C" int tpugan_upfirdn2d_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int64_t planes,
                                     int h, int w, int ho, int wo, int up, int down, int pad_y0,
                                     int pad_x0, int kh, int kw, const float* taps,
                                     const int* plan, int device, void* stream) {
  return run(x, y, planes, h, w, ho, wo, up, down, pad_y0, pad_x0, kh, kw, taps, plan, device,
             stream);
}
