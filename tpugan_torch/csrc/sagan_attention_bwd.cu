// SAGAN attention backward (the FlashAttention-2 backward): dq, dk and dv of
// o = softmax(q k^T) v, from q, k, v, the forward's per-row logsumexp lse and
// delta = rowsum(do * o), with p = exp(q k^T - lse) recomputed tile by tile.
// No 1/sqrt(d) scaling, as in the forward.
//
// Replaces the Pallas TPU kernel tpugan/ops/pallas/attention.py::
// sagan_attention_bwd_pallas: its _dq_kernel (pallas_call :149) is
// attention_dq_kernel, its _dkv_kernel (pallas_call :168) is
// attention_dkv_kernel; attention_pack_kernel lays their operands out for
// the tensor cores first. The caller computes delta, as tpugan does.
//
// Shapes: q [N, Lq, dk], k [N, Lk, dk], v [N, Lk, dv], do [N, Lq, dv],
// lse and delta [N, Lq] (the caller views lse as [N, Lq, 1]); dq, dk, dv
// shaped like q, k, v. All contiguous, any Lq, Lk >= 1, dk <= 128,
// dv <= 256. At BigGAN-256's attention layer N = 2, Lq = 4096, Lk = 1024,
// dk = 64, dv = 256. q, k, v, do, dq, dk and dv are fp32 (the _f32 entry
// points) or bf16 (_bf16), as the Pallas kernels take any float type and
// return the gradients in the inputs' types (:163, :184-185); lse, delta,
// the packed operands and the p/ds scratch are fp32 in both.
//
// bf16: each kernel is templated on the element type T. The pack kernel
// and the dq kernel widen what they read from q, k, v and do to fp32; dq,
// dk and dv are rounded once to bf16 (to nearest even) where they are
// stored. A bf16 value is exact in TF32, so its split is hi = x, lo = 0:
// the packed planes, and so every product, are the fp32 kernels' on the
// widened inputs, and the bf16 form's outputs are theirs rounded, bit for
// bit. The workspace is the fp32 form's. Its bound at the path shape: s
// and dp in one dense bf16 pass (bf16 operands, 989.4 TFLOP/s on an H100
// SXM), dv, dq and dk with the fp32 p and ds split into three bf16 pieces,
// 5.37 + 3 x 6.44 GFLOP of bf16 products, 25.0 us. This form keeps all
// three TF32 passes.
//
// Bound: operations. The backward needs s = q k^T, dp = do v^T,
// dv = p^T do, dq = ds k and dk = ds^T q: 2 Lq Lk (3 dk + 2 dv) FLOPs per
// batch item, 11.81 GFLOP at the BigGAN-256 shape against 26 MB of inputs
// and outputs. The products run on the tensor cores in 3xTF32, three TF32
// products for each fp32-accurate one, so the least time is 3 x 11.81 GFLOP
// at the card's dense TF32 rate: 71.6 us on an H100 SXM (495 TFLOP/s).
// Each product is computed once: the dq kernel computes s, dp, p, ds and
// dq, and hands p and ds to the dkv kernel through a scratch buffer in
// device memory (8 bytes per query-key pair, 67 MB at the BigGAN-256 shape,
// past the 50 MB L2), which adds 134 MB of traffic (40 us at 3.35 TB/s)
// instead of the 16 GFLOP of 3xTF32 products that computing s and dp a
// second time would cost (33 us at the dense rate, more at the rate these
// kernels reach).
//
// Precision: 3xTF32. Every operand x is split into hi, x rounded to TF32 to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding), and
// lo = x - hi, exact in fp32; a b is formed as lo_a hi_b + hi_a lo_b +
// hi_a hi_b with fp32 accumulation. The tensor cores read lo's top 10
// mantissa bits (rounding toward zero) and the dropped lo_a lo_b is about
// 2^-22 of the product. One TF32 product keeps about three digits, which
// does not hold the 2e-4 contract at the path's magnitudes (dk reaches 77).
// exp (__expf: ex2.approx, within a few ulp), the delta subtraction and the
// masks stay in fp32. The tensor cores align and truncate when they add
// into an accumulator, so no accumulator of full-size values takes a long
// chain: the hi hi products run in chains
// that start from a zeroed accumulator (the wgmma's scale-d 0) and cover
// kChainK = 32 of the contraction (4 wgmma), each added to a running sum
// with fp32 adds that round to nearest (add()). The two corrections, about
// 2^-11 of the product, go to an accumulator of their own that lasts the
// whole contraction: what truncation loses there is 2^-11 smaller. (All
// three products in one chain of 32 came out further from the float64
// result at the path shape than chains of 16 in a trial on the card.)
//
// Instructions: all five products are wgmma.mma_async m64nNk8 TF32 with
// fp32 accumulators, one warpgroup (4 warps, 128 threads) per block.
//  * TF32 wgmma reads shared-memory operands K-major only (no transpose for
//    32-bit types). q, do (A of s and dp) and k, v (B of s and dp) lie
//    K-major as they are; the B operands of dq = ds k (k), dv = p^T do (do)
//    and dk = ds^T q (q) lie N-major, so the pack kernel writes K-major
//    copies k^T, do^T and q^T once per call (0.5, 8.4 and 2.1 MB at the
//    path shape, hi and lo planes each).
//  * 3xTF32 with operands in shared memory: each is split into a hi and a
//    lo plane as it is laid out (k, v and the transposed copies by the pack
//    kernel, q and do by the dq kernel as it stages them), so each product
//    reads (A lo, B hi), (A hi, B lo), (A hi, B hi): twice the staged bytes
//    of one fp32 plane. A operands that come from registers (q at dk <= 64
//    and ds in the dq kernel, p^T and ds^T in the dkv kernel) are split
//    there.
//  * Layout: every shared-memory operand is a panel of MN rows x K columns
//    stored as core matrices of 8 rows x 4 fp32 (128 contiguous bytes),
//    column group (4 columns) major, then row group: the element (r, c) of
//    a panel of R rows at ((c / 4) (R / 8) + r / 8) 32 + (r % 8) 4 + c % 4.
//    No swizzle (layout type 0): the descriptor's leading byte offset is
//    16 R bytes (between the two column groups of a k8 step), its stride
//    byte offset 128 bytes (between row groups), and step i starts 32 R i
//    bytes in. The pack kernel writes each panel contiguously in device
//    memory as it lies in shared memory, so staging is a flat 16-byte copy.
//  * Fragments: the accumulator of a m64nN product holds, in warp w of the
//    warpgroup, rows 16 w + g and 16 w + g + 8 and, for each 8-column tile
//    j, columns 8 j + 2t and 8 j + 2t + 1 (g = lane / 4, t = lane % 4); an
//    A operand from registers holds rows 16 w + g, + 8 and columns t, t + 4
//    of each k8 step. Where ds feeds dq = ds k from registers, the
//    contraction index is permuted: A's k = t is accumulator column 2t,
//    k = t + 4 is column 2t + 1, and the pack kernel stores the columns of
//    each 8-key group of k^T in the order 0, 2, 4, 6, 1, 3, 5, 7 to match.
//    The dkv kernel loads p^T and ds^T from the scratch's [query][key]
//    rows in shared memory (rows padded to 72 floats: conflict-free).
//
// Design (no atomics, so the result does not depend on the order in which
// blocks run):
//  * pack: one launch lays out k, v (B of s, dp), k^T (B of dq), do^T and
//    q^T (B of dv and dk), hi and lo, zero-padded to whole panels, into a
//    workspace the wrapper allocates; its size comes from
//    tpugan_sagan_attention_bwd_workspace_floats. A transposed panel is
//    staged in shared memory so that reads and writes are both coalesced.
//  * dq: one block per (batch item, 64 query rows). It reads its rows of q
//    and do and splits them: do stays in shared memory (hi, lo), and q too
//    past dk 64; at dk <= 64 q is held in registers as A fragments (64 of
//    them), which leaves room for tiles of 32 keys at dv 256. Tiles of BK
//    keys of k, v and k^T are copied with cp.async, the next tile's k and v
//    as soon as this tile's s and dp have read theirs, its k^T after this
//    tile's dq product; a tile waits for its k^T only before its dq
//    product. s and dp run as chains of 32 columns, each summed while the
//    next chain and the corrections run; p and ds in registers; ds k into
//    dq; p and ds to the scratch as [query][key] tiles of kDkvRows x
//    kDkvKeys (a thread's two keys in one 8-byte store), rows past Lq as
//    zeros, stored while the tensor cores run the tile's dq product. BK is
//    the largest of 32, 16, 8 whose tiles fit beside do (and q): 32 at the
//    path's widths, in 224 KB of shared memory.
//  * dkv: one cluster of kCluster blocks per (batch item, 64 keys, 64
//    output columns of dv or of dk); block r streams the query tiles r,
//    r + kCluster, ... of 32 rows (p or ds from the scratch, and do^T or
//    q^T) through three cp.async stages, and adds p^T do or ds^T q into its
//    64 x 64 partial sum, one chain of hi hi products a tile. The partial
//    sums meet in distributed shared memory and each block adds up 16 of
//    the rows over the cluster in rank order.
//  Keys past Lk and rows past Lq are zero in the packed operands, masked
//  out of p (branch-free), and not written.
//  What holds it back: one warpgroup per block, so the exp, the scratch
//  stores and the waits between chains leave the tensor cores idle; in the
//  dq kernel do is the A operand of dp from shared memory, read again for
//  every tile of 32 keys (N = 32 wgmma); the scratch's round trip.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kDqRows = 64;    // dq: query rows per block (the wgmma's M)
constexpr int kDkvKeys = 64;   // dkv: keys per block; keys of a scratch tile
constexpr int kDkvRows = 32;   // dkv: query rows per streamed tile; rows of a scratch tile
constexpr int kSlice = 64;     // dkv: output columns per block
constexpr int kCluster = 4;    // dkv blocks that share one key tile and slice
constexpr int kStages = 3;     // dkv: cp.async stages
constexpr int kChainK = 32;    // contraction length of one chain of hi hi products
constexpr int kLdp = kDkvKeys + 8;  // dkv's rows (query rows) of p or ds in shared memory
constexpr int kPlane = kDkvKeys * kDkvRows;  // floats of one p^T or ds^T tile of the scratch
constexpr int kMaxDk = 128;
constexpr int kMaxDv = 256;
constexpr int kMaxSharedBytes = 227 * 1024;
constexpr int kPackJobs = 5;

// the dq kernel keeps q in registers (as A fragments of s = q k^T) at
// widths up to 64, in shared memory past that; do always in shared memory
__host__ __device__ constexpr bool q_in_registers(int ck) { return ck <= 64; }
// shared floats of the dq kernel for padded widths ck, cv and key tiles of bk
__host__ __device__ constexpr int dq_floats(int ck, int cv, int bk) {
  return 2 * (kDqRows * ((q_in_registers(ck) ? 0 : ck) + cv) + bk * (2 * ck + cv));
}
// the dq kernel's key tile: the largest of 32, 16, 8 that fits
__host__ __device__ constexpr int dq_keys(int ck, int cv) {
  return 4 * dq_floats(ck, cv, 32) <= kMaxSharedBytes   ? 32
         : 4 * dq_floats(ck, cv, 16) <= kMaxSharedBytes ? 16
                                                         : 8;
}
static_assert(4 * dq_floats(kMaxDk, kMaxDv, dq_keys(kMaxDk, kMaxDv)) <= kMaxSharedBytes, "dq smem");
// one dkv stage: p or ds [kDkvRows][kLdp], then B hi and lo [kSlice x kDkvRows]
constexpr int kDkvStage = kDkvRows * kLdp + 2 * kSlice * kDkvRows;
constexpr int kDkvBytes = 4 * kStages * kDkvStage;
static_assert(kDkvBytes <= kMaxSharedBytes && kDkvKeys * kSlice <= kStages * kDkvStage, "dkv smem");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad_width(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// The workspace: packed operands (hi, lo) and the p/ds scratch, each segment
// a whole number of panels; offsets in floats from the base.
struct Workspace {
  int n, lq, lk, dk, dv;
  int ck, cv, bk;   // padded widths of q/k and v/do, the dq kernel's key tile
  int lqp, lkp;     // Lq and Lk padded to 64
  int sk, sv;       // dkv slices of dk and of dv
  float* bk_[2];    // k: [bk keys x ck], one per bk keys
  float* bv[2];     // v: [bk x cv]
  float* bkt[2];    // k^T: [ck x bk keys], keys of each 8 in order 0, 2, 4, 6, 1, 3, 5, 7
  float* bdot[2];   // do^T: [64 columns x 32 query rows], slice-major
  float* bqt[2];    // q^T: the same
  float* pds;       // p, ds: [kDkvRows][kDkvKeys] tiles, key-tile-major
  int64_t floats;   // size of the whole
};

Workspace make_workspace(float* base, int n, int lq, int lk, int dk, int dv) {
  Workspace w{};
  w.n = n, w.lq = lq, w.lk = lk, w.dk = dk, w.dv = dv;
  w.ck = pad_width(dk), w.cv = pad_width(dv), w.bk = dq_keys(w.ck, w.cv);
  w.lqp = cdiv(lq, 64) * 64, w.lkp = cdiv(lk, 64) * 64;
  w.sk = cdiv(dk, kSlice), w.sv = cdiv(dv, kSlice);
  int64_t at = 0;
  const auto take = [&](float* (&seg)[2], int64_t per_item) {
    for (int h = 0; h < 2; ++h) {
      seg[h] = base ? base + at : nullptr;
      at += per_item * n;
    }
  };
  take(w.bk_, static_cast<int64_t>(w.lkp) * w.ck);
  take(w.bv, static_cast<int64_t>(w.lkp) * w.cv);
  take(w.bkt, static_cast<int64_t>(w.lkp) * w.ck);
  take(w.bdot, static_cast<int64_t>(w.sv) * kSlice * w.lqp);
  take(w.bqt, static_cast<int64_t>(w.sk) * kSlice * w.lqp);
  w.pds = base ? base + at : nullptr;
  at += 2 * static_cast<int64_t>(w.lkp) * w.lqp * n;
  w.floats = at;
  return w;
}

// asynchronous global -> shared copies
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// `floats` contiguous floats (a multiple of 4, both ends 16-byte aligned)
__device__ __forceinline__ void copy_flat(float* dst, const float* src, int floats, int t) {
  for (int i = 4 * t; i < floats; i += 4 * kThreads) copy16(dst + i, src + i);
}
// acc += d with fp32 adds that round to nearest. The tensor cores align and
// truncate when they add into an accumulator, so a long chain into one
// accumulator drifts past the 2e-4 contract at the path's widths: each
// chain starts from zero and is short, and the running sums are kept
// outside the tensor cores.
template <int R>
__device__ __forceinline__ void add(float (&acc)[R], const float (&d)[R]) {
#pragma unroll
  for (int e = 0; e < R; ++e) acc[e] += d[e];
}

// A 3xTF32 product a b = lo_a hi_b + hi_a lo_b + hi_a hi_b is issued as two
// accumulations: the hi hi products of one chain of k8 steps into d, the
// first of them zeroing it (scale-d 0), and the two corrections, about 2^-11
// of it, into c, which the caller keeps across chains (zeroed when
// `fresh`): an accumulator of small values loses little when the tensor
// cores truncate into it. a is a panel of 64 rows (ss) or register
// fragments (rs), b a panel of N rows; both hi and lo.

// the hi hi products over kChainK columns from k8 step `first`, from
// shared memory
template <int N>
__device__ __forceinline__ void hh_ss(float (&d)[N / 2], const float* a_hi, const float* b_hi,
                                      int first) {
#pragma unroll
  for (int s = 0; s < kChainK / 8; ++s) {
    wgmma_ss(d, desc(a_hi, kDqRows, first + s), desc(b_hi, N, first + s), s > 0);
  }
}
template <int N>
__device__ __forceinline__ void corr_ss(float (&c)[N / 2], const float* a_hi, const float* a_lo,
                                        const float* b_hi, const float* b_lo, int first,
                                        bool fresh) {
#pragma unroll
  for (int s = 0; s < kChainK / 8; ++s) {
    wgmma_ss(c, desc(a_lo, kDqRows, first + s), desc(b_hi, N, first + s), !(fresh && s == 0));
    wgmma_ss(c, desc(a_hi, kDqRows, first + s), desc(b_lo, N, first + s), 1);
  }
}

// the same with a from registers: COUNT k8 steps from `first` of its STEPS
template <int N, int STEPS, int COUNT>
__device__ __forceinline__ void hh_rs(float (&d)[N / 2], const uint32_t (&a_hi)[STEPS][4],
                                      int first, const float* b_hi) {
#pragma unroll
  for (int s = 0; s < COUNT; ++s) wgmma_rs(d, a_hi[first + s], desc(b_hi, N, first + s), s > 0);
}
template <int N, int STEPS, int COUNT>
__device__ __forceinline__ void corr_rs(float (&c)[N / 2], const uint32_t (&a_hi)[STEPS][4],
                                        const uint32_t (&a_lo)[STEPS][4], int first,
                                        const float* b_hi, const float* b_lo, bool fresh) {
#pragma unroll
  for (int s = 0; s < COUNT; ++s) {
    wgmma_rs(c, a_lo[first + s], desc(b_hi, N, first + s), !(fresh && s == 0));
    wgmma_rs(c, a_hi[first + s], desc(b_lo, N, first + s), 1);
  }
}

// ---- pack -------------------------------------------------------------------

// one operand to lay out: element (r, c) of a batch item's matrix at
// src[r s_r + c s_c] (zero past rows x cols), as panels of pr x pc, panel
// (i, j) at ((item tiles_r + i) tiles_c + j) pr pc; permute: columns of
// each 8 in order 0, 2, 4, 6, 1, 3, 5, 7
struct PackJob {
  const void* src;  // of the kernel's element type
  float* hi;
  float* lo;
  int64_t item;  // elements between batch items of src
  int s_r, s_c, rows, cols;
  int pr, pc, tiles_r, tiles_c, permute;
};
struct PackJobs {
  PackJob job[kPackJobs];
  int n;
};

constexpr int kPackThreads = 256;
constexpr int kPackTile = 128 * 33;  // a transposed panel's staging: at most 128 x 32, padded

// Lays out every job of `jobs` (blockIdx.y), splitting each value into hi
// and lo and writing both planes 16 bytes at a time. An operand whose rows
// run along the panel's columns (k, v, q and do as they lie) is written
// four values a thread, grid-stride over the job; a transposed one (k^T,
// do^T, q^T) a panel at a time, staged in shared memory so that both the
// reads and the writes are coalesced.
template <typename T>
__global__ void __launch_bounds__(kPackThreads) attention_pack_kernel(PackJobs jobs) {
  __shared__ float stage[kPackTile];
  const PackJob& j = jobs.job[blockIdx.y];
  const T* src = static_cast<const T*>(j.src);
  const int panel = j.pr * j.pc, per_item = j.tiles_r * j.tiles_c;
  const int64_t units = static_cast<int64_t>(per_item) * jobs.n;
  const int t = threadIdx.x;
  // the panel's element (i, c), panel `unit`: column c of the panel is
  // source column c0 + c, or c0 + (c's position in 0, 2, 4, 6, 1, 3, 5, 7)
  // when permuted
  const auto at = [&](int64_t unit, int i, int c) {
    const int b = static_cast<int>(unit / per_item), tile = static_cast<int>(unit % per_item);
    if (j.permute) c = (c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1);
    const int r = (tile / j.tiles_c) * j.pr + i, col = (tile % j.tiles_c) * j.pc + c;
    return r < j.rows && col < j.cols
               ? to_float(src[b * j.item + static_cast<int64_t>(r) * j.s_r + static_cast<int64_t>(col) * j.s_c])
               : 0.f;
  };
  // four values of the panel at offset o (a multiple of 4) to both planes
  const auto put = [&](int64_t unit, int o, const float* from_stage) {
    const int core = o >> 5;  // (column group) (pr / 8) + row group
    const int cgroup = core / (j.pr >> 3), rgroup = core - cgroup * (j.pr >> 3);
    const int i = rgroup * 8 + ((o >> 2) & 7);
    float4 h4, l4;
    float* h = &h4.x;
    float* l = &l4.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cgroup * 4 + e;
      const float x = from_stage ? from_stage[i * (j.pc + 1) + c] : at(unit, i, c);
      uint32_t xh, xl;
      split(x, xh, xl);
      h[e] = __uint_as_float(xh);
      l[e] = __uint_as_float(xl);
    }
    *reinterpret_cast<float4*>(j.hi + unit * panel + o) = h4;
    *reinterpret_cast<float4*>(j.lo + unit * panel + o) = l4;
  };
  if (j.s_c == 1) {
    const int64_t quads = units * panel / 4;
    for (int64_t x = blockIdx.x * static_cast<int64_t>(kPackThreads) + t; x < quads;
         x += static_cast<int64_t>(gridDim.x) * kPackThreads) {
      put(4 * x / panel, static_cast<int>(4 * x % panel), nullptr);
    }
    return;
  }
  for (int64_t unit = blockIdx.x; unit < units; unit += gridDim.x) {
    __syncthreads();  // the previous panel's reads of the stage are done
    for (int x = t; x < panel; x += kPackThreads) {  // rows along the source's contiguous axis
      const int i = x % j.pr, c = x / j.pr;
      stage[i * (j.pc + 1) + c] = at(unit, i, c);
    }
    __syncthreads();
    for (int o = 4 * t; o < panel; o += 4 * kPackThreads) put(unit, o, stage);
  }
}

// ---- dq ----------------------------------------------------------------------

// rows [r0, r0 + 64) of a row-major [len, d] matrix as a panel of 64 rows
// and CW columns in shared memory, widened to fp32 and split into hi and lo
// (zeros past row len and column d)
template <int CW, typename T>
__device__ __forceinline__ void stage_split(float* hi, float* lo, const T* src, int r0, int len,
                                            int d, int t) {
  for (int o = 4 * t; o < kDqRows * CW; o += 4 * kThreads) {
    const int core = o >> 5;  // (column group) 8 + row group
    const int r = r0 + (core & 7) * 8 + ((o >> 2) & 7), c0 = (core >> 3) * 4;
    float4 h4, l4;
    float* h = &h4.x;
    float* l = &l4.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = r < len && c0 + e < d ? to_float(src[static_cast<int64_t>(r) * d + c0 + e]) : 0.f;
      uint32_t xh, xl;
      split(x, xh, xl);
      h[e] = __uint_as_float(xh);
      l[e] = __uint_as_float(xl);
    }
    *reinterpret_cast<float4*>(hi + o) = h4;
    *reinterpret_cast<float4*>(lo + o) = l4;
  }
}

template <typename T, int CK, int CV>
__global__ void __launch_bounds__(kThreads, 1)
attention_dq_kernel(Workspace ws, const T* __restrict__ q, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq) {
  constexpr bool QR = q_in_registers(CK);
  constexpr int BK = dq_keys(CK, CV);
  constexpr int NS = CK / kChainK, NC = (CK + CV) / kChainK;  // chains of s, of s and dp
  constexpr int R = BK / 2;  // accumulator floats of a 64 x BK product per thread
  constexpr int STEPS = BK / 8, QSTEPS = CK / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* aq = smem;                                // q hi, lo [64 x CK], unless in registers
  float* ado = aq + (QR ? 0 : 2 * kDqRows * CK);  // do hi, lo [64 x CV]
  float* bk = ado + 2 * kDqRows * CV;             // k hi, lo [BK x CK]
  float* bv = bk + 2 * BK * CK;                   // v hi, lo [BK x CV]
  float* bkt = bv + 2 * BK * CV;                  // k^T hi, lo [CK x BK]

  const int t = threadIdx.x, w = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kDqRows;
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const int nkt = ws.lkp / BK, ntiles = cdiv(ws.lk, BK);
  const int nqt = ws.lqp / kDkvRows, nkb = ws.lkp / kDkvKeys;
  float* pdb = ws.pds + static_cast<int64_t>(b) * nkb * nqt * 2 * kPlane;
  const T* qb = q + static_cast<int64_t>(b) * ws.lq * ws.dk;

  const auto issue_kv = [&](int it) {
    const int64_t at = (static_cast<int64_t>(b) * nkt + it) * BK;
    copy_flat(bk, ws.bk_[0] + at * CK, BK * CK, t);
    copy_flat(bk + BK * CK, ws.bk_[1] + at * CK, BK * CK, t);
    copy_flat(bv, ws.bv[0] + at * CV, BK * CV, t);
    copy_flat(bv + BK * CV, ws.bv[1] + at * CV, BK * CV, t);
    copy_commit();
  };
  const auto issue_kt = [&](int it) {
    const int64_t at = (static_cast<int64_t>(b) * nkt + it) * BK * CK;
    copy_flat(bkt, ws.bkt[0] + at, CK * BK, t);
    copy_flat(bkt + CK * BK, ws.bkt[1] + at, CK * BK, t);
    copy_commit();
  };
  issue_kv(0);
  issue_kt(0);

  // q as A fragments (rows 16 w + g, + 8; columns t, t + 4 of each step),
  // or as a panel in shared memory; do as a panel: both read and split here
  uint32_t q_hi[QR ? QSTEPS : 1][4], q_lo[QR ? QSTEPS : 1][4];
  if constexpr (QR) {
#pragma unroll
    for (int st = 0; st < QSTEPS; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e & 1), col = 8 * st + tg + 4 * (e >> 1);
        const float x = row < ws.lq && col < ws.dk ? to_float(qb[static_cast<int64_t>(row) * ws.dk + col]) : 0.f;
        split(x, q_hi[st][e], q_lo[st][e]);
      }
  } else {
    stage_split<CK>(aq, aq + kDqRows * CK, qb, q0, ws.lq, ws.dk, t);
  }
  stage_split<CV>(ado, ado + kDqRows * CV, dout + static_cast<int64_t>(b) * ws.lq * ws.dv, q0, ws.lq,
                  ws.dv, t);

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool ok = row < ws.lq;
    lse_r[h] = ok ? lse[static_cast<int64_t>(b) * ws.lq + row] : 0.f;
    delta_r[h] = ok ? delta[static_cast<int64_t>(b) * ws.lq + row] : 0.f;
  }
  float acc[CK / 2], cq[CK / 2];  // dq's hi hi sum, and its corrections on the tensor cores
#pragma unroll
  for (int e = 0; e < CK / 2; ++e) acc[e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    copy_wait<1>();  // this tile's k and v are in; its k^T may still be on the way
    fence_async_shared();  // and q and do, written above, on the first tile
    __syncthreads();

    // s = q k^T and dp = do v^T: NC chains of kChainK columns of hi hi
    // products, each summed as it completes while the next one and the
    // corrections run
    float s[R], dp[R], ch[R], cs[R], cdp[R];
#pragma unroll
    for (int e = 0; e < R; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wgmma_fence();
      if (c < NS) {
        if constexpr (QR) {
          hh_rs<BK, QSTEPS, kChainK / 8>(ch, q_hi, c * kChainK / 8, bk);
        } else {
          hh_ss<BK>(ch, aq, bk, c * kChainK / 8);
        }
      } else {
        hh_ss<BK>(ch, ado, bv, (c - NS) * kChainK / 8);
      }
      wgmma_commit();
      if (c < NS) {
        if constexpr (QR) {
          corr_rs<BK, QSTEPS, kChainK / 8>(cs, q_hi, q_lo, c * kChainK / 8, bk, bk + BK * CK, c == 0);
        } else {
          corr_ss<BK>(cs, aq, aq + kDqRows * CK, bk, bk + BK * CK, c * kChainK / 8, c == 0);
        }
      } else {
        corr_ss<BK>(cdp, ado, ado + kDqRows * CV, bv, bv + BK * CV, (c - NS) * kChainK / 8, c == NS);
      }
      wgmma_commit();
      wgmma_wait<1>();  // this chain's hi hi products are done
      fence_operand(ch);
      add(c < NS ? s : dp, ch);
    }
    wgmma_wait<0>();
    fence_operand(cs);
    fence_operand(cdp);
    add(s, cs);
    add(dp, cdp);
    __syncthreads();  // every warp's s and dp have read this tile's k and v
    if (it + 1 < ntiles) issue_kv(it + 1);

    // p = exp(s - lse) and ds = p (dp - delta), masked without a branch
    float p[R];
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int h = (e >> 1) & 1, row = row0 + 8 * h, key = it * BK + 8 * (e >> 2) + 2 * tg + (e & 1);
      const float ex = __expf(s[e] - lse_r[h]);
      p[e] = key < ws.lk && row < ws.lq ? ex : 0.f;
      dp[e] = p[e] * (dp[e] - delta_r[h]);  // ds
    }

    // this tile's k^T is in (the next tile's k and v, the latest group, may not be)
    if (it + 1 < ntiles) {
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // dq += ds k: A from ds's accumulator fragment, k = t from column 2t and
    // k = t + 4 from column 2t + 1 (k^T's keys are stored in that order)
    uint32_t a_hi[STEPS][4], a_lo[STEPS][4];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      split(dp[4 * j + 0], a_hi[j][0], a_lo[j][0]);
      split(dp[4 * j + 2], a_hi[j][1], a_lo[j][1]);
      split(dp[4 * j + 1], a_hi[j][2], a_lo[j][2]);
      split(dp[4 * j + 3], a_hi[j][3], a_lo[j][3]);
    }
    float d[CK / 2];
    wgmma_fence();
    hh_rs<CK, STEPS, STEPS>(d, a_hi, 0, bkt);
    corr_rs<CK, STEPS, STEPS>(cq, a_hi, a_lo, 0, bkt, bkt + CK * BK, it == 0);
    wgmma_commit();

    // while the tensor cores run it: p and ds to the scratch tile (key / 64,
    // row / 32) at [row % 32][key % 64], a thread's two keys in one 8-byte
    // store
#pragma unroll
    for (int j = 0; j < STEPS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, key = it * BK + 8 * j + 2 * tg, e = 4 * j + 2 * h;
        const int64_t tile = static_cast<int64_t>(key / kDkvKeys) * nqt + row / kDkvRows;
        float* at = pdb + tile * 2 * kPlane + (row % kDkvRows) * kDkvKeys + key % kDkvKeys;
        *reinterpret_cast<float2*>(at) = make_float2(p[e], p[e + 1]);
        *reinterpret_cast<float2*>(at + kPlane) = make_float2(dp[e], dp[e + 1]);
      }
    wgmma_wait<0>();
    fence_operand(d);
    fence_operand(cq);
    add(acc, d);
    __syncthreads();  // every warp's dq product has read this tile's k^T
    if (it + 1 < ntiles) issue_kt(it + 1);
  }
  copy_wait<0>();
  add(acc, cq);

#pragma unroll
  for (int n = 0; n < CK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 8 * (e >> 1), col = 8 * n + 2 * tg + (e & 1);
      if (row < ws.lq && col < ws.dk) {
        dq[(static_cast<int64_t>(b) * ws.lq + row) * ws.dk + col] = from_float<T>(acc[4 * n + e]);
      }
    }
}

// ---- dk, dv ------------------------------------------------------------------

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
attention_dkv_kernel(Workspace ws, T* __restrict__ dk_out, T* __restrict__ dv_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, w = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const int slices = ws.sv + ws.sk;
  const int kb = blockIdx.y / slices, slice = blockIdx.y - kb * slices, b = blockIdx.z;
  // dv's slices take p (as p^T) and do^T, dk's take ds (as ds^T) and q^T
  const bool is_v = slice < ws.sv;
  const int sl = is_v ? slice : slice - ws.sv;
  const int nqt = ws.lqp / kDkvRows, nkb = ws.lkp / kDkvKeys;
  const float* a_src = ws.pds + ((static_cast<int64_t>(b) * nkb + kb) * nqt) * 2 * kPlane +
                       (is_v ? 0 : kPlane);
  const int64_t b_at =
      (static_cast<int64_t>(b) * (is_v ? ws.sv : ws.sk) + sl) * nqt * kSlice * kDkvRows;
  const float* b_hi = (is_v ? ws.bdot[0] : ws.bqt[0]) + b_at;
  const float* b_lo = (is_v ? ws.bdot[1] : ws.bqt[1]) + b_at;

  // this block's query tiles: rank, rank + kCluster, ... of the ones with a row below Lq
  const int used = cdiv(ws.lq, kDkvRows);
  const int mine = rank < used ? cdiv(used - rank, kCluster) : 0;
  const auto issue = [&](int i) {
    if (i < mine) {
      const int q = rank + i * kCluster;
      float* st = smem + (i % kStages) * kDkvStage;
      const float* a = a_src + static_cast<int64_t>(q) * 2 * kPlane;
      for (int x = t; x < kDkvRows * kDkvKeys / 4; x += kThreads) {
        const int r = x / (kDkvKeys / 4), c = 4 * (x % (kDkvKeys / 4));
        copy16(st + r * kLdp + c, a + r * kDkvKeys + c);
      }
      float* sb = st + kDkvRows * kLdp;
      copy_flat(sb, b_hi + static_cast<int64_t>(q) * kSlice * kDkvRows, kSlice * kDkvRows, t);
      copy_flat(sb + kSlice * kDkvRows, b_lo + static_cast<int64_t>(q) * kSlice * kDkvRows,
                kSlice * kDkvRows, t);
    }
    copy_commit();  // one group per tile, empty past the last, so the waits count tiles
  };

  constexpr int STEPS = kDkvRows / 8;
  float acc[kSlice / 2], corr[kSlice / 2];  // the hi hi sum, and the corrections on the tensor cores
#pragma unroll
  for (int e = 0; e < kSlice / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    copy_wait<kStages - 2>();  // tile i is in
    fence_async_shared();
    __syncthreads();            // and every warp is done with tile i - 1's stage
    issue(i + kStages - 1);
    const float* st = smem + (i % kStages) * kDkvStage;
    const float* sb = st + kDkvRows * kLdp;
    // A: p^T or ds^T, keys (rows) 16 w + g, + 8 and query columns t, t + 4
    // of each step, from the tile's [query][key] rows
    uint32_t a_hi[STEPS][4], a_lo[STEPS][4];
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = st[(8 * s + tg + 4 * (e >> 1)) * kLdp + 16 * w + g + 8 * (e & 1)];
        split(x, a_hi[s][e], a_lo[s][e]);
      }
    // one chain of hi hi products over the tile's rows, the corrections
    // into the block's own accumulator
    static_assert(kDkvRows == kChainK, "one chain per dkv tile");
    float d[kSlice / 2];
    wgmma_fence();
    hh_rs<kSlice, STEPS, STEPS>(d, a_hi, 0, sb);
    corr_rs<kSlice, STEPS, STEPS>(corr, a_hi, a_lo, 0, sb, sb + kSlice * kDkvRows, i == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(d);
    fence_operand(corr);
    add(acc, d);
  }
  if (mine > 0) add(acc, corr);

  // the partial sums to shared memory [kDkvKeys][kSlice], then each block
  // adds up rows [rank kRows, (rank + 1) kRows) over the cluster in rank order
  copy_wait<0>();
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int n = 0; n < kSlice / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(16 * w + g + 8 * (e >> 1)) * kSlice + 8 * n + 2 * tg + (e & 1)] = acc[4 * n + e];
  cluster.sync();
  constexpr int kRows = kDkvKeys / kCluster;
  const float* parts[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c) parts[c] = cluster.map_shared_rank(red, c);
  const int width = is_v ? ws.dv : ws.dk;
  T* out = is_v ? dv_out : dk_out;
  const int j0 = kb * kDkvKeys;
  for (int x = t; x < kRows * kSlice; x += kThreads) {
    const int r = rank * kRows + x / kSlice, col = x % kSlice, oc = sl * kSlice + col;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) sum += parts[c][r * kSlice + col];
    if (j0 + r < ws.lk && oc < width) {
      out[(static_cast<int64_t>(b) * ws.lk + j0 + r) * width + oc] = from_float<T>(sum);
    }
  }
  cluster.sync();  // no block leaves while the others still read its shared memory
}

// ---- launches ----------------------------------------------------------------

bool valid(int n, int lq, int lk, int dk, int dv) {
  return n >= 1 && n <= 65535 && lq >= 1 && lk >= 1 && dk >= 1 && dk <= kMaxDk && dv >= 1 &&
         dv <= kMaxDv && cdiv(lq, kDqRows) <= 65535 &&
         static_cast<int64_t>(cdiv(lk, kDkvKeys)) * (cdiv(dk, kSlice) + cdiv(dv, kSlice)) <= 65535;
}

template <typename T>
struct DqArgs {
  const T *q, *dout;
  const float *lse, *delta;
  T* dq;
};

template <typename T, int CK, int CV>
cudaError_t launch_dq(const Workspace& ws, const DqArgs<T>& a, cudaStream_t stream) {
  constexpr int bytes = 4 * dq_floats(CK, CV, dq_keys(CK, CV));
  const cudaError_t set = cudaFuncSetAttribute(attention_dq_kernel<T, CK, CV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid(ws.lqp / kDqRows, ws.n);
  attention_dq_kernel<T, CK, CV>
      <<<grid, kThreads, bytes, stream>>>(ws, a.q, a.dout, a.lse, a.delta, a.dq);
  return cudaGetLastError();
}

template <typename T, int CK>
cudaError_t launch_dq_dv(const Workspace& ws, const DqArgs<T>& a, cudaStream_t stream) {
  if (ws.cv == 64) return launch_dq<T, CK, 64>(ws, a, stream);
  if (ws.cv == 128) return launch_dq<T, CK, 128>(ws, a, stream);
  return launch_dq<T, CK, 256>(ws, a, stream);
}

bool refused(int n, int lq, int lk, int dk, int dv, const float* workspace) {
  return !valid(n, lq, lk, dk, dv) || reinterpret_cast<uintptr_t>(workspace) % 16 != 0;
}

template <typename T>
int pack(const T* q, const T* k, const T* v, const T* dout, float* workspace, int n, int lq, int lk,
         int dk, int dv, int device, void* stream) {
  if (refused(n, lq, lk, dk, dv, workspace)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Workspace w = make_workspace(workspace, n, lq, lk, dk, dv);
  const int64_t sq = static_cast<int64_t>(lq) * dk, sk = static_cast<int64_t>(lk) * dk;
  const int64_t sv = static_cast<int64_t>(lk) * dv, sd = static_cast<int64_t>(lq) * dv;
  const int kp = w.lkp / w.bk, rows = w.lqp / kDkvRows;
  // src, hi, lo, item, s_r, s_c, rows, cols, pr, pc, tiles_r, tiles_c, permute
  const PackJobs jobs{{
      {k, w.bk_[0], w.bk_[1], sk, dk, 1, lk, dk, w.bk, w.ck, kp, 1, 0},
      {v, w.bv[0], w.bv[1], sv, dv, 1, lk, dv, w.bk, w.cv, kp, 1, 0},
      {k, w.bkt[0], w.bkt[1], sk, 1, dk, dk, lk, w.ck, w.bk, 1, kp, 1},
      {dout, w.bdot[0], w.bdot[1], sd, 1, dv, dv, lq, kSlice, kDkvRows, w.sv, rows, 0},
      {q, w.bqt[0], w.bqt[1], sq, 1, dk, dk, lq, kSlice, kDkvRows, w.sk, rows, 0},
  }, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_pack_kernel<T><<<dim3(4 * 132, kPackJobs), kPackThreads, 0, s>>>(jobs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(const T* q, const T* dout, const float* lse, const float* delta, T* dq_out, float* workspace,
       int n, int lq, int lk, int dk, int dv, int device, void* stream) {
  if (refused(n, lq, lk, dk, dv, workspace)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Workspace w = make_workspace(workspace, n, lq, lk, dk, dv);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DqArgs<T> a{q, dout, lse, delta, dq_out};
  const cudaError_t rc = w.ck == 64 ? launch_dq_dv<T, 64>(w, a, s) : launch_dq_dv<T, 128>(w, a, s);
  return static_cast<int>(rc);
}

template <typename T>
int dkv(float* workspace, T* dk_out, T* dv_out, int n, int lq, int lk, int dk, int dv, int device,
        void* stream) {
  if (refused(n, lq, lk, dk, dv, workspace)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Workspace w = make_workspace(workspace, n, lq, lk, dk, dv);
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(kCluster, (w.lkp / kDkvKeys) * (w.sv + w.sk), n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_dkv_kernel<T><<<grid, kThreads, kDkvBytes, s>>>(w, dk_out, dv_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointers are device pointers on
// ordinal `device`, contiguous as above: q, k, v, do, dq, dk and dv fp32
// (_f32) or bf16 (_bf16), lse and delta fp32; `workspace` holds
// tpugan_sagan_attention_bwd_workspace_floats(n, lq, lk, dk, dv) floats,
// 16-byte aligned, for either type. The three kernels run in order on one
// stream: pack (k, v, do and q into the workspace), dq (from q, do and the
// workspace; also p and ds into its scratch), dkv. Each launches on
// `stream` and does not synchronise.
// Returns 0, or the cudaError_t of a refused launch (cudaErrorInvalidValue
// for arguments outside the kernels' contract).
extern "C" int64_t tpugan_sagan_attention_bwd_workspace_floats(int n, int lq, int lk, int dk,
                                                                int dv) {
  if (!valid(n, lq, lk, dk, dv)) return -1;
  return make_workspace(nullptr, n, lq, lk, dk, dv).floats;
}

extern "C" int tpugan_sagan_attention_bwd_pack_f32(const float* q, const float* k, const float* v,
                                                   const float* dout, float* workspace, int n,
                                                   int lq, int lk, int dk, int dv, int device,
                                                   void* stream) {
  return pack(q, k, v, dout, workspace, n, lq, lk, dk, dv, device, stream);
}

extern "C" int tpugan_sagan_attention_bwd_dq_f32(const float* q, const float* dout,
                                                 const float* lse, const float* delta, float* dq_out,
                                                 float* workspace, int n, int lq, int lk, int dk,
                                                 int dv, int device, void* stream) {
  return dq(q, dout, lse, delta, dq_out, workspace, n, lq, lk, dk, dv, device, stream);
}

extern "C" int tpugan_sagan_attention_bwd_dkv_f32(float* workspace, float* dk_out, float* dv_out,
                                                  int n, int lq, int lk, int dk, int dv, int device,
                                                  void* stream) {
  return dkv(workspace, dk_out, dv_out, n, lq, lk, dk, dv, device, stream);
}

extern "C" int tpugan_sagan_attention_bwd_pack_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                                    const __nv_bfloat16* v,
                                                    const __nv_bfloat16* dout, float* workspace,
                                                    int n, int lq, int lk, int dk, int dv,
                                                    int device, void* stream) {
  return pack(q, k, v, dout, workspace, n, lq, lk, dk, dv, device, stream);
}

extern "C" int tpugan_sagan_attention_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* dout,
                                                  const float* lse, const float* delta,
                                                  __nv_bfloat16* dq_out, float* workspace, int n,
                                                  int lq, int lk, int dk, int dv, int device,
                                                  void* stream) {
  return dq(q, dout, lse, delta, dq_out, workspace, n, lq, lk, dk, dv, device, stream);
}

extern "C" int tpugan_sagan_attention_bwd_dkv_bf16(float* workspace, __nv_bfloat16* dk_out,
                                                   __nv_bfloat16* dv_out, int n, int lq, int lk,
                                                   int dk, int dv, int device, void* stream) {
  return dkv(workspace, dk_out, dv_out, n, lq, lk, dk, dv, device, stream);
}
