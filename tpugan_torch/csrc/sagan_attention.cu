// SAGAN attention forward: o = softmax(q k^T) v over the keys, fp32 or bf16,
// optionally with the per-row logsumexp (fp32). No 1/sqrt(d) scaling:
// BigGAN's SelfAttn applies none.
//
// Replaces the Pallas TPU kernel tpugan/ops/pallas/attention.py::
// sagan_attention_pallas in both forms: without the logsumexp (pallas_call
// :68, the eval path) and with it (:77, the form the training backward
// reads), on fp32 (tpugan_sagan_attention_f32) and on bf16
// (tpugan_sagan_attention_bf16), as the Pallas kernel takes any float type:
// it computes in fp32 (:100-107) and writes o in q's type (:73, :88, :122).
//
// Shapes: q [N, Lq, dk], k [N, Lk, dk], v [N, Lk, dv], o [N, Lq, dv],
// lse [N, Lq] (the caller views it as [N, Lq, 1]); all contiguous, any
// Lq, Lk >= 1, dk <= 128, dv <= 256. At BigGAN-256's attention layer
// N = 2, Lq = 4096, Lk = 1024, dk = 64, dv = 256.
//
// Bound: operations. The two products take 2 N Lq Lk (dk + dv) FLOPs (5.37
// GFLOP at the BigGAN-256 shape) against 13 MB of inputs and output; the
// score matrix never reaches device memory. They run on the tensor cores in
// 3xTF32, three TF32 products for each fp32-accurate one, so the least
// time is 3 x 5.37 GFLOP at the card's dense TF32 rate: 32.5 us on an H100
// SXM (495 TFLOP/s); in fp32 FMAs outside the tensor cores it would be
// 80.1 us (67 TFLOP/s). This design computes s = q k^T once for each slice
// of dv (two at dv 256), 6.44 GFLOP in all at the path shape, so its own
// floor is 39.0 us.
//
// bf16: the kernel is templated on the element type T of q, k, v and o.
// Key tiles are staged in T and widened to fp32 in the split, q where it is
// read; o is rounded once to bf16 (to nearest even) where it is stored, the
// lse stays fp32. A bf16 value is exact in TF32, so its split is hi = x,
// lo = 0, and the bf16 form computes what the fp32 kernel computes on the
// widened inputs: its output is the fp32 kernel's rounded to bf16, bit for
// bit. Its bound at the path shape: s in one dense bf16 pass (both operands
// bf16, 989.4 TFLOP/s on an H100 SXM) and p v with the fp32 p split into
// three bf16 pieces (less time than two TF32 passes), 1.07 + 3 x 4.29
// GFLOP of bf16 products, 14.1 us. This form keeps all three TF32 passes,
// and with them the fp32 kernel's time; bf16 products are a redesign of
// their own.
//
// Precision: 3xTF32, as in sagan_attention_bwd.cu. Every operand x is split
// into hi, x rounded to TF32 to nearest with ties away from zero
// (cvt.rna.tf32.f32's rounding), and lo = x - hi, exact in fp32; a b is
// formed as lo_a hi_b + hi_a lo_b + hi_a hi_b with fp32 accumulation. The
// tensor cores read lo's top 10 mantissa bits (rounding toward zero); the
// dropped lo_a lo_b is about 2^-22 of the product. One TF32 product keeps
// about three digits, which does not hold the forward's 2e-5 contract. The
// max, exp, the sums, the rescale and the division stay in fp32. The
// tensor cores align and truncate when they add into an accumulator, so no
// accumulator of full-size values takes a long chain: the hi hi products run
// in chains of kChainK = 32 of the contraction from a zeroed accumulator
// (the wgmma's scale-d 0), and the two corrections, about 2^-11 of the
// product, in an accumulator of their own. s is the fp32 sum of its chains
// and its corrections; each key tile's p v is one chain (32 keys) and its
// corrections, and the running output is updated in fp32 as
// o = alpha o + (chain + corrections).
//
// Instructions: both products are wgmma.mma_async m64nNk8 TF32 with fp32
// accumulators; a block is two warpgroups (8 warps, 256 threads), each
// with 64 query rows of its own.
//  * TF32 wgmma reads shared-memory operands K-major only. q (A of s) and k
//    (B of s) lie K-major as they are stored; v (B of p v) lies N-major, so
//    each key tile of v is transposed as it is laid out (v^T).
//  * Layout and fragments as in tf32_wgmma.cuh (K-major core-matrix panels,
//    no swizzle), which this kernel shares with the backward. A part of a
//    panel's rows (a 64-column half of v^T) starts 16 bytes per row in,
//    with the same offsets. p feeds p v from registers as A, whose k = t
//    is p's accumulator column 2t and k = t + 4 its column 2t + 1, so
//    v^T's keys of each 8 are laid out in the order 0, 2, 4, 6, 1, 3, 5, 7
//    to match.
//
// Design (no atomics, so two runs on the same inputs are bitwise equal):
//  * one block per (batch item, 128 query rows, slice of at most 128 of
//    dv's columns): at the path shape 32 x 2 x 2 = 128 blocks, one to an SM
//    (185 KB of shared memory), one wave on 132 SMs. Each warpgroup reads
//    its 64 rows of q once and lays them out split, hi and lo, in shared
//    memory; the two share every key tile;
//  * a loop over tiles of kBK = 32 keys: the tile's rows of k and its
//    slice of v are copied with cp.async into a staging buffer (16-byte
//    copies where a row is whole 16-byte copies and its base 16-byte
//    aligned, 4-byte otherwise; bf16 rows that are not whole 4-byte copies
//    a load and a store by the thread, as cp.async has no 2-byte copy;
//    zeros past Lk, dk and dv),
//    then split by all 256 threads into hi and lo panels (k as it lies, v
//    transposed and its keys permuted). With two stages of panels (padded
//    dk up to 64), tile it + 1 is split while the tensor cores run the
//    first part of tile it's p v, and its copy was issued a tile before;
//    with one (dk 128, whose q panels take 128 KB), each tile is split
//    before its products and the next copy runs under them;
//  * s = q k^T on the tensor cores (A and B from shared memory), masked
//    (keys past Lk score -inf, without a branch); the online softmax's max
//    m and sum l per row in registers, reduced over the four threads of a
//    row with shuffles, exp as 2^((s - m) log2 e) (ex2.approx); p split in
//    registers;
//  * p v in parts of 64 columns (one chain and its corrections each), so
//    that the running output, one part's chain and its corrections fit in
//    registers with p (the path's instance uses all 255 registers a
//    thread may have, without spills);
//  * o = o / l and lse = m + log(l) at the end. Rows past Lq and columns
//    past dv are not written; the first slice writes lse.
// Instances: padded dk (CK) 32, 64 or 128 by slice width (CV) 32, 64 or
// 128. What holds it back: the instructions around the products (the
// copies, the split, the softmax, the running output's update, the waits
// and the barriers) take about as long as the products and mostly do not
// overlap them, since the two warpgroups run in step (meeting them half a
// tile apart at the split measured slower on an H100); s reads q from
// shared memory (A of 2 KB for each k8 step against 1 KB of k), so s is
// bound by shared-memory reads rather than by the tensor cores; s is
// computed once for each slice of dv; and every block splits each key tile
// again. A producer warp feeding consumer warpgroups, q in registers, and
// key tiles split once by a pack launch are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kGroups = 2;                 // warpgroups per block
constexpr int kThreads = 128 * kGroups;
constexpr int kRows = 64;                  // query rows per warpgroup (the wgmma's M)
constexpr int kBK = 32;        // keys per tile
constexpr int kChainK = 32;    // contraction length of one chain of hi hi products
constexpr int kPart = 64;      // output columns of one p v chain
constexpr int kMaxSlice = 128; // dv columns per block
constexpr int kMaxDk = 128;
constexpr int kMaxDv = 256;
constexpr int kMaxSharedBytes = 227 * 1024;
static_assert(kBK == kChainK, "one p v chain per key tile");
static_assert(kBK * 32 / 4 % kThreads == 0, "whole 16-byte copies of a tile per thread");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
// padded widths: dk to 32, 64 or 128; a slice of dv to 32, 64 or 128
__host__ __device__ constexpr int pad_width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }
// k's staging rows are padded by 4 floats, so that the split's float4
// reads of 8 consecutive rows fall in distinct banks
__host__ __device__ constexpr int k_stride(int ck) { return ck + 4; }
// the same row of staged elements of T: 16 bytes of padding, which keeps
// every row on a 16-byte boundary (fp32: k_stride; bf16 staging fits in the
// fp32 staging's room)
template <typename T>
__host__ __device__ constexpr int k_stage_stride(int ck) { return ck + 16 / static_cast<int>(sizeof(T)); }
// one stage of split panels: k hi, lo [kBK x CK] and v^T hi, lo [CV x kBK]
__host__ __device__ constexpr int panel_floats(int ck, int cv) { return 2 * kBK * ck + 2 * cv * kBK; }
// shared floats of an instance: q hi, lo [64 x CK] for each warpgroup;
// `stages` stages of panels; k's staging [kBK][CK + 4], v's [kBK][CV]
__host__ __device__ constexpr int shared_floats(int ck, int cv, int stages) {
  return 2 * kGroups * kRows * ck + stages * panel_floats(ck, cv) + kBK * k_stride(ck) + kBK * cv;
}
// two stages of panels where they fit (CK <= 64), one otherwise
__host__ __device__ constexpr int stages_of(int ck, int cv) {
  return 4 * shared_floats(ck, cv, 2) <= kMaxSharedBytes ? 2 : 1;
}
static_assert(4 * shared_floats(kMaxDk, kMaxSlice, 1) <= kMaxSharedBytes, "shared memory");

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
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// 2^x (ex2.approx: within 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [0, kBK) x columns [0, W) of a key tile into the staging buffer
// `dst` (rows `stride` elements apart) from `src` (rows `ld` apart), BYTES a
// copy: 16 or 4 with cp.async, or 2 (one bf16, loaded and stored by the
// thread: cp.async has no 2-byte copy); zeros past `rows` and `cols` (a
// multiple of a copy's elements), where the copy reads from `base`
template <typename T, int BYTES, int W>
__device__ __forceinline__ void stage_copies(T* dst, int stride, const T* src, int ld, int rows,
                                             int cols, const T* base, int t) {
  constexpr int E = BYTES / static_cast<int>(sizeof(T));  // elements a copy
  static_assert(E >= 1 && W % E == 0, "whole copies");
  constexpr int kCopies = kBK * W / E;
#pragma unroll
  for (int n = 0; n < cdiv(kCopies, kThreads); ++n) {
    const int i = t + n * kThreads;
    if (kCopies % kThreads != 0 && i >= kCopies) break;
    const int j = i / (W / E), c = E * (i % (W / E));
    const bool ok = j < rows && c < cols;
    const T* from = ok ? src + static_cast<int64_t>(j) * ld + c : base;
    if constexpr (BYTES == 16) {
      copy16(dst + j * stride + c, from, ok);
    } else if constexpr (BYTES == 4) {
      copy4(dst + j * stride + c, from, ok);
    } else {
      dst[j * stride + c] = ok ? *from : from_float<T>(0.f);
    }
  }
}
template <typename T, int W>
__device__ __forceinline__ void stage(T* dst, int stride, const T* src, int ld, int rows, int cols,
                                      const T* base, int bytes, int t) {
  if (bytes == 16) {
    stage_copies<T, 16, W>(dst, stride, src, ld, rows, cols, base, t);
  } else if (sizeof(T) == 4 || bytes == 4) {
    stage_copies<T, 4, W>(dst, stride, src, ld, rows, cols, base, t);
  } else if constexpr (sizeof(T) == 2) {
    stage_copies<T, 2, W>(dst, stride, src, ld, rows, cols, base, t);
  }
}

// four staged values, widened to fp32 (8 bytes of bf16: the element at the
// lower address is the word's low half)
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16), x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16), x[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void split4(const float (&x)[4], float* hi, float* lo) {
  float4 h4, l4;
  float* h = &h4.x;
  float* l = &l4.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t xh, xl;
    split(x[e], xh, xl);
    h[e] = __uint_as_float(xh);
    l[e] = __uint_as_float(xl);
  }
  *reinterpret_cast<float4*>(hi) = h4;
  *reinterpret_cast<float4*>(lo) = l4;
}

// s's chains: the hi hi products over kChainK columns from k8 step `first`
// into d (the first zeroing it), and the two corrections into c (zeroed
// when `fresh`); a is the 64-row q panel, b the kBK-row k panel (their
// descriptors)
__device__ __forceinline__ void s_chain(float (&d)[16], uint64_t a_hi, uint64_t b_hi, int first) {
#pragma unroll
  for (int s = 0; s < kChainK / 8; ++s) {
    wgmma_ss(d, step(a_hi, kRows, first + s), step(b_hi, kBK, first + s), s > 0);
  }
}
__device__ __forceinline__ void s_corr(float (&c)[16], uint64_t a_hi, uint64_t a_lo, uint64_t b_hi,
                                       uint64_t b_lo, int first, bool fresh) {
#pragma unroll
  for (int s = 0; s < kChainK / 8; ++s) {
    wgmma_ss(c, step(a_lo, kRows, first + s), step(b_hi, kBK, first + s), !(fresh && s == 0));
    wgmma_ss(c, step(a_hi, kRows, first + s), step(b_lo, kBK, first + s), 1);
  }
}

// one part of p v: the hi hi chain over the tile's keys into d and the
// corrections into c, both from zero; p's fragments from registers, the
// part of v^T (a panel of `rows` rows) from shared memory
template <int R>
__device__ __forceinline__ void pv_part(float (&d)[R], float (&c)[R],
                                        const uint32_t (&a_hi)[kBK / 8][4],
                                        const uint32_t (&a_lo)[kBK / 8][4], uint64_t b_hi,
                                        uint64_t b_lo, int rows) {
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s) wgmma_rs(d, a_hi[s], step(b_hi, rows, s), s > 0);
  wgmma_commit();
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s) {
    wgmma_rs(c, a_lo[s], step(b_hi, rows, s), s > 0);
    wgmma_rs(c, a_hi[s], step(b_lo, rows, s), 1);
  }
  wgmma_commit();
}

template <typename T, int CK, int CV>
__global__ void __launch_bounds__(kThreads)
sagan_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, float* __restrict__ lse, int lq, int lk, int dk, int dv,
                       int k_copy, int v_copy) {
  constexpr int NS = CK / kChainK;        // chains of s
  constexpr int NP = CV < kPart ? CV : kPart;  // columns of one p v part
  constexpr int KS = k_stage_stride<T>(CK);
  constexpr int STAGES = stages_of(CK, CV);
  constexpr int PF = panel_floats(CK, CV);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x, wg = t >> 7, tw = t & 127;
  const int w = tw >> 5, g = (tw & 31) >> 2, tg = t & 3;
  float* qh = smem + 2 * wg * kRows * CK;  // this warpgroup's q hi, lo [64 x CK]
  float* ql = qh + kRows * CK;
  // stage st's panels: k hi, lo [kBK x CK] at panels + st PF, then v^T hi,
  // lo [CV x kBK] (keys permuted)
  float* panels = smem + 2 * kGroups * kRows * CK;
  T* sk = reinterpret_cast<T*>(panels + STAGES * PF);  // staging in T: k [kBK][KS], v [kBK][CV]
  T* sv = sk + kBK * KS;

  const int q0 = (blockIdx.x * kGroups + wg) * kRows, c0 = blockIdx.y * CV, b = blockIdx.z;
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
  const T* qb = q + static_cast<int64_t>(b) * lq * dk;
  const T* kb = k + static_cast<int64_t>(b) * lk * dk;
  const T* vb = v + static_cast<int64_t>(b) * lk * dv;

  // tile `it`'s rows of k and columns [c0, c0 + CV) of v into the staging
  // buffer, zeros past Lk, dk and dv
  const auto issue = [&](int it) {
    const int j0 = it * kBK, kn = min(kBK, lk - j0);
    stage<T, CK>(sk, KS, kb + static_cast<int64_t>(j0) * dk, dk, kn, dk, kb, k_copy, t);
    stage<T, CV>(sv, CV, vb + static_cast<int64_t>(j0) * dv + c0, dv, kn, dv - c0, vb, v_copy, t);
    copy_commit();
  };
  issue(0);

  // the warpgroup's rows of q as a panel of 64 rows, split (zeros past Lq
  // and dk)
  for (int x = 4 * tw; x < kRows * CK; x += 4 * 128) {
    const int core = x >> 5;  // (column group) 8 + row group
    const int r = q0 + (core & 7) * 8 + ((x >> 2) & 7), c = (core >> 3) * 4;
    float vals[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vals[e] = r < lq && c + e < dk ? to_float(qb[static_cast<int64_t>(r) * dk + c + e]) : 0.f;
    }
    split4(vals, qh + x, ql + x);
  }

  const uint64_t qd_hi = desc(qh, kRows), qd_lo = desc(ql, kRows);
  float acc[CV / 2];  // the running output, rows row0 and row0 + 8
#pragma unroll
  for (int e = 0; e < CV / 2; ++e) acc[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the split of the staged tile into stage st's panels, four values of
  // one row of a panel a thread at a time: k as it lies (row r = key,
  // column group cg at 128 cg + 4 r), v transposed (row r = v's column, at
  // 4 CV cg + 4 r) with its keys of each 8 in the order 0, 2, 4, 6, 1, 3,
  // 5, 7. Waits for the staging copies and leaves the panels visible to the
  // tensor cores and the staging buffer free.
  const auto split_tile = [&](int st) {
    copy_wait_all();
    __syncthreads();  // every thread's copies are in; no warp reads stage st any more
    float* kh = panels + st * PF;
    float* kl = kh + kBK * CK;
    float* vh = kl + kBK * CK;
    float* vl = vh + CV * kBK;
#pragma unroll
    for (int i = 0; i < CK / 32; ++i) {
      const int r = t & 31, cg = (t >> 5) + 8 * i;
      float vals[4];
      load4(sk + r * KS + 4 * cg, vals);
      split4(vals, kh + 128 * cg + 4 * r, kl + 128 * cg + 4 * r);
    }
#pragma unroll
    for (int i = 0; i < 8 * CV / kThreads; ++i) {
      const int r = t % CV, cg = t / CV + (kThreads / CV) * i;
      const int key0 = 8 * (cg >> 1) + (cg & 1);
      float vals[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vals[e] = to_float(sv[(key0 + 2 * e) * CV + r]);
      split4(vals, vh + cg * 4 * CV + 4 * r, vl + cg * 4 * CV + 4 * r);
    }
    fence_async_shared();
    __syncthreads();
  };

  // With two stages, tile it + 1 is split while the tensor cores run the
  // first part of tile it's p v, and its copy was issued a tile earlier;
  // with one, each tile is split before its products.
  const int ntiles = cdiv(lk, kBK);
  if (STAGES == 2) {
    split_tile(0);
    if (ntiles > 1) issue(1);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int st = STAGES == 2 ? it & 1 : 0;
    if (STAGES == 1) {
      split_tile(0);
      if (it + 1 < ntiles) issue(it + 1);
    }
    const float* kh = panels + st * PF;
    const float* kl = kh + kBK * CK;
    const float* vh = kl + kBK * CK;
    const float* vl = vh + CV * kBK;
    const uint64_t kd_hi = desc(kh, kBK), kd_lo = desc(kl, kBK);
    const uint64_t vd_hi = desc(vh, CV), vd_lo = desc(vl, CV);

    // s = q k^T: NS chains of hi hi products and one accumulator of their
    // corrections, all issued at once; s = the chains' sum, then the
    // corrections, in fp32
    float ch[NS][16], cs[16];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      s_chain(ch[c], qd_hi, kd_hi, c * kChainK / 8);
      s_corr(cs, qd_hi, qd_lo, kd_hi, kd_lo, c * kChainK / 8, c == 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      fence_operand(ch[c]);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] += ch[c][e];
    }
    fence_operand(cs);

    // the online softmax: keys past Lk score -inf (no branch); each row's
    // max and sum over its four threads
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int key = it * kBK + 8 * (e >> 2) + 2 * tg + (e & 1);
      s[e] = key < lk ? s[e] + cs[e] : -INFINITY;
      mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], s[e]);
    }
    // exp(x) as 2^(x log2(e)), x = s - m formed first in fp32
    constexpr float kLog2e = 1.4426950408889634f;
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], 2));
      const float m_new = fmaxf(m[h], mt[h]);
      alpha[h] = exp2_approx((m[h] - m_new) * kLog2e);
      m[h] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      s[e] = exp2_approx((s[e] - m[(e >> 1) & 1]) * kLog2e);  // p
      sum[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
    }

    // p as A fragments: k = t from column 2t, k = t + 4 from column 2t + 1
    uint32_t a_hi[kBK / 8][4], a_lo[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      split(s[4 * j + 0], a_hi[j][0], a_lo[j][0]);
      split(s[4 * j + 2], a_hi[j][1], a_lo[j][1]);
      split(s[4 * j + 1], a_hi[j][2], a_lo[j][2]);
      split(s[4 * j + 3], a_hi[j][3], a_lo[j][3]);
    }

    // o = alpha o + (chain + corrections), a part of NP columns at a time
#pragma unroll
    for (int part = 0; part < CV / NP; ++part) {
      float d[NP / 2], c[NP / 2];
      wgmma_fence();
      pv_part(d, c, a_hi, a_lo, vd_hi + part * NP, vd_lo + part * NP, CV);
      if (STAGES == 2 && part == 0 && it + 1 < ntiles) {  // under the first part's products
        split_tile(st ^ 1);
        if (it + 2 < ntiles) issue(it + 2);
      }
      wgmma_wait<0>();
      fence_operand(d);
      fence_operand(c);
#pragma unroll
      for (int e = 0; e < NP / 2; ++e) {
        float& x = acc[part * NP / 2 + e];
        x = fmaf(x, alpha[(e >> 1) & 1], d[e] + c[e]);
      }
    }
  }

  if (lse != nullptr && blockIdx.y == 0 && tg == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r < lq) lse[static_cast<int64_t>(b) * lq + r] = m[h] + logf(l[h]);
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int n = 0; n < CV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + 8 * (e >> 1), col = c0 + 8 * n + 2 * tg + (e & 1);
      if (r < lq && col < dv) {
        o[(static_cast<int64_t>(b) * lq + r) * dv + col] = from_float<T>(acc[4 * n + e] * inv[e >> 1]);
      }
    }
}

bool valid(int n, int lq, int lk, int dk, int dv) {
  return n >= 1 && n <= 65535 && lq >= 1 && lk >= 1 && dk >= 1 && dk <= kMaxDk && dv >= 1 &&
         dv <= kMaxDv;
}

// the instance of the last launch that was accepted: padded dk, slice
// width, stages (read by tpugan_sagan_attention_last_instance)
int last_instance[3] = {0, 0, 0};

// the bytes of one staging copy for rows of `width` elements of T from
// `base`: 16 where a row is whole 16-byte copies and starts on a 16-byte
// boundary, 4 where it is whole 4-byte copies on 4-byte boundaries, else
// one element (a bf16 view that starts 2 bytes off, or an odd width)
template <typename T>
int copy_bytes(const T* base, int width) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(base);
  const int row = width * static_cast<int>(sizeof(T));
  if (row % 16 == 0 && at % 16 == 0) return 16;
  if (row % 4 == 0 && at % 4 == 0) return 4;
  return static_cast<int>(sizeof(T));
}

template <typename T, int CK, int CV>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, float* lse, int n, int lq, int lk,
                   int dk, int dv, cudaStream_t stream) {
  constexpr int bytes = 4 * shared_floats(CK, CV, stages_of(CK, CV));
  const cudaError_t set = cudaFuncSetAttribute(sagan_attention_kernel<T, CK, CV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const int k_copy = copy_bytes(k, dk), v_copy = copy_bytes(v, dv);
  const dim3 grid(cdiv(lq, kGroups * kRows), cdiv(dv, CV), n);
  sagan_attention_kernel<T, CK, CV>
      <<<grid, kThreads, bytes, stream>>>(q, k, v, o, lse, lq, lk, dk, dv, k_copy, v_copy);
  const cudaError_t rc = cudaGetLastError();
  if (rc == cudaSuccess) {
    last_instance[0] = CK;
    last_instance[1] = CV;
    last_instance[2] = stages_of(CK, CV);
  }
  return rc;
}

template <typename T, int CK>
cudaError_t launch_dv(const T* q, const T* k, const T* v, T* o, float* lse, int n, int lq, int lk,
                      int dk, int dv, cudaStream_t stream) {
  // dv in slices of at most kMaxSlice columns, each padded to 32, 64 or 128
  const int cv = pad_width(cdiv(dv, cdiv(dv, kMaxSlice)));
  if (cv == 32) return launch<T, CK, 32>(q, k, v, o, lse, n, lq, lk, dk, dv, stream);
  if (cv == 64) return launch<T, CK, 64>(q, k, v, o, lse, n, lq, lk, dk, dv, stream);
  return launch<T, CK, 128>(q, k, v, o, lse, n, lq, lk, dk, dv, stream);
}

template <typename T>
int attention(const T* q, const T* k, const T* v, T* o, float* lse, int n, int lq, int lk, int dk,
              int dv, int device, void* stream) {
  if (!valid(n, lq, lk, dk, dv)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ck = pad_width(dk);
  cudaError_t rc;
  if (ck == 32) {
    rc = launch_dv<T, 32>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  } else if (ck == 64) {
    rc = launch_dv<T, 64>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  } else {
    rc = launch_dv<T, 128>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  }
  return static_cast<int>(rc);
}

}  // namespace

// Plain C entry points, bound with ctypes, one per element type: q, k, v
// and o fp32, or bf16; lse (or null) fp32 in both. Device pointers on
// ordinal `device`, contiguous as above. Each launches on `stream` and does
// not synchronise. Returns 0, or the cudaError_t of a refused launch
// (cudaErrorInvalidValue for arguments outside the kernel's contract).
extern "C" int tpugan_sagan_attention_f32(const float* q, const float* k, const float* v,
                                          float* o, float* lse, int n, int lq, int lk, int dk,
                                          int dv, int device, void* stream) {
  return attention(q, k, v, o, lse, n, lq, lk, dk, dv, device, stream);
}

extern "C" int tpugan_sagan_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                           const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                                           int n, int lq, int lk, int dk, int dv, int device,
                                           void* stream) {
  return attention(q, k, v, o, lse, n, lq, lk, dk, dv, device, stream);
}

// Writes the instance (padded dk, slice width, stages) of the last launch
// that either entry point made, {0, 0, 0} before any, into out[3].
extern "C" void tpugan_sagan_attention_last_instance(int* out) {
  for (int i = 0; i < 3; ++i) out[i] = last_instance[i];
}
