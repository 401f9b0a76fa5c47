// SAGAN attention backward (the FlashAttention-2 backward): dq, dk and dv of
// o = softmax(q k^T) v, from q, k, v, the forward's per-row logsumexp lse and
// delta = rowsum(do * o), with p = exp(q k^T - lse) recomputed tile by tile.
// No 1/sqrt(d) scaling, as in the forward.
//
// Replaces the Pallas TPU kernel tpugan/ops/pallas/attention.py::
// sagan_attention_bwd_pallas: its _dq_kernel (pallas_call :149) is
// attention_dq_kernel, its _dkv_kernel (pallas_call :168) is
// attention_dkv_kernel. The caller computes delta, as tpugan does.
//
// Shapes: q [N, Lq, dk], k [N, Lk, dk], v [N, Lk, dv], do [N, Lq, dv],
// lse and delta [N, Lq] (the caller views lse as [N, Lq, 1]); dq, dk, dv
// shaped like q, k, v. All contiguous fp32, any Lq, Lk >= 1, dk <= 128,
// dv <= 256. At BigGAN-256's attention layer N = 2, Lq = 4096, Lk = 1024,
// dk = 64, dv = 256.
//
// Bound: operations. The backward needs s = q k^T, dp = do v^T,
// dv = p^T do, dq = ds k and dk = ds^T q: 2 Lq Lk (3 dk + 2 dv) FLOPs per
// batch item, 11.81 GFLOP at the BigGAN-256 shape against 26 MB of inputs
// and outputs. The products run on the tensor cores in 3xTF32, three TF32
// products for each fp32-accurate one, so the least time is 3 x 11.81 GFLOP
// at the card's dense TF32 rate: 71.6 us on an H100 SXM (495 TFLOP/s).
// This design computes each product once: the dq kernel computes s, dp, p,
// ds and dq, and hands p and ds to the dkv kernel through a scratch buffer
// in device memory (8 bytes per query-key pair, 67 MB at the BigGAN-256
// shape), which adds 134 MB of traffic (40 us at 3.35 TB/s) instead of the
// 5.4 GFLOP that computing s and dp a second time would cost.
//
// Precision: 3xTF32. Every operand x is split into hi, x rounded to TF32 to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding), and
// lo = x - hi, exact in fp32; a b is formed as lo_a hi_b + hi_a lo_b +
// hi_a hi_b with fp32 accumulation. The tensor cores read lo's top 10
// mantissa bits (rounding toward zero) and the dropped lo_a lo_b is about
// 2^-22 of the product. One TF32 product keeps about three digits, which
// does not hold the 2e-4 contract at the path's magnitudes (dk reaches 77).
// exp, the delta subtraction and the masks stay in fp32. The tensor cores
// align and truncate when they add into an accumulator, so no accumulator
// takes a long chain of mma: each 3xTF32 product starts from zero and is
// added to a running sum with an fp32 add that rounds to nearest (add()).
//
// Instructions: all five products are mma.sync.m16n8k8 TF32 (warp-level,
// fragments in registers), not the warpgroup wgmma. Why:
//  * TF32 wgmma reads both shared-memory operands K-major only, with no
//    transpose for 32-bit types. Three B operands lie the other way as the
//    data sit: k for dq = ds k, do for dv = p^T do and q for dk = ds^T q
//    (their contraction runs over rows). mma.sync loads those fragments with
//    32-bit shared-memory reads, so one fp32 copy of a tile serves both
//    orders and no transposed copy is made.
//  * The 3xTF32 split is done in registers as a fragment is loaded, so
//    shared memory holds one fp32 plane of each tile; a wgmma B operand
//    would need its hi and lo planes in shared memory, twice the staged
//    bytes at dv = 256.
//  * s and dp (q k^T, do v^T) could meet wgmma's rules; they stay on
//    mma.sync here so that p and ds come out in the registers of the warp
//    that writes them. Moving them to wgmma is left for later work.
//  The accumulator layout of one product (row g, columns 2t and 2t + 1 of
//  each 8-column tile, g = lane / 4, t = lane % 4) is not the A-fragment
//  layout of the next (columns t and t + 4). Where p or ds feed a product
//  from registers (dq) or through the scratch (dkv), the contraction index
//  is permuted the same way on both operands: the A fragment's k = t is
//  column 2t of the accumulator, k = t + 4 is 2t + 1, and the B fragment
//  reads rows 2t and 2t + 1 of the other operand.
//
// Design (no atomics, so the result does not depend on the order in which
// blocks run):
//  * dq: one block of 8 warps per (batch item, 64 query rows). Q, dO, lse
//    and delta stay in shared memory; tiles of 32 keys of K and V are copied
//    with cp.async into two stages, so the next tile's copy runs under this
//    tile's products. Warp w owns query rows 16 (w % 4) and keys 16 (w / 4)
//    of each tile: s and dp for its 16 x 16 piece (fragments read with
//    ldmatrix), p and ds in registers, ds k into its 16 x dk accumulator,
//    and p and ds to the scratch. The two warps of a row block sum their
//    partials through shared memory in a fixed order at the end.
//  * the scratch holds, for each (batch item, 64 keys, 32 query rows), p^T
//    and then ds^T as [key][slot] with row 8 J + 2u of the tile at slot
//    8 J + u and row 8 J + 2u + 1 at slot 8 J + u + 4: the dkv kernel's A
//    fragments in the permuted order above, 16 KB to copy as it lies. Rows
//    past Lq hold zeros; keys past Lk are not written and feed only rows of
//    dk and dv that are not written either.
//  * dkv: one cluster of 4 blocks of 8 warps per (batch item, 64 keys);
//    block r streams the query tiles r, r + 4, r + 8, ... of 32 rows (Q,
//    dO, p^T and ds^T) through two cp.async stages. A grid of 64-key tiles
//    alone would be 32 blocks at the BigGAN shape, a quarter of the card's
//    SMs; the split makes it 128. Warp w adds p^T do and ds^T q into dv and
//    dk for keys 32 (w % 2) and a quarter (w / 2) of the columns, each B
//    fragment serving two 16-key A fragments. The four partial sums of dk
//    and dv meet in distributed shared memory, and each block adds up 16 of
//    the rows over the cluster in rank order.
//  * shared-memory rows are padded to 4 floats past a multiple of 32, so
//    every fragment read (rows g and columns t, or rows 2t and columns g)
//    hits 32 distinct banks.
//  * the split is three integer and fp32 operations (add half a TF32 ulp
//    to the bits, clear the 13 low bits, subtract); cvt.rna.tf32.f32
//    compiles to a longer sequence on sm_90a. A NaN or inf x gives a NaN lo,
//    so the product is NaN as it should be.
//  Keys past Lk and rows past Lq are copied as zeros, masked out of p, and
//  not written. Shared memory per block: dq 168 KB, dkv 121 KB at the path's
//  widths (201 and 137 KB at dk 128, dv 256), one block of 8 warps per SM.
//  What holds it back: mma.sync and not wgmma, with every B fragment read
//  from shared memory and split beside its three mma; two warps per
//  scheduler to hide the reads' and the mma's latency; and the scratch's
//  round trip through device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kDqRows = 64;    // dq: query rows per block
constexpr int kDqKeys = 32;    // dq: keys per streamed tile
constexpr int kDkvKeys = 64;   // dkv: keys per cluster
constexpr int kDkvRows = 32;   // dkv: query rows per streamed tile
constexpr int kCluster = 4;    // dkv blocks that share one key tile
constexpr int kLdp = kDkvRows + 4;  // dkv's p^T and ds^T planes, [key][slot]
constexpr int kPlane = kDkvKeys * kDkvRows;  // floats of one p^T or ds^T tile of the scratch
constexpr int kMaxDk = 128;
constexpr int kMaxDv = 256;
constexpr int kMaxSharedBytes = 227 * 1024;

// shared floats of each kernel for padded row widths ldk, ldv
__host__ __device__ constexpr int dq_floats(int ldk, int ldv) {
  return kDqRows * (ldk + ldv + 2) + 2 * kDqKeys * (ldk + ldv);
}
__host__ __device__ constexpr int dkv_floats(int ldk, int ldv) {
  return 2 * (kDkvRows * (ldk + ldv) + 2 * kDkvKeys * kLdp);
}
static_assert(sizeof(float) * dq_floats(kMaxDk + 4, kMaxDv + 4) <= kMaxSharedBytes, "dq smem");
static_assert(sizeof(float) * dkv_floats(kMaxDk + 4, kMaxDv + 4) <= kMaxSharedBytes, "dkv smem");

// asynchronous global -> shared copies; an invalid source fills zeros
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + R) of a row-major [len, d] matrix into dst [R][ld], columns
// [0, CW): zeros past row len and past column d. 16-byte copies when vec4
// (d % 4 == 0 and a 16-byte aligned matrix).
template <int NTH, int R, int CW>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src, int r0, int len,
                                          int d, bool vec4, int t) {
  const int rn = min(R, len - r0);
  const float* base = src + static_cast<int64_t>(r0) * d;
  if (vec4) {
    constexpr int kv = CW / 4;
    for (int i = t; i < R * kv; i += NTH) {
      const int r = i / kv, c = (i - r * kv) * 4;
      const bool ok = r < rn && c < d;
      copy16(dst + r * ld + c, ok ? base + static_cast<int64_t>(r) * d + c : src, ok);
    }
  } else {
    for (int i = t; i < R * CW; i += NTH) {
      const int r = i / CW, c = i - r * CW;
      const bool ok = r < rn && c < d;
      copy4(dst + r * ld + c, ok ? base + static_cast<int64_t>(r) * d + c : src, ok);
    }
  }
}

// entries [r0, r0 + R) of a length-len row vector (lse, delta)
template <int NTH, int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int r0, int len, int t) {
  for (int i = t; i < R; i += NTH) {
    const bool ok = r0 + i < len;
    copy4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// ---- 3xTF32 fragments -------------------------------------------------------

// x = hi + lo for the tensor cores: hi is x rounded to TF32 (10 mantissa
// bits) to nearest with ties away from zero, as cvt.rna.tf32.f32 rounds, by
// adding half a TF32 ulp to the magnitude and clearing the 13 low bits; lo =
// x - hi is exact in fp32 and goes to the tensor cores as it is, which read
// its top 10 mantissa bits (rounding toward zero). Three integer and fp32
// operations, where cvt.rna.tf32.f32 compiles to a longer sequence. A NaN x
// gives a NaN lo, so a NaN still reaches the product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 tensor-core product with fp32 accumulation.
// volatile: the compiler must not move it into code that only some lanes of
// the warp run (mma.sync.aligned needs every lane).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {  // 16 x 8: rows g, g + 8 and columns t, t + 4 as a0 (g, t), a1 (g + 8, t), a2, a3
  uint32_t hi[4], lo[4];
};
struct FragB {  // 8 x 8: b0 (k t, n g), b1 (k t + 4, n g)
  uint32_t hi[2], lo[2];
};

// Fragments are read from shared memory as fp32 into registers first, all of
// a step's reads together, and split afterwards, so that the reads' latency
// is paid once per step and not once per product.

// A from a row-major tile a[m][k] at p[m * ld + k]
__device__ __forceinline__ void ld_a(float (&r)[4], const float* p, int ld, int g, int t) {
  r[0] = p[g * ld + t];
  r[1] = p[(g + 8) * ld + t];
  r[2] = p[g * ld + t + 4];
  r[3] = p[(g + 8) * ld + t + 4];
}

// B from a tile stored k-major in the permuted order of make_a: k = t at
// row 2t and k = t + 4 at row 2t + 1, b[.][n] at column n
__device__ __forceinline__ void ld_b_kn(float (&r)[2], const float* p, int ld, int g, int t) {
  r[0] = p[2 * t * ld + g];
  r[1] = p[(2 * t + 1) * ld + g];
}

__device__ __forceinline__ void make_a(FragA& f, const float (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(r[e], f.hi[e], f.lo[e]);
}
__device__ __forceinline__ void make_b(FragB& f, const float (&r)[2]) {
  split(r[0], f.hi[0], f.lo[0]);
  split(r[1], f.hi[1], f.lo[1]);
}

// A from an accumulator fragment c (rows g, g + 8; columns 2t, 2t + 1), with
// k = t taken from column 2t and k = t + 4 from column 2t + 1
__device__ __forceinline__ void make_a_acc(FragA& f, const float (&c)[4]) {
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
}

// acc += d with fp32 adds that round to nearest. The tensor cores align and
// truncate when they add into an accumulator, so a long chain of mma into
// one accumulator drifts past the 2e-4 contract at the path's widths: each
// chain starts from zero and is short, and the running sums are kept outside
// the tensor cores.
__device__ __forceinline__ void add(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Four 8 x 8 matrices of 16-bit values from shared memory, one per register:
// with fp32 data, four 8-row x 4-column fp32 matrices, lane l getting
// element (l / 4, l % 4) of each. Lane l gives the address of row l % 8 of
// matrix l / 8; rows are 16 bytes, 16-byte aligned.
__device__ __forceinline__ void ldsm4(float (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint32_t x[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(a));
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = __uint_as_float(x[e]);
}

// s[j] = a b^T for rows [0, 16) of a and rows [8 j, 8 j + 8) of b, j < 2,
// over KD columns (both row-major, zero past their width; KD a multiple of
// 16): s[j] is an accumulator fragment, rows g and g + 8 of a, rows 8 j + 2t
// and 8 j + 2t + 1 of b. Each step of 8 columns reads A's fragment with one
// ldmatrix (matrices: rows 0-7 and 8-15 at columns 0-3, then at 4-7) and
// both B fragments with another (rows 0-7 at columns 0-3 and 4-7, then rows
// 8-15); the next 16 columns' reads are in flight under this step's
// products. The hi hi products of 16 columns are added to the sum by add();
// the two corrections, 2^-11 of it, sum in tensor-core accumulators of their
// own.
template <int KD>
__device__ __forceinline__ void scores(float (&s)[2][4], const float* a, int lda, const float* b,
                                       int ldb, int lane) {
  const int mi = lane >> 3, ri = lane & 7;
  const float* pa = a + (ri + (mi & 1) * 8) * lda + (mi >> 1) * 4;
  const float* pb = b + (ri + (mi >> 1) * 8) * ldb + (mi & 1) * 4;
  float big[2][4] = {}, c1[2][4] = {}, c2[2][4] = {};
  float ra[2][4], rb[2][4];
  auto fetch = [&](int kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ldsm4(ra[h], pa + kk + 8 * h);
      ldsm4(rb[h], pb + kk + 8 * h);
    }
  };
  fetch(0);
#pragma unroll 4
  for (int kk = 0; kk < KD; kk += 16) {
    FragA fa[2];
    FragB fb[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      make_a(fa[h], ra[h]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float r2[2] = {rb[h][2 * j], rb[h][2 * j + 1]};
        make_b(fb[h][j], r2);
      }
    }
    if (kk + 16 < KD) fetch(kk + 16);
    // independent chains side by side: each mma waits on one four steps back
    float d[2][4] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2; ++j) mma(c1[j], fa[h].lo, fb[h][j].hi[0], fb[h][j].hi[1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma(c2[j], fa[h].hi, fb[h][j].lo[0], fb[h][j].lo[1]);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma(d[j], fa[h].hi, fb[h][j].hi[0], fb[h][j].hi[1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) add(big[j], d[j]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = big[j][e] + (c1[j][e] + c2[j][e]);
}

// d[m][i] += a[m] b[i] in 3xTF32 for 2 x G independent products, issued
// side by side (all lo hi, then all hi lo, then all hi hi) so that no mma
// waits on the one before it
template <int G>
__device__ __forceinline__ void mma3_grid(float (&d)[2][G][4], const FragA (&a)[2],
                                          const FragB (&b)[G]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i) mma(d[m][i], a[m].lo, b[i].hi[0], b[i].hi[1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i) mma(d[m][i], a[m].hi, b[i].lo[0], b[i].lo[1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < G; ++i) mma(d[m][i], a[m].hi, b[i].hi[0], b[i].hi[1]);
}

// ---- kernels ----------------------------------------------------------------

template <int CK, int CV>
__global__ void __launch_bounds__(kThreads, 1)
attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ dout,
                    float* __restrict__ dq, float* __restrict__ pds, int lq, int lk, int dk,
                    int dv, int k_vec4, int v_vec4) {
  constexpr int LDK = CK + 4, LDV = CV + 4, NT = CK / 8;
  constexpr int SF = kDqKeys * (LDK + LDV);  // one stage: K, V
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                     // [kDqRows][LDK]
  float* dos = qs + kDqRows * LDK;      // [kDqRows][LDV]
  float* ls = dos + kDqRows * LDV;      // [kDqRows]
  float* des = ls + kDqRows;            // [kDqRows]
  float* stage0 = des + kDqRows;        // 2 x (K [kDqKeys][LDK], V [kDqKeys][LDV])

  const int t = threadIdx.x, w = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const int r0 = (w & 3) * 16;   // this warp's query rows
  const int c0 = (w >> 2) * 16;  // and keys of each tile
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kDqRows;
  const int nqt = (lq + kDkvRows - 1) / kDkvRows, nkb = (lk + kDkvKeys - 1) / kDkvKeys;
  float* pdb = pds + static_cast<int64_t>(b) * nkb * nqt * 2 * kPlane;
  const float* kb = k + static_cast<int64_t>(b) * lk * dk;
  const float* vb = v + static_cast<int64_t>(b) * lk * dv;

  const float* qb = q + static_cast<int64_t>(b) * lq * dk;
  const float* dob = dout + static_cast<int64_t>(b) * lq * dv;
  copy_tile<kThreads, kDqRows, CK>(qs, LDK, qb, q0, lq, dk, k_vec4, t);
  copy_tile<kThreads, kDqRows, CV>(dos, LDV, dob, q0, lq, dv, v_vec4, t);
  copy_rows<kThreads, kDqRows>(ls, lse + static_cast<int64_t>(b) * lq, q0, lq, t);
  copy_rows<kThreads, kDqRows>(des, delta + static_cast<int64_t>(b) * lq, q0, lq, t);
  copy_commit();

  auto issue = [&](int tile, int st) {
    float* ks = stage0 + st * SF;
    copy_tile<kThreads, kDqKeys, CK>(ks, LDK, kb, tile * kDqKeys, lk, dk, k_vec4, t);
    copy_tile<kThreads, kDqKeys, CV>(ks + kDqKeys * LDK, LDV, vb, tile * kDqKeys, lk, dv, v_vec4,
                                     t);
    copy_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int ntiles = (lk + kDqKeys - 1) / kDqKeys;
  issue(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const int kn = min(kDqKeys, lk - it * kDqKeys);
    __syncthreads();  // the stage about to be refilled is free
    if (it + 1 < ntiles) {
      issue(it + 1, st ^ 1);
      copy_wait<1>();  // this tile's copies (and the resident ones) are done
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* ks = stage0 + st * SF;
    const float* vs = ks + kDqKeys * LDK;

    float s[2][4], dp[2][4];
    scores<CK>(s, qs + r0 * LDK, LDK, ks + c0 * LDK, LDK, t & 31);
    scores<CV>(dp, dos + r0 * LDV, LDV, vs + c0 * LDV, LDV, t & 31);
    FragA a[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >> 1) * 8;
        const int key = c0 + 8 * j + 2 * tg + (e & 1);
        const float ex = expf(s[j][e] - ls[row]);  // no branch: every lane reaches the mma
        const int qq = q0 + row, kk = it * kDqKeys + key;
        const float p = key < kn && qq < lq ? ex : 0.f;
        dp[j][e] = p * (dp[j][e] - des[row]);  // ds
        // p and ds to the scratch tile (kk / 64, qq / 32) as the dkv kernel
        // reads them: [key][slot], row 8 J + 2u of the tile at slot 8 J + u,
        // 8 J + 2u + 1 at 8 J + u + 4 (make_a_acc's order)
        if (qq < nqt * kDkvRows) {
          const int64_t at_tile = static_cast<int64_t>(kk / kDkvKeys) * nqt + qq / kDkvRows;
          float* tile = pdb + at_tile * 2 * kPlane;
          const int at = (kk % kDkvKeys) * kDkvRows + (qq & 24) + (g >> 1) + 4 * (g & 1);
          tile[at] = p;
          tile[kPlane + at] = dp[j][e];
        }
      }
      make_a_acc(a[j], dp[j]);
    }
    // dq += ds k over this tile's 16 keys of the warp, 4 column tiles a step
#pragma unroll
    for (int c = 0; c < NT; c += 4) {
      float rb[4][2][2];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ld_b_kn(rb[n][j], ks + (c0 + 8 * j) * LDK + 8 * (c + n), LDK, g, tg);
      float d[4][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB f[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) make_b(f[n], rb[n][j]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma(d[n], a[j].lo, f[n].hi[0], f[n].hi[1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma(d[n], a[j].hi, f[n].lo[0], f[n].lo[1]);
#pragma unroll
        for (int n = 0; n < 4; ++n) mma(d[n], a[j].hi, f[n].hi[0], f[n].hi[1]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) add(acc[c + n], d[n]);
    }
  }

  // the two key halves: warps 4-7 hand their sums to warps 0-3
  copy_wait<0>();
  __syncthreads();
  float* red = stage0;  // [kDqRows][CK]
  if (w >= 4) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(r0 + g + (e >> 1) * 8) * CK + 8 * n + 2 * tg + (e & 1)] = acc[n][e];
  }
  __syncthreads();
  if (w < 4) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >> 1) * 8, col = 8 * n + 2 * tg + (e & 1);
        if (q0 + row < lq && col < dk)
          dq[(static_cast<int64_t>(b) * lq + q0 + row) * dk + col] =
              acc[n][e] + red[row * CK + col];
      }
  }
}

template <int CK, int CV>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                     const float* __restrict__ pds, float* __restrict__ dk_out,
                     float* __restrict__ dv_out, int lq, int lk, int dk, int dv, int k_vec4,
                     int v_vec4) {
  constexpr int LDK = CK + 4, LDV = CV + 4;
  constexpr int QK = CK / 4, QV = CV / 4;  // each warp's quarter of the dk and dv columns
  constexpr int NK = QK / 8, NV = QV / 8;
  // one stage: Q [kDkvRows][LDK], dO [kDkvRows][LDV], p^T and ds^T [kDkvKeys][kLdp]
  constexpr int SF = kDkvRows * (LDK + LDV) + 2 * kDkvKeys * kLdp;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, w = t >> 5, g = (t & 31) >> 2, tg = t & 3;
  const int m0 = (w & 1) * 32;  // this warp's 32 keys
  const int cq = w >> 1;        // and quarter of the columns
  const int j0 = blockIdx.y * kDkvKeys;
  const int b = blockIdx.z;
  const int kn = min(kDkvKeys, lk - j0);
  const int nqt = (lq + kDkvRows - 1) / kDkvRows;
  const float* qb = q + static_cast<int64_t>(b) * lq * dk;
  const float* dob = dout + static_cast<int64_t>(b) * lq * dv;
  const float* pdb = pds + (static_cast<int64_t>(b) * gridDim.y + blockIdx.y) * nqt * 2 * kPlane;

  auto issue = [&](int tile, int st) {
    float* qs = smem + st * SF;
    float* dos = qs + kDkvRows * LDK;
    float* pt = dos + kDkvRows * LDV;
    copy_tile<kThreads, kDkvRows, CK>(qs, LDK, qb, tile * kDkvRows, lq, dk, k_vec4, t);
    copy_tile<kThreads, kDkvRows, CV>(dos, LDV, dob, tile * kDkvRows, lq, dv, v_vec4, t);
    // p^T and ds^T: 2 x kDkvKeys rows of kDkvRows floats, contiguous in the scratch
    const float* from = pdb + static_cast<int64_t>(tile) * 2 * kPlane;
    copy_tile<kThreads, 2 * kDkvKeys, kDkvRows>(pt, kLdp, from, 0, 2 * kDkvKeys, kDkvRows, true, t);
    copy_commit();
  };

  float acc_k[2][NK][4], acc_v[2][NV][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[m][n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_v[m][n][e] = 0.f;
  }

  // this block's query tiles: rank, rank + kCluster, ...
  const int mine = rank < nqt ? (nqt - rank + kCluster - 1) / kCluster : 0;
  if (mine > 0) issue(rank, 0);
  for (int it = 0; it < mine; ++it) {
    const int st = it & 1;
    __syncthreads();  // the stage about to be refilled is free
    if (it + 1 < mine) {
      issue(rank + (it + 1) * kCluster, st ^ 1);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const float* qs = smem + st * SF;
    const float* dos = qs + kDkvRows * LDK;
    const float* pt = dos + kDkvRows * LDV;  // p^T, then ds^T

    // dv += p^T do and dk += ds^T q for keys [m0, m0 + 32), column quarter
    // cq; each B fragment serves both 16-key halves, and each chain on the
    // tensor cores covers two steps of 8 rows before add()
#pragma unroll 1
    for (int jp = 0; jp < kDkvRows / 8; jp += 2) {
      FragA ap[2][2], ad[2][2];
#pragma unroll
      for (int js = 0; js < 2; ++js)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float r[2][4];
#pragma unroll
          for (int x = 0; x < 2; ++x)
            ld_a(r[x], pt + (x * kDkvKeys + m0 + 16 * m) * kLdp + 8 * (jp + js), kLdp, g, tg);
          make_a(ap[js][m], r[0]);
          make_a(ad[js][m], r[1]);
        }
      constexpr int GV = NV < 2 ? NV : 2;
#pragma unroll
      for (int h = 0; h < NV; h += GV) {
        float rv[2][GV][2];
#pragma unroll
        for (int js = 0; js < 2; ++js)
#pragma unroll
          for (int i = 0; i < GV; ++i)
            ld_b_kn(rv[js][i], dos + 8 * (jp + js) * LDV + cq * QV + 8 * (h + i), LDV, g, tg);
        float d[2][GV][4] = {};
#pragma unroll
        for (int js = 0; js < 2; ++js) {
          FragB f[GV];
#pragma unroll
          for (int i = 0; i < GV; ++i) make_b(f[i], rv[js][i]);
          mma3_grid(d, ap[js], f);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < GV; ++i) add(acc_v[m][h + i], d[m][i]);
      }
      constexpr int GK = NK < 2 ? NK : 2;
#pragma unroll
      for (int h = 0; h < NK; h += GK) {
        float rk[2][GK][2];
#pragma unroll
        for (int js = 0; js < 2; ++js)
#pragma unroll
          for (int i = 0; i < GK; ++i)
            ld_b_kn(rk[js][i], qs + 8 * (jp + js) * LDK + cq * QK + 8 * (h + i), LDK, g, tg);
        float d[2][GK][4] = {};
#pragma unroll
        for (int js = 0; js < 2; ++js) {
          FragB f[GK];
#pragma unroll
          for (int i = 0; i < GK; ++i) make_b(f[i], rk[js][i]);
          mma3_grid(d, ad[js], f);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < GK; ++i) add(acc_k[m][h + i], d[m][i]);
      }
    }
  }

  // the partial sums to shared memory: dk [kDkvKeys][CK], then dv [kDkvKeys][CV]
  copy_wait<0>();
  __syncthreads();
  float* red_k = smem;
  float* red_v = smem + kDkvKeys * CK;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = m0 + 16 * m + g + (e >> 1) * 8, col = 2 * tg + (e & 1);
#pragma unroll
      for (int n = 0; n < NK; ++n) red_k[key * CK + cq * QK + 8 * n + col] = acc_k[m][n][e];
#pragma unroll
      for (int n = 0; n < NV; ++n) red_v[key * CV + cq * QV + 8 * n + col] = acc_v[m][n][e];
    }
  cluster.sync();

  // this block adds up rows [rank * kRows, (rank + 1) * kRows) over the
  // cluster's blocks, in rank order
  constexpr int kRows = kDkvKeys / kCluster;
  const float* parts_k[kCluster];
  const float* parts_v[kCluster];
#pragma unroll
  for (int c = 0; c < kCluster; ++c) {
    parts_k[c] = cluster.map_shared_rank(red_k, c);
    parts_v[c] = cluster.map_shared_rank(red_v, c);
  }
  for (int i = t; i < kRows * CK; i += kThreads) {
    const int r = rank * kRows + i / CK, col = i % CK;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) sum += parts_k[c][r * CK + col];
    if (r < kn && col < dk) dk_out[(static_cast<int64_t>(b) * lk + j0 + r) * dk + col] = sum;
  }
  for (int i = t; i < kRows * CV; i += kThreads) {
    const int r = rank * kRows + i / CV, col = i % CV;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kCluster; ++c) sum += parts_v[c][r * CV + col];
    if (r < kn && col < dv) dv_out[(static_cast<int64_t>(b) * lk + j0 + r) * dv + col] = sum;
  }
  cluster.sync();  // no block leaves while the others still read its shared memory
}

struct Args {
  const float *q, *k, *v, *lse, *delta, *dout;
  float *dq, *dk, *dv, *pds;
  int n, lq, lk, dkd, dvd, k_vec4, v_vec4;
  cudaStream_t stream;
};

template <int CK, int CV>
cudaError_t launch_dq(const Args& a) {
  constexpr int bytes = static_cast<int>(sizeof(float)) * dq_floats(CK + 4, CV + 4);
  const cudaError_t set = cudaFuncSetAttribute(attention_dq_kernel<CK, CV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid((a.lq + kDqRows - 1) / kDqRows, a.n);
  attention_dq_kernel<CK, CV><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.lse, a.delta, a.dout, a.dq, a.pds, a.lq, a.lk, a.dkd, a.dvd, a.k_vec4,
      a.v_vec4);
  return cudaGetLastError();
}

template <int CK, int CV>
cudaError_t launch_dkv(const Args& a) {
  constexpr int bytes = static_cast<int>(sizeof(float)) * dkv_floats(CK + 4, CV + 4);
  const cudaError_t set = cudaFuncSetAttribute(attention_dkv_kernel<CK, CV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid(kCluster, (a.lk + kDkvKeys - 1) / kDkvKeys, a.n);
  attention_dkv_kernel<CK, CV><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.dout, a.pds, a.dk, a.dv, a.lq, a.lk, a.dkd, a.dvd, a.k_vec4, a.v_vec4);
  return cudaGetLastError();
}

template <int CK, int CV>
cudaError_t launch_widths(const Args& a, bool dkv) {
  return dkv ? launch_dkv<CK, CV>(a) : launch_dq<CK, CV>(a);
}

template <int CK>
cudaError_t launch_dv(const Args& a, bool dkv) {
  if (a.dvd <= 64) return launch_widths<CK, 64>(a, dkv);
  if (a.dvd <= 128) return launch_widths<CK, 128>(a, dkv);
  return launch_widths<CK, 256>(a, dkv);
}

int launch(Args a, int device, bool dkv) {
  if (a.n < 1 || a.n > 65535 || a.lq < 1 || a.lk < 1 || (a.lk + kDkvKeys - 1) / kDkvKeys > 65535 ||
      a.dkd < 1 || a.dkd > kMaxDk || a.dvd < 1 || a.dvd > kMaxDv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // 16-byte copies need rows that start on 16-byte boundaries
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.k_vec4 = a.dkd % 4 == 0 && aligned(a.q) && aligned(a.k);
  a.v_vec4 = a.dvd % 4 == 0 && aligned(a.v) && aligned(a.dout);
  const cudaError_t rc = a.dkd <= 64 ? launch_dv<64>(a, dkv) : launch_dv<128>(a, dkv);
  return static_cast<int>(rc);
}

}  // namespace

// Plain C entry points, bound with ctypes: one per kernel. Pointers are
// device pointers on ordinal `device`, contiguous fp32 as above. Each
// launches on `stream` and does not synchronise. Returns 0, or the
// cudaError_t of a refused launch (cudaErrorInvalidValue for arguments
// outside the kernels' contract).
extern "C" int tpugan_sagan_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                                                 const float* lse, const float* delta,
                                                 const float* dout, float* dq, float* pds, int n,
                                                 int lq, int lk, int dk, int dv, int device,
                                                 void* stream) {
  const Args a{q,  k,  v,  lse, delta, dout, dq, nullptr, nullptr, pds,
               n,  lq, lk, dk,  dv,    0,    0,  static_cast<cudaStream_t>(stream)};
  return launch(a, device, false);
}

extern "C" int tpugan_sagan_attention_bwd_dkv_f32(const float* q, const float* dout,
                                                  const float* pds, float* dk_out, float* dv_out,
                                                  int n, int lq, int lk, int dk, int dv,
                                                  int device, void* stream) {
  const Args a{q, nullptr, nullptr, nullptr, nullptr, dout, nullptr, dk_out, dv_out,
               const_cast<float*>(pds), n, lq, lk, dk, dv, 0, 0,
               static_cast<cudaStream_t>(stream)};
  return launch(a, device, true);
}
