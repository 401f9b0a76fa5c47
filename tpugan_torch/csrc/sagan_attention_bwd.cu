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
// and outputs. This design does more: the dq kernel computes s, dp and dq,
// the dkv kernel s and dp again, then dv and dk, so 2 Lq Lk (4 dk + 3 dv)
// FLOPs, 17.18 GFLOP. Neither the scores nor p reach device memory.
//
// Design (plain fp32 FMAs, no TF32 and no tensor cores, as the Pallas
// kernels compute in fp32; no atomics, so the result does not depend on the
// order in which blocks run):
//  * dq: one block of 256 threads per (batch item, tile of 32 query rows).
//    Q, dO, lse and delta stay in shared memory; tiles of 64 keys of K and V
//    are copied with cp.async into one of two stages, so the next tile's
//    copy runs under this tile's arithmetic (one stage where two do not fit).
//  * dkv: one cluster of 4 blocks per (batch item, tile of 64 keys). K and V
//    stay in shared memory; block r of the cluster streams the query tiles
//    r, r + 4, r + 8, ... through two stages. A grid of 64-key tiles alone
//    would be 32 blocks at the BigGAN shape, a quarter of the card's SMs;
//    the split makes it 128. The four partial sums of dk and dv meet in
//    distributed shared memory, and each block adds up a quarter of the rows
//    over the cluster in rank order.
//  * per tile each thread computes a 2 x 4 piece of s and of dp with float4
//    reads along the head dimension. Rows are padded by 4 floats and a
//    thread's 4 keys are 16 apart, so neighbouring threads read neighbouring
//    rows in different banks. p = exp(s - lse) and ds = p (dp - delta) go to
//    shared memory (dq: ds transposed; dkv: p and ds);
//  * the accumulations are register tiles: dq's 4 rows x NCK * 32 columns
//    per warp, dkv's 8 keys x (NCK + NC) * 32 columns per warp, a lane
//    holding NCK (and NC) columns, read from shared memory as float2/float4.
//  Keys past Lk and rows past Lq are copied as zeros, masked out of p, and
//  not written. Left for later work: TF32 or bf16 tensor-core products
//  (wgmma), and more blocks per SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kCluster = 4;    // dkv blocks that share one key tile
constexpr int kLdt = kBQ + 4;  // dq's transposed ds tile, [key][query]
constexpr int kLdp = kBK + 4;  // dkv's p and ds tiles, [query][key]
constexpr int kMaxDk = 128;
constexpr int kMaxDv = 256;
constexpr int kMaxSharedBytes = 227 * 1024;

// shared floats of each kernel for padded row widths ldk, ldv
__host__ __device__ constexpr int dq_floats(int ldk, int ldv, int stages) {
  return kBQ * (ldk + ldv + 2) + stages * kBK * (ldk + ldv) + kBK * kLdt;
}
__host__ __device__ constexpr int dkv_floats(int ldk, int ldv, int stages) {
  return kBK * (ldk + ldv) + stages * kBQ * (ldk + ldv + 2) + 2 * kBQ * kLdp;
}

template <int W>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* out) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

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
template <int R, int CW>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src, int r0, int len,
                                          int d, bool vec4, int t) {
  const int rn = min(R, len - r0);
  const float* base = src + static_cast<int64_t>(r0) * d;
  if (vec4) {
    constexpr int kv = CW / 4;
    for (int i = t; i < R * kv; i += kThreads) {
      const int r = i / kv, c = (i - r * kv) * 4;
      const bool ok = r < rn && c < d;
      copy16(dst + r * ld + c, ok ? base + static_cast<int64_t>(r) * d + c : src, ok);
    }
  } else {
    for (int i = t; i < R * CW; i += kThreads) {
      const int r = i / CW, c = i - r * CW;
      const bool ok = r < rn && c < d;
      copy4(dst + r * ld + c, ok ? base + static_cast<int64_t>(r) * d + c : src, ok);
    }
  }
}

// entries [r0, r0 + kBQ) of a length-len row vector (lse, delta)
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int r0, int len, int t) {
  for (int i = t; i < kBQ; i += kThreads) {
    const bool ok = r0 + i < len;
    copy4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// s[i][j] = sum over d < n of a[ra + i][d] * b[kc + 16 j][d], for i < 2 and
// j < 4; rows of a and b zero-padded to a multiple of 4 columns
__device__ __forceinline__ void tile_dot(const float* a, int lda, const float* b, int ldb, int n,
                                         int ra, int kc, float (&s)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  const float* a0 = a + ra * lda;
  const float* b0 = b + kc * ldb;
#pragma unroll 2
  for (int d = 0; d < n; d += 4) {
    float4 x[2], y[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) x[i] = *reinterpret_cast<const float4*>(a0 + i * lda + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = *reinterpret_cast<const float4*>(b0 + 16 * j * ldb + d);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

template <int NCK, int NC, int STAGES>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ dout,
                    float* __restrict__ dq, int lq, int lk, int dk, int dv, int k_vec4,
                    int v_vec4) {
  constexpr int CK = NCK * 32, CV = NC * 32, LDK = CK + 4, LDV = CV + 4;
  constexpr int W = NCK >= 4 ? 4 : NCK;
  constexpr int G = NCK / W;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                    // [kBQ][LDK]
  float* dos = qs + kBQ * LDK;         // [kBQ][LDV]
  float* ls = dos + kBQ * LDV;         // [kBQ]
  float* des = ls + kBQ;               // [kBQ]
  float* stage0 = des + kBQ;           // STAGES x (K [kBK][LDK], V [kBK][LDV])
  float* dst = stage0 + STAGES * kBK * (LDK + LDV);  // ds transposed, [kBK][kLdt]

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* kb = k + static_cast<int64_t>(b) * lk * dk;
  const float* vb = v + static_cast<int64_t>(b) * lk * dv;

  copy_tile<kBQ, CK>(qs, LDK, q + static_cast<int64_t>(b) * lq * dk, q0, lq, dk, k_vec4, t);
  copy_tile<kBQ, CV>(dos, LDV, dout + static_cast<int64_t>(b) * lq * dv, q0, lq, dv, v_vec4, t);
  copy_rows(ls, lse + static_cast<int64_t>(b) * lq, q0, lq, t);
  copy_rows(des, delta + static_cast<int64_t>(b) * lq, q0, lq, t);
  copy_commit();

  auto issue = [&](int tile, int st) {
    float* ks = stage0 + st * kBK * (LDK + LDV);
    copy_tile<kBK, CK>(ks, LDK, kb, tile * kBK, lk, dk, k_vec4, t);
    copy_tile<kBK, CV>(ks + kBK * LDK, LDV, vb, tile * kBK, lk, dv, v_vec4, t);
    copy_commit();
  };

  const int sr = (t >> 4) * 2, kc = t & 15;  // this thread's 2 x 4 piece of s and dp
  const int tx = t & 31, rw = (t >> 5) * 4;  // and its 4 rows x NCK columns of dq
  float acc[4][NCK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NCK; ++c) acc[i][c] = 0.f;

  const int ntiles = (lk + kBK - 1) / kBK;
  if (STAGES == 2) issue(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = STAGES == 2 ? (it & 1) : 0;
    const int kn = min(kBK, lk - it * kBK);
    __syncthreads();  // the stage about to be refilled and dst are free
    if (STAGES == 2) {
      if (it + 1 < ntiles) {
        issue(it + 1, st ^ 1);
        copy_wait<1>();  // this tile's copies (and the resident ones) are done
      } else {
        copy_wait<0>();
      }
    } else {
      issue(it, 0);
      copy_wait<0>();
    }
    __syncthreads();
    const float* ks = stage0 + st * kBK * (LDK + LDV);
    const float* vs = ks + kBK * LDK;

    float s[2][4], dp[2][4];
    tile_dot(qs, LDK, ks, LDK, dk, sr, kc, s);
    tile_dot(dos, LDV, vs, LDV, dv, sr, kc, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = kc + 16 * j;
      float ds[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p = key < kn ? expf(s[i][j] - ls[sr + i]) : 0.f;
        ds[i] = p * (dp[i][j] - des[sr + i]);
      }
      *reinterpret_cast<float2*>(dst + key * kLdt + sr) = make_float2(ds[0], ds[1]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(dst + j * kLdt + rw);
      const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
      float kv[NCK];
#pragma unroll
      for (int g = 0; g < G; ++g) Vec<W>::load(ks + j * LDK + g * 32 * W + W * tx, kv + g * W);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NCK; ++c) acc[i][c] = fmaf(dv4[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rw + i;
    if (r >= lq) continue;
    float* row = dq + (static_cast<int64_t>(b) * lq + r) * dk;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int col = g * 32 * W + W * tx + e;
        if (col < dk) row[col] = acc[i][g * W + e];
      }
  }
}

template <int NCK, int NC, int STAGES>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
attention_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ dout,
                     float* __restrict__ dk_out, float* __restrict__ dv_out, int lq, int lk,
                     int dk, int dv, int k_vec4, int v_vec4) {
  constexpr int CK = NCK * 32, CV = NC * 32, LDK = CK + 4, LDV = CV + 4;
  constexpr int WK = NCK >= 4 ? 4 : NCK, GK = NCK / WK;
  constexpr int WV = NC >= 4 ? 4 : NC, GV = NC / WV;
  constexpr int SF = kBQ * (LDK + LDV + 2);  // one stage: Q, dO, lse, delta
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                     // [kBK][LDK]
  float* vs = ks + kBK * LDK;           // [kBK][LDV]
  float* stage0 = vs + kBK * LDV;       // STAGES x SF
  float* ps = stage0 + STAGES * SF;     // p, [kBQ][kLdp]
  float* dss = ps + kBQ * kLdp;         // ds, [kBQ][kLdp]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int j0 = blockIdx.y * kBK;
  const int b = blockIdx.z;
  const int kn = min(kBK, lk - j0);
  const float* qb = q + static_cast<int64_t>(b) * lq * dk;
  const float* dob = dout + static_cast<int64_t>(b) * lq * dv;
  const float* lb = lse + static_cast<int64_t>(b) * lq;
  const float* deb = delta + static_cast<int64_t>(b) * lq;

  copy_tile<kBK, CK>(ks, LDK, k + static_cast<int64_t>(b) * lk * dk, j0, lk, dk, k_vec4, t);
  copy_tile<kBK, CV>(vs, LDV, v + static_cast<int64_t>(b) * lk * dv, j0, lk, dv, v_vec4, t);
  copy_commit();

  auto issue = [&](int tile, int st) {
    float* qs = stage0 + st * SF;
    float* dos = qs + kBQ * LDK;
    float* ls = dos + kBQ * LDV;
    copy_tile<kBQ, CK>(qs, LDK, qb, tile * kBQ, lq, dk, k_vec4, t);
    copy_tile<kBQ, CV>(dos, LDV, dob, tile * kBQ, lq, dv, v_vec4, t);
    copy_rows(ls, lb, tile * kBQ, lq, t);
    copy_rows(ls + kBQ, deb, tile * kBQ, lq, t);
    copy_commit();
  };

  const int sr = (t >> 4) * 2, kc = t & 15;  // this thread's 2 x 4 piece of s and dp
  const int tx = t & 31, kw = (t >> 5) * 8;  // and its 8 keys x (NCK + NC) columns of dk, dv
  float acc_k[8][NCK], acc_v[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < NCK; ++c) acc_k[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_v[i][c] = 0.f;
  }

  // this block's query tiles: rank, rank + kCluster, ...
  const int nq = (lq + kBQ - 1) / kBQ;
  const int mine = rank < nq ? (nq - rank + kCluster - 1) / kCluster : 0;
  if (STAGES == 2 && mine > 0) issue(rank, 0);
  for (int it = 0; it < mine; ++it) {
    const int tile = rank + it * kCluster;
    const int st = STAGES == 2 ? (it & 1) : 0;
    const int qn = min(kBQ, lq - tile * kBQ);
    __syncthreads();  // the stage about to be refilled, ps and dss are free
    if (STAGES == 2) {
      if (it + 1 < mine) {
        issue(tile + kCluster, st ^ 1);
        copy_wait<1>();
      } else {
        copy_wait<0>();
      }
    } else {
      issue(tile, 0);
      copy_wait<0>();
    }
    __syncthreads();
    const float* qs = stage0 + st * SF;
    const float* dos = qs + kBQ * LDK;
    const float* ls = dos + kBQ * LDV;
    const float* des = ls + kBQ;

    float s[2][4], dp[2][4];
    tile_dot(qs, LDK, ks, LDK, dk, sr, kc, s);
    tile_dot(dos, LDV, vs, LDV, dv, sr, kc, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool row_ok = sr + i < qn;
      const float m = ls[sr + i], de = des[sr + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kc + 16 * j;
        const float p = row_ok && key < kn ? expf(s[i][j] - m) : 0.f;
        ps[(sr + i) * kLdp + key] = p;
        dss[(sr + i) * kLdp + key] = p * (dp[i][j] - de);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < qn; ++r) {
      const float4 p0 = *reinterpret_cast<const float4*>(ps + r * kLdp + kw);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + r * kLdp + kw + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(dss + r * kLdp + kw);
      const float4 d1 = *reinterpret_cast<const float4*>(dss + r * kLdp + kw + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float dv8[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      float ov[NC], qv[NCK];
#pragma unroll
      for (int g = 0; g < GV; ++g) Vec<WV>::load(dos + r * LDV + g * 32 * WV + WV * tx, ov + g * WV);
#pragma unroll
      for (int g = 0; g < GK; ++g) Vec<WK>::load(qs + r * LDK + g * 32 * WK + WK * tx, qv + g * WK);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
#pragma unroll
        for (int c = 0; c < NCK; ++c) acc_k[i][c] = fmaf(dv8[i], qv[c], acc_k[i][c]);
      }
    }
  }

  // the partial sums to shared memory: dk [kBK][CK], then dv [kBK][CV]
  copy_wait<0>();
  __syncthreads();
  float* red_k = smem;
  float* red_v = smem + kBK * CK;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int g = 0; g < GK; ++g)
#pragma unroll
      for (int e = 0; e < WK; ++e)
        red_k[(kw + i) * CK + g * 32 * WK + WK * tx + e] = acc_k[i][g * WK + e];
#pragma unroll
    for (int g = 0; g < GV; ++g)
#pragma unroll
      for (int e = 0; e < WV; ++e)
        red_v[(kw + i) * CV + g * 32 * WV + WV * tx + e] = acc_v[i][g * WV + e];
  }
  cluster.sync();

  // this block adds up rows [rank * kRows, (rank + 1) * kRows) over the
  // cluster's blocks, in rank order
  constexpr int kRows = kBK / kCluster;
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
  float *dq, *dk, *dv;
  int n, lq, lk, dkd, dvd, k_vec4, v_vec4;
  cudaStream_t stream;
};

template <int NCK, int NC, int STAGES>
cudaError_t launch_dq(const Args& a) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(dq_floats(NCK * 32 + 4, NC * 32 + 4, STAGES));
  const cudaError_t set = cudaFuncSetAttribute(attention_dq_kernel<NCK, NC, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (set != cudaSuccess) return set;
  const dim3 grid((a.lq + kBQ - 1) / kBQ, a.n);
  attention_dq_kernel<NCK, NC, STAGES><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.lse, a.delta, a.dout, a.dq, a.lq, a.lk, a.dkd, a.dvd, a.k_vec4, a.v_vec4);
  return cudaGetLastError();
}

template <int NCK, int NC, int STAGES>
cudaError_t launch_dkv(const Args& a) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(dkv_floats(NCK * 32 + 4, NC * 32 + 4, STAGES));
  const cudaError_t set = cudaFuncSetAttribute(attention_dkv_kernel<NCK, NC, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (set != cudaSuccess) return set;
  const dim3 grid(kCluster, (a.lk + kBK - 1) / kBK, a.n);
  attention_dkv_kernel<NCK, NC, STAGES><<<grid, kThreads, bytes, a.stream>>>(
      a.q, a.k, a.v, a.lse, a.delta, a.dout, a.dk, a.dv, a.lq, a.lk, a.dkd, a.dvd, a.k_vec4,
      a.v_vec4);
  return cudaGetLastError();
}

// two stages where they fit in a block's shared memory, else one
template <int NCK, int NC>
cudaError_t launch_widths(const Args& a, bool dkv) {
  constexpr int ldk = NCK * 32 + 4, ldv = NC * 32 + 4;
  if (dkv) {
    if (sizeof(float) * dkv_floats(ldk, ldv, 2) <= kMaxSharedBytes) return launch_dkv<NCK, NC, 2>(a);
    return launch_dkv<NCK, NC, 1>(a);
  }
  if (sizeof(float) * dq_floats(ldk, ldv, 2) <= kMaxSharedBytes) return launch_dq<NCK, NC, 2>(a);
  return launch_dq<NCK, NC, 1>(a);
}

template <int NCK>
cudaError_t launch_dv(const Args& a, bool dkv) {
  if (a.dvd <= 64) return launch_widths<NCK, 2>(a, dkv);
  if (a.dvd <= 128) return launch_widths<NCK, 4>(a, dkv);
  return launch_widths<NCK, 8>(a, dkv);
}

int launch(Args a, int device, bool dkv) {
  if (a.n < 1 || a.n > 65535 || a.lq < 1 || a.lk < 1 || (a.lk + kBK - 1) / kBK > 65535 ||
      a.dkd < 1 || a.dkd > kMaxDk || a.dvd < 1 || a.dvd > kMaxDv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  // 16-byte copies need rows that start on 16-byte boundaries
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  a.k_vec4 = a.dkd % 4 == 0 && aligned(a.q) && aligned(a.k);
  a.v_vec4 = a.dvd % 4 == 0 && aligned(a.v) && aligned(a.dout);
  const cudaError_t rc = a.dkd <= 64 ? launch_dv<2>(a, dkv) : launch_dv<4>(a, dkv);
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
                                                 const float* dout, float* dq, int n, int lq,
                                                 int lk, int dk, int dv, int device,
                                                 void* stream) {
  const Args a{q,  k,  v,  lse, delta, dout, dq, nullptr, nullptr,
               n,  lq, lk, dk,  dv,    0,    0,  static_cast<cudaStream_t>(stream)};
  return launch(a, device, false);
}

extern "C" int tpugan_sagan_attention_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                                  const float* lse, const float* delta,
                                                  const float* dout, float* dk_out, float* dv_out,
                                                  int n, int lq, int lk, int dk, int dv,
                                                  int device, void* stream) {
  const Args a{q,  k,  v,  lse, delta, dout, nullptr, dk_out, dv_out,
               n,  lq, lk, dk,  dv,    0,    0,       static_cast<cudaStream_t>(stream)};
  return launch(a, device, true);
}
