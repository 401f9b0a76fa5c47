// SAGAN attention forward: o = softmax(q k^T) v over the keys, fp32,
// optionally with the per-row logsumexp. No 1/sqrt(d) scaling: BigGAN's
// SelfAttn applies none.
//
// Replaces the Pallas TPU kernel tpugan/ops/pallas/attention.py::
// sagan_attention_pallas in both forms: without the logsumexp (the eval
// path) and with it (the form the training backward reads).
//
// Shapes: q [N, Lq, dk], k [N, Lk, dk], v [N, Lk, dv], o [N, Lq, dv],
// lse [N, Lq] (the caller views it as [N, Lq, 1]); all contiguous, any
// Lq, Lk >= 1, dk <= 128, dv <= 256. At BigGAN-256's attention layer
// N = 2, Lq = 4096, Lk = 1024, dk = 64, dv = 256.
//
// Bound: operations. The two products take 2 * N * Lq * Lk * (dk + dv)
// FLOPs (5.37 GFLOP at the BigGAN-256 shape) against 13 MB of inputs and
// output, far above the card's fp32 operations-per-byte balance. The score
// matrix never reaches device memory.
//
// Design (plain fp32 FMAs, no TF32 and no tensor cores, as the Pallas
// kernel computes in fp32):
//  * one block of 256 threads per (batch item, tile of 64 query rows); the
//    Q tile stays in shared memory, transposed;
//  * a loop over tiles of 64 keys. Each K tile (transposed) and V tile is
//    copied with cp.async into one of two shared-memory stages, so the
//    next tile's copy runs under the current tile's arithmetic (one stage
//    when two do not fit, as at dk 128 with dv 256);
//  * scores with a 4 x 4 register tile per thread; the 16 threads of a row
//    group are a half-warp and keep the online softmax's running max m and
//    sum l in registers, reduced with shuffles; the rescale factor
//    exp(m_old - m_new) and the probabilities go to shared memory;
//  * o += p v with an 8-row by NC-column register tile per thread, so the
//    accumulator of a 256-wide row is spread over a warp; V is read in
//    float4s;
//  * o = acc / l and lse = m + log(l) at the end. Rows past Lq are not
//    written; keys past Lk score -inf and their V rows are zero.
// Shared memory is up to 201 KB, above the 48 KB default, so the launch
// raises the block's dynamic shared-memory limit. Left for later work:
// more than one block per SM (the BigGAN-256 grid is 128 blocks), warp
// specialisation, and TF32 or bf16 tensor-core products (wgmma).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kPad = 4;
constexpr int kLdq = kBQ + kPad;
constexpr int kLdk = kBK + kPad;
constexpr int kMaxDk = 128;
constexpr int kMaxDv = 256;
constexpr int kMaxSharedBytes = 227 * 1024;

__host__ __device__ constexpr int shared_floats(int dk, int nc, int stages) {
  return dk * kLdq + stages * (dk * kLdk + kBK * nc * 32) + kBK * kLdq + 2 * kBQ;
}

template <int W>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* out) { out[0] = *p; }
};
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

// i / d for 0 <= i < 8192 and 1 <= d <= 128 (the tiles' index ranges):
// (i + 0.5) / d lies at least 0.5 / d from an integer, farther than the
// float product can err
__device__ __forceinline__ int div_small(int i, float inv_d) {
  return __float2int_rd((static_cast<float>(i) + 0.5f) * inv_d);
}

template <int NC, int STAGES>
__global__ void __launch_bounds__(kThreads)
sagan_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int lq, int lk, int dk, int dv, int v_vec4) {
  constexpr int W = NC >= 4 ? 4 : NC;
  constexpr int G = NC / W;
  constexpr int kLdv = NC * 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qt = smem;
  float* kt0 = qt + dk * kLdq;                 // STAGES x [dk][kLdk]
  float* vs0 = kt0 + STAGES * dk * kLdk;       // STAGES x [kBK][kLdv]
  float* pt = vs0 + STAGES * kBK * kLdv;
  float* row_a = pt + kBK * kLdq;
  float* row_l = row_a + kBQ;

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const float* qb = q + static_cast<int64_t>(b) * lq * dk;
  const float* kb = k + static_cast<int64_t>(b) * lk * dk;
  const float* vb = v + static_cast<int64_t>(b) * lk * dv;
  const float inv_dk = 1.f / static_cast<float>(dk);

  for (int i = t; i < kBQ * dk; i += kThreads) {
    const int r = div_small(i, inv_dk), d = i - r * dk;
    qt[d * kLdq + r] = (q0 + r < lq) ? qb[static_cast<int64_t>(q0 + r) * dk + d] : 0.f;
  }

  // copy tile `tile` into stage `st`: K transposed, V row by row (zero past lk and dv)
  auto issue = [&](int tile, int st) {
    const int j0 = tile * kBK;
    const int kn = min(kBK, lk - j0);
    float* kt = kt0 + st * dk * kLdk;
    float* vs = vs0 + st * kBK * kLdv;
    const float* ksrc = kb + static_cast<int64_t>(j0) * dk;
    for (int i = t; i < kBK * dk; i += kThreads) {
      const int j = div_small(i, inv_dk), d = i - j * dk;
      const bool ok = j < kn;
      copy4(kt + d * kLdk + j, ok ? ksrc + i : kb, ok);
    }
    const float* vsrc = vb + static_cast<int64_t>(j0) * dv;
    if (v_vec4) {
      for (int i = t; i < kBK * kLdv / 4; i += kThreads) {
        const int j = i / (kLdv / 4), c = (i - j * (kLdv / 4)) * 4;
        const bool ok = j < kn && c < dv;
        copy16(vs + j * kLdv + c, ok ? vsrc + j * dv + c : vb, ok);
      }
    } else {
      for (int i = t; i < kBK * kLdv; i += kThreads) {
        const int j = i / kLdv, c = i - j * kLdv;
        const bool ok = j < kn && c < dv;
        copy4(vs + i, ok ? vsrc + j * dv + c : vb, ok);
      }
    }
    copy_commit();
  };

  const int sr = (t >> 4) * 4, sc = (t & 15) * 4;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int tx = t & 31, cr = (t >> 5) * 8;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int ntiles = (lk + kBK - 1) / kBK;
  if (STAGES == 2) issue(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = STAGES == 2 ? (it & 1) : 0;
    const int kn = min(kBK, lk - it * kBK);
    __syncthreads();  // the stage about to be refilled and pt are free
    if (STAGES == 2) {
      if (it + 1 < ntiles) {
        issue(it + 1, st ^ 1);
        copy_wait<1>();  // this tile's copies are done, the next one's may run on
      } else {
        copy_wait<0>();
      }
    } else {
      issue(it, 0);
      copy_wait<0>();
    }
    __syncthreads();
    const float* kt = kt0 + st * dk * kLdk;
    const float* vs = vs0 + st * kBK * kLdv;

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dk; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLdq + sr);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLdk + sc);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (sc + j >= kn) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
      if ((t & 15) == 0) row_a[sr + i] = alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pt + (sc + j) * kLdq + sr) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = row_a[cr + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < kn; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(pt + j * kLdq + cr);
      const float4 p1 = *reinterpret_cast<const float4*>(pt + j * kLdq + cr + 4);
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vv[NC];
#pragma unroll
      for (int g = 0; g < G; ++g) Vec<W>::load(vs + j * kLdv + g * 32 * W + W * tx, vv + g * W);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  if ((t & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      row_l[sr + i] = l[i];
      const int r = q0 + sr + i;
      if (lse != nullptr && r < lq) lse[static_cast<int64_t>(b) * lq + r] = m[i] + logf(l[i]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + cr + i;
    if (r >= lq) continue;
    const float inv = 1.f / row_l[cr + i];
    float* orow = o + (static_cast<int64_t>(b) * lq + r) * dv;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const int col = g * 32 * W + W * tx + e;
        if (col < dv) orow[col] = acc[i][g * W + e] * inv;
      }
  }
}

template <int NC, int STAGES>
cudaError_t launch_stages(const float* q, const float* k, const float* v, float* o, float* lse,
                          int n, int lq, int lk, int dk, int dv, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * static_cast<size_t>(shared_floats(dk, NC, STAGES));
  const cudaError_t set = cudaFuncSetAttribute(sagan_attention_kernel<NC, STAGES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (set != cudaSuccess) return set;
  // 16-byte V copies need 16-byte aligned rows
  const int v_vec4 = dv % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((lq + kBQ - 1) / kBQ, n);
  sagan_attention_kernel<NC, STAGES>
      <<<grid, kThreads, bytes, stream>>>(q, k, v, o, lse, lq, lk, dk, dv, v_vec4);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse, int n,
                   int lq, int lk, int dk, int dv, cudaStream_t stream) {
  if (sizeof(float) * shared_floats(dk, NC, 2) <= kMaxSharedBytes) {
    return launch_stages<NC, 2>(q, k, v, o, lse, n, lq, lk, dk, dv, stream);
  }
  return launch_stages<NC, 1>(q, k, v, o, lse, n, lq, lk, dk, dv, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v, o (and lse, or null) are
// device pointers on ordinal `device`, contiguous fp32 as above. Launches on
// `stream` and does not synchronise. Returns 0, or the cudaError_t of a
// refused launch (cudaErrorInvalidValue for arguments outside the kernel's
// contract).
extern "C" int tpugan_sagan_attention_f32(const float* q, const float* k, const float* v,
                                          float* o, float* lse, int n, int lq, int lk, int dk,
                                          int dv, int device, void* stream) {
  if (n < 1 || n > 65535 || lq < 1 || lk < 1 || dk < 1 || dk > kMaxDk || dv < 1 ||
      dv > kMaxDv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dv <= 32) {
    rc = launch<1>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  } else if (dv <= 64) {
    rc = launch<2>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  } else if (dv <= 128) {
    rc = launch<4>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  } else {
    rc = launch<8>(q, k, v, o, lse, n, lq, lk, dk, dv, s);
  }
  return static_cast<int>(rc);
}
