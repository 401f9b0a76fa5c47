// Throughput of the warp-level TF32 tensor-core product that the attention
// backward's earlier design was built from (mma.sync.m16n8k8 .tf32, fp32
// accumulation; csrc/sagan_attention_bwd.cu now runs on wgmma), the cap
// that design could reach, in three settings:
//   regs: operands stay in registers, 8 independent accumulators a warp;
//   smem: each product reads its B fragment from shared memory (conflict-free,
//         2 x 32-bit reads a lane), A stays in registers;
//   3xtf32: as smem, and the B fragment is split into hi and lo (3 operations
//         an element) and fed to three products, the backward's inner step.
// One block of 8 or 16 warps on each of the card's SMs.
//
// Build and run on a machine with the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_rate \
//       tpugan_torch/tools/mma_sync_rate.cu
//   ./mma_sync_rate
// Prints one line per setting: TFLOP/s of TF32 products (2 x 16 x 8 x 8 FLOPs each).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

enum Mode { kRegs, kSmem, k3xTf32 };

template <int CH, Mode M>
__global__ void rate(float* out, int iters) {
  __shared__ float sm[1024];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  uint32_t a[CH][4], b[CH][2];
  for (int c = 0; c < CH; ++c) {
    for (int e = 0; e < 4; ++e) a[c][e] = __float_as_uint(lane * 0.1f + c + e);
    b[c][0] = __float_as_uint(lane * 0.2f + c);
    b[c][1] = __float_as_uint(lane * 0.3f + c);
  }
  float d[CH][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (M == kRegs) {
        mma(d[c], a[c], b[c][0], b[c][1]);
        continue;
      }
      // rows g, columns t and t + 4 of a 36-float-stride tile: 32 banks
      const int at = ((lane >> 2) * 36 + (lane & 3) + c * 8 + (i & 7) * 64) & 511;
      const float x0 = sm[at], x1 = sm[at + 4];
      if (M == kSmem) {
        mma(d[c], a[c], __float_as_uint(x0), __float_as_uint(x1));
      } else {
        const uint32_t h0 = (__float_as_uint(x0) + 0x1000u) & 0xffffe000u;
        const uint32_t h1 = (__float_as_uint(x1) + 0x1000u) & 0xffffe000u;
        const uint32_t l0 = __float_as_uint(x0 - __uint_as_float(h0));
        const uint32_t l1 = __float_as_uint(x1 - __uint_as_float(h1));
        mma(d[c], a[c], h0, h1);
        mma(d[c], a[c], l0, l1);
        mma(d[c], a[c], h0, h1);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1234.5f) out[0] = s;  // keeps the products alive
}

template <Mode M>
void run(const char* name, int warps, int sms) {
  constexpr int kChains = 8;
  const int iters = 2048;
  float* out;
  cudaMalloc(&out, sizeof(float));
  rate<kChains, M><<<sms, 32 * warps>>>(out, iters);  // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<kChains, M><<<sms, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double products = (M == k3xTf32 ? 3.0 : 1.0) * kChains * iters * warps * sms;
  printf("%-7s %2d warps/SM: %.1f TFLOP/s of TF32 products (%.3f ms)\n", name, warps,
         products * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12, ms);
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  for (int warps : {8, 16}) {
    run<kRegs>("regs", warps, prop.multiProcessorCount);
    run<kSmem>("smem", warps, prop.multiProcessorCount);
    run<k3xTf32>("3xtf32", warps, prop.multiProcessorCount);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
