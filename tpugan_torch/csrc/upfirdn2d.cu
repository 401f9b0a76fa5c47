// upfirdn2d: upsample by zero-stuffing, pad, FIR-filter, downsample — NCHW fp32.
//
// Replaces the two Pallas TPU kernels of tpugan/ops/pallas/upfirdn2d.py:
//   * upfirdn2d_pallas         (C % 128 == 0; up, down in {1, 2})
//   * upfirdn2d_pallas_small_c (128 % C == 0; same-size FIR, with (W, C)
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
// The gain is folded into the taps by the caller.
//
// Bound: bytes. The same-size 3x3 blur reads and writes each activation
// element once (8 bytes in fp32) against 9 FMAs, far below the card's
// operations-per-byte balance. This first design does nothing about it
// beyond coalescing: one thread per output element, neighbouring threads on
// neighbouring columns, the halo re-read through L1. Shared-memory row tiles
// with a halo, a polyphase up-2 path and bf16 are left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTaps = 8;
constexpr int kThreads = 256;

struct Taps {
  float v[kMaxTaps * kMaxTaps];
};

template <int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t total,
                 int h, int w, int ho, int wo, int pad0, int kh, int kw, Taps taps) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int ox = static_cast<int>(i % wo);
  const int64_t rest = i / wo;
  const int oy = static_cast<int>(rest % ho);
  const int64_t plane = rest / ho;
  const float* xp = x + plane * h * w;

  float acc = 0.f;
  for (int ty = 0; ty < kh; ++ty) {
    const int sy = oy * DOWN + ty - pad0;
    if (sy < 0 || sy % UP != 0) continue;
    const int iy = sy / UP;
    if (iy >= h) break;  // sy only grows with ty
    const float* row = xp + static_cast<int64_t>(iy) * w;
    for (int tx = 0; tx < kw; ++tx) {
      const int sx = ox * DOWN + tx - pad0;
      if (sx < 0 || sx % UP != 0) continue;
      const int ix = sx / UP;
      if (ix >= w) break;
      acc = fmaf(taps.v[ty * kw + tx], __ldg(row + ix), acc);
    }
  }
  y[i] = acc;
}

template <int UP, int DOWN>
void launch(const float* x, float* y, int64_t total, int h, int w, int ho, int wo, int pad0,
            int kh, int kw, const Taps& taps, cudaStream_t stream) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  upfirdn2d_kernel<UP, DOWN><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      x, y, total, h, w, ho, wo, pad0, kh, kw, taps);
}

}  // namespace

// Plain C entry point, bound with ctypes. `taps` is a host array of kh*kw
// floats (row-major, gain folded in); it is copied into the launch's
// parameters, so the caller may free it on return. `device` is the ordinal
// that holds x, y and `stream` (this library has its own runtime state, so
// it sets the device itself). Launches on `stream` and does not
// synchronise. Returns 0, or the cudaError_t of a refused launch
// (cudaErrorInvalidValue for arguments outside the kernel's contract).
extern "C" int tpugan_upfirdn2d_f32(const float* x, float* y, int64_t planes, int h, int w,
                                    int ho, int wo, int up, int down, int pad0, int kh, int kw,
                                    const float* taps, int device, void* stream) {
  if (planes < 0 || h < 1 || w < 1 || ho < 1 || wo < 1 || pad0 < 0 || kh < 1 ||
      kh > kMaxTaps || kw < 1 || kw > kMaxTaps || (up != 1 && up != 2) ||
      (down != 1 && down != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = planes * ho * wo;
  if (total == 0) return 0;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Taps t{};
  for (int i = 0; i < kh * kw; ++i) t.v[i] = taps[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up == 1 && down == 1) {
    launch<1, 1>(x, y, total, h, w, ho, wo, pad0, kh, kw, t, s);
  } else if (up == 2 && down == 1) {
    launch<2, 1>(x, y, total, h, w, ho, wo, pad0, kh, kw, t, s);
  } else if (up == 1 && down == 2) {
    launch<1, 2>(x, y, total, h, w, ho, wo, pad0, kh, kw, t, s);
  } else {
    launch<2, 2>(x, y, total, h, w, ho, wo, pad0, kh, kw, t, s);
  }
  return static_cast<int>(cudaGetLastError());
}
