// tpugan_torch's image loader: threaded bilinear resize of decoded pixels.
//
// tpugan's native loader decodes PNGs with libpng and resizes them
// bilinearly with aligned corners and no antialias, in fp32:
// (top + (bot - top) * wy) / 255 with top and bot interpolated along x.
// This library is that resize, on 8-bit RGB pixels the caller has decoded
// (PIL: PNG is lossless, so its 8-bit pixels are libpng's), so the port
// needs no libpng. It writes float32 [0, 1] NHWC into a caller-provided
// buffer, one image per task in worker threads. `tpugan_torch/io/native.py`
// builds it with g++ at first use (`ops/cuda.py`'s HOST_LIBRARIES) and
// binds it with ctypes.
//
// C API (ctypes-friendly):
//   tg_resize_rgb8(rgb, h, w, out_f32, out_h, out_w)   one image
//   tg_resize_batch(images, heights, widths, n, out_h, out_w, out, n_threads)
// Both return 0 on success, a negative code for a bad argument.

#include <atomic>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

// bilinear resize h x w x 3 u8 -> out_h x out_w x 3 f32 in [0, 1]
// (native/tpugan_io.cpp:77-103, the same operations in the same order)
void resize_to_f32(const unsigned char* rgb, int h, int w, int out_h, int out_w, float* out) {
  const float sy = h > 1 && out_h > 1 ? (float)(h - 1) / (out_h - 1) : 0.f;
  const float sx = w > 1 && out_w > 1 ? (float)(w - 1) / (out_w - 1) : 0.f;
  for (int oy = 0; oy < out_h; ++oy) {
    float fy = oy * sy;
    int y0 = (int)fy;
    int y1 = y0 + 1 < h ? y0 + 1 : y0;
    float wy = fy - y0;
    for (int ox = 0; ox < out_w; ++ox) {
      float fx = ox * sx;
      int x0 = (int)fx;
      int x1 = x0 + 1 < w ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = rgb[((size_t)y0 * w + x0) * 3 + c];
        float v01 = rgb[((size_t)y0 * w + x1) * 3 + c];
        float v10 = rgb[((size_t)y1 * w + x0) * 3 + c];
        float v11 = rgb[((size_t)y1 * w + x1) * 3 + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        out[((size_t)oy * out_w + ox) * 3 + c] = (top + (bot - top) * wy) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

int tg_resize_rgb8(const unsigned char* rgb, int h, int w, float* out, int out_h, int out_w) {
  if (!rgb || !out || h < 1 || w < 1 || out_h < 1 || out_w < 1) return -1;
  resize_to_f32(rgb, h, w, out_h, out_w, out);
  return 0;
}

// images[n] of heights[i] x widths[i] x 3 -> out [n, out_h, out_w, 3] float32
int tg_resize_batch(const unsigned char** images, const int* heights, const int* widths, int n,
                    int out_h, int out_w, float* out, int n_threads) {
  if (n < 0) return -1;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = tg_resize_rgb8(images[i], heights[i], widths[i], out + (size_t)i * out_h * out_w * 3,
                              out_h, out_w);
      if (rc != 0) err.store(rc);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n ? n_threads : n;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

}  // extern "C"
