// Native image pipeline: JPEG decode + PIL-compatible bicubic resize +
// inception normalize, multithreaded over a batch.
//
// Replaces the reference's per-sample PIL/torchvision host loop (the CPU
// hot path feeding the device, reference src/vilt/datasets/
// base_dataset.py:115-139) with a C++ worker pool: decode via libjpeg,
// antialiased separable bicubic (PIL's convolution resampling, a = -0.5,
// support scaled by the downscale ratio), normalize to (x-0.5)/0.5 and
// emit CHW float32 — the exact eval transform (square_transform).
//
// C ABI, consumed through ctypes (vl_merging_tpu_torch/runtime/__init__.py).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to interleaved RGB8. Returns false on failure.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* width, int* height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  rgb->resize(size_t(*width) * *height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() + size_t(cinfo.output_scanline) * *width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// PIL bicubic kernel (Catmull-Rom-like, a = -0.5), support 2.
inline double cubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds_min, bounds_size;
  std::vector<double> weights;
  int ksize;
};

// PIL's precompute_coeffs: antialiased when downscaling.
ResampleCoeffs compute_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 2.0 * filterscale;
  rc.ksize = int(std::ceil(support)) * 2 + 1;
  rc.bounds_min.resize(out_size);
  rc.bounds_size.resize(out_size);
  rc.weights.assign(size_t(out_size) * rc.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5));
    double* w = rc.weights.data() + size_t(xx) * rc.ksize;
    double wsum = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double v = cubic_filter((x - center + 0.5) / filterscale);
      w[x - xmin] = v;
      wsum += v;
    }
    if (wsum != 0.0)
      for (int x = 0; x < xmax - xmin; ++x) w[x] /= wsum;
    rc.bounds_min[xx] = xmin;
    rc.bounds_size[xx] = xmax - xmin;
  }
  return rc;
}

inline uint8_t clip8(double v) {
  return uint8_t(std::clamp(std::floor(v + 0.5), 0.0, 255.0));
}

// Resize interleaved RGB to out_size² uint8 HWC (PIL-exact: uint8
// round+clip between the horizontal and vertical passes).
void resize_u8(const std::vector<uint8_t>& rgb, int w, int h, int out_size,
               uint8_t* out_hwc) {
  ResampleCoeffs rx = compute_coeffs(w, out_size);
  ResampleCoeffs ry = compute_coeffs(h, out_size);

  // horizontal pass: (h, out_size, 3) uint8
  std::vector<uint8_t> tmp(size_t(h) * out_size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgb.data() + size_t(y) * w * 3;
    for (int xx = 0; xx < out_size; ++xx) {
      const double* wgt = rx.weights.data() + size_t(xx) * rx.ksize;
      int xmin = rx.bounds_min[xx], n = rx.bounds_size[xx];
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < n; ++i) {
        const uint8_t* px = row + size_t(xmin + i) * 3;
        acc[0] += wgt[i] * px[0];
        acc[1] += wgt[i] * px[1];
        acc[2] += wgt[i] * px[2];
      }
      uint8_t* dst = tmp.data() + (size_t(y) * out_size + xx) * 3;
      dst[0] = clip8(acc[0]); dst[1] = clip8(acc[1]); dst[2] = clip8(acc[2]);
    }
  }
  // vertical pass
  for (int yy = 0; yy < out_size; ++yy) {
    const double* wgt = ry.weights.data() + size_t(yy) * ry.ksize;
    int ymin = ry.bounds_min[yy], n = ry.bounds_size[yy];
    for (int xx = 0; xx < out_size; ++xx) {
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < n; ++i) {
        const uint8_t* px =
            tmp.data() + (size_t(ymin + i) * out_size + xx) * 3;
        acc[0] += wgt[i] * px[0];
        acc[1] += wgt[i] * px[1];
        acc[2] += wgt[i] * px[2];
      }
      uint8_t* dst = out_hwc + (size_t(yy) * out_size + xx) * 3;
      dst[0] = clip8(acc[0]); dst[1] = clip8(acc[1]); dst[2] = clip8(acc[2]);
    }
  }
}

// f32 CHW inception-normalized output (the square_transform eval math).
void resize_normalize(const std::vector<uint8_t>& rgb, int w, int h,
                      int out_size, float* out) {
  std::vector<uint8_t> hwc(size_t(out_size) * out_size * 3);
  resize_u8(rgb, w, h, out_size, hwc.data());
  size_t plane = size_t(out_size) * out_size;
  for (int yy = 0; yy < out_size; ++yy)
    for (int xx = 0; xx < out_size; ++xx)
      for (int c = 0; c < 3; ++c) {
        uint8_t v = hwc[(size_t(yy) * out_size + xx) * 3 + c];
        out[size_t(c) * plane + size_t(yy) * out_size + xx] =
            (float(v) / 255.0f - 0.5f) / 0.5f;
      }
}

}  // namespace

extern "C" {

// Decode+resize+normalize a batch of JPEG buffers into out (N,3,S,S) f32.
// Returns number of failures (failed slots are zero-filled).
int vlm_decode_resize_batch(const uint8_t** datas, const size_t* lens,
                            int n, int out_size, float* out,
                            int num_threads) {
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  size_t stride = size_t(3) * out_size * out_size;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> rgb;
      int w = 0, h = 0;
      if (decode_jpeg(datas[i], lens[i], &rgb, &w, &h) && w > 0 && h > 0) {
        resize_normalize(rgb, w, h, out_size, out + size_t(i) * stride);
      } else {
        std::memset(out + size_t(i) * stride, 0, stride * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };

  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Decode+resize a batch into uint8 HWC (N, S, S, 3) — the low-bandwidth
// feed path: normalization happens on device ((u8/255 - 0.5)/0.5), so the
// host->device transfer is 4x smaller than f32.
int vlm_decode_resize_batch_u8(const uint8_t** datas, const size_t* lens,
                               int n, int out_size, uint8_t* out,
                               int num_threads) {
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  size_t stride = size_t(3) * out_size * out_size;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::vector<uint8_t> rgb;
      int w = 0, h = 0;
      if (decode_jpeg(datas[i], lens[i], &rgb, &w, &h) && w > 0 && h > 0) {
        resize_u8(rgb, w, h, out_size, out + size_t(i) * stride);
      } else {
        std::memset(out + size_t(i) * stride, 0, stride);
        failures.fetch_add(1);
      }
    }
  };

  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
