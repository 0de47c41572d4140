// Native data-loader: threaded JPEG decode + bilinear resize + canvas write.
//
// The host data generator was the reference's hot loop #1 (SURVEY.md 3.1:
// per-sample Python decode/resize in datasets/image.py + voc.py). This C++
// runtime component replaces it: libjpeg decode, PIL-convention bilinear
// resize (center-aligned triangle filter — exact for the upscales VOC's
// min-side-600 rule always produces), optional horizontal flip, and direct
// placement into the caller's padded uint8 canvas batch. A std::thread pool
// decodes a whole batch in parallel.
//
// C ABI (consumed by fasterrcnn_tpu/data/native_loader.py via ctypes):
//   frcnn_decode_resize_into(...)  - one image
//   frcnn_decode_batch(...)        - N images, parallel

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
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG byte buffer to RGB8. Returns true on success.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* out,
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
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  out->resize(size_t(*width) * size_t(*height) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * (*width) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// PIL-convention bilinear resize (center-aligned): src = (dst+0.5)*scale-0.5,
// clamped triangle weights. Exact match of PIL BILINEAR for scale >= 1.
void resize_bilinear(const uint8_t* src, int sw, int sh, uint8_t* dst, int dw,
                     int dh, int dst_stride, bool flip) {
  const double sx = double(sw) / dw;
  const double sy = double(sh) / dh;
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> fx(dw);
  for (int x = 0; x < dw; ++x) {
    double cx = (x + 0.5) * sx - 0.5;
    cx = std::max(0.0, std::min(cx, double(sw - 1)));
    x0[x] = int(cx);
    x1[x] = std::min(x0[x] + 1, sw - 1);
    fx[x] = float(cx - x0[x]);
  }
  for (int y = 0; y < dh; ++y) {
    double cy = (y + 0.5) * sy - 0.5;
    cy = std::max(0.0, std::min(cy, double(sh - 1)));
    const int y0 = int(cy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float fy = float(cy - y0);
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    uint8_t* out_row = dst + size_t(y) * dst_stride;
    for (int x = 0; x < dw; ++x) {
      const int ox = flip ? (dw - 1 - x) : x;
      const float wx = fx[x];
      for (int c = 0; c < 3; ++c) {
        const float top = r0[x0[x] * 3 + c] * (1.f - wx) + r0[x1[x] * 3 + c] * wx;
        const float bot = r1[x0[x] * 3 + c] * (1.f - wx) + r1[x1[x] * 3 + c] * wx;
        const float v = top * (1.f - fy) + bot * fy;
        out_row[ox * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

// One sample: decode, resize so min side == min_side (long side capped at
// max_side when > 0 — extreme aspect ratios would otherwise outgrow every
// canvas bucket), flip, write top-left into the (canvas_h, canvas_w, 3)
// uint8 canvas. Returns 0 on success.
int decode_one(const uint8_t* jpeg, size_t len, int min_side, int max_side,
               int flip, uint8_t* canvas, int canvas_h, int canvas_w,
               int canvas_stride, int* real_h, int* real_w, int* orig_h,
               int* orig_w) {
  std::vector<uint8_t> rgb;
  int sw = 0, sh = 0;
  if (!decode_jpeg(jpeg, len, &rgb, &sw, &sh)) return 1;
  *orig_h = sh;
  *orig_w = sw;
  double scale = 1.0;
  if (min_side > 0) {
    scale = (sw > sh) ? double(min_side) / sh : double(min_side) / sw;
    if (max_side > 0) {
      const double long_scale =
          double(max_side) / ((sw > sh) ? double(sw) : double(sh));
      if (long_scale < scale) scale = long_scale;
    }
  }
  const int dw = int(sw * scale);
  const int dh = int(sh * scale);
  if (dh > canvas_h || dw > canvas_w) return 2;
  *real_h = dh;
  *real_w = dw;
  resize_bilinear(rgb.data(), sw, sh, canvas, dw, dh, canvas_stride,
                  flip != 0);
  return 0;
}

}  // namespace

extern "C" {

int frcnn_decode_resize_into(const uint8_t* jpeg, size_t len, int min_side,
                             int max_side, int flip, uint8_t* canvas,
                             int canvas_h, int canvas_w, int* real_h,
                             int* real_w, int* orig_h, int* orig_w) {
  return decode_one(jpeg, len, min_side, max_side, flip, canvas, canvas_h,
                    canvas_w, canvas_w * 3, real_h, real_w, orig_h, orig_w);
}

// Batch: jpegs given as one concatenated buffer + offsets/lengths. Image i is
// written into batch_canvas[dest_idx ? dest_idx[i] : i] of shape
// (canvas_h, canvas_w, 3) — dest_idx lets a caller fill only the undecoded
// rows of a partially-cached batch. results[i]: 0 ok, nonzero error.
// real_hw: (n, 2) int32; orig_hw: (n, 2).
void frcnn_decode_batch(const uint8_t* blob, const int64_t* offsets,
                        const int64_t* lengths, int n, int min_side,
                        int max_side, const int32_t* flips,
                        uint8_t* batch_canvas, int canvas_h, int canvas_w,
                        const int32_t* dest_idx, int32_t* real_hw,
                        int32_t* orig_hw, int32_t* results, int num_threads) {
  if (num_threads <= 0) num_threads = 1;
  std::vector<std::thread> workers;
  std::atomic_int next{0};
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int rh = 0, rw = 0, oh = 0, ow = 0;
      const int dest = dest_idx ? dest_idx[i] : i;
      uint8_t* canvas =
          batch_canvas + size_t(dest) * canvas_h * canvas_w * 3;
      results[i] = decode_one(blob + offsets[i], size_t(lengths[i]), min_side,
                              max_side, flips[i], canvas, canvas_h, canvas_w,
                              canvas_w * 3, &rh, &rw, &oh, &ow);
      real_hw[i * 2] = rh;
      real_hw[i * 2 + 1] = rw;
      orig_hw[i * 2] = oh;
      orig_hw[i * 2 + 1] = ow;
    }
  };
  const int t = std::min(num_threads, n);
  workers.reserve(t);
  for (int i = 0; i < t; ++i) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

}  // extern "C"
