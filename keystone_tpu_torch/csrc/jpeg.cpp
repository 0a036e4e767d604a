// JPEG batch decode on the host with libjpeg, then a bilinear resize to
// the loader's size: the port's copy of native/keystone_native.cpp §
// decode_one and ks_decode_jpegs, byte for byte in its arithmetic, so that
// the same libjpeg gives the same pixels.  The CPU's decoder: a loader on
// the card decodes with nvJPEG instead (csrc/nvjpeg.cu).
//
// Build (keystone_tpu_torch/kernels/build.py, at first use):
//   g++ -O3 -fPIC -std=c++20 -shared -o libjpeg-<hash>.so jpeg.cpp -ljpeg -lpthread
//
// Plain C interface for ctypes.  The caller allocates every buffer.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = (JpegErr*)cinfo->err;
  longjmp(err->jb, 1);
}

void silent(j_common_ptr) {}

// Decode one JPEG into out (th, tw, 3) uint8 by a bilinear resize
// (resampled in float, rounded to the nearest byte).  0 on success.
int decode_one(const uint8_t* buf, int64_t len, int64_t th, int64_t tw, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // a raw buffer, not a std::vector: the longjmp out of the error
  // handler must not skip a destructor; freed on both paths
  uint8_t* volatile imgbuf = nullptr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  jerr.mgr.output_message = silent;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    free(imgbuf);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int64_t h = cinfo.output_height, w = cinfo.output_width;
  imgbuf = (uint8_t*)malloc((size_t)h * w * 3);
  if (!imgbuf) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  uint8_t* img = imgbuf;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = img + (size_t)cinfo.output_scanline * w * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  for (int64_t y = 0; y < th; y++) {
    float sy = th > 1 ? (float)y * (h - 1) / (th - 1) : 0.0f;
    int64_t y0 = (int64_t)sy;
    int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
    float fy = sy - y0;
    for (int64_t x = 0; x < tw; x++) {
      float sx = tw > 1 ? (float)x * (w - 1) / (tw - 1) : 0.0f;
      int64_t x0 = (int64_t)sx;
      int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
      float fx = sx - x0;
      for (int64_t c = 0; c < 3; c++) {
        float v00 = img[(y0 * w + x0) * 3 + c];
        float v01 = img[(y0 * w + x1) * 3 + c];
        float v10 = img[(y1 * w + x0) * 3 + c];
        float v11 = img[(y1 * w + x1) * 3 + c];
        float v = (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11);
        out[(y * tw + x) * 3 + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
  free(imgbuf);
  return 0;
}

}  // namespace

extern "C" {

// Decode n JPEGs, item i the bytes blob[offsets[i], offsets[i] + sizes[i]),
// into out (n, th, tw, 3) uint8 on a pool of `threads` threads (< 1: one
// a core); ok[i] is 0 for a decoded item and negative for one that is not
// (its image is left as the caller filled it).
int ks_jpeg_decode(const uint8_t* blob, const int64_t* offsets, const int64_t* sizes, int64_t n, int64_t th,
                   int64_t tw, int threads, uint8_t* out, int32_t* ok) {
  if (threads < 1) threads = (int)std::thread::hardware_concurrency();
  if (threads < 1) threads = 1;
  if ((int64_t)threads > n) threads = (int)n;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      ok[i] = decode_one(blob + offsets[i], sizes[i], th, tw, out + (size_t)i * th * tw * 3);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
