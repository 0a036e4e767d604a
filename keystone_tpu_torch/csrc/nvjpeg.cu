// JPEG batch decode on the card with nvJPEG (the CUDA toolkit's decoder),
// then the bilinear resize of native/keystone_native.cpp § decode_one as a
// CUDA kernel.  The card's decoder for the ImageNet tar loader: its host
// machine has no libjpeg, and the decoded pixels are wanted on the card.
//
// nvJPEG's IDCT and chroma upsampling are not libjpeg's, so a decoded
// image differs from libjpeg's by a few levels (chip_smoke.py measures the
// largest difference on the committed fixture).  The resize repeats the
// host code's float arithmetic operation by operation with the _rn
// intrinsics, which the compiler never contracts into fused multiply-adds,
// so it adds no difference of its own.  Not a TPU kernel: the reference
// decodes on the host.
//
// Plain C interface for ctypes.  The wrapper (loaders/jpeg.py) allocates
// the device buffers; nvJPEG allocates its own working memory.  Every call
// runs on the caller's stream, and waits for it after each image: nvJPEG's
// hybrid backend decodes the next image's entropy data on the host into
// the decoder state's pinned buffer, which the stream may not yet have
// copied to the card for the image before: with work queued ahead on the
// stream, a batch decode without that wait gives wrong pixels.

#include <cstdint>
#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

// One thread an output pixel: out (th, tw, 3) from img (h, w, 3).
__global__ void resize_kernel(const uint8_t* __restrict__ img, int64_t h, int64_t w, int64_t th, int64_t tw,
                              uint8_t* __restrict__ out) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= th * tw) return;
  int64_t y = p / tw, x = p % tw;
  float sy = th > 1 ? __fdiv_rn(__fmul_rn((float)y, (float)(h - 1)), (float)(th - 1)) : 0.0f;
  int64_t y0 = (int64_t)sy;
  int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
  float fy = __fsub_rn(sy, (float)y0);
  float sx = tw > 1 ? __fdiv_rn(__fmul_rn((float)x, (float)(w - 1)), (float)(tw - 1)) : 0.0f;
  int64_t x0 = (int64_t)sx;
  int64_t x1 = x0 + 1 < w ? x0 + 1 : w - 1;
  float fx = __fsub_rn(sx, (float)x0);
  float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  for (int c = 0; c < 3; c++) {
    float v00 = img[(y0 * w + x0) * 3 + c];
    float v01 = img[(y0 * w + x1) * 3 + c];
    float v10 = img[(y1 * w + x0) * 3 + c];
    float v11 = img[(y1 * w + x1) * 3 + c];
    float top = __fadd_rn(__fmul_rn(gx, v00), __fmul_rn(fx, v01));
    float bot = __fadd_rn(__fmul_rn(gx, v10), __fmul_rn(fx, v11));
    float v = __fadd_rn(__fmul_rn(gy, top), __fmul_rn(fy, bot));
    out[(y * tw + x) * 3 + c] = (uint8_t)__float2uint_rz(__fadd_rn(v, 0.5f));
  }
}

}  // namespace

extern "C" {

// A decoder (handle and state); 0 or the nvjpegStatus_t that failed.
int ks_nvjpeg_create(void** out) {
  Decoder* d = new Decoder();
  nvjpegStatus_t st = nvjpegCreateSimple(&d->handle);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(d->handle, &d->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    return (int)st;
  }
  *out = d;
  return 0;
}

void ks_nvjpeg_destroy(void* p) {
  Decoder* d = (Decoder*)p;
  if (!d) return;
  nvjpegJpegStateDestroy(d->state);
  nvjpegDestroy(d->handle);
  delete d;
}

// Each JPEG's size from its header, on the host: heights[i], widths[i],
// or 0 and 0 for bytes nvJPEG cannot parse.
int ks_nvjpeg_info(void* p, const uint8_t* blob, const int64_t* offsets, const int64_t* sizes, int64_t n,
                   int32_t* heights, int32_t* widths) {
  Decoder* d = (Decoder*)p;
  for (int64_t i = 0; i < n; i++) {
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    int wd[NVJPEG_MAX_COMPONENT] = {0}, ht[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t st = nvjpegGetImageInfo(d->handle, blob + offsets[i], (size_t)sizes[i], &comps, &sub, wd, ht);
    bool ok = st == NVJPEG_STATUS_SUCCESS && wd[0] > 0 && ht[0] > 0;
    heights[i] = ok ? ht[0] : 0;
    widths[i] = ok ? wd[0] : 0;
  }
  return 0;
}

// Decode the n JPEGs whose info gave a size into out (n, th, tw, 3)
// (device, zero-filled by the caller) through scratch (device, at least
// max h·w·3 bytes): ok[i] (host) is 0 for a decoded image, else the
// nvjpegStatus_t of its failure (-1: no size).  Returns 0, or the CUDA
// error of a resize launch or of the wait after it.  The stream orders
// each resize before the next image's decode into the shared scratch.
int ks_nvjpeg_decode(void* p, const uint8_t* blob, const int64_t* offsets, const int64_t* sizes, int64_t n,
                     const int32_t* heights, const int32_t* widths, uint8_t* scratch, int64_t th, int64_t tw,
                     uint8_t* out, int32_t* ok, void* stream) {
  Decoder* d = (Decoder*)p;
  cudaStream_t s = (cudaStream_t)stream;
  for (int64_t i = 0; i < n; i++) {
    int64_t h = heights[i], w = widths[i];
    if (h <= 0 || w <= 0) {
      ok[i] = -1;
      continue;
    }
    nvjpegImage_t img = {};
    img.channel[0] = scratch;
    img.pitch[0] = (size_t)w * 3;
    nvjpegStatus_t st = nvjpegDecode(d->handle, d->state, blob + offsets[i], (size_t)sizes[i],
                                     NVJPEG_OUTPUT_RGBI, &img, s);
    ok[i] = (int32_t)st;
    if (st != NVJPEG_STATUS_SUCCESS) continue;
    int64_t pixels = th * tw;
    int threads = 256;
    resize_kernel<<<(unsigned)((pixels + threads - 1) / threads), threads, 0, s>>>(
        scratch, h, w, th, tw, out + i * th * tw * 3);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) e = cudaStreamSynchronize(s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // extern "C"
