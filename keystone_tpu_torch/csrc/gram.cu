// Gram-block kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels of keystone_tpu/ops/gram_pallas.py:
//   gram_block_pallas (_gram_kernel)      -> ks_gram_block
//     K(x, z) = exp(-gamma * max(|x|^2 - 2 x.z^T + |z|^2, 0))
//   poly_block_pallas (_poly_gram_kernel) -> ks_poly_block
//     K(x, z) = (alpha * x.z^T + c)^degree, integer degree >= 0
//     (the linear kernel is (1, 0, 1))
// x: (n, d), z: (m, d), both f32 or both bf16, row-major; out: (n, m) f32.
// Both kernels run one device tile body, gram_tile_body, and differ only
// in their epilogue, as the two Pallas kernels share their tiling and
// padding discipline, so the two cannot drift apart.
//
// What bounds it on an H100: one (n x m) output from a contraction over d,
// 2*n*m*d flops against (n + m)*d reads and n*m writes.  At the main
// paths' shapes (d = 256..3072, tiles of 128) that is ~30-400 flops per
// byte, above the card's f32 ridge (67 TFLOP/s of non-tensor f32 over
// 3.35 TB/s = 20 flop/byte), so it is bound by f32 FMA throughput; only
// at small d (< ~40) does the output write bound it.  The solver callers
// need IEEE f32 dot products, so no TF32 and no tensor cores.
//
// What the design does about it: the classic shared-memory SGEMM on CUDA
// cores.  A block of 256 threads owns a 128 x 128 output tile; each thread
// holds 8 x 8 f32 accumulators in registers (rows and columns split 4 + 4
// across the tile's two halves, so the float4 shared-memory reads of a
// quarter warp hit 32 distinct banks).  d is walked in chunks of 16,
// staged transposed in two shared-memory buffers: the next chunk's global
// loads are issued into registers before the current chunk's FMAs, so
// one __syncthreads a chunk suffices.  The row norms |x_i|^2 and |z_j|^2
// that the Gaussian epilogue needs come from the same staged chunks (one
// thread a row), not from a second pass over device memory, as the Pallas
// kernel computes them in-tile.  Ragged n, m and d need no padded copy:
// loads outside the matrices read as 0 (which adds nothing to a dot
// product or a norm) and stores are bounds-checked; the Pallas kernel's
// pad-and-slice is gone.  There is no bound on d (the TPU's VMEM-driven
// GRAM_MAX_D): the chunk loop takes any d.  A faster version would use
// wgmma only if the callers accepted TF32/bf16 products; in true f32 the
// levers are a deeper cp.async pipeline and a persistent tile walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                      // output tile: kTile x kTile
constexpr int kHalf = kTile / 2;                // a thread's 4 + 4 rows (columns)
constexpr int kDepth = 16;                      // d chunk staged in shared memory
constexpr int kStride = kTile + 4;              // shared row stride; keeps float4 alignment
constexpr int kRowsPerStep = kThreads / kDepth; // rows one load step covers
constexpr int kLoads = kTile / kRowsPerStep;    // elements a thread loads per operand chunk
constexpr int kMaxGridY = 65535;
constexpr int kErrShape = -1;  // shape or degree the kernels do not take

enum Epilogue { kGaussian = 0, kPolynomial = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Stage {
  float a[kDepth][kStride];  // x chunk, transposed: a[k][tile row]
  float b[kDepth][kStride];  // z chunk, transposed: b[k][tile column]
};

// tile row (column) of a thread's i-th accumulator row (column)
__device__ __forceinline__ int lane_index(int t, int i) {
  return i < 4 ? t * 4 + i : kHalf + t * 4 + (i - 4);
}

// one operand chunk, global -> registers; rows past `rows` and columns
// past d read as 0.  Consecutive threads read consecutive columns.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src, int rows, int d, int row0,
                                           int k0, float (&reg)[kLoads]) {
  const int c = threadIdx.x % kDepth;
  const int r = threadIdx.x / kDepth;
  const int k = k0 + c;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int row = row0 + i * kRowsPerStep + r;
    reg[i] = (row < rows && k < d) ? to_f32(src[(size_t)row * d + k]) : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(float (*dst)[kStride], const float (&reg)[kLoads]) {
  const int c = threadIdx.x % kDepth;
  const int r = threadIdx.x / kDepth;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) dst[c][i * kRowsPerStep + r] = reg[i];
}

// The tile body both kernels share: acc[i][j] = x_row . z_col over all of
// d for the thread's 8 x 8 outputs and, with kNorms, the squared norms of
// the tile's 128 rows of x (xn_s) and of z (zn_s), in shared memory.
template <typename T, bool kNorms>
__device__ __forceinline__ void gram_tile_body(const T* __restrict__ x, const T* __restrict__ z,
                                               int n, int m, int d, int row0, int col0,
                                               Stage (&st)[2], float (&acc)[8][8],
                                               float* xn_s, float* zn_s) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float ra[kLoads], rb[kLoads];
  float nrm = 0.f;  // tid < kTile: |x|^2 of tile row tid; else |z|^2 of tile column tid - kTile
  const int nk = (d + kDepth - 1) / kDepth;
  if (nk > 0) {
    load_chunk(x, n, d, row0, 0, ra);
    load_chunk(z, m, d, col0, 0, rb);
    store_chunk(st[0].a, ra);
    store_chunk(st[0].b, rb);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const Stage& s = st[kt & 1];
    const bool more = kt + 1 < nk;
    if (more) {  // the next chunk's loads are in flight during this chunk's FMAs
      load_chunk(x, n, d, row0, (kt + 1) * kDepth, ra);
      load_chunk(z, m, d, col0, (kt + 1) * kDepth, rb);
    }
    if (kNorms) {
      const float* v = tid < kTile ? &s.a[0][tid] : &s.b[0][tid - kTile];
#pragma unroll
      for (int k = 0; k < kDepth; ++k) nrm = fmaf(v[k * kStride], v[k * kStride], nrm);
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[k][kHalf + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[k][kHalf + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {  // the other buffer: every thread finished reading it before the last sync
      store_chunk(st[(kt + 1) & 1].a, ra);
      store_chunk(st[(kt + 1) & 1].b, rb);
    }
    __syncthreads();
  }
  if (kNorms) {
    if (tid < kTile) xn_s[tid] = nrm;
    else zn_s[tid - kTile] = nrm;
    __syncthreads();
  }
}

// (alpha*cross + c)^degree by repeated multiplication, as lax.integer_pow
// does: a negative base keeps its sign for odd degrees; degree 0 gives 1
__device__ __forceinline__ float int_pow(float v, int degree) {
  float r = 1.f;
  for (int i = 0; i < degree; ++i) r *= v;
  return r;
}

// kGaussian: p0 = gamma.  kPolynomial: p0 = alpha, p1 = c.
template <typename T, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
    gram_kernel(const T* __restrict__ x, const T* __restrict__ z, float* __restrict__ out, int n,
                int m, int d, float p0, float p1, int degree) {
  __shared__ __align__(16) Stage st[2];
  __shared__ float xn_s[kTile];
  __shared__ float zn_s[kTile];
  const int row0 = blockIdx.x * kTile, col0 = blockIdx.y * kTile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  gram_tile_body<T, kEpi == kGaussian>(x, z, n, m, d, row0, col0, st, acc, xn_s, zn_s);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool vec = (m % 4) == 0;  // rows then start 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = lane_index(ty, i);
    const int row = row0 + r;
    if (row >= n) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kEpi == kGaussian) {
        const float sq = fmaxf(xn_s[r] - 2.f * acc[i][j] + zn_s[lane_index(tx, j)], 0.f);
        v[j] = expf(-p0 * sq);
      } else {
        v[j] = int_pow(p0 * acc[i][j] + p1, degree);
      }
    }
    float* orow = out + (size_t)row * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col0 + h * kHalf + tx * 4;
      if (vec && c0 + 3 < m) {
        *reinterpret_cast<float4*>(orow + c0) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c0 + q < m) orow[c0 + q] = v[4 * h + q];
      }
    }
  }
}

template <typename T>
int launch(int epi, const void* x, const void* z, float* out, int n, int m, int d, float p0,
           float p1, int degree, cudaStream_t stream) {
  if (n < 0 || m < 0 || d < 0 || degree < 0) return kErrShape;
  if (n == 0 || m == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > kMaxGridY) return kErrShape;
  const T* xt = static_cast<const T*>(x);
  const T* zt = static_cast<const T*>(z);
  if (epi == kGaussian)
    gram_kernel<T, kGaussian><<<grid, kThreads, 0, stream>>>(xt, zt, out, n, m, d, p0, p1, degree);
  else
    gram_kernel<T, kPolynomial><<<grid, kThreads, 0, stream>>>(xt, zt, out, n, m, d, p0, p1, degree);
  return (int)cudaGetLastError();
}

int dispatch(int epi, const void* x, const void* z, int bf16, float* out, int n, int m, int d,
             float p0, float p1, int degree, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(epi, x, z, out, n, m, d, p0, p1, degree, st)
              : launch<float>(epi, x, z, out, n, m, d, p0, p1, degree, st);
}

}  // namespace

extern "C" {

// x: (n, d), z: (m, d), both f32 or both bf16 (bf16 = 1); out: (n, m) f32.
// Returns 0, a cudaError_t, or -1 for a shape the kernel does not take
// (negative sizes, m > 65535 * 128).
int ks_gram_block(const void* x, const void* z, int bf16, float* out, int n, int m, int d,
                  float gamma, void* stream) {
  return dispatch(kGaussian, x, z, bf16, out, n, m, d, gamma, 0.f, 0, stream);
}

// as ks_gram_block; -1 also for degree < 0
int ks_poly_block(const void* x, const void* z, int bf16, float* out, int n, int m, int d,
                  float alpha, float c, int degree, void* stream) {
  return dispatch(kPolynomial, x, z, bf16, out, n, m, d, alpha, c, degree, stream);
}

const char* ks_gram_error_string(int code) {
  if (code == kErrShape) return "shape or degree not supported by the gram kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
