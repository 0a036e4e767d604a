// Fisher-vector encode kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels of keystone_tpu/ops/fisher_pallas.py:
//   fisher_encode_pallas (_fv_kernel)       -> ks_fisher_encode
//   fused_forward_pallas (_fv_fused_kernel) -> ks_fused_forward
// Both entry kernels end in one device tile body, fv_tile_body, as the
// Pallas kernels share _fv_tile_body, so their math cannot drift apart.
//
// Math per image (descriptors x_t, mask m_t, diagonal GMM w, mu, var):
//   logp_tk = log w_k + log N(x_t; mu_k, var_k)       (gemm expansion)
//   g_tk    = softmax_k(logp_t) * m_t
//   s0_k = sum_t g_tk,  s1_kj = sum_t g_tk x_tj,  s2_kj = sum_t g_tk x_tj^2
//   phi1 = (s1 - s0 mu) / sigma / (T sqrt(w)),
//   phi2 = ((s2 - 2 mu s1 + s0 mu^2) / var - s0) / (T sqrt(2w)),  T = max(sum m, 1)
// The fused kernel first applies the SIFT normalize (L2, min 0.2, L2,
// eps 1e-8; optional), subtracts the PCA mean and projects d_in -> d.
//
// What bounds it on an H100: per image four contractions of T*d*K (two
// posterior gemms, the g^T x and g^T x^2 statistics), 8*T*d*K flops,
// against T*d descriptor reads and 2*K*d output writes -- a few hundred
// flops per byte in f32, far above the card's f32 ridge (67 TFLOP/s of
// non-tensor f32 over 3.35 TB/s = 20 flop/byte).  So it is bound by f32
// FMA throughput, not by memory.
//
// What the design does about it: one block per image walks that image's
// T descriptors tile by tile.  The TPU's sequential grid axis becomes a
// loop inside the block, so no order between blocks is assumed.  The
// (K, 2d) statistics accumulators stay in registers for the whole walk
// (8 components x 8 dims x {x, x^2} per thread); the posterior weights
// (2d, K) stay in shared memory; g never leaves shared memory.  Device
// memory sees one read of the descriptors and one write of the FV.  Both
// gemms are register-tiled outer products (8x16 and 4x8 per thread) in
// f32 FMA: no tensor cores, the port's forward is true f32.  Ragged T is
// handled in the kernel: the tail tile is zero-filled and its mask is 0,
// so no padded copy of the descriptors is made.  At batch 128 the grid
// is 128 blocks on 132 SMs, one block (8 warps) per SM: the occupancy is
// low and latency is hidden only by the register tiling; a faster
// version would split T across blocks or use several images per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAccK = 8;   // components per thread in the statistics
constexpr int kAccD = 8;   // descriptor dims per thread (x and x^2 each)
constexpr int kPostT = 4;  // posterior micro tile: descriptors
constexpr int kPostK = 8;  // posterior micro tile: components
constexpr int kMaxTile = 32;
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most one block may use
constexpr int kErrShape = -1;          // shape the kernel does not take

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// row stride of the g buffer; the fused kernel's raw (tile, d_in) tile
// lives in the same buffer before the posterior overwrites it
__host__ __device__ inline int gstride_of(int K, int d_in) { return round4(K > d_in ? K : d_in); }

// shared memory in floats; d_in == 0 for the plain encode.  Every part
// is a multiple of 4 floats, so each starts 16-byte aligned.
__host__ __device__ inline size_t smem_floats(int tile, int d, int K, int d_in) {
  size_t f = (size_t)2 * d * K + 2 * (size_t)round4(K) + (size_t)tile * 2 * d +
             (size_t)tile * gstride_of(K, d_in) + round4(tile) + round4(kWarps);
  if (d_in > 0) f += (size_t)d_in * d + round4(d_in);
  return f;
}

struct Smem {
  float* wt;    // (2d, K) posterior weights; rows interleaved (x_j, x_j^2)
  float* cst;   // (K,) per-component constant of the log posterior
  float* s0;    // (K,) sum_t g
  float* xx;    // (tile, 2d) descriptor tile; columns interleaved (x_j, x_j^2)
  float* g;     // (tile, gstride) log posterior, then g
  float* msk;   // (tile,)
  float* red;   // (kWarps,) block reduction
  float* comp;  // (d_in, d) fused kernel only
  float* mean;  // (d_in,) fused kernel only
};

__device__ inline Smem carve(float* p, int tile, int d, int K, int d_in) {
  Smem s;
  s.wt = p;   p += 2 * d * K;
  s.cst = p;  p += round4(K);
  s.s0 = p;   p += round4(K);
  s.xx = p;   p += tile * 2 * d;
  s.g = p;    p += tile * gstride_of(K, d_in);
  s.msk = p;  p += round4(tile);
  s.red = p;  p += round4(kWarps);
  s.comp = p; p += d_in * d;
  s.mean = p;
  return s;
}

// posterior weights and constants into shared memory, s0 zeroed
__device__ inline void fv_prologue(const Smem& s, const float* __restrict__ wt,
                                   const float* __restrict__ cst, int d, int K) {
  const float4* src = reinterpret_cast<const float4*>(wt);
  float4* dst = reinterpret_cast<float4*>(s.wt);
  for (int i = threadIdx.x; i < (2 * d * K) / 4; i += kThreads) dst[i] = src[i];
  for (int k = threadIdx.x; k < K; k += kThreads) {
    s.cst[k] = cst[k];
    s.s0[k] = 0.f;
  }
}

// One descriptor tile, shared by both kernels: log posterior gemm ->
// masked softmax -> s0 and the (s1, s2) register accumulators.  s.xx and
// s.msk hold the tile on entry (rows past the data zero, mask 0).
__device__ __forceinline__ void fv_tile_body(const Smem& s, int tile, int d, int K, int gstride,
                                             float (&acc)[kAccK][2 * kAccD], int kb, int jb,
                                             bool owner) {
  const int tid = threadIdx.x;
  const int d2 = 2 * d;

  // log posterior: g = cst + xx . wt, (tile x 2d) x (2d x K)
  const int kgroups = K / kPostK;
  const int micro = (tile / kPostT) * kgroups;
  for (int m = tid; m < micro; m += kThreads) {
    const int t0 = (m / kgroups) * kPostT;
    const int k0 = (m % kgroups) * kPostK;
    float p[kPostT][kPostK];
#pragma unroll
    for (int i = 0; i < kPostT; ++i)
#pragma unroll
      for (int j = 0; j < kPostK; ++j) p[i][j] = 0.f;
    for (int c = 0; c < d2; ++c) {
      const float4 w0 = *reinterpret_cast<const float4*>(s.wt + c * K + k0);
      const float4 w1 = *reinterpret_cast<const float4*>(s.wt + c * K + k0 + 4);
      const float wv[kPostK] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < kPostT; ++i) {
        const float xv = s.xx[(t0 + i) * d2 + c];
#pragma unroll
        for (int j = 0; j < kPostK; ++j) p[i][j] = fmaf(xv, wv[j], p[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPostT; ++i)
#pragma unroll
      for (int j = 0; j < kPostK; ++j)
        s.g[(t0 + i) * gstride + k0 + j] = s.cst[k0 + j] + p[i][j];
  }
  __syncthreads();

  // g = softmax over K (row max, exp, sum) times the mask; one warp a row
  const int warp = tid / 32, lane = tid % 32;
  for (int t = warp; t < tile; t += kWarps) {
    float* row = s.g + t * gstride;
    float mx = -INFINITY;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(row[k] - mx);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float scale = s.msk[t] / sum;
    for (int k = lane; k < K; k += 32) row[k] *= scale;
  }
  __syncthreads();

  for (int k = tid; k < K; k += kThreads) {
    float a = 0.f;
    for (int t = 0; t < tile; ++t) a += s.g[t * gstride + k];
    s.s0[k] += a;
  }

  // statistics: acc[kk][2jj] += g[t][k] x[t][j], acc[kk][2jj+1] += g[t][k] x[t][j]^2
  if (owner) {
    const float* gp = s.g + kb * kAccK;
    const float* xp = s.xx + jb * 2 * kAccD;
    for (int t = 0; t < tile; ++t) {
      const float4 g0 = *reinterpret_cast<const float4*>(gp + t * gstride);
      const float4 g1 = *reinterpret_cast<const float4*>(gp + t * gstride + 4);
      const float gv[kAccK] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      float xv[2 * kAccD];
#pragma unroll
      for (int q = 0; q < 2 * kAccD / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xp + t * d2 + 4 * q);
        xv[4 * q] = v.x;
        xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z;
        xv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < kAccK; ++kk)
#pragma unroll
        for (int c = 0; c < 2 * kAccD; ++c) acc[kk][c] = fmaf(gv[kk], xv[c], acc[kk][c]);
    }
  }
  __syncthreads();  // the next tile overwrites s.xx and s.g
}

// sum of the image's mask over T, the same value in every thread
__device__ inline float block_mask_count(const Smem& s, const float* __restrict__ mask_img, int T) {
  float c = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) c += mask_img[t];
  c = warp_sum(c);
  if (threadIdx.x % 32 == 0) s.red[threadIdx.x / 32] = c;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) tot += s.red[i];
  return tot;
}

// phi1, phi2 from the accumulators; out_img is (2, K, d) row-major
__device__ inline void fv_finalize(const Smem& s, const float (&acc)[kAccK][2 * kAccD], float cnt,
                                   const float* __restrict__ mu, const float* __restrict__ var,
                                   const float* __restrict__ w, float* __restrict__ out_img, int d,
                                   int K, int kb, int jb, bool owner) {
  if (!owner) return;
  const float tn = fmaxf(cnt, 1.f);
#pragma unroll
  for (int kk = 0; kk < kAccK; ++kk) {
    const int k = kb * kAccK + kk;
    const float s0 = s.s0[k];
    const float a1 = tn * sqrtf(w[k]);
    const float a2 = tn * sqrtf(2.f * w[k]);
    float p1[kAccD], p2[kAccD];
#pragma unroll
    for (int jj = 0; jj < kAccD; ++jj) {
      const int j = jb * kAccD + jj;
      const float m = mu[k * d + j];
      const float v = var[k * d + j];
      const float s1 = acc[kk][2 * jj];
      const float s2 = acc[kk][2 * jj + 1];
      p1[jj] = ((s1 - s0 * m) / sqrtf(v)) / a1;
      p2[jj] = ((s2 - 2.f * m * s1 + s0 * (m * m)) / v - s0) / a2;
    }
    float4* o1 = reinterpret_cast<float4*>(out_img + k * d + jb * kAccD);
    float4* o2 = reinterpret_cast<float4*>(out_img + K * d + k * d + jb * kAccD);
    o1[0] = make_float4(p1[0], p1[1], p1[2], p1[3]);
    o1[1] = make_float4(p1[4], p1[5], p1[6], p1[7]);
    o2[0] = make_float4(p2[0], p2[1], p2[2], p2[3]);
    o2[1] = make_float4(p2[4], p2[5], p2[6], p2[7]);
  }
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads, 1)
    fv_encode_kernel(const TIn* __restrict__ x, const float* __restrict__ mask,
                     const float* __restrict__ wt, const float* __restrict__ cst,
                     const float* __restrict__ mu, const float* __restrict__ var,
                     const float* __restrict__ w, float* __restrict__ out, int T, int d, int K,
                     int tile) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), tile, d, K, 0);
  const int gstride = gstride_of(K, 0);
  const int tid = threadIdx.x;
  const int kb = tid / (d / kAccD), jb = tid % (d / kAccD);
  const bool owner = kb < K / kAccK;
  float acc[kAccK][2 * kAccD];
#pragma unroll
  for (int kk = 0; kk < kAccK; ++kk)
#pragma unroll
    for (int c = 0; c < 2 * kAccD; ++c) acc[kk][c] = 0.f;

  fv_prologue(s, wt, cst, d, K);
  const TIn* ximg = x + (size_t)blockIdx.x * T * d;
  const float* mimg = mask + (size_t)blockIdx.x * T;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int rows = min(tile, T - t0);
    for (int i = tid; i < tile * d; i += kThreads) {
      const int r = i / d, j = i - r * d;
      const float v = r < rows ? to_f32(ximg[(size_t)t0 * d + i]) : 0.f;
      s.xx[r * 2 * d + 2 * j] = v;
      s.xx[r * 2 * d + 2 * j + 1] = v * v;
    }
    for (int r = tid; r < tile; r += kThreads) s.msk[r] = r < rows ? mimg[t0 + r] : 0.f;
    __syncthreads();
    fv_tile_body(s, tile, d, K, gstride, acc, kb, jb, owner);
  }
  const float cnt = block_mask_count(s, mimg, T);
  fv_finalize(s, acc, cnt, mu, var, w, out + (size_t)blockIdx.x * 2 * K * d, d, K, kb, jb, owner);
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads, 1)
    fv_fused_kernel(const TIn* __restrict__ x, const float* __restrict__ mask,
                    const float* __restrict__ comp, const float* __restrict__ mean,
                    int normalize, const float* __restrict__ wt, const float* __restrict__ cst,
                    const float* __restrict__ mu, const float* __restrict__ var,
                    const float* __restrict__ w, float* __restrict__ out, int T, int d_in, int d,
                    int K, int tile) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), tile, d, K, d_in);
  const int gstride = gstride_of(K, d_in);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kb = tid / (d / kAccD), jb = tid % (d / kAccD);
  const bool owner = kb < K / kAccK;
  float acc[kAccK][2 * kAccD];
#pragma unroll
  for (int kk = 0; kk < kAccK; ++kk)
#pragma unroll
    for (int c = 0; c < 2 * kAccD; ++c) acc[kk][c] = 0.f;

  fv_prologue(s, wt, cst, d, K);
  {
    const float4* src = reinterpret_cast<const float4*>(comp);
    float4* dst = reinterpret_cast<float4*>(s.comp);
    for (int i = tid; i < (d_in * d) / 4; i += kThreads) dst[i] = src[i];
    for (int i = tid; i < d_in; i += kThreads) s.mean[i] = mean ? mean[i] : 0.f;
  }
  float* raw = s.g;  // (tile, d_in), consumed before the posterior writes s.g
  const TIn* ximg = x + (size_t)blockIdx.x * T * d_in;
  const float* mimg = mask + (size_t)blockIdx.x * T;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int rows = min(tile, T - t0);
    for (int i = tid; i < tile * d_in; i += kThreads) {
      const int r = i / d_in;
      raw[i] = r < rows ? to_f32(ximg[(size_t)t0 * d_in + i]) : 0.f;
    }
    for (int r = tid; r < tile; r += kThreads) s.msk[r] = r < rows ? mimg[t0 + r] : 0.f;
    __syncthreads();

    // SIFT normalize (optional) and centering, one warp a row.  A zero
    // tail row stays finite: its norm clamps to 1e-8.
    for (int t = warp; t < tile; t += kWarps) {
      float* row = raw + t * d_in;
      if (normalize) {
        float ss = 0.f;
        for (int i = lane; i < d_in; i += 32) ss += row[i] * row[i];
        float nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-8f);
        ss = 0.f;
        for (int i = lane; i < d_in; i += 32) {
          const float v = fminf(row[i] / nrm, 0.2f);
          row[i] = v;
          ss += v * v;
        }
        nrm = fmaxf(sqrtf(warp_sum(ss)), 1e-8f);
        for (int i = lane; i < d_in; i += 32) row[i] = row[i] / nrm - s.mean[i];
      } else {
        for (int i = lane; i < d_in; i += 32) row[i] -= s.mean[i];
      }
    }
    __syncthreads();

    // PCA projection z = raw . comp, 2 rows x 4 dims per thread
    const int jq = d / 4;
    for (int m = tid; m < (tile / 2) * jq; m += kThreads) {
      const int r0 = (m / jq) * 2, j0 = (m % jq) * 4;
      float z[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int i = 0; i < d_in; ++i) {
        const float4 cv = *reinterpret_cast<const float4*>(s.comp + i * d + j0);
        const float a0 = raw[r0 * d_in + i], a1 = raw[(r0 + 1) * d_in + i];
        z[0][0] = fmaf(a0, cv.x, z[0][0]);
        z[0][1] = fmaf(a0, cv.y, z[0][1]);
        z[0][2] = fmaf(a0, cv.z, z[0][2]);
        z[0][3] = fmaf(a0, cv.w, z[0][3]);
        z[1][0] = fmaf(a1, cv.x, z[1][0]);
        z[1][1] = fmaf(a1, cv.y, z[1][1]);
        z[1][2] = fmaf(a1, cv.z, z[1][2]);
        z[1][3] = fmaf(a1, cv.w, z[1][3]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = z[r][q];
          s.xx[(r0 + r) * 2 * d + 2 * (j0 + q)] = v;
          s.xx[(r0 + r) * 2 * d + 2 * (j0 + q) + 1] = v * v;
        }
    }
    __syncthreads();
    fv_tile_body(s, tile, d, K, gstride, acc, kb, jb, owner);
  }
  const float cnt = block_mask_count(s, mimg, T);
  fv_finalize(s, acc, cnt, mu, var, w, out + (size_t)blockIdx.x * 2 * K * d, d, K, kb, jb, owner);
}

// the largest tile (a multiple of 8, at most kMaxTile) whose shared
// memory fits; 0 when the shape is not one the kernels take
int pick_tile(int d, int K, int d_in) {
  if (d <= 0 || K <= 0 || d % kAccD || K % kAccK) return 0;
  if ((K / kAccK) * (d / kAccD) > kThreads) return 0;  // one accumulator tile a thread
  if (d_in < 0 || d_in % 4) return 0;
  for (int tile = kMaxTile; tile >= 8; tile -= 8)
    if (smem_floats(tile, d, K, d_in) * sizeof(float) <= kSmemLimit) return tile;
  return 0;
}

template <typename TIn>
int launch_encode(const void* x, const float* mask, const float* wt, const float* cst,
                  const float* mu, const float* var, const float* w, float* out, int n, int T,
                  int d, int K, cudaStream_t stream) {
  const int tile = pick_tile(d, K, 0);
  if (tile == 0) return kErrShape;
  if (n == 0) return 0;
  const size_t bytes = smem_floats(tile, d, K, 0) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fv_encode_kernel<TIn>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  fv_encode_kernel<TIn><<<n, kThreads, bytes, stream>>>(
      static_cast<const TIn*>(x), mask, wt, cst, mu, var, w, out, T, d, K, tile);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_fused(const void* x, const float* mask, const float* comp, const float* mean,
                 int normalize, const float* wt, const float* cst, const float* mu,
                 const float* var, const float* w, float* out, int n, int T, int d_in, int d,
                 int K, cudaStream_t stream) {
  const int tile = d_in > 0 ? pick_tile(d, K, d_in) : 0;
  if (tile == 0) return kErrShape;
  if (n == 0) return 0;
  const size_t bytes = smem_floats(tile, d, K, d_in) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fv_fused_kernel<TIn>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  fv_fused_kernel<TIn><<<n, kThreads, bytes, stream>>>(static_cast<const TIn*>(x), mask, comp,
                                                      mean, normalize, wt, cst, mu, var, w, out,
                                                      T, d_in, d, K, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, T, d) f32 or bf16 (x_bf16 = 1); mask: (n, T) f32;
// wt: (2d, K) posterior weights, cst: (K,); mu, var: (K, d); w: (K,);
// out: (n, 2*K*d) f32.  Returns 0, a cudaError_t, or -1 for a shape
// the kernel does not take: d and K multiples of 8 with K*d <= 16384
// (one register accumulator tile a thread), d_in a multiple of 4, and
// shared memory within 227 KB.
int ks_fisher_encode(const void* x, int x_bf16, const float* mask, const float* wt,
                     const float* cst, const float* mu, const float* var, const float* w,
                     float* out, int n, int T, int d, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_encode<__nv_bfloat16>(x, mask, wt, cst, mu, var, w, out, n, T, d, K, st)
                : launch_encode<float>(x, mask, wt, cst, mu, var, w, out, n, T, d, K, st);
}

// x: (n, T, d_in) f32 or bf16; comp: (d_in, d); mean: (d_in,) or null;
// the rest as ks_fisher_encode.
int ks_fused_forward(const void* x, int x_bf16, const float* mask, const float* comp,
                     const float* mean, int normalize, const float* wt, const float* cst,
                     const float* mu, const float* var, const float* w, float* out, int n, int T,
                     int d_in, int d, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_fused<__nv_bfloat16>(x, mask, comp, mean, normalize, wt, cst, mu, var, w,
                                              out, n, T, d_in, d, K, st)
                : launch_fused<float>(x, mask, comp, mean, normalize, wt, cst, mu, var, w, out, n,
                                      T, d_in, d, K, st);
}

const char* ks_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the Fisher-vector kernels";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
