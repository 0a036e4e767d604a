// One-pass TF32 solver product for Hopper (sm_90a), with a plain C interface.
//
// Replaces no Pallas kernel.  It carries the reference's solver precision
// setting (keystone_tpu/utils/precision.py:213, sdot under
// KEYSTONE_SOLVER_PRECISION=default, where the solver contractions drop to
// the backend's default precision): on the card that default is TF32, and
// PyTorch's only TF32 switch (torch.backends.cuda.matmul.allow_tf32) is
// process-global, so a serving thread's forward running beside a solve
// would change with it.  This product is TF32 for its own call only.
//
//   C (m x n, f32, row-major) = sum over p < k of A(p, i) * B(p, j)
//   A(p, i) = a[p * a_sp + i * a_si], B(p, j) = b[p * b_sp + j * b_sj]
//
// so C = a^T b for row-major (k, m) and (k, n) tensors (the solvers' form:
// Gramians, A^T.target, EM sufficient statistics, covariances, gradients)
// and C = a b for a row-major (m, k) a (a_sp = 1, a_si = k).  Views with
// any strides are read in place.
//
// Rounding.  Each operand is rounded to TF32 with cvt.rna.tf32.f32 (to
// nearest, ties away from zero) as it is staged into shared memory, once
// an element; every fragment then reads rounded values.  Without the
// rounding the tensor core drops the low 13 bits, which truncates.
// Products accumulate in f32.  The tensor core adds into its accumulator
// with truncation, which biases a long same-signed sum (a Gramian's
// diagonal) toward zero, so each k-tile's products go into a fresh
// fragment that is added to the accumulators on the CUDA cores, rounded to
// nearest, as csrc/gram.cu does.
//
// What bounds it on an H100: 2*m*n*k flops against (m + n)*k reads and
// m*n writes.  The weighted BCD's Gramian (4096 x 4096 over 2048 rows) is
// operations-bound (68.7 GFLOP against 495 TFLOP/s of TF32); the EM's
// statistics (64 x 64 over 131 072 rows) and the BCD's A^T.target (4096 x
// 64 over 2048) are bytes-bound.
//
// What the design does about it.  mma.sync m16n8k8 (tf32) is used, not
// wgmma: wgmma takes tf32 operands K-major only, and these products reduce
// over the rows of row-major tensors, so K is their strided dimension;
// the transpose happens here, in the staging into shared memory.  A block
// of 128 threads (four warps, 2 x 2, each 32 x 32) owns a 64 x 64 output
// tile and walks its range of k in tiles of 32, double-buffered: the next
// tile's loads are in registers while the tensor cores work on the current
// one.  Shared rows are padded by 8 words, so that both the staging stores
// and the fragment loads are free of bank conflicts.  Where an operand's
// columns are contiguous and its rows and base 16-byte aligned, a thread
// loads 4 columns with one 16-byte load; otherwise one element at a time
// by its strides.  Loads past an edge read zero; stores are bounds-checked.
//
// Split-K.  Small outputs over long reductions (the EM's 64 x 64 over
// 131 072 rows is one tile) would leave most of the 132 SMs idle, so the
// caller may cut k into `splits` chunks of `chunk` rows (a multiple of
// 32): each (tile, chunk) block writes its partial sum to a workspace, and
// a second kernel adds the partials of each element in a fixed order.  No
// atomics: two calls give the same bits.
//
// Launches on the caller's stream, allocates nothing, does not synchronize.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps, 2 x 2 over the tile
constexpr int kTile = 64;      // output tile: kTile x kTile
constexpr int kBK = 32;        // rows of k a stage
constexpr int kLd = kTile + 8; // padded shared row (words)
constexpr int kVec = kBK * kTile / 4 / kThreads;  // 16-byte loads a thread a stage (4)
constexpr int kScalar = kBK * kTile / kThreads;   // element loads a thread a stage (16)
constexpr int kMaxGrid = 65535;
constexpr int kErrShape = -1;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += A . B, one m16n8k8 tf32 product (fragments as the PTX ISA lays them
// out: lane 4g + t holds A rows g, g + 8 at columns t, t + 4; B rows t,
// t + 4 at column g; D rows g, g + 8 at columns 2t, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage of an operand, rows p0 .. p0 + 31 (below pend) by columns
// c0 .. c0 + 63 (below cend), into registers.  kV: 16-byte loads of 4
// contiguous columns (the caller checked stride and alignment).
template <bool kV>
__device__ __forceinline__ void load_stage(const float* __restrict__ src, long long s_p, long long s_c,
                                           int p0, int pend, int c0, int cend, float (&v)[kScalar]) {
  const int tid = threadIdx.x;
  if (kV) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int idx = tid + kThreads * q;
      const int r = idx >> 4, c = (idx & 15) * 4;
      const int p = p0 + r, col = c0 + c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < pend && col < cend) {
        const float* ptr = src + (long long)p * s_p + col;
        if (col + 3 < cend) {
          x = *reinterpret_cast<const float4*>(ptr);
        } else {
          x.x = ptr[0];
          if (col + 1 < cend) x.y = ptr[1];
          if (col + 2 < cend) x.z = ptr[2];
        }
      }
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kScalar; ++q) {
      const int idx = tid + kThreads * q;
      const int r = idx >> 6, c = idx & 63;
      const int p = p0 + r, col = c0 + c;
      v[q] = (p < pend && col < cend) ? src[(long long)p * s_p + (long long)col * s_c] : 0.f;
    }
  }
}

// The registers of load_stage into a shared stage, rounded to TF32.
template <bool kV>
__device__ __forceinline__ void store_stage(uint32_t (*s)[kLd], const float (&v)[kScalar]) {
  const int tid = threadIdx.x;
  if (kV) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int idx = tid + kThreads * q;
      const int r = idx >> 4, c = (idx & 15) * 4;
      *reinterpret_cast<uint4*>(&s[r][c]) =
          make_uint4(to_tf32(v[4 * q]), to_tf32(v[4 * q + 1]), to_tf32(v[4 * q + 2]), to_tf32(v[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < kScalar; ++q) {
      const int idx = tid + kThreads * q;
      s[idx >> 6][idx & 63] = to_tf32(v[q]);
    }
  }
}

template <bool kVA, bool kVB>
__global__ void __launch_bounds__(kThreads)
solver_gemm_kernel(const float* __restrict__ a, long long a_sp, long long a_si, const float* __restrict__ b,
                   long long b_sp, long long b_sj, float* __restrict__ out, int m, int n, int k, int chunk) {
  __shared__ __align__(16) uint32_t sa[2][kBK][kLd];
  __shared__ __align__(16) uint32_t sb[2][kBK][kLd];

  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(k, kbeg + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;

  float acc[2][4][4];
  float part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  float va[kScalar], vb[kScalar];
  const int stages = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  if (stages > 0) {
    load_stage<kVA>(a, a_sp, a_si, kbeg, kend, i0, m, va);
    load_stage<kVB>(b, b_sp, b_sj, kbeg, kend, j0, n, vb);
    store_stage<kVA>(sa[0], va);
    store_stage<kVB>(sb[0], vb);
  }
  __syncthreads();

  for (int st = 0; st < stages; ++st) {
    const int cur = st & 1;
    const bool more = st + 1 < stages;
    if (more) {
      const int p0 = kbeg + (st + 1) * kBK;
      load_stage<kVA>(a, a_sp, a_si, p0, kend, i0, m, va);
      load_stage<kVB>(b, b_sp, b_sj, p0, kend, j0, n, vb);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int kr = ks * 8 + t;
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int rb = wm * 32 + mt * 16 + g;
        af[mt][0] = sa[cur][kr][rb];
        af[mt][1] = sa[cur][kr][rb + 8];
        af[mt][2] = sa[cur][kr + 4][rb];
        af[mt][3] = sa[cur][kr + 4][rb + 8];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cb = wn * 32 + nt * 8 + g;
        bf[nt][0] = sb[cur][kr][cb];
        bf[nt][1] = sb[cur][kr + 4][cb];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(part[mt][nt], af[mt], bf[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    if (more) {
      store_stage<kVA>(sa[cur ^ 1], va);
      store_stage<kVB>(sb[cur ^ 1], vb);
    }
    __syncthreads();
  }

  // this block's chunk: the output itself, or its partial in the workspace
  float* dst = out + (size_t)blockIdx.z * (size_t)m * (size_t)n;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int j = j0 + wn * 32 + nt * 8 + 2 * t + (e & 1);
        if (i < m && j < n) dst[(size_t)i * n + j] = acc[mt][nt][e];
      }
}

// out[e] = the sum of the `splits` partials of element e, in a fixed
// order: thread row ty adds partials ty, ty + 8, ... in turn, then the
// eight sums are added in row order.  Neighbouring threads read
// neighbouring elements of one partial.
constexpr int kRedX = 32, kRedY = 8;

__global__ void __launch_bounds__(kRedX * kRedY)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out, long long mn, int splits) {
  __shared__ float sums[kRedY][kRedX];
  const long long e = (long long)blockIdx.x * kRedX + threadIdx.x;
  float s = 0.f;
  if (e < mn)
    for (int z = threadIdx.y; z < splits; z += kRedY) s += part[(long long)z * mn + e];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < mn) {
    float total = sums[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kRedY; ++y) total += sums[y][threadIdx.x];
    out[e] = total;
  }
}

bool vec_ok(const float* p, long long s_outer, long long s_inner) {
  return s_inner == 1 && s_outer % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kVA, bool kVB>
void launch_gemm(dim3 grid, cudaStream_t st, const float* a, long long a_sp, long long a_si, const float* b,
                 long long b_sp, long long b_sj, float* dst, int m, int n, int k, int chunk) {
  solver_gemm_kernel<kVA, kVB><<<grid, kThreads, 0, st>>>(a, a_sp, a_si, b, b_sp, b_sj, dst, m, n, k, chunk);
}

}  // namespace

extern "C" {

// C (m, n) = A^T B as above, f32.  splits >= 1 chunks of `chunk` rows of
// k (a multiple of 32; (splits - 1) * chunk < k <= splits * chunk, or
// splits = 1 for any k >= 0).  With splits > 1, ws holds splits * m * n
// floats of device memory for the partials.  Returns 0, a cudaError_t, or
// -1 for a shape or split the kernels do not take.
int ks_solver_gemm(const float* a, long long a_sp, long long a_si, const float* b, long long b_sp,
                   long long b_sj, float* out, int m, int n, int k, int splits, int chunk, float* ws,
                   void* stream) {
  if (m < 0 || n < 0 || k < 0 || splits < 1 || splits > kMaxGrid) return kErrShape;
  if (splits > 1 && (ws == nullptr || chunk <= 0 || chunk % kBK != 0 ||
                     (long long)(splits - 1) * chunk >= k || (long long)splits * chunk < k))
    return kErrShape;
  if (m == 0 || n == 0) return 0;
  if (splits == 1) chunk = k;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, splits);
  if (grid.y > (unsigned)kMaxGrid) return kErrShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? ws : out;
  const bool va = vec_ok(a, a_sp, a_si), vb = vec_ok(b, b_sp, b_sj);
  if (va && vb)
    launch_gemm<true, true>(grid, st, a, a_sp, a_si, b, b_sp, b_sj, dst, m, n, k, chunk);
  else if (va)
    launch_gemm<true, false>(grid, st, a, a_sp, a_si, b, b_sp, b_sj, dst, m, n, k, chunk);
  else if (vb)
    launch_gemm<false, true>(grid, st, a, a_sp, a_si, b, b_sp, b_sj, dst, m, n, k, chunk);
  else
    launch_gemm<false, false>(grid, st, a, a_sp, a_si, b, b_sp, b_sj, dst, m, n, k, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long mn = (long long)m * n;
  const long long blocks = (mn + kRedX - 1) / kRedX;
  if (blocks > 0x7fffffffLL) return kErrShape;
  reduce_splits_kernel<<<(unsigned)blocks, dim3(kRedX, kRedY), 0, st>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}

const char* ks_solver_error_string(int code) {
  if (code == kErrShape) return "shape or split not supported by the solver product";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
