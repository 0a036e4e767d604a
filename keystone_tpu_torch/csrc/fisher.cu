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
// flops per byte.  On the CUDA cores (67 TFLOP/s of f32 over 3.35 TB/s, a
// ridge of 20 flop/byte) that is FMA-bound, and so is 3xTF32 on the tensor
// cores (495/3 = 165 TFLOP/s of f32-grade work, a ridge of ~49).
//
// Precision.  The reference computes in f32.  The two contractions run on
// the tensor cores as 3xTF32 mma.sync m16n8k8: each f32 operand v splits
// into big = tf32(v) and small = tf32(v - big), both rounded to nearest,
// and a.b ~ a_s.b_b + a_b.b_s + a_b.b_b, the small terms first; only
// a_s.b_s (~2^-22 relative) is dropped.  The tensor core adds into its
// accumulator with truncation, which biases a long same-signed sum (s2 is
// one over all T) toward zero; so every k-step's three products go into a
// fresh fragment that is added to the running sums on the CUDA cores,
// rounded to nearest, after a half-ulp correction of the truncation (see
// mma3_add).  bf16 descriptors are widened to f32 and take the
// same path.  The log posterior's per-component constant (~|log N|, a
// hundred at d = 64) comes in two f32 parts, its rounded value and what
// the rounding dropped (the wrapper computes it in float64); the low part
// starts each descriptor's sum.  Rounded once into one f32, the constant
// would be off by up to half its ulp on every descriptor alike, a shift of
// that component's posterior mass that the sums over T carry: that, not
// the products, set the largest FV error against float64 on the card.
//
// Two paths.  The tiled kernels below take the shapes of pick_tile: d and
// K multiples of 8 with (d/8)(K/8) fragments within the registers (K*d <=
// 16384), d_in a multiple of 4, and a tile of at least 8 rows within
// shared memory; the scorer's and the fit's shapes are all such.  Every
// other shape takes the general path at the end of this file: plain
// kernels on the CUDA cores through a device workspace, with float64 sums,
// so that the port encodes every GMM the reference encodes.  The entry
// points pick the path from the shape before any launch.
//
// What the tiled design does about it: one block per image walks that image's
// T descriptors tile by tile.  The TPU's sequential grid axis becomes a
// loop inside the block, so no order between blocks is assumed.  The
// posterior weights (2d, K) stay resident and unsplit in shared memory;
// each warp splits its slice of them in registers at fragment load, once
// a tile.  g never leaves shared memory.  The (2d, K) statistics stay in
// registers for the whole walk as 32 m16n8 fragments a warp (128 floats a
// thread), a 4 x 8 block of the fragment grid where d and K allow (the
// main path's do), so that each split fragment feeds 4 or 8 products.
// The hot loops have no branch, so that the fragments' product chains
// overlap.  Device memory sees one read of the descriptors and one write
// of the FV.  Shared rows are padded so that the fragment loads are free
// of bank conflicts (the statistics' x loads are 2-way).  Ragged T is
// handled in the kernel: the tail tile is zero-filled and its mask is 0,
// and m16 rows past a tile of 8 or 24 repeat its last row and are not
// stored, so no padded copy of the descriptors is made.  At batch 128 the
// grid is 128 blocks on 132 SMs, one block (8 warps) per SM: the occupancy
// is low and mma.sync does not reach wgmma's rate; splitting T across
// blocks and wgmma are the next levers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;   // statistics fragments a warp: (d/8)(K/8) <= kWarps * kSlots
constexpr int kPostN = 4;    // posterior n8 tiles a warp holds at once
constexpr int kMaxTile = 32;
constexpr int kBatch = 4;    // 16-byte loads a thread has in flight when staging
constexpr size_t kSmemLimit = 232448;  // 227 KB: the most one block may use
constexpr int kErrShape = -1;          // shape no kernel takes (d, K or d_in not positive)
constexpr int kErrWorkspace = -2;      // the general path was given no workspace
constexpr size_t kWsChunk = size_t(1) << 24;  // workspace floats a chunk of images may take

// 4 consecutive descriptor values as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // the low half is the earlier value
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// n float4s, dst[to(i)] = src[from(i)]: each thread issues kBatch loads
// before it stores any, so a copy pays device memory's latency about
// once, not once a float4
template <typename From, typename To>
__device__ __forceinline__ void copy4(const float4* __restrict__ src, float4* dst, int n, From from, To to) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < n) v[u] = src[from(i0 + u * kThreads)];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * kThreads < n) dst[to(i0 + u * kThreads)] = v[u];
  }
}

// a tile of an image's (T, w) descriptors from row t0 on, w a multiple of
// 4, in chunks of 4 values: put(e, v) stores the chunk at element e of
// the (tile, w) tile; chunks past `rows` are zero.  Batched as copy4.
template <typename TIn, typename Put>
__device__ __forceinline__ void stage_tile(const TIn* __restrict__ src, int w, int tile, int rows, Put put) {
  const int n = tile * w / 4, live = rows * w / 4;
  for (int c0 = threadIdx.x; c0 < n; c0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      v[u] = c < live ? load4(src + 4 * (size_t)c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u * kThreads < n) put(4 * (c0 + u * kThreads), v[u]);
  }
}

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

// the least stride >= v that is r modulo 32 floats (32 banks): rows r
// banks apart put the m16n8k8 fragment loads on distinct banks
__host__ __device__ inline int pad_stride(int v, int r) { return v + ((r - v) % 32 + 32) % 32; }

// row strides: the (2d, K) weights and the (tile, K) posteriors are read
// as B fragments (lanes 4 apart one row apart: 8 banks a row), the
// (tile, 2d) descriptors as the posterior's A fragment (lanes 1 apart one
// row apart: 4 banks a row).  The fused kernel's raw (tile, d_in) tile
// lives in the g buffer before the posterior overwrites it.
__host__ __device__ inline int wstride_of(int K) { return pad_stride(K, 8); }
__host__ __device__ inline int gstride_of(int K, int d_in) { return pad_stride(K > d_in ? K : d_in, 8); }
__host__ __device__ inline int xstride_of(int d) { return pad_stride(2 * d, 4); }

// column of x_j (sq = 0) or x_j^2 (sq = 1) in a descriptor row, and row
// of their weights: blocks of 16, [x_8b .. x_8b+7, x_8b^2 .. x_8b+7^2], so
// that one m16 fragment of the statistics holds s1 and s2 of 8 dims
__host__ __device__ inline int xcol(int j, int sq) { return 16 * (j / 8) + 8 * sq + j % 8; }

// shared memory in floats; d_in == 0 for the plain encode.  Every part
// is a multiple of 4 floats, so each starts 16-byte aligned.
__host__ __device__ inline size_t smem_floats(int tile, int d, int K, int d_in) {
  size_t f = (size_t)2 * d * wstride_of(K) + 3 * (size_t)round4(K) + (size_t)tile * xstride_of(d) +
             (size_t)tile * gstride_of(K, d_in) + round4(tile) + round4(kWarps);
  if (d_in > 0) f += (size_t)d_in * d + round4(d_in);
  return f;
}

struct Smem {
  float* wt;    // (2d, ws) posterior weights, rows in xcol order
  float* cst;   // (K,) per-component constant of the log posterior, in f32
  float* clo;   // (K,) what rounding it to f32 dropped
  float* s0;    // (K,) sum_t g
  float* xx;    // (tile, xs) descriptor tile, x and x^2 in xcol order
  float* g;     // (tile, gs) log posterior, then g
  float* msk;   // (tile,)
  float* red;   // (kWarps,) block reduction
  float* comp;  // (d_in, d) fused kernel only
  float* mean;  // (d_in,) fused kernel only
};

__device__ inline Smem carve(float* p, int tile, int d, int K, int d_in) {
  Smem s;
  s.wt = p;   p += 2 * d * wstride_of(K);
  s.cst = p;  p += round4(K);
  s.clo = p;  p += round4(K);
  s.s0 = p;   p += round4(K);
  s.xx = p;   p += tile * xstride_of(d);
  s.g = p;    p += tile * gstride_of(K, d_in);
  s.msk = p;  p += round4(tile);
  s.red = p;  p += round4(kWarps);
  s.comp = p; p += d_in * d;
  s.mean = p;
  return s;
}

// posterior weights (global rows interleaved (x_j, x_j^2), see the
// wrapper) into shared memory in xcol order, constants (2, K), s0 zeroed
__device__ inline void fv_prologue(const Smem& s, const float* __restrict__ wt,
                                   const float* __restrict__ cst, int d, int K) {
  const int ws4 = wstride_of(K) / 4, q = K / 4;
  copy4(reinterpret_cast<const float4*>(wt), reinterpret_cast<float4*>(s.wt), 2 * d * q,
        [=](int i) {  // shared row r = xcol(j, sq) from global row 2j + sq
          const int r = i / q, j = 8 * (r / 16) + r % 8, sq = (r % 16) / 8;
          return (2 * j + sq) * q + i - r * q;
        },
        [=](int i) { return (i / q) * ws4 + i % q; });
  for (int k = threadIdx.x; k < K; k += kThreads) {
    s.cst[k] = cst[k];
    s.clo[k] = cst[K + k];
    s.s0[k] = 0.f;
  }
}

// v = big + small + O(2^-22 |v|), both parts rounded to nearest (ties
// away, as cvt.rna.tf32.f32), in integer steps: adding half of the 13
// dropped bits before clearing them rounds the magnitude.  small keeps its
// low bits: the tensor core ignores them, and the added half rounds it.
// (Operands here are finite: descriptors, weights and posteriors.)
__device__ __forceinline__ void split_tf32(float f, uint32_t& big, uint32_t& small) {
  const uint32_t v = __float_as_uint(f);
  big = (v + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(f - __uint_as_float(big)) + 0x1000u;
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

// acc += A . B in 3xTF32: the three products into a fresh fragment, small
// terms first, then added on the CUDA cores (rounded, not truncated).  The
// tensor core truncates the fragment toward zero, so it comes out about
// half an ulp of itself too small, a bias that a sum over many k-steps,
// such as s2, would keep.  t + half an ulp of t is a tie, rounded to
// even: up by an ulp or not, half the time each, so the added fragment
// carries no bias to speak of.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                         const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb);
  mma_tf32(t, ab, bs);
  mma_tf32(t, ab, bb);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // 2^e of t, with t's sign, times 2^-24: half an ulp of t
    acc[i] += fmaf(__uint_as_float(__float_as_uint(t[i]) & 0xff800000u), 0x1p-24f, t[i]);
}

// The statistics fragment (m, n) of the warp's slot sl, of the (mt, nt) =
// (d/8, K/8) grid; ok is false for a slot past the grid, which repeats
// fragment (0, 0) and is never stored.  kRect (d/8 a multiple of 4, K/8
// of 8): each warp a 4 x 8 block of the grid, so that a k-step splits 4 A
// and 8 B fragments for 32 products.  Otherwise slot sl is fragment
// kSlots * warp + sl in row-major order, any (d, K) with mt * nt <= 256.
template <bool kRect>
__device__ __forceinline__ void slot_frag(int warp, int sl, int mt, int nt, int& m, int& n, bool& ok) {
  if (kRect) {
    const int wn = nt / 8;
    ok = warp / wn < mt / 4;
    m = ok ? 4 * (warp / wn) + sl / 8 : 0;
    n = ok ? 8 * (warp % wn) + sl % 8 : 0;
  } else {
    const int f = kSlots * warp + sl;
    ok = f < mt * nt;
    m = ok ? f / nt : 0;
    n = ok ? f % nt : 0;
  }
}

// x (rows gq) and x^2 (rows gq + 8) of dims 8m.. of a k-step: the A
// fragment of the statistics, split; xr points at row tq, column gq
__device__ __forceinline__ void load_xt(const float* xr, int xs, int m, uint32_t (&ab)[4], uint32_t (&as)[4]) {
  const float* p = xr + 16 * m;
  split_tf32(p[0], ab[0], as[0]);
  split_tf32(p[8], ab[1], as[1]);
  split_tf32(p[4 * xs], ab[2], as[2]);
  split_tf32(p[4 * xs + 8], ab[3], as[3]);
}

// g of components 8n.. of a k-step: the B fragment, split; gr points at
// row tq, column gq
__device__ __forceinline__ void load_g(const float* gr, int gs, int n, uint32_t (&bb)[2], uint32_t (&bs)[2]) {
  split_tf32(gr[8 * n], bb[0], bs[0]);
  split_tf32(gr[4 * gs + 8 * n], bb[1], bs[1]);
}

// One k-step (8 descriptor rows) of the statistics, (s1, s2)^T += xx^T . g,
// for the warp's slots (slot_frag).  No branch in the loop: the slots'
// product chains overlap.
template <bool kRect>
__device__ __forceinline__ void fv_stats_kstep(const float* xr, const float* gr, int xs, int gs, int mt,
                                               int nt, int warp, float (&acc)[kSlots][4]) {
  if (kRect) {
    int m0, n0;
    bool ok;
    slot_frag<true>(warp, 0, mt, nt, m0, n0, ok);
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_xt(xr, xs, m0 + i, ab[i], as[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bb[2], bs[2];
      load_g(gr, gs, n0 + j, bb, bs);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma3_add(acc[8 * i + j], ab[i], as[i], bb, bs);
    }
  } else {
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) {
      int m, n;
      bool ok;
      slot_frag<false>(warp, sl, mt, nt, m, n, ok);
      uint32_t ab[4], as[4], bb[2], bs[2];
      load_xt(xr, xs, m, ab, as);
      load_g(gr, gs, n, bb, bs);
      mma3_add(acc[sl], ab, as, bb, bs);
    }
  }
}

// One descriptor tile, shared by both kernels: log posterior gemm ->
// masked softmax -> s0 and the statistics in registers.  s.xx and s.msk
// hold the tile on entry (rows past the data zero, mask 0).  acc[sl] is
// the warp's slot sl (slot_frag) of the (d/8) x (K/8) grid of m16n8 tiles
// of (s1, s2)^T: fragment (m, n) covers dims 8m..8m+7 (rows 0-7 s1, rows
// 8-15 s2) and components 8n..8n+7.
template <bool kRect>
__device__ __forceinline__ void fv_tile_body(const Smem& s, int tile, int d, int K, int gs,
                                             float (&acc)[kSlots][4]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // the fragments' group and thread in group
  const int d2 = 2 * d, xs = xstride_of(d), ws = wstride_of(K);
  const int nt = K / 8;

  // log posterior: g = cst + (clo + xx . wt), (tile x 2d) x (2d x K); each
  // warp a run of n8 tiles, kPostN at a time, both m16 row tiles of the
  // tile.  clo starts the sum, so that it survives the last rounding.
  // The hot loop has no branch, so that the fragments' product chains
  // overlap: rows past the tile repeat its last row and n8 tiles past the
  // warp's run its last tile, and neither is stored.
  const int per = (nt + kWarps - 1) / kWarps;
  const int nend = min(per * (warp + 1), nt);
  for (int n0 = per * warp; n0 < nend; n0 += kPostN) {
    int nb[kPostN];
    float run[2][kPostN][4];
#pragma unroll
    for (int nn = 0; nn < kPostN; ++nn) {
      nb[nn] = 8 * min(n0 + nn, nend - 1) + gq;
      const int k = 8 * min(n0 + nn, nend - 1) + 2 * tq;
      const float lo0 = s.clo[k], lo1 = s.clo[k + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        run[mt][nn][0] = run[mt][nn][2] = lo0;
        run[mt][nn][1] = run[mt][nn][3] = lo1;
      }
    }
    const float* xrow[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) xrow[mt][h] = s.xx + min(16 * mt + 8 * h + gq, tile - 1) * xs + tq;
    for (int c = 0; c < d2; c += 8) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split_tf32(xrow[mt][0][c], ab[mt][0], as[mt][0]);
        split_tf32(xrow[mt][1][c], ab[mt][1], as[mt][1]);
        split_tf32(xrow[mt][0][c + 4], ab[mt][2], as[mt][2]);
        split_tf32(xrow[mt][1][c + 4], ab[mt][3], as[mt][3]);
      }
      const float* q = s.wt + (c + tq) * ws;
#pragma unroll
      for (int nn = 0; nn < kPostN; ++nn) {
        uint32_t bb[2], bs[2];
        split_tf32(q[nb[nn]], bb[0], bs[0]);
        split_tf32(q[4 * ws + nb[nn]], bb[1], bs[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3_add(run[mt][nn], ab[mt], as[mt], bb, bs);
      }
    }
#pragma unroll
    for (int nn = 0; nn < kPostN; ++nn) {
      if (n0 + nn >= nend) break;
      const int k = 8 * (n0 + nn) + 2 * tq;
      const float c0 = s.cst[k], c1 = s.cst[k + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 16 * mt + gq;
        if (16 * mt < tile)
          *reinterpret_cast<float2*>(s.g + r * gs + k) =
              make_float2(c0 + run[mt][nn][0], c1 + run[mt][nn][1]);
        if (16 * mt + 16 <= tile)
          *reinterpret_cast<float2*>(s.g + (r + 8) * gs + k) =
              make_float2(c0 + run[mt][nn][2], c1 + run[mt][nn][3]);
      }
    }
  }
  __syncthreads();

  // g = softmax over K (row max, exp, sum) times the mask; one warp a row
  for (int t = warp; t < tile; t += kWarps) {
    float* row = s.g + t * gs;
    float mx = -INFINITY;
#pragma unroll 8
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k]);
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll 8
    for (int k = lane; k < K; k += 32) {
      const float e = expf(row[k] - mx);
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float scale = s.msk[t] / sum;
#pragma unroll 8
    for (int k = lane; k < K; k += 32) row[k] *= scale;
  }
  __syncthreads();

  for (int k = tid; k < K; k += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int t = 0; t < tile; ++t) a += s.g[t * gs + k];
    s.s0[k] += a;
  }

  // statistics: (s1, s2)^T += xx^T . g over the tile's rows, k-steps of 8
  int m, n;
  bool busy;  // whether the warp holds any fragment
  slot_frag<kRect>(warp, 0, d / 8, nt, m, n, busy);
  if (busy)
    for (int t0 = 0; t0 < tile; t0 += 8)
      fv_stats_kstep<kRect>(s.xx + (t0 + tq) * xs + gq, s.g + (t0 + tq) * gs + gq, xs, gs, d / 8, nt, warp, acc);
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

// phi1, phi2 from the statistics fragments; out_img is (2, K, d) row-major
template <bool kRect>
__device__ inline void fv_finalize(const Smem& s, const float (&acc)[kSlots][4], float cnt,
                                   const float* __restrict__ mu, const float* __restrict__ var,
                                   const float* __restrict__ w, float* __restrict__ out_img, int d,
                                   int K) {
  const int lane = threadIdx.x % 32;
  const float tn = fmaxf(cnt, 1.f);
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    int m, n;
    bool ok;
    slot_frag<kRect>(threadIdx.x / 32, sl, d / 8, K / 8, m, n, ok);
    if (!ok) continue;
    const int j = 8 * m + lane / 4;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = 8 * n + 2 * (lane % 4) + q;
      const float s0 = s.s0[k];
      const float m = mu[k * d + j];
      const float v = var[k * d + j];
      const float s1 = acc[sl][q];
      const float s2 = acc[sl][2 + q];
      out_img[k * d + j] = ((s1 - s0 * m) / sqrtf(v)) / (tn * sqrtf(w[k]));
      out_img[K * d + k * d + j] = ((s2 - 2.f * m * s1 + s0 * (m * m)) / v - s0) / (tn * sqrtf(2.f * w[k]));
    }
  }
}

// kRect: d a multiple of 32 and K of 64 (see slot_frag); a template
// parameter, so that each statistics loop gets its own registers
template <typename TIn, bool kRect>
__global__ void __launch_bounds__(kThreads, 1)
    fv_encode_kernel(const TIn* __restrict__ x, const float* __restrict__ mask,
                     const float* __restrict__ wt, const float* __restrict__ cst,
                     const float* __restrict__ mu, const float* __restrict__ var,
                     const float* __restrict__ w, float* __restrict__ out, int T, int d, int K,
                     int tile) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), tile, d, K, 0);
  const int gs = gstride_of(K, 0), xs = xstride_of(d);
  const int tid = threadIdx.x;
  float acc[kSlots][4];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[sl][i] = 0.f;

  fv_prologue(s, wt, cst, d, K);
  const TIn* ximg = x + (size_t)blockIdx.x * T * d;
  const float* mimg = mask + (size_t)blockIdx.x * T;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int rows = min(tile, T - t0);
    const float mk = tid < rows ? mimg[t0 + tid] : 0.f;
    stage_tile(ximg + (size_t)t0 * d, d, tile, rows, [&](int e, float4 v) {
      float* row = s.xx + (e / d) * xs;  // 4 dims of one xcol block: x, then x^2
      *reinterpret_cast<float4*>(row + xcol(e % d, 0)) = v;
      *reinterpret_cast<float4*>(row + xcol(e % d, 1)) = make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
    });
    if (tid < tile) s.msk[tid] = mk;
    __syncthreads();
    fv_tile_body<kRect>(s, tile, d, K, gs, acc);
  }
  const float cnt = block_mask_count(s, mimg, T);
  fv_finalize<kRect>(s, acc, cnt, mu, var, w, out + (size_t)blockIdx.x * 2 * K * d, d, K);
}

template <typename TIn, bool kRect>
__global__ void __launch_bounds__(kThreads, 1)
    fv_fused_kernel(const TIn* __restrict__ x, const float* __restrict__ mask,
                    const float* __restrict__ comp, const float* __restrict__ mean,
                    int normalize, const float* __restrict__ wt, const float* __restrict__ cst,
                    const float* __restrict__ mu, const float* __restrict__ var,
                    const float* __restrict__ w, float* __restrict__ out, int T, int d_in, int d,
                    int K, int tile) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), tile, d, K, d_in);
  const int gs = gstride_of(K, d_in), xs = xstride_of(d);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float acc[kSlots][4];
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[sl][i] = 0.f;

  fv_prologue(s, wt, cst, d, K);
  copy4(reinterpret_cast<const float4*>(comp), reinterpret_cast<float4*>(s.comp), d_in * d / 4,
        [](int i) { return i; }, [](int i) { return i; });
  for (int i = tid; i < d_in; i += kThreads) s.mean[i] = mean ? mean[i] : 0.f;
  float* raw = s.g;  // (tile, d_in), consumed before the posterior writes s.g
  const TIn* ximg = x + (size_t)blockIdx.x * T * d_in;
  const float* mimg = mask + (size_t)blockIdx.x * T;
  for (int t0 = 0; t0 < T; t0 += tile) {
    const int rows = min(tile, T - t0);
    const float mk = tid < rows ? mimg[t0 + tid] : 0.f;
    stage_tile(ximg + (size_t)t0 * d_in, d_in, tile, rows,
               [&](int e, float4 v) { *reinterpret_cast<float4*>(raw + e) = v; });
    if (tid < tile) s.msk[tid] = mk;
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

    // PCA projection z = raw . comp, 2 rows x 4 dims per thread (f32 FMA);
    // the 4 dims share an xcol block, so z and z^2 go out as float4s
    const int jq = d / 4;
    for (int m = tid; m < (tile / 2) * jq; m += kThreads) {
      const int r0 = (m / jq) * 2, j0 = (m % jq) * 4;
      float z[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int i = 0; i < d_in; i += 4) {  // d_in is a multiple of 4
        const float4 r4[2] = {*reinterpret_cast<const float4*>(raw + r0 * d_in + i),
                              *reinterpret_cast<const float4*>(raw + (r0 + 1) * d_in + i)};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float4 cv = *reinterpret_cast<const float4*>(s.comp + (i + ii) * d + j0);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float a = ii == 0 ? r4[r].x : ii == 1 ? r4[r].y : ii == 2 ? r4[r].z : r4[r].w;
            z[r][0] = fmaf(a, cv.x, z[r][0]);
            z[r][1] = fmaf(a, cv.y, z[r][1]);
            z[r][2] = fmaf(a, cv.z, z[r][2]);
            z[r][3] = fmaf(a, cv.w, z[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* row = s.xx + (r0 + r) * xs;
        *reinterpret_cast<float4*>(row + xcol(j0, 0)) = make_float4(z[r][0], z[r][1], z[r][2], z[r][3]);
        *reinterpret_cast<float4*>(row + xcol(j0, 1)) =
            make_float4(z[r][0] * z[r][0], z[r][1] * z[r][1], z[r][2] * z[r][2], z[r][3] * z[r][3]);
      }
    }
    __syncthreads();
    fv_tile_body<kRect>(s, tile, d, K, gs, acc);
  }
  const float cnt = block_mask_count(s, mimg, T);
  fv_finalize<kRect>(s, acc, cnt, mu, var, w, out + (size_t)blockIdx.x * 2 * K * d, d, K);
}

// the largest tile (a multiple of 8, at most kMaxTile) whose shared
// memory fits; 0 when the shape is not one the kernels take
int pick_tile(int d, int K, int d_in) {
  if (d <= 0 || K <= 0 || d % 8 || K % 8) return 0;
  if ((K / 8) * (d / 8) > kWarps * kSlots) return 0;  // the statistics fragments
  if (d_in < 0 || d_in % 4) return 0;
  for (int tile = kMaxTile; tile >= 8; tile -= 8)
    if (smem_floats(tile, d, K, d_in) * sizeof(float) <= kSmemLimit) return tile;
  return 0;
}

// ---------------------------------------------------------------- general path
//
// Any d, K >= 1 (and d_in >= 1 for the fused entry), a chunk of images at
// a time through the workspace: g (rows, K), and for the fused entry the
// projected descriptors z (rows, d) after it.  Four launches a chunk:
//   fvg_project (fused only)  [SIFT normalize,] centre, project -> z
//   fvg_logpost               g = cst + (clo + [x, x^2] . wt)
//   fvg_softmax               g = softmax_k(g) * mask
//   fvg_stats                 s0, s1, s2 of one (k, j) over T, then phi1, phi2
// Sums run in float64 on f32 operands (a product of two f32 values is
// exact there), so their rounding stays far below f32's: closer to the
// float64 chain than the plain f32 chain comes.  The work is
// the tiled kernels' (plus the posteriors' round trip through device
// memory) on the CUDA cores, at float64's half rate.

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }

// one warp a descriptor row: z = ([normalized] x - mean) . comp; the
// normalize as the tiled kernel's (L2, min 0.2, L2, norms clamped to 1e-8)
template <typename TIn>
__global__ void __launch_bounds__(kThreads)
    fvg_project(const TIn* __restrict__ x, const float* __restrict__ comp, const float* __restrict__ mean,
                int normalize, float* __restrict__ z, int rows, int d_in, int d) {
  const size_t r = ((size_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= (size_t)rows) return;  // the whole warp
  const TIn* row = x + r * d_in;
  float n1 = 1.f, n2 = 1.f;
  if (normalize) {
    float ss = 0.f;
    for (int i = lane; i < d_in; i += 32) ss += ld(row[i]) * ld(row[i]);
    n1 = fmaxf(sqrtf(warp_sum(ss)), 1e-8f);
    ss = 0.f;
    for (int i = lane; i < d_in; i += 32) {
      const float v = fminf(ld(row[i]) / n1, 0.2f);
      ss += v * v;
    }
    n2 = fmaxf(sqrtf(warp_sum(ss)), 1e-8f);
  }
  for (int j = lane; j < d; j += 32) {
    double a = 0.0;
    for (int i = 0; i < d_in; ++i) {
      float v = ld(row[i]);
      if (normalize) v = fminf(v / n1, 0.2f) / n2;
      if (mean) v -= mean[i];
      a += (double)v * comp[(size_t)i * d + j];
    }
    z[r * d + j] = (float)a;
  }
}

// one thread a (row, component): the log posterior, wt's rows
// interleaved (x_j, x_j^2) as the wrapper lays them out
template <typename TX>
__global__ void __launch_bounds__(kThreads)
    fvg_logpost(const TX* __restrict__ x, const float* __restrict__ wt, const float* __restrict__ cst,
                float* __restrict__ g, int rows, int d, int K) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)rows * K) return;
  const size_t r = i / K;
  const int k = (int)(i % K);
  const TX* xr = x + r * d;
  double a = cst[K + k];
  for (int j = 0; j < d; ++j) {
    const double v = ld(xr[j]);
    a += v * wt[(size_t)(2 * j) * K + k] + (v * v) * wt[(size_t)(2 * j + 1) * K + k];
  }
  g[i] = (float)((double)cst[k] + a);
}

// one warp a row: g = softmax over K, times the row's mask
__global__ void __launch_bounds__(kThreads)
    fvg_softmax(float* __restrict__ g, const float* __restrict__ mask, int rows, int K) {
  const size_t r = ((size_t)blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= (size_t)rows) return;  // the whole warp
  float* row = g + r * K;
  float mx = -INFINITY;
  for (int k = lane; k < K; k += 32) mx = fmaxf(mx, row[k]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float e = expf(row[k] - mx);
    row[k] = e;
    sum += e;
  }
  const float scale = mask[r] / warp_sum(sum);
  for (int k = lane; k < K; k += 32) row[k] *= scale;
}

// one thread a (k, j) of image blockIdx.y: the statistics over T, then
// phi1 and phi2 (out rows (2, K, d) as the tiled kernels write them)
template <typename TX>
__global__ void __launch_bounds__(kThreads)
    fvg_stats(const TX* __restrict__ x, const float* __restrict__ g, const float* __restrict__ mask,
              const float* __restrict__ mu, const float* __restrict__ var, const float* __restrict__ w,
              float* __restrict__ out, int T, int d, int K) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= K * d) return;
  const int k = i / d, j = i % d;
  const TX* xi = x + (size_t)blockIdx.y * T * d;
  const float* gi = g + (size_t)blockIdx.y * T * K;
  const float* mi = mask + (size_t)blockIdx.y * T;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, cnt = 0.0;
  for (int t = 0; t < T; ++t) {
    const double gk = gi[(size_t)t * K + k], v = ld(xi[(size_t)t * d + j]);
    s0 += gk;
    s1 += gk * v;
    s2 += gk * v * v;
    cnt += mi[t];
  }
  const double tn = fmax(cnt, 1.0), m = mu[i], v = var[i], wk = w[k];
  float* o = out + (size_t)blockIdx.y * 2 * K * d;
  o[i] = (float)(((s1 - s0 * m) / sqrt(v)) / (tn * sqrt(wk)));
  o[K * d + i] = (float)(((s2 - 2.0 * m * s1 + s0 * (m * m)) / v - s0) / (tn * sqrt(2.0 * wk)));
}

// images a chunk of the general path holds: its workspace within
// kWsChunk floats, at least one image, at most a grid's y extent
int general_chunk(int n, int T, int d, int K, bool fused) {
  const size_t per = (size_t)T * (K + (fused ? d : 0));
  const size_t c = per == 0 ? (size_t)n : kWsChunk / per;
  return (int)(c < 1 ? 1 : c > 65535 ? 65535 : c > (size_t)n ? (size_t)n : c);
}

size_t general_workspace(int n, int T, int d, int K, bool fused) {
  return (size_t)general_chunk(n, T, d, K, fused) * T * (K + (fused ? d : 0));
}

unsigned blocks_for(size_t threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

// x: (n, T, d) for the encode, (n, T, d_in) for the fused entry (comp
// non-null); ws: general_workspace floats
template <typename TIn>
int launch_general(const TIn* x, const float* mask, const float* comp, const float* mean, int normalize,
                   const float* wt, const float* cst, const float* mu, const float* var, const float* w,
                   float* out, int n, int T, int d_in, int d, int K, float* ws, cudaStream_t stream) {
  const bool fused = comp != nullptr;
  const int c = general_chunk(n, T, d, K, fused);
  if (general_workspace(n, T, d, K, fused) > 0 && ws == nullptr) return kErrWorkspace;
  float* g = ws;
  float* z = fused ? ws + (size_t)c * T * K : nullptr;
  for (int i0 = 0; i0 < n; i0 += c) {
    const int nc = n - i0 < c ? n - i0 : c, rows = nc * T;
    const float* m = mask + (size_t)i0 * T;
    float* o = out + (size_t)i0 * 2 * K * d;
    const dim3 grid(blocks_for((size_t)K * d), nc);
    if (fused) {
      if (rows > 0) {
        fvg_project<TIn><<<blocks_for((size_t)rows * 32), kThreads, 0, stream>>>(
            x + (size_t)i0 * T * d_in, comp, mean, normalize, z, rows, d_in, d);
        fvg_logpost<float><<<blocks_for((size_t)rows * K), kThreads, 0, stream>>>(z, wt, cst, g, rows, d, K);
        fvg_softmax<<<blocks_for((size_t)rows * 32), kThreads, 0, stream>>>(g, m, rows, K);
      }
      fvg_stats<float><<<grid, kThreads, 0, stream>>>(z, g, m, mu, var, w, o, T, d, K);
    } else {
      const TIn* xc = x + (size_t)i0 * T * d;
      if (rows > 0) {
        fvg_logpost<TIn><<<blocks_for((size_t)rows * K), kThreads, 0, stream>>>(xc, wt, cst, g, rows, d, K);
        fvg_softmax<<<blocks_for((size_t)rows * 32), kThreads, 0, stream>>>(g, m, rows, K);
      }
      fvg_stats<TIn><<<grid, kThreads, 0, stream>>>(xc, g, m, mu, var, w, o, T, d, K);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Above 48 KB, dynamic shared memory needs the function's attribute.  The
// attribute belongs to the function for the whole process, not to the
// calling thread: set per launch at that launch's size, another thread
// (a second replica, a co-served tenant, the other branch's shape) could
// lower it between one thread's set and its launch, which CUDA then
// refuses (cudaErrorInvalidValue).  So it is set once per device and
// kernel instantiation, at kSmemLimit, the most pick_tile ever takes.
constexpr int kMaxDevices = 64;

template <typename TIn, bool kRect, bool kFused, typename Kernel>
cudaError_t prepare(Kernel kernel) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [&] {
    err[device] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
  });
  return err[device];
}

template <typename TIn>
int launch_encode(const void* x, const float* mask, const float* wt, const float* cst,
                  const float* mu, const float* var, const float* w, float* out, int n, int T,
                  int d, int K, float* ws, cudaStream_t stream) {
  if (d <= 0 || K <= 0 || T < 0 || n < 0) return kErrShape;
  if (n == 0) return 0;
  const int tile = pick_tile(d, K, 0);
  if (tile == 0)
    return launch_general(static_cast<const TIn*>(x), mask, nullptr, nullptr, 0, wt, cst, mu, var, w, out,
                          n, T, 0, d, K, ws, stream);
  const size_t bytes = smem_floats(tile, d, K, 0) * sizeof(float);
  const bool rect = d % 32 == 0 && K % 64 == 0;
  const auto kernel = rect ? fv_encode_kernel<TIn, true> : fv_encode_kernel<TIn, false>;
  const cudaError_t e = rect ? prepare<TIn, true, false>(kernel) : prepare<TIn, false, false>(kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n, kThreads, bytes, stream>>>(
      static_cast<const TIn*>(x), mask, wt, cst, mu, var, w, out, T, d, K, tile);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_fused(const void* x, const float* mask, const float* comp, const float* mean,
                 int normalize, const float* wt, const float* cst, const float* mu,
                 const float* var, const float* w, float* out, int n, int T, int d_in, int d,
                 int K, float* ws, cudaStream_t stream) {
  if (d <= 0 || K <= 0 || d_in <= 0 || T < 0 || n < 0) return kErrShape;
  if (n == 0) return 0;
  const int tile = pick_tile(d, K, d_in);
  if (tile == 0)
    return launch_general(static_cast<const TIn*>(x), mask, comp, mean, normalize, wt, cst, mu, var, w, out,
                          n, T, d_in, d, K, ws, stream);
  const size_t bytes = smem_floats(tile, d, K, d_in) * sizeof(float);
  const bool rect = d % 32 == 0 && K % 64 == 0;
  const auto kernel = rect ? fv_fused_kernel<TIn, true> : fv_fused_kernel<TIn, false>;
  const cudaError_t e = rect ? prepare<TIn, true, true>(kernel) : prepare<TIn, false, true>(kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n, kThreads, bytes, stream>>>(static_cast<const TIn*>(x), mask, comp, mean, normalize, wt,
                                         cst, mu, var, w, out, T, d_in, d, K, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, T, d) f32 or bf16 (x_bf16 = 1); mask: (n, T) f32;
// wt: (2d, K) posterior weights; cst: (2, K), the per-component constant
// in f32 and what its rounding dropped; mu, var: (K, d); w: (K,);
// out: (n, 2*K*d) f32; ws: ks_fisher_workspace floats of device memory
// (null where that is 0).  Returns 0, a cudaError_t, -1 for d or K not
// positive, or -2 for a missing workspace.
int ks_fisher_encode(const void* x, int x_bf16, const float* mask, const float* wt,
                     const float* cst, const float* mu, const float* var, const float* w,
                     float* out, int n, int T, int d, int K, float* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_encode<__nv_bfloat16>(x, mask, wt, cst, mu, var, w, out, n, T, d, K, ws, st)
                : launch_encode<float>(x, mask, wt, cst, mu, var, w, out, n, T, d, K, ws, st);
}

// x: (n, T, d_in) f32 or bf16; comp: (d_in, d); mean: (d_in,) or null;
// the rest as ks_fisher_encode (-1 also for d_in not positive).
int ks_fused_forward(const void* x, int x_bf16, const float* mask, const float* comp,
                     const float* mean, int normalize, const float* wt, const float* cst,
                     const float* mu, const float* var, const float* w, float* out, int n, int T,
                     int d_in, int d, int K, float* ws, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_fused<__nv_bfloat16>(x, mask, comp, mean, normalize, wt, cst, mu, var, w,
                                              out, n, T, d_in, d, K, ws, st)
                : launch_fused<float>(x, mask, comp, mean, normalize, wt, cst, mu, var, w, out, n,
                                      T, d_in, d, K, ws, st);
}

// floats of workspace the call takes (the encode for d_in = 0, the fused
// entry otherwise): 0 where the tiled kernels take the shape, the general
// path's chunk otherwise
size_t ks_fisher_workspace(int n, int T, int d, int K, int d_in) {
  if (n <= 0 || T <= 0 || d <= 0 || K <= 0 || d_in < 0 || pick_tile(d, K, d_in) > 0) return 0;
  return general_workspace(n, T, d, K, d_in > 0);
}

// 1 when the tiled kernels take the shape, 0 when it takes the general path
int ks_fisher_tiled(int d, int K, int d_in) { return pick_tile(d, K, d_in) > 0; }

const char* ks_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the Fisher-vector kernels";
  if (code == kErrWorkspace) return "the general Fisher-vector path needs its workspace";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
