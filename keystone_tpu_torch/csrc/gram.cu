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
// Precision.  The reference's contract for these products is f32 at
// Precision.HIGHEST, which a TPU meets by a multi-pass bf16 emulation on
// its matrix unit.  Hopper's counterpart is 3xTF32 on the tensor cores:
// each f32 operand v splits into big = tf32(v) and small = tf32(v - big),
// both rounded to nearest, and a.b ~ a_s.b_b + a_b.b_s + a_b.b_b, the
// small terms first; only a_s.b_s (~2^-22 relative) is dropped.  bf16
// operands (the reference's mxu='bf16' stream) take one bf16 pass: their
// products are exact in f32.  The tensor core adds its products into the
// accumulator with truncation, which over many k-steps biases a long
// same-signed sum (a diagonal entry, x.x) toward zero.  So each chunk's
// products (12 wgmmas for f32, 4 for bf16) go into a fresh partial sum
// that is added to the accumulators on the CUDA cores, rounded to
// nearest.  The Gaussian's row norms |x|^2 and |z|^2 are f32 FMA sums
// from the staged chunks, a fresh partial a chunk: near the diagonal
// |x|^2 - 2 x.z + |z|^2 cancels, and norms through TF32 would lose what
// the split keeps.
//
// What bounds it on an H100: one (n x m) output from a contraction over d,
// 2*n*m*d flops against (n + m)*d reads and n*m writes.  3xTF32 spends
// three TF32 products a flop: 495/3 = 165 TFLOP/s of f32-grade work over
// 3.35 TB/s is a ridge of ~49 flop/byte, and the main paths' shapes (d =
// 256..3072, ~80-200 flop/byte) sit above it: tensor-core bound.  The bf16
// pass (989 TFLOP/s, ridge ~295) sits below its ridge: bound by bytes,
// mostly the (n, m) f32 output.
//
// What the design does about it.  mma.sync feeds Hopper's tensor cores
// from registers, a warp at a time: its operands pass through the
// register file, every fragment is split once per warp that reads it, and
// it does not reach the tensor cores' full rate.  So the products are
// wgmma, both operands read from shared memory: a block of 256 threads is
// two warpgroups, each owning 64 rows of a 128 x 128 output tile,
// m64n128k8 (tf32) or m64n128k16 (bf16).  d is walked in chunks of 128
// bytes a row (32 f32 or 64 bf16) through a ring of 4 shared-memory
// stages, each chunk in wgmma's 128-byte swizzled layout.  Where a row's
// bytes and both bases are 16-byte aligned, the tensor memory accelerator
// fills a stage (one thread, one mbarrier a stage); otherwise every
// thread copies one element at a time, by 4-byte cp.async (f32) or plain
// loads (bf16), into the same layout.  Once a chunk has landed, each
// thread takes its half-row of x's and of z's tile, in 16-byte units:
// their squares go into the norms and, for f32, each unit is split, big
// in place and small into a second tile.  So the split is paid once an
// element and not once a warp, and it runs while the previous chunk's
// wgmmas do.  One block an SM (194 KB of dynamic shared memory).  Ragged
// n, m and d need no padded copy: copies outside the matrices zero-fill
// (adding nothing to a product or a norm) and stores are bounds-checked.
// There is no bound on d (the TPU's VMEM-driven GRAM_MAX_D): the chunk
// loop takes any d.

#include <cuda.h>  // CUtensorMap; the encoder is looked up through the runtime
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                 // two warpgroups
constexpr int kTile = 128;                    // output tile: kTile x kTile
constexpr int kAcc = kTile / 2;               // f32 accumulators a thread: 64 x 128 over 128
constexpr int kChunkBytes = 128;              // a row's bytes of d per stage (the swizzle width)
constexpr int kUnits = kChunkBytes / 16;      // 16-byte units a row per stage
constexpr int kKSteps = kChunkBytes / 32;     // wgmma k-steps a chunk (8 f32 or 16 bf16)
constexpr int kStages = 4;
constexpr int kOpBytes = kTile * kChunkBytes;      // one operand's chunk: 16 KB
constexpr int kStageBytes = 2 * kOpBytes;          // z's tile, then x's
constexpr int kSmallOff = kStages * kStageBytes;   // f32: small parts of two chunks, z then x
constexpr int kBarOff = kSmallOff + 2 * kStageBytes;  // a stage's TMA barrier: 8 bytes
constexpr int kNormOff = kBarOff + 8 * kStages;    // |x|^2, |z|^2 of the tile's rows
constexpr int kSmemBytes = kNormOff + 2 * kTile * 4 + 1024;  // + slack to align the base
constexpr int kMaxGridY = 65535;
constexpr int kMaxDevices = 64;
constexpr int kErrShape = -1;  // shape or degree the kernels do not take

enum Epilogue { kGaussian = 0, kPolynomial = 1 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte b of a tile's row r: 8-row atoms of 128-byte rows whose 16-byte
// units are XOR-ed with r % 8 (the 128-byte swizzle of wgmma and TMA)
__device__ __forceinline__ int tile_off(int r, int b) {
  return r * kChunkBytes + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// bytes past `src_bytes` of the copy are zero-filled
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// shared-memory writes by this thread, visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// the barrier's one arrival, expecting `bytes` from TMA copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a (kTile rows x 128 bytes) box of `map` at element k, row `row`, into
// the swizzled tile at `dst`; rows and elements outside read as 0
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// One operand's chunk `chunk` (rows row0.., d from chunk * 128 bytes) into
// its swizzled tile, where TMA does not take the operand (d * sizeof(T)
// not a multiple of 16, or a base not 16-byte aligned): one element a
// copy.  Rows past `rows` and elements past d read as 0.  Consecutive
// threads copy consecutive elements of a row.
template <typename T>
__device__ __forceinline__ void load_chunk(uint8_t* dst, const T* __restrict__ src, int rows,
                                           int d, int row0, int chunk) {
  constexpr int kElems = kChunkBytes / sizeof(T);
  const int k0 = chunk * kElems;
#pragma unroll 4
  for (int i = 0; i < kTile * kElems / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kElems, kk = e % kElems;
    const int row = row0 + r, k = k0 + kk;
    const bool ok = row < rows && k < d;
    if constexpr (std::is_same<T, float>::value) {
      cp_async4(smem_addr(dst + tile_off(r, kk * 4)), ok ? src + (size_t)row * d + k : src,
                ok ? 4 : 0);
    } else {  // cp.async has no 2-byte copy, so plain loads
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
      *reinterpret_cast<unsigned short*>(dst + tile_off(r, kk * 2)) =
          ok ? s[(size_t)row * d + k] : (unsigned short)0;
    }
  }
}

// v = big + small + O(2^-22 |v|), both parts rounded to nearest (ties
// away, as cvt.rna.tf32.f32), in integer steps: adding half of the 13
// dropped bits before clearing them rounds the magnitude.  small keeps its
// low bits: the tensor core ignores them, and the added half rounds it.
// (cvt.rna.tf32.f32 itself compiles to the same steps plus a check for
// inf and NaN, which gram operands are not.)
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& big, uint32_t& small) {
  big = (v + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(v) - __uint_as_float(big)) + 0x1000u;
}

// One staged 16-byte unit at byte `off` of a tile: its squares added, in
// f32 FMA and k order, to `nrm` (kNorms) and, for f32, the unit split in
// place into its big part and into `small` at the same offset
template <typename T, bool kNorms>
__device__ __forceinline__ void unit_pass(uint8_t* tile, uint8_t* small, int off, float& nrm) {
  uint4 v = *reinterpret_cast<const uint4*>(tile + off);
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (std::is_same<T, float>::value) {
      if (kNorms) nrm = fmaf(__uint_as_float(w[q]), __uint_as_float(w[q]), nrm);
    } else if (kNorms) {  // the low half is the earlier element
      const float lo = __uint_as_float(w[q] << 16), hi = __uint_as_float(w[q] & 0xffff0000u);
      nrm = fmaf(lo, lo, nrm);
      nrm = fmaf(hi, hi, nrm);
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    uint4 sm;
    split_tf32(w[0], v.x, sm.x);
    split_tf32(w[1], v.y, sm.y);
    split_tf32(w[2], v.z, sm.z);
    split_tf32(w[3], v.w, sm.w);
    *reinterpret_cast<uint4*>(tile + off) = v;
    *reinterpret_cast<uint4*>(small + off) = sm;
  }
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: 8-row atoms
// 1024 bytes apart (the stride), the leading offset unused
__device__ __forceinline__ uint64_t tile_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

#define KS_ACC64                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),          \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),          \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define KS_D64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A . B over k = 8, a warpgroup's 64 x 128, both from shared
// memory (K-major, 128-byte swizzled); scale_d = 0 starts from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " KS_D64 ", %64, %65, p, 1, 1;\n}\n"
      : KS_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same over k = 16 of bf16
__device__ __forceinline__ void wgmma_bf16(float (&d)[kAcc], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KS_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : KS_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef KS_ACC64
#undef KS_D64

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of d across the wgmma ops
__device__ __forceinline__ void fence_regs(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The tile body both kernels share: acc = x_rows . z_cols over all of d
// for the warpgroup's 64 x 128 outputs (acc[4j + q]: row g + 8 (q / 2) of
// the warp's 16, column 8j + 2t + q % 2, for lane 4g + t) and, with
// kNorms, the squared norms of the tile's rows of x (xn) and z (zn).
//
// Chunk c's stage is filled three chunks ahead, by TMA (one thread, one
// barrier a stage) or by cp.async.  One __syncthreads a chunk: after it,
// chunk c is split and every warpgroup is done with chunk c - 1, whose
// stage takes chunk c + 3.  Between the wgmmas of chunk c's k-steps, each
// thread takes one unit of its half-row of x and of z of chunk c + 1 (its
// norms; for f32 its split), so that work runs while the tensor cores do.
template <typename T, bool kNorms>
__device__ __forceinline__ void gram_tile_body(const CUtensorMap* tmx, const CUtensorMap* tmz,
                                               const T* __restrict__ x, const T* __restrict__ z,
                                               int n, int m, int d, int row0, int col0, bool tma,
                                               uint8_t* smem, float (&acc)[kAcc], float* xn,
                                               float* zn) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kElems = kChunkBytes / sizeof(T);
  const int tid = threadIdx.x;
  const int nk = (d + kElems - 1) / kElems;
  const uint32_t bars = smem_addr(smem) + kBarOff;
  auto stage = [&](int c) { return smem + (c % kStages) * kStageBytes; };  // z, then x
  auto small = [&](int c) { return smem + kSmallOff + (c % 2) * kStageBytes; };  // z, then x
  auto bar = [&](int c) { return bars + 8 * (c % kStages); };
  if (tma && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int c) {
    if (c < nk) {
      if (!tma) {
        load_chunk<T>(stage(c), z, m, d, col0, c);
        load_chunk<T>(stage(c) + kOpBytes, x, n, d, row0, c);
      } else if (tid == 0) {
        mbar_expect(bar(c), kStageBytes);
        tma_load(smem_addr(stage(c)), tmz, c * kElems, col0, bar(c));
        tma_load(smem_addr(stage(c)) + kOpBytes, tmx, c * kElems, row0, bar(c));
      }
    }
    if (!tma) cp_async_commit();
  };
  // unit (tid % 2) * 4 + p of row tid / 2 of x's and z's tiles of chunk c;
  // xh, zh: this thread's half of the row's squared norm, to which each
  // chunk adds a fresh partial (xp, zp)
  const int hr = tid / 2;
  float xh = 0.f, zh = 0.f, xp = 0.f, zp = 0.f;
  auto prep = [&](int c, int p) {
    const int off = tile_off(hr, ((tid % 2) * (kUnits / 2) + p) * 16);
    unit_pass<T, kNorms>(stage(c), small(c), off, zp);
    unit_pass<T, kNorms>(stage(c) + kOpBytes, small(c) + kOpBytes, off, xp);
  };
  const int a_off = (tid / 128) * 64 * kChunkBytes;  // the warpgroup's 64 rows of x

  load(0);
  load(1);
  load(2);
  if (nk > 0) {
    if (tma) mbar_wait(bar(0), 0);
    else cp_async_wait<2>();
    fence_async_shared();
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kKSteps; ++p) prep(0, p);
    xh = xp;
    zh = zp;
    fence_async_shared();
  }
  for (int c = 0; c < nk; ++c) {
    const bool next = c + 1 < nk;
    if (next) {  // chunk c + 1 has landed (this thread's copies, or the TMA's)
      if (tma) mbar_wait(bar(c + 1), ((c + 1) / kStages) & 1);
      else cp_async_wait<1>();
      fence_async_shared();
    }
    __syncthreads();
    load(c + 3);
    const uint32_t zb = smem_addr(stage(c)), xb = zb + kOpBytes + a_off;
    float part[kAcc];  // this chunk's products, added to acc once they are done
    wgmma_fence();
    if constexpr (kF32) {
      const uint32_t zs = smem_addr(small(c)), xs = zs + kOpBytes + a_off;
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {  // small terms first
        wgmma_tf32(part, tile_desc(xs + 32 * s), tile_desc(zb + 32 * s), s > 0);
        wgmma_tf32(part, tile_desc(xb + 32 * s), tile_desc(zs + 32 * s), 1);
        wgmma_tf32(part, tile_desc(xb + 32 * s), tile_desc(zb + 32 * s), 1);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kKSteps; ++s)
        wgmma_bf16(part, tile_desc(xb + 32 * s), tile_desc(zb + 32 * s), s > 0);
    }
    wgmma_commit();
    xp = zp = 0.f;
    if (next) {  // while chunk c's wgmmas run
#pragma unroll
      for (int p = 0; p < kKSteps; ++p) prep(c + 1, p);
    }
    xh += xp;
    zh += zp;
    fence_async_shared();
    wgmma_wait();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
  }
  if (!tma) cp_async_wait<0>();
  if (kNorms) {  // the two halves of each row
    xh += __shfl_xor_sync(0xffffffffu, xh, 1);
    zh += __shfl_xor_sync(0xffffffffu, zh, 1);
    if (tid % 2 == 0) {
      xn[hr] = xh;
      zn[hr] = zh;
    }
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
__global__ void __launch_bounds__(kThreads, 1)
    gram_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmz,
                const T* __restrict__ x, const T* __restrict__ z, float* __restrict__ out, int n,
                int m, int d, float p0, float p1, int degree, bool tma) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle's 8-row atoms sit on 1024-byte boundaries of the address
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* xn = reinterpret_cast<float*>(smem + kNormOff);
  float* zn = xn + kTile;
  const int row0 = blockIdx.x * kTile, col0 = blockIdx.y * kTile;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  gram_tile_body<T, kEpi == kGaussian>(&tmx, &tmz, x, z, n, m, d, row0, col0, tma, smem, acc, xn,
                                       zn);

  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int rbase = (threadIdx.x / 128) * 64 + ((threadIdx.x / 32) % 4) * 16 + lane / 4;
  const bool vec2 = (m % 2) == 0;  // column pairs then start 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the fragment's rows g and g + 8
    const int r = rbase + 8 * h;
    const int row = row0 + r;
    if (row >= n) continue;
    float* orow = out + (size_t)row * m;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const int cc = 8 * j + 2 * t;
      const int col = col0 + cc;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float cross = acc[4 * j + 2 * h + q];
        if (kEpi == kGaussian) {
          const float sq = fmaxf(xn[r] - 2.f * cross + zn[cc + q], 0.f);
          v[q] = expf(-p0 * sq);
        } else {
          v[q] = int_pow(p0 * cross + p1, degree);
        }
      }
      if (vec2 && col + 1 < m) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(v[0], v[1]);
      } else {
        if (col < m) orow[col] = v[0];
        if (col + 1 < m) orow[col + 1] = v[1];
      }
    }
  }
}

// Above 48 KB, dynamic shared memory needs the function's attribute; a
// launch without it is refused and never runs.  Set once per device.
template <typename T, int kEpi>
cudaError_t prepare(int device) {
  static bool ready[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      gram_kernel<T, kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  ready[device] = e == cudaSuccess;
  return e;
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query (no -lcuda)
cudaError_t tensor_map_encoder(PFN_cuTensorMapEncodeTiled_v12000* fn) {
  static void* sym = nullptr;
  static cudaError_t err = [] {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                            cudaEnableDefault, &q);
    return e != cudaSuccess ? e : q == cudaDriverEntryPointSuccess ? cudaSuccess : cudaErrorNotSupported;
  }();
  *fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(sym);
  return err;
}

// TMA's map of a (rows, d) row-major operand in boxes of kTile rows x 128
// bytes, 128-byte swizzled, zero-filled past its edges
template <typename T>
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int d) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t e = tensor_map_encoder(&encode);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(T)};
  const cuuint32_t box[2] = {kChunkBytes / sizeof(T), kTile};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int kEpi>
int launch(const void* x, const void* z, float* out, int n, int m, int d, float p0, float p1,
           int degree, cudaStream_t stream) {
  if (n < 0 || m < 0 || d < 0 || degree < 0) return kErrShape;
  if (n == 0 || m == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > kMaxGridY) return kErrShape;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = prepare<T, kEpi>(device);
  if (e != cudaSuccess) return (int)e;
  // TMA takes 16-byte aligned bases and rows a multiple of 16 bytes apart
  const bool tma = d > 0 && ((size_t)d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  CUtensorMap tmx = {}, tmz = {};
  if (tma) {
    e = tensor_map<T>(&tmx, x, n, d);
    if (e == cudaSuccess) e = tensor_map<T>(&tmz, z, m, d);
    if (e != cudaSuccess) return (int)e;
  }
  gram_kernel<T, kEpi><<<grid, kThreads, kSmemBytes, stream>>>(
      tmx, tmz, static_cast<const T*>(x), static_cast<const T*>(z), out, n, m, d, p0, p1, degree,
      tma);
  return (int)cudaGetLastError();
}

int dispatch(int epi, const void* x, const void* z, int bf16, float* out, int n, int m, int d,
             float p0, float p1, int degree, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return epi == kGaussian
               ? launch<__nv_bfloat16, kGaussian>(x, z, out, n, m, d, p0, p1, degree, st)
               : launch<__nv_bfloat16, kPolynomial>(x, z, out, n, m, d, p0, p1, degree, st);
  return epi == kGaussian ? launch<float, kGaussian>(x, z, out, n, m, d, p0, p1, degree, st)
                          : launch<float, kPolynomial>(x, z, out, n, m, d, p0, p1, degree, st);
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
