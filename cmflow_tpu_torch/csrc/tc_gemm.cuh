// Tensor-core pieces shared by the fused GEMM kernels (plf.cu,
// cost_volume.cu, mse.cu), for Hopper (sm_90a): float32 accuracy from TF32
// products (3xTF32), the bf16 products of the bf16 serving arms, `wgmma`
// with A in registers and B in shared memory, and a ring of weight stages
// filled by `cp.async.bulk` and completed on `mbarrier`s.
//
// 3xTF32.  A TF32 product keeps 10 mantissa bits of each operand, about
// 5e-4 relative, which over 512-wide sums breaks the 1e-5-of-magnitude bar
// the fused kernels are held to.  So each operand is split, x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// (cvt.rna.tf32.f32), and a product is hi*hi + hi*lo + lo*hi.  What is
// dropped, lo*lo and the rounding of lo, is about 2^-22 of each product.  The
// weights come split already (ops/fused.py::tf32_split, the same rounding);
// the activations are split in registers, just before the product.  The
// tensor cores add into their float32 accumulator without rounding to
// nearest: summed there over 512 channels (192 products) the result drifted
// by ~5e-6 of its size on the card, half the bar.  So they sum only one or
// two k8 steps from zero, and the CUDA cores add each such part into the
// running float32 sum (promote below): ~7e-7.
//
// wgmma m64nNk8 .tf32 (one warpgroup, 64 rows, N columns, 8 deep):
// - A, 64 x 8, from registers: warp w of the warpgroup holds rows
//   16w..16w+15; lane (g = lane/4, t = lane%4) holds a[0] = (16w+g, t),
//   a[1] = (16w+g+8, t), a[2] = (16w+g, t+4), a[3] = (16w+g+8, t+4).
// - B, N x 8 (K-major: the weights as [cout, cin]), from shared memory, no
//   swizzle: 8 x 4 "core matrices" of 128 contiguous bytes, the two along K
//   kLbo bytes apart, consecutive groups of 8 columns kSbo bytes apart.  One
//   k8 step of B is [N/8][2][8][4] floats: element (n, p) at
//   ((n/8 * 2 + p/4) * 8 + n%8) * 4 + p%4.
// - D, 64 x N float32, in registers: d[4j + e] of lane (g, t) in warp w is
//   (16w + g + 8*(e/2), 8j + 2t + e%2).
// K positions are free to permute (a sum is a sum), so each kernel orders K
// such that a thread's A values are ones it holds anyway: four consecutive
// channels of a gathered row (one float4 load, two k8 steps), or the two
// adjacent accumulator columns 8j + 2t, +1 of a previous product (one k8
// step, no data movement).  The packers in ops/fused.py order the weights'
// rows to match.
//
// bf16 (the serving arms).  A bf16 product is exact and the tensor cores sum
// it in float32, so one pass replaces the hi/lo split; the activations are
// rounded to nearest even (pack_bf16), as the JAX package's astype rounds.
// wgmma m64nNk16 .bf16: each 32-bit register holds two bf16 values, the
// lower k in its low half.
// - A, 64 x 16, from registers: lane (g, t) of warp w holds a[0] = (16w+g,
//   2t..2t+1), a[1] = (16w+g+8, 2t..2t+1), a[2] = (16w+g, 2t+8..2t+9),
//   a[3] = (16w+g+8, 2t+8..2t+9), as mma.sync m16n8k16 takes it.
// - B, N x 16, from shared memory in the same no-swizzle layout: a core
//   matrix is still 8 rows of 16 bytes (8 bf16 along K), so LBO and SBO
//   stay 128 and 256 bytes.  One k16 step of B is [N/8][2][8][8] bf16:
//   element (n, p) at ((n/8 * 2 + p/8) * 8 + n%8) * 8 + p%8.
// - D is as above.  A gathered row's four consecutive channels 4t .. 4t+3
//   of a 16-channel block are positions 2t, 2t+1, 2t+8, 2t+9 of one k16
//   step; accumulator columns 16s .. 16s+15 (n8 tiles 2s, 2s+1) are the A
//   of step s as they stand, in natural order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cmflow {
namespace tc {

// wgmma B layout (see above), in bytes
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// 3xTF32 split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct Split {
  uint32_t hi[4];
  uint32_t lo[4];
};

__device__ __forceinline__ Split split4(float a0, float a1, float a2,
                                        float a3) {
  Split s;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.hi[i] = tf32_rna(a[i]);
    s.lo[i] = tf32_rna(a[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a B tile at shared address `addr` (16-byte aligned), no
// swizzle (layout type 0, base offset 0)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CMFLOW_D8(i)                                                    \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),  \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),            \
      "+f"(d[(i) + 7])
#define CMFLOW_D32(i) \
  CMFLOW_D8(i), CMFLOW_D8((i) + 8), CMFLOW_D8((i) + 16), CMFLOW_D8((i) + 24)


// d = A (registers) x B (descriptor) + (accumulate ? d : 0), 64 x 128 x 8
__device__ __forceinline__ void mma_n128(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : CMFLOW_D32(0), CMFLOW_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same, 64 x 64 x 8
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : CMFLOW_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d = A (registers, bf16) x B (descriptor, bf16, K-major) + (accumulate ?
// d : 0) in float32, 64 x 128 x 16
__device__ __forceinline__ void mma_bf16_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : CMFLOW_D32(0), CMFLOW_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same, 64 x 64 x 16
__device__ __forceinline__ void mma_bf16_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : CMFLOW_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef CMFLOW_D32
#undef CMFLOW_D8

// d += a (16 x 16, bf16) b (16 x 8, bf16) on the tensor cores, one warp,
// float32 sums: a[0..3] as wgmma's A above (rows g, g+8); b0 = (k 2t..2t+1,
// n g), b1 = (k 2t+8..2t+9, n g); d[0..3] = (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)
__device__ __forceinline__ void mma_sync_bf16(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest even as the bf16 pair of one register, lo
// in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four bf16 values (a uint2, the lowest first) as floats, exactly
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// the three products of 3xTF32 for one k8 step, small ones first; B's hi
// and lo tiles at shared addresses b_hi, b_lo.  accumulate = 0 starts d
// afresh.
template <int M>
__device__ __forceinline__ void mma3(float (&d)[M], const Split& a,
                                     uint32_t b_hi, uint32_t b_lo,
                                     int accumulate) {
  static_assert(M == 64 || M == 32, "N is 128 or 64");
  if constexpr (M == 64) {
    mma_n128(d, a.lo, desc(b_hi), accumulate);
    mma_n128(d, a.hi, desc(b_lo), 1);
    mma_n128(d, a.hi, desc(b_hi), 1);
  } else {
    mma_n64(d, a.lo, desc(b_hi), accumulate);
    mma_n64(d, a.hi, desc(b_lo), 1);
    mma_n64(d, a.hi, desc(b_hi), 1);
  }
}

// sum[OFF + i] += part[i] on the CUDA cores, rounded to nearest (see the
// top of this file)
template <int OFF, int M, int P>
__device__ __forceinline__ void promote(float (&sum)[M],
                                        const float (&part)[P]) {
  static_assert(OFF + P <= M, "part lies inside sum");
#pragma unroll
  for (int i = 0; i < P; ++i) sum[OFF + i] += part[i];
}

// ---------------------------------------------------------------------------
// the weight ring: one producer thread, consumer warps
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A ring of STAGES buffers of BYTES each in shared memory, filled in order
// from the packed weights: for 3xTF32 (ops/fused.py::tc_weights) buffer
// c % STAGES takes chunk c of the hi array in its first half and chunk c of
// the lo array in its second; for bf16 (tc_weights_bf16) chunk c of the one
// array.  full[s] completes when buffer s has landed; empty[s] when every
// consumer warp has released it.
template <int STAGES, int BYTES>
struct Ring {
  char* buf;
  uint64_t* full;
  uint64_t* empty;

  // one thread, before the block's first barrier
  __device__ void init(uint32_t consumer_warps) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the producer thread: for c in [0, chunks), once the consumers have
  // released buffer c % STAGES, copy chunk c of the hi array into its first
  // half and chunk c of the lo array into its second half
  __device__ void produce(const char* hi, const char* lo, int chunks) const {
    constexpr int kHalf = BYTES / 2;
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES;
      if (c >= STAGES) mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
      const uint32_t bar = smem_addr(&full[s]);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(BYTES)
          : "memory");
      const uint32_t dst = smem_addr(buf + s * BYTES);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst),
          "l"(hi + (size_t)c * kHalf), "r"(kHalf), "r"(bar)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(dst + kHalf),
          "l"(lo + (size_t)c * kHalf), "r"(kHalf), "r"(bar)
          : "memory");
    }
  }

  // the producer thread, one array (the bf16 weights): chunk c is the BYTES
  // at src + c * BYTES
  __device__ void produce(const char* src, int chunks) const {
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES;
      if (c >= STAGES) mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
      const uint32_t bar = smem_addr(&full[s]);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(BYTES)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(buf + s * BYTES)),
          "l"(src + (size_t)c * BYTES), "r"(BYTES), "r"(bar)
          : "memory");
    }
  }

  // a consumer warp: wait for chunk c; returns its buffer's shared address
  __device__ uint32_t acquire(int c) const {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    return smem_addr(buf + s * BYTES);
  }

  // a consumer warp, once its products on chunk c have completed
  __device__ void release(int c) const {
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[c % STAGES]);
  }
};

// warp specialisation: the producer warpgroup gives up registers that the
// consumer warpgroups take (all four warps of a warpgroup execute it)
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// a barrier over the consumer threads only (the producer has left)
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

}  // namespace tc
}  // namespace cmflow
