// Tensor-core pieces shared by the fused GEMM kernels (plf.cu,
// cost_volume.cu, mse.cu), for Hopper (sm_90a): float32 accuracy from TF32
// products (3xTF32), the bf16 products of the bf16 serving arms, `wgmma`
// with A in registers or shared memory and B in shared memory, and rings of
// weight stages filled by `cp.async.bulk` and completed on `mbarrier`s, the
// bf16 arms' shared by a cluster of blocks (multicast).
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
// - A, 64 x 16, may come from shared memory instead, in B's layout with
//   rows for columns (a_offset): 2 KB a k16 step, each row's channels 8h ..
//   8h+7 one 16-byte store.
// - D is as above.  Accumulator columns 16s .. 16s+15 (n8 tiles 2s, 2s+1)
//   are the A of step s as they stand, in natural order, as is an A from
//   shared memory; a gathered row's four consecutive channels 4t .. 4t+3 of
//   a 16-channel block are positions 2t, 2t+1, 2t+8, 2t+9 of one k16 step
//   (ops/fused.py::tc_weights_bf16 orders each product's weights to match).

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
// until at most N committed groups of products are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for A operands in registers: after the wait that covers their
// products, so that no other value takes their registers while they run
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
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

// the same, 64 x 32 x 8
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4],
                                        uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : CMFLOW_D8(0), CMFLOW_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d = A (registers, bf16) x B (descriptor, bf16, K-major) + (accumulate ?
// d : 0) in float32, 64 x 32 x 16
__device__ __forceinline__ void mma_bf16_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : CMFLOW_D8(0), CMFLOW_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d = A (registers, bf16) x B (descriptor, bf16, K-major) + (accumulate ?
// d : 0) in float32, 64 x 256 x 16
__device__ __forceinline__ void mma_bf16_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : CMFLOW_D32(0), CMFLOW_D32(32), CMFLOW_D32(64), CMFLOW_D32(96)
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

// d = A (descriptor, bf16, K-major) x B (descriptor, bf16, K-major) +
// (accumulate ? d : 0) in float32, 64 x 256 x 16: both operands from shared
// memory, so no register of an operand is live while the product runs
__device__ __forceinline__ void mma_bf16_ss_n256(float (&d)[128], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : CMFLOW_D32(0), CMFLOW_D32(32), CMFLOW_D32(64), CMFLOW_D32(96)
      : "l"(a), "l"(b), "r"(accumulate));
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
// from the packed 3xTF32 weights (ops/fused.py::tc_weights): buffer
// c % STAGES takes chunk c of the hi array in its first half and chunk c of
// the lo array in its second.  full[s] completes when buffer s has landed;
// empty[s] when every consumer warp has released it.
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

  // the producer thread: `passes` times over, for each chunk i in [0,
  // chunks), once the consumers have released buffer c % STAGES (c counts
  // the chunks copied), copy chunk i of the hi array into its first half
  // and chunk i of the lo array into its second half.  One pass is the
  // loop a single-pass kernel had, so its timing holds.
  __device__ void produce(const char* hi, const char* lo, int chunks,
                          int passes) const {
    constexpr int kHalf = BYTES / 2;
    for (int pass = 0; pass < passes; ++pass) {
      for (int i = 0; i < chunks; ++i) {
        const int c = pass * chunks + i;
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
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
            "l"(hi + (size_t)i * kHalf), "r"(kHalf), "r"(bar)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst + kHalf),
            "l"(lo + (size_t)i * kHalf), "r"(kHalf), "r"(bar)
            : "memory");
      }
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

// ---------------------------------------------------------------------------
// the bf16 arms: A in shared memory, and weight stages shared by a cluster
// ---------------------------------------------------------------------------

// bytes of one k16 step of a 64-row A tile in shared memory, and where row
// r's channels 8h .. 8h+7 of a step lie in it (B's layout, rows for
// columns; LBO 128 and SBO 256 as for B)
constexpr uint32_t kAStep = 2048;
__host__ __device__ constexpr uint32_t a_offset(int r, int h) {
  return (uint32_t)(((r / 8 * 2 + h) * 8 + r % 8) * 16);
}

// makes this thread's stores to shared memory visible to the tensor cores'
// reads of it (the async proxy); a barrier then orders them across threads
__device__ __forceinline__ void fence_view_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster that has not exited, with release and
// acquire order for shared memory across its blocks
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// an arrival on the barrier at `bar`'s offset in block `rank` of the
// cluster.  Its release is the default, of this block's own operations
// only: enough where what it reports (the products' reads of a stage) has
// already completed; a release at cluster scope costs each arrival a fence
// of a microsecond or more.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// A ring of STAGES buffers of BYTES each, at the same offset in each of the
// CLUSTER blocks of a cluster, filled in order from one packed array: chunk
// c (the BYTES at src + (c % period) * BYTES) goes to buffer c % STAGES of
// every block.  Each block's producer copies its 1/CLUSTER part of the chunk
// and multicasts it to all of them, so each weight byte leaves L2 once per
// cluster.  full[s] of a block completes when all BYTES have landed in it;
// empty[s] of a block when every consumer warp of every block has released
// buffer s, since the next copy writes into all of them.  Every block of the
// cluster must take part in every chunk.
template <int STAGES, int BYTES, int CLUSTER>
struct ClusterRing {
  static_assert(BYTES % (16 * CLUSTER) == 0, "parts of whole 16 bytes");
  static constexpr int kPart = BYTES / CLUSTER;
  char* buf;
  uint64_t* full;
  uint64_t* empty;

  // one thread, before the cluster's first barrier (cluster_sync)
  __device__ void init(uint32_t consumer_warps) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the producer thread of each block
  __device__ void produce(const char* src, int chunks, int period) const {
    const uint32_t rank = CLUSTER == 1 ? 0 : cluster_rank();
    for (int c = 0; c < chunks; ++c) {
      const int s = c % STAGES;
      if (c >= STAGES) mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
      const uint32_t bar = smem_addr(&full[s]);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"(BYTES)
          : "memory");
      const uint32_t dst = smem_addr(buf + s * BYTES + rank * kPart);
      const char* from = src + (size_t)(c % period) * BYTES + rank * kPart;
      if constexpr (CLUSTER == 1) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
            "l"(from), "r"(kPart), "r"(bar)
            : "memory");
      } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
            "l"(from), "r"(kPart), "r"(bar),
            "h"((uint16_t)((1u << CLUSTER) - 1))
            : "memory");
      }
    }
  }

  // a consumer warp: wait for chunk c; returns its buffer's shared address
  __device__ uint32_t acquire(int c) const {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    return smem_addr(buf + s * BYTES);
  }

  // a consumer warp, once the products that read chunk c have completed:
  // its release of the buffer in every block of the cluster
  __device__ void release(int c) const {
    if (threadIdx.x % 32 == 0) {
      const uint32_t own = CLUSTER == 1 ? 0 : cluster_rank();
#pragma unroll
      for (uint32_t r = 0; r < CLUSTER; ++r) {
        if (r == own) {
          mbar_arrive(&empty[c % STAGES]);
        } else {
          mbar_arrive_remote(&empty[c % STAGES], r);
        }
      }
    }
  }
};

// a launch in clusters of CLUSTER blocks along x (blocks a multiple of it),
// with `smem` bytes of dynamic shared memory; returns the launch's error
template <int CLUSTER, typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int blocks, int threads,
                           size_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

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
