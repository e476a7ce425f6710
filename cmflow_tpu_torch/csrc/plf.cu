// One propagation-encoder scale (a wide PointLocalFeature, before mlp2), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cmflow_tpu/ops/fused.py::_plf_kernel (called
// by fused_point_local_feature).  For each query i and each of its K
// ball-query neighbours j (one row per pair):
//   x0 = ReLU((base[j] - xyz_c[i] @ wrel) * s0 + b0)     512 wide
//   x1 = ReLU((x0 @ W1) * s1 + b1)                         256 wide
//   x2 = ReLU((x1 @ W2) * s2 + b2)                          64 wide
//   out[i] = max over k of x2
// where base[j] = feat_tx[j] + xyz_c[j] @ wrel is folded outside.
//
// What bounds it: operations.  147,456 multiply-adds per row; at B=16,
// N=256 the four scales (K = 4, 8, 16, 32) hold 245,760 rows, 72.5 GFLOP.
// On the tensor cores in 3xTF32 (three TF32 products per product, see
// tc_gemm.cuh) that is 0.44 ms at the dense TF32 peak of 495 TFLOP/s; the
// bytes that must move (base in, out back) take a few microseconds, but the
// split weights (1.2 MB) stream from L2 once per block.  Evaluated layer by
// layer the [B,N,K,512] tensor between the gather and W1 would be 268 MB at
// K=32; this kernel never writes it.
//
// Design: a gather-GEMM with a max-pool epilogue on wgmma (tc_gemm.cuh).  A
// block takes 128 rows made of whole queries (128/K of them), so the max
// over K closes inside the block: two consumer warpgroups of 64 rows each,
// and a producer warpgroup (registers handed to the consumers with
// setmaxnreg) one thread of which streams the packed weights (W1 then W2,
// TF32 hi and lo, ops/fused.py::tc_weights) through a ring of five 32 KB
// stages with cp.async.bulk, completed on mbarriers, while the tensor cores
// work.  Every weight byte read from L2 serves 128 rows.
// - x0 never exists in memory: each thread gathers four consecutive
//   channels of its two rows per float4 load, applies the offset, the
//   affine and the ReLU, and splits them into the A fragments of two k8
//   steps in registers.
// - x1 [64, 256] of a warpgroup stays in 128 registers a thread (the
//   tensor cores sum each stage into 64 more, 128 columns at a time, which
//   the CUDA cores add in: tc::promote); after the affine and ReLU they are
//   the A fragments of the 256 -> 64 product as they stand.
// - x2 goes through shared memory for the max over each query's K rows.
// All sums are float32.  ~200 KB of dynamic shared memory needs
// cudaFuncSetAttribute, and a launch refused for it never runs, so the entry
// point returns cudaGetLastError().
//
// The bf16 arm (plf_bf16_kernel, the JAX kernel's bf16 serving mode,
// fused.py:99-105 and :129): the base comes rounded to bf16, one rounding
// per point; the offset, the first affine and ReLU stay float32; the two
// products take bf16 operands in one wgmma pass (m64nNk16 .bf16, each
// activation rounded to nearest even just before) and sum in float32; the
// output is float32.  Half the operations' cost and half the weight bytes:
// the packed bf16 weights (ops/fused.py::tc_weights_bf16, 320 KB) stream
// through five 16 KB stages, each W1 stage two k16 steps (32 channels),
// each W2 stage eight.  The tensor cores keep each product's whole sum:
// their accumulator's drift (~5e-6 of its size, tc_gemm.cuh) is far below
// the bf16 arm's bar (1e-2 of the output), so nothing is promoted.  What
// bounds it: operations, 72.5 GFLOP at B=16, N=256, 0.073 ms at the dense
// bf16 peak (989 TFLOP/s).  Both arms share plf_body.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_gemm.cuh"

namespace {

namespace tc = cmflow::tc;

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRows = 128;                 // (query, neighbour) rows per block
constexpr int kC1 = 512;
constexpr int kC2 = 256;
constexpr int kC3 = 64;
constexpr int kStageBytes = 32768;
constexpr int kStages = 5;
constexpr int kChunks1 = kC1 / 16;  // W1 stages: 16 channels, 2 k8 steps
constexpr int kChunks2 = kC2 / 64;  // W2 stages: 64 channels, 8 k8 steps
constexpr int kX2Stride = kC3 + 8;  // padded rows of x2
static_assert(2 * 16 * kC2 * 4 == kStageBytes, "a W1 stage: 16 rows, hi, lo");
static_assert(2 * 64 * kC3 * 4 == kStageBytes, "a W2 stage: 64 rows, hi, lo");
// floats of each half (hi, lo) of the packed weights
constexpr int kPackHalf = kC1 * kC2 + kC2 * kC3;
// the bf16 arm's stages: W1 two k16 steps of 256 columns, W2 eight of 64
constexpr int kBf16StageBytes = 16384;
constexpr int kBf16Chunks1 = kC1 / 32;
constexpr int kBf16Chunks2 = kC2 / 128;
static_assert(2 * 16 * kC2 * 2 == kBf16StageBytes, "a bf16 W1 stage");
static_assert(8 * 16 * kC3 * 2 == kBf16StageBytes, "a bf16 W2 stage");

template <bool kBf16>
__host__ __device__ constexpr int stage_bytes() {
  return kBf16 ? kBf16StageBytes : kStageBytes;
}

template <bool kBf16>
constexpr size_t smem_bytes() {
  return (size_t)kStages * stage_bytes<kBf16>() +
         (size_t)kRows * kX2Stride * 4;
}

__device__ __forceinline__ float relu_affine(float x, float s, float b) {
  return fmaxf(fmaf(x, s, b), 0.0f);
}

__device__ __forceinline__ float4 load_or_zero(const float4* p, int i) {
  return p ? __ldg(p + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// four consecutive bf16 channels as floats
__device__ __forceinline__ float4 load_or_zero(const uint2* p, int i) {
  return p ? tc::bf16x4_to_float4(__ldg(p + i))
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// the accumulator's columns 128h .. 128h + 127
template <int H>
__device__ __forceinline__ float (&half_of(float (&acc)[128]))[64] {
  return *reinterpret_cast<float(*)[64]>(acc + 64 * H);
}

// base [B*N, kC1] float32 (float4 rows) or bf16 (uint2 rows: four channels
// each); wpack from tc_weights or tc_weights_bf16
template <bool kBf16>
__device__ __forceinline__ void plf_body(
    const void* __restrict__ base, const int* __restrict__ idx,
    const float* __restrict__ xyz, const float* __restrict__ wrel,
    const float* __restrict__ s0, const float* __restrict__ b0,
    const void* __restrict__ wpack, const float* __restrict__ s1,
    const float* __restrict__ b1, const float* __restrict__ s2,
    const float* __restrict__ b2, float* __restrict__ out, int total, int n,
    int k) {
  using Row4 = typename std::conditional<kBf16, uint2, float4>::type;
  constexpr int kStage = stage_bytes<kBf16>();
  extern __shared__ __align__(128) char smem[];
  float* x2s = reinterpret_cast<float*>(smem + kStages * kStage);
  __shared__ int row_j[kRows];  // neighbour row in base, or -1
  __shared__ int row_q[kRows];  // query, or -1 for an unused row
  __shared__ float row_xyz[kRows][3];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const tc::Ring<kStages, kStage> ring{smem, full, empty};

  const int qpb = kRows / k;  // whole queries per block
  const int q0 = blockIdx.x * qpb;
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    const int q = q0 + r / k;
    int j = -1, qq = -1;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (r < qpb * k && q < total) {
      qq = q;
      const int jj = idx[(int64_t)q * k + r % k];
      if (jj >= 0 && jj < n) j = (q / n) * n + jj;
      x = xyz[(int64_t)q * 3];
      y = xyz[(int64_t)q * 3 + 1];
      z = xyz[(int64_t)q * 3 + 2];
    }
    row_j[r] = j;
    row_q[r] = qq;
    row_xyz[r][0] = x;
    row_xyz[r][1] = y;
    row_xyz[r][2] = z;
  }
  if (threadIdx.x == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread
    tc::producer_registers();
    if (threadIdx.x == kConsumers) {
      const char* w = static_cast<const char*>(wpack);
      if constexpr (kBf16) {
        ring.produce(w, kBf16Chunks1 + kBf16Chunks2);
      } else {
        ring.produce(w, w + kPackHalf * 4, kChunks1 + kChunks2);
      }
    }
    return;
  }
  tc::consumer_registers();

  // the thread's two rows: ra in the upper, rb in the lower half of its
  // warp's 16 (tc_gemm.cuh, fragment layouts)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = 64 * wg + 16 * warp + g, rb = ra + 8;
  constexpr int C4 = kC1 / 4;
  const bool va = row_q[ra] >= 0, vb = row_q[rb] >= 0;
  const Row4* base4 = static_cast<const Row4*>(base);
  const Row4* pa =
      va && row_j[ra] >= 0 ? base4 + (int64_t)row_j[ra] * C4 : nullptr;
  const Row4* pb =
      vb && row_j[rb] >= 0 ? base4 + (int64_t)row_j[rb] * C4 : nullptr;
  const float xa = row_xyz[ra][0], ya = row_xyz[ra][1], za = row_xyz[ra][2];
  const float xb = row_xyz[rb][0], yb = row_xyz[rb][1], zb = row_xyz[rb][2];
  const float4* wr4 = reinterpret_cast<const float4*>(wrel);
  const float4* s04 = reinterpret_cast<const float4*>(s0);
  const float4* b04 = reinterpret_cast<const float4*>(b0);

  // x0 at the four channels 4*c4 .. 4*c4 + 3 of rows ra (xa4) and rb (xb4)
  auto first_layer = [&](int c4, float (&xa4)[4], float (&xb4)[4]) {
    const float4 ga = load_or_zero(pa, c4), gb = load_or_zero(pb, c4);
    const float4 r0 = __ldg(wr4 + c4), r1 = __ldg(wr4 + C4 + c4),
                 r2 = __ldg(wr4 + 2 * C4 + c4);
    const float4 s = __ldg(s04 + c4), b = __ldg(b04 + c4);
    const float ga4[4] = {ga.x, ga.y, ga.z, ga.w};
    const float gb4[4] = {gb.x, gb.y, gb.z, gb.w};
    const float rr0[4] = {r0.x, r0.y, r0.z, r0.w};
    const float rr1[4] = {r1.x, r1.y, r1.z, r1.w};
    const float rr2[4] = {r2.x, r2.y, r2.z, r2.w};
    const float ss[4] = {s.x, s.y, s.z, s.w}, bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float offa = fmaf(za, rr2[e], fmaf(ya, rr1[e], xa * rr0[e]));
      const float offb = fmaf(zb, rr2[e], fmaf(yb, rr1[e], xb * rr0[e]));
      xa4[e] = va ? relu_affine(ga4[e] - offa, ss[e], bb[e]) : 0.0f;
      xb4[e] = vb ? relu_affine(gb4[e] - offb, ss[e], bb[e]) : 0.0f;
    }
  };

  // x1 = x0 @ W1
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  if constexpr (kBf16) {
    // Stage c holds k16 steps 2c and 2c+1 (8 KB each): channels 32c + 16e
    // + 4t .. +3 of a thread's rows are its A values of step 2c + e
    // (tc_gemm.cuh).  The tensor cores sum the whole product in `acc`.
    for (int c = 0; c < kBf16Chunks1; ++c) {
      uint32_t a[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float xa4[4], xb4[4];
        first_layer(8 * c + 4 * e + t, xa4, xb4);
        a[e][0] = tc::pack_bf16(xa4[0], xa4[1]);
        a[e][1] = tc::pack_bf16(xb4[0], xb4[1]);
        a[e][2] = tc::pack_bf16(xa4[2], xa4[3]);
        a[e][3] = tc::pack_bf16(xb4[2], xb4[3]);
      }
      const uint32_t st = ring.acquire(c);
      tc::fence();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        tc::mma_bf16_n128(half_of<0>(acc), a[e], tc::desc(st + 8192 * e), 1);
        tc::mma_bf16_n128(half_of<1>(acc), a[e],
                          tc::desc(st + 8192 * e + 4096), 1);
      }
      tc::commit();
      tc::wait_all();
      tc::fence_regs(acc);
      ring.release(c);
    }
  } else {
    // Stage c holds k8 steps 2c and 2c+1: their hi tiles (8 KB each), then
    // their lo tiles.  Step 2c + e, position p is channel 16c + 4*(p%4) +
    // 2e + p/4, so the channels 16c + 4t .. +3 a thread loads as one float4
    // are its A values of both steps.  The tensor cores sum each stage's
    // products for 128 columns at a time in `part`, which is then added to
    // `acc` (tc::promote).
    float part[64];
    for (int c = 0; c < kChunks1; ++c) {
      float xa4[4], xb4[4];
      first_layer(4 * c + t, xa4, xb4);
      const tc::Split a0 = tc::split4(xa4[0], xb4[0], xa4[1], xb4[1]);
      const tc::Split a1 = tc::split4(xa4[2], xb4[2], xa4[3], xb4[3]);
      const uint32_t st = ring.acquire(c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns 128h .. 128h + 127
        tc::fence();
        tc::mma3(part, a0, st + 4096 * h, st + 16384 + 4096 * h, 0);
        tc::mma3(part, a1, st + 8192 + 4096 * h, st + 24576 + 4096 * h, 1);
        tc::commit();
        tc::wait_all();
        tc::fence_regs(part);
        if (h == 0) {
          tc::promote<0>(acc, part);
        } else {
          tc::promote<64>(acc, part);
        }
      }
      ring.release(c);
    }
  }

  // x1 = ReLU(acc * s1 + b1), in place: acc[4j + e] is column 8j + 2t + e%2
#pragma unroll
  for (int j = 0; j < kC2 / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 s = __ldg(reinterpret_cast<const float2*>(s1 + col));
    const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
    acc[4 * j] = relu_affine(acc[4 * j], s.x, b.x);
    acc[4 * j + 1] = relu_affine(acc[4 * j + 1], s.y, b.y);
    acc[4 * j + 2] = relu_affine(acc[4 * j + 2], s.x, b.x);
    acc[4 * j + 3] = relu_affine(acc[4 * j + 3], s.y, b.y);
  }

  // x2 = x1 @ W2
  float acc2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc2[i] = 0.0f;
  if constexpr (kBf16) {
    // Stage c holds k16 steps 8c .. 8c+7 (2 KB each); step s takes the
    // accumulator's columns 16s .. 16s+15 in natural order.
#pragma unroll
    for (int c = 0; c < kBf16Chunks2; ++c) {
      const uint32_t st = ring.acquire(kBf16Chunks1 + c);
      tc::fence();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int s = 8 * (8 * c + jj);
        const uint32_t a[4] = {tc::pack_bf16(acc[s], acc[s + 1]),
                               tc::pack_bf16(acc[s + 2], acc[s + 3]),
                               tc::pack_bf16(acc[s + 4], acc[s + 5]),
                               tc::pack_bf16(acc[s + 6], acc[s + 7])};
        tc::mma_bf16_n64(acc2, a, tc::desc(st + 2048 * jj), 1);
      }
      tc::commit();
      tc::wait_all();
      tc::fence_regs(acc2);
      ring.release(kBf16Chunks1 + c);
    }
  } else {
    // Stage c holds k8 steps 8c .. 8c+7: their hi tiles (2 KB each), then
    // their lo tiles.  Step j, position p is channel 8j + 2*(p%4) + p/4,
    // the columns 8j + 2t (p = t) and 8j + 2t + 1 (p = t + 4) the thread
    // already holds.  Two steps at a time are summed in `part2`, then added
    // to `acc2`.
    float part2[32];
#pragma unroll
    for (int c = 0; c < kChunks2; ++c) {
      const uint32_t st = ring.acquire(kChunks1 + c);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj;
        const tc::Split a = tc::split4(acc[4 * j], acc[4 * j + 2],
                                       acc[4 * j + 1], acc[4 * j + 3]);
        tc::fence();
        tc::mma3(part2, a, st + 2048 * jj, st + 16384 + 2048 * jj, jj % 2);
        if (jj % 2 == 1) {
          tc::commit();
          tc::wait_all();
          tc::fence_regs(part2);
          tc::promote<0>(acc2, part2);
        }
      }
      ring.release(kChunks1 + c);
    }
  }

  // x2 = ReLU(acc2 * s2 + b2) into shared memory
#pragma unroll
  for (int j = 0; j < kC3 / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 s = __ldg(reinterpret_cast<const float2*>(s2 + col));
    const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + col));
    *reinterpret_cast<float2*>(x2s + ra * kX2Stride + col) =
        make_float2(relu_affine(acc2[4 * j], s.x, b.x),
                    relu_affine(acc2[4 * j + 1], s.y, b.y));
    *reinterpret_cast<float2*>(x2s + rb * kX2Stride + col) =
        make_float2(relu_affine(acc2[4 * j + 2], s.x, b.x),
                    relu_affine(acc2[4 * j + 3], s.y, b.y));
  }
  tc::consumer_sync<kConsumers>();

  // max over each query's k rows
  for (int e = threadIdx.x; e < qpb * kC3; e += kConsumers) {
    const int qi = e / kC3, c = e % kC3;
    const int q = q0 + qi;
    if (q >= total) continue;
    float m = -INFINITY;
    for (int kk = 0; kk < k; ++kk) {
      m = fmaxf(m, x2s[(qi * k + kk) * kX2Stride + c]);
    }
    out[(int64_t)q * kC3 + c] = m;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    plf_kernel(const float* __restrict__ base,  // [B*N, kC1]
               const int* __restrict__ idx,     // [B*N, k]
               const float* __restrict__ xyz,   // [B*N, 3], centred
               const float* __restrict__ wrel,  // [3, kC1]
               const float* __restrict__ s0, const float* __restrict__ b0,
               const float* __restrict__ wpack,  // tc_weights
               const float* __restrict__ s1, const float* __restrict__ b1,
               const float* __restrict__ s2, const float* __restrict__ b2,
               float* __restrict__ out,  // [B*N, kC3]
               int total, int n, int k) {
  plf_body<false>(base, idx, xyz, wrel, s0, b0, wpack, s1, b1, s2, b2, out,
                  total, n, k);
}

__global__ void __launch_bounds__(kThreads, 1)
    plf_bf16_kernel(const __nv_bfloat16* __restrict__ base,  // [B*N, kC1]
                    const int* __restrict__ idx, const float* __restrict__ xyz,
                    const float* __restrict__ wrel,
                    const float* __restrict__ s0, const float* __restrict__ b0,
                    const __nv_bfloat16* __restrict__ wpack,  // tc_weights_bf16
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    float* __restrict__ out, int total, int n, int k) {
  plf_body<true>(base, idx, xyz, wrel, s0, b0, wpack, s1, b1, s2, b2, out,
                 total, n, k);
}

template <typename T, typename W>
int launch(void (*kernel)(const T*, const int*, const float*, const float*,
                          const float*, const float*, const W*, const float*,
                          const float*, const float*, const float*, float*,
                          int, int, int),
           size_t smem, const void* base, const void* idx, const void* xyz,
           const void* wrel, const void* s0, const void* b0,
           const void* wpack, const void* s1, const void* b1, const void* s2,
           const void* b2, void* out, int b, int n, int k, int c1,
           void* stream) {
  if (c1 != kC1 || k < 1 || k > kRows || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qpb = kRows / k;
  const int blocks = (total + qpb - 1) / qpb;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(base), static_cast<const int*>(idx),
      static_cast<const float*>(xyz), static_cast<const float*>(wrel),
      static_cast<const float*>(s0), static_cast<const float*>(b0),
      static_cast<const W*>(wpack), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<float*>(out), total, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// base [B,N,512] f32, idx [B,N,k] int32 (1 <= k <= 128), xyz [B,N,3]
// centred, wrel [3,512], s0/b0 [512], wpack from tc_weights (W1 [512,256]
// and W2 [256,64], split and ordered for the tensor cores), s1/b1 [256],
// s2/b2 [64], out [B,N,64]; c1 must be 512.  Returns a cudaError_t.
int cmflow_plf(const void* base, const void* idx, const void* xyz,
               const void* wrel, const void* s0, const void* b0,
               const void* wpack, const void* s1, const void* b1,
               const void* s2, const void* b2, void* out, int b, int n, int k,
               int c1, void* stream) {
  return launch(plf_kernel, smem_bytes<false>(), base, idx, xyz, wrel, s0,
                b0, wpack, s1, b1, s2, b2, out, b, n, k, c1, stream);
}

// The bf16 arm: base [B,N,512] bf16, wrel [3,512] f32 (the bf16-rounded
// values), wpack from tc_weights_bf16 (bf16), the rest as cmflow_plf.
int cmflow_plf_bf16(const void* base, const void* idx, const void* xyz,
                    const void* wrel, const void* s0, const void* b0,
                    const void* wpack, const void* s1, const void* b1,
                    const void* s2, const void* b2, void* out, int b, int n,
                    int k, int c1, void* stream) {
  return launch(plf_bf16_kernel, smem_bytes<true>(), base, idx, xyz, wrel,
                s0, b0, wpack, s1, b1, s2, b2, out, b, n, k, c1, stream);
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
