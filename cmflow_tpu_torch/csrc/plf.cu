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
// N=256 the four scales (K = 4, 8, 16, 32) hold 245,760 rows, 72.5 GFLOP,
// 1.08 ms at the float32 peak of 67 TFLOP/s, while the bytes that must move
// (base in, out back) take a few microseconds.  Evaluated layer by layer the
// [B,N,K,512] tensor between the gather and W1 would be 268 MB at K=32; this
// kernel never writes it.
//
// Design: a gather-GEMM with a max-pool epilogue.  A block of 256 threads
// takes 64 rows made of whole queries (64/K of them), so the max over K
// closes inside the block.  It gathers base rows, applies the offset, the
// affine and the ReLU, and keeps x0 [64, 512] in shared memory (128 KB).  W1
// (512 KB) cannot stay resident: it streams through a 32 KB slab, 32 rows at
// a time, against register tiles of 8x8 outputs per thread (block_gemm.cuh);
// then x1 [64, 256] overwrites x0 and W2 streams the same way into 4x4
// tiles.  x2 goes to shared memory for the max over each query's K rows.
// All arithmetic is float32 FFMA; no tensor cores (see block_gemm.cuh).
// 160 KB of dynamic shared memory needs cudaFuncSetAttribute, and a launch
// refused for it never runs, so the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // (query, neighbour) rows per block
constexpr int kC1 = 512;
constexpr int kC2 = 256;
constexpr int kC3 = 64;
constexpr int kSlabFloats = 32 * kC2;  // 32 rows of W1, 128 rows of W2
constexpr size_t kSmemBytes = (size_t)(kRows * kC1 + kSlabFloats) * 4;

// GEMM1: 8 rows x 8 columns per thread; GEMM2: 4 x 4
constexpr int kTm1 = 8, kNv1 = 2;
constexpr int kTm2 = 4, kNv2 = 1;
static_assert((kThreads / cmflow::TileMap<kC2, kNv1>::TX) * kTm1 == kRows,
              "GEMM1 tiles must cover the rows");
static_assert((kThreads / cmflow::TileMap<kC3, kNv2>::TX) * kTm2 == kRows,
              "GEMM2 tiles must cover the rows");

__device__ __forceinline__ float4 relu_affine4(float4 x, float4 s, float4 b) {
  return make_float4(fmaxf(fmaf(x.x, s.x, b.x), 0.0f),
                     fmaxf(fmaf(x.y, s.y, b.y), 0.0f),
                     fmaxf(fmaf(x.z, s.z, b.z), 0.0f),
                     fmaxf(fmaf(x.w, s.w, b.w), 0.0f));
}

__global__ void __launch_bounds__(kThreads, 1)
    plf_kernel(const float* __restrict__ base,  // [B*N, kC1]
               const int* __restrict__ idx,     // [B*N, k]
               const float* __restrict__ xyz,   // [B*N, 3], centred
               const float* __restrict__ wrel,  // [3, kC1]
               const float* __restrict__ s0, const float* __restrict__ b0,
               const float* __restrict__ w1,    // [kC1, kC2]
               const float* __restrict__ s1, const float* __restrict__ b1,
               const float* __restrict__ w2,    // [kC2, kC3]
               const float* __restrict__ s2, const float* __restrict__ b2,
               float* __restrict__ out,         // [B*N, kC3]
               int total, int n, int k) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // x0, then x1 and x2
  float* slab = act + kRows * kC1;
  float* x2s = act + kRows * kC2;  // beside x1
  __shared__ int row_j[kRows];     // neighbour row in base, or -1
  __shared__ int row_q[kRows];     // query, or -1 for an unused row
  __shared__ float row_xyz[kRows][3];

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
  __syncthreads();

  // gather and first layer: x0 = ReLU((base[j] - xyz_c[q] @ wrel) * s0 + b0)
  {
    constexpr int C4 = kC1 / 4;
    const float4* base4 = reinterpret_cast<const float4*>(base);
    const float4* wr4 = reinterpret_cast<const float4*>(wrel);
    const float4* s04 = reinterpret_cast<const float4*>(s0);
    const float4* b04 = reinterpret_cast<const float4*>(b0);
    float4* act4 = smem4;
    for (int e = threadIdx.x; e < kRows * C4; e += kThreads) {
      const int r = e / C4, c = e % C4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row_q[r] >= 0) {
        const int j = row_j[r];
        const float4 g = j >= 0 ? __ldg(base4 + (int64_t)j * C4 + c) : v;
        const float x = row_xyz[r][0], y = row_xyz[r][1], z = row_xyz[r][2];
        const float4 r0 = __ldg(wr4 + c), r1 = __ldg(wr4 + C4 + c),
                     r2 = __ldg(wr4 + 2 * C4 + c);
        const float4 off = make_float4(
            fmaf(z, r2.x, fmaf(y, r1.x, x * r0.x)),
            fmaf(z, r2.y, fmaf(y, r1.y, x * r0.y)),
            fmaf(z, r2.z, fmaf(y, r1.z, x * r0.z)),
            fmaf(z, r2.w, fmaf(y, r1.w, x * r0.w)));
        v = relu_affine4(make_float4(g.x - off.x, g.y - off.y, g.z - off.z,
                                     g.w - off.w),
                         __ldg(s04 + c), __ldg(b04 + c));
      }
      act4[e] = v;
    }
  }

  // x1 = ReLU((x0 @ W1) * s1 + b1), written over x0
  {
    using Map = cmflow::TileMap<kC2, kNv1>;
    float acc[kTm1][4 * kNv1] = {};
    cmflow::block_gemm<kThreads, kC2, kTm1, kNv1, kSlabFloats / kC2>(
        act, kC1, kC1, w1, slab, acc);
    const int row0 = Map::ty() * kTm1;
#pragma unroll
    for (int v = 0; v < kNv1; ++v) {
      const int c = Map::col(v);
      const float4 s = __ldg(reinterpret_cast<const float4*>(s1 + c));
      const float4 b = __ldg(reinterpret_cast<const float4*>(b1 + c));
#pragma unroll
      for (int i = 0; i < kTm1; ++i) {
        *reinterpret_cast<float4*>(act + (row0 + i) * kC2 + c) = relu_affine4(
            make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2],
                        acc[i][4 * v + 3]),
            s, b);
      }
    }
  }

  // x2 = ReLU((x1 @ W2) * s2 + b2), beside x1
  {
    using Map = cmflow::TileMap<kC3, kNv2>;
    float acc[kTm2][4 * kNv2] = {};
    cmflow::block_gemm<kThreads, kC3, kTm2, kNv2, kSlabFloats / kC3>(
        act, kC2, kC2, w2, slab, acc);
    const int row0 = Map::ty() * kTm2;
    const int c = Map::col(0);
    const float4 s = __ldg(reinterpret_cast<const float4*>(s2 + c));
    const float4 b = __ldg(reinterpret_cast<const float4*>(b2 + c));
#pragma unroll
    for (int i = 0; i < kTm2; ++i) {
      *reinterpret_cast<float4*>(x2s + (row0 + i) * kC3 + c) = relu_affine4(
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]), s, b);
    }
  }
  __syncthreads();

  // max over each query's k rows
  for (int e = threadIdx.x; e < qpb * kC3; e += kThreads) {
    const int qi = e / kC3, c = e % kC3;
    const int q = q0 + qi;
    if (q >= total) continue;
    float m = -INFINITY;
    for (int kk = 0; kk < k; ++kk) m = fmaxf(m, x2s[(qi * k + kk) * kC3 + c]);
    out[(int64_t)q * kC3 + c] = m;
  }
}

}  // namespace

extern "C" {

// base [B,N,512] f32, idx [B,N,k] int32 (1 <= k <= 64), xyz [B,N,3] centred,
// wrel [3,512], s0/b0 [512], w1 [512,256], s1/b1 [256], w2 [256,64],
// s2/b2 [64], out [B,N,64]; c1 must be 512.  Returns a cudaError_t.
int cmflow_plf(const void* base, const void* idx, const void* xyz,
               const void* wrel, const void* s0, const void* b0,
               const void* w1, const void* s1, const void* b1, const void* w2,
               const void* s2, const void* b2, void* out, int b, int n, int k,
               int c1, void* stream) {
  if (c1 != kC1 || k < 1 || k > kRows || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      plf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int qpb = kRows / k;
  const int blocks = (total + qpb - 1) / qpb;
  plf_kernel<<<blocks, kThreads, kSmemBytes,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int*>(idx),
      static_cast<const float*>(xyz), static_cast<const float*>(wrel),
      static_cast<const float*>(s0), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<float*>(out), total, n, k);
  return (int)cudaGetLastError();
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
