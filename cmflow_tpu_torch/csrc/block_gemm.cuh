// Block-level float32 matrix product for the fused kernels (plf.cu,
// cost_volume.cu), on the CUDA cores with FFMA.
//
// No tensor cores on purpose: TF32 keeps about 10 mantissa bits, and over
// 512-wide sums that breaks the 1e-4 bars the fused engine is held to.
//
// A block of THREADS threads computes the product of an activation tile A
// [ROWS, cin], resident in shared memory, with a weight W [cin, COUT] in
// device memory.  W is streamed through shared memory SLAB_ROWS rows at a
// time (the weights are too large to stay resident: 512x512 floats is 1 MB),
// and each thread keeps a TM x 4*NV register tile of the output:
//   rows    ty*TM + i,                 i < TM
//   columns 4*(tx + v*TX) + c,         v < NV, c < 4
// with TX = COUT / (4*NV), tx = threadIdx.x % TX, ty = threadIdx.x / TX, so
// ROWS = (THREADS / TX) * TM.  The lanes of a warp share ty: their A reads
// are broadcasts, and their W reads are consecutive float4s, free of bank
// conflicts.

#pragma once

#include <cuda_runtime.h>

namespace cmflow {

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int COUT, int NV>
struct TileMap {
  static constexpr int TX = COUT / (4 * NV);
  __device__ static int tx() { return threadIdx.x % TX; }
  __device__ static int ty() { return threadIdx.x / TX; }
  // first of the four columns of float4 v
  __device__ static int col(int v) { return 4 * (tx() + v * TX); }
};

// acc[i][4*v + c] += sum over k < cin of A[row * lda + k] * W[k * COUT + col]
// for the thread's rows and columns (see above).  A: shared memory, row
// stride lda, both lda and cin multiples of 4, 16-byte aligned.  slab:
// SLAB_ROWS * COUT floats of shared memory.  Every thread of the block must
// call it.  It begins with a barrier, so that writes to A made before the
// call are seen, and ends with one, so that the caller may then overwrite A
// or the slab.
template <int THREADS, int COUT, int TM, int NV, int SLAB_ROWS>
__device__ __forceinline__ void block_gemm(const float* A, int lda, int cin,
                                           const float* __restrict__ W,
                                           float* slab,
                                           float (&acc)[TM][4 * NV]) {
  using Map = TileMap<COUT, NV>;
  constexpr int C4 = COUT / 4;
  static_assert(COUT % (4 * NV) == 0, "columns must split evenly");
  static_assert(THREADS % Map::TX == 0, "threads must cover whole rows");
  static_assert(SLAB_ROWS % 4 == 0, "slab rows come in fours");
  const int tx = Map::tx();
  const int row0 = Map::ty() * TM;
  const float4* w4 = reinterpret_cast<const float4*>(W);
  float4* s4 = reinterpret_cast<float4*>(slab);
  for (int k0 = 0; k0 < cin; k0 += SLAB_ROWS) {
    const int rows = min(SLAB_ROWS, cin - k0);
    __syncthreads();  // the previous slab is consumed; A is written
    for (int e = threadIdx.x; e < rows * C4; e += THREADS) {
      s4[e] = __ldg(w4 + (size_t)k0 * C4 + e);
    }
    __syncthreads();
    for (int k = 0; k < rows; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = *reinterpret_cast<const float4*>(A + (row0 + i) * lda + k0 +
                                                k);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) b[v] = s4[(k + kk) * C4 + tx + v * Map::TX];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = lane_of(a[i], kk);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            acc[i][4 * v + 0] = fmaf(x, b[v].x, acc[i][4 * v + 0]);
            acc[i][4 * v + 1] = fmaf(x, b[v].y, acc[i][4 * v + 1]);
            acc[i][4 * v + 2] = fmaf(x, b[v].z, acc[i][4 * v + 2]);
            acc[i][4 * v + 3] = fmaf(x, b[v].w, acc[i][4 * v + 3]);
          }
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace cmflow
