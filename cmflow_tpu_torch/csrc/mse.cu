// The narrow multi-scale (sa) encoder, all scales in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel cmflow_tpu/ops/fused.py::_mse_kernel
// (called by fused_multi_scale_encoder).  For each query i and scale s, over
// its first K_s ball-query neighbours j:
//   x0 = ReLU((base[j, s] - xyz_c[i] @ w0r_s) * s0_s + b0_s)      32 wide
//   x1 = ReLU((x0 @ w1_s) * s1_s + b1_s)                            32 wide
//   x2 = ReLU((x1 @ w2_s) * s2_s + b2_s)                            64 wide
//   out[i, s] = max over k < K_s of x2
// where base[j, s] = feats[j] @ w0f_s + xyz_c[j] @ w0r_s is folded outside.
//
// What bounds it: operations, barely.  3,072 multiply-adds per (query,
// neighbour) row, 60 rows per query over the four scales; at B=16, N=256
// one launch is ~1.5 GFLOP (~0.02 ms at the float32 peak) and moves ~4 MB.
// The rows are narrow (32 and 64 channels), so the work is many tiny
// products.
//
// Design: one warp per (query, scale), lanes over channels.  A block serves
// one scale, so only that scale's w1 (32x32), w2 (32x64), w0r and affines
// sit in shared memory (~13 KB).  Per neighbour the warp gathers one 128-byte
// row of base (coalesced), writes its activation row to a per-warp shared
// buffer and reads it back as broadcasts against the weight columns.  The
// loop runs over k < K_s only, so the JAX kernel's per-scale masking becomes
// a loop bound, and the running max stays in registers.  The TPU kernel's
// block-diagonal packing and stacked one-hot gather existed to fill the MXU
// and have no counterpart here.  All arithmetic is float32 FFMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC1 = 32;  // first layer width, one channel per lane
constexpr int kC2 = 32;
constexpr int kC3 = 64;  // two channels per lane
constexpr int kMaxScales = 4;
constexpr int kWarps = 8;
constexpr int kQueriesPerWarp = 4;

struct Scales {
  int count;
  int k[kMaxScales];
  const int* idx[kMaxScales];  // [B*N, k[s]]
};

__global__ void __launch_bounds__(kWarps * 32)
    mse_kernel(const float* __restrict__ base,   // [B*N, S*kC1]
               const float* __restrict__ xyz,    // [B*N, 3], centred
               const float* __restrict__ w0r,    // [3, S*kC1]
               const float* __restrict__ s0, const float* __restrict__ b0,
               const float* __restrict__ w1,     // [S, kC1, kC2]
               const float* __restrict__ s1, const float* __restrict__ b1,
               const float* __restrict__ w2,     // [S, kC2, kC3]
               const float* __restrict__ s2, const float* __restrict__ b2,
               float* __restrict__ out,          // [B*N, S*kC3]
               int total, int n, Scales sc) {
  __shared__ float w1s[kC1][kC2];
  __shared__ float w2s[kC2][kC3];
  __shared__ float wr[3][kC1];
  __shared__ float xbuf[kWarps][kC1];
  __shared__ float hbuf[kWarps][kC2];

  const int s = blockIdx.y;
  const int S = sc.count;
  const int K = sc.k[s];
  const int* __restrict__ idx = sc.idx[s];
  for (int e = threadIdx.x; e < kC1 * kC2; e += blockDim.x) {
    w1s[e / kC2][e % kC2] = w1[(size_t)s * kC1 * kC2 + e];
  }
  for (int e = threadIdx.x; e < kC2 * kC3; e += blockDim.x) {
    w2s[e / kC3][e % kC3] = w2[(size_t)s * kC2 * kC3 + e];
  }
  for (int e = threadIdx.x; e < 3 * kC1; e += blockDim.x) {
    wr[e / kC1][e % kC1] = w0r[(e / kC1) * S * kC1 + s * kC1 + e % kC1];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float s0l = s0[s * kC1 + lane], b0l = b0[s * kC1 + lane];
  const float s1l = s1[s * kC2 + lane], b1l = b1[s * kC2 + lane];
  const float s2a = s2[s * kC3 + lane], b2a = b2[s * kC3 + lane];
  const float s2b = s2[s * kC3 + lane + 32], b2b = b2[s * kC3 + lane + 32];
  const unsigned full = 0xffffffffu;

  for (int t = 0; t < kQueriesPerWarp; ++t) {
    // q is the same on every lane of the warp, so the exit is uniform
    const int q = (blockIdx.x * kQueriesPerWarp + t) * kWarps + warp;
    if (q >= total) break;
    const int64_t bn0 = (int64_t)(q / n) * n;  // first row of q's cloud
    const float x = xyz[(int64_t)q * 3], y = xyz[(int64_t)q * 3 + 1],
                z = xyz[(int64_t)q * 3 + 2];
    const float off = fmaf(z, wr[2][lane], fmaf(y, wr[1][lane], x * wr[0][lane]));
    const int my_j = lane < K ? idx[(int64_t)q * K + lane] : 0;
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const int j = __shfl_sync(full, my_j, k);
      const float g = (j >= 0 && j < n)
                          ? base[(bn0 + j) * S * kC1 + s * kC1 + lane]
                          : 0.0f;
      xbuf[warp][lane] = fmaxf(fmaf(g - off, s0l, b0l), 0.0f);
      __syncwarp();
      float a = 0.0f;
#pragma unroll
      for (int c = 0; c < kC1; ++c) a = fmaf(xbuf[warp][c], w1s[c][lane], a);
      hbuf[warp][lane] = fmaxf(fmaf(a, s1l, b1l), 0.0f);
      __syncwarp();
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
      for (int c = 0; c < kC2; ++c) {
        const float h = hbuf[warp][c];
        a0 = fmaf(h, w2s[c][lane], a0);
        a1 = fmaf(h, w2s[c][lane + 32], a1);
      }
      m0 = fmaxf(m0, fmaxf(fmaf(a0, s2a, b2a), 0.0f));
      m1 = fmaxf(m1, fmaxf(fmaf(a1, s2b, b2b), 0.0f));
      __syncwarp();  // the buffers are free for the next neighbour
    }
    out[(int64_t)q * S * kC3 + s * kC3 + lane] = m0;
    out[(int64_t)q * S * kC3 + s * kC3 + lane + 32] = m1;
  }
}

}  // namespace

extern "C" {

// base [B,N,S*32], idx[s] [B,N,ks[s]] int32 (ks[s] <= 32), xyz [B,N,3]
// centred, w0r [3,S*32], s0/b0 [S*32], w1 [S,32,32], s1/b1 [S*32],
// w2 [S,32,64], s2/b2 [S*64], out [B,N,S*64].  Returns a cudaError_t.
int cmflow_mse(const void* base, void* const* idx, const int* ks, int count,
               const void* xyz, const void* w0r, const void* s0,
               const void* b0, const void* w1, const void* s1, const void* b1,
               const void* w2, const void* s2, const void* b2, void* out,
               int b, int n, void* stream) {
  if (count < 1 || count > kMaxScales || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Scales sc;
  sc.count = count;
  for (int t = 0; t < kMaxScales; ++t) {
    sc.k[t] = t < count ? ks[t] : 0;
    sc.idx[t] = t < count ? static_cast<const int*>(idx[t]) : nullptr;
    if (t < count && (sc.k[t] < 1 || sc.k[t] > 32)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  const int per_block = kWarps * kQueriesPerWarp;
  const dim3 grid((total + per_block - 1) / per_block, count);
  mse_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const float*>(xyz),
      static_cast<const float*>(w0r), static_cast<const float*>(s0),
      static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<float*>(out), total, n, sc);
  return (int)cudaGetLastError();
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
