// The cost volume of CMFlow's FeatureCorrelator: point-to-patch and
// patch-to-patch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels cmflow_tpu/ops/fused.py::_cv_kernel
// (point-to-patch, cv_p2p_kernel here) and ::_cv_agg_kernel (patch-to-patch,
// cv_agg_kernel here), both called by fused_cost_volume.  The offsets are
// folded outside, around one centre shared by both clouds:
// f1c = f1t - x1c @ wd, f2c = f2t + x2c @ wd, z1 = x1c @ wn1_w0,
// z2 = x2c @ wn1_w0, zq = x1c @ wn2_w0.
//
// cv_p2p_kernel, for each query i and frame-2 neighbour j = idx[i, k]:
//   x0 = LeakyReLU(f1c[i] + f2c[j] + b0)            512 wide
//   x1 = LeakyReLU(x0 @ W1 + b1)                     512 wide
//   x2 = LeakyReLU(x1 @ W2 + b2)                     512 wide
//   w  = WeightNet1 on z2[j] - z1[i] (+wb0 -> 8 -> 8 -> 512, ReLU each)
//   p2p[i] = sum over k of w * x2
// What bounds it: operations.  ~528k multiply-adds per row (two 512x512
// products and the WeightNet); at B=16, N=256, k=8 that is 32,768 rows,
// 34.6 GFLOP, 0.52 ms at the float32 peak.
// Design: the shape of plf.cu.  A block of 256 threads takes 32 rows, whole
// queries (4 at k=8).  x0 [32, 512] and x1 [32, 512] stay in shared memory
// (64 KB each) and the 1 MB weights stream beside them through a 32 KB slab
// (16 rows) into 8x8 register tiles (block_gemm.cuh).  The WeightNet's two
// 8-wide layers run once per row in the gather phase; its 512-wide last
// layer runs in the epilogue of the second product, which writes w * x2 over
// x0 for the sum over each query's k rows.
//
// cv_agg_kernel: out[i] = sum over frame-1 neighbours j of
// WeightNet2(zq[j] - zq[i]) * p2p[j].
// What bounds it: bytes.  It reads p2p once per neighbour from L2 but needs
// it from device memory once: 8 MB in and 8 MB out at B=16, N=256 (~0.005
// ms); its arithmetic (8x512 weights per row) is small.
// Design: one warp per query, lanes over channels in float4s; the WeightNet's
// 8-wide layers are recomputed by every lane (tiny), its last layer per
// channel.
//
// All arithmetic is float32 FFMA; no tensor cores (see block_gemm.cuh).  The
// point-to-patch kernel's 161 KB of dynamic shared memory needs
// cudaFuncSetAttribute; a refused launch never runs, so each entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // (query, neighbour) rows per block
constexpr int kC = 512;
constexpr int kH = 8;  // WeightNet hidden width
constexpr int kSlabRows = 16;
constexpr int kTm = 8, kNv = 2;  // 8 x 8 outputs per thread
constexpr size_t kSmemBytes = (size_t)(2 * kRows * kC + kSlabRows * kC) * 4;
static_assert((kThreads / cmflow::TileMap<kC, kNv>::TX) * kTm == kRows,
              "tiles must cover the rows");

__device__ __forceinline__ float leaky(float x) {
  return x > 0.0f ? x : 0.1f * x;
}

__device__ __forceinline__ float4 leaky4(float4 v) {
  return make_float4(leaky(v.x), leaky(v.y), leaky(v.z), leaky(v.w));
}

// the WeightNet's two 8-wide layers: h = ReLU(ReLU(d + b0) @ w1 + b1)
__device__ __forceinline__ void weightnet_hidden(
    const float (&d)[kH], const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ b1,
    float (&h)[kH]) {
  float a[kH];
#pragma unroll
  for (int m = 0; m < kH; ++m) a[m] = fmaxf(d[m] + __ldg(b0 + m), 0.0f);
#pragma unroll
  for (int o = 0; o < kH; ++o) {
    float t = 0.0f;
#pragma unroll
    for (int m = 0; m < kH; ++m) t = fmaf(a[m], __ldg(w1 + m * kH + o), t);
    h[o] = fmaxf(t + __ldg(b1 + o), 0.0f);
  }
}

// the WeightNet's last layer for the four channels c..c+3
__device__ __forceinline__ float4 weightnet_out(
    const float* h, const float* __restrict__ w2, const float* __restrict__ b2,
    int c) {
  float4 t = __ldg(reinterpret_cast<const float4*>(b2 + c));
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int m = 0; m < kH; ++m) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(w2 + m * kC + c));
    acc.x = fmaf(h[m], w.x, acc.x);
    acc.y = fmaf(h[m], w.y, acc.y);
    acc.z = fmaf(h[m], w.z, acc.z);
    acc.w = fmaf(h[m], w.w, acc.w);
  }
  return make_float4(fmaxf(acc.x + t.x, 0.0f), fmaxf(acc.y + t.y, 0.0f),
                     fmaxf(acc.z + t.z, 0.0f), fmaxf(acc.w + t.w, 0.0f));
}

struct WeightNet {  // after its first product: (b0, w1, b1, w2, b2)
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
};

__global__ void __launch_bounds__(kThreads, 1)
    cv_p2p_kernel(const float* __restrict__ f1c,  // [B*N, kC]
                  const float* __restrict__ f2c,  // [B*N, kC]
                  const int* __restrict__ idx,    // [B*N, k]
                  const float* __restrict__ z1,   // [B*N, kH]
                  const float* __restrict__ z2,   // [B*N, kH]
                  const float* __restrict__ b0, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, WeightNet wn,
                  float* __restrict__ out,        // [B*N, kC]
                  int total, int n, int k) {
  extern __shared__ float4 smem4[];
  float* x0 = reinterpret_cast<float*>(smem4);  // then w * x2
  float* x1 = x0 + kRows * kC;
  float* slab = x1 + kRows * kC;
  __shared__ int row_j[kRows];  // neighbour row in f2c, or -1
  __shared__ int row_q[kRows];  // query, or -1 for an unused row
  __shared__ float row_h[kRows][kH];

  const int qpb = kRows / k;
  const int q0 = blockIdx.x * qpb;
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x;
    const int q = q0 + r / k;
    int j = -1, qq = -1;
    float h[kH];
#pragma unroll
    for (int m = 0; m < kH; ++m) h[m] = 0.0f;
    if (r < qpb * k && q < total) {
      qq = q;
      const int jj = idx[(int64_t)q * k + r % k];
      if (jj >= 0 && jj < n) j = (q / n) * n + jj;
      float d[kH];
#pragma unroll
      for (int m = 0; m < kH; ++m) {
        const float zj = j >= 0 ? z2[(int64_t)j * kH + m] : 0.0f;
        d[m] = zj - z1[(int64_t)q * kH + m];
      }
      weightnet_hidden(d, wn.b0, wn.w1, wn.b1, h);
    }
    row_j[r] = j;
    row_q[r] = qq;
#pragma unroll
    for (int m = 0; m < kH; ++m) row_h[r][m] = h[m];
  }
  __syncthreads();

  // gather and first layer: x0 = LeakyReLU(f1c[q] + f2c[j] + b0)
  {
    constexpr int C4 = kC / 4;
    const float4* f14 = reinterpret_cast<const float4*>(f1c);
    const float4* f24 = reinterpret_cast<const float4*>(f2c);
    const float4* b04 = reinterpret_cast<const float4*>(b0);
    float4* x04 = smem4;
    for (int e = threadIdx.x; e < kRows * C4; e += kThreads) {
      const int r = e / C4, c = e % C4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int q = row_q[r];
      if (q >= 0) {
        const int j = row_j[r];
        const float4 a = __ldg(f14 + (int64_t)q * C4 + c);
        const float4 g = j >= 0 ? __ldg(f24 + (int64_t)j * C4 + c) : v;
        const float4 bb = __ldg(b04 + c);
        v = leaky4(make_float4((a.x + g.x) + bb.x, (a.y + g.y) + bb.y,
                               (a.z + g.z) + bb.z, (a.w + g.w) + bb.w));
      }
      x04[e] = v;
    }
  }

  using Map = cmflow::TileMap<kC, kNv>;
  const int row0 = Map::ty() * kTm;
  // x1 = LeakyReLU(x0 @ W1 + b1)
  {
    float acc[kTm][4 * kNv] = {};
    cmflow::block_gemm<kThreads, kC, kTm, kNv, kSlabRows>(x0, kC, kC, w1,
                                                          slab, acc);
#pragma unroll
    for (int v = 0; v < kNv; ++v) {
      const int c = Map::col(v);
      const float4 b = __ldg(reinterpret_cast<const float4*>(b1 + c));
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        *reinterpret_cast<float4*>(x1 + (row0 + i) * kC + c) = leaky4(
            make_float4(acc[i][4 * v] + b.x, acc[i][4 * v + 1] + b.y,
                        acc[i][4 * v + 2] + b.z, acc[i][4 * v + 3] + b.w));
      }
    }
  }
  // x2 = LeakyReLU(x1 @ W2 + b2); w * x2 over x0
  {
    float acc[kTm][4 * kNv] = {};
    cmflow::block_gemm<kThreads, kC, kTm, kNv, kSlabRows>(x1, kC, kC, w2,
                                                          slab, acc);
#pragma unroll
    for (int v = 0; v < kNv; ++v) {
      const int c = Map::col(v);
      const float4 b = __ldg(reinterpret_cast<const float4*>(b2 + c));
#pragma unroll
      for (int i = 0; i < kTm; ++i) {
        const float4 x = leaky4(
            make_float4(acc[i][4 * v] + b.x, acc[i][4 * v + 1] + b.y,
                        acc[i][4 * v + 2] + b.z, acc[i][4 * v + 3] + b.w));
        const float4 w = weightnet_out(row_h[row0 + i], wn.w2, wn.b2, c);
        *reinterpret_cast<float4*>(x0 + (row0 + i) * kC + c) =
            make_float4(w.x * x.x, w.y * x.y, w.z * x.z, w.w * x.w);
      }
    }
  }
  __syncthreads();

  // sum over each query's k rows, in k order
  for (int e = threadIdx.x; e < qpb * kC; e += kThreads) {
    const int qi = e / kC, c = e % kC;
    const int q = q0 + qi;
    if (q >= total) continue;
    float s = x0[(qi * k) * kC + c];
    for (int kk = 1; kk < k; ++kk) s += x0[(qi * k + kk) * kC + c];
    out[(int64_t)q * kC + c] = s;
  }
}

constexpr int kAggWarps = 8;

__global__ void __launch_bounds__(kAggWarps * 32)
    cv_agg_kernel(const float* __restrict__ p2p,  // [B*N, kC]
                  const int* __restrict__ idx,    // [B*N, k]
                  const float* __restrict__ zq,   // [B*N, kH]
                  WeightNet wn, float* __restrict__ out, int total, int n,
                  int k) {
  constexpr int C4 = kC / 4;
  constexpr int kPerLane = C4 / 32;
  const int q = blockIdx.x * kAggWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= total) return;  // the same on every lane of the warp
  const int64_t bn0 = (int64_t)(q / n) * n;
  const float4* p4 = reinterpret_cast<const float4*>(p2p);
  float zi[kH];
#pragma unroll
  for (int m = 0; m < kH; ++m) zi[m] = zq[(int64_t)q * kH + m];
  float4 acc[kPerLane];
#pragma unroll
  for (int v = 0; v < kPerLane; ++v) acc[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int kk = 0; kk < k; ++kk) {
    const int jj = idx[(int64_t)q * k + kk];
    const bool inside = jj >= 0 && jj < n;
    const int64_t j = bn0 + (inside ? jj : 0);
    float d[kH], h[kH];
#pragma unroll
    for (int m = 0; m < kH; ++m) {
      d[m] = (inside ? zq[j * kH + m] : 0.0f) - zi[m];
    }
    weightnet_hidden(d, wn.b0, wn.w1, wn.b1, h);
#pragma unroll
    for (int v = 0; v < kPerLane; ++v) {
      const int c4 = lane + 32 * v;
      const float4 w = weightnet_out(h, wn.w2, wn.b2, 4 * c4);
      const float4 g = inside ? __ldg(p4 + j * C4 + c4)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      acc[v].x = fmaf(w.x, g.x, acc[v].x);
      acc[v].y = fmaf(w.y, g.y, acc[v].y);
      acc[v].z = fmaf(w.z, g.z, acc[v].z);
      acc[v].w = fmaf(w.w, g.w, acc[v].w);
    }
  }
  float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int v = 0; v < kPerLane; ++v) o4[(int64_t)q * C4 + lane + 32 * v] = acc[v];
}

bool valid_shape(int b, int n, int k, int c) {
  return c == kC && n >= 1 && b >= 0 && k >= 1 && k <= kRows;
}

}  // namespace

extern "C" {

// f1c/f2c [B,N,512], idx [B,N,k] int32 (1 <= k <= 32), z1/z2 [B,N,8],
// dense b0 [512], w1 [512,512], b1 [512], w2 [512,512], b2 [512], the
// WeightNet after its first product wb0 [8], ww1 [8,8], wb1 [8],
// ww2 [8,512], wb2 [512], out [B,N,512].  Returns a cudaError_t.
int cmflow_cv_p2p(const void* f1c, const void* f2c, const void* idx,
                  const void* z1, const void* z2, const void* b0,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* wb0, const void* ww1,
                  const void* wb1, const void* ww2, const void* wb2,
                  void* out, int b, int n, int k, int c, void* stream) {
  if (!valid_shape(b, n, k, c)) return (int)cudaErrorInvalidValue;
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      cv_p2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const WeightNet wn{static_cast<const float*>(wb0),
                     static_cast<const float*>(ww1),
                     static_cast<const float*>(wb1),
                     static_cast<const float*>(ww2),
                     static_cast<const float*>(wb2)};
  const int qpb = kRows / k;
  cv_p2p_kernel<<<(total + qpb - 1) / qpb, kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1c), static_cast<const float*>(f2c),
      static_cast<const int*>(idx), static_cast<const float*>(z1),
      static_cast<const float*>(z2), static_cast<const float*>(b0),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), wn,
      static_cast<float*>(out), total, n, k);
  return (int)cudaGetLastError();
}

// p2p [B,N,512], idx [B,N,k] int32 (1 <= k <= 32), zq [B,N,8], the WeightNet
// after its first product as above, out [B,N,512].  Returns a cudaError_t.
int cmflow_cv_agg(const void* p2p, const void* idx, const void* zq,
                  const void* wb0, const void* ww1, const void* wb1,
                  const void* ww2, const void* wb2, void* out, int b, int n,
                  int k, int c, void* stream) {
  if (!valid_shape(b, n, k, c)) return (int)cudaErrorInvalidValue;
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  const WeightNet wn{static_cast<const float*>(wb0),
                     static_cast<const float*>(ww1),
                     static_cast<const float*>(wb1),
                     static_cast<const float*>(ww2),
                     static_cast<const float*>(wb2)};
  cv_agg_kernel<<<(total + kAggWarps - 1) / kAggWarps, kAggWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p2p), static_cast<const int*>(idx),
      static_cast<const float*>(zq), wn, static_cast<float*>(out), total, n,
      k);
  return (int)cudaGetLastError();
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
