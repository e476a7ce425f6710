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
// 34.6 GFLOP: 0.21 ms at the dense TF32 peak in 3xTF32 (tc_gemm.cuh), with
// the split weights (4 MB) streamed from L2 once per block beside it.
// Design: on wgmma (tc_gemm.cuh).  A block takes 64 rows, whole queries (8
// at k=8): two consumer warpgroups, each on all 64 rows and one half of the
// 512 columns (a float32 sum in 128 registers a thread, into which the CUDA
// cores add the tensor cores' sum of each k8 step, 128 columns at a time:
// tc::promote), and a producer warpgroup (registers handed to the consumers
// with setmaxnreg) one thread of which streams the packed weights (W1 then
// W2, TF32 hi and lo, ops/fused.py::tc_weights) through a ring of three
// 32 KB stages, one k8 step each, with cp.async.bulk, completed on
// mbarriers.  Both warpgroups read each stage, so every weight byte from L2
// serves 64 rows.
// - x0 never exists in memory: each thread loads four consecutive channels
//   of f1c and f2c for its two rows per float4 and splits them into the A
//   fragments of two k8 steps in registers.
// - x1 [64, 512] goes to shared memory (128 KB) in the A-fragment order of
//   the second product, one float4 per thread and k8 step, since each
//   warpgroup needs all of it.
// - The WeightNet's two 8-wide layers run per row in the epilogue of the
//   second product, and its 512-wide last layer per column; w * x2 goes over
//   x1 for the sum over each query's k rows.
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
// All sums are float32.  The point-to-patch kernel's 224 KB of dynamic
// shared memory needs cudaFuncSetAttribute; a refused launch never runs, so
// each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {

namespace tc = cmflow::tc;

constexpr int kC = 512;
constexpr int kH = 8;        // WeightNet hidden width
constexpr int kMaxK = 32;    // neighbours per query the kernels take
constexpr int kP2pConsumers = 256;  // two warpgroups
constexpr int kP2pThreads = kP2pConsumers + 128;  // and a producer warpgroup
constexpr int kP2pRows = 64;  // (query, neighbour) rows per block
constexpr int kSteps = kC / 8;  // k8 steps of one product
constexpr int kStageBytes = 2 * 8 * kC * 4;  // one k8 step, hi and lo
constexpr int kP2pStages = 3;
constexpr size_t kSmemBytes =
    (size_t)kP2pStages * kStageBytes + (size_t)kP2pRows * kC * 4;
using WeightRing = tc::Ring<kP2pStages, kStageBytes>;
constexpr int kPackHalf = 2 * kC * kC;  // floats of each half (hi, lo)

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

__device__ __forceinline__ float4 load_or_zero(const float4* p, int i) {
  return p ? __ldg(p + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// the WeightNet's last layer for the two channels c, c+1
__device__ __forceinline__ float2 weightnet_out2(
    const float (&h)[kH], const float* __restrict__ w2,
    const float* __restrict__ b2, int c) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(b2 + c));
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int m = 0; m < kH; ++m) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(w2 + m * kC + c));
    acc.x = fmaf(h[m], w.x, acc.x);
    acc.y = fmaf(h[m], w.y, acc.y);
  }
  return make_float2(fmaxf(acc.x + t.x, 0.0f), fmaxf(acc.y + t.y, 0.0f));
}

// One k8 step of a 512-wide product for a warpgroup's 256 columns: the
// three products of 3xTF32 summed by the tensor cores in `part`, 128 columns
// at a time, then added to `acc` (tc::promote).  The stage at `st` holds the
// step's hi tile (16 KB), then its lo tile; the warpgroup's columns start
// `half` bytes into each.
__device__ __forceinline__ void p2p_step(float (&acc)[128], float (&part)[64],
                                         const tc::Split& a, uint32_t st,
                                         uint32_t half) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tc::fence();
    tc::mma3(part, a, st + half + 4096 * h, st + 16384 + half + 4096 * h, 0);
    tc::commit();
    tc::wait_all();
    tc::fence_regs(part);
    if (h == 0) {
      tc::promote<0>(acc, part);
    } else {
      tc::promote<64>(acc, part);
    }
  }
}

__global__ void __launch_bounds__(kP2pThreads, 1)
    cv_p2p_kernel(const float* __restrict__ f1c,  // [B*N, kC]
                  const float* __restrict__ f2c,  // [B*N, kC]
                  const int* __restrict__ idx,    // [B*N, k]
                  const float* __restrict__ z1,   // [B*N, kH]
                  const float* __restrict__ z2,   // [B*N, kH]
                  const float* __restrict__ b0,
                  const float* __restrict__ wpack,  // tc_weights
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  WeightNet wn,
                  float* __restrict__ out,  // [B*N, kC]
                  int total, int n, int k) {
  extern __shared__ __align__(128) char smem[];
  // x1, then w * x2, in A-fragment order: step S (8 channels), then the
  // warpgroup's 128 threads, a float4 each
  float4* xbuf = reinterpret_cast<float4*>(smem + kP2pStages * kStageBytes);
  __shared__ int row_j[kP2pRows];  // neighbour row in f2c, or -1
  __shared__ int row_q[kP2pRows];  // query, or -1 for an unused row
  __shared__ __align__(8) uint64_t full[kP2pStages];
  __shared__ __align__(8) uint64_t empty[kP2pStages];
  const WeightRing ring{smem, full, empty};

  const int qpb = kP2pRows / k;
  const int q0 = blockIdx.x * qpb;
  if (threadIdx.x < kP2pRows) {
    const int r = threadIdx.x;
    const int q = q0 + r / k;
    int j = -1, qq = -1;
    if (r < qpb * k && q < total) {
      qq = q;
      const int jj = idx[(int64_t)q * k + r % k];
      if (jj >= 0 && jj < n) j = (q / n) * n + jj;
    }
    row_j[r] = j;
    row_q[r] = qq;
  }
  if (threadIdx.x == 0) ring.init(kP2pConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kP2pConsumers) {  // the producer warpgroup: one thread
    tc::producer_registers();
    if (threadIdx.x == kP2pConsumers) {
      ring.produce(reinterpret_cast<const char*>(wpack),
                   reinterpret_cast<const char*>(wpack + kPackHalf),
                   2 * kSteps);
    }
    return;
  }
  tc::consumer_registers();

  // warpgroup wg computes columns 256*wg .. +255 of all 64 rows; the
  // thread's two rows are ra and rb (tc_gemm.cuh, fragment layouts)
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * warp + g, rb = ra + 8;
  const uint32_t half = 8192 * wg;  // the warpgroup's columns in a B tile
  constexpr int C4 = kC / 4;
  const int qa = row_q[ra], qb = row_q[rb];
  const int ja = row_j[ra], jb = row_j[rb];
  const float4* f14 = reinterpret_cast<const float4*>(f1c);
  const float4* f24 = reinterpret_cast<const float4*>(f2c);
  const float4* b04 = reinterpret_cast<const float4*>(b0);
  const float4* p1a = qa >= 0 ? f14 + (int64_t)qa * C4 : nullptr;
  const float4* p1b = qb >= 0 ? f14 + (int64_t)qb * C4 : nullptr;
  const float4* p2a = qa >= 0 && ja >= 0 ? f24 + (int64_t)ja * C4 : nullptr;
  const float4* p2b = qb >= 0 && jb >= 0 ? f24 + (int64_t)jb * C4 : nullptr;

  float acc[128];
  float part[64];
  // x1 = x0 @ W1 with x0 = LeakyReLU(f1c[q] + f2c[j] + b0).  Step 2c + e,
  // position p is channel 16c + 4*(p%4) + 2e + p/4, so the float4 at
  // channels 16c + 4t holds the thread's A values of steps 2c and 2c + 1.
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  for (int c = 0; c < kSteps / 2; ++c) {
    const int c4 = 4 * c + t;
    const float4 bb = __ldg(b04 + c4);
    const float4 f1a = load_or_zero(p1a, c4), f2a = load_or_zero(p2a, c4);
    const float4 f1b = load_or_zero(p1b, c4), f2b = load_or_zero(p2b, c4);
    const float4 xa = qa >= 0 ? leaky4(make_float4((f1a.x + f2a.x) + bb.x,
                                                   (f1a.y + f2a.y) + bb.y,
                                                   (f1a.z + f2a.z) + bb.z,
                                                   (f1a.w + f2a.w) + bb.w))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 xb = qb >= 0 ? leaky4(make_float4((f1b.x + f2b.x) + bb.x,
                                                   (f1b.y + f2b.y) + bb.y,
                                                   (f1b.z + f2b.z) + bb.z,
                                                   (f1b.w + f2b.w) + bb.w))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    p2p_step(acc, part, tc::split4(xa.x, xb.x, xa.y, xb.y),
             ring.acquire(2 * c), half);
    ring.release(2 * c);
    p2p_step(acc, part, tc::split4(xa.z, xb.z, xa.w, xb.w),
             ring.acquire(2 * c + 1), half);
    ring.release(2 * c + 1);
  }

  // x1 = LeakyReLU(acc + b1) into shared memory, already in the A-fragment
  // order of the second product: acc[4j + e] is (row ra or rb, column
  // 256*wg + 8j + 2t + e%2), which step S = 32*wg + j takes at positions t
  // and t + 4.
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 256 * wg + 8 * j + 2 * t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
    xbuf[(32 * wg + j) * 128 + tid] =
        make_float4(leaky(acc[4 * j] + b.x), leaky(acc[4 * j + 2] + b.x),
                    leaky(acc[4 * j + 1] + b.y), leaky(acc[4 * j + 3] + b.y));
  }
  tc::consumer_sync<kP2pConsumers>();

  // x2 = x1 @ W2: step S, position p is channel 8S + 2*(p%4) + p/4
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  float4 xn = xbuf[tid];
  for (int s = 0; s < kSteps; ++s) {
    const float4 x = xn;
    if (s + 1 < kSteps) xn = xbuf[(s + 1) * 128 + tid];
    p2p_step(acc, part, tc::split4(x.x, x.y, x.z, x.w),
             ring.acquire(kSteps + s), half);
    ring.release(kSteps + s);
  }

  // w * LeakyReLU(acc + b2), w the WeightNet of z2[j] - z1[q], over x1
  float ha[kH], hb[kH];
  {
    float da[kH], db[kH];
#pragma unroll
    for (int m = 0; m < kH; ++m) {
      da[m] = (ja >= 0 ? z2[(int64_t)ja * kH + m] : 0.0f) -
              (qa >= 0 ? z1[(int64_t)qa * kH + m] : 0.0f);
      db[m] = (jb >= 0 ? z2[(int64_t)jb * kH + m] : 0.0f) -
              (qb >= 0 ? z1[(int64_t)qb * kH + m] : 0.0f);
    }
    weightnet_hidden(da, wn.b0, wn.w1, wn.b1, ha);
    weightnet_hidden(db, wn.b0, wn.w1, wn.b1, hb);
  }
  tc::consumer_sync<kP2pConsumers>();  // every thread has read x1
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 256 * wg + 8 * j + 2 * t;
    const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + col));
    const float2 wa = weightnet_out2(ha, wn.w2, wn.b2, col);
    const float2 wb = weightnet_out2(hb, wn.w2, wn.b2, col);
    xbuf[(32 * wg + j) * 128 + tid] =
        make_float4(wa.x * leaky(acc[4 * j] + b.x),
                    wb.x * leaky(acc[4 * j + 2] + b.x),
                    wa.y * leaky(acc[4 * j + 1] + b.y),
                    wb.y * leaky(acc[4 * j + 3] + b.y));
  }
  tc::consumer_sync<kP2pConsumers>();

  // sum over each query's k rows, in k order; (row r, column c) lies in
  // step c/8, warp r/16, lane 4*(r%8) + (c%8)/2, float (r%16)/8 + 2*(c%2)
  const float* xs = reinterpret_cast<const float*>(xbuf);
  for (int e = threadIdx.x; e < qpb * kC; e += kP2pConsumers) {
    const int qi = e / kC, c = e % kC;
    const int q = q0 + qi;
    if (q >= total) continue;
    const int cbase = (c / 8) * 512 + ((c % 8) / 2) * 4 + 2 * (c % 2);
    float s = 0.0f;
    for (int kk = 0; kk < k; ++kk) {
      const int r = qi * k + kk;
      const float v =
          xs[cbase + (r / 16) * 128 + (r % 8) * 16 + (r % 16) / 8];
      s = kk == 0 ? v : s + v;
    }
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
  return c == kC && n >= 1 && b >= 0 && k >= 1 && k <= kMaxK;
}

}  // namespace

extern "C" {

// f1c/f2c [B,N,512], idx [B,N,k] int32 (1 <= k <= 32), z1/z2 [B,N,8],
// dense b0 [512], wpack from tc_weights (w1 and w2 [512,512], split and
// ordered for the tensor cores), b1 [512], b2 [512], the WeightNet after its
// first product wb0 [8], ww1 [8,8], wb1 [8], ww2 [8,512], wb2 [512],
// out [B,N,512].  Returns a cudaError_t.
int cmflow_cv_p2p(const void* f1c, const void* f2c, const void* idx,
                  const void* z1, const void* z2, const void* b0,
                  const void* wpack, const void* b1, const void* b2,
                  const void* wb0, const void* ww1, const void* wb1,
                  const void* ww2, const void* wb2, void* out, int b, int n,
                  int k, int c, void* stream) {
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
  const int qpb = kP2pRows / k;
  cv_p2p_kernel<<<(total + qpb - 1) / qpb, kP2pThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1c), static_cast<const float*>(f2c),
      static_cast<const int*>(idx), static_cast<const float*>(z1),
      static_cast<const float*>(z2), static_cast<const float*>(b0),
      static_cast<const float*>(wpack), static_cast<const float*>(b1),
      static_cast<const float*>(b2), wn, static_cast<float*>(out), total, n,
      k);
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
