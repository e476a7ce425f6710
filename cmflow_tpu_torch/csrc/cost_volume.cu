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
// Design: on wgmma (tc_gemm.cuh).  A block takes tiles of 64 rows: one
// tile of 64 / k whole queries (8 at k=8) where those fill at least 7/8 of
// it (every k that divides 64; 5, 7, 12, ...); at every other k
// (cv_p2p_full_kernel, the full-tile arm: 24, 33, 48, every k past 64) a
// run of consecutive whole queries planned by the host
// (ops/fused.py::cv_p2p_plan: one block an SM, the runs balanced in
// tiles), their rows one after the other in full tiles across query
// boundaries, a query's sums carried in registers from one tile to the
// next, k ascending as in one tile, so every k keeps the bits of one
// tile's sum.  A tile has two consumer warpgroups, each on all 64 rows and
// one half of the 512 columns (a float32 sum in 128 registers a thread,
// into which the CUDA cores add the tensor cores' sum of each k8 step, 128
// columns at a time: tc::promote), and a producer warpgroup (registers
// handed to the consumers with setmaxnreg) one thread of which streams the
// packed weights (W1 then W2, TF32 hi and lo, ops/fused.py::tc_weights)
// through a ring of three 32 KB stages, one k8 step each, with
// cp.async.bulk, completed on mbarriers.  Both warpgroups read each stage,
// so every weight byte from L2 serves 64 rows; in the full-tile arm x0's
// rows are staged two step pairs ahead by cp.async into x1's buffer.  What
// holds the full-tile arm (scripts/profile_torch_cv.py ablate, NVIDIA H100
// 80GB HBM3 at 700 W): the 4 MB of weights each tile brings into its SM;
// sharing each stage between the two blocks of a cluster by multicast
// saved nothing (PERF.md §6), without its products a tile still takes 57%
// of its time, and each product ~88k cycles against ~47k at the 3xTF32
// peak.
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
// cv_agg_kernel: out[i] = sum over frame-1 neighbours j = idx[i, k] of
// WeightNet2(zq[j] - zq[i]) * p2p[j], any k >= 1.
// What bounds it: bytes, with its arithmetic close behind.  It needs p2p
// from device memory once: 8 MB in and 8 MB out at B=16, N=256, k=8 (~0.005
// ms at 3.35 TB/s); the WeightNet's last layer is 8 multiply-adds per
// (query, neighbour, channel), 134 M at that shape (~0.004 ms at the float32
// peak).  Each neighbour's 2 KB row is read once per query that names it,
// 64 MB from L2 at that shape.
// Design: a block of 256 threads takes kAggQ queries of one batch element;
// a thread owns one float4 cell (four channels) of the 512 for the queries
// tid / 128, +2, ...  It holds its cell's columns of the last layer (8 float4)
// and its bias in registers for the whole block; the 8-wide layers sit in
// shared memory.  The neighbours go in chunks of kAggKc: one thread per
// (query, neighbour) loads the index and both zq rows and computes the
// 8-wide hidden layer once, into shared memory, beside the neighbour's row
// number.  Then each thread streams the p2p columns of its queries'
// neighbours into its own cells of a shared-memory ring with cp.async, one
// query ahead of its sum (a warp's copy is 512 contiguous bytes), so that
// no register waits on a load, and adds w * p2p[j] neighbour by neighbour.
// Chunks bound shared memory, so k has no limit.  The sums run in the
// plain function's orders: over k ascending, and each 8-term dot over m
// ascending, as fused multiply-adds from zero; no atomics, so reruns give
// the same bits.  What holds it (scripts/profile_torch_cv_agg.py): the
// instructions of the sum, not the loads; leaving out the p2p reads saves
// ~5%, leaving out the last layer ~30%.
// cv_agg_any_kernel, the same body at any C: a block takes one chunk of
// `cells` cells of the row (blockIdx.y) for 256 / cells * per queries, per
// a thread (both from ops/fused.py::cv_agg_plan, which sizes the grid to
// the card's waves); the hidden layer is computed again for each chunk.
// A row whose start is not aligned to a cell (C not a multiple of 4, or p2p
// a view that starts off a cell) is copied in pieces of 8, 4 or (bf16) 2
// bytes, the channels past C
// as zeros; the sums are the same operations in the same order, so each
// channel's bits are those of any other chunking.
//
// All sums are float32.  The kernels' dynamic shared memory (224 KB and
// 64 KB) needs cudaFuncSetAttribute; a refused launch never runs, so each
// entry point returns cudaGetLastError().
//
// The bf16 arms (the JAX kernels' bf16 serving mode, fused.py:721-725,
// :742-745, :792-796, :912-918):
// - cv_p2p_bf16_kernel reads f1c and f2c in bf16, forms x0 in float32 and
//   rounds it, and x1, to bf16 (nearest even) before the two 512x512
//   products, which sum in float32 in the tensor cores (their drift, ~5e-6
//   of a sum's size, is far below the arm's 1e-2 bar, so nothing is
//   promoted); the WeightNet, w * x2 and the sum over k stay float32 as
//   above, and the sum is stored rounded to bf16 once.  It takes any K.
//   What bounds it: operations, 34.6 GFLOP at B=16, N=256, k=8, 0.035 ms at
//   the dense bf16 peak (989 TFLOP/s).  Its packed bf16 weights
//   (ops/fused.py::tc_weights_bf16, 1 MiB) stream from L2 once per cluster
//   of two blocks: at that shape 512 blocks, 268 MB of L2 reads a forward
//   (537 MB if each block read its own).
//   Design (cv_p2p_bf16_kernel, below): x0 and then x1 of the 64 rows in
//   shared memory in the A layout of tc_gemm.cuh, both products on wgmma
//   m64n256k16 with A and B from shared memory, so the tensor cores never
//   wait on a gather and ptxas serialises nothing; each stage's group of
//   products stays in flight while the next stage's is issued
//   (tc::wait<1>); 32 KB stages (two k16 steps) in a ring of three, each
//   half copied by one block of the cluster and multicast to both.  A
//   query's running sum is carried in registers from tile to tile.
//   What held the first design (scripts/profile_torch_bf16_tc.py, NVIDIA
//   H100 80GB HBM3 at 700 W): its products' issue, each k16 step waited out
//   before the next gather (left out, they took 39% of its time with them);
//   without them it still took 61%, streaming its 537 MB of weights at
//   5.8 TB/s.
//   Its rows come from a host plan.  Tiles of whole queries leave rows
//   empty at most k (25% at k = 48, 48% at 33 and 65), and an empty row
//   still costs its products; so a block takes a run of whole queries
//   (ops/fused.py::cv_p2p_plan in clusters of two, one block an SM), their
//   rows in full tiles across query boundaries, each query's float32 sum
//   carried in registers from tile to tile in k order (the bits of a tile
//   of whole queries).  Timed against tiles of whole queries
//   (scripts/profile_torch_cv.py ablate bf16_arms, NVIDIA H100 80GB HBM3 at
//   700 W), it was faster at every k but 5 (within 3%), the divisors of 64
//   too.  What holds it (ablate bf16_no_mma, bf16_timeline): not its
//   products (without them a tile keeps 92% of its time at k = 48), but a
//   tile's CUDA-core work: of ~42k cycles, 17k to x0 and the first
//   product, 11k to x1 and the second, 13k to the WeightNet and the sums.
// - cv_agg_bf16_kernel is cv_agg_kernel with p2p in bf16: each thread's
//   cells of the ring are 8 bytes (cp.async.ca of 8), half the bytes; the
//   sums stay float32 and in the same order.  It and cv_agg_kernel share one
//   body, templated on the operand type.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_gemm.cuh"

namespace {

namespace tc = cmflow::tc;

constexpr int kC = 512;
constexpr int kH = 8;        // WeightNet hidden width
constexpr int kP2pConsumers = 256;  // two warpgroups
constexpr int kP2pThreads = kP2pConsumers + 128;  // and a producer warpgroup
constexpr int kP2pRows = 64;  // (query, neighbour) rows per block
constexpr int kSteps = kC / 8;  // k8 steps of one product
constexpr int kStageBytes = 2 * 8 * kC * 4;  // one k8 step, hi and lo
constexpr int kP2pStages = 3;
constexpr int kPackHalf = 2 * kC * kC;  // floats of each half (hi, lo)
constexpr size_t kP2pSmemBytes =
    (size_t)kP2pStages * kStageBytes + (size_t)kP2pRows * kC * 4;
// the bf16 arm: a stage is two k16 steps of all 512 columns, 16 stages a
// product
constexpr int kBf16Stage = 2 * 16 * kC * 2;
constexpr int kBf16Stages = 3;
// blocks that share each weight stage (CV_P2P_BF16_CLUSTER builds
// scripts/profile_torch_cv.py's ablation copy with another)
#ifdef CV_P2P_BF16_CLUSTER
constexpr int kBf16Cluster = CV_P2P_BF16_CLUSTER;
#else
constexpr int kBf16Cluster = 2;
#endif
constexpr int kBf16Chunks1 = kC / 32;  // stages of one product
constexpr int kC8 = kC / 8;  // 16-byte pieces (8 bf16) of a feature row
constexpr int kXTile = kP2pRows * kC * 2;  // x0 or x1 of the rows, bf16
constexpr size_t kBf16SmemBytes = (size_t)kP2pRows * kC * 4 +
                                  (size_t)kBf16Stages * kBf16Stage +
                                  (size_t)kP2pRows * kH * 4;
static_assert(2 * kXTile == kP2pRows * kC * 4, "x0 and x1 fill w * x2's");

// Build switches for scripts/profile_torch_cv.py's ablation copies of the
// full-tile arms (the package builds with none): CV_P2P_NO_MMA (the
// products left out, their operands kept live; in bf16 its shared-memory
// products), CV_P2P_X0_DIRECT (float32 x0's rows loaded into registers
// where they are used, as the whole-query arm does, not staged ahead) and
// CV_P2P_TIMELINE (block 0's thread 0 stamps its cycle counter at the
// marks of each tile into cmflow_cv_p2p_timeline's buffer).
#ifdef CV_P2P_X0_DIRECT
constexpr bool kX0Staged = false;
#else
constexpr bool kX0Staged = true;
#endif
constexpr int kX0Ahead = 3;  // the full-tile arm's x0 ring: pairs of steps
static_assert(kX0Ahead * 4 * kP2pConsumers * 16 <= kP2pRows * kC * 4,
              "the x0 ring fits in x1's buffer");
#ifdef CV_P2P_NO_MMA
constexpr bool kP2pMma = false;
#else
constexpr bool kP2pMma = true;
#endif

#ifdef CV_P2P_TIMELINE
constexpr int kStamps = 1 << 14;
__device__ long long g_stamps[kStamps];
__device__ int g_stamp_count;
// 0: a tile's start, 1: its first product done, 2: its second, 3: its sums
// stored or carried
__device__ __forceinline__ void stamp(int what) {
  if (blockIdx.x == 0 && threadIdx.x == 0 && g_stamp_count < kStamps / 2) {
    g_stamps[2 * g_stamp_count] = clock64();
    g_stamps[2 * g_stamp_count + 1] = what;
    ++g_stamp_count;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

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

struct WeightNet {  // after its first product: (b0, w1, b1, w2, b2)
  const float* b0;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
};

// a 16-byte copy from device to shared memory that the issuing thread
// waits for itself (cp.async.wait_group); `bytes` 0 writes zeros
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of the thread's copy groups are in flight
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float4 load_or_zero(const float4* p, int i) {
  return p ? __ldg(p + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void store_out(float* out, int64_t i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* out, int64_t i,
                                          float v) {
  out[i] = __float2bfloat16_rn(v);
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
    if constexpr (kP2pMma) {
      tc::mma3(part, a, st + half + 4096 * h, st + 16384 + half + 4096 * h,
               0);
    } else {  // the ablation: the operands kept live, no product
      uint32_t ops[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ops[0][i] = a.hi[i];
        ops[1][i] = a.lo[i];
      }
      tc::fence_regs(ops);
    }
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

// wpack from tc_weights.  The block is one tile of qpb = kP2pRows / k
// whole queries (k <= kP2pRows; every k that divides kP2pRows fills it).
__global__ void __launch_bounds__(kP2pThreads, 1)
    cv_p2p_kernel(const float* __restrict__ f1c,  // [B*N, kC]
                  const float* __restrict__ f2c,  // [B*N, kC]
                  const int* __restrict__ idx,    // [B*N, k]
                  const float* __restrict__ z1,   // [B*N, kH]
                  const float* __restrict__ z2,   // [B*N, kH]
                  const float* __restrict__ b0,
                  const void* __restrict__ wpack,  // tc_weights
                  const float* __restrict__ b1, const float* __restrict__ b2,
                  WeightNet wn,
                  float* __restrict__ out,  // [B*N, kC]
                  int total, int n, int k) {
  using Row4 = float4;
  constexpr int kStage = kStageBytes;
  extern __shared__ __align__(128) char smem[];
  // x1, then w * x2, in A-fragment order: step S (8 channels), then the
  // warpgroup's 128 threads, a float4 each
  float4* xbuf = reinterpret_cast<float4*>(smem + kP2pStages * kStage);
  static_assert(kC == 2 * kP2pConsumers, "two columns a thread");
  __shared__ int row_j[kP2pRows];  // neighbour row in f2c, or -1
  __shared__ int row_q[kP2pRows];  // query, or -1 for an unused row
  __shared__ __align__(8) uint64_t full[kP2pStages];
  __shared__ __align__(8) uint64_t empty[kP2pStages];
  const tc::Ring<kP2pStages, kStage> ring{smem, full, empty};

  // the block's work: qpb whole queries, qpb * k rows in one tile
  const int qpb = kP2pRows / k;
  const int rows = qpb * k;
  const int q0 = blockIdx.x * qpb;
  if (threadIdx.x < kP2pRows) {
    const int r = threadIdx.x;
    const int q = q0 + r / k;
    int j = -1, qq = -1;
    if (r < rows && q < total) {
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
      const char* w = static_cast<const char*>(wpack);
      ring.produce(w, w + kPackHalf * 4, 2 * kSteps, 1);
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
  const Row4* f14 = reinterpret_cast<const Row4*>(f1c);
  const Row4* f24 = reinterpret_cast<const Row4*>(f2c);
  const float4* b04 = reinterpret_cast<const float4*>(b0);

  const int qa = row_q[ra], qb = row_q[rb];
  const int ja = row_j[ra], jb = row_j[rb];
  const Row4* p1a = qa >= 0 ? f14 + (int64_t)qa * C4 : nullptr;
  const Row4* p1b = qb >= 0 ? f14 + (int64_t)qb * C4 : nullptr;
  const Row4* p2a = qa >= 0 && ja >= 0 ? f24 + (int64_t)ja * C4 : nullptr;
  const Row4* p2b = qb >= 0 && jb >= 0 ? f24 + (int64_t)jb * C4 : nullptr;

  // x0 = LeakyReLU(f1c[q] + f2c[j] + b0) at channels 4*c4 .. 4*c4 + 3 of
  // rows ra (xa) and rb (xb)
  auto first_layer = [&](int c4, float4& xa, float4& xb) {
    const float4 bb = __ldg(b04 + c4);
    const float4 f1a = load_or_zero(p1a, c4), f2a = load_or_zero(p2a, c4);
    const float4 f1b = load_or_zero(p1b, c4), f2b = load_or_zero(p2b, c4);
    xa = qa >= 0 ? leaky4(make_float4((f1a.x + f2a.x) + bb.x,
                                      (f1a.y + f2a.y) + bb.y,
                                      (f1a.z + f2a.z) + bb.z,
                                      (f1a.w + f2a.w) + bb.w))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    xb = qb >= 0 ? leaky4(make_float4((f1b.x + f2b.x) + bb.x,
                                      (f1b.y + f2b.y) + bb.y,
                                      (f1b.z + f2b.z) + bb.z,
                                      (f1b.w + f2b.w) + bb.w))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  {
    float part[64];
    // x1 = x0 @ W1.  Step 2c + e, position p is channel 16c + 4*(p%4) +
    // 2e + p/4, so the float4 at channels 16c + 4t holds the thread's A
    // values of steps 2c and 2c + 1.
    for (int c = 0; c < kSteps / 2; ++c) {
      float4 xa, xb;
      first_layer(4 * c + t, xa, xb);
      p2p_step(acc, part, tc::split4(xa.x, xb.x, xa.y, xb.y),
               ring.acquire(2 * c), half);
      ring.release(2 * c);
      p2p_step(acc, part, tc::split4(xa.z, xb.z, xa.w, xb.w),
               ring.acquire(2 * c + 1), half);
      ring.release(2 * c + 1);
    }

    // x1 = LeakyReLU(acc + b1) into shared memory, already in the
    // A-fragment order of the second product: acc[4j + e] is (row ra or
    // rb, column 256*wg + 8j + 2t + e%2), which step S = 32*wg + j takes
    // at positions t and t + 4.
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 256 * wg + 8 * j + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
      xbuf[(32 * wg + j) * 128 + tid] = make_float4(
          leaky(acc[4 * j] + b.x), leaky(acc[4 * j + 2] + b.x),
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

  // sum over each query's rows, k ascending; (row r, column c) lies in
  // step c/8, warp r/16, lane 4*(r%8) + (c%8)/2, float (r%16)/8 + 2*(c%2)
  const float* xs = reinterpret_cast<const float*>(xbuf);
  for (int e = threadIdx.x; e < qpb * kC; e += kP2pConsumers) {
    const int qi = e / kC, c = e % kC;
    const int q = q0 + qi;
    if (q >= total) continue;
    const int cbase = (c / 8) * 512 + ((c % 8) / 2) * 4 + 2 * (c % 2);
    float s = 0.0f;
    for (int r = qi * k; r < qi * k + k; ++r) {
      const float v =
          xs[cbase + (r / 16) * 128 + (r % 8) * 16 + (r % 16) / 8];
      s = r == qi * k ? v : s + v;
    }
    store_out(out, (int64_t)q * kC + c, s);
  }
}

// wpack from tc_weights.  The full-tile arm (ops/fused.py sends the k
// whose tile of whole queries would leave an eighth or more of its rows
// empty, and every k past kP2pRows): the block takes `qpb` consecutive
// whole queries, their rows one after the other in `tiles` tiles of
// kP2pRows rows across query boundaries (full tiles; a query's rows may run
// over several), each query's sum carried in registers from one tile to
// the next, k ascending, so its bits are those of a tile of whole queries;
// x0's rows are staged ahead by cp.async.
__global__ void __launch_bounds__(kP2pThreads, 1)
    cv_p2p_full_kernel(const float* __restrict__ f1c,  // [B*N, kC]
                       const float* __restrict__ f2c,  // [B*N, kC]
                       const int* __restrict__ idx,    // [B*N, k]
                       const float* __restrict__ z1,   // [B*N, kH]
                       const float* __restrict__ z2,   // [B*N, kH]
                       const float* __restrict__ b0,
                       const void* __restrict__ wpack,  // tc_weights
                       const float* __restrict__ b1,
                       const float* __restrict__ b2, WeightNet wn,
                       float* __restrict__ out,  // [B*N, kC]
                       int total, int n, int k, int qpb) {
  using Row4 = float4;
  constexpr int kStage = kStageBytes;
  extern __shared__ __align__(128) char smem[];
  // x1, then w * x2, in A-fragment order: step S (8 channels), then the
  // warpgroup's 128 threads, a float4 each
  float4* xbuf = reinterpret_cast<float4*>(smem + kP2pStages * kStage);
  // the sums of the query whose rows run on into the next tile, of the
  // thread's columns threadIdx.x and threadIdx.x + 256
  static_assert(kC == 2 * kP2pConsumers, "two columns a thread");
  float carry0 = 0.0f, carry1 = 0.0f;
  __shared__ int row_j[kP2pRows];  // neighbour row in f2c, or -1
  __shared__ int row_q[kP2pRows];  // query, or -1 for an unused row
  __shared__ __align__(8) uint64_t full[kP2pStages];
  __shared__ __align__(8) uint64_t empty[kP2pStages];
  const tc::Ring<kP2pStages, kStage> ring{smem, full, empty};

  // the block's work: qpb whole queries from q0 (fewer in the last block),
  // their rows in `tiles` tiles
  const int q0 = blockIdx.x * qpb;
  const int rows = min(qpb, total - q0) * k;
  const int tiles = (rows + kP2pRows - 1) / kP2pRows;
  auto set_rows = [&](int tile) {
    const int r = threadIdx.x;
    const int rg = tile * kP2pRows + r;  // row of the block's work
    const int q = q0 + rg / k;
    int j = -1, qq = -1;
    if (rg < rows && q < total) {
      qq = q;
      const int jj = idx[(int64_t)q * k + rg % k];
      if (jj >= 0 && jj < n) j = (q / n) * n + jj;
    }
    row_j[r] = j;
    row_q[r] = qq;
  };
  if (threadIdx.x < kP2pRows) set_rows(0);
  if (threadIdx.x == 0) ring.init(kP2pConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kP2pConsumers) {  // the producer warpgroup: one thread
    tc::producer_registers();
    if (threadIdx.x == kP2pConsumers) {
      const char* w = static_cast<const char*>(wpack);
      ring.produce(w, w + kPackHalf * 4, 2 * kSteps, tiles);
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
  const Row4* f14 = reinterpret_cast<const Row4*>(f1c);
  const Row4* f24 = reinterpret_cast<const Row4*>(f2c);
  const float4* b04 = reinterpret_cast<const float4*>(b0);

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile > 0) {
      tc::consumer_sync<kP2pConsumers>();  // the last tile's rows and sums
      if (threadIdx.x < kP2pRows) set_rows(tile);
      tc::consumer_sync<kP2pConsumers>();
    }
    stamp(0);
    const int c0 = tile * 2 * kSteps;
    const int qa = row_q[ra], qb = row_q[rb];
    const int ja = row_j[ra], jb = row_j[rb];
    const Row4* p1a = qa >= 0 ? f14 + (int64_t)qa * C4 : nullptr;
    const Row4* p1b = qb >= 0 ? f14 + (int64_t)qb * C4 : nullptr;
    const Row4* p2a = qa >= 0 && ja >= 0 ? f24 + (int64_t)ja * C4 : nullptr;
    const Row4* p2b = qb >= 0 && jb >= 0 ? f24 + (int64_t)jb * C4 : nullptr;

    // x0 = LeakyReLU(f1c[q] + f2c[j] + b0) at channels 4*c4 .. 4*c4 + 3 of
    // rows ra (xa) and rb (xb), from those channels of the four rows
    auto form_x0 = [&](const float4& bb, const float4& f1a, const float4& f2a,
                       const float4& f1b, const float4& f2b, float4& xa,
                       float4& xb) {
      xa = qa >= 0 ? leaky4(make_float4((f1a.x + f2a.x) + bb.x,
                                        (f1a.y + f2a.y) + bb.y,
                                        (f1a.z + f2a.z) + bb.z,
                                        (f1a.w + f2a.w) + bb.w))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      xb = qb >= 0 ? leaky4(make_float4((f1b.x + f2b.x) + bb.x,
                                        (f1b.y + f2b.y) + bb.y,
                                        (f1b.z + f2b.z) + bb.z,
                                        (f1b.w + f2b.w) + bb.w))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    };
    auto first_layer = [&](int c4, float4& xa, float4& xb) {
      const float4 bb = __ldg(b04 + c4);
      const float4 f1a = load_or_zero(p1a, c4), f2a = load_or_zero(p2a, c4);
      const float4 f1b = load_or_zero(p1b, c4), f2b = load_or_zero(p2b, c4);
      form_x0(bb, f1a, f2a, f1b, f2b, xa, xb);
    };
    // the four float4s of f1c and f2c that step pair c takes (rows
    // ra and rb, channels 16c + 4t ..) are copied kX0Ahead pairs ahead with
    // cp.async into the thread's own cells of a ring over xbuf (free until
    // x1 is stored), so no product waits on a gather (zeros for a row of
    // no query or neighbour, as load_or_zero gives)
    auto x0_cells = [&](int c) {
      return xbuf + (c % kX0Ahead) * 4 * kP2pConsumers + threadIdx.x;
    };
    auto stage_x0 = [&](int c) {
      if (c < kSteps / 2) {
        const uint32_t dst = tc::smem_addr(x0_cells(c));
        const int c4 = 4 * c + t;
        constexpr uint32_t kNext = 16 * kP2pConsumers;
        copy16(dst, (p1a ? p1a : f14) + c4, p1a ? 16 : 0);
        copy16(dst + kNext, (p2a ? p2a : f24) + c4, p2a ? 16 : 0);
        copy16(dst + 2 * kNext, (p1b ? p1b : f14) + c4, p1b ? 16 : 0);
        copy16(dst + 3 * kNext, (p2b ? p2b : f24) + c4, p2b ? 16 : 0);
      }
      copy_commit();  // an empty group past the last pair keeps the count
    };

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    {
      float part[64];
      // x1 = x0 @ W1.  Step 2c + e, position p is channel 16c + 4*(p%4) +
      // 2e + p/4, so the float4 at channels 16c + 4t holds the thread's A
      // values of steps 2c and 2c + 1.
      if constexpr (kX0Staged) {
        for (int c = 0; c + 1 < kX0Ahead; ++c) stage_x0(c);
      }
      for (int c = 0; c < kSteps / 2; ++c) {
        float4 xa, xb;
        if constexpr (kX0Staged) {
          stage_x0(c + kX0Ahead - 1);
          copy_wait<kX0Ahead - 1>();  // pair c's rows have landed
          const float4* x0 = x0_cells(c);
          form_x0(__ldg(b04 + 4 * c + t), x0[0], x0[kP2pConsumers],
                  x0[2 * kP2pConsumers], x0[3 * kP2pConsumers], xa, xb);
        } else {
          first_layer(4 * c + t, xa, xb);
        }
        p2p_step(acc, part, tc::split4(xa.x, xb.x, xa.y, xb.y),
                 ring.acquire(c0 + 2 * c), half);
        ring.release(c0 + 2 * c);
        p2p_step(acc, part, tc::split4(xa.z, xb.z, xa.w, xb.w),
                 ring.acquire(c0 + 2 * c + 1), half);
        ring.release(c0 + 2 * c + 1);
      }
      stamp(1);
      tc::consumer_sync<kP2pConsumers>();  // x1 goes over the x0 cells

      // x1 = LeakyReLU(acc + b1) into shared memory, already in the
      // A-fragment order of the second product: acc[4j + e] is (row ra or
      // rb, column 256*wg + 8j + 2t + e%2), which step S = 32*wg + j takes
      // at positions t and t + 4.
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 256 * wg + 8 * j + 2 * t;
        const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
        xbuf[(32 * wg + j) * 128 + tid] = make_float4(
            leaky(acc[4 * j] + b.x), leaky(acc[4 * j + 2] + b.x),
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
                 ring.acquire(c0 + kSteps + s), half);
        ring.release(c0 + kSteps + s);
      }
    }
    stamp(2);

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

    // sum over each query's rows in this tile, k ascending, on from the
    // running sum of the tiles before; (row r, column c) lies in step c/8,
    // warp r/16, lane 4*(r%8) + (c%8)/2, float (r%16)/8 + 2*(c%2).  The
    // queries with rows in the tile: from the one holding its first row
    // (whose sum may come carried) to the one holding its last (whose sum
    // may run on), each thread taking both its columns of each, in order.
    const float* xs = reinterpret_cast<const float*>(xbuf);
    const int qfirst = tile * kP2pRows / k;
    const int qcount =
        min(((tile + 1) * kP2pRows - 1) / k + 1, rows / k) - qfirst;
    for (int e = threadIdx.x; e < qcount * kC; e += kP2pConsumers) {
      const int qi = qfirst + e / kC, c = e % kC;
      const int q = q0 + qi;
      const int cbase = (c / 8) * 512 + ((c % 8) / 2) * 4 + 2 * (c % 2);
      // the query's rows in this tile
      const int lo = max(qi * k, tile * kP2pRows);
      const int hi = min(qi * k + k, (tile + 1) * kP2pRows);
      const bool first = c < kP2pConsumers;  // of the thread's two columns
      float s = lo == qi * k ? 0.0f : first ? carry0 : carry1;
      for (int rg = lo; rg < hi; ++rg) {
        const int r = rg - tile * kP2pRows;
        const float v =
            xs[cbase + (r / 16) * 128 + (r % 8) * 16 + (r % 16) / 8];
        s = rg == qi * k ? v : s + v;
      }
      if (hi == qi * k + k) {
        store_out(out, (int64_t)q * kC + c, s);
      } else if (first) {
        carry0 = s;
      } else {
        carry1 = s;
      }
    }
    stamp(3);
  }
}

// One 512-wide product of the bf16 arm for a warpgroup's 256 columns, into
// acc: ring chunks c0 .. c0 + 15, two k16 steps each (the warpgroup's
// columns `half` bytes into each step's B tile), A from shared memory at `a`
// (tc::kAStep bytes a step).  A stage's products are one group, issued
// before the wait for the last stage's group, which then releases it.
template <class Ring>
__device__ __forceinline__ void bf16_product(float (&acc)[128],
                                             const Ring& ring, uint32_t a,
                                             uint32_t half, int c0) {
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  for (int c = 0; c < kBf16Chunks1; ++c) {
    const uint32_t st = ring.acquire(c0 + c);
    tc::fence_regs(acc);
    tc::fence();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (kP2pMma) {
        tc::mma_bf16_ss_n256(acc, tc::desc(a + (2 * c + e) * tc::kAStep),
                             tc::desc(st + 16384 * e + half), 1);
      }
    }
    tc::commit();
    tc::wait<1>();  // the last stage's products are done
    tc::fence_regs(acc);
    if (c > 0) ring.release(c0 + c - 1);
  }
  tc::wait<0>();
  tc::fence_regs(acc);
  ring.release(c0 + kBf16Chunks1 - 1);
}

// The bf16 arm.  The block takes `qpb` consecutive whole queries, their
// rows one after the other in `tiles` tiles of kP2pRows across query
// boundaries (rows past its queries empty), both from the host's plan
// (ops/fused.py::cv_p2p_plan: one block an SM).  Every block of the grid
// runs the plan's tiles, so both blocks of a cluster take each weight
// stage.  Per tile:
// - all consumers form x0 of the 64 rows (LeakyReLU(f1c[q] + f2c[j] + b0) in
//   float32, rounded to bf16) in shared memory in the A layout of
//   tc_gemm.cuh, the loads of eight rows in flight at a time;
// - x1 = x0 @ W1 on wgmma m64n256k16 with A and B from shared memory, each
//   warpgroup on 256 of the 512 columns: a stage's two k16 steps are one
//   group of products, and the next stage's group is issued before the wait
//   for this one (tc::wait<1>), which then releases the stage before it;
// - x1 (LeakyReLU, bf16) goes to shared memory in the same A layout, and
//   x2 = x1 @ W2 runs as x1 did;
// - x2 (LeakyReLU, float32) goes to shared memory over x1, the WeightNet's
//   8-wide layers run once a row, and each thread takes two of the 512
//   columns with their last WeightNet layer in registers: w * x2 summed
//   over each query's rows in ascending k, as the float32 arm sums, on from
//   the sum carried in registers from the tiles before (a thread's columns
//   are the same in every tile), and stored, rounded to bf16, at the
//   query's last row; so any plan gives the bits of tiles of whole
//   queries.
__global__ void __launch_bounds__(kP2pThreads, 1)
    cv_p2p_bf16_kernel(
        const __nv_bfloat16* __restrict__ f1c,  // [B*N, kC]
        const __nv_bfloat16* __restrict__ f2c,  // [B*N, kC]
        const int* __restrict__ idx,            // [B*N, k]
        const float* __restrict__ z1,           // [B*N, kH]
        const float* __restrict__ z2,           // [B*N, kH]
        const float* __restrict__ b0,
        const void* __restrict__ wpack,  // tc_weights_bf16
        const float* __restrict__ b1, const float* __restrict__ b2,
        WeightNet wn,
        __nv_bfloat16* __restrict__ out,  // [B*N, kC]
        int total, int n, int k, int qpb, int tiles) {
  extern __shared__ __align__(128) char smem[];
  // x0 then x1 of the tile's rows (bf16), later x2 (float32); the ring; the
  // WeightNet's hidden layer of each row
  float4* xbuf = reinterpret_cast<float4*>(smem);
  char* ring_buf = smem + 2 * kXTile;
  float4* h_s =
      reinterpret_cast<float4*>(ring_buf + kBf16Stages * kBf16Stage);
  constexpr int kCols = kC / kP2pConsumers;
  // the sums of the query whose rows run on into the next tile, of the
  // thread's columns threadIdx.x + kP2pConsumers * i
  float carry[kCols] = {};
  __shared__ int row_j[kP2pRows];  // neighbour row in f2c, or -1
  __shared__ int row_q[kP2pRows];  // query, or -1 for an unused row
  __shared__ __align__(8) uint64_t full[kBf16Stages];
  __shared__ __align__(8) uint64_t empty[kBf16Stages];
  const tc::ClusterRing<kBf16Stages, kBf16Stage, kBf16Cluster> ring{
      ring_buf, full, empty};

  // the block's work: qpb whole queries from q0 (fewer in the last block,
  // none in a block that pads the grid to whole clusters), `rows` rows
  const int q0 = blockIdx.x * qpb;
  const int rows = max(0, min(qpb, total - q0)) * k;
  auto set_rows = [&](int tile) {
    const int r = threadIdx.x;
    const int rg = tile * kP2pRows + r;  // row of the block's work
    int j = -1, qq = -1;
    if (rg < rows) {
      qq = q0 + rg / k;
      const int jj = idx[(int64_t)qq * k + rg % k];
      if (jj >= 0 && jj < n) j = (qq / n) * n + jj;
    }
    row_j[r] = j;
    row_q[r] = qq;
  };
  if (threadIdx.x < kP2pRows) set_rows(0);
  if (threadIdx.x == 0) ring.init(kP2pConsumers / 32);
  tc::cluster_sync();  // every block's barriers are initialised

  if (threadIdx.x >= kP2pConsumers) {  // the producer warpgroup: one thread
    tc::producer_registers();
    if (threadIdx.x == kP2pConsumers) {
      ring.produce(static_cast<const char*>(wpack),
                   tiles * 2 * kBf16Chunks1, 2 * kBf16Chunks1);
    }
    return;
  }
  tc::consumer_registers();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int ra = 16 * warp + g, rb = ra + 8;
  const uint32_t half = 8192 * wg;  // the warpgroup's columns in a B step
  char* x0s = smem;
  char* x1s = smem + kXTile;
  const uint32_t x0a = tc::smem_addr(x0s), x1a = tc::smem_addr(x1s);
  const uint4* f18 = reinterpret_cast<const uint4*>(f1c);
  const uint4* f28 = reinterpret_cast<const uint4*>(f2c);
  const float4* b04 = reinterpret_cast<const float4*>(b0);

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile > 0) {
      tc::consumer_sync<kP2pConsumers>();  // the last tile's rows and sums
      if (threadIdx.x < kP2pRows) set_rows(tile);
      tc::consumer_sync<kP2pConsumers>();
    }
    stamp(0);

    // x0 of rows 8rr + rl (rr < 8), channels 8 c8 .. +7 for c8 = cq + 32m:
    // the lanes of a quarter warp hold eight rows of one piece, so their
    // 16-byte stores meet no bank twice
    {
      const int rl = threadIdx.x % 8, cq = threadIdx.x / 8;
      const uint4* p1[8];
      const uint4* p2[8];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int r = 8 * rr + rl;
        const bool valid = row_q[r] >= 0;
        p1[rr] = valid ? f18 + (int64_t)row_q[r] * kC8 : nullptr;
        p2[rr] = valid && row_j[r] >= 0 ? f28 + (int64_t)row_j[r] * kC8
                                        : nullptr;
      }
#pragma unroll 1
      for (int m = 0; m < 2; ++m) {
        const int c8 = cq + 32 * m;
        const float4 bl = __ldg(b04 + 2 * c8), bh = __ldg(b04 + 2 * c8 + 1);
        const float bb[8] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
        uint4 u1[8], u2[8];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          u1[rr] = p1[rr] ? __ldg(p1[rr] + c8) : make_uint4(0, 0, 0, 0);
          u2[rr] = p2[rr] ? __ldg(p2[rr] + c8) : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) {
          const float4 a0 =
              tc::bf16x4_to_float4(make_uint2(u1[rr].x, u1[rr].y));
          const float4 a1 =
              tc::bf16x4_to_float4(make_uint2(u1[rr].z, u1[rr].w));
          const float4 d0 =
              tc::bf16x4_to_float4(make_uint2(u2[rr].x, u2[rr].y));
          const float4 d1 =
              tc::bf16x4_to_float4(make_uint2(u2[rr].z, u2[rr].w));
          const float fa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float fb[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {  // (no sum reads a row of no query)
            v[e] = leaky((fa[e] + fb[e]) + bb[e]);
          }
          *reinterpret_cast<uint4*>(x0s + (c8 / 2) * tc::kAStep +
                                    tc::a_offset(8 * rr + rl, c8 % 2)) =
              make_uint4(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]),
                         tc::pack_bf16(v[4], v[5]), tc::pack_bf16(v[6], v[7]));
        }
      }
    }
    tc::fence_view_async();
    tc::consumer_sync<kP2pConsumers>();  // x0 is whole

    const int c0 = tile * 2 * kBf16Chunks1;
    float acc[128];
    bf16_product(acc, ring, x0a, half, c0);
    stamp(1);

    // x1 = LeakyReLU(acc + b1), rounded to bf16, into its A tiles:
    // acc[4j + e] is (row ra or rb, column 256*wg + 8j + 2t + e%2), two
    // channels of step 16*wg + j/2 at 2t of its eight 8*(j%2) ..
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 256 * wg + 8 * j + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(b1 + col));
      char* step = x1s + (16 * wg + j / 2) * tc::kAStep + 4 * t;
      *reinterpret_cast<uint32_t*>(step + tc::a_offset(ra, j % 2)) =
          tc::pack_bf16(leaky(acc[4 * j] + b.x), leaky(acc[4 * j + 1] + b.y));
      *reinterpret_cast<uint32_t*>(step + tc::a_offset(rb, j % 2)) =
          tc::pack_bf16(leaky(acc[4 * j + 2] + b.x),
                        leaky(acc[4 * j + 3] + b.y));
    }
    tc::fence_view_async();
    tc::consumer_sync<kP2pConsumers>();  // x1 is whole

    bf16_product(acc, ring, x1a, half, c0 + kBf16Chunks1);
    stamp(2);

    // the WeightNet's two 8-wide layers, once a row: h_s[r] of z2[j] - z1[q]
    if (threadIdx.x < kP2pRows) {
      const int r = threadIdx.x, q = row_q[r], j = row_j[r];
      float d[kH], h[kH];
#pragma unroll
      for (int m = 0; m < kH; ++m) {
        d[m] = (j >= 0 ? z2[(int64_t)j * kH + m] : 0.0f) -
               (q >= 0 ? z1[(int64_t)q * kH + m] : 0.0f);
      }
      weightnet_hidden(d, wn.b0, wn.w1, wn.b1, h);
      h_s[2 * r] = make_float4(h[0], h[1], h[2], h[3]);
      h_s[2 * r + 1] = make_float4(h[4], h[5], h[6], h[7]);
    }
    tc::consumer_sync<kP2pConsumers>();  // every thread has read x1
    // x2 = LeakyReLU(acc + b2) over x1, in the float32 arm's A-fragment
    // order: (row r, column c) at float (c/8)*512 + (r/16)*128 + (r%8)*16 +
    // ((c%8)/2)*4 + (r%16)/8 + 2*(c%2)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = 256 * wg + 8 * j + 2 * t;
      const float2 b = __ldg(reinterpret_cast<const float2*>(b2 + col));
      xbuf[(32 * wg + j) * 128 + tid] = make_float4(
          leaky(acc[4 * j] + b.x), leaky(acc[4 * j + 2] + b.x),
          leaky(acc[4 * j + 1] + b.y), leaky(acc[4 * j + 3] + b.y));
    }
    tc::consumer_sync<kP2pConsumers>();

    // w * x2 summed over each query's rows in this tile, k ascending, on
    // from the sum carried from the tiles before: the queries from the one
    // holding the tile's first row to the one holding its last (whose sum
    // may run on), in order; each thread's columns c = threadIdx.x +
    // kP2pConsumers * i with their last WeightNet layer in registers
    const float* xs = reinterpret_cast<const float*>(xbuf);
    float w2c[kCols][kH], wb2[kCols];
    int cbase[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int c = threadIdx.x + kP2pConsumers * i;
#pragma unroll
      for (int m = 0; m < kH; ++m) w2c[i][m] = __ldg(wn.w2 + m * kC + c);
      wb2[i] = __ldg(wn.b2 + c);
      cbase[i] = (c / 8) * 512 + ((c % 8) / 2) * 4 + 2 * (c % 2);
    }
    const int qfirst = tile * kP2pRows / k;
    const int qend = min(((tile + 1) * kP2pRows - 1) / k + 1, rows / k);
    for (int qi = qfirst; qi < qend; ++qi) {
      const int lo = max(qi * k, tile * kP2pRows);
      const int hi = min(qi * k + k, (tile + 1) * kP2pRows);
      float s[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) s[i] = carry[i];
#pragma unroll 4
      for (int rg = lo; rg < hi; ++rg) {
        const int rr = rg - tile * kP2pRows;
        const float4 ha = h_s[2 * rr], hb = h_s[2 * rr + 1];
        const float h[kH] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        const int at = (rr / 16) * 128 + (rr % 8) * 16 + (rr % 16) / 8;
#pragma unroll
        for (int i = 0; i < kCols; ++i) {
          float a = 0.0f;
#pragma unroll
          for (int m = 0; m < kH; ++m) a = fmaf(h[m], w2c[i][m], a);
          const float v = fmaxf(a + wb2[i], 0.0f) * xs[cbase[i] + at];
          s[i] = rg == qi * k ? v : s[i] + v;
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (hi == qi * k + k) {
          store_out(out, (int64_t)(q0 + qi) * kC + threadIdx.x +
                             kP2pConsumers * i, s[i]);
        } else {
          carry[i] = s[i];  // the tile's last query, on into the next
        }
      }
    }
    stamp(3);
  }
  tc::cluster_sync();  // no block of the cluster signals this one any more
}

constexpr int kAggThreads = 256;
constexpr int kAggQ = 16;   // queries of a block of the C = 512 kernels
constexpr int kAggKc = 8;   // neighbours per chunk
constexpr int kAggDepth = 2;  // queries in the ring of each thread's rows
constexpr int kAggPer = 8;  // queries a thread takes, at most
constexpr int kAggMaxPairs = 512;  // (query, neighbour) of a chunk, at most
// a thread's cell of the ring: four channels of one row, float4 or bf16
template <bool kBf16>
constexpr size_t agg_smem_bytes() {
  return (size_t)kAggDepth * kAggKc * kAggThreads * (kBf16 ? 8 : 16);
}
constexpr int kAggSlots = kAggThreads / (kC / 4);  // queries worked at once
constexpr int kAggPairs = kAggQ * kAggKc;  // (query, neighbour) of a chunk
static_assert(kAggPairs <= kAggThreads, "a thread per pair of a chunk");
static_assert(kAggQ == kAggSlots * kAggPer, "whole query slots");
static_assert(kAggKc % 4 == 0, "a chunk's rows in int4s");

// weightnet_hidden with (b0, w1, b1) in shared memory as 20 float4s
__device__ __forceinline__ void weightnet_hidden_shared(
    const float (&d)[kH], const float4* wn_s, float (&h)[kH]) {
  const float4 b0a = wn_s[0], b0b = wn_s[1];
  const float b0[kH] = {b0a.x, b0a.y, b0a.z, b0a.w,
                        b0b.x, b0b.y, b0b.z, b0b.w};
  float t[kH];
#pragma unroll
  for (int o = 0; o < kH; ++o) t[o] = 0.0f;
#pragma unroll
  for (int m = 0; m < kH; ++m) {
    const float a = fmaxf(d[m] + b0[m], 0.0f);
    const float4 wa = wn_s[2 + 2 * m], wb = wn_s[3 + 2 * m];
    const float w[kH] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int o = 0; o < kH; ++o) t[o] = fmaf(a, w[o], t[o]);
  }
  const float4 b1a = wn_s[18], b1b = wn_s[19];
  const float b1[kH] = {b1a.x, b1a.y, b1a.z, b1a.w,
                        b1b.x, b1b.y, b1b.z, b1b.w};
#pragma unroll
  for (int o = 0; o < kH; ++o) h[o] = fmaxf(t[o] + b1[o], 0.0f);
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

// the same, 8 bytes (cp.async.cg copies 16 only)
__device__ __forceinline__ void copy8(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// the same, 4 bytes
__device__ __forceinline__ void copy4(uint32_t dst, const void* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// one piece of a cell, kPart bytes, zeros where it is not `valid`: 16, 8 or
// 4 by cp.async; 2 (a bf16 row of odd C, 2-byte aligned only) by a load and
// a store, since cp.async copies no less than 4 bytes
template <int kPart>
__device__ __forceinline__ void copy_part(uint32_t dst, const char* src,
                                          bool valid) {
  if constexpr (kPart == 16) {
    copy16(dst, src, valid ? 16 : 0);
  } else if constexpr (kPart == 8) {
    copy8(dst, src, valid ? 8 : 0);
  } else if constexpr (kPart == 4) {
    copy4(dst, src, valid ? 4 : 0);
  } else {
    static_assert(kPart == 2, "a piece of 16, 8, 4 or 2 bytes");
    const unsigned short v =
        valid ? __ldg(reinterpret_cast<const unsigned short*>(src))
              : (unsigned short)0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(v) : "memory");
  }
}

// four floats from p, those from `width` on (of 4) zero
__device__ __forceinline__ float4 load4_tail(const float* p, int width) {
  return make_float4(width > 0 ? __ldg(p) : 0.0f,
                     width > 1 ? __ldg(p + 1) : 0.0f,
                     width > 2 ? __ldg(p + 2) : 0.0f,
                     width > 3 ? __ldg(p + 3) : 0.0f);
}

// A block's share of the columns: the C = 512 kernels' is the whole row in
// 16-query blocks (compiled in); the generic kernel's comes from the host's
// plan (ops/fused.py::cv_agg_plan)
struct AggChunk {
  int c;      // channels of a row
  int cells;  // cells (four channels) of a chunk; blockIdx.y is the chunk
  int per;    // queries a thread takes (its slot's, `slots` apart)
  int tiles;  // blocks of each batch element (blockIdx.x = b * tiles + t)
};

// T the element of p2p: float, or __nv_bfloat16 for the bf16 arm (a
// thread's four channels of a row one uint2).  kPart: the bytes of one copy
// into a cell, the whole cell where every row is aligned to it (always at
// C = 512), else 8, 4 or 2 bytes of it.  kFixed: the C = 512 kernels,
// their chunk, slots and queries compiled in.
template <typename T, int kPart, bool kFixed>
__device__ __forceinline__ void agg_body(const T* __restrict__ p2p,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ zq,
                                         WeightNet wn,
                                         float* __restrict__ out, int n,
                                         int k, AggChunk ch) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  using Cell = typename std::conditional<kBf16, uint2, float4>::type;
  constexpr int kCell = sizeof(Cell);
  constexpr int kParts = kCell / kPart;  // copies a cell
  constexpr int kPartCh = kPart / (int)sizeof(T);  // channels a copy
  static_assert(!kFixed || kParts == 1, "whole cells at C = 512");
  constexpr int kPairs = kFixed ? kAggPairs : kAggMaxPairs;
  const int c = kFixed ? kC : ch.c;
  const int cells = kFixed ? kC / 4 : ch.cells;
  const int slots = kFixed ? kAggSlots : kAggThreads / cells;
  const int per = kFixed ? kAggPer : ch.per;
  const int qb = slots * per;  // queries of the block
  const int64_t row_bytes = (int64_t)c * sizeof(T);
  // [kAggDepth][kAggKc][kAggThreads] cells
  extern __shared__ __align__(16) char g_raw[];
  const Cell* g_s = reinterpret_cast<const Cell*>(g_raw);
  __shared__ float4 h_s[kPairs][2];  // each pair's hidden layer
  __shared__ float4 wn_s[2 * kH / 4 + kH * kH / 4];  // b0, w1, b1
  // its neighbour's row in p2p, -1 outside [0, N)
  __shared__ __align__(16) int j_s[kPairs];
  const uint32_t ring = tc::smem_addr(g_raw) + kCell * threadIdx.x;

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)(blockIdx.x / ch.tiles) * n;
  const int i0 = (blockIdx.x % ch.tiles) * qb;
  const int slot = tid / cells;
  // the thread's cell of the row
  const int cell = (kFixed ? 0 : blockIdx.y * cells) + tid % cells;
  const int width = c - 4 * cell;  // its channels in the row, if below 4
  // a thread with a slot and a cell inside the row (all at C = 512)
  const bool mine = kFixed || (slot < slots && width > 0);
  const bool whole = kFixed || (c % 4 == 0 && width >= 4);
  if (tid < 2 * kH / 4 + kH * kH / 4) {  // read after the first barrier
    const float* src = tid < 2 ? wn.b0 + 4 * tid
                       : tid < 18 ? wn.w1 + 4 * (tid - 2)
                                  : wn.b1 + 4 * (tid - 18);
    wn_s[tid] = __ldg(reinterpret_cast<const float4*>(src));
  }
  float4 w2r[kH];
  float4 b2r;
  if (whole) {
#pragma unroll
    for (int m = 0; m < kH; ++m) {
      w2r[m] = __ldg(reinterpret_cast<const float4*>(wn.w2 + m * c +
                                                     4 * cell));
    }
    b2r = __ldg(reinterpret_cast<const float4*>(wn.b2 + 4 * cell));
  } else {
#pragma unroll
    for (int m = 0; m < kH; ++m) {
      w2r[m] = load4_tail(wn.w2 + m * c + 4 * cell, width);
    }
    b2r = load4_tail(wn.b2 + 4 * cell, width);
  }
  const char* pc =
      reinterpret_cast<const char*>(p2p) + (size_t)4 * cell * sizeof(T);
  const float4* z4 = reinterpret_cast<const float4*>(zq);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the hidden layer of pair p of the chunk from neighbour k0
  auto pair = [&](int p, int k0) {
    const int i = i0 + p / kAggKc, kk = k0 + p % kAggKc;
    int j = -1;
    float h[kH] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (i < n && kk < k) {
      const int jj = __ldg(idx + (row0 + i) * k + kk);
      const bool inside = jj >= 0 && jj < n;
      const float4 zi0 = __ldg(z4 + 2 * (row0 + i));
      const float4 zi1 = __ldg(z4 + 2 * (row0 + i) + 1);
      const float4 zj0 = inside ? __ldg(z4 + 2 * (row0 + jj)) : zero;
      const float4 zj1 = inside ? __ldg(z4 + 2 * (row0 + jj) + 1) : zero;
      const float d[kH] = {zj0.x - zi0.x, zj0.y - zi0.y, zj0.z - zi0.z,
                           zj0.w - zi0.w, zj1.x - zi1.x, zj1.y - zi1.y,
                           zj1.z - zi1.z, zj1.w - zi1.w};
      weightnet_hidden_shared(d, wn_s, h);
      if (inside) j = (int)(row0 + jj);
    }
    h_s[p][0] = make_float4(h[0], h[1], h[2], h[3]);
    h_s[p][1] = make_float4(h[4], h[5], h[6], h[7]);
    j_s[p] = j;
  };

  float4 acc[kAggPer];
#pragma unroll
  for (int s = 0; s < kAggPer; ++s) acc[s] = zero;
  for (int k0 = 0; k0 < k; k0 += kAggKc) {
    __syncthreads();  // wn_s written, the last chunk's h_s and j_s read
    if constexpr (kFixed) {  // a thread a pair
      if (tid < kAggPairs) pair(tid, k0);
    } else {
      for (int p = tid; p < qb * kAggKc; p += kAggThreads) pair(p, k0);
    }
    __syncthreads();
    // Each thread copies the p2p cells it alone will read into its own
    // cells of a ring of kAggDepth queries, kAggDepth - 1 queries ahead of
    // its sum, so that the rows stream in while it computes.
    const int kn = min(kAggKc, k - k0);
    const bool last = k0 + kAggKc >= k;
    auto fetch = [&](int s) {  // query s's rows into ring stage s % kAggDepth
      if (s < per && mine) {
        const int4* rows = reinterpret_cast<const int4*>(
            j_s + (slot + slots * s) * kAggKc);
#pragma unroll
        for (int kk = 0; kk < kAggKc; kk += 4) {
          const int4 r4 = rows[kk / 4];  // -1 past kn and past N
          const int r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t dst = ring + ((s % kAggDepth) * kAggKc + kk + e) *
                                            (kAggThreads * kCell);
            const char* src = pc + (size_t)(unsigned)max(r[e], 0) * row_bytes;
#pragma unroll
            for (int q = 0; q < kParts; ++q) {
              copy_part<kPart>(dst + q * kPart, src + q * kPart,
                               r[e] >= 0 && (kFixed || q * kPartCh < width));
            }
          }
        }
      }
      copy_commit();  // an empty group past `per` keeps the count
    };
#pragma unroll
    for (int s = 0; s + 1 < kAggDepth; ++s) fetch(s);
#pragma unroll
    for (int s = 0; s < kAggPer; ++s) {
      if (s >= per) break;  // never at C = 512
      fetch(s + kAggDepth - 1);
      copy_wait<kAggDepth - 1>();  // query s's rows have landed
      const int qi = slot + slots * s;
      // the same on every lane of a warp, but at the row's last cells
      if (!mine || i0 + qi >= n) continue;
      const Cell* g = g_s + (s % kAggDepth) * kAggKc * kAggThreads + tid;
      // no branch inside a step of 4, so that the steps' products overlap
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        const float4 ha = h_s[qi * kAggKc + kk][0];
        const float4 hb = h_s[qi * kAggKc + kk][1];
        const float h[kH] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
        float4 t = zero;
#pragma unroll
        for (int m = 0; m < kH; ++m) {
          t = fma4(make_float4(h[m], h[m], h[m], h[m]), w2r[m], t);
        }
        const float4 w = make_float4(
            fmaxf(t.x + b2r.x, 0.0f), fmaxf(t.y + b2r.y, 0.0f),
            fmaxf(t.z + b2r.z, 0.0f), fmaxf(t.w + b2r.w, 0.0f));
        float4 gv;
        if constexpr (kBf16) {
          gv = tc::bf16x4_to_float4(g[kk * kAggThreads]);
        } else {
          gv = g[kk * kAggThreads];
        }
        acc[s] = fma4(w, gv, acc[s]);
      }
      // a whole sum goes out at once, under the next query's work
      if (last) {
        float* o = out + (row0 + i0 + qi) * c + 4 * cell;
        if (whole) {
          *reinterpret_cast<float4*>(o) = acc[s];
        } else {
          const float v[4] = {acc[s].x, acc[s].y, acc[s].z, acc[s].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e < width) o[e] = v[e];
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kAggThreads, 2)
    cv_agg_kernel(const float* __restrict__ p2p,  // [B*N, kC]
                  const int* __restrict__ idx,    // [B*N, k]
                  const float* __restrict__ zq,   // [B*N, kH]
                  WeightNet wn, float* __restrict__ out, int n, int k,
                  int tiles) {
  agg_body<float, 16, true>(p2p, idx, zq, wn, out, n, k,
                            AggChunk{kC, kC / 4, kAggPer, tiles});
}

__global__ void __launch_bounds__(kAggThreads, 2)
    cv_agg_bf16_kernel(const __nv_bfloat16* __restrict__ p2p,  // [B*N, kC]
                       const int* __restrict__ idx, const float* __restrict__ zq,
                       WeightNet wn, float* __restrict__ out, int n, int k,
                       int tiles) {
  agg_body<__nv_bfloat16, 8, true>(p2p, idx, zq, wn, out, n, k,
                                   AggChunk{kC, kC / 4, kAggPer, tiles});
}

// K4b at any C (the wrapper's generic arm): p2p [B*N, C] float32 or bf16,
// copied kPart bytes at a time
template <typename T, int kPart>
__global__ void __launch_bounds__(kAggThreads, 2)
    cv_agg_any_kernel(const T* __restrict__ p2p, const int* __restrict__ idx,
                      const float* __restrict__ zq, WeightNet wn,
                      float* __restrict__ out, int n, int k, AggChunk ch) {
  agg_body<T, kPart, false>(p2p, idx, zq, wn, out, n, k, ch);
}

bool valid_p2p_shape(int b, int n, int k, int c) {
  return c == kC && n >= 1 && b >= 0 && k >= 1;
}

bool valid_agg_shape(int b, int n, int k, int c) {  // rows fit an int
  return c >= 1 && n >= 1 && b >= 0 && k >= 1 &&
         (int64_t)b * n <= 0x7fffffff;
}

WeightNet weightnet(const void* wb0, const void* ww1, const void* wb1,
                    const void* ww2, const void* wb2) {
  return WeightNet{static_cast<const float*>(wb0),
                   static_cast<const float*>(ww1),
                   static_cast<const float*>(wb1),
                   static_cast<const float*>(ww2),
                   static_cast<const float*>(wb2)};
}

template <typename T>
int launch_agg(void (*kernel)(const T*, const int*, const float*, WeightNet,
                              float*, int, int, int),
               size_t smem, const void* p2p, const void* idx, const void* zq,
               const void* wb0, const void* ww1, const void* wb1,
               const void* ww2, const void* wb2, void* out, int b, int n,
               int k, int c, void* stream) {
  if (!valid_agg_shape(b, n, k, c) || c != kC) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  const int tiles = (n + kAggQ - 1) / kAggQ;  // b * tiles <= b * n fits
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b * tiles, kAggThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p2p), static_cast<const int*>(idx),
      static_cast<const float*>(zq), weightnet(wb0, ww1, wb1, ww2, wb2),
      static_cast<float*>(out), n, k, tiles);
  return (int)cudaGetLastError();
}

template <typename T, int kPart>
int launch_agg_any(dim3 grid, AggChunk ch, const void* p2p, const void* idx,
                   const void* zq, WeightNet wn, void* out, int n, int k,
                   void* stream) {
  auto kernel = cv_agg_any_kernel<T, kPart>;
  constexpr size_t smem =
      agg_smem_bytes<std::is_same<T, __nv_bfloat16>::value>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kAggThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p2p), static_cast<const int*>(idx),
      static_cast<const float*>(zq), wn, static_cast<float*>(out), n, k, ch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f1c/f2c [B,N,512], idx [B,N,k] int32 (1 <= k <= 64; ops/fused.py sends
// the k that divide 64 here), z1/z2 [B,N,8], dense b0 [512], wpack from
// tc_weights (w1 and w2 [512,512], split and ordered for the tensor cores),
// b1 [512], b2 [512], the WeightNet after its first product wb0 [8], ww1
// [8,8], wb1 [8], ww2 [8,512], wb2 [512], out [B,N,512].  Returns a
// cudaError_t.
int cmflow_cv_p2p(const void* f1c, const void* f2c, const void* idx,
                  const void* z1, const void* z2, const void* b0,
                  const void* wpack, const void* b1, const void* b2,
                  const void* wb0, const void* ww1, const void* wb1,
                  const void* ww2, const void* wb2, void* out, int b, int n,
                  int k, int c, void* stream) {
  if (!valid_p2p_shape(b, n, k, c) || k > kP2pRows) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      cv_p2p_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kP2pSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int qpb = kP2pRows / k;
  cv_p2p_kernel<<<(total + qpb - 1) / qpb, kP2pThreads, kP2pSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1c), static_cast<const float*>(f2c),
      static_cast<const int*>(idx), static_cast<const float*>(z1),
      static_cast<const float*>(z2), static_cast<const float*>(b0), wpack,
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      weightnet(wb0, ww1, wb1, ww2, wb2), static_cast<float*>(out), total, n,
      k);
  return (int)cudaGetLastError();
}

// The full-tile arm (any k >= 1; ops/fused.py sends the k whose tile of
// whole queries would leave an eighth or more of its rows empty): the
// arguments of cmflow_cv_p2p, then the plan of ops/fused.py::cv_p2p_plan,
// `qpb` whole queries a block, their rows in full tiles of 64.  A grid of
// ceil(B*N / qpb) blocks.
int cmflow_cv_p2p_full(const void* f1c, const void* f2c, const void* idx,
                       const void* z1, const void* z2, const void* b0,
                       const void* wpack, const void* b1, const void* b2,
                       const void* wb0, const void* ww1, const void* wb1,
                       const void* ww2, const void* wb2, void* out, int b,
                       int n, int k, int c, int qpb, void* stream) {
  if (!valid_p2p_shape(b, n, k, c)) return (int)cudaErrorInvalidValue;
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  if (qpb < 1 || (int64_t)qpb * k + kP2pRows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cv_p2p_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kP2pSmemBytes);
  if (err != cudaSuccess) return (int)err;
  cv_p2p_full_kernel<<<(total + qpb - 1) / qpb, kP2pThreads, kP2pSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1c), static_cast<const float*>(f2c),
      static_cast<const int*>(idx), static_cast<const float*>(z1),
      static_cast<const float*>(z2), static_cast<const float*>(b0), wpack,
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      weightnet(wb0, ww1, wb1, ww2, wb2), static_cast<float*>(out), total, n,
      k, qpb);
  return (int)cudaGetLastError();
}

#ifdef CV_P2P_TIMELINE
// block 0's stamps of the last launch (pairs of cycle counter and mark) into
// `host`, at most n pairs; returns how many, and clears them
int cmflow_cv_p2p_timeline(long long* host, int n) {
  int count = 0;
  cudaMemcpyFromSymbol(&count, g_stamp_count, sizeof(int));
  count = count < n ? count : n;
  if (count > 0) {
    cudaMemcpyFromSymbol(host, g_stamps, 2 * sizeof(long long) * count);
  }
  const int zero = 0;
  cudaMemcpyToSymbol(g_stamp_count, &zero, sizeof(int));
  return count;
}
#endif

// The bf16 arm: f1c/f2c and out [B,N,512] bf16, idx [B,N,k] int32 (any
// k >= 1), wpack from tc_weights_bf16 (bf16), the rest as cmflow_cv_p2p;
// then the plan of ops/fused.py::cv_p2p_plan (or any other), `qpb` whole
// queries a block, their rows in `tiles` tiles of 64 a block (at least the
// most any block's rows fill).  A
// grid of ceil(B*N / qpb) blocks in clusters of kBf16Cluster (a block past
// the last query takes part in the weight stages and writes nothing).
int cmflow_cv_p2p_bf16(const void* f1c, const void* f2c, const void* idx,
                       const void* z1, const void* z2, const void* b0,
                       const void* wpack, const void* b1, const void* b2,
                       const void* wb0, const void* ww1, const void* wb1,
                       const void* ww2, const void* wb2, void* out, int b,
                       int n, int k, int c, int qpb, int tiles,
                       void* stream) {
  if (!valid_p2p_shape(b, n, k, c)) return (int)cudaErrorInvalidValue;
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  if (qpb < 1 || (int64_t)qpb * k > (int64_t)tiles * kP2pRows ||
      (int64_t)tiles * kP2pRows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      cv_p2p_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBf16SmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (total + qpb - 1) / qpb;
  return (int)tc::launch_cluster<kBf16Cluster>(
      cv_p2p_bf16_kernel,
      (blocks + kBf16Cluster - 1) / kBf16Cluster * kBf16Cluster, kP2pThreads,
      kBf16SmemBytes, stream, static_cast<const __nv_bfloat16*>(f1c),
      static_cast<const __nv_bfloat16*>(f2c), static_cast<const int*>(idx),
      static_cast<const float*>(z1), static_cast<const float*>(z2),
      static_cast<const float*>(b0), wpack, static_cast<const float*>(b1),
      static_cast<const float*>(b2), weightnet(wb0, ww1, wb1, ww2, wb2),
      static_cast<__nv_bfloat16*>(out), total, n, k, qpb, tiles);
}

// The blocks of the bf16 arm the card runs at once (its clusters of
// kBf16Cluster that fit, times that), its plan's width; a negative
// cudaError_t where the card cannot say.
int cmflow_cv_p2p_bf16_slots() {
  cudaError_t err = cudaFuncSetAttribute(
      cv_p2p_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kBf16SmemBytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBf16Cluster);
  cfg.blockDim = dim3(kP2pThreads);
  cfg.dynamicSmemBytes = kBf16SmemBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kBf16Cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, cv_p2p_bf16_kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters * kBf16Cluster;
}

// p2p [B,N,512], idx [B,N,k] int32 (k >= 1), zq [B,N,8], the WeightNet
// after its first product as above, out [B,N,512].  Returns a cudaError_t.
int cmflow_cv_agg(const void* p2p, const void* idx, const void* zq,
                  const void* wb0, const void* ww1, const void* wb1,
                  const void* ww2, const void* wb2, void* out, int b, int n,
                  int k, int c, void* stream) {
  return launch_agg(cv_agg_kernel, agg_smem_bytes<false>(), p2p, idx, zq,
                    wb0, ww1, wb1, ww2, wb2, out, b, n, k, c, stream);
}

// The bf16 arm: p2p [B,N,512] bf16, the rest (out float32) as cmflow_cv_agg.
int cmflow_cv_agg_bf16(const void* p2p, const void* idx, const void* zq,
                       const void* wb0, const void* ww1, const void* wb1,
                       const void* ww2, const void* wb2, void* out, int b,
                       int n, int k, int c, void* stream) {
  return launch_agg(cv_agg_bf16_kernel, agg_smem_bytes<true>(), p2p, idx, zq,
                    wb0, ww1, wb1, ww2, wb2, out, b, n, k, c, stream);
}

// K4b at any C >= 1 (ops/fused.py sends every C but 512 here), bf16 1 for
// the bf16 arm: the arguments of cmflow_cv_agg (p2p [B,N,C], ww2 [8,C], wb2
// [C], out [B,N,C]), then the chunk of ops/fused.py::cv_agg_plan: `cells`
// cells of four channels a block and `per` queries a thread, so 256 /
// cells * per queries a block.  A grid of B * ceil(N / that) blocks by
// ceil(ceil(C / 4) / cells) chunks.  Each cell is copied in pieces of the
// widest size that every row's start allows (p2p's address and its row
// stride, so p2p may start at any address its elements are aligned to):
// float32 16, 8 or 4 bytes, bf16 8, 4 or 2.  zq, wb0, ww1, wb1, and ww2
// and wb2 where C is a multiple of 4, are read as float4s and must be
// 16-byte aligned.
int cmflow_cv_agg_any(int bf16, const void* p2p, const void* idx,
                      const void* zq, const void* wb0, const void* ww1,
                      const void* wb1, const void* ww2, const void* wb2,
                      void* out, int b, int n, int k, int c, int cells,
                      int per, void* stream) {
  if (!valid_agg_shape(b, n, k, c) || cells < 1 || cells > kAggThreads ||
      per < 1 || per > kAggPer ||
      kAggThreads / cells * per * kAggKc > kAggMaxPairs) {
    return (int)cudaErrorInvalidValue;
  }
  const int qb = kAggThreads / cells * per;
  const int64_t tiles = (n + qb - 1) / qb;
  const int64_t chunks = ((c + 3) / 4 + cells - 1) / cells;
  if ((int64_t)b * tiles > 0x7fffffff || chunks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  const AggChunk ch{c, cells, per, (int)tiles};
  const dim3 grid((unsigned)(b * tiles), (unsigned)chunks);
  const WeightNet wn = weightnet(wb0, ww1, wb1, ww2, wb2);
  // what every row's start is aligned to: the pointer's and the stride's
  const uintptr_t at =
      reinterpret_cast<uintptr_t>(p2p) | ((uintptr_t)c * (bf16 ? 2 : 4));
  if (bf16) {
    using T = __nv_bfloat16;
    return at % 8 == 0 ? launch_agg_any<T, 8>(grid, ch, p2p, idx, zq, wn, out,
                                              n, k, stream)
           : at % 4 == 0 ? launch_agg_any<T, 4>(grid, ch, p2p, idx, zq, wn,
                                                out, n, k, stream)
           : at % 2 == 0 ? launch_agg_any<T, 2>(grid, ch, p2p, idx, zq, wn,
                                                out, n, k, stream)
                         : (int)cudaErrorInvalidValue;
  }
  return at % 16 == 0 ? launch_agg_any<float, 16>(grid, ch, p2p, idx, zq, wn,
                                                  out, n, k, stream)
         : at % 8 == 0 ? launch_agg_any<float, 8>(grid, ch, p2p, idx, zq, wn,
                                                  out, n, k, stream)
         : at % 4 == 0 ? launch_agg_any<float, 4>(grid, ch, p2p, idx, zq, wn,
                                                  out, n, k, stream)
                       : (int)cudaErrorInvalidValue;
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
