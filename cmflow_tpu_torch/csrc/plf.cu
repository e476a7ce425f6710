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
// over K closes inside the block (past K = 128, one query whose rows run
// over consecutive tiles of the block, its max carried in shared memory and
// the weights streamed once a tile): two consumer warpgroups of 64 rows each,
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
// The bf16 arm (plf_bf16_kernel) replaces the same Pallas kernel in its
// bf16 serving mode (cmflow_tpu/ops/fused.py:99-105, the chain :120-129,
// pallas_call :216): the base comes rounded to bf16, one rounding per point;
// the offset, the first affine and ReLU stay float32; x0 and x1 are rounded
// to bf16 (nearest even) before their products, which sum in float32 in the
// tensor cores (their accumulator's drift, ~5e-6 of its size, is far below
// the arm's bar of 1e-2 of the output, so nothing is promoted); the output is
// float32.  It takes any K.
// What bounds it: operations, 72.5 GFLOP at B=16, N=256, 0.073 ms at the
// dense bf16 peak (989 TFLOP/s).  The packed bf16 weights
// (ops/fused.py::tc_weights_bf16, 288 KiB) stream from L2 once a block: at
// that shape 1,920 blocks, 566 MB of L2 reads a forward.  The ring takes a
// cluster size (kBf16Cluster): in clusters of two, each stage multicast to
// both blocks, those reads halve, but the kernel ran 5% slower.
// Design (plf_bf16_kernel, below): each thread forms its A registers of a
// stage (64 channels) from gathered bf16 pairs while the tensor cores run
// the stage before, the next stage's pairs in flight, so the tensor cores
// never wait on a gather; a stage's group of products stays in flight
// while the next stage's is issued (tc::wait<1>), and the A registers of
// each group, and the accumulator, are held (tc::fence_regs) until the
// wait that covers it, so ptxas serialises nothing; 32 KB stages in a ring
// of four.  A query's running max is carried in shared memory from tile to
// tile.
// What held the first design (scripts/profile_torch_bf16_tc.py, NVIDIA H100
// 80GB HBM3 at 700 W): its products' own issue.  Left out, they took 74% of
// its time with them; its gathers 20%, its weight stream 5%.
// Its rows come from a host plan (ops/fused.py::plf_plan).  A tile of whole
// queries leaves 128 mod K rows empty (25% at K = 48, 49% at 65), and a
// query past 128 leaves its last tile part empty (37.5% at K = 160), yet an
// empty row costs a full row's products.  So a block takes a run of whole
// queries (one block an SM), their rows in full tiles across query
// boundaries.  Timed against tiles of whole queries (scripts/
// profile_torch_cv.py ablate bf16_arms, NVIDIA H100 80GB HBM3 at 700 W),
// it was faster at every K, those that fill their tiles too (a block's
// set-up, its parameters and first weight stages, once an SM).  What holds
// it (ablate bf16_no_mma, bf16_timeline): its products, as before; without
// them it keeps 31% of its time at K = 48, and of a tile's ~23k cycles
// x0 and W1 take 17k, W2 3k, the max 1k.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// the bf16 arm: tiles of kRows rows, 64 a consumer warpgroup; a stage is
// four W1 k16 steps of 256 columns, or all of W2 (16 k16 steps of 64)
constexpr int kBf16Stage = 32768;
constexpr int kBf16Stages = 4;
// blocks that share each weight stage: one (a cluster of two, multicasting
// each stage, measured slower here: scripts/profile_torch_bf16_tc.py)
constexpr int kBf16Cluster = 1;
constexpr int kBf16W1Chunks = kC1 / 64;
constexpr int kBf16Chunks = kBf16W1Chunks + 1;
static_assert(4 * 16 * kC2 * 2 == kBf16Stage, "a bf16 W1 stage");
static_assert(kC2 * kC3 * 2 == kBf16Stage, "W2 in one bf16 stage");
// dynamic shared memory of the bf16 arm: the ring, x2, the float32
// parameters (wrel, s0, b0, s1, b1, s2, b2), the running max
constexpr int kBf16X2 = kBf16Stages * kBf16Stage;
constexpr int kBf16Params = kBf16X2 + kRows * kX2Stride * 4;
constexpr int kParamFloats = 5 * kC1 + 2 * kC2 + 2 * kC3;
constexpr int kBf16Carry = kBf16Params + kParamFloats * 4;
// a running max, double-buffered (one tile reads the last tile's while it
// writes its own)
constexpr size_t kBf16SmemBytes = kBf16Carry + 2 * kC3 * 4;

// Build switches for scripts/profile_torch_cv.py's ablation copies of the
// bf16 arm (the package builds with none): PLF_BF16_NO_MMA (the
// products left out, their operands kept live) and PLF_BF16_TIMELINE
// (block 0's thread 0 stamps its cycle counter at the marks of each tile
// into cmflow_plf_bf16_timeline's buffer).
#ifdef PLF_BF16_NO_MMA
constexpr bool kBf16Mma = false;
#else
constexpr bool kBf16Mma = true;
#endif
#ifdef PLF_BF16_TIMELINE
constexpr int kStamps = 1 << 14;
__device__ long long g_stamps[kStamps];
__device__ int g_stamp_count;
// 0: a tile's start, 1: its first product done, 2: x2 stored, 3: its max
// written or carried
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

constexpr size_t smem_bytes() {
  return (size_t)kStages * kStageBytes + (size_t)kRows * kX2Stride * 4;
}

__device__ __forceinline__ float relu_affine(float x, float s, float b) {
  return fmaxf(fmaf(x, s, b), 0.0f);
}

__device__ __forceinline__ float4 load_or_zero(const float4* p, int i) {
  return p ? __ldg(p + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
  constexpr int kStage = kStageBytes;
  extern __shared__ __align__(128) char smem[];
  float* x2s = reinterpret_cast<float*>(smem + kStages * kStage);
  __shared__ int row_j[kRows];  // neighbour row in base, or -1
  __shared__ int row_q[kRows];  // query, or -1 for an unused row
  __shared__ float row_xyz[kRows][3];
  __shared__ float carry[kC3];  // a query's max over the tiles before
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const tc::Ring<kStages, kStage> ring{smem, full, empty};

  // the block's work: qpb whole queries, qpb * k rows in `tiles` tiles of
  // kRows (one tile of whole queries where k <= kRows, else one query)
  const int qpb = max(1, kRows / k);
  const int rows = qpb * k;
  const int tiles = (rows + kRows - 1) / kRows;
  const int q0 = blockIdx.x * qpb;
  auto set_rows = [&](int tile) {
    const int r = threadIdx.x;
    const int rg = tile * kRows + r;  // row of the block's work
    const int q = q0 + rg / k;
    int j = -1, qq = -1;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (rg < rows && q < total) {
      qq = q;
      const int jj = idx[(int64_t)q * k + rg % k];
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
  };
  if (threadIdx.x < kRows) set_rows(0);
  if (threadIdx.x == 0) ring.init(kConsumers / 32);
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread
    tc::producer_registers();
    if (threadIdx.x == kConsumers) {
      const char* w = reinterpret_cast<const char*>(wpack);
      ring.produce(w, w + kPackHalf * 4, kChunks1 + kChunks2, tiles);
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
  const float4* base4 = reinterpret_cast<const float4*>(base);
  const float4* wr4 = reinterpret_cast<const float4*>(wrel);
  const float4* s04 = reinterpret_cast<const float4*>(s0);
  const float4* b04 = reinterpret_cast<const float4*>(b0);

  for (int tile = 0; tile < tiles; ++tile) {
    if (tile > 0) {
      tc::consumer_sync<kConsumers>();  // the last tile's rows and x2 read
      if (threadIdx.x < kRows) set_rows(tile);
      tc::consumer_sync<kConsumers>();
    }
    const int c0 = tile * (kChunks1 + kChunks2);
    const bool va = row_q[ra] >= 0, vb = row_q[rb] >= 0;
    const float4* pa =
        va && row_j[ra] >= 0 ? base4 + (int64_t)row_j[ra] * C4 : nullptr;
    const float4* pb =
        vb && row_j[rb] >= 0 ? base4 + (int64_t)row_j[rb] * C4 : nullptr;
    const float xa = row_xyz[ra][0], ya = row_xyz[ra][1], za = row_xyz[ra][2];
    const float xb = row_xyz[rb][0], yb = row_xyz[rb][1], zb = row_xyz[rb][2];

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
    {
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
        const uint32_t st = ring.acquire(c0 + c);
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
        ring.release(c0 + c);
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
    {
      // Stage c holds k8 steps 8c .. 8c+7: their hi tiles (2 KB each), then
      // their lo tiles.  Step j, position p is channel 8j + 2*(p%4) + p/4,
      // the columns 8j + 2t (p = t) and 8j + 2t + 1 (p = t + 4) the thread
      // already holds.  Two steps at a time are summed in `part2`, then added
      // to `acc2`.
      float part2[32];
#pragma unroll
      for (int c = 0; c < kChunks2; ++c) {
        const uint32_t st = ring.acquire(c0 + kChunks1 + c);
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
        ring.release(c0 + kChunks1 + c);
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

    // max over each query's rows in this tile, k ascending, on from the
    // running max of the tiles before
    for (int e = threadIdx.x; e < qpb * kC3; e += kConsumers) {
      const int qi = e / kC3, c = e % kC3;
      const int q = q0 + qi;
      if (q >= total) continue;
      const int lo = max(qi * k, tile * kRows);
      const int hi = min(qi * k + k, (tile + 1) * kRows);
      float m = tile == 0 ? -INFINITY : carry[c];
      for (int rg = lo; rg < hi; ++rg) {
        m = fmaxf(m, x2s[(rg - tile * kRows) * kX2Stride + c]);
      }
      if (tile + 1 == tiles) {
        out[(int64_t)q * kC3 + c] = m;
      } else {
        carry[c] = m;
      }
    }
  }
}

// The bf16 arms' parameters into shared memory (wrel [3][kC1], s0, b0
// [kC1], s1, b1 [kC2], s2, b2 [kC3]), by every thread, before the block's
// first barrier.
__device__ __forceinline__ void load_params(
    float* params, const float* __restrict__ wrel,
    const float* __restrict__ s0, const float* __restrict__ b0,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const float* __restrict__ s2, const float* __restrict__ b2) {
  for (int i = threadIdx.x; i < kParamFloats / 4; i += kThreads) {
    const float* const srcs[7] = {wrel, s0, b0, s1, b1, s2, b2};
    const int ends[7] = {3 * kC1, 4 * kC1, 5 * kC1, 5 * kC1 + kC2,
                         5 * kC1 + 2 * kC2, 5 * kC1 + 2 * kC2 + kC3,
                         kParamFloats};
    int a = 0, from = 0;
#pragma unroll
    for (int u = 0; u < 6; ++u) {
      if (4 * i >= ends[u]) {
        a = u + 1;
        from = ends[u];
      }
    }
    reinterpret_cast<float4*>(params)[i] =
        __ldg(reinterpret_cast<const float4*>(srcs[a] + 4 * i - from));
  }
}

// One tile of the bf16 arms, by the consumer threads: the rows row_j,
// row_q, row_xyz (a row of no query forms values that no max reads) through
// the chain into x2s, ring chunks c0 .. c0 + kBf16Chunks - 1.  Each
// consumer warpgroup takes 64 rows:
// - x1 = x0 @ W1 on wgmma m64n256k16 with A in registers and B from the
//   ring, a stage (64 channels, four k16 steps) at a time: each thread
//   forms its A of a stage (the gathered bf16 pairs, offset, affine and
//   ReLU in float32, rounded to bf16) while the tensor cores run the stage
//   before, and loads the next stage's pairs once the stage's products are
//   issued; a stage's group of products is waited for (tc::wait<1>) only
//   once the next one is issued, and then releases its stage, its A
//   registers held until that wait (tc::fence_regs);
// - x1 (affine, ReLU, bf16) becomes the A registers of all 16 k16 steps of
//   W2 before its products start (m64n64k16, one group);
// - x2 (affine, ReLU) goes to shared memory, and a barrier closes it.
template <class Ring>
__device__ __forceinline__ void bf16_tile(
    const Ring& ring, int c0, const float* params,
    const __nv_bfloat16* __restrict__ base, const int (&row_j)[kRows],
    const int (&row_q)[kRows], const float (&row_xyz)[kRows][3],
    float* x2s) {
  const float* s1s = params + 5 * kC1;
  const float* b1s = s1s + kC2;
  const float* s2s = b1s + kC2;
  const float* b2s = s2s + kC3;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;
  // the thread's rows ra, rb of the warpgroup's 64 (tc_gemm.cuh, fragment
  // layouts); in W1's K order (ops/fused.py::tc_weights_bf16 with
  // from_rows) its A values of k16 step s are channels 16s + 4t .. +3 of
  // both rows, one 8-byte load each
  const int ra = 64 * wg + 16 * warp + g, rb = ra + 8;
  const uint2* base4 = reinterpret_cast<const uint2*>(base);
  const float4* params4 = reinterpret_cast<const float4*>(params);

  const int rows2[2] = {ra, rb};
  const uint2* prow[2];
  float rx[2], ry[2], rz[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows2[h], j = row_j[r];
    prow[h] = j >= 0 ? base4 + (int64_t)j * (kC1 / 4) : nullptr;
    rx[h] = row_xyz[r][0];
    ry[h] = row_xyz[r][1];
    rz[h] = row_xyz[r][2];
  }
  const bool same_query = row_q[ra] == row_q[rb];
  // a stage's gathered channels 64c + 16e + 4t .. +3 of both rows
  auto gather = [&](int cc, uint2 (&gp)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gp[h][e] = prow[h] ? __ldg(prow[h] + 16 * cc + 4 * e + t)
                           : make_uint2(0, 0);
      }
    }
  };
  uint2 gp[2][4];  // the next stage's
  gather(0, gp);

  // x1 = x0 @ W1 on wgmma m64n256k16, A in registers: stage c holds k16
  // steps 4c .. 4c+3, 8 KB each.  x0 of a stage is formed from its
  // gathered channels (offset, affine and ReLU in float32, rounded to
  // bf16) while the tensor cores run the stage before; the next stage's
  // channels are loaded once this stage's products are issued
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  uint32_t a[2][4][4];  // the A of two stages: [stage % 2][step][reg]
#pragma unroll 2
  for (int c = 0; c < kBf16W1Chunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c4 = 16 * c + 4 * e + t;  // channels 4 c4 .. +3
      const float4 w0 = params4[c4], w1 = params4[kC1 / 4 + c4],
                   w2 = params4[kC1 / 2 + c4],
                   sc = params4[3 * kC1 / 4 + c4], bi = params4[kC1 + c4];
      const float r0[4] = {w0.x, w0.y, w0.z, w0.w};
      const float r1[4] = {w1.x, w1.y, w1.z, w1.w};
      const float r2[4] = {w2.x, w2.y, w2.z, w2.w};
      const float ss[4] = {sc.x, sc.y, sc.z, sc.w};
      const float bb[4] = {bi.x, bi.y, bi.z, bi.w};
      float v[2][4];
      const float4 ga = tc::bf16x4_to_float4(gp[0][e]);
      const float4 gb = tc::bf16x4_to_float4(gp[1][e]);
      const float g4[2][4] = {{ga.x, ga.y, ga.z, ga.w},
                              {gb.x, gb.y, gb.z, gb.w}};
      if (same_query) {  // one offset for both rows
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float off =
              fmaf(rz[0], r2[u], fmaf(ry[0], r1[u], rx[0] * r0[u]));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            v[h][u] = relu_affine(g4[h][u] - off, ss[u], bb[u]);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float off =
                fmaf(rz[h], r2[u], fmaf(ry[h], r1[u], rx[h] * r0[u]));
            v[h][u] = relu_affine(g4[h][u] - off, ss[u], bb[u]);
          }
        }
      }
      a[c % 2][e][0] = tc::pack_bf16(v[0][0], v[0][1]);
      a[c % 2][e][1] = tc::pack_bf16(v[1][0], v[1][1]);
      a[c % 2][e][2] = tc::pack_bf16(v[0][2], v[0][3]);
      a[c % 2][e][3] = tc::pack_bf16(v[1][2], v[1][3]);
    }
    const uint32_t st = ring.acquire(c0 + c);
    tc::fence_regs(acc);
    tc::fence();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kBf16Mma) {
        tc::mma_bf16_n256(acc, a[c % 2][e], tc::desc(st + 8192 * e), 1);
      }
    }
    tc::commit();
    if (c + 1 < kBf16W1Chunks) gather(c + 1, gp);
    tc::wait<1>();  // the last stage's products are done
    tc::fence_regs(acc);
    tc::fence_regs(a[(c + 1) % 2]);  // their A, now free
    if (c > 0) ring.release(c0 + c - 1);
  }
  tc::wait<0>();
  tc::fence_regs(acc);
  tc::fence_regs(a[(kBf16W1Chunks - 1) % 2]);
  ring.release(c0 + kBf16W1Chunks - 1);
  stamp(1);

  // x1 = ReLU(acc * s1 + b1) in bf16 as the A registers of W2's k16 steps:
  // acc[8s .. 8s+7] are columns 16s + 2t, +1 and 16s + 8 + 2t, +1 of rows
  // g and g + 8 (tc_gemm.cuh)
  uint32_t a2[kC2 / 16][4];
#pragma unroll
  for (int s = 0; s < kC2 / 16; ++s) {
    const int col = 16 * s + 2 * t;
    const float2 sa = *reinterpret_cast<const float2*>(s1s + col);
    const float2 ba = *reinterpret_cast<const float2*>(b1s + col);
    const float2 sb = *reinterpret_cast<const float2*>(s1s + col + 8);
    const float2 bb = *reinterpret_cast<const float2*>(b1s + col + 8);
    a2[s][0] = tc::pack_bf16(relu_affine(acc[8 * s], sa.x, ba.x),
                             relu_affine(acc[8 * s + 1], sa.y, ba.y));
    a2[s][1] = tc::pack_bf16(relu_affine(acc[8 * s + 2], sa.x, ba.x),
                             relu_affine(acc[8 * s + 3], sa.y, ba.y));
    a2[s][2] = tc::pack_bf16(relu_affine(acc[8 * s + 4], sb.x, bb.x),
                             relu_affine(acc[8 * s + 5], sb.y, bb.y));
    a2[s][3] = tc::pack_bf16(relu_affine(acc[8 * s + 6], sb.x, bb.x),
                             relu_affine(acc[8 * s + 7], sb.y, bb.y));
  }

  // x2 = x1 @ W2: one stage, k16 step s 2 KB at 2048 s
  float acc2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc2[i] = 0.0f;
  {
    const uint32_t st = ring.acquire(c0 + kBf16W1Chunks);
    tc::fence_regs(acc2);
    tc::fence();
    if constexpr (kBf16Mma) {
#pragma unroll
      for (int s = 0; s < kC2 / 16; ++s) {
        tc::mma_bf16_n64(acc2, a2[s], tc::desc(st + 2048 * s), 1);
      }
    } else {  // the ablation: the operands kept live, no product
      tc::fence_regs(a2);
    }
    tc::commit();
    tc::wait<0>();
    tc::fence_regs(acc2);
    ring.release(c0 + kBf16W1Chunks);
  }

  // x2 = ReLU(acc2 * s2 + b2) into shared memory
#pragma unroll
  for (int j = 0; j < kC3 / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(s2s + col);
    const float2 b = *reinterpret_cast<const float2*>(b2s + col);
    *reinterpret_cast<float2*>(x2s + ra * kX2Stride + col) =
        make_float2(relu_affine(acc2[4 * j], s.x, b.x),
                    relu_affine(acc2[4 * j + 1], s.y, b.y));
    *reinterpret_cast<float2*>(x2s + rb * kX2Stride + col) =
        make_float2(relu_affine(acc2[4 * j + 2], s.x, b.x),
                    relu_affine(acc2[4 * j + 3], s.y, b.y));
  }
  tc::consumer_sync<kConsumers>();
  stamp(2);
}

// The bf16 arm.  The block takes `qpb` consecutive whole queries, their
// rows one after the other in `tiles` tiles of kRows across query
// boundaries (rows past its queries empty), both from the host's plan
// (ops/fused.py::plf_plan: one block an SM).  Every block of the grid runs
// the plan's tiles, so the blocks of a cluster take the same weight
// stages.
// Each tile is bf16_tile's; the max over a query's rows in a tile goes on
// from the running max of the tiles before, and only the query that runs
// on past a tile's end carries one, a row of kC3 floats in shared memory,
// double-buffered (tile t writes row t % 2, tile t + 1 reads it).  A float
// max is exact, so any plan gives the bits of tiles of whole queries.
__global__ void __launch_bounds__(kThreads, 1)
    plf_bf16_kernel(const __nv_bfloat16* __restrict__ base,  // [B*N, kC1]
                    const int* __restrict__ idx,             // [B*N, k]
                    const float* __restrict__ xyz,  // [B*N, 3], centred
                    const float* __restrict__ wrel,  // [3, kC1]
                    const float* __restrict__ s0, const float* __restrict__ b0,
                    const __nv_bfloat16* __restrict__ wpack,  // tc_weights_bf16
                    const float* __restrict__ s1, const float* __restrict__ b1,
                    const float* __restrict__ s2, const float* __restrict__ b2,
                    float* __restrict__ out,  // [B*N, kC3]
                    int total, int n, int k, int qpb, int tiles) {
  extern __shared__ __align__(128) char smem[];
  float* x2s = reinterpret_cast<float*>(smem + kBf16X2);
  float* params = reinterpret_cast<float*>(smem + kBf16Params);
  float* carry = reinterpret_cast<float*>(smem + kBf16Carry);
  __shared__ int row_j[kRows];  // neighbour row in base, or -1
  __shared__ int row_q[kRows];  // query, or -1 for an unused row
  __shared__ float row_xyz[kRows][3];  // the query's point, or 0
  __shared__ __align__(8) uint64_t full[kBf16Stages];
  __shared__ __align__(8) uint64_t empty[kBf16Stages];
  const tc::ClusterRing<kBf16Stages, kBf16Stage, kBf16Cluster> ring{
      smem, full, empty};

  // the block's work: qpb whole queries from q0 (fewer in the last block,
  // none in a block that pads the grid to whole clusters), `rows` rows
  const int q0 = blockIdx.x * qpb;
  const int rows = max(0, min(qpb, total - q0)) * k;
  load_params(params, wrel, s0, b0, s1, b1, s2, b2);
  // the tile's rows: (query, neighbour row in base), or -1
  auto set_rows = [&](int tile) {
    const int r = threadIdx.x;
    const int rg = tile * kRows + r;  // row of the block's work
    int j = -1, qq = -1;
    if (rg < rows) {
      qq = q0 + rg / k;
      const int jj = idx[(int64_t)qq * k + rg % k];
      if (jj >= 0 && jj < n) j = (qq / n) * n + jj;
    }
    row_j[r] = j;
    row_q[r] = qq;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      row_xyz[r][a] = qq >= 0 ? __ldg(xyz + (int64_t)qq * 3 + a) : 0.0f;
    }
  };
  if (threadIdx.x < kRows) set_rows(0);
  if (threadIdx.x == 0) ring.init(kConsumers / 32);
  tc::cluster_sync();  // every block's barriers are initialised

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread
    tc::producer_registers();
    if (threadIdx.x == kConsumers) {
      ring.produce(reinterpret_cast<const char*>(wpack), tiles * kBf16Chunks,
                   kBf16Chunks);
    }
    return;
  }
  tc::consumer_registers();

  const int tid = threadIdx.x;
  for (int tile = 0; tile < tiles; ++tile) {
    if (tile > 0) {
      tc::consumer_sync<kConsumers>();  // the last tile's rows and x2 read
      if (tid < kRows) set_rows(tile);
      tc::consumer_sync<kConsumers>();
    }
    stamp(0);
    bf16_tile(ring, tile * kBf16Chunks, params, base, row_j, row_q, row_xyz,
              x2s);

    // max over each query's rows in this tile, k ascending: the queries
    // from the one holding the tile's first row (whose max may come
    // carried) to the one holding its last (whose max may run on)
    const int qfirst = tile * kRows / k;
    const int qcount =
        min(((tile + 1) * kRows - 1) / k + 1, rows / k) - qfirst;
    const float* carried = carry + kC3 * ((tile + 1) % 2);
    float* carries = carry + kC3 * (tile % 2);
    for (int e = tid; e < qcount * kC3; e += kConsumers) {
      const int qi = qfirst + e / kC3, c = e % kC3;
      const int lo = max(qi * k, tile * kRows);
      const int hi = min(qi * k + k, (tile + 1) * kRows);
      float m = lo == qi * k ? -INFINITY : carried[c];
#pragma unroll 4
      for (int rg = lo; rg < hi; ++rg) {
        m = fmaxf(m, x2s[(rg - tile * kRows) * kX2Stride + c]);
      }
      if (hi == qi * k + k) {
        out[(int64_t)(q0 + qi) * kC3 + c] = m;
      } else {
        carries[c] = m;
      }
    }
    stamp(3);
  }
  tc::cluster_sync();  // no block of the cluster signals this one any more
}

int check_shape(int n, int k, int c1) {
  return c1 != kC1 || k < 1 || n < 1 ? (int)cudaErrorInvalidValue
                                     : (int)cudaSuccess;
}

}  // namespace

extern "C" {

// base [B,N,512] f32, idx [B,N,k] int32 (any k >= 1), xyz [B,N,3]
// centred, wrel [3,512], s0/b0 [512], wpack from tc_weights (W1 [512,256]
// and W2 [256,64], split and ordered for the tensor cores), s1/b1 [256],
// s2/b2 [64], out [B,N,64]; c1 must be 512.  Returns a cudaError_t.
int cmflow_plf(const void* base, const void* idx, const void* xyz,
               const void* wrel, const void* s0, const void* b0,
               const void* wpack, const void* s1, const void* b1,
               const void* s2, const void* b2, void* out, int b, int n, int k,
               int c1, void* stream) {
  if (check_shape(n, k, c1)) return (int)cudaErrorInvalidValue;
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      plf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qpb = k < kRows ? kRows / k : 1;
  const int blocks = (total + qpb - 1) / qpb;
  plf_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(base), static_cast<const int*>(idx),
      static_cast<const float*>(xyz), static_cast<const float*>(wrel),
      static_cast<const float*>(s0), static_cast<const float*>(b0),
      static_cast<const float*>(wpack), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<float*>(out), total, n, k);
  return (int)cudaGetLastError();
}

// The bf16 arm: base [B,N,512] bf16, idx [B,N,k] int32 (any k >= 1), wrel
// [3,512] f32 (the bf16-rounded values), wpack from tc_weights_bf16 (bf16),
// the rest as cmflow_plf; then the plan of ops/fused.py::plf_plan (or
// any other), `qpb` whole queries a block, their rows in `tiles` tiles of
// 128 a block (at least the most any block's rows fill).  A grid of ceil(B*N / qpb) blocks
// in clusters of kBf16Cluster (a block past the last query takes part in
// the weight stages and writes nothing).
int cmflow_plf_bf16(const void* base, const void* idx, const void* xyz,
                    const void* wrel, const void* s0, const void* b0,
                    const void* wpack, const void* s1, const void* b1,
                    const void* s2, const void* b2, void* out, int b, int n,
                    int k, int c1, int qpb, int tiles, void* stream) {
  if (check_shape(n, k, c1)) return (int)cudaErrorInvalidValue;
  const int total = b * n;
  if (total == 0) return (int)cudaSuccess;
  if (qpb < 1 || (int64_t)qpb * k > (int64_t)tiles * kRows ||
      (int64_t)tiles * kRows > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = kBf16SmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      plf_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (total + qpb - 1) / qpb;
  return (int)tc::launch_cluster<kBf16Cluster>(
      plf_bf16_kernel,
      (blocks + kBf16Cluster - 1) / kBf16Cluster * kBf16Cluster, kThreads,
      smem, stream, static_cast<const __nv_bfloat16*>(base),
      static_cast<const int*>(idx), static_cast<const float*>(xyz),
      static_cast<const float*>(wrel), static_cast<const float*>(s0),
      static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(wpack),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<float*>(out), total, n, k, qpb, tiles);
}

#ifdef PLF_BF16_TIMELINE
// block 0's stamps of the last launch (pairs of cycle counter and mark) into
// `host`, at most n pairs; returns how many, and clears them
int cmflow_plf_bf16_timeline(long long* host, int n) {
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

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
