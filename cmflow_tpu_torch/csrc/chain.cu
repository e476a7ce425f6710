// The width-generic arms of the fused serving kernels, for Hopper (sm_90a):
// every shape the tuned kernels (mse.cu, plf.cu, cost_volume.cu) are not
// written for.
//
// Replaces, at any widths, the Pallas TPU kernels of
// cmflow_tpu/ops/fused.py: _mse_kernel (K3, called by
// fused_multi_scale_encoder) and _plf_kernel (K5, fused_point_local_feature)
// as Kind kMax, and _cv_kernel (K4a, called by fused_cost_volume) as kP2p.
// (K4b's _cv_agg_kernel has no product: its arm at any width is
// cost_volume.cu::cv_agg_any_kernel.)  For each query i and each of its K
// neighbours j = idx[i, k] (one row per pair):
//   kMax: x0 = ReLU((base[j] - xyz_c[i] @ wrel) * s0 + b0)
//         x_{l+1} = ReLU((x_l @ W_l) * s_l + b_l), L >= 0 layers
//         out[i] = max over k of x_L
//   kP2p: x0 = LeakyReLU(f1c[i] + f2c[j] + b0)
//         x_{l+1} = LeakyReLU(x_l @ W_l + b_l), L >= 1 layers
//         out[i] = sum over k of WeightNet(z2[j] - z1[i]) * x_L
// with the WeightNet after its first product, (d + b0) -> ReLU -> 8x8 ->
// ReLU -> 8xC -> ReLU, its hidden width 8 fixed as in the JAX package.
// K3's route folds each scale's first layer into a base outside (as the JAX
// package's make_mse_base does) and launches this kernel once a scale.  A
// neighbour index outside [0, N) stands for a zero row.
//
// bf16 (T = __nv_bfloat16, the JAX kernels' bf16 serving mode): the base,
// f1c/f2c and the Dense weights come in bf16; the offset, the affines
// and the WeightNet stay float32; each activation is rounded to bf16
// (nearest even) before the product it feeds, a product of two bf16 values
// is exact and the sums are float32 (ops/fused.py::_mm); kP2p stores its sum
// rounded to bf16 once.
//
// Two kernels.
//
// chain_tc_kernel (kMax and kP2p with at least one layer: every chain that
// has a product).  What bounds it: operations, 2 * rows * sum(cin * cout)
// (and 16 + 2 * C a row for kP2p's WeightNet), on the tensor cores: wgmma
// m64nNk16 .bf16 in the bf16 arm, m64nNk8 .tf32 in 3xTF32 in the float32
// arm (tc_gemm.cuh: the weights split into TF32 hi and lo parts by the
// packer, the activations in registers; each stage's two k8 steps summed in
// the tensor cores from zero and added into the float32 sum on the CUDA
// cores, tc::promote, which keeps 1e-5 of the magnitude over wide sums).
// Design:
// - A block is one warpgroup (64 rows), 128 threads, so two blocks an SM
//   keep up to 255 registers a thread (the bf16 arm's 128 accumulators
//   among them).  Its work item is 64 / P whole queries, P the power of two
//   at or above K (a query's rows P apart, those past K masked), or above K
//   = 64 one query whose rows run over consecutive tiles, its max or sum
//   carried.  Blocks are persistent (grid and iterations from the host's
//   plan) and run in clusters of two.
// - Each layer's weights come packed (ops/fused.py::chain_tc_weights) as a
//   sequence of 16 KB stages in the order the block uses them: per block of
//   output columns (128 in float32, 256 in bf16), two k steps a stage (k8:
//   TF32 hi tiles, then lo tiles; or k16).  A block pass is compiled for
//   its width (N = 64 .. 256: one wgmma a k step, with_width), so no branch
//   sits between its products.  Rows and columns are zero-padded (columns
//   to a multiple of 64), so padded channels stay zero through the
//   activations (their affines and biases are padded with 0).  They stream
//   through a ring of three stages with cp.async.bulk, each stage multicast
//   to both blocks of the cluster (each weight byte read from L2 serves 128
//   rows): thread 0 issues stage c + 2 while stage c's products run, as
//   soon as both blocks have released its buffer (fill_ring, testing
//   without waiting).
// - Every product takes its A from registers, in the K order of a float4
//   of a row (two k8 steps, float32) or four bf16 (a k16 step), as plf.cu's
//   first product does: x0 is formed there from the gathered rows (offset,
//   affine, activation; one 8-byte load a row and step where the rows are
//   aligned), the next stage's rows loaded while this stage's products
//   run, and never stored; a middle activation is stored once, in the next
//   product's dtype, into a [64][width + 16] buffer in shared memory or,
//   where the host's plan says it does not fit (or would leave fewer than
//   two blocks an SM), in device scratch.  A warp reads and writes only its
//   own 16 rows, so layers meet at a warp barrier.
// - The last layer is reduced in the epilogue from the accumulators: each
//   thread's two rows, then across the rows of a query in its warp by
//   shuffles (masked rows -inf or 0), across warps through shared memory
//   where a query spans several, and across tiles through a carry.  kP2p's
//   WeightNet hidden layer is computed once a row; its last layer at each
//   accumulator.  No atomics: two launches give the same bits.
// - The layer table (widths and parameter offsets) is a device array, so a
//   chain may be of any depth.
// What holds it (scripts/profile_torch_chain.py, NVIDIA H100 80GB HBM3 at
// 700 W, config B): each stage's fixed work on the CUDA cores (its wait,
// the refill, the release, forming A, asking for the next rows), about
// 2,900 cycles a 16 KB stage against ~250 of tensor-core time at peak, of
// which two blocks an SM overlap part.

// chain_kernel (kMax with no layer: nothing to multiply).  What bounds it:
// the gathered bytes (B*N*K rows of C), read from L2.  A block of 256
// threads takes a tile of 32 rows made of whole queries, or one query whose
// rows run over consecutive tiles, its max carried in shared memory; each
// (query, column) is reduced by one thread, k ascending, x0 formed as it is
// read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tc_gemm.cuh"

namespace {

namespace tc = cmflow::tc;

enum Kind { kMax = 0, kP2p = 1 };
constexpr int kH = 8;  // WeightNet hidden width
constexpr int kMaxSmem = 232448;  // a block's shared memory (opt-in)

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float leaky(float x) {
  return x > 0.0f ? x : 0.1f * x;
}

__device__ __forceinline__ float relu_affine(float x, float s, float b) {
  return fmaxf(fmaf(x, s, b), 0.0f);
}

// the WeightNet's two 8-wide layers: h = ReLU(ReLU(d + b0) @ w1 + b1)
__device__ __forceinline__ void weightnet_hidden(const float (&d)[kH],
                                                 const float* wb0,
                                                 const float* ww1,
                                                 const float* wb1,
                                                 float (&h)[kH]) {
  float a[kH];
#pragma unroll
  for (int m = 0; m < kH; ++m) a[m] = fmaxf(d[m] + __ldg(wb0 + m), 0.0f);
#pragma unroll
  for (int o = 0; o < kH; ++o) {
    float t = 0.0f;
#pragma unroll
    for (int m = 0; m < kH; ++m) t = fmaf(a[m], __ldg(ww1 + m * kH + o), t);
    h[o] = fmaxf(t + __ldg(wb1 + o), 0.0f);
  }
}

// ===========================================================================
// chain_kernel: kMax with no layer
// ===========================================================================

constexpr int kThreads = 256;
constexpr int kRows = 32;

struct Params {
  const int* idx;  // [B*N, k]
  int n, k;
  int64_t total;
  const void* src;      // the base, [B*N, src_stride]
  int64_t src_stride;
  const float* xyz;     // centred points [B*N, 3]
  const float* wrel;    // [3, c0]
  const float* s0;      // the affine's scale
  const float* b0;      // its bias
  int c0;
  float* out;           // [B*N, out_stride]
  int64_t out_stride;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float carry[];  // [c0], across tiles
  __shared__ int row_q[kRows];      // the row's query, or -1
  __shared__ int64_t row_j[kRows];  // its neighbour's row, or -1
  __shared__ float row_v[kRows][3];  // the query's point

  const int tid = threadIdx.x;
  const int k = p.k;
  const int qpt = k <= kRows ? kRows / k : 1;  // whole queries of a tile
  const int rows = qpt * k;
  const int tiles = (rows + kRows - 1) / kRows;
  const int64_t works = (p.total + qpt - 1) / qpt;
  const T* src = static_cast<const T*>(p.src);

  for (int64_t wk = blockIdx.x; wk < works; wk += gridDim.x) {
    const int64_t q0 = wk * qpt;
    for (int tile = 0; tile < tiles; ++tile) {
      __syncthreads();  // the last tile's rows and carry read
      if (tid < kRows) {
        const int rg = tile * kRows + tid;  // row of the work item
        const int64_t q = q0 + rg / k;
        int qq = -1;
        int64_t j = -1;
        if (rg < rows && q < p.total) {
          qq = (int)(q - q0);
          const int jj = __ldg(p.idx + q * k + rg % k);
          if (jj >= 0 && jj < p.n) j = (q / p.n) * p.n + jj;
        }
        row_q[tid] = qq;
        row_j[tid] = j;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          row_v[tid][a] = qq >= 0 ? __ldg(p.xyz + q * 3 + a) : 0.0f;
        }
      }
      __syncthreads();

      // each (query, column) of the tile: its rows' max, k ascending, on
      // from the carry of the tiles before
      for (int e = tid; e < qpt * p.c0; e += kThreads) {
        const int qi = e / p.c0, c = e % p.c0;
        const int64_t q = q0 + qi;
        if (q >= p.total) continue;
        const int lo = max(qi * k, tile * kRows);
        const int hi = min(qi * k + k, (tile + 1) * kRows);
        const float w0 = __ldg(p.wrel + c), w1 = __ldg(p.wrel + p.c0 + c),
                    w2 = __ldg(p.wrel + 2 * p.c0 + c);
        const float s0 = __ldg(p.s0 + c), b0 = __ldg(p.b0 + c);
        float m = tile == 0 ? -INFINITY : carry[c];
        for (int rg = lo; rg < hi; ++rg) {
          const int r = rg - tile * kRows;
          const int64_t j = row_j[r];
          const float g = j >= 0 ? load(src, j * p.src_stride + c) : 0.0f;
          const float off =
              fmaf(row_v[r][2], w2, fmaf(row_v[r][1], w1, row_v[r][0] * w0));
          m = fmaxf(m, relu_affine(g - off, s0, b0));
        }
        if (tile + 1 == tiles) {
          p.out[q * p.out_stride + c] = m;
        } else {
          carry[c] = m;
        }
      }
    }
  }
}

template <typename T>
int launch(const Params& p, void* stream) {
  auto kernel = chain_kernel<T>;
  const int smem = 4 * ((p.c0 + 3) & ~3);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int qpt = p.k <= kRows ? kRows / p.k : 1;
  const int64_t works = (p.total + qpt - 1) / qpt;
  const unsigned grid = (unsigned)(works < 0x7fffffff ? works : 0x7fffffff);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ===========================================================================
// chain_tc_kernel: kMax and kP2p on the tensor cores
// ===========================================================================

constexpr int kTcRows = 64;  // a tile: one warpgroup's M
constexpr int kTcThreads = 128;  // one warpgroup; its thread 0 fills the ring
constexpr int kTcStage = 16384;  // bytes of a weight stage
constexpr int kTcStages = 3;
// Build switches for scripts/profile_torch_chain.py's ablation copies (the
// package builds with none): the cluster size, CHAIN_TC_NO_MMA (the
// products left out, their operands kept live) and CHAIN_TC_TIMELINE
// (block 0's thread 0 stamps its cycle counter around each stage's wait,
// issue and release into cmflow_chain_tc_timeline's buffer).
#ifndef CHAIN_TC_CLUSTER
#define CHAIN_TC_CLUSTER 2
#endif
constexpr int kTcCluster = CHAIN_TC_CLUSTER;
// blocks an SM its registers allow (the launch bound: 8 warps an SM, two a
// scheduler, up to 255 registers a thread; a producer warp beside each
// warpgroup made it 10 warps, three on some schedulers, and capped a
// thread at 168 registers, which spilled)
constexpr int kTcBlocksPerSm = 2;
constexpr int kSub = 64;   // columns of one wgmma
constexpr int kHead = 8;   // ints of the layer table's header

// a stage is kSteps k steps of a block of output columns, 16 KB: in
// float32 two k8 steps of 128 columns (the TF32 hi tiles, then the lo
// tiles), a thread's A of a step two adjacent channels of each of its rows;
// in bf16 two k16 steps of 256 columns, four adjacent channels a row.
// (Four k16 steps, 32 KB, made bf16 K4a 4% faster and K5 7% slower at
// config B: K5's middle activation then had to go to device scratch.)
template <bool kB>
struct Arm {
  using T = float;
  static constexpr int kSubs = 2;
  static constexpr int kE = 2;
  static constexpr int kSteps = 2;
};
template <>
struct Arm<true> {
  using T = __nv_bfloat16;
  static constexpr int kSubs = 4;
  static constexpr int kE = 4;
  static constexpr int kSteps = 2;
};
static_assert(2 * 2 * 128 * 8 * 4 == kTcStage, "a float32 stage");
static_assert(2 * 256 * 16 * 2 == kTcStage, "a bf16 stage");

// The layer table (int32, on the device): a header [c0_p, wrel, s0, b0,
// ww2, wb2, wn, c_last_p], the offsets in floats of each parameter in the
// parameter array (wn: wb0 [8], ww1 [8, 8], wb1 [8]), then per layer
// [cin_p, cout_p, s, b], its padded widths and the offsets of its scale (-1
// for none) and bias.  Parameters are zero-padded to the padded widths.
struct TcParams {
  const int* idx;       // [B*N, k]
  const void* src;      // kMax: base; kP2p: f2c; [B*N, src_stride] T
  const void* f1c;      // kP2p: [B*N, src_stride] T
  const float* xyz;     // kMax: centred points [B*N, 3]
  const float* z1;      // kP2p: [B*N, 8], the queries'
  const float* z2;      // kP2p: [B*N, 8], the neighbours'
  const char* wimg;     // the packed weight stages
  const float* prm;     // the parameters
  const int* table;     // the layer table
  void* out;            // [B*N, out_stride]: T (kP2p) or float32
  void* scratch;        // middle activations in device scratch, or nullptr
  int64_t total, src_stride, out_stride, works, scratch_block;
  int n, k, c0, c_last, layers;
  int span;             // rows a query (a power of two, at most 64)
  int qpt, tiles, iters, period;
  int xw, yw;           // row strides of the two middle buffers (elements)
  int x_global, y_global;
  int vec;              // x0's rows load whole (aligned, c0 a multiple of 4)
  int x_off, y_off, red_off, carry_off;  // bytes into dynamic shared memory
};

// the plan's fields, in the order of the host's array (ops/fused.py::
// CHAIN_TC_PLAN)
enum PlanField {
  kPN, kPK, kPTotal, kPSrcStride, kPOutStride, kPC0, kPCLast, kPLayers,
  kPSpan, kPQpt, kPTiles, kPWorks, kPIters, kPPeriod, kPXw, kPYw,
  kPXGlobal, kPYGlobal, kPXOff, kPYOff, kPRedOff, kPCarryOff,
  kPScratchBlock, kPGrid, kPSmem, kPFields
};

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// a row's channels of a thread's A of one stage as they lie: two floats
// (float32), or four bf16 as two packed pairs
template <bool kB>
using RawOf = std::conditional_t<kB, uint32_t, float>;

// element 2m .. 2m+1 (bf16: one packed pair; float32: element m) of the
// thread's channels c .. of a gathered row (null: a zero row), zero past c0
template <bool kB, typename T>
__device__ __forceinline__ RawOf<kB> load_raw(const T* row, int c, int m,
                                              int c0) {
  if constexpr (kB) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(row);
    const int cc = c + 2 * m;
    const uint32_t lo = row && cc < c0 ? __ldg(p + cc) : 0u;
    const uint32_t hi = row && cc + 1 < c0 ? __ldg(p + cc + 1) : 0u;
    return lo | (hi << 16);
  } else {
    const int cc = c + m;
    return row && cc < c0 ? __ldg(row + cc) : 0.0f;
  }
}

// N consecutive parameters (16-byte aligned for 4, 8-byte for 2)
template <int N>
__device__ __forceinline__ void param(const float* at, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(at));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    const float2 x = __ldg(reinterpret_cast<const float2*>(at));
    v[0] = x.x;
    v[1] = x.y;
  }
}

// the thread's channels of a gathered row at `at` in one 8-byte load
// (read-only), or zeros
template <bool kB, typename T>
__device__ __forceinline__ void load_whole(const T* at, bool valid,
                                           RawOf<kB> (&r)[2]) {
  if constexpr (kB) {
    const uint2 x = valid ? __ldg(reinterpret_cast<const uint2*>(at))
                          : make_uint2(0u, 0u);
    r[0] = x.x;
    r[1] = x.y;
  } else {
    const float2 x = valid ? __ldg(reinterpret_cast<const float2*>(at))
                           : make_float2(0.0f, 0.0f);
    r[0] = x.x;
    r[1] = x.y;
  }
}

// the thread's channels of a middle activation row (plain loads: it may
// lie in scratch this block wrote)
template <bool kB>
__device__ __forceinline__ void load_row(const void* row, RawOf<kB> (&r)[2]) {
  if constexpr (kB) {
    const uint2 x = *static_cast<const uint2*>(row);
    r[0] = x.x;
    r[1] = x.y;
  } else {
    const float2 x = *static_cast<const float2*>(row);
    r[0] = x.x;
    r[1] = x.y;
  }
}

// those values as floats, exactly
template <bool kB>
__device__ __forceinline__ void unpack(const RawOf<kB> (&r)[2],
                                       float (&v)[kB ? 4 : 2]) {
  if constexpr (kB) {
    const float4 x = tc::bf16x4_to_float4(make_uint2(r[0], r[1]));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = r[0];
    v[1] = r[1];
  }
}

// two adjacent channels of a middle activation row, in its dtype
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(a, b);
}

using Ring = tc::ClusterRing<kTcStages, kTcStage, kTcCluster>;

#ifdef CHAIN_TC_TIMELINE
constexpr int kStamps = 1 << 14;
__device__ long long g_stamps[kStamps];
__device__ int g_stamp_count;
// block 0's thread 0: the cycle counter and what it marks (0: before a
// stage's wait, 1: after it, 2: after the stage's products are issued, 3:
// after the wait for them, 4: a stage issued by fill_ring, 5: after the
// stage's release, 6: after the next stage's A is formed, 7: after the
// stage after's rows are asked for)
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

#ifdef CHAIN_TC_NO_MMA
constexpr bool kMma = false;
#else
constexpr bool kMma = true;
#endif

// whether the phase of `parity` of the barrier at `bar` has completed,
// without waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(tc::smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// The ring's producer, run by thread 0 of the warpgroup after it releases a
// stage (need = -1) and, where that stage has not been issued yet, before
// it takes stage `need`: it issues this block's half of every stage whose
// buffer both blocks of the cluster have released, up to kTcStages ahead
// of `next`, the next stage it takes, testing without waiting; it waits
// only for the stage it needs now.  `fill` counts the stages issued, of
// `chunks` in all; stage f is the 16 KB at src + (f % period) * kTcStage,
// f % period kept in `from_at` (tc::ClusterRing::produce, one stage at a
// time).
__device__ __forceinline__ void fill_ring(const Ring& ring, const char* src,
                                          int period, int chunks, int need,
                                          int next, int& fill, int& from_at,
                                          uint32_t rank) {
  while (fill < chunks && fill < next + kTcStages) {
    const int s = fill % kTcStages;
    if (fill >= kTcStages) {
      const uint32_t parity = ((fill / kTcStages) - 1) & 1;
      if (fill > need) {
        if (!mbar_test(&ring.empty[s], parity)) break;
      } else {
        tc::mbar_wait(&ring.empty[s], parity);
      }
    }
    const uint32_t bar = tc::smem_addr(&ring.full[s]);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar),
        "r"(kTcStage)
        : "memory");
    const uint32_t dst =
        tc::smem_addr(ring.buf + s * kTcStage + rank * Ring::kPart);
    const char* from = src + (size_t)from_at * kTcStage + rank * Ring::kPart;
    if (++from_at == period) from_at = 0;  // fill % period
    if constexpr (kTcCluster == 1) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
          "l"(from), "r"(Ring::kPart), "r"(bar)
          : "memory");
    } else {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
          "l"(from), "r"(Ring::kPart), "r"(bar),
          "h"((uint16_t)((1u << kTcCluster) - 1))
          : "memory");
    }
    stamp(4);
    ++fill;
  }
}

#define CHAIN_D8(i)                                                     \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),  \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),            \
      "+f"(d[(i) + 7])
#define CHAIN_D32(i) \
  CHAIN_D8(i), CHAIN_D8((i) + 8), CHAIN_D8((i) + 16), CHAIN_D8((i) + 24)

// d = A (registers, bf16) x B (descriptor, bf16, K-major) + (accumulate ?
// d : 0) in float32, 64 x 128 x 16 (the first 64 of d, as mma_bf16_n256
// lays them out)
__device__ __forceinline__ void mma_bf16_n128(float* d, const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : CHAIN_D32(0), CHAIN_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d = A (registers, bf16) x B (descriptor, bf16, K-major) + (accumulate ?
// d : 0) in float32, 64 x 192 x 16 (the first 96 of d, as mma_bf16_n256
// lays them out)
__device__ __forceinline__ void mma_bf16_n192(float* d, const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 0;\n"
      "}\n"
      : CHAIN_D32(0), CHAIN_D32(32), CHAIN_D32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#undef CHAIN_D32
#undef CHAIN_D8

// a block pass's product for one k16 step, NS 64-column parts wide: one
// instruction (four narrow ones cost four times the issue)
template <int NS>
__device__ __forceinline__ void mma_bf16_cols(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  if constexpr (NS == 4) {
    tc::mma_bf16_n256(d, a, b, 1);
  } else if constexpr (NS == 3) {
    mma_bf16_n192(d, a, b, 1);
  } else if constexpr (NS == 2) {
    mma_bf16_n128(d, a, b, 1);
  } else {
    tc::mma_bf16_n64(*reinterpret_cast<float(*)[32]>(d), a, b, 1);
  }
}

// the same in 3xTF32 for one k8 step, 128 or 64 columns; accumulate = 0
// starts d afresh
template <int NS>
__device__ __forceinline__ void mma3_cols(float (&d)[64], const tc::Split& a,
                                          uint32_t hi, uint32_t lo,
                                          int accumulate) {
  if constexpr (NS == 2) {
    tc::mma3(d, a, hi, lo, accumulate);
  } else {
    tc::mma3(*reinterpret_cast<float(*)[32]>(d), a, hi, lo, accumulate);
  }
}

// f(std::integral_constant<int, nsub>) for a runtime nsub in 1 .. MAX: the
// block pass compiled for each width, so that no branch sits between its
// products (ptxas serialises wgmmas across one)
template <int MAX, typename F>
__device__ __forceinline__ void with_width(int nsub, F&& f) {
  if constexpr (MAX >= 4) {
    if (nsub == 4) return f(std::integral_constant<int, 4>{});
  }
  if constexpr (MAX >= 3) {
    if (nsub == 3) return f(std::integral_constant<int, 3>{});
  }
  if (nsub == 2) return f(std::integral_constant<int, 2>{});
  return f(std::integral_constant<int, 1>{});
}

// keeps a 3xTF32 A operand in its registers until the wait that covers its
// products
__device__ __forceinline__ void fence_split(tc::Split& s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm volatile("" : "+r"(s.hi[i]), "+r"(s.lo[i])::"memory");
  }
}

template <Kind K, bool kB>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
    chain_tc_kernel(const __grid_constant__ TcParams p) {
  using T = typename Arm<kB>::T;
  constexpr int kSubs = Arm<kB>::kSubs;
  constexpr int kE = Arm<kB>::kE;      // a row's channels of a thread's A
  constexpr int kSteps = Arm<kB>::kSteps;
  constexpr int kChans = kSteps * 4 * kE;  // input channels of a stage
  using Raw = RawOf<kB>;
  constexpr int kCols = kSubs * kSub;  // columns of a block pass
  extern __shared__ __align__(128) char smem[];
  __shared__ int row_q[kTcRows];      // the row's query in its work item
  __shared__ int64_t row_j[kTcRows];  // its neighbour's row, or -1
  __shared__ float row_xyz[kTcRows][3];
  __shared__ __align__(16) float row_h[kTcRows][kH];
  __shared__ __align__(8) uint64_t full[kTcStages];
  __shared__ __align__(8) uint64_t empty[kTcStages];
  const Ring ring{smem, full, empty};
  if (threadIdx.x == 0) ring.init(kTcThreads / 32);
  tc::cluster_sync();  // every block's barriers are initialised
  const int chunks = p.iters * p.tiles * p.period;
  const uint32_t rank = kTcCluster == 1 ? 0 : tc::cluster_rank();
  int fill = 0, from_at = 0;  // thread 0: the stages it has issued
  // stage c of the ring, once it has landed (thread 0 fills it first)
  auto acquire = [&](int c) {
    stamp(0);
    if (threadIdx.x == 0 && fill <= c) {
      fill_ring(ring, p.wimg, p.period, chunks, c, c, fill, from_at, rank);
    }
    __syncwarp();
    const uint32_t st = ring.acquire(c);
    stamp(1);
    return st;
  };
  // stage c released by this warp; thread 0 issues what that frees
  auto release = [&](int c) {
    ring.release(c);
    stamp(5);
  };
  // while stage c's products run: thread 0 issues stage c + 2, whose
  // buffer stage c - 1's release freed (non-blocking; stage c + 3's buffer
  // is c's own)
  auto refill = [&](int c) {
    if (threadIdx.x == 0) {
      fill_ring(ring, p.wimg, p.period, chunks, -1, c, fill, from_at, rank);
    }
  };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = 16 * warp + g, rb = ra + 8;  // the thread's two rows
  const int* tab = p.table;
  const float* prm = p.prm;
  const int c0p = __ldg(tab);
  const int wrel_off = __ldg(tab + 1), s0_off = __ldg(tab + 2),
            b0_off = __ldg(tab + 3);
  const T* src = static_cast<const T*>(p.src);
  const T* f1c = static_cast<const T*>(p.f1c);
  T* const scratch =
      static_cast<T*>(p.scratch) + (int64_t)blockIdx.x * p.scratch_block;
  T* const xbuf =
      p.x_global ? scratch : reinterpret_cast<T*>(smem + p.x_off);
  T* const ybuf = p.y_global
                      ? scratch + (p.x_global ? (int64_t)kTcRows * p.xw : 0)
                      : reinterpret_cast<T*>(smem + p.y_off);
  float* const red = reinterpret_cast<float*>(smem + p.red_off);
  float* const carry = reinterpret_cast<float*>(smem + p.carry_off);
  int chunk = 0;  // stages taken from the ring

  for (int it = 0; it < p.iters; ++it) {
    const int64_t wk = blockIdx.x + (int64_t)it * gridDim.x;
    const int64_t q0 = wk * p.qpt;
    for (int tile = 0; tile < p.tiles; ++tile) {
      // the warp's 16 rows: (query, neighbour); only the warp reads them
      __syncwarp();
      if (lane < 16) {
        const int r = 16 * warp + lane;
        int qi, kk;
        if (p.tiles == 1) {
          qi = r / p.span;
          kk = r % p.span;
        } else {
          qi = 0;
          kk = tile * kTcRows + r;
        }
        const int64_t q = q0 + qi;
        const bool valid = wk < p.works && kk < p.k && q < p.total;
        int64_t j = -1;
        if (valid) {
          const int jj = __ldg(p.idx + q * p.k + kk);
          if (jj >= 0 && jj < p.n) j = (q / p.n) * p.n + jj;
        }
        row_q[r] = valid ? qi : -1;
        row_j[r] = j;
        if constexpr (K == kMax) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            row_xyz[r][a] = valid ? __ldg(p.xyz + q * 3 + a) : 0.0f;
          }
        } else {
          float d[kH], h[kH];
#pragma unroll
          for (int m = 0; m < kH; ++m) {
            d[m] = (j >= 0 ? __ldg(p.z2 + j * kH + m) : 0.0f) -
                   (valid ? __ldg(p.z1 + q * kH + m) : 0.0f);
          }
          const float* wn = prm + __ldg(tab + 6);
          weightnet_hidden(d, wn, wn + kH, wn + kH + kH * kH, h);
#pragma unroll
          for (int m = 0; m < kH; ++m) row_h[r][m] = h[m];
        }
      }
      __syncwarp();
      const int qa = row_q[ra], qb = row_q[rb];
      const int64_t ja = row_j[ra], jb = row_j[rb];
      // the rows x0 gathers from (src's neighbour rows, f1c's query rows),
      // or null for a zero row
      const T* gsrc[2] = {ja >= 0 ? src + ja * p.src_stride : nullptr,
                          jb >= 0 ? src + jb * p.src_stride : nullptr};
      const T* gq[2] = {nullptr, nullptr};
      if constexpr (K == kP2p) {
        gq[0] = qa >= 0 ? f1c + (q0 + qa) * p.src_stride : nullptr;
        gq[1] = qb >= 0 ? f1c + (q0 + qb) * p.src_stride : nullptr;
      }
      float xq[2][3];  // kMax: the rows' query points
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        xq[0][a] = K == kMax ? row_xyz[ra][a] : 0.0f;
        xq[1][a] = K == kMax ? row_xyz[rb][a] : 0.0f;
      }

      for (int l = 0; l < p.layers; ++l) {
        const int* lt = tab + kHead + 4 * l;
        const int cin = __ldg(lt), cout = __ldg(lt + 1);
        const int s_off = __ldg(lt + 2), b_off = __ldg(lt + 3);
        const bool last = l + 1 == p.layers;
        // layer l reads x_l: x0 formed here, or the middle buffer layer l-1
        // wrote (X after even layers, Y after odd), and writes the other
        const T* in = (l - 1) % 2 == 0 ? xbuf : ybuf;
        const int inw = (l - 1) % 2 == 0 ? p.xw : p.yw;
        T* const outb = l % 2 == 0 ? xbuf : ybuf;
        const int outw = l % 2 == 0 ? p.xw : p.yw;
        const int stages = cin / kChans;

        // the thread's channels of k step ks: c .. c + kE - 1 of both its
        // rows, in from_rows' K order (ops/fused.py::_tc_operand,
        // _tc_operand_bf16): k16 step ks holds channels 16 ks + 4t .. +3 at
        // the positions of lane t; k8 step ks = 2q + e holds 16q + 4t + 2e
        // and +1
        auto chan = [&](int ks) {
          return kB ? 16 * ks + 4 * t : 16 * (ks >> 1) + 4 * t + 2 * (ks & 1);
        };
        const int steps = kSteps * stages;  // k steps
        // a batch of kSteps k steps from `s0`, as it lies: x0's gathered rows
        // (and f1c's query rows) or a middle activation's rows, in their
        // dtype (bf16 pairs packed, the lower channel in the low half)
        auto load_batch = [&](int s0, Raw (&gr)[kSteps][2][2],
                              Raw (&fr)[kSteps][2][2]) {
#pragma unroll
          for (int i = 0; i < kSteps; ++i) {
            if (s0 + i >= steps) break;
            const int c = chan(s0 + i);
            if (l == 0) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (p.vec) {  // the thread's channels in one load
                  load_whole<kB>(gsrc[h] + c, gsrc[h] && c < p.c0, gr[i][h]);
                  if constexpr (K == kP2p) {
                    load_whole<kB>(gq[h] + c, gq[h] && c < p.c0, fr[i][h]);
                  }
                  continue;
                }
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                  gr[i][h][m] = load_raw<kB>(gsrc[h], c, m, p.c0);
                  if constexpr (K == kP2p) {
                    fr[i][h][m] = load_raw<kB>(gq[h], c, m, p.c0);
                  }
                }
              }
            } else {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                load_row<kB>(in + (int64_t)(h ? rb : ra) * inw + c,
                             gr[i][h]);
              }
            }
          }
        };
        // k step s's values of the thread's rows, as floats: x0 (offset,
        // affine and activation; padded channels stay zero) or the middle
        // activation
        auto form = [&](int s, const Raw (&gr)[2][2], const Raw (&fr)[2][2],
                        float (&v)[2][kE]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) unpack<kB>(gr[h], v[h]);
          if (l != 0) return;
          const int c = chan(s);
          if constexpr (K == kMax) {
            float r0[kE], r1[kE], r2[kE], ss[kE], bb[kE];
            param<kE>(prm + wrel_off + c, r0);
            param<kE>(prm + wrel_off + c0p + c, r1);
            param<kE>(prm + wrel_off + 2 * c0p + c, r2);
            param<kE>(prm + s0_off + c, ss);
            param<kE>(prm + b0_off + c, bb);
            if (qa == qb) {  // one query: one offset for both rows
#pragma unroll
              for (int e = 0; e < kE; ++e) {
                const float off =
                    fmaf(xq[0][2], r2[e],
                         fmaf(xq[0][1], r1[e], xq[0][0] * r0[e]));
                v[0][e] = relu_affine(v[0][e] - off, ss[e], bb[e]);
                v[1][e] = relu_affine(v[1][e] - off, ss[e], bb[e]);
              }
            } else {
#pragma unroll
              for (int e = 0; e < kE; ++e) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float off = fmaf(xq[h][2], r2[e],
                                         fmaf(xq[h][1], r1[e],
                                              xq[h][0] * r0[e]));
                  v[h][e] = relu_affine(v[h][e] - off, ss[e], bb[e]);
                }
              }
            }
          } else {
            float bb[kE];
            param<kE>(prm + b0_off + c, bb);
            float fq[2][kE];
#pragma unroll
            for (int h = 0; h < 2; ++h) unpack<kB>(fr[h], fq[h]);
#pragma unroll
            for (int e = 0; e < kE; ++e) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                v[h][e] = leaky((fq[h][e] + v[h][e]) + bb[e]);
              }
            }
          }
        };

        for (int cb = 0; cb * kCols < cout; ++cb) {
          const int nsub = min(kSubs, (cout - cb * kCols) / kSub);
          // acc[32u + 4j + e] is row ra (e < 2) or rb (e >= 2), column
          // col_of(u, j) + e % 2 (tc_gemm.cuh's D layout, 64-column part u)
          float acc[kSubs * 32];
#pragma unroll
          for (int i = 0; i < kSubs * 32; ++i) acc[i] = 0.0f;
          // a stage's rows (two k steps), the next stage's loaded while
          // this one's products run
          Raw rg[kSteps][2][2], rf[kSteps][2][2];
          load_batch(0, rg, rf);
          with_width<kSubs>(nsub, [&](auto width) {
            constexpr int NS = decltype(width)::value;
            if constexpr (!kB) {
              // 3xTF32: a stage's two k8 steps summed from zero in `part`,
              // then added into `acc` (tc::promote)
              float part[64];
#pragma unroll
              for (int i = 0; i < 64; ++i) part[i] = 0.0f;
              for (int s = 0; s < stages; ++s) {
                // positions t and t + 4: the thread's two channels
                tc::Split a[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  float v[2][kE];
                  form(kSteps * s + e, rg[e], rf[e], v);
                  a[e] = tc::split4(v[0][0], v[1][0], v[0][1], v[1][1]);
                }
                stamp(6);
                if (s + 1 < stages) load_batch(kSteps * (s + 1), rg, rf);
                stamp(7);
                const uint32_t st = acquire(chunk + s);
                tc::fence_regs(part);
                tc::fence();
                if (kMma) {  // hi tiles at 0 and 4 KB, lo at 8 and 12 KB
                  mma3_cols<NS>(part, a[0], st, st + 8192, 0);
                  mma3_cols<NS>(part, a[1], st + 4096, st + 12288, 1);
                }
                tc::commit();
                refill(chunk + s);
                stamp(2);
                tc::wait_all();
                stamp(3);
                tc::fence_regs(part);
                fence_split(a[0]);
                fence_split(a[1]);
                tc::promote<0>(acc, part);
                release(chunk + s);
              }
            } else {
              // bf16: a stage's A formed (x0) or taken as loaded (a middle
              // activation is bf16 already) before its products; forming
              // the next stage's A while they run measured slower
              // (scripts/profile_torch_chain.py: ptxas then issued the
              // products one after another)
              for (int s = 0; s < stages; ++s) {
                uint32_t a[kSteps][4];
#pragma unroll
                for (int e = 0; e < kSteps; ++e) {
                  if (l > 0) {
                    a[e][0] = rg[e][0][0];
                    a[e][1] = rg[e][1][0];
                    a[e][2] = rg[e][0][1];
                    a[e][3] = rg[e][1][1];
                    continue;
                  }
                  float v[2][kE];
                  form(kSteps * s + e, rg[e], rf[e], v);
                  a[e][0] = tc::pack_bf16(v[0][0], v[0][1]);
                  a[e][1] = tc::pack_bf16(v[1][0], v[1][1]);
                  a[e][2] = tc::pack_bf16(v[0][2], v[0][3]);
                  a[e][3] = tc::pack_bf16(v[1][2], v[1][3]);
                }
                stamp(6);
                if (s + 1 < stages) load_batch(kSteps * (s + 1), rg, rf);
                stamp(7);
                const uint32_t st = acquire(chunk + s);
                tc::fence_regs(acc);
                tc::fence();
                if (kMma) {  // k16 step e at 8 KB * e
#pragma unroll
                  for (int e = 0; e < kSteps; ++e) {
                    mma_bf16_cols<NS>(acc, a[e], tc::desc(st + 8192 * e));
                  }
                }
                tc::commit();
                refill(chunk + s);
                stamp(2);
                tc::wait_all();
                stamp(3);
                tc::fence_regs(acc);
                tc::fence_regs(a);
                release(chunk + s);
              }
            }
          });
          chunk += stages;

          auto col_of = [&](int u, int j) {
            return cb * kCols + kSub * u + 8 * j + 2 * t;
          };
          if (!last) {
            // the activation, rounded to the next product's dtype, into the
            // middle buffer (padded columns: zero)
#pragma unroll
            for (int u = 0; u < kSubs; ++u) {
              if (u >= nsub) continue;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int col = col_of(u, j);
                const float2 bi = ldg2(prm + b_off + col);
                float v4[4];
                if constexpr (K == kMax) {
                  const float2 sc = ldg2(prm + s_off + col);
                  v4[0] = relu_affine(acc[32 * u + 4 * j], sc.x, bi.x);
                  v4[1] = relu_affine(acc[32 * u + 4 * j + 1], sc.y, bi.y);
                  v4[2] = relu_affine(acc[32 * u + 4 * j + 2], sc.x, bi.x);
                  v4[3] = relu_affine(acc[32 * u + 4 * j + 3], sc.y, bi.y);
                } else {
                  v4[0] = leaky(acc[32 * u + 4 * j] + bi.x);
                  v4[1] = leaky(acc[32 * u + 4 * j + 1] + bi.y);
                  v4[2] = leaky(acc[32 * u + 4 * j + 2] + bi.x);
                  v4[3] = leaky(acc[32 * u + 4 * j + 3] + bi.y);
                }
                store2(outb + (int64_t)ra * outw + col, v4[0], v4[1]);
                store2(outb + (int64_t)rb * outw + col, v4[2], v4[3]);
              }
            }
            continue;
          }

          // the last layer: each value's activation (kMax), or its
          // WeightNet weight times it (kP2p); masked rows -inf or 0
          float ha[kH], hb[kH];
          if constexpr (K == kP2p) {
#pragma unroll
            for (int m = 0; m < kH; ++m) {
              ha[m] = row_h[ra][m];
              hb[m] = row_h[rb][m];
            }
          }
          const float masked = K == kMax ? -INFINITY : 0.0f;
#pragma unroll
          for (int u = 0; u < kSubs; ++u) {
            if (u >= nsub) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = col_of(u, j);
              const float2 bi = ldg2(prm + b_off + col);
              if constexpr (K == kMax) {
                const float2 sc = ldg2(prm + s_off + col);
                acc[32 * u + 4 * j] =
                    qa >= 0 ? relu_affine(acc[32 * u + 4 * j], sc.x, bi.x)
                            : masked;
                acc[32 * u + 4 * j + 1] =
                    qa >= 0 ? relu_affine(acc[32 * u + 4 * j + 1], sc.y, bi.y)
                            : masked;
                acc[32 * u + 4 * j + 2] =
                    qb >= 0 ? relu_affine(acc[32 * u + 4 * j + 2], sc.x, bi.x)
                            : masked;
                acc[32 * u + 4 * j + 3] =
                    qb >= 0 ? relu_affine(acc[32 * u + 4 * j + 3], sc.y, bi.y)
                            : masked;
              } else {
                const float* ww2 = prm + __ldg(tab + 4);
                const int clp = __ldg(tab + 7);
                const float2 b2 = ldg2(prm + __ldg(tab + 5) + col);
                float ta0 = 0.0f, ta1 = 0.0f, tb0 = 0.0f, tb1 = 0.0f;
#pragma unroll
                for (int m = 0; m < kH; ++m) {
                  const float2 w2 = ldg2(ww2 + m * clp + col);
                  ta0 = fmaf(ha[m], w2.x, ta0);
                  ta1 = fmaf(ha[m], w2.y, ta1);
                  tb0 = fmaf(hb[m], w2.x, tb0);
                  tb1 = fmaf(hb[m], w2.y, tb1);
                }
                acc[32 * u + 4 * j] = qa >= 0 ? fmaxf(ta0 + b2.x, 0.0f) *
                                              leaky(acc[32 * u + 4 * j] + bi.x)
                                        : masked;
                acc[32 * u + 4 * j + 1] =
                    qa >= 0 ? fmaxf(ta1 + b2.y, 0.0f) *
                                  leaky(acc[32 * u + 4 * j + 1] + bi.y)
                            : masked;
                acc[32 * u + 4 * j + 2] =
                    qb >= 0 ? fmaxf(tb0 + b2.x, 0.0f) *
                                  leaky(acc[32 * u + 4 * j + 2] + bi.x)
                            : masked;
                acc[32 * u + 4 * j + 3] =
                    qb >= 0 ? fmaxf(tb1 + b2.y, 0.0f) *
                                  leaky(acc[32 * u + 4 * j + 3] + bi.y)
                            : masked;
              }
            }
          }

          auto comb = [](float a, float b) {
            return K == kMax ? fmaxf(a, b) : a + b;
          };
          auto put = [&](int64_t q, int col, float x) {
            if constexpr (K == kMax) {
              static_cast<float*>(p.out)[q * p.out_stride + col] = x;
            } else {
              store(static_cast<T*>(p.out), q * p.out_stride + col, x);
            }
          };
          if (p.span <= 8) {
            // a query's rows are lanes g .. g + span - 1 of one half of the
            // warp's rows: a butterfly over the low bits of g, each half on
            // its own
            for (int m = 1; m < p.span; m *= 2) {
#pragma unroll
              for (int u = 0; u < kSubs; ++u) {
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                  const float x = acc[32 * u + i];
                  acc[32 * u + i] =
                      comb(x, __shfl_xor_sync(0xffffffffu, x, 4 * m));
                }
              }
            }
            if (g % p.span == 0) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int qh = h ? qb : qa;
                if (qh < 0) continue;
#pragma unroll
                for (int u = 0; u < kSubs; ++u) {
                  if (u >= nsub) continue;
#pragma unroll
                  for (int j = 0; j < 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                      const int col = col_of(u, j) + e;
                      if (col < p.c_last) {
                        put(q0 + qh, col, acc[32 * u + 4 * j + 2 * h + e]);
                      }
                    }
                  }
                }
              }
            }
            continue;
          }
          // a query's rows fill the warp's 16 or more: both rows of the
          // thread, then the butterfly over all of g
#pragma unroll
          for (int u = 0; u < kSubs; ++u) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float x = comb(acc[32 * u + 4 * j + e],
                               acc[32 * u + 4 * j + 2 + e]);
#pragma unroll
                for (int m = 4; m < 32; m *= 2) {
                  x = comb(x, __shfl_xor_sync(0xffffffffu, x, m));
                }
                acc[32 * u + 4 * j + e] = x;
              }
            }
          }
          if (p.span == 16 && p.tiles == 1) {  // a query a warp
            if (g == 0 && qa >= 0) {
#pragma unroll
              for (int u = 0; u < kSubs; ++u) {
                if (u >= nsub) continue;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const int col = col_of(u, j) + e;
                    if (col < p.c_last) {
                      put(q0 + qa, col, acc[32 * u + 4 * j + e]);
                    }
                  }
                }
              }
            }
            continue;
          }
          // a query over two or four warps, and over tiles: each warp's
          // part through shared memory, added in warp order, then to the
          // carry of the tiles before
          if (g == 0) {
#pragma unroll
            for (int u = 0; u < kSubs; ++u) {
              if (u >= nsub) continue;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int cl = kSub * u + 8 * j + 2 * t;
                red[warp * kCols + cl] = acc[32 * u + 4 * j];
                red[warp * kCols + cl + 1] = acc[32 * u + 4 * j + 1];
              }
            }
          }
          tc::consumer_sync<kTcThreads>();
          const int wpq = p.span / 16;  // warps a query
          const int cols = nsub * kSub;
          for (int e = tid; e < p.qpt * cols; e += kTcThreads) {
            const int qi = e / cols, cl = e % cols, col = cb * kCols + cl;
            const int64_t q = q0 + qi;
            if (wk >= p.works || q >= p.total || col >= p.c_last) continue;
            float x = red[qi * wpq * kCols + cl];
            for (int w = 1; w < wpq; ++w) {
              x = comb(x, red[(qi * wpq + w) * kCols + cl]);
            }
            if (p.tiles > 1) {
              if (tile > 0) x = comb(carry[col], x);
              if (tile + 1 < p.tiles) {
                carry[col] = x;
                continue;
              }
            }
            put(q, col, x);
          }
          tc::consumer_sync<kTcThreads>();
        }
        __syncwarp();  // the warp's rows of x_{l+1} written before read
      }
    }
  }
  tc::cluster_sync();  // no block of the cluster signals this one any more
}

template <Kind K, bool kB>
int launch_tc(const TcParams& p, int grid, int smem, void* stream) {
  auto kernel = chain_tc_kernel<K, kB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)tc::launch_cluster<kTcCluster>(kernel, grid, kTcThreads,
                                             (size_t)smem, stream, p);
}

template <typename F>
auto pick_tc(int kind, int bf16, F f) {
  if (kind == kMax) {
    return bf16 ? f(chain_tc_kernel<kMax, true>)
                : f(chain_tc_kernel<kMax, false>);
  }
  return bf16 ? f(chain_tc_kernel<kP2p, true>)
              : f(chain_tc_kernel<kP2p, false>);
}

}  // namespace

extern "C" {

// A max (K3 and K5) with no layer; bf16 1 for the bf16 arm.  idx [B,N,k]
// int32; src the gathered base (T) with row stride src_stride (elements);
// xyz [B,N,3] centred, wrel [3,c0], s0, b0 [c0]; out [B,N] float32 rows of
// out_stride elements.  Returns a cudaError_t.
int cmflow_chain(int bf16, const void* idx, int b, int n, int k,
                 const void* src, long long src_stride, const void* xyz,
                 const void* wrel, const void* s0, const void* b0, int c0,
                 void* out, long long out_stride, void* stream) {
  const long long total = (long long)b * n;
  if (n < 1 || b < 0 || k < 1 || c0 < 1 ||
      4 * ((c0 + 3) & ~3) > kMaxSmem - 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (total == 0) return (int)cudaSuccess;
  Params p{};
  p.idx = static_cast<const int*>(idx);
  p.n = n;
  p.k = k;
  p.total = total;
  p.src = src;
  p.src_stride = src_stride;
  p.xyz = static_cast<const float*>(xyz);
  p.wrel = static_cast<const float*>(wrel);
  p.s0 = static_cast<const float*>(s0);
  p.b0 = static_cast<const float*>(b0);
  p.c0 = c0;
  p.out = static_cast<float*>(out);
  p.out_stride = out_stride;
  return bf16 ? launch<__nv_bfloat16>(p, stream) : launch<float>(p, stream);
}

// kind 0 (max, K3 and K5) or 1 (point-to-patch, K4a), each with at least
// one layer; bf16 1 for the bf16 arm.  plan: kPFields int64 values in the
// order of PlanField (ops/fused.py::chain_tc_plan computes them from the
// shapes).  idx [B,N,k] int32; src (base or f2c) and f1c (kind 1) rows of
// src_stride elements, T; xyz [B,N,3] centred (kind 0); z1, z2 [B,N,8]
// (kind 1); wimg the packed weight stages (ops/fused.py::chain_tc_weights);
// prm and table the parameters and the layer table (chain_tc_params); out
// [B,N] rows of out_stride elements, T for kind 1, else float32; scratch
// as the plan sizes it; vec 1 where src's and f1c's rows may be read four
// elements (bf16) or two (float32) at a time: 8-byte aligned rows and c0 a
// multiple of 4.  Returns a cudaError_t.
int cmflow_chain_tc(int kind, int bf16, const long long* plan,
                    const void* idx, const void* src, const void* f1c,
                    const void* xyz, const void* z1, const void* z2,
                    const void* wimg, const void* prm, const void* table,
                    void* out, void* scratch, int vec, void* stream) {
  if ((kind != kMax && kind != kP2p) || plan[kPLayers] < 1 ||
      plan[kPN] < 1 || plan[kPK] < 1 || plan[kPSpan] > kTcRows ||
      plan[kPGrid] % kTcCluster ||
      ((plan[kPXGlobal] || plan[kPYGlobal]) && !scratch)) {
    return (int)cudaErrorInvalidValue;
  }
  if (plan[kPTotal] == 0) return (int)cudaSuccess;
  TcParams p{};
  p.idx = static_cast<const int*>(idx);
  p.src = src;
  p.f1c = f1c;
  p.xyz = static_cast<const float*>(xyz);
  p.z1 = static_cast<const float*>(z1);
  p.z2 = static_cast<const float*>(z2);
  p.wimg = static_cast<const char*>(wimg);
  p.prm = static_cast<const float*>(prm);
  p.table = static_cast<const int*>(table);
  p.out = out;
  p.scratch = scratch;
  p.total = plan[kPTotal];
  p.src_stride = plan[kPSrcStride];
  p.out_stride = plan[kPOutStride];
  p.works = plan[kPWorks];
  p.scratch_block = plan[kPScratchBlock];
  p.n = (int)plan[kPN];
  p.k = (int)plan[kPK];
  p.c0 = (int)plan[kPC0];
  p.c_last = (int)plan[kPCLast];
  p.layers = (int)plan[kPLayers];
  p.span = (int)plan[kPSpan];
  p.qpt = (int)plan[kPQpt];
  p.tiles = (int)plan[kPTiles];
  p.iters = (int)plan[kPIters];
  p.period = (int)plan[kPPeriod];
  p.xw = (int)plan[kPXw];
  p.yw = (int)plan[kPYw];
  p.x_global = (int)plan[kPXGlobal];
  p.vec = vec;
  p.y_global = (int)plan[kPYGlobal];
  p.x_off = (int)plan[kPXOff];
  p.y_off = (int)plan[kPYOff];
  p.red_off = (int)plan[kPRedOff];
  p.carry_off = (int)plan[kPCarryOff];
  const int grid = (int)plan[kPGrid], smem = (int)plan[kPSmem];
  if (kind == kMax) {
    return bf16 ? launch_tc<kMax, true>(p, grid, smem, stream)
                : launch_tc<kMax, false>(p, grid, smem, stream);
  }
  return bf16 ? launch_tc<kP2p, true>(p, grid, smem, stream)
              : launch_tc<kP2p, false>(p, grid, smem, stream);
}

#ifdef CHAIN_TC_TIMELINE
// block 0's stamps of the last launch (pairs of cycle counter and mark) into
// `host`, at most n pairs; returns how many, and clears them
int cmflow_chain_tc_timeline(long long* host, int n) {
  int count = 0;
  cudaMemcpyFromSymbol(&count, g_stamp_count, sizeof(int));
  count = count < n ? count : n;
  cudaMemcpyFromSymbol(host, g_stamps, 2 * sizeof(long long) * count);
  const int zero = 0;
  cudaMemcpyToSymbol(g_stamp_count, &zero, sizeof(int));
  return count;
}
#endif

// The tensor-core kernel's static shared memory in bytes (the host's plan
// counts it: ops/fused.py::CHAIN_TC_STATIC_SMEM), or -1 on an error.
int cmflow_chain_tc_static_smem(int kind, int bf16) {
  cudaFuncAttributes attr;
  const cudaError_t err = pick_tc(kind, bf16, [&](auto kernel) {
    return cudaFuncGetAttributes(&attr, kernel);
  });
  return err == cudaSuccess ? (int)attr.sharedSizeBytes : -1;
}

// Blocks of the tensor-core kernel an SM holds at `smem` bytes of dynamic
// shared memory (the card's own count: registers and shared memory), or -1.
int cmflow_chain_tc_occupancy(int kind, int bf16, int smem) {
  int blocks = -1;
  const cudaError_t err = pick_tc(kind, bf16, [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         kTcThreads, smem);
  });
  return err == cudaSuccess ? blocks : -1;
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
