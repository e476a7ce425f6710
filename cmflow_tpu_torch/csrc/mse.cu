// The narrow multi-scale (sa) encoder, all scales in one launch, on the
// tensor cores of Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cmflow_tpu/ops/fused.py::_mse_kernel
// (called by fused_multi_scale_encoder).  For each query i, scale s and each
// of i's first K_s ball-query neighbours j (one row per pair):
//   x0 = ReLU(([xyz[j] - xyz[i], feats[j]] @ W0_s) * s0_s + b0_s)   32 wide
//   x1 = ReLU((x0 @ W1_s) * s1_s + b1_s)                             32 wide
//   x2 = ReLU((x1 @ W2_s) * s2_s + b2_s)                             64 wide
//   out[i, s] = max over the K_s rows of x2
// with W0_s = [w0r_s; w0f_s], the first layer (3 + Cf rows, Cf <= 5).  The
// plain version folds the first layer outside (a gathered base minus the
// query's offset); this is the same function.  A neighbour index outside
// [0, N) stands for a zero row of that base: the point at the cloud's
// centroid with zero features.
//
// What bounds it: operations.  3,328 multiply-adds per row (the first layer
// padded to 8 inputs, then 32x32 and 32x64); at B=16, N=256 a launch holds
// 245,760 rows (K = 4, 8, 16, 32).  As three TF32 tensor-core products per
// product (3xTF32, tc_gemm.cuh) that is ~9 us at an H100 SXM's published
// dense TF32 peak (495 TFLOP/s, at its 700 W limit); in float32 FFMA it
// would be ~23 us at 67 TFLOP/s.  The bytes (a few KB of cloud per batch
// element, the indices, 4 MB out) take ~1.3 us at 3.35 TB/s.  Measured on
// an H100 80GB HBM3 at 700 W it reaches ~20% of the 3xTF32 bound: each
// warp's 16-row unit is a chain of gathers, dependent products and
// shuffles that 16 warps per SM do not hide (PERF.md).  The long kernels'
// times beside their bounds: PERF.md, scripts/profile_torch_mse.py.
//
// Design: a row-tiled gather-GEMM on mma.sync.m16n8k8 .tf32, max-pooled in
// registers.  A query's K_s rows are padded to P_s = the next power of two
// by repeating its first neighbour (the max is unchanged), so a warp's
// 32-row tile holds 32 / P_s whole queries and every tile carries the same
// work whatever the scale.  A block serves one scale: its split weights
// (26 KB) and affines sit in shared memory for all of its 8 warps x 4
// tiles, read as one float4 (hi and lo of a B fragment) per three products.
// - mma.sync, not wgmma: the products are narrow (N = 32, 64; K = 32), a
//   warp tile holds whole queries at every K <= 32 so the max closes in
//   registers and shuffles, and the warps of a block, each on its own
//   tiles, never wait for one another.
// - Past K = 32 (mse_long_kernel, and mse_bf16_long_kernel for the bf16
//   arm) the rows of a query run in 16-row units one after another, on
//   wgmma: a warpgroup takes four queries at a time (a quad), one a warp,
//   and a step is one unit of each, a 64-row tile (rows past K repeat the
//   first neighbour).  Each warp folds the step's last product into its
//   query's running max in registers (the affine and ReLU once a query,
//   fold_max) and closes it with the butterfly below after the query's
//   last unit: the max is exact, so any split gives the same bits.  Blocks
//   of three warpgroups (float32, 168 registers a thread) or four (bf16,
//   128) take consecutive quads of one scale, spread over every SM by the
//   host's plan (ops/fused.py::mse_long_plan); a block stages its weights
//   once as wgmma B tiles and its span once (the points of the elements
//   its queries lie in: float32 coordinates and features, bf16 bases) in
//   shared memory, and each warp copies a step's indices into a ring with
//   cp.async two steps ahead, so no register waits on a load from device
//   memory.  Every product takes its A from registers: the gathered row,
//   or the accumulator of the product before after its affine and ReLU, as
//   it lies (the K order of the mma.sync fragments below is wgmma's too);
//   float32 splits it into TF32 hi and lo by truncation (two instructions
//   a value, where ptxas expands cvt.rna to four).  A launch's scales of
//   each kind take their own kernel, so a call with both is two launches;
//   the scales of K <= 32 keep their kernel and bits.  (A warp a query on
//   mma.sync read its scale's 26 KB of B fragments from shared memory for
//   every 16 rows, where wgmma reads them once for 64; loads of a step's
//   indices and rows from device memory, made when the step began, cost a
//   third of its time: PERF.md.)
// - Each thread gathers its two channels (t, t + 4) of its two rows (g,
//   g + 8) straight into the first product's A fragment; x0 and x1 stay in
//   the accumulator layout and are the next product's A as they stand (the
//   packer orders the weights' K to match, ops/fused.py::mse_tc_weights).
//   The next unit's indices load while the current unit computes.
// - Each k8 step's three products are summed by the tensor cores from zero
//   and added on the CUDA cores (tc_gemm.cuh, "promote").
// - Epilogue: affine, ReLU, then the max over a query's rows by a halving
//   butterfly: in each round of shuffles across the accumulator's row
//   groups a lane keeps half of its values and takes its partner's max of
//   them, so it ends holding whole columns of one query (at K > 8 one
//   float2, the warp's store of a query one 256-byte line).
// The weights come in float32 and are split into TF32 hi and lo while they
// are staged.  No atomics: two launches give the same bits.
//
// The bf16 arm (mse_bf16_kernel, the JAX kernel's bf16 serving mode,
// fused.py:290-293, :348, :351) takes what the float32 arm takes: the
// points, the features (here bf16, any strides), each cloud's centroid, the
// indices, and the weights where they lie (each scale's w0r and w0f, the
// stacked bf16 w1 and w2, the six affines), so its call is two launches (the
// centroids' mean and the kernel).  It forms the folded first layer itself,
// in float32 as the JAX package's base (make_mse_base: feats @ w0f_s, then
// (xyz - ctr) @ w0r_s, each over its channels in ascending order as one
// product and a chain of fused multiply-adds, then one add), rounded once to
// bf16, once a point: a block first forms the base and the centred point of
// every point of the batch elements its rows touch (its span; at B=16, N=256
// one or two elements) in shared memory.  Each row then reads its
// neighbour's base there (zero outside [0, N)), subtracts its query's
// offset (xyz_q - ctr) @ w0r_s in float32, applies the affine and ReLU,
// and rounds to bf16: the A of the 32 -> 32 product's two k16 steps.  (A
// span of more than kBf16SpanPoints points does not fit: then each row
// forms its neighbour's base from the point and features it gathers, a
// unit ahead.)  Both products (32 -> 32 -> 64) run on mma.sync m16n8k16
// .bf16 with float32 sums, each activation rounded to nearest even before;
// then the same padding, tiles, butterfly max and stores as the float32
// arm.  A block stages its scale's w1 and w2 into shared memory as the B
// fragments of its two products (one uint2 per fragment slot) and the
// float32 weights beside them.  What bounds it: operations, 3,072
// multiply-adds a row, ~1.5 us at the dense bf16 peak at B=16, N=256.
// mse_bf16_long_kernel forms its block's span the same way (the elements
// its quads lie in, where the plan finds that it fits), each warp its
// query's offset once a query, and runs both products on wgmma (m64n32k16,
// m64n64k16 .bf16) with the second's A the first's accumulator after its
// affine and ReLU, rounded to bf16 in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tc_gemm.cuh"

namespace {

namespace tc = cmflow::tc;

constexpr int kC0 = 8;    // first layer inputs: dx, dy, dz, Cf features, 0
constexpr int kC1 = 32;
constexpr int kC2 = 32;
constexpr int kC3 = 64;
constexpr int kMaxFeats = kC0 - 3;
constexpr int kMaxScales = 8;
constexpr int kMaxK = 32;  // the tile kernels' K; above it the long kernels
constexpr int kWarps = 8;
constexpr int kTilesPerWarp = 4;
constexpr int kTileRows = 32;  // two m16 units
// B fragments of one scale, one float4 per (product, k8 step, n8 tile,
// lane): layer 0 (1 x 4), layer 1 (4 x 4), layer 2 (4 x 8)
constexpr int kSlots1 = 4 * 32;
constexpr int kSlots2 = kSlots1 + 16 * 32;
constexpr int kSlots = kSlots2 + 32 * 32;
// affines of one scale: s0, b0, s1, b1 (32 each), s2, b2 (64 each)
constexpr int kS0 = 0, kB0 = 32, kS1 = 64, kB1 = 96, kS2 = 128, kB2 = 192;
constexpr int kAffine = 256;
// floats of one scale in the packed image: the (b0, b1) pair of each slot,
// then the affines
constexpr int kImage = 2 * kSlots + kAffine;
static_assert(kImage == 3584, "ops/fused.py::MSE_IMAGE");

struct Scales {
  int count;
  int k[kMaxScales];            // K_s
  int log2p[kMaxScales];        // P_s = 2^log2p[s] rows per query
  int block0[kMaxScales + 1];   // first block of each scale
  int qpb[kMaxScales];          // the long kernels: quads a block
  const int* idx[kMaxScales];   // [B*N, K_s]
};

// a row of a unit: its query (-1 past the end), the query's batch element,
// and its neighbour in that element (-1 outside [0, N))
struct Row {
  int q, b, j;
};

__device__ __forceinline__ Row unit_row(const int* __restrict__ idx, int r,
                                        int lp, int k, int total, int n) {
  Row row{-1, 0, -1};
  const int q = r >> lp;
  if (q < total) {
    int kk = r & ((1 << lp) - 1);
    if (kk >= k) kk = 0;  // padding rows repeat the first neighbour
    const int j = __ldg(idx + (int64_t)q * k + kk);
    row.q = q;
    row.b = q / n;
    row.j = (j >= 0 && j < n) ? j : -1;
  }
  return row;
}

struct Cloud {
  const float* xyz;    // [B*N, 3]
  const float* feats;  // [B, N, Cf], strided
  int64_t sb, sn, sc;
  int cf;
  const float* ctr;    // [B, 3], each cloud's mean over all N
  int n;
};

// channels t and t + 4 of the row's first-layer input
// [xyz[j] - xyz[q], feats[j], 0, ...]
__device__ __forceinline__ float2 gather(const Cloud& c, Row row, int t) {
  if (row.q < 0) return make_float2(0.0f, 0.0f);
  const bool in = row.j >= 0;
  const float* f = c.feats + row.b * c.sb + row.j * c.sn;
  float lo;
  if (t < 3) {
    const float p = in ? __ldg(c.xyz + ((int64_t)row.b * c.n + row.j) * 3 + t)
                       : __ldg(c.ctr + row.b * 3 + t);
    lo = p - __ldg(c.xyz + (int64_t)row.q * 3 + t);
  } else {
    lo = in && c.cf > 0 ? __ldg(f) : 0.0f;
  }
  const float hi = in && t + 1 < c.cf ? __ldg(f + (t + 1) * c.sc) : 0.0f;
  return make_float2(lo, hi);
}

// d = a (16 x 8) b (8 x 8) + c on the tensor cores, one warp; fragment
// layouts as in tc_gemm.cuh: a[0..3] = (g, t), (g+8, t), (g, t+4),
// (g+8, t+4); b0 = (k t, n g), b1 = (k t+4, n g); d[0..3] = (g, 2t),
// (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one k8 step in 3xTF32, small products first, summed from zero; w holds B's
// hi pair, then its lo pair
__device__ __forceinline__ void mma3(float (&d)[4], const tc::Split& a,
                                     float4 w) {
  const uint32_t h0 = __float_as_uint(w.x), h1 = __float_as_uint(w.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = 0.0f;
  mma(d, a.lo, h0, h1);
  mma(d, a.hi, __float_as_uint(w.z), __float_as_uint(w.w));
  mma(d, a.hi, h0, h1);
}

__device__ __forceinline__ float relu_affine(float x, float s, float b) {
  return fmaxf(fmaf(x, s, b), 0.0f);
}

// ReLU(d * s + b) at columns 8 nt + 2t, +1 of rows g, g + 8
__device__ __forceinline__ void epilogue(float* out, const float (&d)[4],
                                         const float* aff, int s_off,
                                         int b_off, int col) {
  const float2 s = *reinterpret_cast<const float2*>(aff + s_off + col);
  const float2 b = *reinterpret_cast<const float2*>(aff + b_off + col);
  out[0] = relu_affine(d[0], s.x, b.x);
  out[1] = relu_affine(d[1], s.y, b.y);
  out[2] = relu_affine(d[2], s.x, b.x);
  out[3] = relu_affine(d[3], s.y, b.y);
}

// A of a k8 step from the accumulator of n8 tile j of the previous product:
// position t is its column 8j + 2t, position t + 4 column 8j + 2t + 1
__device__ __forceinline__ tc::Split chain_a(const float* x) {
  return tc::split4(x[0], x[2], x[1], x[3]);
}

// w[0..M) = the max of this lane's and its partner's (lane ^ xor) values,
// keeping the upper half of w[0..2M) if up, the lower half otherwise
template <int M, int N>
__device__ __forceinline__ void halve(float (&w)[N], int up, int xor_mask) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? w[i] : w[i + M];
    const float keep = up ? w[i + M] : w[i];
    w[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, xor_mask));
  }
}

__device__ __forceinline__ void store2(float* __restrict__ out, int q,
                                       int stride, int col, float a,
                                       float b) {
  if (q >= 0) {
    *reinterpret_cast<float2*>(out + (int64_t)q * stride + col) =
        make_float2(a, b);
  }
}

// w[i], i < M, is value i + off of {v0 (row g), v1 (row g + 8)}
template <int M>
__device__ __forceinline__ void store_part(float* __restrict__ out, int qa,
                                           int qb, int stride,
                                           const float (&w)[32], int off,
                                           int t) {
#pragma unroll
  for (int i = 0; i < M; i += 2) {
    const int o = i + off;
    store2(out, o < 16 ? qa : qb, stride, 8 * ((o & 15) >> 1) + 2 * t, w[i],
           w[i + 1]);
  }
}

// The max over each query's rows of a unit, then its stores.  v0 and v1
// are the last product's rows g and g + 8 (columns 8 nt + 2t, +1 at
// 2 nt, 2 nt + 1).  P = 2^lp consecutive rows of the unit are the low bits
// of g, then (P >= 16) both row groups, then (P = 32) both halves of the
// tile, h the unit's half; carry holds the first half's max at P = 32.
__device__ __forceinline__ void pool_store(float (&v0)[16], float (&v1)[16],
                                           int lp, int h, int g, int t,
                                           int qa, int qb,
                                           float* __restrict__ outs,
                                           int stride, float (&carry)[2]) {
  if (lp <= 3) {
    float w[32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i] = v0[i];
      w[16 + i] = v1[i];
    }
    int off = 0;  // w[i] now holds value i + off of {v0, v1}
    if (lp > 0) {
      halve<16>(w, g & 1, 4);
      off += (g & 1) * 16;
    }
    if (lp > 1) {
      halve<8>(w, (g >> 1) & 1, 8);
      off += ((g >> 1) & 1) * 8;
    }
    if (lp > 2) {
      halve<4>(w, (g >> 2) & 1, 16);
      off += ((g >> 2) & 1) * 4;
    }
    switch (lp) {
      case 0: store_part<32>(outs, qa, qb, stride, w, off, t); break;
      case 1: store_part<16>(outs, qa, qb, stride, w, off, t); break;
      case 2: store_part<8>(outs, qa, qb, stride, w, off, t); break;
      default: store_part<4>(outs, qa, qb, stride, w, off, t); break;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v0[i] = fmaxf(v0[i], v1[i]);
    halve<8>(v0, g & 1, 4);
    halve<4>(v0, (g >> 1) & 1, 8);
    halve<2>(v0, (g >> 2) & 1, 16);
    // v0[0..1] are columns 8 nt + 2t, +1 with nt = 4 g0 + 2 g1 + g2
    if (lp == 5 && h == 0) {
      carry[0] = v0[0];
      carry[1] = v0[1];
    } else {
      if (lp == 5) {
        v0[0] = fmaxf(v0[0], carry[0]);
        v0[1] = fmaxf(v0[1], carry[1]);
      }
      const int nt = 4 * (g & 1) + ((g >> 1) & 1) * 2 + (g >> 2);
      store2(outs, qa, stride, 8 * nt + 2 * t, v0[0], v0[1]);
    }
  }
}

// the scale of this block's tiles
__device__ __forceinline__ int block_scale(const Scales& sc) {
  int s = 0;
  while (s + 1 < sc.count && (int)blockIdx.x >= sc.block0[s + 1]) ++s;
  return s;
}

// scale s's B fragments, split into TF32 hi and lo, and its affines into
// shared memory
__device__ __forceinline__ void stage_f32(const float* __restrict__ image,
                                          int s, float4* wsm, float* aff) {
  const float* img = image + (size_t)s * kImage;
  const float2* pairs = reinterpret_cast<const float2*>(img);
  for (int e = threadIdx.x; e < kSlots; e += blockDim.x) {
    const float2 w = __ldg(pairs + e);
    const uint32_t h0 = tc::tf32_rna(w.x), h1 = tc::tf32_rna(w.y);
    wsm[e] = make_float4(
        __uint_as_float(h0), __uint_as_float(h1),
        __uint_as_float(tc::tf32_rna(w.x - __uint_as_float(h0))),
        __uint_as_float(tc::tf32_rna(w.y - __uint_as_float(h1))));
  }
  for (int e = threadIdx.x; e < kAffine; e += blockDim.x) {
    aff[e] = __ldg(img + 2 * kSlots + e);
  }
}

// The three products of one 16-row unit from its first layer's gathered
// inputs (ga of row g, gb of row g + 8): the last product's rows g (v0) and
// g + 8 (v1), columns 8 nt + 2t, +1 at 2 nt, 2 nt + 1.
__device__ __forceinline__ void chain_f32(float2 ga, float2 gb,
                                          const float4* wsm, const float* aff,
                                          int lane, int t, float (&v0)[16],
                                          float (&v1)[16]) {
  // layer 0: one k8 step, input channel p at position p
  float x[16];
  {
    const tc::Split a = tc::split4(ga.x, gb.x, ga.y, gb.y);
#pragma unroll
    for (int nt = 0; nt < kC1 / 8; ++nt) {
      float d[4];
      mma3(d, a, wsm[nt * 32 + lane]);
      epilogue(x + 4 * nt, d, aff, kS0, kB0, 8 * nt + 2 * t);
    }
  }
  // layer 1: k8 step j takes x0's n8 tile j
  float y[16];
  {
    tc::Split a[kC1 / 8];
#pragma unroll
    for (int j = 0; j < kC1 / 8; ++j) a[j] = chain_a(x + 4 * j);
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kC1 / 8; ++j) {
        float d[4];
        mma3(d, a[j], wsm[kSlots1 + (j * (kC2 / 8) + nt) * 32 + lane]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += d[i];
      }
      epilogue(y + 4 * nt, acc, aff, kS1, kB1, 8 * nt + 2 * t);
    }
  }
  // layer 2, then its rows g (v0) and g + 8 (v1)
  {
    tc::Split a[kC2 / 8];
#pragma unroll
    for (int j = 0; j < kC2 / 8; ++j) a[j] = chain_a(y + 4 * j);
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kC2 / 8; ++j) {
        float d[4];
        mma3(d, a[j], wsm[kSlots2 + (j * (kC3 / 8) + nt) * 32 + lane]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += d[i];
      }
      float z[4];
      epilogue(z, acc, aff, kS2, kB2, 8 * nt + 2 * t);
      v0[2 * nt] = z[0];
      v0[2 * nt + 1] = z[1];
      v1[2 * nt] = z[2];
      v1[2 * nt + 1] = z[3];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32, 2)
    mse_kernel(Cloud cloud, const float* __restrict__ image,  // [S, kImage]
               float* __restrict__ out,                      // [B*N, S*kC3]
               int total, Scales sc) {
  __shared__ float4 wsm[kSlots];
  __shared__ __align__(16) float aff[kAffine];

  const int s = block_scale(sc);
  stage_f32(image, s, wsm, aff);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lp = sc.log2p[s], k = sc.k[s];
  const int* __restrict__ idx = sc.idx[s];
  const int tiles = ((total << lp) + kTileRows - 1) / kTileRows;
  const int tile0 = (blockIdx.x - sc.block0[s]) * kWarps * kTilesPerWarp;
  const int stride = sc.count * kC3;
  float* __restrict__ outs = out + s * kC3;

  // unit u of this warp: the half u % 2 of tile tile0 + warp + (u / 2) *
  // kWarps; its rows g and g + 8 in the scale's row space
  auto first_row = [&](int u) {
    return (tile0 + warp + (u >> 1) * kWarps) * kTileRows + 16 * (u & 1) + g;
  };
  Row ra = unit_row(idx, first_row(0), lp, k, total, cloud.n);
  Row rb = unit_row(idx, first_row(0) + 8, lp, k, total, cloud.n);
  float carry[2];  // P = 32: the first half's max

  for (int u = 0; u < 2 * kTilesPerWarp; ++u) {
    if (tile0 + warp + (u >> 1) * kWarps >= tiles) break;  // warp-uniform
    const int h = u & 1;
    const float2 ga = gather(cloud, ra, t), gb = gather(cloud, rb, t);
    Row na{-1, 0, -1}, nb{-1, 0, -1};
    if (u + 1 < 2 * kTilesPerWarp) {
      na = unit_row(idx, first_row(u + 1), lp, k, total, cloud.n);
      nb = unit_row(idx, first_row(u + 1) + 8, lp, k, total, cloud.n);
    }

    float v0[16], v1[16];
    chain_f32(ga, gb, wsm, aff, lane, t, v0, v1);

    pool_store(v0, v1, lp, h, g, t, ra.q, rb.q, outs, stride, carry);
    ra = na;
    rb = nb;
  }
}

// ---------------------------------------------------------------------------
// past K = 32: the long kernels, both arms on wgmma
// ---------------------------------------------------------------------------

// A scale's queries in quads of four consecutive queries, one a warp of a
// warpgroup.  Block i of scale s takes the qpb[s] quads from i * qpb[s] (the
// host's plan, ops/fused.py::mse_long_plan, spreads each scale over about
// every resident block); its warpgroups take every kGroups-th of them, so a
// block stages its weights once.  A warpgroup's step is one 16-row unit of
// each of its four queries, a 64-row wgmma tile: warp w's rows 16w .. 16w +
// 15 of the tile are rows 16u .. 16u + 15 of its query (rows past K repeat
// the first neighbour, the max is unchanged).  Every warp of a warpgroup
// takes the same steps (warps past the last query compute zero rows and
// store nothing), as wgmma needs.
constexpr int kLongGroups = 3;      // float32: warpgroups a block
constexpr int kLongBlocks = 1;      // blocks an SM (the launch bound: 168
                                    // registers a thread)
constexpr int kLongBf16Groups = 4;  // bf16 (128 registers; two blocks of
constexpr int kLongBf16Blocks = 1;  // two, each its own span, were slower)

// Build switches for scripts/profile_torch_mse.py's ablation copies (the
// package builds with none): MSE_LONG_NO_MMA (the products left out, their
// operands kept live) and MSE_LONG_TIMELINE (block 0's thread 0 stamps its
// cycle counter at the marks of each step into cmflow_mse_long_timeline's
// buffer).
#ifdef MSE_LONG_NO_MMA
constexpr bool kLongMma = false;
#else
constexpr bool kLongMma = true;
#endif
#ifdef MSE_LONG_TIMELINE
constexpr int kStamps = 1 << 14;
__device__ long long g_stamps[kStamps];
__device__ int g_stamp_count;
// 0: a step's start, 1: its first product's A formed, 2: the first
// product's wait done, 3: the second's, 4: the third's, 5: the step's end
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

// This warpgroup's quads in its block: the first, and how many (every
// `groups`-th from it, up to the block's end)
__device__ __forceinline__ int long_quads(const Scales& sc, int s, int wg,
                                          int groups, int total, int& first) {
  const int quads = (total + 3) / 4;
  const int q0 = (blockIdx.x - sc.block0[s]) * sc.qpb[s];
  const int end = min(q0 + sc.qpb[s], quads);
  first = q0 + wg;
  return first < end ? (end - first + groups - 1) / groups : 0;
}

// keeps a 3xTF32 A operand in its registers until the wait that covers its
// products
__device__ __forceinline__ void fence_split(tc::Split& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm volatile("" : "+r"(a.hi[i]), "+r"(a.lo[i])::"memory");
  }
}

// ReLU(d * s + b) of the accumulator's n8 tiles [0, M / 4) (rows g, g + 8,
// columns 8 nt + 2t, +1) into x, the affine at s_off, b_off of aff
template <int M>
__device__ __forceinline__ void epilogue_tiles(float (&x)[M], const float* d,
                                               const float* aff, int s_off,
                                               int b_off, int t) {
#pragma unroll
  for (int nt = 0; nt < M / 4; ++nt) {
    const float2 sv = *reinterpret_cast<const float2*>(aff + s_off + 8 * nt
                                                       + 2 * t);
    const float2 bv = *reinterpret_cast<const float2*>(aff + b_off + 8 * nt
                                                       + 2 * t);
    x[4 * nt] = relu_affine(d[4 * nt], sv.x, bv.x);
    x[4 * nt + 1] = relu_affine(d[4 * nt + 1], sv.y, bv.y);
    x[4 * nt + 2] = relu_affine(d[4 * nt + 2], sv.x, bv.x);
    x[4 * nt + 3] = relu_affine(d[4 * nt + 3], sv.y, bv.y);
  }
}

// The last product's accumulator (rows g, g + 8 of this warp's 16, columns
// 8 nt + 2t, +1 at 4 nt + e, + 2) folded into the running max m[2 nt + e]
// of each column over the query's rows so far (first: it starts here).
// The affine and ReLU come once a query (close_max): with the scale s of a
// column positive, both are non-decreasing in the accumulator, rounding
// included, so the max over rows of ReLU(d * s + b) is ReLU(max(d) * s + b)
// exactly.  A column of negative scale is staged negated (its weights, so
// its accumulator is -d bit for bit: rounding to nearest is symmetric) with
// the scale |s|, which computes the same -d * |s| = d * s.
__device__ __forceinline__ void fold_max(float (&m)[16], const float (&d)[32],
                                         bool first) {
#pragma unroll
  for (int nt = 0; nt < kC3 / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float hi = fmaxf(d[4 * nt + e], d[4 * nt + 2 + e]);
      m[2 * nt + e] = first ? hi : fmaxf(m[2 * nt + e], hi);
    }
  }
}

// A query's max over its rows: the affine (|s| at kS2, b at kB2 of aff)
// and ReLU of each column's max (fold_max), then closed across the warp's
// row groups by pool_store's halving butterfly; lane (g, t) stores columns
// 8 nt + 2t, +1, nt = 4 g0 + 2 g1 + g2, of query q (none if q < 0)
__device__ __forceinline__ void close_max(float (&m)[16], const float* aff,
                                          int q, int g, int t,
                                          float* __restrict__ outs,
                                          int stride) {
#pragma unroll
  for (int nt = 0; nt < kC3 / 8; ++nt) {
    const float2 sv = *reinterpret_cast<const float2*>(aff + kS2 + 8 * nt
                                                       + 2 * t);
    const float2 bv = *reinterpret_cast<const float2*>(aff + kB2 + 8 * nt
                                                       + 2 * t);
    m[2 * nt] = relu_affine(m[2 * nt], sv.x, bv.x);
    m[2 * nt + 1] = relu_affine(m[2 * nt + 1], sv.y, bv.y);
  }
  halve<8>(m, g & 1, 4);
  halve<4>(m, (g >> 1) & 1, 8);
  halve<2>(m, (g >> 2) & 1, 16);
  const int nt = 4 * (g & 1) + ((g >> 1) & 1) * 2 + (g >> 2);
  store2(outs, q, stride, 8 * nt + 2 * t, m[0], m[1]);
}

// A k8 step's A operand in 3xTF32 from four floats, split by truncation:
// hi keeps the top 10 mantissa bits of x, lo = x - hi exactly, and the
// tensor cores read lo's top 10 (they ignore a TF32 operand's low 13
// bits).  About 2^-21 of each product is dropped (cvt.rna's split, which
// ptxas expands to ~4 instructions a value, drops 2^-22): two instructions
// a value.
__device__ __forceinline__ tc::Split split_trunc(float a0, float a1,
                                                 float a2, float a3) {
  tc::Split r;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.hi[i] = __float_as_uint(a[i]) & 0xffffe000u;
    r.lo[i] = __float_as_uint(a[i] - __uint_as_float(r.hi[i]));
  }
  return r;
}

// float32: one scale's weights in shared memory as wgmma B tiles (tc_gemm.cuh:
// a k8 step N wide is [N/8][2][8][4] floats), each k8 step's TF32 hi tile
// followed by its lo tile; kL0, kL1, kL2 the floats before each product's
constexpr int kTile32 = 32 * 8, kTile64 = 64 * 8;  // floats of a k8 tile
constexpr int kL0 = 0;                             // 1 step, N = 32
constexpr int kL1 = kL0 + 2 * kTile32;             // 4 steps, N = 32
constexpr int kL2 = kL1 + 4 * 2 * kTile32;         // 4 steps, N = 64
constexpr int kLongFloats = kL2 + 4 * 2 * kTile64;
static_assert(kLongFloats == 2 * 2 * kSlots, "hi and lo of every slot");

// scale s's weights from the packed image (a (b0, b1) pair a mma.sync
// fragment slot: lane (g, t) of k8 step j and n8 tile nt holds (k t, n g)
// and (k t + 4, n g)) into those tiles, split into TF32 hi and lo, and its
// affines (the last scale as |s2|, fold_max); each thread's loads issued
// before its first store, so that they are in flight together
template <int kThreads>
__device__ __forceinline__ void stage_long(const float* __restrict__ image,
                                           int s, float* wt, float* aff) {
  constexpr int kPer = (kSlots + kThreads - 1) / kThreads;
  const float* img = image + (size_t)s * kImage;
  const float2* pairs = reinterpret_cast<const float2*>(img);
  float2 w[kPer];
  float s2[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    w[i] = e < kSlots ? __ldg(pairs + e) : make_float2(0.0f, 0.0f);
    const int f = e - kSlots2;  // a layer-2 slot's column 8 nt + g
    s2[i] = e < kSlots && f >= 0
                ? __ldg(img + 2 * kSlots + kS2 + 8 * (f / 32 % (kC3 / 8)) +
                        f % 32 / 4)
                : 1.0f;
  }
  float av = 0.0f;
  if (threadIdx.x < kAffine) av = __ldg(img + 2 * kSlots + threadIdx.x);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= kSlots) break;
    int f, tiles, at, tile;
    if (e < kSlots1) {
      f = e, tiles = kC1 / 8, at = kL0, tile = kTile32;
    } else if (e < kSlots2) {
      f = e - kSlots1, tiles = kC2 / 8, at = kL1, tile = kTile32;
    } else {
      f = e - kSlots2, tiles = kC3 / 8, at = kL2, tile = kTile64;
    }
    const int lane = f % 32, nt = (f / 32) % tiles, j = f / 32 / tiles;
    float* hi = wt + at + 2 * tile * j;
    float* lo = hi + tile;
    // element (n, p) of a step at ((n/8 * 2 + p/4) * 8 + n%8) * 4 + p%4
    const int o0 = (16 * nt + lane / 4) * 4 + lane % 4, o1 = o0 + 32;
    // a column of negative scale, negated (fold_max)
    const float2 v = s2[i] < 0.0f ? make_float2(-w[i].x, -w[i].y) : w[i];
    const uint32_t h0 = tc::tf32_rna(v.x), h1 = tc::tf32_rna(v.y);
    hi[o0] = __uint_as_float(h0);
    hi[o1] = __uint_as_float(h1);
    lo[o0] = __uint_as_float(tc::tf32_rna(v.x - __uint_as_float(h0)));
    lo[o1] = __uint_as_float(tc::tf32_rna(v.y - __uint_as_float(h1)));
  }
  if (threadIdx.x < kAffine) {
    const int e = threadIdx.x;
    aff[e] = e >= kS2 && e < kB2 ? fabsf(av) : av;
  }
}

// one k8 step's three products into d, small ones first (A's lo by B's hi,
// A's hi by B's lo, then hi by hi); `tile` the step's hi tile (its lo tile
// follows, `lo_at` bytes on); accumulate 0 starts d afresh
template <int M>
__device__ __forceinline__ void mma3_long(float (&d)[M], const tc::Split& a,
                                          uint32_t tile, uint32_t lo_at,
                                          int accumulate) {
  if constexpr (!kLongMma) return;
  if constexpr (M == 16) {
    tc::mma_n32(d, a.lo, tc::desc(tile), accumulate);
    tc::mma_n32(d, a.hi, tc::desc(tile + lo_at), 1);
    tc::mma_n32(d, a.hi, tc::desc(tile), 1);
  } else {
    tc::mma_n64(d, a.lo, tc::desc(tile), accumulate);
    tc::mma_n64(d, a.hi, tc::desc(tile + lo_at), 1);
    tc::mma_n64(d, a.hi, tc::desc(tile), 1);
  }
}

// A product of K = 32 (four k8 steps, A from the previous accumulator x):
// steps 0-1 summed by the tensor cores from zero in d, steps 2-3 in r, then
// d += r on the CUDA cores (tc_gemm.cuh's promote: the tensor cores' sums do not
// round to nearest); `at` the shared address of step 0's hi tile
template <int M>
__device__ __forceinline__ void product32(float (&d)[M], const float (&x)[16],
                                          uint32_t at) {
  constexpr uint32_t kLo = 64 * M;  // bytes of a tile (N = 2M columns)
  constexpr uint32_t kStep = 2 * kLo;  // of a step's hi and lo tiles
  tc::Split a[kC1 / 8];
#pragma unroll
  for (int j = 0; j < kC1 / 8; ++j) {
    a[j] = split_trunc(x[4 * j], x[4 * j + 2], x[4 * j + 1], x[4 * j + 3]);
  }
  float r[M];
  if constexpr (!kLongMma) {
#pragma unroll
    for (int i = 0; i < M; ++i) d[i] = r[i] = 0.0f;
  }
  tc::fence_regs(d);
  tc::fence_regs(r);
  tc::fence();
  mma3_long(d, a[0], at, kLo, 0);
  mma3_long(d, a[1], at + kStep, kLo, 1);
  mma3_long(r, a[2], at + 2 * kStep, kLo, 0);
  mma3_long(r, a[3], at + 3 * kStep, kLo, 1);
  tc::commit();
  tc::wait_all();
  tc::fence_regs(d);
  tc::fence_regs(r);
#pragma unroll
  for (int j = 0; j < kC1 / 8; ++j) fence_split(a[j]);
  tc::promote<0>(d, r);
}

// The three products of one step (64 rows, this warp's 16) from its first
// layer's gathered inputs (ga of row g, gb of row g + 8), folded into m
// (fold_max; first: the query's first unit); `wt` the shared address of the
// tiles
__device__ __forceinline__ void chain_long(float2 ga, float2 gb, uint32_t wt,
                                           const float* aff, int t,
                                           bool first, float (&m)[16]) {
  // layer 0: one k8 step, input channel p at position p
  float x[16];
  {
    tc::Split a = split_trunc(ga.x, gb.x, ga.y, gb.y);
    stamp(1);
    float d[16];
    if constexpr (!kLongMma) {
#pragma unroll
      for (int i = 0; i < 16; ++i) d[i] = 0.0f;
    }
    tc::fence_regs(d);
    tc::fence();
    mma3_long(d, a, wt + 4 * kL0, 4 * kTile32, 0);
    tc::commit();
    tc::wait_all();
    tc::fence_regs(d);
    fence_split(a);
    stamp(2);
    epilogue_tiles(x, d, aff, kS0, kB0, t);
  }
  // layer 1: k8 step j takes x's n8 tile j
  float y[16];
  {
    float d[16];
    product32(d, x, wt + 4 * kL1);
    stamp(3);
    epilogue_tiles(y, d, aff, kS1, kB1, t);
  }
  // layer 2, then its max over the query's rows
  float d[32];
  product32(d, y, wt + 4 * kL2);
  stamp(4);
  fold_max(m, d, first);
}

// Each warp's ring of what a step reads from device memory, copied there
// kAhead steps ahead by cp.async (so no register waits on those loads):
// per lane, kRing slots of kRingInts words: its rows' neighbour indices
// (rows g, g + 8 of the step's unit), and at a query's first unit its
// point's coordinate t and its cloud's centroid's (t < 3; float32 arm).
// Each lane copies and reads its own words: no other lane's copies need be
// visible to it.
constexpr int kAhead = 2;
constexpr int kRing = kAhead + 1;
constexpr int kRingInts = 4;
constexpr int kRingWarpInts = kRing * 32 * kRingInts;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   tc::smem_addr(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A warp's steps: its query in its warpgroup's i-th quad, and the copies
// into its ring.  A step is (i, u): unit u of the query of quad i; the
// kernels walk them with `next`, no division.
struct LongSteps {
  const int* idx;
  int k, units, quad0, groups, warp, total, n;
  int steps;
  __device__ int query(int i) const {
    return 4 * (quad0 + groups * i) + warp;
  }
  __device__ void next(int& i, int& u) const {
    if (++u == units) {
      u = 0;
      ++i;
    }
  }
  // the words of step (i, u) into `slot` (a lane's kRingInts words) if
  // `live`, then one commit (an empty group past the last step, so that
  // waiting for all but the kAhead - 1 most recent groups waits for the
  // step kAhead back): the indices of rows g, g + 8 (rows past K the first
  // neighbour's; a query past the last copies the first query's), and at a
  // query's first unit (with_point) the coordinate t of its point and of
  // its cloud's centroid, t < 3
  __device__ void prefetch(bool live, int i, int u, int* slot, int g, int t,
                           const float* xyz, const float* ctr,
                           bool with_point) const {
    if (live) {
      const int q = query(i);
      const int qq = q < total ? q : 0;
      int k0 = 16 * u + g, k1 = k0 + 8;
      if (k0 >= k) k0 = 0;
      if (k1 >= k) k1 = 0;
      const int* row = idx + (int64_t)qq * k;
      cp_async4(slot, row + k0);
      cp_async4(slot + 1, row + k1);
      if (with_point && u == 0 && t < 3) {
        cp_async4(slot + 2, xyz + (int64_t)qq * 3 + t);
        cp_async4(slot + 3, ctr + (qq / n) * 3 + t);
      }
    }
    cp_async_commit();
  }
};

// the span of the float32 long kernel: each point of the elements a block's
// queries lie in as [x, y, z, f0 .. f4] (features past Cf zero)
constexpr int kPointFloats = kC0;

__device__ __forceinline__ void form_points(const Cloud& c, int b0,
                                            int points, float* pts) {
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    const int b = b0 + i / c.n, j = i % c.n;
    const float* x = c.xyz + ((int64_t)b * c.n + j) * 3;
    const float* f = c.feats + b * c.sb + j * c.sn;
    float v[kPointFloats];
#pragma unroll
    for (int ch = 0; ch < kPointFloats; ++ch) {
      v[ch] = ch < 3 ? __ldg(x + ch)
                     : ch - 3 < c.cf ? __ldg(f + (ch - 3) * c.sc) : 0.0f;
    }
    float4* out = reinterpret_cast<float4*>(pts + i * kPointFloats);
    out[0] = make_float4(v[0], v[1], v[2], v[3]);
    out[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// channels t and t + 4 of a row's first-layer input [xyz[j] - xyz[q],
// feats[j], 0, ...] from the span (jl the neighbour's point in it, -1
// outside [0, N): the centroid with zero features), xq and ctr coordinate t
// of the query's point and of its cloud's centroid (gather's arithmetic)
__device__ __forceinline__ float2 span_input(const float* pts, int jl, int t,
                                             float xq, float ctr) {
  if (jl < 0) return make_float2(t < 3 ? ctr - xq : 0.0f, 0.0f);
  const float* p = pts + jl * kPointFloats;
  return make_float2(t < 3 ? p[t] - xq : p[3], p[t + 4]);
}

// the block's queries [first, last] of its scale s
__device__ __forceinline__ int2 long_block_queries(const Scales& sc, int s,
                                                   int total) {
  const int64_t quads = (total + 3) / 4;
  const int64_t blk = blockIdx.x - sc.block0[s];
  const int64_t end = min((blk + 1) * sc.qpb[s], quads);
  return make_int2((int)(4 * blk * sc.qpb[s]),
                   (int)min(4 * end, (int64_t)total) - 1);
}

// Scales with K > kMaxK (make_scales gives the others no block): each warp
// of a warpgroup one query of each of the warpgroup's quads, its K rows as
// 16-row units one after another (the warpgroup's steps), the max carried in
// registers across them.  A step's indices (and a query's point) come from
// the warp's ring, copied kAhead steps ahead.  kSpan: the block first
// copies every point of the elements its queries lie in (its span) into
// dynamic shared memory, and the rows read their points there; otherwise
// each row gathers its point and features from device memory.
template <bool kSpan>
__global__ void __launch_bounds__(kLongGroups * 128, kLongBlocks)
    mse_long_kernel(Cloud cloud, const float* __restrict__ image,
                    float* __restrict__ out, int total, Scales sc) {
  __shared__ __align__(128) float wt[kLongFloats];
  __shared__ __align__(16) float aff[kAffine];
  __shared__ __align__(16) int ring[kLongGroups * 4 * kRingWarpInts];
  extern __shared__ float pts[];  // kSpan: [points][kPointFloats]

  const int s = block_scale(sc);
  const int n = cloud.n;
  stage_long<kLongGroups * 128>(image, s, wt, aff);
  const int2 span_q = long_block_queries(sc, s, total);
  const int b0 = span_q.x / n;
  if constexpr (kSpan) form_points(cloud, b0, (span_q.y / n - b0 + 1) * n, pts);
  tc::fence_view_async();  // the products read the tiles
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k = sc.k[s], units = (k + 15) / 16;
  const int stride = sc.count * kC3;
  float* __restrict__ outs = out + s * kC3;
  LongSteps ls{sc.idx[s], k, units, 0, kLongGroups, warp, total, n, 0};
  ls.steps = long_quads(sc, s, wg, kLongGroups, total, ls.quad0) * units;
  int* const my = ring + (threadIdx.x / 32) * kRingWarpInts + lane * kRingInts;
  // the ring slots of this step and of the step kAhead ahead
  int* cur = my;
  int* ahead = my;
  auto turn = [&](int*& at) {
    at = at + 32 * kRingInts == my + kRingWarpInts ? my : at + 32 * kRingInts;
  };
  const uint32_t base = tc::smem_addr(wt);

  int pi = 0, pu = 0;  // the step kAhead ahead
#pragma unroll
  for (int f = 0; f < kAhead; ++f) {
    ls.prefetch(f < ls.steps, pi, pu, ahead, g, t, cloud.xyz, cloud.ctr,
                true);
    ls.next(pi, pu);
    turn(ahead);
  }
  float m[16];
  float xq = 0.0f, ctr = 0.0f;  // coordinate t of the query and centroid
  int qb = 0;                   // the query's batch element
  int ci = 0, u = 0;            // this step
  for (int f = 0; f < ls.steps; ++f, ls.next(ci, u), turn(cur)) {
    stamp(0);
    const int q = ls.query(ci);
    cp_async_wait<kAhead - 1>();  // step f's words have landed
    const int ja = cur[0], jb = cur[1];
    if (u == 0) {
      qb = (q < total ? q : 0) / n;
      if (t < 3) {
        xq = __int_as_float(cur[2]);
        ctr = __int_as_float(cur[3]);
      }
    }
    ls.prefetch(f + kAhead < ls.steps, pi, pu, ahead, g, t, cloud.xyz,
                cloud.ctr, true);
    ls.next(pi, pu);
    turn(ahead);
    float2 ga, gb;
    if constexpr (kSpan) {  // (a query past the last reads zero rows)
      const bool in = q < total;
      const int at = (qb - b0) * n;
      ga = span_input(pts, in && ja >= 0 && ja < n ? at + ja : -1, t, xq,
                      ctr);
      gb = span_input(pts, in && jb >= 0 && jb < n ? at + jb : -1, t, xq,
                      ctr);
    } else {
      const int qr = q < total ? q : -1;
      ga = gather(cloud, Row{qr, qb, ja >= 0 && ja < n ? ja : -1}, t);
      gb = gather(cloud, Row{qr, qb, jb >= 0 && jb < n ? jb : -1}, t);
    }
    chain_long(ga, gb, base, aff, t, u == 0, m);
    if (u + 1 == units) close_max(m, aff, q < total ? q : -1, g, t, outs, stride);
    stamp(5);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// the bf16 arm
// ---------------------------------------------------------------------------

// B fragments of one scale, one uint2 (b0, b1: two bf16 each) per
// (product, k16 step, n8 tile, lane): layer 1 (2 x 4), layer 2 (2 x 8)
constexpr int kBf16Slots1 = 8 * 32;
constexpr int kBf16Slots = kBf16Slots1 + 16 * 32;
// floats of one scale in shared memory: w0r [3][kC1], w0f [kMaxFeats][kC1],
// then the affines as kS0 .. kB2
constexpr int kW0r = 0, kW0f = 3 * kC1, kBf16Aff = kW0f + kMaxFeats * kC1;
constexpr int kBf16Floats = kBf16Aff + kAffine;
constexpr int kBf16Warps = 8;
constexpr int kBf16TilesPerWarp = 4;
constexpr int kBf16MinBlocks = 2;  // per SM, for the register budget

struct Bf16Cloud {
  const float* xyz;              // [B*N, 3]
  const unsigned short* feats;   // [B, N, Cf] bf16, strided
  int64_t sb, sn, sc;
  int cf;
  const float* ctr;  // [B, 3], each cloud's mean over all N
  int n;
};

// the weights of every scale where they lie
struct Bf16Weights {
  const float* w0r[kMaxScales];  // [3, kC1] per scale
  const float* w0f[kMaxScales];  // [Cf, kC1] per scale
  const unsigned short* w1;      // [S, kC1, kC2] bf16
  const unsigned short* w2;      // [S, kC2, kC3] bf16
  const float* aff[6];           // s0, b0 [S*kC1], s1, b1, s2, b2
};

// a point of a block's span in shared memory: its bf16 base, kC1 channels
// as pairs (channel 2w in the low half of word w), then its centred point
// (an odd stride, so the rows a warp reads at once rarely share a bank)
constexpr int kPointWords = kC1 / 2 + 3;
constexpr int kBf16SpanPoints = 2048;  // the most points a block forms

// channel cc of a point's folded first layer, in float32 before its one
// rounding to bf16, from its features f and centred point d: f @ w0f as the
// first channel's product then a fused multiply-add per channel, the same
// for d @ w0r, then one add (the order of the plain version's float32
// matmuls, ops/fused.py::make_mse_base)
__device__ __forceinline__ float base_channel(const float* f, const float* d,
                                              int cf, int cc,
                                              const float* fsm) {
  const float* w0r = fsm + kW0r;
  const float* w0f = fsm + kW0f;
  float a = cf > 0 ? __fmul_rn(f[0], w0f[cc]) : 0.0f;
#pragma unroll
  for (int i = 1; i < kMaxFeats; ++i) {
    if (i < cf) a = __fmaf_rn(f[i], w0f[i * kC1 + cc], a);
  }
  float r = __fmul_rn(d[0], w0r[cc]);
  r = __fmaf_rn(d[1], w0r[kC1 + cc], r);
  r = __fmaf_rn(d[2], w0r[2 * kC1 + cc], r);
  return __fadd_rn(a, r);
}

// point j of element b, centred: xyz - ctr (as ops/fused.py::center_xyz)
__device__ __forceinline__ void centred(const Bf16Cloud& c, int b, int j,
                                        float (&d)[3]) {
  const float* x = c.xyz + ((int64_t)b * c.n + j) * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d[i] = __fsub_rn(__ldg(x + i), __ldg(c.ctr + b * 3 + i));
  }
}

// the features of point j of element b, as floats (zero past cf)
__device__ __forceinline__ void features(const Bf16Cloud& c, int b, int j,
                                         float (&f)[kMaxFeats]) {
  const unsigned short* fp = c.feats + b * c.sb + j * c.sn;
#pragma unroll
  for (int i = 0; i < kMaxFeats; ++i) {
    f[i] = i < c.cf ? __uint_as_float((uint32_t)__ldg(fp + i * c.sc) << 16)
                    : 0.0f;
  }
}

// x[4j + 2e + u] = x0 at channel 16j + 8e + 2t + u of the row: its
// neighbour's base (zero outside [0, N)) less the query's offset p @ w0r
// (p its centred point), then the affine and ReLU, in float32; g(w) gives
// word w of the neighbour's base
template <typename BaseWord>
__device__ __forceinline__ void first_layer_bf16(const float (&p)[3],
                                                 BaseWord g, int t,
                                                 const float* fsm,
                                                 float (&x)[8]) {
  const float* w0r = fsm + kW0r;
  const float* aff = fsm + kBf16Aff;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t v = g(8 * j + 4 * e + t);
      const float base[2] = {__uint_as_float(v << 16),
                             __uint_as_float(v & 0xffff0000u)};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = 16 * j + 8 * e + 2 * t + u;
        const float off = fmaf(p[2], w0r[2 * kC1 + cc],
                               fmaf(p[1], w0r[kC1 + cc], p[0] * w0r[cc]));
        x[4 * j + 2 * e + u] =
            relu_affine(base[u] - off, aff[kS0 + cc], aff[kB0 + cc]);
      }
    }
  }
}

// the A of k16 step j from rows g (xa) and g + 8 (xb), each x as
// first_layer_bf16 lays it out, or an accumulator's n8 tiles 2j, 2j + 1
__device__ __forceinline__ void chain_a_bf16(const float* xa, const float* xb,
                                             uint32_t (&a)[4]) {
  a[0] = tc::pack_bf16(xa[0], xa[1]);
  a[1] = tc::pack_bf16(xb[0], xb[1]);
  a[2] = tc::pack_bf16(xa[2], xa[3]);
  a[3] = tc::pack_bf16(xb[2], xb[3]);
}

// the B fragment slot e of one scale's two products: lane (g, t) of k16
// step j and n8 tile nt holds w[k][8 nt + g] at k = 16j + 2t, +1, +8, +9
__device__ __forceinline__ uint2 bf16_slot(const unsigned short* w1,
                                           const unsigned short* w2, int e) {
  const bool second = e >= kBf16Slots1;
  const int f = second ? e - kBf16Slots1 : e;
  const int cout = second ? kC3 : kC2;
  const int lane = f % 32, nt = (f / 32) % (cout / 8), j = f / 32 / (cout / 8);
  const unsigned short* col =
      (second ? w2 : w1) + (16 * j + 2 * (lane % 4)) * cout + 8 * nt + lane / 4;
  return make_uint2(
      (uint32_t)__ldg(col) | (uint32_t)__ldg(col + cout) << 16,
      (uint32_t)__ldg(col + 8 * cout) | (uint32_t)__ldg(col + 9 * cout) << 16);
}

// scale s's float32 weights (w0r, w0f, the affines) into shared memory;
// abs_s2: the last scale as |s2| (the long kernel's, fold_max)
__device__ __forceinline__ void stage_bf16_floats(const Bf16Weights& wt, int s,
                                                  int cf, float* fsm,
                                                  bool abs_s2 = false) {
  const float* w0r = wt.w0r[s];
  const float* w0f = wt.w0f[s];
  for (int e = threadIdx.x; e < 3 * kC1; e += blockDim.x) {
    fsm[kW0r + e] = __ldg(w0r + e);
  }
  for (int e = threadIdx.x; e < cf * kC1; e += blockDim.x) {
    fsm[kW0f + e] = __ldg(w0f + e);
  }
  // s0, b0 (kC1 each), s1, b1 (kC2), s2, b2 (kC3): this scale's part
  for (int e = threadIdx.x; e < kAffine; e += blockDim.x) {
    const int a = e < kS2 ? e / kC1 : 4 + (e - kS2) / kC3;
    const int width = a < 2 ? kC1 : a < 4 ? kC2 : kC3;
    const int col = e < kS2 ? e % kC1 : (e - kS2) % kC3;
    const float v = __ldg(wt.aff[a] + s * width + col);
    fsm[kBf16Aff + e] = abs_s2 && a == 4 ? fabsf(v) : v;
  }
}

// scale s's w1 and w2 as B fragments, and its float32 weights, into
// shared memory
__device__ __forceinline__ void stage_bf16(const Bf16Weights& wt, int s,
                                           int cf, uint2* wsm, float* fsm) {
  const unsigned short* w1 = wt.w1 + (size_t)s * kC1 * kC2;
  const unsigned short* w2 = wt.w2 + (size_t)s * kC2 * kC3;
  for (int e = threadIdx.x; e < kBf16Slots; e += blockDim.x) {
    wsm[e] = bf16_slot(w1, w2, e);
  }
  stage_bf16_floats(wt, s, cf, fsm);
}

// the base and the centred point of the `points` points of the elements
// from b0 on, each point's base rounded to bf16 once, into the span (one
// point a thread at a time)
__device__ __forceinline__ void form_span(const Bf16Cloud& cloud, int b0,
                                          int points, const float* fsm,
                                          uint32_t* span) {
  const int n = cloud.n;
  for (int i = threadIdx.x; i < points; i += blockDim.x) {
    float d[3], f[kMaxFeats];
    centred(cloud, b0 + i / n, i % n, d);
    features(cloud, b0 + i / n, i % n, f);
    uint32_t* row = span + i * kPointWords;
#pragma unroll
    for (int w = 0; w < kC1 / 2; ++w) {
      row[w] = tc::pack_bf16(base_channel(f, d, cloud.cf, 2 * w, fsm),
                             base_channel(f, d, cloud.cf, 2 * w + 1, fsm));
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) row[kC1 / 2 + e] = __float_as_uint(d[e]);
  }
}

// the values a row forms its x0 from, without a span: its neighbour's
// centred point and features, its query's centred point
struct Gathered {
  float d[3], f[kMaxFeats], p[3];
};

__device__ __forceinline__ Gathered gather_bf16(const Bf16Cloud& cloud,
                                                Row row) {
  Gathered v{};
  if (row.q >= 0) {
    centred(cloud, row.b, row.q - row.b * cloud.n, v.p);
    if (row.j >= 0) {
      centred(cloud, row.b, row.j, v.d);
      features(cloud, row.b, row.j, v.f);
    }
  }
  return v;
}

// a row's x0 (first_layer_bf16's layout) from its gathered values, its
// neighbour's base formed and rounded to bf16 here
__device__ __forceinline__ void x0_from_gathered(Row row, const Gathered& v,
                                                 int cf, int t,
                                                 const float* fsm,
                                                 float (&x)[8]) {
  const bool in = row.q >= 0 && row.j >= 0;
  first_layer_bf16(v.p, [&](int w) {
    return in ? tc::pack_bf16(base_channel(v.f, v.d, cf, 2 * w, fsm),
                              base_channel(v.f, v.d, cf, 2 * w + 1, fsm))
              : 0u;
  }, t, fsm, x);
}

// The two bf16 products of one 16-row unit from x0 of rows g (xa) and g + 8
// (xb): the last product's rows g (v0) and g + 8 (v1) as chain_f32 gives
// them.
__device__ __forceinline__ void chain_bf16(const float (&xa)[8],
                                           const float (&xb)[8],
                                           const uint2* wsm, const float* aff,
                                           int lane, int t, float (&v0)[16],
                                           float (&v1)[16]) {
  // layer 1: k16 step j takes channels 16j .. 16j + 15 of x0
  float y[16];
  {
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) chain_a_bf16(xa + 4 * j, xb + 4 * j, a[j]);
#pragma unroll
    for (int nt = 0; nt < kC2 / 8; ++nt) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint2 w = wsm[(j * (kC2 / 8) + nt) * 32 + lane];
        tc::mma_sync_bf16(d, a[j], w.x, w.y);
      }
      epilogue(y + 4 * nt, d, aff, kS1, kB1, 8 * nt + 2 * t);
    }
  }
  // layer 2: k16 step j takes y's n8 tiles 2j, 2j + 1
  {
    uint32_t a[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* yy = y + 8 * j;
      const float ya[4] = {yy[0], yy[1], yy[4], yy[5]};
      const float yb[4] = {yy[2], yy[3], yy[6], yy[7]};
      chain_a_bf16(ya, yb, a[j]);
    }
#pragma unroll
    for (int nt = 0; nt < kC3 / 8; ++nt) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint2 w = wsm[kBf16Slots1 + (j * (kC3 / 8) + nt) * 32 + lane];
        tc::mma_sync_bf16(d, a[j], w.x, w.y);
      }
      float z[4];
      epilogue(z, d, aff, kS2, kB2, 8 * nt + 2 * t);
      v0[2 * nt] = z[0];
      v0[2 * nt + 1] = z[1];
      v1[2 * nt] = z[2];
      v1[2 * nt + 1] = z[3];
    }
  }
}

// the queries [first, last] of the tiles [tile0, tile0 + per_block) of a
// scale with P = 2^lp rows a query
__device__ __host__ __forceinline__ int2 block_queries(int64_t tile0,
                                                       int per_block, int lp,
                                                       int total) {
  const int64_t first = (tile0 * kTileRows) >> lp;
  const int64_t last = ((tile0 + per_block) * kTileRows - 1) >> lp;
  return make_int2((int)first, (int)(last < total - 1 ? last : total - 1));
}

// kSpan: the block first forms the base and the centred point of every
// point of the elements its rows touch (its span, <= kBf16SpanPoints) in
// dynamic shared memory, once a point, and each row reads them there;
// otherwise each row forms its neighbour's base from the points and
// features it gathers, a unit ahead.
template <bool kSpan>
__global__ void __launch_bounds__(kBf16Warps * 32, kBf16MinBlocks)
    mse_bf16_kernel(Bf16Cloud cloud, Bf16Weights wt,
                    float* __restrict__ out,  // [B*N, S*kC3]
                    int total, Scales sc) {
  __shared__ uint2 wsm[kBf16Slots];
  __shared__ __align__(16) float fsm[kBf16Floats];
  extern __shared__ uint32_t span[];  // [points][kPointWords]

  const int s = block_scale(sc);
  stage_bf16(wt, s, cloud.cf, wsm, fsm);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lp = sc.log2p[s], k = sc.k[s], n = cloud.n;
  const int* __restrict__ idx = sc.idx[s];
  const int tiles = ((total << lp) + kTileRows - 1) / kTileRows;
  constexpr int kPerBlock = kBf16Warps * kBf16TilesPerWarp;
  const int tile0 = (blockIdx.x - sc.block0[s]) * kPerBlock;
  const int stride = sc.count * kC3;
  float* __restrict__ outs = out + s * kC3;
  const float* aff = fsm + kBf16Aff;
  constexpr int kUnits = 2 * kBf16TilesPerWarp;

  // the span: the elements [b0, ...] of the block's queries, each point's
  // base rounded to bf16 once
  const int b0 = block_queries(tile0, kPerBlock, lp, total).x / n;
  if constexpr (kSpan) {
    form_span(cloud, b0,
              (block_queries(tile0, kPerBlock, lp, total).y / n - b0 + 1) * n,
              fsm, span);
    __syncthreads();
  }

  // unit u of this warp: the half u % 2 of tile tile0 + warp + (u / 2) *
  // kBf16Warps; its rows g and g + 8 in the scale's row space
  auto row_of = [&](int u, int plus) {
    if (u >= kUnits) return Row{-1, 0, -1};
    const int r = (tile0 + warp + (u >> 1) * kBf16Warps) * kTileRows +
                  16 * (u & 1) + g + plus;
    return unit_row(idx, r, lp, k, total, n);
  };
  // a row's x0 from the span: its query's centred point, its neighbour's
  // base words
  auto x0_span = [&](Row row, float (&x)[8]) {
    float p[3] = {0.0f, 0.0f, 0.0f};
    const uint32_t* q = span + (int64_t)(row.q - b0 * n) * kPointWords;
    const uint32_t* j = span + (int64_t)((row.b - b0) * n + row.j) * kPointWords;
    if (row.q >= 0) {
#pragma unroll
      for (int e = 0; e < 3; ++e) p[e] = __uint_as_float(q[kC1 / 2 + e]);
    }
    const bool in = row.q >= 0 && row.j >= 0;
    first_layer_bf16(p, [&](int w) { return in ? j[w] : 0u; }, t, fsm, x);
  };
  auto gather = [&](Row row) { return gather_bf16(cloud, row); };
  auto x0_gathered = [&](Row row, const Gathered& v, float (&x)[8]) {
    x0_from_gathered(row, v, cloud.cf, t, fsm, x);
  };

  Row ra = row_of(0, 0), rb = row_of(0, 8);
  Row na = row_of(1, 0), nb = row_of(1, 8);
  Gathered va{}, vb{};
  if constexpr (!kSpan) {
    va = gather(ra);
    vb = gather(rb);
  }
  float carry[2];  // P = 32: the first half's max

  for (int u = 0; u < kUnits; ++u) {
    if (tile0 + warp + (u >> 1) * kBf16Warps >= tiles) break;  // warp-uniform
    const int h = u & 1;
    float xa[8], xb[8];
    if constexpr (kSpan) {
      x0_span(ra, xa);
      x0_span(rb, xb);
    } else {
      x0_gathered(ra, va, xa);
      x0_gathered(rb, vb, xb);
      // the next unit's gathers, in flight while this unit's products run
      va = gather(na);
      vb = gather(nb);
    }
    // the indices of the unit after the next
    const Row na2 = row_of(u + 2, 0), nb2 = row_of(u + 2, 8);

    float v0[16], v1[16];
    chain_bf16(xa, xb, wsm, aff, lane, t, v0, v1);
    pool_store(v0, v1, lp, h, g, t, ra.q, rb.q, outs, stride, carry);
    ra = na;
    rb = nb;
    na = na2;
    nb = nb2;
  }
}


// bf16: one scale's w1 and w2 in shared memory as wgmma B tiles (tc_gemm.cuh:
// a k16 step N wide is [N/8][2][8][8] bf16; element (n, p) of step j is
// w[16j + p][n]), w1's two steps then w2's
constexpr int kBf16Tile1 = kC2 * 16, kBf16Tile2 = kC3 * 16;  // bf16 a step
constexpr int kBf16LongTiles = 2 * kBf16Tile1 + 2 * kBf16Tile2;

template <int kThreads>
__device__ __forceinline__ void stage_bf16_long(const Bf16Weights& wt, int s,
                                                int cf, unsigned short* tiles,
                                                float* fsm) {
  // w1 then w2 as 16-byte pieces of 8 consecutive output columns
  constexpr int kPieces1 = kC1 * kC2 / 8, kPieces = kPieces1 + kC2 * kC3 / 8;
  constexpr int kPer = (kPieces + kThreads - 1) / kThreads;
  const uint4* w1 = reinterpret_cast<const uint4*>(wt.w1 + (size_t)s * kC1 *
                                                               kC2);
  const uint4* w2 = reinterpret_cast<const uint4*>(wt.w2 + (size_t)s * kC2 *
                                                               kC3);
  uint4 v[kPer];
  float4 sg[kPer][2];  // a w2 piece's columns' scales (their signs)
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    v[i] = e < kPieces1 ? __ldg(w1 + e)
           : e < kPieces ? __ldg(w2 + (e - kPieces1))
                         : make_uint4(0u, 0u, 0u, 0u);
    sg[i][0] = sg[i][1] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
    if (e >= kPieces1 && e < kPieces) {
      const float4* s2 = reinterpret_cast<const float4*>(
          wt.aff[4] + s * kC3 + 8 * (e - kPieces1) % kC3);
      sg[i][0] = __ldg(s2);
      sg[i][1] = __ldg(s2 + 1);
    }
  }
  stage_bf16_floats(wt, s, cf, fsm, true);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (e >= kPieces) break;
    const bool second = e >= kPieces1;
    const int f = 8 * (second ? e - kPieces1 : e);
    const int cout = second ? kC3 : kC2;
    const int k = f / cout, j = k / 16, p = k % 16;
    unsigned short* tile =
        tiles + (second ? 2 * kBf16Tile1 + j * kBf16Tile2 : j * kBf16Tile1);
    const uint32_t words[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    const float scale[8] = {sg[i][0].x, sg[i][0].y, sg[i][0].z, sg[i][0].w,
                            sg[i][1].x, sg[i][1].y, sg[i][1].z, sg[i][1].w};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = f % cout + c;
      unsigned short h = (unsigned short)(words[c / 2] >> (16 * (c % 2)));
      if (scale[c] < 0.0f) {
        h ^= 0x8000u;  // a column of negative scale, negated (fold_max)
      }
      tile[((n / 8 * 2 + p / 8) * 8 + n % 8) * 8 + p % 8] = h;
    }
  }
}

// x[4j + 2e + u] = x0 at channel cc = 16j + 8e + 2t + u of a row: its
// neighbour's base (`words`, its kC1 / 2 words in the span; null: a zero
// base) less the query's offset off[] at cc, then the affine (sv, bv at
// cc) and ReLU, in float32 (first_layer_bf16's arithmetic, its offset once
// a query)
__device__ __forceinline__ void x0_words(const uint32_t* words, int t,
                                         const float (&off)[8],
                                         const float (&sv)[8],
                                         const float (&bv)[8],
                                         float (&x)[8]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t v = words ? words[8 * j + 4 * e + t] : 0u;
      const float base[2] = {__uint_as_float(v << 16),
                             __uint_as_float(v & 0xffff0000u)};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * j + 2 * e + u;
        x[i] = relu_affine(base[u] - off[i], sv[i], bv[i]);
      }
    }
  }
}

// The bf16 arm's scales with K > kMaxK, in mse_long_kernel's order of work.
// kSpan: the block first forms the base and the centred point of every point
// of the elements its queries lie in (its span) in dynamic shared memory,
// once a point; each row reads its neighbour's base there and each warp its
// query's offset once a query.  Otherwise each row forms its neighbour's
// base from the point and features it gathers, a step ahead.  x0 is formed
// on the CUDA cores; both products (32 -> 32 -> 64) on wgmma m64n32k16 and
// m64n64k16 .bf16 with float32 sums, A from registers: the first product's
// accumulator, after its affine and ReLU, rounded to bf16 is the second's A
// as it lies.
template <bool kSpan>
__global__ void __launch_bounds__(kLongBf16Groups * 128, kLongBf16Blocks)
    mse_bf16_long_kernel(Bf16Cloud cloud, Bf16Weights wt,
                         float* __restrict__ out, int total, Scales sc) {
  __shared__ __align__(128) unsigned short tiles[kBf16LongTiles];
  __shared__ __align__(16) float fsm[kBf16Floats];
  __shared__ __align__(16) int ring[kLongBf16Groups * 4 * kRingWarpInts];
  extern __shared__ uint32_t span[];  // [points][kPointWords]

  const int s = block_scale(sc);
  const int n = cloud.n;
  stage_bf16_long<kLongBf16Groups * 128>(wt, s, cloud.cf, tiles, fsm);
  const int2 span_q = long_block_queries(sc, s, total);
  const int b0 = span_q.x / n;
  if constexpr (kSpan) {
    __syncthreads();  // fsm staged
    form_span(cloud, b0, (span_q.y / n - b0 + 1) * n, fsm, span);
  }
  tc::fence_view_async();  // the products read the tiles
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k = sc.k[s], units = (k + 15) / 16;
  const int stride = sc.count * kC3;
  float* __restrict__ outs = out + s * kC3;
  const float* aff = fsm + kBf16Aff;
  LongSteps ls{sc.idx[s], k, units, 0, kLongBf16Groups, warp, total, n, 0};
  ls.steps = long_quads(sc, s, wg, kLongBf16Groups, total, ls.quad0) * units;
  int* const my = ring + (threadIdx.x / 32) * kRingWarpInts + lane * kRingInts;
  // the ring slots of this step and of the step kAhead ahead
  int* cur = my;
  int* ahead = my;
  auto turn = [&](int*& at) {
    at = at + 32 * kRingInts == my + kRingWarpInts ? my : at + 32 * kRingInts;
  };
  const uint32_t t1 = tc::smem_addr(tiles);
  const uint32_t t2 = t1 + 2 * kBf16Tile1 * (uint32_t)sizeof(unsigned short);
  constexpr uint32_t kStep1 = kBf16Tile1 * sizeof(unsigned short);
  constexpr uint32_t kStep2 = kBf16Tile2 * sizeof(unsigned short);

  // (kSpan) the affine of the lane's x0 channels, and its query's offset
  float sv[8], bv[8], off[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cc = 16 * (i / 4) + 8 * (i / 2 % 2) + 2 * t + i % 2;
    sv[i] = kSpan ? aff[kS0 + cc] : 0.0f;
    bv[i] = kSpan ? aff[kB0 + cc] : 0.0f;
    off[i] = 0.0f;
  }
  int pi = 0, pu = 0;  // the step kAhead ahead
#pragma unroll
  for (int f = 0; f < kAhead; ++f) {
    ls.prefetch(f < ls.steps, pi, pu, ahead, g, t, nullptr, nullptr, false);
    ls.next(pi, pu);
    turn(ahead);
  }
  float m[16];
  int qb = 0;        // the query's batch element
  int ci = 0, u = 0;  // this step
  for (int f = 0; f < ls.steps; ++f, ls.next(ci, u), turn(cur)) {
    stamp(0);
    const int q = ls.query(ci);
    const bool in = q < total;
    cp_async_wait<kAhead - 1>();  // step f's indices have landed
    const int ja = cur[0], jb = cur[1];
    ls.prefetch(f + kAhead < ls.steps, pi, pu, ahead, g, t, nullptr,
                nullptr, false);
    ls.next(pi, pu);
    turn(ahead);
    if (u == 0) qb = (in ? q : 0) / n;
    float xa[8], xb[8];
    if constexpr (kSpan) {
      if (u == 0) {  // a new query: its offset (xyz_q - ctr) @ w0r
        float p[3] = {0.0f, 0.0f, 0.0f};
        if (in) {
          const uint32_t* qp =
              span + (int64_t)(q - b0 * n) * kPointWords + kC1 / 2;
#pragma unroll
          for (int e = 0; e < 3; ++e) p[e] = __uint_as_float(qp[e]);
        }
        const float* w0r = fsm + kW0r;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int cc = 16 * (i / 4) + 8 * (i / 2 % 2) + 2 * t + i % 2;
          off[i] = fmaf(p[2], w0r[2 * kC1 + cc],
                        fmaf(p[1], w0r[kC1 + cc], p[0] * w0r[cc]));
        }
      }
      auto words = [&](int j) {
        return in && j >= 0 && j < n
                   ? span + (int64_t)((qb - b0) * n + j) * kPointWords
                   : nullptr;
      };
      x0_words(words(ja), t, off, sv, bv, xa);
      x0_words(words(jb), t, off, sv, bv, xb);
    } else {
      const int qr = in ? q : -1;
      const Row ra{qr, qb, ja >= 0 && ja < n ? ja : -1};
      const Row rb{qr, qb, jb >= 0 && jb < n ? jb : -1};
      x0_from_gathered(ra, gather_bf16(cloud, ra), cloud.cf, t, fsm, xa);
      x0_from_gathered(rb, gather_bf16(cloud, rb), cloud.cf, t, fsm, xb);
    }

    // layer 1: k16 step j takes channels 16j .. 16j + 15 of x0
    uint32_t a1[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) chain_a_bf16(xa + 4 * j, xb + 4 * j, a1[j]);
    stamp(1);
    float d1[16];
    if constexpr (!kLongMma) {
#pragma unroll
      for (int i = 0; i < 16; ++i) d1[i] = 0.0f;
    }
    tc::fence_regs(d1);
    tc::fence();
    if constexpr (kLongMma) {
      tc::mma_bf16_n32(d1, a1[0], tc::desc(t1), 0);
      tc::mma_bf16_n32(d1, a1[1], tc::desc(t1 + kStep1), 1);
    }
    tc::commit();
    tc::wait_all();
    tc::fence_regs(d1);
    tc::fence_regs(a1);
    stamp(2);
    float y[16];
    epilogue_tiles(y, d1, aff, kS1, kB1, t);

    // layer 2: k16 step j takes y's n8 tiles 2j, 2j + 1
    uint32_t a2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* yy = y + 8 * j;
      const float ya[4] = {yy[0], yy[1], yy[4], yy[5]};
      const float yb[4] = {yy[2], yy[3], yy[6], yy[7]};
      chain_a_bf16(ya, yb, a2[j]);
    }
    float d2[32];
    if constexpr (!kLongMma) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d2[i] = 0.0f;
    }
    tc::fence_regs(d2);
    tc::fence();
    if constexpr (kLongMma) {
      tc::mma_bf16_n64(d2, a2[0], tc::desc(t2), 0);
      tc::mma_bf16_n64(d2, a2[1], tc::desc(t2 + kStep2), 1);
    }
    tc::commit();
    tc::wait_all();
    tc::fence_regs(d2);
    tc::fence_regs(a2);
    stamp(3);
    fold_max(m, d2, u == 0);
    if (u + 1 == units) close_max(m, aff, in ? q : -1, g, t, outs, stride);
    stamp(5);
  }
  cp_async_wait<0>();
}

// fills `scales` for count scales of ks[] neighbours and idx[] indices over
// `total` queries: for the tile kernels (long_scales false) the scales with
// K <= kMaxK, `per_block` 32-row tiles a block; for the long kernels the
// others, qpb[s] quads of four queries a block (ops/fused.py::
// mse_long_plan); a scale of the other kind gets no block.  Returns a
// cudaError_t.
int make_scales(void* const* idx, const int* ks, const int* qpb, int count,
                int total, int per_block, bool long_scales, Scales& scales) {
  scales.count = count;
  scales.block0[0] = 0;
  const int64_t quads = ((int64_t)total + 3) / 4;
  for (int t = 0; t < kMaxScales; ++t) {
    const bool used = t < count;
    const int k = used ? ks[t] : 1;
    if (used && k < 1) return (int)cudaErrorInvalidValue;
    int lp = 0;
    while ((1 << lp) < k) ++lp;
    scales.k[t] = k;
    scales.log2p[t] = lp;
    scales.qpb[t] = 0;
    scales.idx[t] = used ? static_cast<const int*>(idx[t]) : nullptr;
    int64_t blocks = 0;
    if (used && (k > kMaxK) == long_scales) {
      if (long_scales) {
        if (qpb[t] < 1) return (int)cudaErrorInvalidValue;
        scales.qpb[t] = qpb[t];
        blocks = (quads + qpb[t] - 1) / qpb[t];
      } else {
        blocks = ((((int64_t)total << lp) + kTileRows - 1) / kTileRows +
                  per_block - 1) / per_block;
      }
    }
    if (scales.block0[t] + blocks > 0x7fffffff) {
      return (int)cudaErrorInvalidValue;
    }
    scales.block0[t + 1] = scales.block0[t] + (int)blocks;
  }
  return (int)cudaSuccess;
}

// the most points a block of the bf16 long kernel touches (the elements its
// queries lie in, whole)
int64_t long_span_points(const Scales& sc, int total, int n) {
  const int64_t quads = ((int64_t)total + 3) / 4;
  int64_t points = 0;
  for (int t = 0; t < sc.count; ++t) {
    for (int64_t blk = 0; blk < sc.block0[t + 1] - sc.block0[t]; ++blk) {
      const int64_t first = 4 * blk * sc.qpb[t];
      const int64_t end = std::min((blk + 1) * sc.qpb[t], quads);
      const int64_t last = std::min(4 * end, (int64_t)total) - 1;
      points = std::max(points, (last / n - first / n + 1) * n);
    }
  }
  return points;
}

template <typename F>
cudaError_t pick_long(int bf16, int span, F&& f) {
  if (!bf16) return span ? f(mse_long_kernel<true>) : f(mse_long_kernel<false>);
  return span ? f(mse_bf16_long_kernel<true>) : f(mse_bf16_long_kernel<false>);
}

// A long kernel's launch: with a span of `smem` bytes (at least `point`
// bytes for each point a block touches), or without (smem 0)
template <typename Span, typename NoSpan, typename... Args>
int launch_long(Span span_kernel, NoSpan kernel, const Scales& sc, int total,
                int n, int threads, int smem, int point, cudaStream_t st,
                Args... args) {
  const int grid = sc.block0[sc.count];
  if (grid == 0) return (int)cudaSuccess;
  if (smem == 0) {
    kernel<<<grid, threads, 0, st>>>(args...);
    return (int)cudaGetLastError();
  }
  if (long_span_points(sc, total, n) * point > smem) {
    return (int)cudaErrorInvalidValue;  // a block's span would not fit
  }
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, span_kernel);
  if (e == cudaSuccess && attr.sharedSizeBytes + smem > 48 * 1024) {
    e = cudaFuncSetAttribute(span_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  }
  if (e != cudaSuccess) return (int)e;
  span_kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xyz [B,N,3] f32 contiguous; feats [B,N,cf] f32 with element strides
// (sb, sn, sc), cf <= 5; ctr [B,3] the mean of each cloud over all N;
// idx[s] [B,N,ks[s]] int32 (any ks[s] >= 1, count <= 8 scales); qpb[s] the
// quads a block of the long kernel takes of scale s where ks[s] > 32
// (ops/fused.py::mse_long_plan); long_smem the bytes of its span (0: none,
// each row gathers its point; else at least kPointFloats floats for each
// point a block touches); image [count, 3584] from
// ops/fused.py::mse_tc_weights; out [B,N,count*64].  The scales with K <=
// 32 take mse_kernel, the others mse_long_kernel: one launch, or two where
// both kinds are there.  Returns a cudaError_t.
int cmflow_mse(const void* xyz, const void* feats, long long sb, long long sn,
               long long sc, int cf, const void* ctr, void* const* idx,
               const int* ks, int count, const int* qpb, int long_smem,
               const void* image, void* out, int b, int n, void* stream) {
  if (count < 1 || count > kMaxScales || n < 1 || cf < 0 ||
      cf > kMaxFeats || long_smem < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  Scales tile_scales, long_scales;
  int err = make_scales(idx, ks, qpb, count, total, kWarps * kTilesPerWarp,
                        false, tile_scales);
  if (err == (int)cudaSuccess) {
    err = make_scales(idx, ks, qpb, count, total, 0, true, long_scales);
  }
  if (err != (int)cudaSuccess) return err;
  if (total == 0) return (int)cudaSuccess;
  Cloud cloud{static_cast<const float*>(xyz), static_cast<const float*>(feats),
              sb, sn, sc, cf, static_cast<const float*>(ctr), n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_scales.block0[count] > 0) {
    mse_kernel<<<tile_scales.block0[count], kWarps * 32, 0, st>>>(
        cloud, static_cast<const float*>(image), static_cast<float*>(out),
        total, tile_scales);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return launch_long(mse_long_kernel<true>, mse_long_kernel<false>,
                     long_scales, total, n, kLongGroups * 128, long_smem,
                     kPointFloats * (int)sizeof(float), st, cloud,
                     static_cast<const float*>(image),
                     static_cast<float*>(out), total, long_scales);
}

// The bf16 arm (mse_bf16_kernel, and mse_bf16_long_kernel for K > 32): xyz,
// ctr, idx, ks and qpb as cmflow_mse; long_smem the bytes of the long
// kernel's span (0: none, each row forms its own base; else at least
// kPointWords words for each point a block touches); feats [B,N,cf] bf16
// with element strides (sb, sn, sc); per scale s, w0r[s] [3,32] and w0f[s]
// [cf,32] f32; w1 [count,32,32] and w2 [count,32,64] bf16; the affines s0,
// b0 [count*32], s1, b1 [count*32], s2, b2 [count*64] f32 (all contiguous);
// out [B,N,count*64] f32.  Returns a cudaError_t.
int cmflow_mse_bf16(const void* xyz, const void* feats, long long sb,
                    long long sn, long long sc, int cf, const void* ctr,
                    void* const* idx, const int* ks, int count,
                    const int* qpb, int long_smem, void* const* w0r,
                    void* const* w0f, const void* w1, const void* w2,
                    const void* s0, const void* b0, const void* s1,
                    const void* b1, const void* s2, const void* b2,
                    void* out, int b, int n, void* stream) {
  if (count < 1 || count > kMaxScales || n < 1 || cf < 0 ||
      cf > kMaxFeats || long_smem < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  Scales scales, long_scales;
  int err = make_scales(idx, ks, qpb, count, total,
                        kBf16Warps * kBf16TilesPerWarp, false, scales);
  if (err == (int)cudaSuccess) {
    err = make_scales(idx, ks, qpb, count, total, 0, true, long_scales);
  }
  if (err != (int)cudaSuccess) return err;
  if (total == 0) return (int)cudaSuccess;
  const Bf16Cloud cloud{static_cast<const float*>(xyz),
                        static_cast<const unsigned short*>(feats),
                        sb, sn, sc, cf, static_cast<const float*>(ctr), n};
  Bf16Weights wt;
  for (int t = 0; t < kMaxScales; ++t) {
    wt.w0r[t] = t < count ? static_cast<const float*>(w0r[t]) : nullptr;
    wt.w0f[t] = t < count ? static_cast<const float*>(w0f[t]) : nullptr;
  }
  wt.w1 = static_cast<const unsigned short*>(w1);
  wt.w2 = static_cast<const unsigned short*>(w2);
  const void* affs[6] = {s0, b0, s1, b1, s2, b2};
  for (int a = 0; a < 6; ++a) wt.aff[a] = static_cast<const float*>(affs[a]);
  // the most points a block's span holds (the elements its queries
  // touch, whole)
  int64_t points = 0;
  constexpr int kPerBlock = kBf16Warps * kBf16TilesPerWarp;
  for (int t = 0; t < count; ++t) {
    for (int blk = 0; blk < scales.block0[t + 1] - scales.block0[t]; ++blk) {
      const int2 q = block_queries((int64_t)blk * kPerBlock, kPerBlock,
                                   scales.log2p[t], total);
      const int64_t p = (int64_t)(q.y / n - q.x / n + 1) * n;
      if (p > points) points = p;
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scales.block0[count] == 0) {
    // every scale takes the long kernel
  } else if (points <= kBf16SpanPoints) {
    const int smem = (int)points * kPointWords * (int)sizeof(uint32_t);
    if (smem > 48 * 1024 - (int)(sizeof(uint2) * kBf16Slots +
                                 sizeof(float) * kBf16Floats)) {
      const cudaError_t e = cudaFuncSetAttribute(
          mse_bf16_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
    }
    mse_bf16_kernel<true><<<scales.block0[count], kBf16Warps * 32, smem,
                            st>>>(cloud, wt, static_cast<float*>(out), total,
                                  scales);
  } else {
    mse_bf16_kernel<false><<<scales.block0[count], kBf16Warps * 32, 0, st>>>(
        cloud, wt, static_cast<float*>(out), total, scales);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_long(mse_bf16_long_kernel<true>, mse_bf16_long_kernel<false>,
                     long_scales, total, n, kLongBf16Groups * 128, long_smem,
                     kPointWords * (int)sizeof(uint32_t), st, cloud, wt,
                     static_cast<float*>(out), total, long_scales);
}

// The long kernel's static shared memory in bytes (the host's plan counts
// it: ops/fused.py::MSE_LONG_STATIC_SMEM), or -1 on an error; bf16 1 for
// the bf16 arm, span 1 for its instantiation with a span.
int cmflow_mse_long_static_smem(int bf16, int span) {
  cudaFuncAttributes attr;
  const cudaError_t err = pick_long(bf16, span, [&](auto kernel) {
    return cudaFuncGetAttributes(&attr, kernel);
  });
  return err == cudaSuccess ? (int)attr.sharedSizeBytes : -1;
}

// Blocks of the long kernel an SM holds at `smem` bytes of dynamic shared
// memory (the card's own count: registers and shared memory), or -1.
int cmflow_mse_long_occupancy(int bf16, int span, int smem) {
  int blocks = -1;
  const int threads = (bf16 ? kLongBf16Groups : kLongGroups) * 128;
  const cudaError_t err = pick_long(bf16, span, [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         threads, smem);
  });
  return err == cudaSuccess ? blocks : -1;
}

#ifdef MSE_LONG_TIMELINE
// block 0's stamps of the last launch (pairs of cycle counter and mark) into
// `host`, at most n pairs; returns how many, and clears them
int cmflow_mse_long_timeline(long long* host, int n) {
  int count = 0;
  cudaMemcpyFromSymbol(&count, g_stamp_count, sizeof(int));
  count = count < n ? count : n;
  if (host) cudaMemcpyFromSymbol(host, g_stamps, 2 * sizeof(long long) * count);
  const int zero = 0;
  cudaMemcpyToSymbol(g_stamp_count, &zero, sizeof(int));
  return count;
}
#endif

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
