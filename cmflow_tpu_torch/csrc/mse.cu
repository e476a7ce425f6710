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
// shuffles that 16 warps per SM do not hide (PERF.md).
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
// fused.py:290-293, :348, :351): the first layer comes folded and rounded
// to bf16 outside, one rounding per point, as a [B*N, S*32] base (the
// wrapper builds it, ops/fused.py::make_mse_base), so each thread gathers
// its eight channels of that row (four 4-byte loads), subtracts the query's
// offset xyz_c[i] @ w0r_s in float32, applies the affine and ReLU, and
// rounds to bf16: the A of the 32 -> 32 product's two k16 steps.  Both
// products (32 -> 32 -> 64) run on mma.sync m16n8k16 .bf16 with float32
// sums, each activation rounded to nearest even before; then the same
// padding, tiles, butterfly max and stores as the float32 arm.  Its weights
// come as a bf16 image of B fragments (6 KB a scale) and a float32 image of
// w0r and the affines (ops/fused.py::mse_bf16_weights), staged in shared
// memory as they are.  What bounds it: operations, 3,072 multiply-adds a
// row, ~1.5 us at the dense bf16 peak at B=16, N=256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_gemm.cuh"

namespace {

namespace tc = cmflow::tc;

constexpr int kC0 = 8;    // first layer inputs: dx, dy, dz, Cf features, 0
constexpr int kC1 = 32;
constexpr int kC2 = 32;
constexpr int kC3 = 64;
constexpr int kMaxFeats = kC0 - 3;
constexpr int kMaxScales = 8;
constexpr int kMaxK = 32;
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

__global__ void __launch_bounds__(kWarps * 32, 2)
    mse_kernel(Cloud cloud, const float* __restrict__ image,  // [S, kImage]
               float* __restrict__ out,                      // [B*N, S*kC3]
               int total, Scales sc) {
  __shared__ float4 wsm[kSlots];
  __shared__ __align__(16) float aff[kAffine];

  int s = 0;
  while (s + 1 < sc.count && (int)blockIdx.x >= sc.block0[s + 1]) ++s;
  {
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
    float v0[16], v1[16];
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

    pool_store(v0, v1, lp, h, g, t, ra.q, rb.q, outs, stride, carry);
    ra = na;
    rb = nb;
  }
}

// ---------------------------------------------------------------------------
// the bf16 arm
// ---------------------------------------------------------------------------

// B fragments of one scale, one uint2 (b0, b1: two bf16 each) per
// (product, k16 step, n8 tile, lane): layer 1 (2 x 4), layer 2 (2 x 8)
constexpr int kBf16Slots1 = 8 * 32;
constexpr int kBf16Slots = kBf16Slots1 + 16 * 32;
// floats of one scale: w0r [3][kC1], then the affines as kS0 .. kB2
constexpr int kW0r = 0, kBf16Aff = 3 * kC1;
constexpr int kBf16Floats = kBf16Aff + kAffine;
static_assert(4 * kBf16Slots == 3072, "ops/fused.py::MSE_BF16_IMAGE");
static_assert(kBf16Floats == 352, "ops/fused.py::MSE_BF16_AFFINE");

struct Bf16Cloud {
  const uint32_t* base;  // [B*N, S*kC1] bf16, as pairs
  const float* xyz;      // [B*N, 3], centred
  int n, pairs;          // points per element, bf16 pairs per base row
};

// x[4j + 2e + u] = x0 at channel 16j + 8e + 2t + u of the row: the base
// (zero outside [0, N)) less the query's offset xyz_c[q] @ w0r, then the
// affine and ReLU, in float32
__device__ __forceinline__ void first_layer_bf16(const Bf16Cloud& c, Row row,
                                                 int s, int t,
                                                 const float* fsm,
                                                 float (&x)[8]) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  const uint32_t* src = nullptr;
  if (row.q >= 0) {
    p0 = __ldg(c.xyz + (int64_t)row.q * 3);
    p1 = __ldg(c.xyz + (int64_t)row.q * 3 + 1);
    p2 = __ldg(c.xyz + (int64_t)row.q * 3 + 2);
    if (row.j >= 0) {
      src = c.base + ((int64_t)row.b * c.n + row.j) * c.pairs + s * kC1 / 2;
    }
  }
  const float* w0r = fsm + kW0r;
  const float* aff = fsm + kBf16Aff;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = 16 * j + 8 * e + 2 * t;
      const uint32_t v = src ? __ldg(src + ch / 2) : 0u;
      const float g[2] = {__uint_as_float(v << 16),
                          __uint_as_float(v & 0xffff0000u)};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = ch + u;
        const float off = fmaf(p2, w0r[2 * kC1 + cc],
                               fmaf(p1, w0r[kC1 + cc], p0 * w0r[cc]));
        x[4 * j + 2 * e + u] =
            relu_affine(g[u] - off, aff[kS0 + cc], aff[kB0 + cc]);
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

__global__ void __launch_bounds__(kWarps * 32, 2)
    mse_bf16_kernel(Bf16Cloud cloud,
                    const uint2* __restrict__ frags,   // [S, kBf16Slots]
                    const float* __restrict__ floats,  // [S, kBf16Floats]
                    float* __restrict__ out,           // [B*N, S*kC3]
                    int total, Scales sc) {
  __shared__ uint2 wsm[kBf16Slots];
  __shared__ __align__(16) float fsm[kBf16Floats];

  int s = 0;
  while (s + 1 < sc.count && (int)blockIdx.x >= sc.block0[s + 1]) ++s;
  for (int e = threadIdx.x; e < kBf16Slots; e += blockDim.x) {
    wsm[e] = __ldg(frags + (size_t)s * kBf16Slots + e);
  }
  for (int e = threadIdx.x; e < kBf16Floats; e += blockDim.x) {
    fsm[e] = __ldg(floats + (size_t)s * kBf16Floats + e);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lp = sc.log2p[s], k = sc.k[s];
  const int* __restrict__ idx = sc.idx[s];
  const int tiles = ((total << lp) + kTileRows - 1) / kTileRows;
  const int tile0 = (blockIdx.x - sc.block0[s]) * kWarps * kTilesPerWarp;
  const int stride = sc.count * kC3;
  float* __restrict__ outs = out + s * kC3;
  const float* aff = fsm + kBf16Aff;

  auto first_row = [&](int u) {
    return (tile0 + warp + (u >> 1) * kWarps) * kTileRows + 16 * (u & 1) + g;
  };
  Row ra = unit_row(idx, first_row(0), lp, k, total, cloud.n);
  Row rb = unit_row(idx, first_row(0) + 8, lp, k, total, cloud.n);
  float carry[2];  // P = 32: the first half's max

  for (int u = 0; u < 2 * kTilesPerWarp; ++u) {
    if (tile0 + warp + (u >> 1) * kWarps >= tiles) break;  // warp-uniform
    const int h = u & 1;
    float xa[8], xb[8];
    first_layer_bf16(cloud, ra, s, t, fsm, xa);
    first_layer_bf16(cloud, rb, s, t, fsm, xb);
    Row na{-1, 0, -1}, nb{-1, 0, -1};
    if (u + 1 < 2 * kTilesPerWarp) {
      na = unit_row(idx, first_row(u + 1), lp, k, total, cloud.n);
      nb = unit_row(idx, first_row(u + 1) + 8, lp, k, total, cloud.n);
    }

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
    float v0[16], v1[16];
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
    pool_store(v0, v1, lp, h, g, t, ra.q, rb.q, outs, stride, carry);
    ra = na;
    rb = nb;
  }
}

// fills `scales` for count scales of ks[] neighbours and idx[] indices over
// `total` queries; returns a cudaError_t
int make_scales(void* const* idx, const int* ks, int count, int total,
                Scales& scales) {
  scales.count = count;
  scales.block0[0] = 0;
  for (int t = 0; t < kMaxScales; ++t) {
    const bool used = t < count;
    const int k = used ? ks[t] : 1;
    if (used && (k < 1 || k > kMaxK)) return (int)cudaErrorInvalidValue;
    int lp = 0;
    while ((1 << lp) < k) ++lp;
    scales.k[t] = k;
    scales.log2p[t] = lp;
    scales.idx[t] = used ? static_cast<const int*>(idx[t]) : nullptr;
    const int64_t tiles = (((int64_t)total << lp) + kTileRows - 1) / kTileRows;
    const int64_t blocks =
        used ? (tiles + kWarps * kTilesPerWarp - 1) / (kWarps * kTilesPerWarp)
             : 0;
    if (scales.block0[t] + blocks > 0x7fffffff) {
      return (int)cudaErrorInvalidValue;
    }
    scales.block0[t + 1] = scales.block0[t] + (int)blocks;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// xyz [B,N,3] f32 contiguous; feats [B,N,cf] f32 with element strides
// (sb, sn, sc), cf <= 5; ctr [B,3] the mean of each cloud over all N;
// idx[s] [B,N,ks[s]] int32 (1 <= ks[s] <= 32, count <= 8 scales); image
// [count, 3584] from ops/fused.py::mse_tc_weights; out [B,N,count*64].
// Returns a cudaError_t.
int cmflow_mse(const void* xyz, const void* feats, long long sb, long long sn,
               long long sc, int cf, const void* ctr, void* const* idx,
               const int* ks, int count, const void* image, void* out, int b,
               int n, void* stream) {
  if (count < 1 || count > kMaxScales || n < 1 || cf < 0 ||
      cf > kMaxFeats) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  Scales scales;
  const int err = make_scales(idx, ks, count, total, scales);
  if (err != (int)cudaSuccess) return err;
  if (total == 0) return (int)cudaSuccess;
  Cloud cloud{static_cast<const float*>(xyz), static_cast<const float*>(feats),
              sb, sn, sc, cf, static_cast<const float*>(ctr), n};
  mse_kernel<<<scales.block0[count], kWarps * 32, 0,
               static_cast<cudaStream_t>(stream)>>>(
      cloud, static_cast<const float*>(image), static_cast<float*>(out),
      total, scales);
  return (int)cudaGetLastError();
}

// The bf16 arm: base [B,N,count*32] bf16, each scale's folded first layer
// (ops/fused.py::make_mse_base); xyz [B,N,3] f32 centred; idx and ks as
// cmflow_mse; frags [count, 3072] bf16 and floats [count, 352] f32 from
// ops/fused.py::mse_bf16_weights; out [B,N,count*64] f32.  Returns a
// cudaError_t.
int cmflow_mse_bf16(const void* base, const void* xyz, void* const* idx,
                    const int* ks, int count, const void* frags,
                    const void* floats, void* out, int b, int n,
                    void* stream) {
  if (count < 1 || count > kMaxScales || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int total = b * n;
  Scales scales;
  const int err = make_scales(idx, ks, count, total, scales);
  if (err != (int)cudaSuccess) return err;
  if (total == 0) return (int)cudaSuccess;
  const Bf16Cloud cloud{static_cast<const uint32_t*>(base),
                        static_cast<const float*>(xyz), n, count * kC1 / 2};
  mse_bf16_kernel<<<scales.block0[count], kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      cloud, static_cast<const uint2*>(frags),
      static_cast<const float*>(floats), static_cast<float*>(out), total,
      scales);
  return (int)cudaGetLastError();
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
