// The width-generic arms of the fused serving kernels, for Hopper (sm_90a):
// one "grouped chain" kernel for every shape the tuned kernels (mse.cu,
// plf.cu, cost_volume.cu) are not written for.
//
// Replaces, at any widths, the Pallas TPU kernels of
// cmflow_tpu/ops/fused.py: _mse_kernel (K3, called by
// fused_multi_scale_encoder) and _plf_kernel (K5, fused_point_local_feature)
// as Kind kMax; _cv_kernel (K4a) as kP2p and _cv_agg_kernel (K4b) as kAgg,
// both called by fused_cost_volume.  For each query i and each of its K
// neighbours j = idx[i, k] (one row per pair):
//   kMax: x0 = ReLU((base[j] - xyz_c[i] @ wrel) * s0 + b0)
//         x_{l+1} = ReLU((x_l @ W_l) * s_l + b_l), L >= 0 layers
//         out[i] = max over k of x_L
//   kP2p: x0 = LeakyReLU(f1c[i] + f2c[j] + b0)
//         x_{l+1} = LeakyReLU(x_l @ W_l + b_l)
//         out[i] = sum over k (ascending) of WeightNet(z2[j] - z1[i]) * x_L
//   kAgg: x0 = p2p[j], no layers, out[i] = sum over k of
//         WeightNet(zq[j] - zq[i]) * x0
// with the WeightNet after its first product, (d + b0) -> ReLU -> 8x8 ->
// ReLU -> 8xC -> ReLU, its hidden width 8 fixed as in the JAX package.
// K3's route folds each scale's first layer into a base outside (as the JAX
// package's make_mse_base does) and launches this kernel once a scale.  A
// neighbour index outside [0, N) stands for a zero row.
//
// bf16 (T = __nv_bfloat16, the JAX kernels' bf16 serving mode): the base,
// f1c/f2c, p2p and the Dense weights come in bf16; the offset, the affines,
// the activations and the WeightNet stay float32; each activation is
// rounded to bf16 (nearest even) before the product it feeds, each product
// of two bf16 values is exact in float32 and the sums are float32
// (ops/fused.py::_mm); kP2p stores its sum rounded to bf16 once.
//
// What bounds it: operations, 2 * rows * sum(cin * cout) (and 16 + 2 * C
// per row for the WeightNet); at the widths the tuned kernels take the
// tensor cores do the same work 5-10x faster, which is why they stay.
// Design, simple first: a block of 256 threads takes a tile of 32 rows made
// of whole queries (32 / K of them), or one query whose K rows run over
// consecutive tiles, the max or sum carried in shared memory.  The tile's
// activations sit in shared memory, two buffers [32][width] used in turn
// (in device scratch, the same code through generic pointers, where they
// do not fit); each layer's weights stream through a shared-memory slab of
// 32 input channels by 128 output columns, each thread a 4 x 4 block of
// the product in float32 FMAs (k ascending).  No atomics: two launches give
// the same bits.  Every tile reads each layer's weights once from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;     // rows of a tile: 8 row groups x 4
constexpr int kCols = 128;    // output columns of a pass: 32 threads x 4
constexpr int kSlab = 32;     // input channels of a weight slab
constexpr int kH = 8;         // WeightNet hidden width
constexpr int kMaxLayers = 32;
constexpr int kScratchBlocks = 528;  // blocks of a launch in scratch mode
constexpr int kMaxSmem = 232448;     // a block's shared memory (opt-in)
// the kernel's static shared memory (row_q, row_j, row_xyz), which the
// dynamic block shares kMaxSmem with
constexpr int kStaticSmem =
    kRows * (sizeof(int) + sizeof(int64_t) + 3 * sizeof(float));
constexpr int kMaxDynSmem = kMaxSmem - kStaticSmem;

enum Kind { kMax = 0, kP2p = 1, kAgg = 2 };

struct Layer {
  const void* w;   // [cin, cout] T
  const float* s;  // [cout] (kMax), or nullptr
  const float* b;  // [cout]
  int cin, cout;
};

struct Params {
  const int* idx;  // [B*N, k]
  int n, k;
  int64_t total;
  const void* src;      // kMax: base; kP2p: f2c; kAgg: p2p; [B*N, src_stride]
  int64_t src_stride;
  const void* f1c;      // kP2p: [B*N, src_stride]
  const float* xyz;     // kMax: centred points [B*N, 3]
  const float* wrel;    // kMax: [3, c0]
  const float* s0;      // kMax: the first affine's scale
  const float* b0;      // kMax: its bias; kP2p: the first bias
  int c0;
  int layers;
  Layer layer[kMaxLayers];
  const float* z1;      // kP2p: z1 (queries); kAgg: zq  [B*N, 8]
  const float* z2;      // kP2p: z2 (neighbours); kAgg: zq
  const float* wb0;     // the WeightNet after its first product
  const float* ww1;
  const float* wb1;
  const float* ww2;     // [8, c_last]
  const float* wb2;
  void* out;            // [B*N, out_stride]: T (kP2p) or float32
  int64_t out_stride;
  int xw, yw;           // widths of the two activation buffers
  float* scratch;       // device scratch, or nullptr (shared memory)
};

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ float operand(float v) {  // a product's input
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
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

// the WeightNet's two 8-wide layers: h = ReLU(ReLU(d + b0) @ w1 + b1)
__device__ __forceinline__ void weightnet_hidden(const float (&d)[kH],
                                                 const Params& p,
                                                 float (&h)[kH]) {
  float a[kH];
#pragma unroll
  for (int m = 0; m < kH; ++m) a[m] = fmaxf(d[m] + __ldg(p.wb0 + m), 0.0f);
#pragma unroll
  for (int o = 0; o < kH; ++o) {
    float t = 0.0f;
#pragma unroll
    for (int m = 0; m < kH; ++m) t = fmaf(a[m], __ldg(p.ww1 + m * kH + o), t);
    h[o] = fmaxf(t + __ldg(p.wb1 + o), 0.0f);
  }
}

// one layer's product for the tile: out[r][c] = act(in[r] . W[:, c]), each
// thread rows ty + 8i (i < 4) and columns cc + 4 tx .. +3 of each pass
template <Kind K, typename T>
__device__ __forceinline__ void layer_product(const Layer& L,
                                              const float* in, int inw,
                                              float* out, int outw,
                                              float* slab, bool round_out) {
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const T* w = static_cast<const T*>(L.w);
  for (int cc = 0; cc < L.cout; cc += kCols) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < L.cin; k0 += kSlab) {
      __syncthreads();  // the last slab is read, the input written
      for (int e = tid; e < kSlab * kCols; e += kThreads) {
        const int kk = e / kCols, c = e % kCols;
        slab[e] = k0 + kk < L.cin && cc + c < L.cout
                      ? load(w, (int64_t)(k0 + kk) * L.cout + cc + c)
                      : 0.0f;
      }
      __syncthreads();
      const int kn = min(kSlab, L.cin - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float4 b = reinterpret_cast<const float4*>(slab + kk * kCols)[tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = in[(ty + 8 * i) * inw + k0 + kk];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cc + 4 * tx + j;
      if (c >= L.cout) continue;
      const float bias = __ldg(L.b + c);
      const float scale = K == kMax ? __ldg(L.s + c) : 1.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = K == kMax ? fmaxf(fmaf(acc[i][j], scale, bias), 0.0f)
                            : leaky(acc[i][j] + bias);
        if (round_out) v = operand<T>(v);
        out[(ty + 8 * i) * outw + c] = v;
      }
    }
  }
}

template <Kind K, typename T>
__global__ void __launch_bounds__(kThreads)
    chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  // slab [kSlab * kCols], hidden [kRows][kH], carry [c_last], then (in
  // shared-memory mode) the activations X [kRows][xw] and Y [kRows][yw]
  float* slab = smem;
  float* hid = slab + kSlab * kCols;
  const int c_last = p.layers ? p.layer[p.layers - 1].cout : p.c0;
  float* carry = hid + kRows * kH;
  float* acts = carry + ((c_last + 3) & ~3);
  if (p.scratch) {
    acts = p.scratch + (int64_t)blockIdx.x * kRows * (p.xw + p.yw);
  }
  float* xs = acts;
  float* ys = acts + kRows * p.xw;
  __shared__ int row_q[kRows];      // the row's query, or -1
  __shared__ int64_t row_j[kRows];  // its neighbour's row, or -1
  __shared__ float row_xyz[kRows][3];
  static_assert(sizeof(row_q) + sizeof(row_j) + sizeof(row_xyz) ==
                    kStaticSmem,
                "kStaticSmem counts the static shared memory");

  const int tid = threadIdx.x;
  const int k = p.k;
  const int qpt = k <= kRows ? kRows / k : 1;  // whole queries of a tile
  const int rows = qpt * k;
  const int tiles = (rows + kRows - 1) / kRows;
  const int64_t works = (p.total + qpt - 1) / qpt;
  const T* src = static_cast<const T*>(p.src);
  const T* f1c = static_cast<const T*>(p.f1c);

  for (int64_t wk = blockIdx.x; wk < works; wk += gridDim.x) {
    const int64_t q0 = wk * qpt;
    for (int tile = 0; tile < tiles; ++tile) {
      __syncthreads();  // the last tile's rows, activations and carry read
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
        if constexpr (K == kMax) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            row_xyz[tid][a] = qq >= 0 ? __ldg(p.xyz + (q0 + qq) * 3 + a)
                                      : 0.0f;
          }
        } else {
          // the WeightNet's hidden layer of the row
          float d[kH], h[kH];
#pragma unroll
          for (int m = 0; m < kH; ++m) {
            d[m] = (j >= 0 ? __ldg(p.z2 + j * kH + m) : 0.0f) -
                   (qq >= 0 ? __ldg(p.z1 + (q0 + qq) * kH + m) : 0.0f);
          }
          weightnet_hidden(d, p, h);
#pragma unroll
          for (int m = 0; m < kH; ++m) hid[tid * kH + m] = h[m];
        }
      }
      __syncthreads();

      // x0 of the tile's rows (zero for a row of no query)
      const bool round0 = p.layers > 0;
      for (int e = tid; e < kRows * p.c0; e += kThreads) {
        const int r = e / p.c0, c = e % p.c0;
        const int qq = row_q[r];
        const int64_t j = row_j[r];
        float v = 0.0f;
        if (qq >= 0) {
          const float g = j >= 0 ? load(src, j * p.src_stride + c) : 0.0f;
          if constexpr (K == kMax) {
            const float off =
                fmaf(row_xyz[r][2], __ldg(p.wrel + 2 * p.c0 + c),
                     fmaf(row_xyz[r][1], __ldg(p.wrel + p.c0 + c),
                          row_xyz[r][0] * __ldg(p.wrel + c)));
            v = fmaxf(fmaf(g - off, __ldg(p.s0 + c), __ldg(p.b0 + c)), 0.0f);
          } else if constexpr (K == kP2p) {
            v = leaky((load(f1c, (q0 + qq) * p.src_stride + c) + g) +
                      __ldg(p.b0 + c));
          } else {
            v = g;
          }
          if (round0) v = operand<T>(v);
        }
        xs[r * p.xw + c] = v;
      }

      // the layers, X -> Y -> X ...
      float* cur = xs;
      int curw = p.xw;
      for (int l = 0; l < p.layers; ++l) {
        float* nxt = cur == xs ? ys : xs;
        const int nxtw = cur == xs ? p.yw : p.xw;
        layer_product<K, T>(p.layer[l], cur, curw, nxt, nxtw, slab,
                            l + 1 < p.layers);
        cur = nxt;
        curw = nxtw;
      }
      __syncthreads();

      // each (query, column) of the tile: its rows' max or weighted sum,
      // k ascending, on from the carry of the tiles before
      for (int e = tid; e < qpt * c_last; e += kThreads) {
        const int qi = e / c_last, c = e % c_last;
        const int64_t q = q0 + qi;
        if (q >= p.total) continue;
        const int lo = max(qi * k, tile * kRows);
        const int hi = min(qi * k + k, (tile + 1) * kRows);
        if constexpr (K == kMax) {
          float m = tile == 0 ? -INFINITY : carry[c];
          for (int rg = lo; rg < hi; ++rg) {
            m = fmaxf(m, cur[(rg - tile * kRows) * curw + c]);
          }
          if (tile + 1 == tiles) {
            store(static_cast<float*>(p.out), q * p.out_stride + c, m);
          } else {
            carry[c] = m;
          }
        } else {
          float w2[kH];
#pragma unroll
          for (int m = 0; m < kH; ++m) w2[m] = __ldg(p.ww2 + m * c_last + c);
          const float b2 = __ldg(p.wb2 + c);
          float s = tile == 0 ? 0.0f : carry[c];
          for (int rg = lo; rg < hi; ++rg) {
            const int r = rg - tile * kRows;
            float t = 0.0f;
#pragma unroll
            for (int m = 0; m < kH; ++m) t = fmaf(hid[r * kH + m], w2[m], t);
            const float w = fmaxf(t + b2, 0.0f);
            s = fmaf(w, cur[r * curw + c], s);
          }
          if (tile + 1 < tiles) {
            carry[c] = s;
          } else if constexpr (K == kP2p) {
            store(static_cast<T*>(p.out), q * p.out_stride + c, s);
          } else {
            store(static_cast<float*>(p.out), q * p.out_stride + c, s);
          }
        }
      }
    }
  }
}

// a launch's shapes: the activation buffers' widths (X takes x0 and the
// odd layers' outputs, Y the even layers'), bytes of dynamic shared memory,
// the activations' device scratch in floats (0 where they fit in shared
// memory), and the grid
struct Plan {
  int xw, yw;
  int smem;
  int64_t scratch;
  int64_t grid;
};

Plan plan(int c0, int layers, const int* widths, int64_t total, int k) {
  Plan out;
  out.xw = c0;
  out.yw = 0;
  for (int l = 0; l < layers; ++l) {
    int& width = l % 2 == 0 ? out.yw : out.xw;
    width = widths[l] > width ? widths[l] : width;
  }
  const int c_last = layers ? widths[layers - 1] : c0;
  const int64_t fixed =
      4 * ((int64_t)kSlab * kCols + kRows * kH + ((c_last + 3) & ~3));
  const int64_t acts = 4 * (int64_t)kRows * (out.xw + out.yw);
  const int qpt = k <= kRows ? kRows / k : 1;
  const int64_t works = (total + qpt - 1) / qpt;
  if (fixed + acts <= kMaxDynSmem) {
    out.smem = (int)(fixed + acts);
    out.scratch = 0;
    out.grid = works < 0x7fffffff ? works : 0x7fffffff;
  } else {
    out.smem = (int)fixed;
    out.grid = works < kScratchBlocks ? works : kScratchBlocks;
    out.scratch = out.grid * kRows * (int64_t)(out.xw + out.yw);
  }
  return out;
}

template <Kind K, typename T>
int launch(const Params& p, const Plan& pl, void* stream) {
  auto kernel = chain_kernel<K, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)pl.grid, kThreads, pl.smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of device scratch a cmflow_chain launch at these shapes needs (0:
// none), or -1 for shapes it does not take.  widths[l] is layer l's output
// width.
long long cmflow_chain_scratch(int c0, int layers, const int* widths,
                               long long total, int k) {
  if (c0 < 1 || layers < 0 || layers > kMaxLayers || k < 1 || total < 0) {
    return -1;
  }
  for (int l = 0; l < layers; ++l) {
    if (widths[l] < 1) return -1;
  }
  const Plan pl = plan(c0, layers, widths, total, k);
  if (pl.smem > kMaxDynSmem) return -1;  // the carry alone does not fit
  return pl.scratch;
}

// kind 0 (max, K3 and K5), 1 (point-to-patch, K4a), 2 (patch-to-patch,
// K4b); bf16 1 for the bf16 arm.  idx [B,N,k] int32; src the gathered rows
// (base, f2c or p2p) with row stride src_stride (elements) and f1c with the
// same (kind 1); xyz [B,N,3] centred, wrel [3,c0], s0, b0 [c0] (kind 0; b0
// the first bias for kind 1); per layer l, w[l] [in, widths[l]] T, s[l]
// (kind 0) and bias[l] [widths[l]]; z1, z2 [B,N,8] and the WeightNet after
// its first product wb0 [8], ww1 [8,8], wb1 [8], ww2 [8,C], wb2 [C] (kinds
// 1, 2); out [B,N] rows of out_stride elements (T for kind 1, else
// float32); scratch as cmflow_chain_scratch sizes it.  Returns a
// cudaError_t.
int cmflow_chain(int kind, int bf16, const void* idx, int b, int n, int k,
                 const void* src, long long src_stride, const void* f1c,
                 const void* xyz, const void* wrel, const void* s0,
                 const void* b0, int c0, int layers, void* const* w,
                 void* const* s, void* const* bias, const int* widths,
                 const void* z1, const void* z2, const void* wb0,
                 const void* ww1, const void* wb1, const void* ww2,
                 const void* wb2, void* out, long long out_stride,
                 void* scratch, void* stream) {
  const long long total = (long long)b * n;
  if (kind < 0 || kind > 2 || n < 1 || b < 0 ||
      cmflow_chain_scratch(c0, layers, widths, total, k) < 0 ||
      (kind == 2 && layers != 0)) {
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
  p.f1c = f1c;
  p.xyz = static_cast<const float*>(xyz);
  p.wrel = static_cast<const float*>(wrel);
  p.s0 = static_cast<const float*>(s0);
  p.b0 = static_cast<const float*>(b0);
  p.c0 = c0;
  p.layers = layers;
  int cin = c0;
  for (int l = 0; l < layers; ++l) {
    p.layer[l] = Layer{w[l], static_cast<const float*>(s ? s[l] : nullptr),
                       static_cast<const float*>(bias[l]), cin, widths[l]};
    cin = widths[l];
  }
  p.z1 = static_cast<const float*>(z1);
  p.z2 = static_cast<const float*>(z2);
  p.wb0 = static_cast<const float*>(wb0);
  p.ww1 = static_cast<const float*>(ww1);
  p.wb1 = static_cast<const float*>(wb1);
  p.ww2 = static_cast<const float*>(ww2);
  p.wb2 = static_cast<const float*>(wb2);
  p.out = out;
  p.out_stride = out_stride;
  const Plan pl = plan(c0, layers, widths, total, k);
  p.xw = pl.xw;
  p.yw = pl.yw;
  p.scratch = static_cast<float*>(pl.scratch ? scratch : nullptr);
  if (pl.scratch && !scratch) return (int)cudaErrorInvalidValue;
  if (kind == 0) {
    return bf16 ? launch<kMax, __nv_bfloat16>(p, pl, stream)
                : launch<kMax, float>(p, pl, stream);
  }
  if (kind == 1) {
    return bf16 ? launch<kP2p, __nv_bfloat16>(p, pl, stream)
                : launch<kP2p, float>(p, pl, stream);
  }
  return bf16 ? launch<kAgg, __nv_bfloat16>(p, pl, stream)
              : launch<kAgg, float>(p, pl, stream);
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
