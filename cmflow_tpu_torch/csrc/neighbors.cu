// Neighbour search on small point clouds: multi-radius ball query and
// exact kNN, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels cmflow_tpu/ops/neighbors.py::_ball_kernel
// (called by ball_query_multi) and ::_knn_kernel (called by knn_pallas).
//
// What bounds it: neither kernel moves many bytes (a [B,N,3] cloud in, a
// [B,S,K] index block out), and the pairwise distance work is small too
// (~10 float operations per (query, point) pair).  At the model's sizes
// (B=16, N=S<=512) the roofline bound is well under a microsecond; what
// costs is latency: staging the cloud, and the scan over N.
//
// Design: one block per (batch element, 8 queries), one warp per query.  The
// block stages the cloud in shared memory as (x, y, z, |p|^2) float4s plus a
// valid byte, every thread loading points, in tiles of at most 2048 points
// (34 KB), so N is not limited; then each warp scans the tile.  Both kernels
// scan in index order, so what a warp holds carries from tile to tile.  The
// ball query stages and scans a cloud of one tile (the model's) without the
// loop.
//  * Ball query: lanes over 32 consecutive points: at N = 256 a query takes
//    8 steps, and B=16, S=256 is 4,096 warps.  Per step and radius a ballot
//    of the hits gives each hitting lane its slot, the count so far plus the
//    hits of the lanes below it, so slot k is still the (k+1)-th hit in index
//    order with no sort, and the hits of a step are stored to consecutive
//    slots.  All radii fill in the same scan, which stops (warp-uniformly)
//    once every radius is full; the block stops staging tiles once every
//    warp has stopped.  The lanes then fill the empty slots with the first
//    hit, or 0.
//  * kNN: lane l scans the points j = l (mod 32) in ascending j and keeps
//    its own K best (d^2, j) pairs sorted in registers (K is a template
//    parameter, so the insertion unrolls), inserting only on a strictly
//    smaller d^2: since j only grows within a lane, its list is ordered by
//    (d^2, j).  Then k rounds of a warp-wide (d^2, j) argmin over the lanes'
//    heads (five xor shuffles) pop the k best in order: ascending d^2, ties
//    to the lower index (lax.top_k semantics).  Lane t keeps slots t and
//    t + 32 and the warp stores them together.
//  * kNN past k = 64 (knn_select_kernel): one block per query.  Each point's
//    key is (d^2 bits << 32 | j): a distance is >= 0, so its bits order as
//    the floats do, and the keys are distinct and order as lax.top_k does
//    (ascending d^2, ties to the lower index, invalid points at BIG last in
//    index order).  The block computes the row's distances once into shared
//    memory (up to kSelStage points; past that it computes them again on
//    every pass).  The k smallest keys go out in windows of kSelWindow
//    ranks: for a window's upper end r, a radix select on the key, eight
//    bits a pass from the top (a shared-memory histogram, a warp's scan of
//    its 256 bins), finds a bound with exactly r keys below it; it stops as
//    soon as the rank falls on the first key of a bin (after the distance's
//    four bytes when that distance is unique), and otherwise goes on into
//    the index's bytes.  The keys between the window's two bounds (exactly
//    its ranks) are gathered into shared memory, sorted there (bitonic) and
//    stored.  k <= 64 takes the warp per query above.
//
// Squared distances must be bit-identical to the plain PyTorch version and to
// the JAX package: cross = (x*x' + y*y') + z*z', d = max((-2*cross + q2) + p2,
// 0), in that order, each step rounded on its own.  __fmul_rn / __fadd_rn are
// never contracted into FMAs, which nvcc would otherwise do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e10f;   // distance of an invalid point (pointops._BIG)
constexpr int kWarps = 8;       // queries per block, one warp each
constexpr int kMaxScales = 4;   // radii per ball-query launch
constexpr int kTile = 2048;     // points staged in shared memory at a time
constexpr int kSelThreads = 256;   // threads of a kNN-select block (a query)
constexpr int kSelWindow = 2048;   // ranks sorted in shared memory at a time
constexpr int kSelStage = 16384;   // distances kept in shared memory (64 KB)

struct Scales {
  int count;
  float r2[kMaxScales];
  int k[kMaxScales];
  int* out[kMaxScales];
};

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float q2, float4 p) {
  const float cross = __fadd_rn(
      __fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)), __fmul_rn(qz, p.z));
  return fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(-2.0f, cross), q2), p.w), 0.0f);
}

// Stage points [t0, t0 + len) of cloud b as (x, y, z, |p|^2) plus their
// valid flags; every thread of the block must call it.
__device__ void stage_tile(const float* __restrict__ points,
                           const uint8_t* __restrict__ valid, int b, int n,
                           int t0, int len, float4* sp, uint8_t* sv) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int64_t j = (int64_t)b * n + t0 + i;
    const float* p = points + j * 3;
    const float x = p[0], y = p[1], z = p[2];
    sp[i] = make_float4(x, y, z, norm2(x, y, z));
    sv[i] = valid ? valid[j] : 1;
  }
}

// One warp scans staged points [0, len), which are points t0 + i of the
// cloud, for its query; cnt and first carry from tile to tile.  Returns
// whether a radius still has room (the same on every lane).
__device__ __forceinline__ bool ball_scan_tile(
    const float4* sp, const uint8_t* sv, int t0, int len, float qx, float qy,
    float qz, float q2, int64_t row, const Scales& sc, int (&cnt)[kMaxScales],
    int (&first)[kMaxScales]) {
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  for (int j0 = 0; j0 < len; j0 += 32) {
    const int i = j0 + lane;
    const bool live = i < len && sv[i];
    const float d = live ? sqdist(qx, qy, qz, q2, sp[i]) : kBig;
    bool room = false;
#pragma unroll
    for (int t = 0; t < kMaxScales; ++t) {
      if (t < sc.count && cnt[t] < sc.k[t]) {
        const unsigned hits = __ballot_sync(0xffffffffu, live && d < sc.r2[t]);
        if (hits != 0u) {
          if (cnt[t] == 0) first[t] = t0 + j0 + __ffs(hits) - 1;
          const int slot = cnt[t] + __popc(hits & below);
          if (((hits >> lane) & 1u) && slot < sc.k[t]) {
            sc.out[t][row * sc.k[t] + slot] = t0 + i;
          }
          cnt[t] = min(cnt[t] + __popc(hits), sc.k[t]);
        }
        room |= cnt[t] < sc.k[t];
      }
    }
    if (!room) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ points,
                      const float* __restrict__ query,
                      const uint8_t* __restrict__ valid, int n, int s,
                      Scales sc) {
  extern __shared__ float4 smem[];
  float4* sp = smem;
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + min(n, kTile));
  const int b = blockIdx.y;
  // q is the same on every lane of the warp, so every branch on it is uniform
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)b * s + q;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (q < s) {
    qx = query[row * 3];
    qy = query[row * 3 + 1];
    qz = query[row * 3 + 2];
  }
  const float q2 = norm2(qx, qy, qz);

  // per radius, the same on every lane: hits so far (at most K), first hit
  int cnt[kMaxScales];
  int first[kMaxScales];
#pragma unroll
  for (int t = 0; t < kMaxScales; ++t) {
    cnt[t] = 0;
    first[t] = 0;
  }

  // open: this warp's query still has a radius with room.  A cloud of one
  // tile takes a path of its own: the tile loop cost ~20% at N=256 (NVIDIA
  // H100 80GB HBM3, 700 W).  Above one tile, the barrier before a later
  // tile also stops the block once no warp is open.
  bool open = q < s;
  if (n <= kTile) {
    stage_tile(points, valid, b, n, 0, n, sp, sv);
    __syncthreads();
    if (open) ball_scan_tile(sp, sv, 0, n, qx, qy, qz, q2, row, sc, cnt, first);
  } else {
    for (int t0 = 0; t0 < n; t0 += kTile) {
      if (t0 > 0 && !__syncthreads_or(open)) break;  // t0 is block-uniform
      const int len = min(kTile, n - t0);
      stage_tile(points, valid, b, n, t0, len, sp, sv);
      __syncthreads();
      if (open) {
        open = ball_scan_tile(sp, sv, t0, len, qx, qy, qz, q2, row, sc, cnt,
                              first);
      }
    }
  }
  if (q >= s) return;
  // empty slots repeat the first hit; an empty ball gives all zeros
#pragma unroll
  for (int t = 0; t < kMaxScales; ++t) {
    if (t < sc.count) {
      for (int k = cnt[t] + lane; k < sc.k[t]; k += 32) {
        sc.out[t][row * sc.k[t] + k] = first[t];
      }
    }
  }
}

__device__ __forceinline__ bool key_less(float da, int ja, float db, int jb) {
  return da < db || (da == db && ja < jb);
}

// This lane's points of staged tile [0, len), which are points t0 + i of
// the cloud (t0 a multiple of 32, so they are j = lane mod 32), into its
// list of the KMAX best keys, ascending (d^2, index).
template <int KMAX>
__device__ __forceinline__ void knn_scan_tile(const float4* sp,
                                              const uint8_t* sv, int t0,
                                              int len, float qx, float qy,
                                              float qz, float q2,
                                              float (&bd)[KMAX],
                                              int (&bj)[KMAX]) {
  for (int i = threadIdx.x % 32; i < len; i += 32) {
    const float d = sv[i] ? sqdist(qx, qy, qz, q2, sp[i]) : kBig;
    // j exceeds every index held, so only a strictly smaller d enters
    if (d < bd[KMAX - 1]) {
      float cd = d;
      int cj = t0 + i;
#pragma unroll
      for (int t = 0; t < KMAX; ++t) {
        if (key_less(cd, cj, bd[t], bj[t])) {
          const float td = bd[t];
          const int tj = bj[t];
          bd[t] = cd;
          bj[t] = cj;
          cd = td;
          cj = tj;
        }
      }
    }
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kWarps * 32)
    knn_kernel(const float* __restrict__ points,
               const float* __restrict__ query,
               const uint8_t* __restrict__ valid, int n, int s, int k,
               int* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* sp = smem;
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + min(n, kTile));
  const int b = blockIdx.y;
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)b * s + q;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (q < s) {
    qx = query[row * 3];
    qy = query[row * 3 + 1];
    qz = query[row * 3 + 2];
  }
  const float q2 = norm2(qx, qy, qz);

  // this lane's KMAX best keys among its points, ascending (d^2, index)
  float bd[KMAX];
  int bj[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf
    bj[t] = 0x7fffffff;
  }
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    if (t0 > 0) __syncthreads();  // the previous tile is no longer read
    stage_tile(points, valid, b, n, t0, len, sp, sv);
    __syncthreads();
    if (q < s) knn_scan_tile<KMAX>(sp, sv, t0, len, qx, qy, qz, q2, bd, bj);
  }
  if (q >= s) return;

  // k rounds: the least head over the lanes is the next neighbour; the lane
  // that held it (j = lane mod 32) pops it.  k <= N, so a real key wins
  // every round.
  int slot_lo = 0, slot_hi = 0;  // slots lane and lane + 32
  for (int t = 0; t < k; ++t) {
    float d = bd[0];
    int j = bj[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oj = __shfl_xor_sync(0xffffffffu, j, off);
      if (key_less(od, oj, d, j)) {
        d = od;
        j = oj;
      }
    }
    if (lane == (t & 31)) {
      if (t < 32) {
        slot_lo = j;
      } else {
        slot_hi = j;
      }
    }
    if (lane == (j & 31)) {
#pragma unroll
      for (int u = 0; u + 1 < KMAX; ++u) {
        bd[u] = bd[u + 1];
        bj[u] = bj[u + 1];
      }
      bd[KMAX - 1] = __int_as_float(0x7f800000);
      bj[KMAX - 1] = 0x7fffffff;
    }
  }
  if (lane < k) out[row * k + lane] = slot_lo;
  if (lane + 32 < k) out[row * k + lane + 32] = slot_hi;
}

// A bound on the kNN-select keys: the keys below it are those whose top
// 64 - shift bits are less than `prefix`; shift -1 has no key below it
// and shift 64 every key.
struct Bound {
  unsigned long long prefix;
  int shift;
};

__device__ __forceinline__ bool below(unsigned long long key, Bound bd) {
  if (bd.shift < 0) return false;
  if (bd.shift >= 64) return true;
  return (key >> bd.shift) < bd.prefix;
}

// The row's squared distance of point i: staged in shared memory, or from
// the cloud (the same operations as stage_tile and sqdist).
__device__ __forceinline__ float select_dist(
    const float* __restrict__ points, const uint8_t* __restrict__ valid,
    int b, int n, const float* sd, int i, float qx, float qy, float qz,
    float q2) {
  if (sd != nullptr) return sd[i];
  const int64_t j = (int64_t)b * n + i;
  if (valid != nullptr && !valid[j]) return kBig;
  const float* p = points + j * 3;
  const float x = p[0], y = p[1], z = p[2];
  return sqdist(qx, qy, qz, q2, make_float4(x, y, z, norm2(x, y, z)));
}

__device__ __forceinline__ unsigned long long select_key(float d, int i) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)i;
}

// One block per (query q = blockIdx.x, element b = blockIdx.y): the k
// nearest points, k > 64.  Dynamic shared memory: the window's keys
// (pow2 >= min(k, kSelWindow) of them), then the row's distances when
// n <= kSelStage.
__global__ void __launch_bounds__(kSelThreads)
    knn_select_kernel(const float* __restrict__ points,
                      const float* __restrict__ query,
                      const uint8_t* __restrict__ valid, int n, int s, int k,
                      int window, int* __restrict__ out) {
  extern __shared__ unsigned long long skeys[];
  __shared__ unsigned hist[256];
  __shared__ unsigned s_digit, s_below, s_count;
  float* sd = n <= kSelStage ? reinterpret_cast<float*>(skeys + window)
                             : nullptr;
  const int b = blockIdx.y, q = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t row = (int64_t)b * s + q;
  const float qx = query[row * 3], qy = query[row * 3 + 1],
              qz = query[row * 3 + 2];
  const float q2 = norm2(qx, qy, qz);
  if (sd != nullptr) {
    for (int i = tid; i < n; i += kSelThreads) {
      sd[i] = select_dist(points, valid, b, n, nullptr, i, qx, qy, qz, q2);
    }
  }
  __syncthreads();
  // the index's bytes that can be non-zero: j < n
  int jbits = 8;
  while (jbits < 32 && (n - 1) >> jbits) jbits += 8;

  Bound lo = {0ull, -1};
  for (int r0 = 0; r0 < k; r0 += kSelWindow) {
    const int r1 = min(r0 + kSelWindow, k);
    // the bound with exactly r1 keys below it
    Bound hi = {0ull, 64};
    if (r1 < n) {
      unsigned long long prefix = 0ull;
      int shift = 64;
      unsigned need = (unsigned)r1;  // rank among the keys under `prefix`
      while (true) {
        // after the distance's bytes, only the index's low jbits remain
        const int next = shift == 32 ? jbits - 8 : shift - 8;
        if (shift == 32) prefix <<= 32 - jbits;
        shift = next;
        for (int i = tid; i < 256; i += kSelThreads) hist[i] = 0u;
        __syncthreads();
        for (int i = tid; i < n; i += kSelThreads) {
          const unsigned long long key = select_key(
              select_dist(points, valid, b, n, sd, i, qx, qy, qz, q2), i);
          if (shift + 8 >= 64 || (key >> (shift + 8)) == prefix) {
            atomicAdd(&hist[(unsigned)(key >> shift) & 255u], 1u);
          }
        }
        __syncthreads();
        // the bin in which rank `need` falls, by warp 0: lane l scans bins
        // 8l .. 8l + 7 after the counts of the lanes below it
        if (tid < 32) {
          unsigned c[8], sum = 0u;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            c[u] = hist[8 * lane + u];
            sum += c[u];
          }
          unsigned inc = sum;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const unsigned v = __shfl_up_sync(0xffffffffu, inc, off);
            if (lane >= off) inc += v;
          }
          unsigned run = inc - sum;
          if (run <= need && need < inc) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (run <= need && need < run + c[u]) {
                s_digit = 8 * lane + u;
                s_below = run;
              }
              run += c[u];
            }
          }
        }
        __syncthreads();
        prefix = (prefix << 8) | s_digit;
        need -= s_below;
        // need == 0: the bound is the least key under `prefix`, and the
        // keys below it are exactly those whose prefix is smaller
        if (need == 0u) break;
      }
      hi = Bound{prefix, shift};
    }
    // the keys in [lo, hi), exactly ranks r0 .. r1 - 1, in any order
    if (tid == 0) s_count = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += kSelThreads) {
      const unsigned long long key = select_key(
          select_dist(points, valid, b, n, sd, i, qx, qy, qz, q2), i);
      if (below(key, hi) && !below(key, lo)) {
        skeys[atomicAdd(&s_count, 1u)] = key;
      }
    }
    const int w = r1 - r0;
    int size = 1;
    while (size < w) size <<= 1;
    __syncthreads();
    for (int i = w + tid; i < size; i += kSelThreads) skeys[i] = ~0ull;
    __syncthreads();
    // bitonic sort of `size` keys, ascending
    for (int len = 2; len <= size; len <<= 1) {
      for (int stride = len >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < size / 2; t += kSelThreads) {
          const int i = 2 * t - (t & (stride - 1));
          const int j = i + stride;
          const unsigned long long a = skeys[i], c = skeys[j];
          if ((a > c) == ((i & len) == 0)) {
            skeys[i] = c;
            skeys[j] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int t = tid; t < w; t += kSelThreads) {
      out[row * k + r0 + t] = (int)(unsigned)(skeys[t] & 0xffffffffull);
    }
    __syncthreads();  // the window's keys are read before the next's land
    lo = hi;
  }
}

size_t tile_smem_bytes(int n) {
  const size_t tile = (size_t)(n < kTile ? n : kTile);
  return tile * sizeof(float4) + tile * sizeof(uint8_t);
}

template <int KMAX>
cudaError_t launch_knn(const float* points, const float* query,
                       const uint8_t* valid, int b, int n, int s, int k,
                       int* out, cudaStream_t stream) {
  const dim3 grid((s + kWarps - 1) / kWarps, b);
  knn_kernel<KMAX><<<grid, kWarps * 32, tile_smem_bytes(n), stream>>>(
      points, query, valid, n, s, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ball query for up to four radii in one scan (the wrapper launches once
// per four radii: eight in one scan took 64 registers against 40).
//   points [B,N,3] f32, query [B,S,3] f32, valid [B,N] u8 or null,
//   radii2[i] = r_i * r_i rounded to f32, ks[i] = slots of radius i,
//   outs[i] = [B,S,ks[i]] int32.  Returns a cudaError_t.
int cmflow_ball_query(const void* points, const void* query, const void* valid,
                      int b, int n, int s, int count, const float* radii2,
                      const int* ks, void* const* outs, void* stream) {
  if (count < 1 || count > kMaxScales || n < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || s == 0) return (int)cudaSuccess;
  Scales sc;
  sc.count = count;
  for (int t = 0; t < kMaxScales; ++t) {
    sc.r2[t] = t < count ? radii2[t] : 0.0f;
    sc.k[t] = t < count ? ks[t] : 0;
    sc.out[t] = t < count ? static_cast<int*>(outs[t]) : nullptr;
  }
  const dim3 grid((s + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kWarps * 32, tile_smem_bytes(n),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(query),
      static_cast<const uint8_t*>(valid), n, s, sc);
  return (int)cudaGetLastError();
}

// Exact kNN, 1 <= k <= n: out [B,S,k] int32, ascending d^2, ties to the
// lower index; k <= 64 a warp per query, above a block per query
// (knn_select_kernel).  Returns a cudaError_t.
int cmflow_knn(const void* points, const void* query, const void* valid,
               int b, int n, int s, int k, void* out, void* stream) {
  if (k < 1 || k > n) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || s == 0) return (int)cudaSuccess;
  const float* p = static_cast<const float*>(points);
  const float* q = static_cast<const float*>(query);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k > 64) {
    int window = 1;
    while (window < k && window < kSelWindow) window <<= 1;
    const size_t smem = (size_t)window * sizeof(unsigned long long) +
                        (n <= kSelStage ? (size_t)n * sizeof(float) : 0);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(knn_select_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    knn_select_kernel<<<dim3(s, b), kSelThreads, smem, st>>>(p, q, v, n, s, k,
                                                             window, o);
    return (int)cudaGetLastError();
  }
  if (k <= 8) {
    err = launch_knn<8>(p, q, v, b, n, s, k, o, st);
  } else if (k <= 16) {
    err = launch_knn<16>(p, q, v, b, n, s, k, o, st);
  } else if (k <= 32) {
    err = launch_knn<32>(p, q, v, b, n, s, k, o, st);
  } else {
    err = launch_knn<64>(p, q, v, b, n, s, k, o, st);
  }
  return (int)err;
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
