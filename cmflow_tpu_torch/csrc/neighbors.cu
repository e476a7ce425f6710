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
// Design: one block per (batch element, tile of queries).  The block stages
// the whole cloud in shared memory as (x, y, z, |p|^2) float4s plus a valid
// byte (N <= 2048 -> 34 KB), every thread loading points, then scans it.
//  * Ball query: one warp per query, lanes over 32 consecutive points, 8
//    queries (warps) per block sharing the staged cloud: at N = 256 a
//    query takes 8 steps, and B=16, S=256 is 4,096 warps.  Per step and
//    radius a ballot of the hits gives each hitting lane its slot, the
//    count so far plus the hits of the lanes below it, so slot k is still
//    the (k+1)-th hit in index order with no sort, and the hits of a step
//    are stored to consecutive slots.  All radii fill in the same scan,
//    which stops (warp-uniformly) once every radius is full; the lanes then
//    fill the empty slots with the first hit, or 0.
//  * kNN: one thread per query, 32 per block, scanning the points in index
//    order (each read is a broadcast).  Each keeps its K best (d^2, j) pairs
//    sorted in registers (K is a template parameter, so the insertion loop
//    unrolls) and inserts only on a strictly smaller key, so ties keep the
//    lower index (lax.top_k semantics).
//
// Squared distances must be bit-identical to the plain PyTorch version and to
// the JAX package: cross = (x*x' + y*y') + z*z', d = max((-2*cross + q2) + p2,
// 0), in that order, each step rounded on its own.  __fmul_rn / __fadd_rn are
// never contracted into FMAs, which nvcc would otherwise do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e10f;   // distance of an invalid point (pointops._BIG)
constexpr int kThreads = 32;    // kNN: queries per block
constexpr int kBallWarps = 8;   // ball query: queries per block
constexpr int kMaxScales = 4;   // radii per ball-query launch
constexpr int kMaxPoints = 2048;

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

// Stage cloud b as (x, y, z, |p|^2) plus its valid flags; every thread of the
// block must call it.
__device__ void stage_cloud(const float* __restrict__ points,
                            const uint8_t* __restrict__ valid, int b, int n,
                            float4* sp, uint8_t* sv) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float* p = points + ((int64_t)b * n + j) * 3;
    const float x = p[0], y = p[1], z = p[2];
    sp[j] = make_float4(x, y, z, norm2(x, y, z));
    sv[j] = valid ? valid[(int64_t)b * n + j] : 1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBallWarps * 32)
    ball_query_kernel(const float* __restrict__ points,
                      const float* __restrict__ query,
                      const uint8_t* __restrict__ valid, int n, int s,
                      Scales sc) {
  extern __shared__ float4 smem[];
  float4* sp = smem;
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + n);
  const int b = blockIdx.y;
  stage_cloud(points, valid, b, n, sp, sv);

  // q is the same on every lane of the warp, so the exit is uniform
  const int q = blockIdx.x * kBallWarps + threadIdx.x / 32;
  if (q >= s) return;
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int64_t row = (int64_t)b * s + q;
  const float qx = query[row * 3], qy = query[row * 3 + 1],
              qz = query[row * 3 + 2];
  const float q2 = norm2(qx, qy, qz);

  // per radius, the same on every lane: hits so far (at most K), first hit
  int cnt[kMaxScales];
  int first[kMaxScales];
#pragma unroll
  for (int t = 0; t < kMaxScales; ++t) {
    cnt[t] = 0;
    first[t] = 0;
  }

  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < n && sv[j];
    const float d = live ? sqdist(qx, qy, qz, q2, sp[j]) : kBig;
    bool open = false;
#pragma unroll
    for (int t = 0; t < kMaxScales; ++t) {
      if (t < sc.count && cnt[t] < sc.k[t]) {
        const unsigned hits = __ballot_sync(0xffffffffu, live && d < sc.r2[t]);
        if (hits != 0u) {
          if (cnt[t] == 0) first[t] = j0 + __ffs(hits) - 1;
          const int slot = cnt[t] + __popc(hits & below);
          if (((hits >> lane) & 1u) && slot < sc.k[t]) {
            sc.out[t][row * sc.k[t] + slot] = j;
          }
          cnt[t] = min(cnt[t] + __popc(hits), sc.k[t]);
        }
        open |= cnt[t] < sc.k[t];
      }
    }
    if (!open) break;
  }
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

template <int KMAX>
__global__ void knn_kernel(const float* __restrict__ points,
                           const float* __restrict__ query,
                           const uint8_t* __restrict__ valid, int n, int s,
                           int k, int* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* sp = smem;
  uint8_t* sv = reinterpret_cast<uint8_t*>(smem + n);
  const int b = blockIdx.y;
  stage_cloud(points, valid, b, n, sp, sv);

  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= s) return;
  const int64_t row = (int64_t)b * s + q;
  const float qx = query[row * 3], qy = query[row * 3 + 1],
              qz = query[row * 3 + 2];
  const float q2 = norm2(qx, qy, qz);

  // the KMAX best keys in ascending (d^2, index) order; the first k of them
  // are the k best, since k <= KMAX
  float bd[KMAX];
  int bj[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    bd[t] = __int_as_float(0x7f800000);  // +inf
    bj[t] = 0x7fffffff;
  }
  for (int j = 0; j < n; ++j) {
    const float d = sv[j] ? sqdist(qx, qy, qz, q2, sp[j]) : kBig;
    // j exceeds every index held, so only a strictly smaller d enters
    if (d < bd[KMAX - 1]) {
      float cd = d;
      int cj = j;
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
#pragma unroll
  for (int t = 0; t < KMAX; ++t) {
    if (t < k) out[row * k + t] = bj[t];
  }
}

size_t cloud_smem_bytes(int n) {
  return (size_t)n * sizeof(float4) + (size_t)n * sizeof(uint8_t);
}

template <int KMAX>
cudaError_t launch_knn(const float* points, const float* query,
                       const uint8_t* valid, int b, int n, int s, int k,
                       int* out, cudaStream_t stream) {
  const dim3 grid((s + kThreads - 1) / kThreads, b);
  knn_kernel<KMAX><<<grid, kThreads, cloud_smem_bytes(n), stream>>>(
      points, query, valid, n, s, k, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ball query for up to four radii in one scan.
//   points [B,N,3] f32, query [B,S,3] f32, valid [B,N] u8 or null,
//   radii2[i] = r_i * r_i rounded to f32, ks[i] = slots of radius i,
//   outs[i] = [B,S,ks[i]] int32.  Returns a cudaError_t.
int cmflow_ball_query(const void* points, const void* query, const void* valid,
                      int b, int n, int s, int count, const float* radii2,
                      const int* ks, void* const* outs, void* stream) {
  if (count < 1 || count > kMaxScales || n < 1 || n > kMaxPoints) {
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
  const dim3 grid((s + kBallWarps - 1) / kBallWarps, b);
  ball_query_kernel<<<grid, kBallWarps * 32, cloud_smem_bytes(n),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(query),
      static_cast<const uint8_t*>(valid), n, s, sc);
  return (int)cudaGetLastError();
}

// Exact kNN, k <= 64: out [B,S,k] int32, ascending d^2, ties to the lower
// index.  Returns a cudaError_t.
int cmflow_knn(const void* points, const void* query, const void* valid,
               int b, int n, int s, int k, void* out, void* stream) {
  if (k < 1 || k > 64 || k > n || n > kMaxPoints) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || s == 0) return (int)cudaSuccess;
  const float* p = static_cast<const float*>(points);
  const float* q = static_cast<const float*>(query);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
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
