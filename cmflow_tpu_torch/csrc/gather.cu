// Row gather and its backward, for Hopper (sm_90a).
//
// cmflow_gather_rows: out[b, m, :] = points[b, idx[b, m], :].  Replaces the
// Pallas TPU kernel cmflow_tpu/ops/fused.py::_gather_fwd_kernel (called by
// mxu_gather_rows / mxu_group_points), the forward of pointops.group_points.
// On the TPU the gather was a one-hot matrix product on the MXU; here a
// gather is a load.
//
// What bounds it: bytes.  It does no arithmetic, reads each needed row of
// points and the index once, and writes the [B, M, C] result, which is the
// largest stream by far (K copies of each row: at B=16, N=256, K=32, C=512 it
// writes 268 MB).
//
// Design: a flat grid-stride loop over output elements, so that neighbouring
// threads write neighbouring addresses for any C (a C=3 row and a C=512 row
// alike).  When C is a multiple of 4 and the pointers are 16-byte aligned each
// thread moves one float4, the widest load and store a thread has.  The source
// rows are read again once per neighbour that names them; at these sizes the
// whole cloud stays in the 50 MB L2, so the re-reads do not reach device
// memory.  An index outside [0, N) writes a zero row, as the one-hot product
// did.
//
// cmflow_gather_rows_backward: out[b, n, :] = sum of g[b, m, :] over every m
// with idx[b, m] == n, the transpose of the gather.  Replaces the Pallas TPU
// kernel cmflow_tpu/ops/fused.py::_gather_bwd_kernel (called by
// _mxu_gather_bwd, the backward of mxu_group_points).  On the TPU it was the
// transposed one-hot product, accumulated over a sequential grid axis.
//
// What bounds it: bytes.  It reads each cotangent row once (the [B, M, C]
// stream, M = S*K, is the largest: 268 MB at B=16, S=256, K=32, C=512), the
// index once, and writes [B, N, C]; one add per cotangent element.
//
// Design: deterministic, with no atomics, so that a train step gives the same
// bits every run.  Each output row belongs to one warp, which sums its rows
// in registers in ascending m, a fixed order (the order of a sequential
// index_add_).  A block of 16 warps owns 16 consecutive output rows of one
// batch element and stages that element's indices through shared memory, 4096
// at a time.  Each warp scans them 32 at a time with one ballot (lane j tests
// index m0 + j against its row), then walks the set bits in ascending order,
// loading up to four matching cotangent rows before adding them, so that the
// loads are in flight together.  Lanes run over channels: a float4 each when
// C is a multiple of 4 and the pointers are 16-byte aligned, so a C=512 row is
// one 2 KB coalesced read per warp.  Every cotangent row is read by exactly
// one warp; the indices are read once per block from L2.  An index outside
// [0, N) matches no row and contributes nothing, the transpose of the zero
// row the forward writes for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // grid-stride beyond this

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() {
  return 0.0f;
}

template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// T is float (one channel per element) or float4 (four channels); c counts
// elements of T in a row.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ points,
                                   const int* __restrict__ idx,
                                   T* __restrict__ out, int n, int m, int c,
                                   int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t row = e / c;  // b * m + position
    const int col = (int)(e - row * c);
    const int64_t b = row / m;
    const int j = __ldg(idx + row);
    out[e] = (j >= 0 && j < n) ? __ldg(points + (b * n + j) * c + col)
                               : zero<T>();
  }
}

template <typename T>
cudaError_t launch(const void* points, const void* idx, void* out, int n,
                   int m, int c, int64_t total, cudaStream_t stream) {
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  gather_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(points), static_cast<const int*>(idx),
      static_cast<T*>(out), n, m, c, total);
  return cudaGetLastError();
}

__device__ __forceinline__ void add_to(float& acc, float v) { acc += v; }

__device__ __forceinline__ void add_to(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

constexpr int kBwdWarps = 16;    // output rows per block, one warp each
constexpr int kBwdTile = 4096;   // indices staged in shared memory at a time
constexpr int kBwdBatch = 4;     // matching rows loaded before they are added
constexpr int kBwdMaxVpl = 16;   // elements of T per lane: C <= 512 * 4 * 4

// T is float or float4; c counts elements of T in a row; VPL elements of T
// per lane cover it (VPL * 32 >= c).
template <typename T, int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32)
gather_rows_backward_kernel(const T* __restrict__ g,
                            const int* __restrict__ idx,
                            T* __restrict__ out, int n, int m, int c) {
  __shared__ int sidx[kBwdTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  const int* ib = idx + (int64_t)b * m;
  const T* gb = g + (int64_t)b * m * c;

  T acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = zero<T>();

  for (int m0 = 0; m0 < m; m0 += kBwdTile) {
    const int len = min(kBwdTile, m - m0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      sidx[i] = __ldg(ib + m0 + i);
    }
    __syncthreads();
    if (row >= n) continue;  // warp-uniform: the whole warp has this row
    for (int s = 0; s < len; s += 32) {
      const int j = s + lane;
      unsigned hits = __ballot_sync(0xffffffffu, j < len && sidx[j] == row);
      while (hits) {
        int pos[kBwdBatch];
#pragma unroll
        for (int q = 0; q < kBwdBatch; ++q) {
          pos[q] = hits ? __ffs(hits) - 1 : -1;  // ascending m
          hits &= hits - 1;
        }
        T val[kBwdBatch][VPL];
#pragma unroll
        for (int q = 0; q < kBwdBatch; ++q) {
          const T* src = gb + (int64_t)(m0 + s + max(pos[q], 0)) * c;
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const int col = lane + 32 * v;
            val[q][v] = (pos[q] >= 0 && col < c) ? __ldg(src + col) : zero<T>();
          }
        }
#pragma unroll
        for (int q = 0; q < kBwdBatch; ++q) {
          if (pos[q] < 0) break;
#pragma unroll
          for (int v = 0; v < VPL; ++v) add_to(acc[v], val[q][v]);
        }
      }
    }
  }
  if (row >= n) return;
  T* dst = out + ((int64_t)b * n + row) * c;
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int col = lane + 32 * v;
    if (col < c) dst[col] = acc[v];
  }
}

template <typename T>
cudaError_t launch_backward(const void* g, const void* idx, void* out, int b,
                            int n, int m, int c, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kBwdWarps - 1) / kBwdWarps), (unsigned)b);
  const dim3 block(kBwdWarps * 32);
  const T* gt = static_cast<const T*>(g);
  const int* it = static_cast<const int*>(idx);
  T* ot = static_cast<T*>(out);
  const int vpl = (c + 31) / 32;
  if (vpl <= 1) {
    gather_rows_backward_kernel<T, 1><<<grid, block, 0, stream>>>(gt, it, ot, n, m, c);
  } else if (vpl <= 2) {
    gather_rows_backward_kernel<T, 2><<<grid, block, 0, stream>>>(gt, it, ot, n, m, c);
  } else if (vpl <= 4) {
    gather_rows_backward_kernel<T, 4><<<grid, block, 0, stream>>>(gt, it, ot, n, m, c);
  } else if (vpl <= 8) {
    gather_rows_backward_kernel<T, 8><<<grid, block, 0, stream>>>(gt, it, ot, n, m, c);
  } else {
    gather_rows_backward_kernel<T, kBwdMaxVpl><<<grid, block, 0, stream>>>(gt, it, ot, n, m, c);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// points [B,N,C] f32, idx [B,M] int32, out [B,M,C] f32.  vec4 != 0 asks for
// the float4 path: C % 4 == 0 and all three pointers 16-byte aligned.
// Returns a cudaError_t.
int cmflow_gather_rows(const void* points, const void* idx, void* out, int b,
                       int n, int m, int c, int vec4, void* stream) {
  if (n < 1 || c < 1 || (vec4 && c % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = (int64_t)b * m;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec4) {
    err = launch<float4>(points, idx, out, n, m, c / 4, rows * (c / 4), st);
  } else {
    err = launch<float>(points, idx, out, n, m, c, rows * c, st);
  }
  return (int)err;
}

// g [B,M,C] f32, idx [B,M] int32, out [B,N,C] f32, every row of out written.
// vec4 != 0 asks for the float4 path: C % 4 == 0 and g and out 16-byte
// aligned.  C may be at most 512 (scalar path) or 2048 (float4 path).
// Returns a cudaError_t.
int cmflow_gather_rows_backward(const void* g, const void* idx, void* out,
                                int b, int n, int m, int c, int vec4,
                                void* stream) {
  if (n < 1 || c < 1 || m < 0 || (vec4 && c % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int elems = vec4 ? c / 4 : c;
  if ((elems + 31) / 32 > kBwdMaxVpl) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4) return (int)launch_backward<float4>(g, idx, out, b, n, m, elems, st);
  return (int)launch_backward<float>(g, idx, out, b, n, m, elems, st);
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
