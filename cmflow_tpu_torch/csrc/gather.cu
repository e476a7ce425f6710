// Row gather: out[b, m, :] = points[b, idx[b, m], :], for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cmflow_tpu/ops/fused.py::_gather_fwd_kernel
// (called by mxu_gather_rows / mxu_group_points), the forward of
// pointops.group_points.  On the TPU the gather was a one-hot matrix product
// on the MXU; here a gather is a load.
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

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
