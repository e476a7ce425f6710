// Iterative farthest-point sampling for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs farthest-point sampling
// as one lax.fori_loop under jax.jit (cmflow_tpu/ops/pointops.py:270,
// farthest_point_sample), a loop that stays on the device.  Step by step in
// eager PyTorch the same loop would issue about five launches per sample
// from the host, so the port's counterpart of that device-resident loop is
// this kernel.  The reference's own FPS is a CUDA kernel too
// (lib/src/sampling_gpu.cu).
//
// What it computes, per batch element b: the first sample is point 0 and
// every point's running distance starts at 1e10; step i stores the current
// sample, lowers each point's running distance to its squared distance from
// that sample, and takes the next sample as the point with the largest
// running distance, ties to the lowest index (jnp.argmax, torch.argmax).
//
// What bounds it: the bytes (a [B,N,3] cloud read once, [B,npoint] int32
// written) and the arithmetic (~10 float operations per point per step) are
// both far below a microsecond at B=16, N=1024, npoint=512.  What costs is
// the chain of npoint dependent steps, each a block-wide argmax: two
// __syncthreads and a few shuffles per step, with only B blocks on the card.
//
// Design: one block per batch element, kThreads threads.  Thread t keeps
// the points j = t + r * kThreads, r < kRegs, in registers, coordinates and
// running distance; points past kRegs * kThreads keep their running
// distance in a global scratch row that the wrapper allocates, and are read
// from the cloud every step, so N is not limited.  The current sample's
// coordinates are broadcast through shared memory.  Each step's argmax:
// every thread scans its points in ascending index and replaces its best
// only on a strictly larger distance, then five xor shuffles take the
// (distance, index) maximum of a warp, ties to the lower index, then warp
// 0 the maximum of the warps' results from shared memory.
//
// Squared distances must equal the plain PyTorch version's bit for bit:
// d = ((dx*dx + dy*dy) + dz*dz) with dx = x - cx, each step rounded on its
// own.  __fsub_rn / __fmul_rn / __fadd_rn are never contracted into FMAs,
// which nvcc would otherwise do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegs = 4;  // points per thread held in registers
constexpr float kInit = 1e10f;

__device__ __forceinline__ float sqdist(float x, float y, float z, float cx,
                                        float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) becomes the larger of (v, i) and (ov, oi), ties to the lower index.
__device__ __forceinline__ void take_max(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int n, int npoint,
               float* __restrict__ scratch, int* __restrict__ out) {
  __shared__ float s_center[3];
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* cloud = xyz + (int64_t)b * n * 3;
  float* far_dist = scratch == nullptr ? nullptr : scratch + (int64_t)b * n;
  int* samples = out + (int64_t)b * npoint;

  float px[kRegs], py[kRegs], pz[kRegs], dist[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int j = t + r * kThreads;
    if (j < n) {
      px[r] = cloud[3 * j];
      py[r] = cloud[3 * j + 1];
      pz[r] = cloud[3 * j + 2];
    }
    dist[r] = kInit;
  }
  const int in_regs = kRegs * kThreads;
  for (int j = in_regs + t; j < n; j += kThreads) far_dist[j] = kInit;

  int sample = 0;  // meaningful in thread 0
  for (int i = 0; i < npoint; ++i) {
    if (t == 0) {
      samples[i] = sample;
      s_center[0] = cloud[3 * sample];
      s_center[1] = cloud[3 * sample + 1];
      s_center[2] = cloud[3 * sample + 2];
    }
    __syncthreads();
    const float cx = s_center[0], cy = s_center[1], cz = s_center[2];
    float best = -1.0f;
    int best_j = 0x7fffffff;
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int j = t + r * kThreads;
      if (j < n) {
        dist[r] = fminf(dist[r], sqdist(px[r], py[r], pz[r], cx, cy, cz));
        if (dist[r] > best) {
          best = dist[r];
          best_j = j;
        }
      }
    }
    for (int j = in_regs + t; j < n; j += kThreads) {
      const float d = fminf(far_dist[j], sqdist(cloud[3 * j], cloud[3 * j + 1],
                                                cloud[3 * j + 2], cx, cy, cz));
      far_dist[j] = d;
      if (d > best) {
        best = d;
        best_j = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_max(best, best_j, __shfl_xor_sync(0xffffffffu, best, off),
               __shfl_xor_sync(0xffffffffu, best_j, off));
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_j;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kWarps ? s_val[lane] : -1.0f;
      best_j = lane < kWarps ? s_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        take_max(best, best_j, __shfl_xor_sync(0xffffffffu, best, off),
                 __shfl_xor_sync(0xffffffffu, best_j, off));
      }
      sample = best_j;
    }
    // thread 0 writes s_center only after every thread has passed the
    // barrier above, so no thread still reads the previous sample; the
    // other warps write s_val again only after the next step's barrier
  }
}

}  // namespace

extern "C" {

// Points held in registers by one block; a cloud above this many points
// needs a scratch of [B, N] float32 for its running distances.
int cmflow_fps_register_points() { return kRegs * kThreads; }

// Farthest-point sampling: xyz [B,N,3] f32, out [B,npoint] int32, scratch
// [B,N] f32 when N > cmflow_fps_register_points(), else null.  Returns a
// cudaError_t.
int cmflow_fps(const void* xyz, int b, int n, int npoint, void* scratch,
               void* out, void* stream) {
  if (n < 1 || npoint < 1 ||
      (n > kRegs * kThreads && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  fps_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), n, npoint,
      static_cast<float*>(scratch), static_cast<int*>(out));
  return (int)cudaGetLastError();
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
