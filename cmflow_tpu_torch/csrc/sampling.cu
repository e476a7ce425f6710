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
// the chain of npoint dependent steps, each an argmax over the cloud, with
// only B blocks on the card: the time is the latency of one step times
// npoint.
//
// Design (a step's latency is what it attacks): one block per batch element
// of WARPS warps, few and sized by N (cmflow_fps_warps: one warp up to 256
// points, four up to 1,024, then eight), and R points a
// thread in registers, coordinates and running distance (thread t holds
// j = t + r * 32 * WARPS).  The cloud is also staged in shared memory as
// float4, so every warp reads the winner's coordinates by its index (one
// shared load, no global load and no broadcast barrier).  A step:
//  * each thread lowers its points' distances and takes their argmax, a
//    tree over r in which the lower r keeps a tie;
//  * the warp's argmax by redux.sync: the largest distance's bits (a
//    distance is >= 0, so its bits order as the floats do), then the least
//    index among the lanes that hold it (two instructions, where a butterfly
//    took ten dependent shuffles);
//  * with more than one warp, each warp writes (bits << 32 | ~index) to
//    its slot of a double-buffered array, one __syncthreads, and every lane
//    reads the WARPS slots and takes their largest by a tree of 64-bit
//    compares (two redux.sync more made a step 1.5x longer at four warps).
//    One barrier a step, no serial tail; one warp has no barrier at all.  A
//    slot of step i is written again at step i + 2, after the barrier of
//    step i + 1, which every warp reaches only once it has read step i's.
// No step branches on a lane: a point slot past N sits at running distance
// -1, which no distance is below; every lane of a warp stores its slot (the
// same value); warp 0 keeps the samples in its lanes' registers and stores
// 32 at a time.  (A branch per point and one lane's store of the sample
// made a step 1.9x longer at N=1024 on the card: PERF.md.)
// Points past R * 32 * WARPS keep their running distance in a global
// scratch row that the wrapper allocates (and read their coordinates from
// shared memory, or from the cloud above kStageMax points), so N is not
// limited.
//
// Squared distances must equal the plain PyTorch version's bit for bit:
// d = ((dx*dx + dy*dy) + dz*dz) with dx = x - cx, each step rounded on its
// own.  __fsub_rn / __fmul_rn / __fadd_rn are never contracted into FMAs,
// which nvcc would otherwise do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInit = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // the index of a lane with no point
constexpr int kStageMax = 12288;         // points staged (192 KB of float4)
constexpr int kMaxRegs = 32;             // points a thread holds at most

__device__ __forceinline__ float sqdist(float x, float y, float z, float cx,
                                        float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int WARPS, int R>
__global__ void __launch_bounds__(WARPS * 32)
    fps_kernel(const float* __restrict__ xyz, int n, int npoint,
               int staged_far, float* __restrict__ scratch,
               int* __restrict__ out) {
  constexpr int T = WARPS * 32;
  // only the block's most registers a thread leave points past them; any
  // other block holds at most 4,096 points, all staged
  constexpr bool kFar = R == kMaxRegs;
  const bool staged = !kFar || staged_far;
  extern __shared__ float4 s_pts[];  // the cloud, when staged
  // each warp's (distance bits << 32 | ~index), double-buffered by step
  __shared__ unsigned long long s_slot[2][WARPS];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* cloud = xyz + (int64_t)b * n * 3;
  float* far_dist = scratch == nullptr ? nullptr : scratch + (int64_t)b * n;
  int* samples = out + (int64_t)b * npoint;

  if (staged) {
    for (int j = t; j < n; j += T) {
      s_pts[j] = make_float4(cloud[3 * j], cloud[3 * j + 1], cloud[3 * j + 2],
                             0.0f);
    }
  }
  // a slot past N holds the origin at running distance -1, which every
  // step keeps (fminf) and which is below any distance: no branch a step
  float px[R], py[R], pz[R], dist[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = t + r * T;
    px[r] = py[r] = pz[r] = 0.0f;
    dist[r] = -1.0f;
    if (j < n) {
      px[r] = cloud[3 * j];
      py[r] = cloud[3 * j + 1];
      pz[r] = cloud[3 * j + 2];
      dist[r] = kInit;
    }
  }
  constexpr int in_regs = R * T;
  if constexpr (kFar) {
    for (int j = in_regs + t; j < n; j += T) far_dist[j] = kInit;
  }
  __syncthreads();

  unsigned cur = 0;  // the current sample, the same in every thread
  int mine = 0;      // lane l: the sample of the last step i with i % 32 == l
  for (int i = 0; i < npoint; ++i) {
    // the samples leave 32 at a time from warp 0's registers: a select a
    // step, where one lane's store would branch
    mine = lane == (i & 31) ? (int)cur : mine;
    if (warp == 0 && (i & 31) == 31) samples[i - 31 + lane] = mine;
    float cx, cy, cz;
    if (staged) {
      const float4 c = s_pts[cur];
      cx = c.x;
      cy = c.y;
      cz = c.z;
    } else {
      cx = __ldg(cloud + 3 * cur);
      cy = __ldg(cloud + 3 * cur + 1);
      cz = __ldg(cloud + 3 * cur + 2);
    }
    // this thread's points: distances, then a tree argmax over r in which
    // the lower r (the lower index) keeps a tie; -1 marks no point
    float v[R];
    int w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dist[r] = fminf(dist[r], sqdist(px[r], py[r], pz[r], cx, cy, cz));
      v[r] = dist[r];
      w[r] = r;
    }
#pragma unroll
    for (int level = 0; (1 << level) < R; ++level) {
#pragma unroll
      for (int r = 0; r + (1 << level) < R; r += 2 << level) {
        const bool take = v[r + (1 << level)] > v[r];
        v[r] = take ? v[r + (1 << level)] : v[r];
        w[r] = take ? w[r + (1 << level)] : w[r];
      }
    }
    float best = v[0];
    unsigned best_j = (unsigned)(t + w[0] * T);
    if constexpr (kFar) {
      // the points past the registers, in ascending index, after them
      for (int j = in_regs + t; j < n; j += T) {
        float x, y, z;
        if (staged) {
          const float4 p = s_pts[j];
          x = p.x;
          y = p.y;
          z = p.z;
        } else {
          x = cloud[3 * j];
          y = cloud[3 * j + 1];
          z = cloud[3 * j + 2];
        }
        const float d = fminf(far_dist[j], sqdist(x, y, z, cx, cy, cz));
        far_dist[j] = d;
        if (d > best) {
          best = d;
          best_j = (unsigned)j;
        }
      }
    }
    const unsigned key = best < 0.0f ? 0u : __float_as_uint(best);
    best_j = best < 0.0f ? kNone : best_j;
    const unsigned wkey = __reduce_max_sync(kFull, key);
    const unsigned wj = __reduce_min_sync(kFull, key == wkey ? best_j : kNone);
    if constexpr (WARPS == 1) {
      cur = wj;
    } else {
      // every lane stores the same value: one store, no branch.  The
      // largest key (bits << 32 | ~index) is the largest distance at the
      // least index; every lane reads all WARPS slots (broadcasts) and
      // takes their maximum by a tree, without a redux.sync
      const int par = i & 1;
      s_slot[par][warp] = ((unsigned long long)wkey << 32) | ~wj;
      __syncthreads();
      unsigned long long o[WARPS];
#pragma unroll
      for (int u = 0; u < WARPS; ++u) o[u] = s_slot[par][u];
#pragma unroll
      for (int level = 0; (1 << level) < WARPS; ++level) {
#pragma unroll
        for (int u = 0; u + (1 << level) < WARPS; u += 2 << level) {
          o[u] = o[u + (1 << level)] > o[u] ? o[u + (1 << level)] : o[u];
        }
      }
      cur = ~(unsigned)o[0];
    }
  }
  // the last npoint % 32 samples
  const int done = npoint & ~31;
  if (warp == 0 && done + lane < npoint) samples[done + lane] = mine;
}

template <int W, int R>
cudaError_t launch(const float* xyz, int b, int n, int npoint, float* scratch,
                   int* out, cudaStream_t stream) {
  const int staged = n <= kStageMax;  // only a far block may be unstaged
  const size_t smem = staged ? (size_t)n * sizeof(float4) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  fps_kernel<W, R><<<b, W * 32, smem, stream>>>(xyz, n, npoint, staged,
                                                 scratch, out);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_regs(int r, const float* xyz, int b, int n, int npoint,
                        float* scratch, int* out, cudaStream_t stream) {
  switch (r) {
    case 1:
      return launch<W, 1>(xyz, b, n, npoint, scratch, out, stream);
    case 2:
      return launch<W, 2>(xyz, b, n, npoint, scratch, out, stream);
    case 4:
      return launch<W, 4>(xyz, b, n, npoint, scratch, out, stream);
    case 8:
      return launch<W, 8>(xyz, b, n, npoint, scratch, out, stream);
    case 16:
      return launch<W, 16>(xyz, b, n, npoint, scratch, out, stream);
    default:
      return launch<W, 32>(xyz, b, n, npoint, scratch, out, stream);
  }
}

bool valid_warps(int warps) {
  return warps == 1 || warps == 2 || warps == 4 || warps == 8;
}

}  // namespace

extern "C" {

// The warps a block of cmflow_fps takes for a cloud of n points, by
// default: the fastest of 1, 2, 4 and 8 at B=16 and N = 256, 512, 1024 and
// 2048 (NVIDIA H100 80GB HBM3, 700 W; scripts/profile_torch_fps.py, PERF.md).
// 16 warps measured slower at every one of them and is not offered.
int cmflow_fps_warps(int n) { return n <= 256 ? 1 : n <= 1024 ? 4 : 8; }

// Points held in registers by one block of `warps` warps; a cloud above
// this many points needs a scratch of [B, N] float32 for its running
// distances.
int cmflow_fps_register_points(int warps) { return 32 * warps * kMaxRegs; }

// Farthest-point sampling: xyz [B,N,3] f32, out [B,npoint] int32, `warps`
// warps a block (1, 2, 4 or 8), scratch [B,N] f32 when N >
// cmflow_fps_register_points(warps), else null.  Returns a cudaError_t.
int cmflow_fps(const void* xyz, int b, int n, int npoint, int warps,
               void* scratch, void* out, void* stream) {
  if (n < 1 || npoint < 1 || !valid_warps(warps) ||
      (n > cmflow_fps_register_points(warps) && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0) return (int)cudaSuccess;
  // the fewest registers a thread that hold the cloud, up to the most
  int r = 1;
  while (r < kMaxRegs && 32 * warps * r < n) r *= 2;
  const float* p = static_cast<const float*>(xyz);
  float* sc = static_cast<float*>(scratch);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 1:
      return (int)launch_regs<1>(r, p, b, n, npoint, sc, o, st);
    case 2:
      return (int)launch_regs<2>(r, p, b, n, npoint, sc, o, st);
    case 4:
      return (int)launch_regs<4>(r, p, b, n, npoint, sc, o, st);
    default:
      return (int)launch_regs<8>(r, p, b, n, npoint, sc, o, st);
  }
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
