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
// Design: deterministic, with no atomics in any sum, so that a train step
// gives the same bits every run, and balanced however the indices are skewed
// (the ball query names low indices far more often: at K=32 one row of 256
// is named 203 times, and ~100 never).  Two launches:
//  1. CSR build (gather_rows_backward_csr_kernel, also cmflow_gather_rows_csr):
//     a counting sort of each element's indices by row, stable in m, by a
//     thread-block cluster of kCsrCluster blocks per element (one block per
//     SM-sized slice: at B=16 128 blocks, where one block per element left 116
//     of the 132 SMs idle).  Out-of-range indices go to a discard bin past row
//     N-1.  Block q takes the q-th contiguous slice of m, and each of its warps
//     a contiguous range of that slice; a warp counts its entries per row
//     (shared-memory atomics: a count does not depend on order).  Per (warp,
//     row) counts scanned over the block's warps give each block its per-row
//     totals, which it stores into every block of the cluster (distributed
//     shared memory) before the cluster's barrier; after it each block scans
//     (row, then block rank, then warp) what it holds, so every warp knows its
//     first position in each row; block q's slice precedes block q+1's, so the
//     order stays stable in m.  (Reading the others' totals after the barrier
//     instead put a remote load's latency, ~1,000 cycles, twice on the path:
//     PERF.md.)  Then, 32 entries at a time, a warp finds the lanes naming each
//     lane's row (32 shuffles); an entry's rank among them (popc of the lower
//     lanes) plus the warp's running count of that row gives its place: offsets
//     [B, N+1] and order [B, M], the m of each sorted position.  No position
//     comes from the return value of an atomic.  Above kCsrClusterBins rows an
//     element takes one block (every block's totals would not fit beside the
//     counts); the counts lie in shared memory up to 25,599 rows, and above
//     that in a device scratch buffer that the caller sizes, with 8 warps, so N
//     has no limit.  For the backward the same kernel also zeroes the rows of
//     out that no index names (it knows them from the totals), each by the
//     block of its rank modulo the cluster, and the tickets of step 2.
//  2. Sum (gather_rows_backward_sum_kernel): the sorted in-range entries are
//     cut into pieces of 32, one warp each, so every warp has the same work
//     whatever the rows' lengths.  A warp loads its piece's m and rows, finds
//     where rows change with one ballot, and sums each row's run in sorted
//     order.  A row that lies whole in the piece is written to out; a row
//     that begins in an earlier piece or goes on in a later one is written
//     to a partial slot of the piece (slot 0: the row it began with, slot
//     1: the row it ends with).  For narrow rows (up to 16 elements of T) the
//     warp splits into groups of G lanes, lanes over a row's elements; piece
//     entry i belongs to group i % (32 / G), all of a group's entries are
//     loaded at once, each group sums its entries of a run in ascending i,
//     and the groups combine by a fixed xor-shuffle tree, so all 32 lanes
//     carry data.  Wider rows take all 32 lanes, up to 64 elements of T a
//     warp (a C=512 piece is two warps; a row of any width is one warp per
//     64-element column slice, ceil(C/64) warps a piece in the grid, each
//     slice with tickets of its own), and stream through the piece eight
//     rows at a time, adding in sorted order.  A column's sum is the same
//     whichever slice takes it.  A warp that wrote a partial
//     takes a ticket of its row (an atomicAdd after a release fence); the
//     warp that takes the row's last ticket adds its partials in piece order
//     (its first piece's slot 1, then slot 0 of each later one) and writes
//     the row.  The ticket decides which warp adds, never the order of a
//     sum.  (The warp of a row's first piece summing all of a row that goes
//     on, piece by piece, waited on no other warp but made a heavy row, ~200
//     entries, one warp's serial chain: slower, PERF.md.)
// Whichever row a warp meets, the order of every sum follows from the
// indices alone, so two runs give the same bits.
//
// bf16 arms (cmflow_gather_rows_bf16, cmflow_gather_rows_backward_bf16):
// the branches of the same Pallas kernels for bf16 points
// (_gather_fwd_kernel's single-pass product, _gather_bwd_kernel's bf16
// cotangent, and _mxu_group_bwd's cast of its float32 sum to the points'
// dtype).  The forward copies each bf16 row bit for bit, as the one-hot
// product of bf16 values did, on 16-byte vectors of 8 bf16 (uint4) where C
// is a multiple of 8 and the pointers are aligned, else on single bf16.
// The backward is the same two launches: the sum kernel loads bf16 terms
// (8 a lane, or one), adds them in float32 in the same order as the float32
// arm, keeps its partial slots in float32, and rounds each row to bf16 once,
// where its sum is complete: for a row that spans pieces, in the warp that
// takes its last ticket.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
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

template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// eight float32 sums, the accumulator of a uint4 of 8 bf16
struct alignas(16) float8 {
  float4 lo, hi;
};

template <>
__device__ __forceinline__ float8 zero<float8>() {
  return float8{zero<float4>(), zero<float4>()};
}

// T is float (one channel per element), float4 (four channels),
// __nv_bfloat16 (one) or uint4 (eight bf16 channels); c counts elements of
// T in a row.  The bf16 arms copy bits.
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

__device__ __forceinline__ void add_to(float8& acc, float8 v) {
  add_to(acc.lo, v.lo);
  add_to(acc.hi, v.hi);
}

__device__ __forceinline__ float shfl_xor(float v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

__device__ __forceinline__ float4 shfl_xor(float4 v, int off) {
  return make_float4(shfl_xor(v.x, off), shfl_xor(v.y, off),
                     shfl_xor(v.z, off), shfl_xor(v.w, off));
}

__device__ __forceinline__ float8 shfl_xor(float8 v, int off) {
  return float8{shfl_xor(v.lo, off), shfl_xor(v.hi, off)};
}

// The backward's element types: L, the type it loads and stores (float,
// float4, __nv_bfloat16 or uint4 of 8 bf16), and Acc<L>, the float32 type
// it sums in.  widen() turns a loaded element into its sum type (exactly:
// a bf16 is the top half of a float32), narrow() a finished sum into the
// stored type (round to nearest even for bf16); both are the identity on
// the float32 arms, which keep their instructions and their bits.
template <typename L>
struct AccOf {
  using type = L;
};
template <>
struct AccOf<__nv_bfloat16> {
  using type = float;
};
template <>
struct AccOf<uint4> {
  using type = float8;
};
template <typename L>
using Acc = typename AccOf<L>::type;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// bf16 element 2i is the low half of word i (little endian)
__device__ __forceinline__ float2 widen2(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float8 widen(uint4 v) {
  const float2 a = widen2(v.x), b = widen2(v.y), c = widen2(v.z),
               d = widen2(v.w);
  return float8{make_float4(a.x, a.y, b.x, b.y), make_float4(c.x, c.y, d.x, d.y)};
}

template <typename L>
__device__ __forceinline__ L narrow(Acc<L> v);

template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float4 narrow<float4>(float4 v) {
  return v;
}

template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x low half
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
__device__ __forceinline__ uint4 narrow<uint4>(float8 v) {
  return make_uint4(pack2(v.lo.x, v.lo.y), pack2(v.lo.z, v.lo.w),
                    pack2(v.hi.x, v.hi.y), pack2(v.hi.z, v.hi.w));
}

// a partial slot written by another warp of the sum kernel, read past L1
// (which another SM's stores do not reach)
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 load_cg(const float4* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float8 load_cg(const float8* p) {
  return float8{__ldcg(&p->lo), __ldcg(&p->hi)};
}

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCsrMaxWarps = 32;
constexpr int kCsrMinWarps = 8;          // a block's warps where they fit
constexpr int kCsrClusterWarps = 8;      // a cluster block's warps
constexpr int kCsrGlobalWarps = 8;       // counts in device scratch
constexpr int kCsrMaxSmem = 200 * 1024;  // of the SM's 227 KB a block may use
constexpr int kCsrSteps = 8;             // 32-entry steps loaded together
constexpr int kCsrCluster = 8;           // blocks per batch element
constexpr int kCsrClusterBins = 2048;    // the most bins a cluster scans
constexpr int kPiece = 32;               // sorted entries per warp of the sum
constexpr int kSumWarps = 4;             // pieces per block of the sum
constexpr int kSumBatch = 8;             // rows in flight, wide sum warp

// the bin of an index: its row, or n (discarded) outside [0, n)
__device__ __forceinline__ int bin_of(int j, int n) {
  return (j >= 0 && j < n) ? j : n;
}

// zeroes `bytes` at p (16-byte aligned when bytes % 16 == 0), one warp
__device__ __forceinline__ void zero_row(char* p, int bytes, int lane) {
  if (bytes % 16 == 0) {
    for (int i = 16 * lane; i < bytes; i += 16 * 32) {
      *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else if (bytes % 4 == 0) {
    for (int i = 4 * lane; i < bytes; i += 4 * 32) {
      *reinterpret_cast<unsigned*>(p + i) = 0u;
    }
  } else {
    for (int i = 2 * lane; i < bytes; i += 2 * 32) {
      *reinterpret_cast<unsigned short*>(p + i) = 0;
    }
  }
}

// CLUSTER blocks per batch element (a thread-block cluster when more than
// one), blockDim.x / 32 warps each.  Block q = blockIdx.x % CLUSTER of
// element blockIdx.x / CLUSTER takes its entries [q * span, (q + 1) * span),
// span = ceil(m / CLUSTER).  Its counts, (warps + CLUSTER) * (n + 1) ints
// (per warp, then every block's totals), lie in dynamic shared memory when
// scratch is null, else in scratch, that many ints per element (CLUSTER
// 1).  With out non-null, the rows of out [B, n] (row_bytes each) that no
// index names are zeroed, and so are the tickets [B, n, slices] of every
// row.
template <int CLUSTER>
__global__ void __launch_bounds__(kCsrMaxWarps * 32)
gather_rows_backward_csr_kernel(const int* __restrict__ idx,
                                int* __restrict__ offsets,
                                int* __restrict__ order,
                                int* __restrict__ scratch, int n, int m,
                                char* __restrict__ out, int row_bytes,
                                int* __restrict__ tickets, int slices) {
  constexpr int cluster = CLUSTER;
  extern __shared__ int csr_smem[];
  __shared__ int wsum[32];
  namespace cg = cooperative_groups;
  const int bins = n + 1;
  const int warps = blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int b = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  int* wc = scratch ? scratch + (int64_t)b * (warps + 1) * bins
                    : csr_smem;  // [warps][bins]
  int* tot = wc + warps * bins;  // [CLUSTER][bins], each block's totals
  const int* ib = idx + (int64_t)b * m;
  int* ob = offsets + (int64_t)b * bins;
  int* rb = order + (int64_t)b * m;
  const int bspan = (m + cluster - 1) / cluster;
  const int blo = min(rank * bspan, m), bhi = min(blo + bspan, m);
  const int span = (bhi - blo + warps - 1) / warps;
  const int lo = min(blo + w * span, bhi), hi = min(lo + span, bhi);
  int* mine = wc + w * bins;

  for (int i = tid; i < warps * bins; i += blockDim.x) wc[i] = 0;
  __syncthreads();
  // 1. each warp counts its range's entries per bin (a count does not
  // depend on the order of the adds)
  for (int j = lo + lane; j < hi; j += 32) {
    atomicAdd(mine + bin_of(__ldg(ib + j), n), 1);
  }
  __syncthreads();
  // 2. per bin, each warp's count becomes the count of this block's warps
  // before it; the block's total goes to row `rank` of every block's tot
  // (stores through the cluster, which its barrier completes)
  for (int r = tid; r < bins; r += blockDim.x) {
    int run = 0;
    for (int v = 0; v < warps; ++v) {
      const int t = wc[v * bins + r];
      wc[v * bins + r] = run;
      run += t;
    }
    if constexpr (CLUSTER > 1) {
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) {
        *cg::this_cluster().map_shared_rank(tot + rank * bins + r, q) = run;
      }
    } else {
      tot[r] = run;
    }
  }
  // every block's totals are in place before any block reads them; no
  // block touches another's shared memory after this
  if constexpr (CLUSTER > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  // 3. exclusive scan over the bins of the element's totals (every block of
  // the cluster scans them all): each thread a run of bins, a shuffle scan
  // over the threads of a warp, then over the warps; a bin's start, plus
  // the counts of the blocks before this one, plus those of the warps
  // before each warp, is that warp's first position in the bin
  const int per = (bins + blockDim.x - 1) / blockDim.x;
  const int r0 = min(tid * per, bins), r1 = min(r0 + per, bins);
  int local = 0;
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) local += tot[q * bins + r];
  }
  int inc = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int x = lane < warps ? wsum[lane] : 0;
    int y = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, y, off);
      if (lane >= off) y += t;
    }
    if (lane < warps) wsum[lane] = y - x;
  }
  __syncthreads();
  int run = wsum[w] + inc - local;
  for (int r = r0; r < r1; ++r) {
    int all = 0, before = 0;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) {
      const int t = tot[q * bins + r];
      all += t;
      if (q < rank) before += t;
    }
    if (rank == 0) ob[r] = run;
    for (int v = 0; v < warps; ++v) wc[v * bins + r] += run + before;
    // a bin no index names: its counts are never read again
    if (all == 0) wc[r] = -1;
    run += all;
  }
  __syncthreads();
  // 4. the rows no index names are zeroed, and every row's tickets, by
  // the block of the row's rank modulo the cluster, a warp a row
  if (out != nullptr) {
    for (int r = rank + cluster * w; r < n; r += cluster * warps) {
      for (int u = lane; u < slices; u += 32) {
        tickets[((int64_t)b * n + r) * slices + u] = 0;
      }
      if (wc[r] < 0) {
        zero_row(out + ((int64_t)b * n + r) * row_bytes, row_bytes, lane);
      }
    }
  }
  // 5. each warp walks its range again, 32 entries a step, the bins of
  // kCsrSteps steps loaded together: an entry goes to the warp's next
  // position in its bin plus its rank among the lanes before it with the
  // same bin.  The lanes with its bin come from 32 broadcasts:
  // __match_any_sync took ~1 us a step when the 32 bins differ, as a ball
  // query's do (NVIDIA H100 80GB HBM3, 700 W).  An idle lane takes a bin of
  // its own.
  for (int j0 = lo; j0 < hi; j0 += 32 * kCsrSteps) {
    int bin[kCsrSteps];
#pragma unroll
    for (int u = 0; u < kCsrSteps; ++u) {
      const int j = j0 + 32 * u + lane;
      bin[u] = j < hi ? bin_of(__ldg(ib + j), n) : -1 - lane;
    }
#pragma unroll
    for (int u = 0; u < kCsrSteps; ++u) {
      if (j0 + 32 * u >= hi) break;  // warp-uniform
      unsigned peers = 0u;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        peers |= (__shfl_sync(kFull, bin[u], l) == bin[u] ? 1u : 0u) << l;
      }
      if (bin[u] >= 0) {
        rb[mine[bin[u]] + __popc(peers & below)] = j0 + 32 * u + lane;
      }
      __syncwarp();
      if (bin[u] >= 0 && (peers & below) == 0u) mine[bin[u]] += __popc(peers);
      __syncwarp();
    }
  }
}

// T is the loaded and stored element (float, float4, __nv_bfloat16 or uint4
// of 8 bf16), A = Acc<T> its float32 sum and the type of the partial slots;
// c counts elements of T in a row.  G lanes take a row (G < 32: one element
// each, 32 / G groups; G = 32: VPL elements each, and `slices` warps share a
// piece, each taking 32 * VPL elements of the rows).  tickets [B, n,
// slices], zeroed by the CSR build.
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(kSumWarps * 32)
gather_rows_backward_sum_kernel(const T* __restrict__ g,
                                const int* __restrict__ idx,
                                const int* __restrict__ offsets,
                                const int* __restrict__ order,
                                T* __restrict__ out, Acc<T>* __restrict__ part,
                                int* __restrict__ tickets, int n, int m, int c,
                                int pieces, int slices) {
  using A = Acc<T>;
  const int b = blockIdx.y;
  const int w = blockIdx.x * kSumWarps + threadIdx.x / 32;  // warp-uniform
  const int p = w / slices, slice = w % slices;
  const int lane = threadIdx.x & 31;
  const int* ob = offsets + (int64_t)b * (n + 1);
  const int total = __ldg(ob + n);  // in-range entries
  const int s = p * kPiece;
  if (p >= pieces || s >= total) return;
  const int cnt = min(kPiece, total - s);
  const int e = s + cnt;
  const T* gb = g + (int64_t)b * m * c;

  // lane i: the m and the row of piece entry i
  int mi = 0, ri = -1;
  if (lane < cnt) {
    mi = __ldg(order + (int64_t)b * m + s + lane);
    ri = __ldg(idx + (int64_t)b * m + mi);
  }
  const int prev = __shfl_up_sync(kFull, ri, 1);
  // the first entry of each run of one row
  const unsigned starts =
      __ballot_sync(kFull, lane < cnt && (lane == 0 || ri != prev));
  const int r_first = __shfl_sync(kFull, ri, 0);
  const int r_last = __shfl_sync(kFull, ri, cnt - 1);
  const bool head_open = __ldg(ob + r_first) < s;    // began before the piece
  const bool tail_open = __ldg(ob + r_last + 1) > e;  // goes on after it
  A* const slot0 = part + ((int64_t)b * pieces + p) * 2 * c;
  const A* const pb = part + (int64_t)b * pieces * 2 * c;

  // element col of the run [lo, hi) of row r: a whole row to out, narrowed
  // once; a part of a row that spans pieces to its float32 slot
  auto put = [&](int lo, int hi, int r, int col, const A& v) {
    const bool first = lo == 0 && head_open;
    if (!first && !(hi == cnt && tail_open)) {
      out[((int64_t)b * n + r) * c + col] = narrow<T>(v);
    } else {
      (first ? slot0 : slot0 + c)[col] = v;
    }
  };
  // after the run [lo, hi) of row r is put (warp-uniform): if it went to a
  // slot, this warp's ticket of the row; the warp that takes the row's last
  // ticket adds its partials in piece order, its first piece's slot 1, then
  // slot 0 of each later one, into its elements c0 + lane + 32 v
  auto settle = [&](int lo, int hi, int r, int c0) {
    const bool first = lo == 0 && head_open;
    if (!first && !(hi == cnt && tail_open)) return;
    // release: every lane's part of the slot before the ticket
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    __syncwarp();
    int ticket = 0;
    if (lane == 0) {
      ticket = atomicAdd(tickets + ((int64_t)b * n + r) * slices + slice, 1);
    }
    ticket = __shfl_sync(kFull, ticket, 0);
    const int p0 = __ldg(ob + r) / kPiece, p1 = (__ldg(ob + r + 1) - 1) / kPiece;
    if (ticket < p1 - p0) return;  // a piece's warp that has not come yet
    // acquire: the other pieces' slots after their tickets
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
#pragma unroll
    for (int v = 0; v < (G < 32 ? 1 : VPL); ++v) {
      const int col = c0 + lane + 32 * v;
      if (col >= c) continue;
      A acc = load_cg(pb + ((int64_t)p0 * 2 + 1) * c + col);
      for (int q = p0 + 1; q <= p1; ++q) {
        add_to(acc, load_cg(pb + (int64_t)q * 2 * c + col));
      }
      out[((int64_t)b * n + r) * c + col] = narrow<T>(acc);
    }
  };

  if constexpr (G < 32) {
    constexpr int NG = 32 / G;      // groups
    constexpr int PER = kPiece / NG;  // entries per group
    const int q = lane / G, u = lane % G;
    T val[PER];
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int i = q + NG * t;
      const int src = __shfl_sync(kFull, mi, i);
      val[t] = (i < cnt && u < c) ? __ldg(gb + (int64_t)src * c + u)
                                  : zero<T>();
    }
    unsigned rest = starts;
    while (rest) {
      const int lo = __ffs(rest) - 1;
      rest &= rest - 1;
      const int hi = rest ? __ffs(rest) - 1 : cnt;
      A acc = zero<A>();
#pragma unroll
      for (int t = 0; t < PER; ++t) {
        const int i = q + NG * t;
        if (i >= lo && i < hi) add_to(acc, widen(val[t]));
      }
#pragma unroll
      for (int off = G; off < 32; off <<= 1) add_to(acc, shfl_xor(acc, off));
      const int r = __shfl_sync(kFull, ri, lo);
      if (q == 0 && u < c) put(lo, hi, r, u, acc);
    }
  } else {
    constexpr int BATCH = kSumBatch;
    const int c0 = slice * 32 * VPL;  // this warp's first element
    A acc[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) acc[v] = zero<A>();
    int lo = 0;  // first entry of the run being summed
    for (int i0 = 0; i0 < cnt; i0 += BATCH) {
      T val[BATCH][VPL];
#pragma unroll
      for (int t = 0; t < BATCH; ++t) {
        const int i = i0 + t;
        const T* src = gb + (int64_t)__shfl_sync(kFull, mi, min(i, 31)) * c;
#pragma unroll
        for (int v = 0; v < VPL; ++v) {
          const int col = c0 + lane + 32 * v;
          val[t][v] = (i < cnt && col < c) ? __ldg(src + col) : zero<T>();
        }
      }
#pragma unroll
      for (int t = 0; t < BATCH; ++t) {
        const int i = i0 + t;
        if (i >= cnt) break;
        if (i > lo && ((starts >> i) & 1u)) {  // a new run: store the last
          const int r = __shfl_sync(kFull, ri, lo);
#pragma unroll
          for (int v = 0; v < VPL; ++v) {
            const int col = c0 + lane + 32 * v;
            if (col < c) put(lo, i, r, col, acc[v]);
            acc[v] = zero<A>();
          }
          lo = i;
        }
#pragma unroll
        for (int v = 0; v < VPL; ++v) add_to(acc[v], widen(val[t][v]));
      }
    }
    const int r = __shfl_sync(kFull, ri, lo);
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int col = c0 + lane + 32 * v;
      if (col < c) put(lo, cnt, r, col, acc[v]);
    }
  }
  // the rows this piece may have put in slots: its first run's and its
  // last run's (one run: both)
  const int c0 = G < 32 ? 0 : slice * 32 * VPL;
  const unsigned later = starts & ~1u;
  const int first_end = later ? __ffs(later) - 1 : cnt;
  settle(0, first_end, r_first, c0);
  if (later) settle(31 - __clz(starts), cnt, r_last, c0);
}

// The CSR build's shape for n rows and m entries: blocks per element (a
// cluster of kCsrCluster, kCsrClusterWarps warps each, up to
// kCsrClusterBins bins; else one), warps per block (one block: as many as
// its entries need, at least kCsrMinWarps and at most kCsrMaxWarps; all as
// far as their counts fit in shared memory; if not even one warp's do,
// kCsrGlobalWarps with the counts in device scratch).
struct CsrShape {
  int cluster, warps;
  bool in_scratch;
};

CsrShape csr_shape(int n, int m) {
  CsrShape sh;
  const int fit = kCsrMaxSmem / (int)sizeof(int) / (n + 1) - 1;
  sh.in_scratch = fit < 1;
  sh.cluster = !sh.in_scratch && n + 1 <= kCsrClusterBins ? kCsrCluster : 1;
  const int cluster_fit = fit + 1 - kCsrCluster;  // beside every block's totals
  const int want = max(m > 32 ? (m + 31) / 32 : 1, kCsrMinWarps);
  sh.warps = sh.in_scratch         ? kCsrGlobalWarps
             : sh.cluster > 1      ? min(cluster_fit, kCsrClusterWarps)
                                   : min(min(fit, kCsrMaxWarps), want);
  return sh;
}

// scratch: null, or csr_scratch_ints(n, m) ints per element when that is
// not 0
int64_t csr_scratch_ints(int n, int m) {
  const CsrShape sh = csr_shape(n, m);
  return sh.in_scratch ? (int64_t)(sh.warps + 1) * (n + 1) : 0;
}

cudaError_t launch_csr(const int* idx, int* offsets, int* order, int* scratch,
                       int b, int n, int m, char* out, int row_bytes,
                       int* tickets, int slices, cudaStream_t stream) {
  const CsrShape sh = csr_shape(n, m);
  if (sh.in_scratch && scratch == nullptr) return cudaErrorInvalidValue;
  const int smem = sh.in_scratch ? 0
                                 : (sh.warps + sh.cluster) * (n + 1) *
                                       (int)sizeof(int);
  auto kernel = sh.cluster > 1 ? gather_rows_backward_csr_kernel<kCsrCluster>
                               : gather_rows_backward_csr_kernel<1>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  if (sh.cluster > 8) {  // past the portable cluster size
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(b * sh.cluster));
  cfg.blockDim = dim3((unsigned)(sh.warps * 32));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = sh.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, idx, offsets, order,
                           sh.in_scratch ? scratch : nullptr, n, m, out,
                           row_bytes, tickets, slices);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

template <typename T, int G, int VPL>
void launch_sum(const void* g, const int* idx, const int* offsets,
                const int* order, void* out, void* part, int* tickets, int b,
                int n, int m, int c, int pieces, int slices,
                cudaStream_t stream) {
  const int warps = pieces * slices;
  const dim3 grid((unsigned)((warps + kSumWarps - 1) / kSumWarps), (unsigned)b);
  gather_rows_backward_sum_kernel<T, G, VPL><<<grid, kSumWarps * 32, 0, stream>>>(
      static_cast<const T*>(g), idx, offsets, order, static_cast<T*>(out),
      static_cast<Acc<T>*>(part), tickets, n, m, c, pieces, slices);
}

// the warps that share a piece of c elements of T: one up to 32 elements,
// then one per 64
int sum_slices(int c) { return c <= 32 ? 1 : (c + 63) / 64; }

template <typename T>
cudaError_t launch_backward(const void* g, const int* idx, int* offsets,
                            int* order, int* scratch, void* part, int* tickets,
                            void* out, int b, int n, int m, int c,
                            cudaStream_t stream) {
  const int slices = sum_slices(c);
  cudaError_t err =
      launch_csr(idx, offsets, order, scratch, b, n, m, static_cast<char*>(out),
                 c * (int)sizeof(T), tickets, slices, stream);
  if (err != cudaSuccess) return err;
  const int pieces = (m + kPiece - 1) / kPiece;
  if (pieces > 0) {
    // narrow rows: lane groups of the least power of two >= c; wide rows:
    // warps of 64 elements each (one each up to 32), so that a C=512 piece
    // is two warps with 8 rows of 1 KB in flight each
    auto sum = &launch_sum<T, 32, 2>;
    if (c <= 1) {
      sum = &launch_sum<T, 1, 1>;
    } else if (c <= 2) {
      sum = &launch_sum<T, 2, 1>;
    } else if (c <= 4) {
      sum = &launch_sum<T, 4, 1>;
    } else if (c <= 8) {
      sum = &launch_sum<T, 8, 1>;
    } else if (c <= 16) {
      sum = &launch_sum<T, 16, 1>;
    } else if (c <= 32) {
      sum = &launch_sum<T, 32, 1>;
    }
    sum(g, idx, offsets, order, out, part, tickets, b, n, m, c, pieces,
        slices, stream);
    err = cudaGetLastError();
  }
  return err;
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

// points [B,N,C] bf16, idx [B,M] int32, out [B,M,C] bf16, each row an exact
// copy.  vec8 != 0 asks for the 8-bf16 (16-byte) path: C % 8 == 0 and all
// three pointers 16-byte aligned.  Returns a cudaError_t.
int cmflow_gather_rows_bf16(const void* points, const void* idx, void* out,
                            int b, int n, int m, int c, int vec8,
                            void* stream) {
  if (n < 1 || c < 1 || (vec8 && c % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t rows = (int64_t)b * m;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec8) {
    err = launch<uint4>(points, idx, out, n, m, c / 8, rows * (c / 8), st);
  } else {
    err = launch<__nv_bfloat16>(points, idx, out, n, m, c, rows * c, st);
  }
  return (int)err;
}

// The int32 scratch the CSR build of n rows and m entries needs per batch
// element, for the scratch argument below: 0 when its counts fit in shared
// memory (scratch may then be null); -1 past 2^31 - 1.
int cmflow_gather_rows_csr_scratch(int n, int m) {
  const int64_t ints = n < 1 || m < 0 ? 0 : csr_scratch_ints(n, m);
  return ints > 0x7fffffff ? -1 : (int)ints;
}

// The CSR form of each element's indices: offsets [B,N+1] int32 (row r's
// entries are sorted positions [offsets[r], offsets[r+1]); offsets[N] counts
// the in-range entries) and order [B,M] int32 (the m of each sorted position,
// out-of-range indices last), stable in m.  scratch: [B, S] int32, S from
// cmflow_gather_rows_csr_scratch.  Returns a cudaError_t.
int cmflow_gather_rows_csr(const void* idx, void* offsets, void* order,
                           void* scratch, int b, int n, int m, void* stream) {
  if (n < 1 || m < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  return (int)launch_csr(static_cast<const int*>(idx),
                         static_cast<int*>(offsets), static_cast<int*>(order),
                         static_cast<int*>(scratch), b, n, m, nullptr, 0,
                         nullptr, 0, static_cast<cudaStream_t>(stream));
}

// The int32 tickets per row of the backward below, for rows of `elems`
// elements of its load type (c / 4 or c / 8 on the vector paths, else c).
int cmflow_gather_rows_backward_slices(int elems) {
  return sum_slices(elems);
}

// g [B,M,C] f32, idx [B,M] int32, out [B,N,C] f32, every row of out written.
// Scratch: offsets [B,N+1] and order [B,M] int32, the CSR build's scratch
// as above, part [B, ceil(M/32), 2, C] f32, tickets [B, N, S] int32 (S from
// cmflow_gather_rows_backward_slices).  vec4 != 0 asks for the float4 path:
// C % 4 == 0 and g, part and out 16-byte aligned.  Any C.  Two launches;
// returns a cudaError_t.
int cmflow_gather_rows_backward(const void* g, const void* idx, void* offsets,
                                void* order, void* scratch, void* part,
                                void* tickets, void* out, int b, int n, int m,
                                int c, int vec4, void* stream) {
  if (n < 1 || c < 1 || m < 0 || (vec4 && c % 4 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int elems = vec4 ? c / 4 : c;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(idx);
  int* of = static_cast<int*>(offsets);
  int* od = static_cast<int*>(order);
  int* sc = static_cast<int*>(scratch);
  int* tk = static_cast<int*>(tickets);
  if (vec4) {
    return (int)launch_backward<float4>(g, it, of, od, sc, part, tk, out, b, n,
                                        m, elems, st);
  }
  return (int)launch_backward<float>(g, it, of, od, sc, part, tk, out, b, n, m,
                                     elems, st);
}

// g [B,M,C] bf16, idx [B,M] int32, out [B,N,C] bf16: the float32 arm's
// sums in float32, each row rounded to bf16 once.  Scratch as above, part
// [B, ceil(M/32), 2, C] float32.  vec8 != 0 asks for the 8-bf16 path: C % 8
// == 0 and g, out 16-byte aligned (part always is).  Any C.  Two launches;
// returns a cudaError_t.
int cmflow_gather_rows_backward_bf16(const void* g, const void* idx,
                                     void* offsets, void* order, void* scratch,
                                     void* part, void* tickets, void* out,
                                     int b, int n, int m, int c, int vec8,
                                     void* stream) {
  if (n < 1 || c < 1 || m < 0 || (vec8 && c % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const int elems = vec8 ? c / 8 : c;
  if (b == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(idx);
  int* of = static_cast<int*>(offsets);
  int* od = static_cast<int*>(order);
  int* sc = static_cast<int*>(scratch);
  int* tk = static_cast<int*>(tickets);
  if (vec8) {
    return (int)launch_backward<uint4>(g, it, of, od, sc, part, tk, out, b, n,
                                       m, elems, st);
  }
  return (int)launch_backward<__nv_bfloat16>(g, it, of, od, sc, part, tk, out,
                                             b, n, m, elems, st);
}

const char* cmflow_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
