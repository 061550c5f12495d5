// Sorted segment sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_sum.py:50
// (segment_sum), the join-group-by reduction under every PageRank
// iteration. The reference reformulates the reduction as a one-hot matmul
// over the whole (n+1)-row output block so that it runs on the TPU's matrix
// unit; that costs O(n * m) work and is not carried over. This kernel uses
// what the reference only assumes: the segment ids are ascending, so each
// segment's rows are one contiguous range. A first kernel finds the ranges
// (``starts``, n+1 entries) in one pass over the ids: the thread at each
// row boundary writes the start of every segment that begins there, empty
// segments included.
//
// What bounds it on an H100: device-memory bytes — each value row is read
// once and each output row written once, with one add per value, far below
// the card's float32 rate.
//
// What the design does about it: a team of lanes per segment, no atomics,
// so the sum is deterministic. Within a team, lanes split into row groups
// of G lanes (G = F for F a power of two up to 32, else 32 lanes walking
// the features in chunks): neighbouring lanes read neighbouring features
// of neighbouring rows, so loads coalesce, and a shuffle tree adds the row
// groups at the end. The team covers about as many rows per step as a
// segment holds on average (m / n, rounded down to a power of two), so a
// warp serves 32 / team segments at once: with a whole warp per segment,
// the short segments of a sparse graph (about 5 rows each in the serving
// slice) left most lanes idle and the kernel latency-bound. Accumulation
// is float32 for every input type; rows outside [0, n) (the phantom
// padding segment) are never visited; empty segments are 0. Known
// weakness: a power-law hub's segment is still reduced by one team.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// starts[s] = first row r with ids[r] >= s, for s in [0, n]. Thread r in
// [0, m] owns the boundary before row r: the segments s with
// ids[r - 1] < s <= ids[r] (clamped to [0, n]) start there.
__global__ void segment_starts_kernel(const int* __restrict__ ids,
                                      long long m, long long n,
                                      long long* __restrict__ starts) {
  long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r > m) return;
  long long lo = r == 0 ? 0 : (long long)ids[r - 1] + 1;
  long long hi = r == m ? n : (long long)ids[r];
  if (lo < 0) lo = 0;
  if (hi > n) hi = n;
  for (long long s = lo; s <= hi; ++s) starts[s] = r;
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ values,
                                   const long long* __restrict__ starts,
                                   float* __restrict__ out, long long n,
                                   int F, int team_lanes, int group_lanes) {
  int teams_per_warp = 32 / team_lanes;
  long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp * teams_per_warp >= n) return;  // warp-uniform
  int lane = threadIdx.x & 31;
  long long seg = warp * teams_per_warp + lane / team_lanes;
  bool active = seg < n;
  int tl = lane % team_lanes;  // lane within the team
  int groups = team_lanes / group_lanes;
  int g = tl / group_lanes;
  int sub = tl % group_lanes;
  long long begin = active ? starts[seg] : 0;
  long long end = active ? starts[seg + 1] : 0;
  for (int f0 = 0; f0 < F; f0 += group_lanes) {
    int f = f0 + sub;
    float acc = 0.f;
    if (f < F) {
      for (long long r = begin + g; r < end; r += groups) {
        acc += to_float(values[r * F + f]);
      }
    }
    // every lane of the warp takes part; offsets below team_lanes stay
    // inside the team
    for (int off = team_lanes >> 1; off >= group_lanes; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (active && g == 0 && f < F) out[seg * F + f] = acc;
  }
}

inline int pow2_floor(long long x) {
  int p = 1;
  while (p * 2LL <= x && p < 32) p *= 2;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. ids: (m,) int32 ascending. starts:
// (n + 1,) int64 scratch the caller allocates. m also sets how many lanes
// a segment's team gets.
int rt_segment_sum(const void* values, int dtype, const int* ids,
                   long long* starts, float* out, long long m, long long n,
                   int F, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || F <= 0) return (int)cudaGetLastError();
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  segment_starts_kernel<<<(unsigned)((m + kThreads) / kThreads), kThreads, 0,
                          s>>>(ids, m, n, starts);
  int group_lanes = 32;
  if (F <= 32 && (F & (F - 1)) == 0) group_lanes = F;
  int rows_per_step = pow2_floor(m / n);
  int team_lanes = group_lanes * rows_per_step;
  if (team_lanes > 32) team_lanes = 32;
  long long teams_per_block = (long long)kWarpsPerBlock * (32 / team_lanes);
  unsigned blocks = (unsigned)((n + teams_per_block - 1) / teams_per_block);
  if (dtype == 0) {
    segment_sum_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)values, starts, out, n, F, team_lanes, group_lanes);
  } else {
    segment_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)values, starts, out, n, F, team_lanes,
        group_lanes);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
