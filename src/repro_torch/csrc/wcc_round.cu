// One round of WCC's min-label propagation for Hopper (sm_90a): one pass
// over the edge list.
//
// Replaces no TPU kernel. The reference computes WCC with
// jax.ops.segment_min (src/repro/graph/compute.py:155-173), two scatter-mins
// a round that XLA lowers, and has no Pallas kernel for it. The port's plain
// round is two full-length scatter_reduce_ passes (each filling an n-sized
// output first), two gathers and two int64 copies of the ids: some 700 MB a
// round at the timeline's shape, most of the time of a temporal-analytics
// version. This kernel was added to move only the round's own bytes.
//
// What it computes (synchronous, as the reference: every label read comes
// from the round's input, so no label moves more than one hop a round):
//   out[v] = min(in[v], min over edges (u, v) of in[u],
//                       min over edges (v, w) of in[w])
// The C entry first copies in to out; the kernel then only lowers out with
// atomicMin. Integer min is order-free, so the result is bit-equal to the
// plain round whatever order the atomics land in. An edge with an endpoint
// outside [0, n) is dropped (never read or written out of bounds).
//
// What bounds it on an H100: device-memory bytes. Each id is read once (8
// bytes an edge) and each label read once and written once (8 bytes a
// vertex): at the timeline's shape (m = 16,777,216, n = 1,048,576) 142.6 MB,
// 42.6 us at 3.35 TB/s. The labels (4 MB at n = 2^20) stay in the 50 MB L2:
// the ids are read with evict-first loads so that the 134 MB stream does
// not push them out, and the random label reads and the atomics are L2
// traffic, not HBM.
//
// Design:
// - A thread takes 8 consecutive edges, src and dst each as two 16-byte
//   loads (scalar loads when either pointer is not 16-byte aligned, and on
//   the ragged tail).
// - An edge whose two labels are equal writes nothing, and after the first
//   round that is nearly every edge: a warp none of whose edges differs
//   stops after its loads. Of an edge with in[u] < in[v] only v can fall,
//   and with in[v] < in[u] only u: at most one write an edge.
// - The dst side: the join view's rows are sorted by dst, and Kronecker hubs
//   have up to ~10^5 in-edges. Runs of equal dst take a segmented min over
//   the warp's 256 edges (each thread's own runs, then a shuffle scan of the
//   threads' open runs), so a hub costs one atomicMin per warp it spans, and
//   only where the run's min is below the hub's label. Any order of dst is
//   correct; sorted order makes the runs long.
// - The src side: a plain atomicMin.
// - Every atomicMin is skipped when an L2 read (ld.global.cg) of out shows
//   it cannot lower it: labels only fall during a round, so a read that is
//   stale is too high, never too low, and skips no needed write.
// - changed (one int32, zeroed by the C entry): a warp sets it once if any
//   of its atomics lowered a value (returned an old value above the new).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kEdges = 8;                   // edges per thread
constexpr int kChunk = kThreads * kEdges;   // edges per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoId = -1;                   // a row past m or out of range

// segmented-scan element over a span of rows: whether a run of equal dst
// starts in the span, and the min of the span's rows after its last start
// (all its rows if none starts)
struct Run {
  int f;
  int v;
};
__device__ __forceinline__ Run combine(Run a, Run b) {
  return {a.f | b.f, b.f ? b.v : min(a.v, b.v)};
}

// lower out[i] to x; true if this call lowered it
__device__ __forceinline__ bool lower(int* out, int i, int x) {
  if (__ldcg(out + i) <= x) return false;
  return atomicMin(out + i, x) > x;
}

template <bool kVec>
__device__ __forceinline__ void load_edges(const int* __restrict__ src,
                                           const int* __restrict__ dst,
                                           long long base, long long m,
                                           long long n, int* s, int* d) {
  if (kVec && base + kEdges <= m) {
#pragma unroll
    for (int g = 0; g < kEdges / 4; ++g) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(src + base) + g);
      const int4 b = __ldcs(reinterpret_cast<const int4*>(dst + base) + g);
      s[4 * g] = a.x;
      s[4 * g + 1] = a.y;
      s[4 * g + 2] = a.z;
      s[4 * g + 3] = a.w;
      d[4 * g] = b.x;
      d[4 * g + 1] = b.y;
      d[4 * g + 2] = b.z;
      d[4 * g + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kEdges; ++i) {
      const bool ok = base + i < m;
      s[i] = ok ? __ldcs(src + base + i) : kNoId;
      d[i] = ok ? __ldcs(dst + base + i) : kNoId;
    }
  }
#pragma unroll
  for (int i = 0; i < kEdges; ++i) {
    if ((unsigned long long)(unsigned)s[i] >= (unsigned long long)n ||
        (unsigned long long)(unsigned)d[i] >= (unsigned long long)n)
      s[i] = d[i] = kNoId;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
wcc_round_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                 long long m, const int* labels_in, int* labels_out,
                 long long n, int* changed) {
  const int lane = threadIdx.x & 31;
  const long long base =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kEdges;

  int s[kEdges], d[kEdges];
  load_edges<kVec>(src, dst, base, m, n, s, d);
  // ls: the label of the edge's src, the candidate for its dst; ld: the
  // dst's own label
  int ls[kEdges], ld[kEdges];
  bool differs = false;
#pragma unroll
  for (int i = 0; i < kEdges; ++i) {
    const bool ok = d[i] != kNoId;
    ls[i] = ok ? __ldg(labels_in + s[i]) : INT_MAX;
    ld[i] = ok ? __ldg(labels_in + d[i]) : INT_MAX;
    differs |= ls[i] != ld[i];
  }
  if (!__any_sync(kFull, differs)) return;  // warp-uniform

  bool lowered = false;
  // the src side: u falls to in[v]
#pragma unroll
  for (int i = 0; i < kEdges; ++i)
    if (ld[i] < ls[i]) lowered |= lower(labels_out, s[i], ld[i]);

  // the dst side: a segmented min over the warp's runs of equal dst.
  // before: the dst of the row before this thread's first (lane 0: none,
  // so the warp's first row starts a run)
  int before = __shfl_up_sync(kFull, d[kEdges - 1], 1);
  if (lane == 0) before = INT_MIN;
  Run mine = {0, INT_MAX};
  {
    int last = before;
#pragma unroll
    for (int i = 0; i < kEdges; ++i) {
      if (d[i] != last) mine = {1, ls[i]};
      else mine.v = min(mine.v, ls[i]);
      last = d[i];
    }
  }
  Run inc = mine;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const Run up = {__shfl_up_sync(kFull, inc.f, k),
                    __shfl_up_sync(kFull, inc.v, k)};
    if (lane >= k) inc = combine(up, inc);
  }
  // the min of the run open at this thread's first row, over the lanes
  // before it
  int acc = __shfl_up_sync(kFull, inc.v, 1);
  // the dst of the next lane's first row: whether this thread's last run
  // ends here (lane 31: the warp's last run ends with the warp)
  int after = __shfl_down_sync(kFull, d[0], 1);
  if (lane == 31) after = INT_MIN;
  {
    int last = before;
#pragma unroll
    for (int i = 0; i < kEdges; ++i) {
      if (d[i] != last) acc = ls[i];
      else acc = min(acc, ls[i]);
      last = d[i];
      const int next = i + 1 < kEdges ? d[i + 1] : after;
      if (next != d[i] && d[i] != kNoId && acc < ld[i])
        lowered |= lower(labels_out, d[i], acc);
    }
  }
  if (__any_sync(kFull, lowered) && lane == 0) *changed = 1;
}

}  // namespace

extern "C" {

// src, dst: (m,) int32 edge endpoints, any order (dst-sorted runs cost one
// atomic a warp); labels_in, labels_out: (n,) int32; changed: one int32.
// Copies labels_in to labels_out, zeroes changed, then one launch lowers
// labels_out to the round's labels and sets changed to 1 if any fell. The
// wrapper refuses labels_out == labels_in; called so (in place), a round
// would read labels lowered earlier in the same round.
int rt_wcc_round(const int* src, const int* dst, long long m,
                 const int* labels_in, int* labels_out, long long n,
                 int* changed, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m < 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (labels_out != labels_in && n > 0)
    e = cudaMemcpyAsync(labels_out, labels_in, (size_t)n * sizeof(int),
                        cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const unsigned blocks = (unsigned)((m + kChunk - 1) / kChunk);
  if (vec)
    wcc_round_kernel<true><<<blocks, kThreads, 0, s>>>(
        src, dst, m, labels_in, labels_out, n, changed);
  else
    wcc_round_kernel<false><<<blocks, kThreads, 0, s>>>(
        src, dst, m, labels_in, labels_out, n, changed);
  return (int)cudaGetLastError();
}

}  // extern "C"
