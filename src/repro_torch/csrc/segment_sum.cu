// Sorted segment sum for Hopper (sm_90a): one launch, one pass, no scratch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/segment_sum.py:50
// (segment_sum), the join-group-by reduction under every PageRank
// iteration. The reference reformulates the reduction as a one-hot matmul
// over the whole (n+1)-row output block so that it runs on the TPU's matrix
// unit; that costs O(n * m) work and is not carried over. This kernel uses
// what the reference only assumes: the segment ids are ascending, so each
// segment's rows are one contiguous range.
//
// What bounds it on an H100: device-memory bytes. Each id and value is read
// once and each output row written once, with one add per value, far below
// the card's float32 rate: at the serving slice's shape (m = 4,859,264
// rows, n = 1,048,576, F = 1) 43 MB, 12.9 us at 3.35 TB/s.
//
// Ownership, the rule that makes one pass enough: rows are cut into fixed
// chunks, and a chunk's owner (a block for F = 1, a warp for F > 1) owns
// the segments that *start* in its chunk. It skips the leading rows that
// continue the previous chunk's last segment, and reads on past its chunk
// end to finish its own last segment. So every segment is summed by exactly
// one owner, without atomics, carries between blocks or a second pass, and
// the result is deterministic. Empty segments are written as 0 by the owner
// of the segment before them (the gap between ids[r-1] and ids[r]); the
// ids below ids[0] by the first owner and those above ids[m-1] by the last.
// Ids outside [0, n) (the phantom padding segment n) are summed but never
// written. Accumulation is float32 for every input type.
//
// F = 1 (the PageRank shape): a block of 256 threads owns 2,048 rows, 8 per
// thread, read with 16-byte loads. Chunks are laid out from the 16-byte
// line that holds ids[0], so a misaligned ids pointer only shifts the
// chunks (the rows before 0 in the first line are masked); values take
// 16-byte loads when their misalignment matches the ids', scalar loads
// otherwise. Each thread reduces its run of rows sequentially; across
// threads a segmented scan (head flags, warp shuffles, one shared-memory
// pass over the warps) gives each thread the sum of the segment open at
// its first row, and the thread that sees a segment's successor writes it.
// A segment that runs past the chunk is finished by the whole block, 256
// rows a step (the first step loaded with the chunk), until a row with
// another id appears.
//
// F > 1: a warp owns 64 rows; lanes span the features (32 at a time), ids
// arrive 32 at a time and are broadcast with shuffles, and the warp walks
// its rows in order.
//
// Known weakness: a power-law hub's segment is summed by the one block (or
// warp) that owns it, at 256 (or 1) rows a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                   // rows per thread (F = 1)
constexpr int kChunk = kThreads * kRows;   // rows owned per block (F = 1)
constexpr int kUnitRows = 64;              // rows owned per warp (F > 1)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// segmented-scan element: whether a segment starts in the span, and the sum
// of the span's rows after its last start (all its rows if none starts)
struct Carry {
  int f;
  float s;
};
__device__ __forceinline__ Carry combine(Carry a, Carry b) {
  return {a.f | b.f, b.f ? b.s : a.s + b.s};
}

// out[id] = sum (F = 1) for an id in [0, n), and 0 for the empty ids
// strictly between id and next
__device__ __forceinline__ void close_segment(float* out, long long n,
                                              long long id, float sum,
                                              long long next) {
  if (id >= 0 && id < n) out[id] = sum;
  const long long hi = next < n ? next : n;
  for (long long e = id + 1 < 0 ? 0 : id + 1; e < hi; ++e) out[e] = 0.f;
}

// zeros for [lo, hi) x F, the threads of a block (or lanes of a warp,
// `stride` 32) striding over the elements
__device__ __forceinline__ void zero_range(float* out, long long lo,
                                           long long hi, long long n, int F,
                                           int tid, int stride) {
  if (lo < 0) lo = 0;
  if (hi > n) hi = n;
  for (long long e = lo * F + tid; e < hi * F; e += stride) out[e] = 0.f;
}

// the ids below ids[0] (first owner) and above ids[m-1] (last owner)
__device__ __forceinline__ void zero_ends(const int* ids, float* out,
                                          long long m, long long n, int F,
                                          bool first, bool last, int tid,
                                          int stride) {
  if (first) zero_range(out, 0, ids[0], n, F, tid, stride);
  if (last) zero_range(out, (long long)ids[m - 1] + 1, n, n, F, tid, stride);
}

template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ values,
                                          const int* __restrict__ ids,
                                          long long base, long long m,
                                          bool vec_values, int* id, float* v) {
#pragma unroll
  for (int g = 0; g < kRows / 4; ++g) {
    const long long r = base + 4 * g;
    if (r >= 0 && r + 3 < m) {
      // (r + misalignment) % 4 == 0: a whole 16-byte line of ids
      const int4 q = *reinterpret_cast<const int4*>(ids + r);
      id[4 * g] = q.x;
      id[4 * g + 1] = q.y;
      id[4 * g + 2] = q.z;
      id[4 * g + 3] = q.w;
      if constexpr (sizeof(T) == 4) {
        if (vec_values) {
          const float4 f = *reinterpret_cast<const float4*>(values + r);
          v[4 * g] = f.x;
          v[4 * g + 1] = f.y;
          v[4 * g + 2] = f.z;
          v[4 * g + 3] = f.w;
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * g + e] = to_float(values[r + e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long rr = r + e;
        const bool ok = rr >= 0 && rr < m;
        id[4 * g + e] = ok ? ids[rr] : 0;
        v[4 * g + e] = ok ? to_float(values[rr]) : 0.f;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_f1_kernel(const T* __restrict__ values,
                      const int* __restrict__ ids, float* __restrict__ out,
                      long long m, long long n, int misalign,
                      bool vec_values) {
  __shared__ Carry s_warp[kWarps];
  __shared__ float s_part[kWarps];
  __shared__ int s_open, s_cur;
  __shared__ float s_acc;
  __shared__ unsigned long long s_next_row;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (m == 0) {  // no rows: every segment is empty
    zero_range(out, 0, n, n, 1, blockIdx.x * kThreads + tid,
               gridDim.x * kThreads);
    return;
  }
  zero_ends(ids, out, m, n, 1, blockIdx.x == 0, blockIdx.x == gridDim.x - 1,
            tid, kThreads);

  // this block's chunk: rows [lo, lo + kChunk), lo + misalign 16-B aligned
  const long long lo = (long long)blockIdx.x * kChunk - misalign;
  const bool has_prev = lo > 0;
  const int prev_id = has_prev ? ids[lo - 1] : 0;  // not ours if continued
  const long long base = lo + (long long)kRows * tid;

  int id[kRows];
  float v[kRows];
  load_rows(values, ids, base, m, vec_values, id, v);
  // the first step past the chunk, loaded now: most chunks end inside a
  // segment, and this hides the finishing step's load behind the first
  long long r_next = lo + kChunk + tid;
  bool ok_next = r_next < m;
  int id_next = ok_next ? ids[r_next] : 0;
  float v_next = ok_next ? to_float(values[r_next]) : 0.f;
  // id of the row before this thread's first: the previous lane's last
  int before = __shfl_up_sync(kFull, id[kRows - 1], 1);
  if (lane == 0) before = (base >= 1 && base - 1 < m) ? ids[base - 1] : 0;
  auto included = [&](long long r, int x) {
    return r >= 0 && r < m && !(has_prev && x == prev_id);
  };
  const bool prev_inc = tid > 0 && included(base - 1, before);

  // this thread's scan element
  Carry mine = {0, 0.f};
  {
    int last = before;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long r = base + i;
      if (included(r, id[i])) {
        if (r == 0 || id[i] != last) mine = {1, v[i]};
        else mine.s += v[i];
      }
      last = id[i];
    }
  }
  // block-wide exclusive segmented scan: warp shuffles, then the warps
  Carry inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Carry up = {__shfl_up_sync(kFull, inc.f, d),
                      __shfl_up_sync(kFull, inc.s, d)};
    if (lane >= d) inc = combine(up, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  Carry ex = {0, 0.f};
  for (int w = 0; w < warp; ++w) ex = combine(ex, s_warp[w]);
  {
    const Carry up = {__shfl_up_sync(kFull, inc.f, 1),
                      __shfl_up_sync(kFull, inc.s, 1)};
    if (lane > 0) ex = combine(ex, up);
  }

  // walk the rows: a segment is written by the thread that sees its end
  float acc = ex.s;
  int cur = before;
  bool open = prev_inc;
  {
    int last = before;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long r = base + i;
      if (included(r, id[i])) {
        if (r == 0 || id[i] != last) {
          if (open) close_segment(out, n, cur, acc, id[i]);
          acc = v[i];
          cur = id[i];
          open = true;
        } else {
          acc += v[i];
        }
      } else if (open) {  // past the last row (r >= m)
        close_segment(out, n, cur, acc, (long long)cur + 1);
        open = false;
      }
      last = id[i];
    }
  }
  if (tid == kThreads - 1) {
    s_open = open;
    s_cur = cur;
    s_acc = acc;
    s_next_row = ~0ull;
  }
  __syncthreads();
  if (!s_open) return;

  // the chunk's last segment runs on past the chunk: finish it
  const int own = s_cur;
  float part = 0.f;
  for (;;) {
    const bool in = ok_next && id_next == own;
    if (in) part += v_next;
    else atomicMin(&s_next_row, (unsigned long long)r_next);
    if (__syncthreads_or(!in)) break;
    r_next += kThreads;
    ok_next = r_next < m;
    id_next = ok_next ? ids[r_next] : 0;
    v_next = ok_next && id_next == own ? to_float(values[r_next]) : 0.f;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
  if (lane == 0) s_part[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float total = s_acc;
    for (int w = 0; w < kWarps; ++w) total += s_part[w];
    const long long next = (long long)s_next_row;
    close_segment(out, n, own, total,
                  next < m ? (long long)ids[next] : (long long)own + 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows_kernel(const T* __restrict__ values,
                        const int* __restrict__ ids, float* __restrict__ out,
                        long long m, long long n, int F) {
  const int lane = threadIdx.x & 31;
  if (m == 0) {
    zero_range(out, 0, n, n, F, blockIdx.x * kThreads + threadIdx.x,
               gridDim.x * kThreads);
    return;
  }
  const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long lo = unit * kUnitRows;
  if (lo >= m) return;  // warp-uniform from here on
  const long long hi = lo + kUnitRows < m ? lo + kUnitRows : m;
  zero_ends(ids, out, m, n, F, unit == 0, hi == m, lane, 32);

  // skip the rows that continue the previous unit's last segment (a prefix:
  // the ids ascend)
  long long r = lo;
  if (lo > 0) {
    const int prev_id = ids[lo - 1];
    for (;;) {
      const long long rl = r + lane;
      const unsigned cont =
          __ballot_sync(kFull, rl < hi && ids[rl] == prev_id);
      r += __popc(cont);
      if (cont != kFull) break;
    }
    if (r >= hi) return;
  }
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int f = f0 + lane;
    const bool lane_on = f < F;
    int cur = ids[r];
    float acc = 0.f;
    bool done = false;
    for (long long rb = r; !done; rb += 32) {
      const int mine = rb + lane < m ? ids[rb + lane] : 0;
      for (int k = 0; k < 32; ++k) {
        const long long rr = rb + k;
        const int x = __shfl_sync(kFull, mine, k);
        if (rr >= m || x != cur) {
          if (lane_on && cur >= 0 && cur < n) out[(long long)cur * F + f] = acc;
          if (rr >= m) {
            done = true;
            break;
          }
          const long long gap_hi = x < n ? x : n;
          for (long long e = cur + 1 < 0 ? 0 : cur + 1; e < gap_hi; ++e)
            if (lane_on) out[e * F + f] = 0.f;
          if (rr >= hi) {
            done = true;
            break;
          }
          cur = x;
          acc = 0.f;
        }
        if (lane_on) acc += to_float(values[rr * F + f]);
      }
    }
  }
}

template <typename T>
int launch(const void* values, const int* ids, float* out, long long m,
           long long n, int F, cudaStream_t s) {
  const T* vals = (const T*)values;
  if (F == 1) {
    const int misalign = (int)((reinterpret_cast<uintptr_t>(ids) >> 2) & 3);
    const bool vec = sizeof(T) == 4 &&
                     (int)((reinterpret_cast<uintptr_t>(values) >> 2) & 3) ==
                         misalign;
    long long blocks = m == 0 ? (n + kThreads - 1) / kThreads
                              : (m + misalign + kChunk - 1) / kChunk;
    if (m == 0 && blocks > 1024) blocks = 1024;
    segment_sum_f1_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        vals, ids, out, m, n, misalign, vec);
  } else {
    long long blocks =
        m == 0 ? (n * F + kThreads - 1) / kThreads
               : ((m + kUnitRows - 1) / kUnitRows + kWarps - 1) / kWarps;
    if (m == 0 && blocks > 1024) blocks = 1024;
    segment_sum_rows_kernel<T><<<(unsigned)blocks, kThreads, 0, s>>>(
        vals, ids, out, m, n, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 values (m, F), contiguous; ids (m,)
// int32 ascending; out (n, F) float32, every row written. One launch.
int rt_segment_sum(const void* values, int dtype, const int* ids, float* out,
                   long long m, long long n, int F, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || F <= 0) return (int)cudaGetLastError();
  if (dtype == 0) return launch<float>(values, ids, out, m, n, F, s);
  if (dtype == 1) return launch<__nv_bfloat16>(values, ids, out, m, n, F, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
