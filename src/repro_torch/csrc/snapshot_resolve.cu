// Snapshot resolution kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/snapshot_resolve.py:
//   * liveness_mask    (snapshot_resolve.py:78) — the edge snapshot mask
//     ``created <= q < deleted``. The reference stacks [created, deleted]
//     into an (N, 2) version matrix with values [1, 0] and runs the general
//     resolve; that stack is a TPU tiling artifact and is not carried over.
//     Here it is one elementwise pass over the two int32 stamp columns.
//   * snapshot_resolve (snapshot_resolve.py:39) — the general multi-version
//     resolve over (N, K) ascending, int32-max-padded version rows.
//
// What bounds them on an H100: device-memory bytes. liveness_mask reads 8
// bytes and writes 1 byte per edge (9 B/edge) with three integer ops, far
// below the card's compute rate. snapshot_resolve reads K*4 bytes of
// versions plus at most one value per item and writes value + index.
//
// What the design does about it: liveness_mask gives each thread four edges
// through 16-byte int4 loads of both columns and one 4-byte store of the
// four mask bytes, so every warp moves full 512-byte lines; a scalar kernel
// covers the ragged tail and misaligned slices. snapshot_resolve is one
// thread per item looping over K (K is a small version fan-out); rows of
// neighbouring threads are adjacent, so the version reads stay coalesced
// through L1/L2, and only the selected value is gathered.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void liveness_mask_vec4(const int4* __restrict__ created,
                                   const int4* __restrict__ deleted, int q,
                                   uchar4* __restrict__ out, long long n4) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  int4 c = created[i];
  int4 d = deleted[i];
  uchar4 o;
  o.x = (c.x <= q) & (q < d.x);
  o.y = (c.y <= q) & (q < d.y);
  o.z = (c.z <= q) & (q < d.z);
  o.w = (c.w <= q) & (q < d.w);
  out[i] = o;
}

__global__ void liveness_mask_scalar(const int* __restrict__ created,
                                     const int* __restrict__ deleted, int q,
                                     unsigned char* __restrict__ out,
                                     long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (created[i] <= q) & (q < deleted[i]);
}

template <typename T>
__global__ void snapshot_resolve_kernel(const int* __restrict__ versions,
                                        const T* __restrict__ values, int q,
                                        T* __restrict__ out,
                                        int* __restrict__ index, long long n,
                                        int k) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* row = versions + i * k;
  // newest eligible slot: the largest j with versions[i, j] <= q
  int best = -1;
  for (int j = 0; j < k; ++j) {
    if (row[j] <= q) best = j;
  }
  out[i] = best >= 0 ? values[i * k + best] : T(0);
  index[i] = best;
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int rt_liveness_mask(const int* created, const int* deleted, int q,
                     unsigned char* out, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  bool aligned = ((uintptr_t)created % 16 == 0) &&
                 ((uintptr_t)deleted % 16 == 0) &&
                 ((uintptr_t)out % 4 == 0);
  long long head = 0;
  if (aligned) {
    long long n4 = n / 4;
    if (n4 > 0) {
      liveness_mask_vec4<<<blocks_for(n4), kThreads, 0, s>>>(
          (const int4*)created, (const int4*)deleted, q, (uchar4*)out, n4);
    }
    head = n4 * 4;
  }
  long long rest = n - head;
  if (rest > 0) {
    liveness_mask_scalar<<<blocks_for(rest), kThreads, 0, s>>>(
        created + head, deleted + head, q, out + head, rest);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = int32
int rt_snapshot_resolve(const int* versions, const void* values, int dtype,
                        int q, void* out, int* index, long long n, int k,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    snapshot_resolve_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        versions, (const float*)values, q, (float*)out, index, n, k);
  } else if (dtype == 1) {
    snapshot_resolve_kernel<int><<<blocks_for(n), kThreads, 0, s>>>(
        versions, (const int*)values, q, (int*)out, index, n, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
