// Diagonal linear recurrence for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t,  h_{-1} = h0 (0 when absent),
// over a, b of shape (B, S, C) float32, the inner loop of every RG-LRU
// layer's prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lru_scan.py:52
// (lru_scan). The reference keeps a whole (S, 256)-channel slab resident
// in VMEM and walks time in chunks; its padding of S to the time chunk
// (lru_scan.py:59-63) and its MAX_RESIDENT_S time tiling with chained
// carries (:67-77) exist only for VMEM and are not carried over: this
// kernel takes any S and an optional h0 directly.
//
// What bounds it on an H100: device-memory bytes. a and b are read once
// and h written once, 12 bytes per element and one FMA; at the serving
// shape (B = 8, S = 4096, C = 2560) that is 1.007 GB, 0.30 ms at
// 3.35 TB/s.
//
// What the design does about it: one thread per (batch, channel) walks
// time, so each chain stays in a register. Neighbouring threads take
// neighbouring channels, so every load and store of a warp is one
// 128-byte line. Each thread starts the loads of kUnroll steps ahead
// before the dependent FMA chain that consumes them, so a warp keeps
// 2 * kUnroll lines in flight. Known limit: only B * C threads exist
// (20,480 at the serving shape, about 4.8 warps per SM, 1.2 per warp
// scheduler), too few to cover the memory latency, so the kernel is
// latency-bound well above its bound. A chunked two-pass scan, which
// splits time across threads, is the fix.
//
// The backward has no TPU counterpart: the JAX package differentiates its
// plain scan with jax.grad. Given dh = dL/dh it walks time backwards:
//     g_t = dh_t + a_{t+1} g_{t+1}   (g past the end is 0)
//     db_t = g_t,  da_t = g_t h_{t-1}   (h_{-1} = h0, or 0)
//     dh0 = a_0 g_0
// Its plain version is kernels/ref.py:lru_scan_bwd. What bounds it on an
// H100: device-memory bytes. a, the forward's output h and dh are read once
// (12 bytes per element) and da, db written once (8): 20 bytes per element,
// 0.125 ms at 3.35 TB/s at the training shape (B = 2, S = 4096, C = 2560).
// At that batch there are only 5,120 chains, so one thread per chain (as
// the forward) hides too little latency. The backward splits time into
// chunks of L steps (the wrapper passes L, kernels/lru_scan.py:BWD_CHUNK)
// and runs two passes over one thread per (batch, chunk, channel), 327,680
// threads at L = 64, neighbouring threads on neighbouring channels:
//  1. lru_scan_bwd_carry_kernel walks its chunk backwards with no carry in
//     and writes, into a (2, B, n_chunks, C) float32 scratch,
//       G_k = a_{t0} g_{t0}  (g of the chunk alone, at its first step t0)
//       A_k = a_{t0} a_{t0+1} ... a_{t1-1}  (the chunk's product of a).
//     The true carry into chunk k from the right is then
//       c_k = a_{t1} g_{t1} = G_{k+1} + A_{k+1} c_{k+1},  c_{last} = 0.
//  2. lru_scan_bwd_kernel folds G and A of the chunks to its right, from
//     the last one down (a fixed order), into c_k, walks its chunk again
//     with g_{t1-1} = dh_{t1-1} + c_k and writes db and da; chunk 0 writes
//     dh0. 28 bytes per element in all (pass 1 reads a and dh again).
// No atomics and a fixed order: a call's result is the same bit for bit
// from run to run. Any S: the last chunk may be short, and S < L is one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;
constexpr int kBwdThreads = 128;

__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ out,
                long long chains, long long S, long long C) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chains) return;
  long long bi = i / C;
  long long c = i - bi * C;
  const long long base = bi * S * C + c;
  float h = h0 != nullptr ? h0[i] : 0.f;
  long long t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long off = base + (t + u) * C;
      av[u] = a[off];
      bv[u] = b[off];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      out[base + (t + u) * C] = h;
    }
  }
  for (; t < S; ++t) {
    long long off = base + t * C;
    h = fmaf(a[off], h, b[off]);
    out[off] = h;
  }
}

// pass 1: G_k and A_k of one (batch, chunk, channel)
__global__ void __launch_bounds__(kBwdThreads)
lru_scan_bwd_carry_kernel(const float* a, const float* dh, float* carry,
                          long long total, long long n_chunks, long long S,
                          long long C, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long c = i % C, bk = i / C;  // bk = b * n_chunks + k
  const long long k = bk % n_chunks, bi = bk / n_chunks;
  const long long base = bi * S * C + c;
  const long long t0 = k * L, t1 = min(S, t0 + L);
  float g = 0.f, a_next = 0.f, prod = 1.f;
  long long t = t1 - 1;
  for (; t + 1 - t0 >= kUnroll; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = a[base + (t - u) * C];
      gv[u] = dh[base + (t - u) * C];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      g = fmaf(a_next, g, gv[u]);
      a_next = av[u];
      prod *= a_next;
    }
  }
  for (; t >= t0; --t) {
    g = fmaf(a_next, g, dh[base + t * C]);
    a_next = a[base + t * C];
    prod *= a_next;
  }
  carry[i] = a_next * g;
  carry[total + i] = prod;
}

// pass 2: the carry from the right, then db, da (and dh0) of the chunk
__global__ void __launch_bounds__(kBwdThreads)
lru_scan_bwd_kernel(const float* a, const float* h, const float* h0,
                    const float* dh, const float* carry, float* da,
                    float* db, float* dh0, long long total,
                    long long n_chunks, long long S, long long C, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long c = i % C, bk = i / C;
  const long long k = bk % n_chunks, bi = bk / n_chunks;
  const long long base = bi * S * C + c;
  const long long t0 = k * L, t1 = min(S, t0 + L);
  // c_k from the last chunk down: c = G_m + A_m c for m = n - 1, ..., k + 1
  const float* gk = carry + bi * n_chunks * C + c;
  const float* ak = gk + total;
  float g = 0.f;
#pragma unroll 4
  for (long long m = n_chunks - 1; m > k; --m)
    g = fmaf(ak[m * C], g, gk[m * C]);
  const float h_init = h0 != nullptr ? h0[bi * C + c] : 0.f;
  float a_next = 1.f;  // the first step adds the carry: g = dh + c_k
  long long t = t1 - 1;
  for (; t + 1 - t0 >= kUnroll; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (t - u) * C;
      av[u] = a[off];
      gv[u] = dh[off];
      if (t - u > 0)
        hv[u] = h[off - C];
      else
        hv[u] = h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (t - u) * C;
      g = fmaf(a_next, g, gv[u]);
      db[off] = g;
      da[off] = g * hv[u];
      a_next = av[u];
    }
  }
  for (; t >= t0; --t) {
    const long long off = base + t * C;
    g = fmaf(a_next, g, dh[off]);
    db[off] = g;
    da[off] = g * (t > 0 ? h[off - C] : h_init);
    a_next = a[off];
  }
  if (dh0 != nullptr && k == 0) dh0[bi * C + c] = a_next * g;
}

}  // namespace

extern "C" {

// a, b, out: (B, S, C) float32 contiguous; h0: (B, C) float32 or null.
int rt_lru_scan(const float* a, const float* b, const float* h0, float* out,
                long long B, long long S, long long C, void* stream) {
  long long chains = B * C;
  if (chains <= 0 || S <= 0) return (int)cudaGetLastError();
  unsigned blocks = (unsigned)((chains + kThreads - 1) / kThreads);
  lru_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, h0, out, chains, S, C);
  return (int)cudaGetLastError();
}

// The gradient of rt_lru_scan, in two launches (pass 1, then pass 2, on
// one stream). a, h (its output), dh, da, db: (B, S, C) float32
// contiguous; h0: (B, C) float32 or null (then h_{-1} = 0); dh0: (B, C)
// float32 or null (not written); carry: (2, B, ceil(S / L), C) float32
// scratch; L >= 1 the chunk length.
int rt_lru_scan_bwd_carry(const float* a, const float* dh, float* carry,
                          long long B, long long S, long long C, int L,
                          void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (S + L - 1) / L, total = B * n_chunks * C;
  if (total <= 0) return (int)cudaGetLastError();
  lru_scan_bwd_carry_kernel<<<(unsigned)((total + kBwdThreads - 1) /
                                         kBwdThreads),
                              kBwdThreads, 0, (cudaStream_t)stream>>>(
      a, dh, carry, total, n_chunks, S, C, L);
  return (int)cudaGetLastError();
}

int rt_lru_scan_bwd(const float* a, const float* h, const float* h0,
                    const float* dh, const float* carry, float* da,
                    float* db, float* dh0, long long B, long long S,
                    long long C, int L, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const long long n_chunks = (S + L - 1) / L, total = B * n_chunks * C;
  if (total <= 0) return (int)cudaGetLastError();
  lru_scan_bwd_kernel<<<(unsigned)((total + kBwdThreads - 1) / kBwdThreads),
                        kBwdThreads, 0, (cudaStream_t)stream>>>(
      a, h, h0, dh, carry, da, db, dh0, total, n_chunks, S, C, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
