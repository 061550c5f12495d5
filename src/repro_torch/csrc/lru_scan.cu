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
// The backward (lru_scan_bwd_kernel, entry rt_lru_scan_bwd) has no TPU
// counterpart: the JAX package differentiates its plain scan with
// jax.grad. Given dh = dL/dh, it walks time backwards with the same
// thread-per-chain layout:
//     g_t = dh_t + a_{t+1} g_{t+1}   (g past the end is 0)
//     db_t = g_t,  da_t = g_t h_{t-1}   (h_{-1} = h0, or 0)
//     dh0 = a_0 g_0
// reading a, the forward's output h and dh once (12 bytes per element)
// and writing da and db (8 bytes): 20 bytes per element, 0.25 ms at
// 3.35 TB/s at the training shape (B = 2, S = 4096, C = 2560). Its plain
// version is kernels/ref.py:lru_scan_bwd.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

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

__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                    const float* __restrict__ h0,
                    const float* __restrict__ dh, float* __restrict__ da,
                    float* __restrict__ db, float* __restrict__ dh0,
                    long long chains, long long S, long long C) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chains) return;
  long long bi = i / C;
  long long c = i - bi * C;
  const long long base = bi * S * C + c;
  const float h_init = h0 != nullptr ? h0[i] : 0.f;
  float g = 0.f, a_next = 0.f;
  long long t = S - 1;
  // kUnroll steps t, t - 1, ..., loaded before the dependent chain
  for (; t + 1 >= kUnroll; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long off = base + (t - u) * C;
      av[u] = a[off];
      gv[u] = dh[off];
      hv[u] = t - u > 0 ? h[off - C] : h_init;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      long long off = base + (t - u) * C;
      g = fmaf(a_next, g, gv[u]);
      db[off] = g;
      da[off] = g * hv[u];
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    long long off = base + t * C;
    g = fmaf(a_next, g, dh[off]);
    db[off] = g;
    da[off] = g * (t > 0 ? h[off - C] : h_init);
    a_next = a[off];
  }
  if (dh0 != nullptr) dh0[i] = a_next * g;
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

// The gradient of rt_lru_scan. a, h (its output), dh, da, db: (B, S, C)
// float32 contiguous; h0: (B, C) float32 or null (then h_{-1} = 0);
// dh0: (B, C) float32 or null (not written).
int rt_lru_scan_bwd(const float* a, const float* h, const float* h0,
                    const float* dh, float* da, float* db, float* dh0,
                    long long B, long long S, long long C, void* stream) {
  long long chains = B * C;
  if (chains <= 0 || S <= 0) return (int)cudaGetLastError();
  unsigned blocks = (unsigned)((chains + kThreads - 1) / kThreads);
  lru_scan_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, h, h0, dh, da, db, dh0, chains, S, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
