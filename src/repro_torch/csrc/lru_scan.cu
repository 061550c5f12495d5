// Diagonal linear recurrence for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t,  h_{-1} = h0 (0 when absent),
// over a, b of shape (B, S, C) float32, the inner loop of every RG-LRU
// layer's prefill, and of its forward in training.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lru_scan.py:52
// (lru_scan). The reference keeps a whole (S, 256)-channel slab resident
// in VMEM and walks time once, so a and b are read once and h written
// once. Its padding of S to the time chunk (lru_scan.py:59-63) and its
// MAX_RESIDENT_S time tiling with chained carries (:67-77) exist only for
// VMEM and are not carried over: this kernel takes any S, any C and an
// optional h0 directly.
//
// What bounds it on an H100: device-memory bytes. 12 bytes per element
// (a and b read once, h written once) and two operations: at the training
// shape (B = 2, S = 4096, C = 2560) 252 MB, 0.0751 ms at 3.35 TB/s; at
// the serving shape (B = 8) 1.007 GB, 0.3005 ms.
//
// The design: one pass, with time split across the warps of a block.
// A block owns (batch, a tile of 32 consecutive channels); lane =
// channel, so every load and store of a warp is one 128-byte row. The
// block walks time in segments of W = 8 warps x T = 16 steps (the
// wrapper passes W and T, kernels/lru_scan.py:SCAN_WARPS, SCAN_STEPS; the
// C entry refuses any other pair). In each segment:
//  1. each warp holds its T steps of a and b in registers (steps past S
//     are identity steps, a = 1 and b = 0, made in registers and never
//     stored; lanes past C load nothing and store nothing) and scans them
//     with no carry in: A_w = the product of its a, H_w = its local state
//     at its last step. It writes (A_w, H_w) to shared memory and issues
//     the next segment's loads into a second set of registers, so device
//     memory stays busy through the fold and the rescan;
//  2. after a barrier, every warp folds the aggregates in warp order from
//     the segment's carry: c_0 = carry, c_{v+1} = A_v c_v + H_v. Warp w
//     keeps c_w; c_W is the next segment's carry (h0, or 0, first);
//  3. each warp rescans its registers from c_w and writes h.
// The aggregates are double-buffered by segment parity, so one barrier a
// segment suffices: a warp cannot write parity p again before every warp
// has passed the next barrier, which follows its fold of parity p. Every
// element is touched once, so loads and stores carry the streaming
// (evict-first) hint.
//
// Occupancy: a block has 32 W threads; at B = 2 and C = 2560 the grid is
// 2 x 80 = 160 blocks for 132 SMs, and all of them should be resident at
// once, not 28 of them in a second wave. The kernel is built with
// __launch_bounds__(32 W, M), which caps a thread at 65,536 / (32 W M)
// registers; it needs 4 T floats (this segment's a and b, the next one's)
// and about 30 more. W = 8, T = 16 with M = 2: 256 threads, 96 registers
// (ptxas, no spills), so two blocks a SM, 264 slots for the 160 blocks;
// at the serving shape (B = 8) the 640 blocks run in about 2.4 such waves. In flight at the training shape:
// 160 x 256 threads x 2 x 16 floats = 5.2 MB of loads, and as much again
// of the next segment, against the 3.35 TB/s x ~1 us that covers the
// latency of device memory. (16, 8), (8, 8) and (4, 32) timed within
// run noise of (8, 16) at both shapes (PERF.md), so only (8, 16) is built.
//
// Why one pass within a block, and not two passes or a look-back: two
// passes (a pass of per-chunk aggregates, then each chunk with the carry
// from its left, as the backward below) read a and b twice, 20 bytes per
// element against 12: a floor of 0.125 ms at the training shape (60 % of
// the bound at best) and 0.50 ms at the serving shape. A decoupled
// look-back across blocks reads once, but its fold order depends on
// timing, so the bits change from run to run, and its flags need a reset
// on every call. Here no work crosses between blocks: no scratch, no
// memset, no flags, and the fold order is fixed, so two calls give the
// same bits (the recovery of a training run relies on it).
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
// At that batch there are only 5,120 chains, so one thread per chain
// hides too little latency. The backward splits time into
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

constexpr int kUnroll = 16;
constexpr int kBwdThreads = 128;

// loads steps t0 .. t0 + T - 1 of one channel (offset ``off`` = element
// (batch, t0, channel)); steps past S, and lanes past C, are identity steps
template <int T>
__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           long long off, long long t0,
                                           long long S, long long C,
                                           bool live, float (&av)[T],
                                           float (&bv)[T]) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    if (live && t0 + u < S) {
      av[u] = __ldcs(a + off);
      bv[u] = __ldcs(b + off);
    } else {
      av[u] = 1.f;
      bv[u] = 0.f;
    }
    off += C;
  }
}

// one block per (batch, tile of 32 channels); warp w of segment s owns
// the steps s W T + w T + [0, T)
template <int W, int T, int M>
__global__ void __launch_bounds__(W * 32, M)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ out,
                long long tiles, long long S, long long C) {
  __shared__ float agg[2][2][W][32];  // [segment parity][A, H][warp][lane]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long bi = blockIdx.x / tiles;
  const long long c = (blockIdx.x - bi * tiles) * 32 + lane;
  const bool live = c < C;
  const long long base = bi * S * C + c;  // element (bi, 0, c)
  constexpr int kSeg = W * T;
  const long long n_seg = (S + kSeg - 1) / kSeg;
  float carry = h0 != nullptr && live ? h0[bi * C + c] : 0.f;
  float av[T], bv[T], an[T], bn[T];
  long long t0 = (long long)w * T;
  load_steps<T>(a, b, base + t0 * C, t0, S, C, live, av, bv);
  for (long long s = 0; s < n_seg; ++s) {
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      H = fmaf(av[u], H, bv[u]);
      A *= av[u];
    }
    float (&sa)[W][32] = agg[s & 1][0];
    float (&sh)[W][32] = agg[s & 1][1];
    sa[w][lane] = A;
    sh[w][lane] = H;
    // the next segment's loads (identity steps past S, no access)
    load_steps<T>(a, b, base + (t0 + kSeg) * C, t0 + kSeg, S, C, live, an,
                  bn);
    __syncthreads();
    float cw = carry;
#pragma unroll
    for (int v = 0; v < W; ++v) {
      if (v == w) cw = carry;
      carry = fmaf(sa[v][lane], carry, sh[v][lane]);
    }
    float h = cw;
    long long off = base + t0 * C;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      h = fmaf(av[u], h, bv[u]);
      if (live && t0 + u < S) __stcs(out + off, h);
      off += C;
    }
#pragma unroll
    for (int u = 0; u < T; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
    t0 += kSeg;
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
// W warps a block, T steps a warp: only (8, 16) is built, any other pair
// gives cudaErrorInvalidValue.
int rt_lru_scan(const float* a, const float* b, const float* h0, float* out,
                long long B, long long S, long long C, int W, int T,
                void* stream) {
  constexpr int kW = 8, kT = 16, kM = 2;
  if (W != kW || T != kT) return (int)cudaErrorInvalidValue;
  if (B * C <= 0 || S <= 0) return (int)cudaGetLastError();
  const long long tiles = (C + 31) / 32;
  if (B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lru_scan_kernel<kW, kT, kM><<<(unsigned)(B * tiles), kW * 32, 0,
                                (cudaStream_t)stream>>>(a, b, h0, out, tiles,
                                                         S, C);
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
