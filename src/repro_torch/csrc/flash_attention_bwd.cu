// Backward of the blocked attention (causal, grouped query heads, optional
// sliding window) for Hopper (sm_90a): the gradient of flash_attention.cu
// and flash_attention_sm90.cu with respect to q, k and v.
//
// The TPU has no counterpart: the JAX package differentiates its plain
// attention path with jax.grad (src/repro/launch/steps.py:26-35), and its
// Pallas kernel src/repro/kernels/flash_attention.py:78 has no backward.
// The port's training forward runs the hand-written forward kernels, so
// their gradient is this kernel; its plain version is
// kernels/ref.py:flash_attention_bwd.
//
// Function. With S = scale * Q K^T masked as the forward masks it (key j
// masked for query i when j > i under causal, or i - j >= window) and
// lse = m + log(l) per query row, written by the forward:
//   P     = exp(S - lse)
//   delta = rowsum(dO * O)
//   dV    = P^T dO,  dS = P * (dO V^T - delta)
//   dK    = scale * dS^T Q,  dQ = scale * dS K
// Query head h reads kv head h / G (G = Hq / Hkv), so dK and dV of a kv
// head sum over the G query heads of its group.
//
// Three launches, no atomics, so the result is deterministic:
//   1. delta_kernel: one warp per query row, delta in float32.
//   2. dkv_kernel: one block per (64-key tile, kv head, batch). K and V of
//      the tile stay in shared memory; the block walks the G heads of the
//      group and, for each, the 32-row query tiles that the causal and
//      window masks let reach the tile, and accumulates dK and dV in
//      registers.
//   3. dq_kernel: one block per (32-row query tile, query head, batch),
//      walking the key tiles the masks allow (the forward's kv_lo..kv_hi)
//      and accumulating dQ in registers.
// Both recompute S and dO V^T for their pairs.
//
// Precision: every product and sum in float32 on the CUDA cores, for
// float32 and bf16 inputs alike; the tiles are staged in shared memory as
// float32. One kv head of recurrentgemma-2b sums 10 query heads: float32
// accumulation keeps dK and dV at float32 accuracy before the one
// rounding to the input dtype.
//
// What bounds it on an H100: operations. Per (query, key) pair inside the
// mask the gradient needs 5 products of length hd (S, dO V^T, dV, dK, dQ),
// 10 hd operations; at the training shape (B = 2, Hq = 10, Hkv = 1,
// S = 4096, hd = 256, window 2048, bf16) that is 322 GFLOP, 0.33 ms at the
// 989 TFLOP/s bf16 tensor-core rate. This first kernel runs on the CUDA
// cores in float32 (67 TFLOP/s) and recomputes S and dO V^T in both
// passes (14 hd per pair), so it sits far above that bound; tensor cores
// (wgmma) are the later fix.
//
// Design of each tile step, 256 threads as 16 x 16 (ty, tx): thread
// (ty, tx) owns query rows ty + 16 a (a < 2) and keys tx + 16 c (c < 4) of
// the 32 x 64 score tile. Rows of every tile are padded to hd + 1 floats
// so that the 16 threads of a half-warp, reading one column of 16
// different rows, hit 16 different banks. At hd = 256 the dkv kernel uses
// 209.3 KB of shared memory (K, V 64-row tiles; Q, dO 32-row tiles; P and
// dS) and 128 float32 accumulators per thread; the dq kernel 201.1 KB and
// 32 accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kBK + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
struct Tiles {
  static constexpr int kStride = HD + 1;
  static constexpr int kQ = kBQ * kStride;  // a Q or dO tile
  static constexpr int kK = kBK * kStride;  // a K or V tile
  static constexpr int kP = kBQ * kPStride; // a P or dS tile
  // dkv: K, V, Q, dO, P, dS, lse, delta
  static constexpr size_t kDkvBytes =
      (size_t)(2 * kK + 2 * kQ + 2 * kP + 2 * kBQ) * sizeof(float);
  // dq: K, V, Q, dO, dS, lse, delta
  static constexpr size_t kDqBytes =
      (size_t)(2 * kK + 2 * kQ + kP + 2 * kBQ) * sizeof(float);
};

// rows [row0, row0 + rows) of a (S, HD) head into a float32 tile with rows
// of HD + 1; rows at or past S are zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int rows, int S) {
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int pos = row0 + r;
    dst[r * (HD + 1) + d] =
        pos < S ? to_f(src[(long long)pos * HD + d]) : 0.f;
  }
}

// lse and delta of query rows [q0, q0 + kBQ) (0 past S)
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int q0, int S) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[q0 + r] : 0.f;
    delta_s[r] = in ? delta[q0 + r] : 0.f;
  }
}

// P and dS of the 32 x 64 tile (query rows q0.., keys k0..) for thread
// (ty, tx): rows ty + 16 a, keys tx + 16 c. Masked pairs, and rows or keys
// past S, give 0.
template <int HD>
__device__ __forceinline__ void tile_grads(const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           const float* lse_s,
                                           const float* delta_s, int q0,
                                           int k0, int S, int causal,
                                           int window, float scale, int ty,
                                           int tx, float p[2][4],
                                           float ds[2][4]) {
  constexpr int St = HD + 1;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[2], gv[2], kv[4], vv[4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      qv[a] = qs[(ty + 16 * a) * St + d];
      gv[a] = dos[(ty + 16 * a) * St + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tx + 16 * c) * St + d];
      vv[c] = vs[(tx + 16 * c) * St + d];
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(gv[a], vv[c], dp[a][c]);
      }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = q0 + ty + 16 * a;
    const float lse_i = lse_s[ty + 16 * a], delta_i = delta_s[ty + 16 * a];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      bool ok = i < S && j < S;
      if (causal) ok = ok && j <= i;
      if (window > 0) ok = ok && i - j < window;
      const float pv = ok ? expf(s[a][c] * scale - lse_i) : 0.f;
      p[a][c] = pv;
      ds[a][c] = pv * (dp[a][c] - delta_i);
    }
  }
}

template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, long long rows,
                             int hd) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* a = o + row * hd;
  const T* b = dout + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(to_f(a[d]), to_f(b[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int Hq, int group, int S,
           int causal, int window, float scale) {
  using L = Tiles<HD>;
  constexpr int St = L::kStride;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + L::kK;
  float* qs = vs + L::kK;
  float* dos = qs + L::kQ;
  float* ps = dos + L::kQ;
  float* dss = ps + L::kP;
  float* lse_s = dss + L::kP;
  float* delta_s = lse_s + kBQ;

  const int kt = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int hkv_n = Hq / group;
  const int k0 = kt * kBK;
  const long long kv_off = ((long long)b * hkv_n + hkv) * S * HD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(ks, k + kv_off, k0, kBK, S);
  load_tile<T, HD>(vs, v + kv_off, k0, kBK, S);

  // query tiles that can reach keys [k0, k0 + kBK)
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt_lo = causal ? k0 / kBQ : 0;
  int qt_hi = n_qt;
  if (window > 0) {
    const long long last = (long long)k0 + kBK - 1 + window - 1;
    if (last / kBQ + 1 < qt_hi) qt_hi = (int)(last / kBQ + 1);
  }

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hkv * group + g;
    const long long q_off = ((long long)b * Hq + h) * S * HD;
    const long long r_off = ((long long)b * Hq + h) * S;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD>(qs, q + q_off, q0, kBQ, S);
      load_tile<T, HD>(dos, dout + q_off, q0, kBQ, S);
      load_rows(lse_s, delta_s, lse + r_off, delta + r_off, q0, S);
      __syncthreads();
      float p[2][4], ds[2][4];
      tile_grads<HD>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, S, causal,
                     window, scale, ty, tx, p, ds);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(ty + 16 * a) * kPStride + tx + 16 * c] = p[a][c];
          dss[(ty + 16 * a) * kPStride + tx + 16 * c] = ds[a][c];
        }
      __syncthreads();
      // dV[j] += sum_i P[i, j] dO[i];  dK[j] += sum_i dS[i, j] Q[i]
      // for keys j = ty + 16 a (a < 4), columns tx + 16 c
#pragma unroll 2
      for (int i = 0; i < kBQ; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = ps[i * kPStride + ty + 16 * a];
          dsv[a] = dss[i * kPStride + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float gv = dos[i * St + tx + 16 * c];
          const float qv = qs[i * St + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][c] = fmaf(pv[a], gv, acc_v[a][c]);
            acc_k[a][c] = fmaf(dsv[a], qv, acc_k[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= S) continue;
    T* krow = dk + kv_off + (long long)j * HD;
    T* vrow = dv + kv_off + (long long)j * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(krow + tx + 16 * c, acc_k[a][c] * scale);
      store(vrow + tx + 16 * c, acc_v[a][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Hq, int group, int S, int causal,
          int window, float scale) {
  using L = Tiles<HD>;
  constexpr int St = L::kStride;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + L::kK;
  float* qs = vs + L::kK;
  float* dos = qs + L::kQ;
  float* dss = dos + L::kQ;
  float* lse_s = dss + L::kP;
  float* delta_s = lse_s + kBQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hkv_n = Hq / group;
  const int q0 = qt * kBQ;
  const long long q_off = ((long long)b * Hq + h) * S * HD;
  const long long r_off = ((long long)b * Hq + h) * S;
  const long long kv_off = ((long long)b * hkv_n + h / group) * S * HD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(qs, q + q_off, q0, kBQ, S);
  load_tile<T, HD>(dos, dout + q_off, q0, kBQ, S);
  load_rows(lse_s, delta_s, lse + r_off, delta + r_off, q0, S);

  // the forward's kv tile range for these rows
  int kv_hi = (S + kBK - 1) / kBK;
  if (causal && (q0 + kBQ - 1) / kBK + 1 < kv_hi) kv_hi = (q0 + kBQ - 1) / kBK + 1;
  int kv_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / kBK;

  float acc[2][kCols];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  for (int j = kv_lo; j < kv_hi; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(ks, k + kv_off, k0, kBK, S);
    load_tile<T, HD>(vs, v + kv_off, k0, kBK, S);
    __syncthreads();
    float p[2][4], ds[2][4];
    tile_grads<HD>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, S, causal,
                   window, scale, ty, tx, p, ds);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dss[(ty + 16 * a) * kPStride + tx + 16 * c] = ds[a][c];
    __syncthreads();
    // dQ[i] += sum_j dS[i, j] K[j] for rows ty + 16 a, columns tx + 16 c
#pragma unroll 4
    for (int jj = 0; jj < kBK; ++jj) {
      float dsv[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) dsv[a] = dss[(ty + 16 * a) * kPStride + jj];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = ks[jj * St + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 2; ++a) acc[a][c] = fmaf(dsv[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    T* row = dq + q_off + (long long)i * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(row + tx + 16 * c, acc[a][c] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int S, int causal,
           int window, float scale, cudaStream_t stream) {
  using L = Tiles<HD>;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::kDkvBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L::kDqBytes);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * Hq * S;
  const int rows_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                    kThreads, 0, stream>>>((const T*)o, (const T*)dout, delta,
                                           rows, HD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int group = Hq / Hkv;
  dim3 gkv((unsigned)((S + kBK - 1) / kBK), (unsigned)Hkv, (unsigned)B);
  dkv_kernel<T, HD><<<gkv, kThreads, L::kDkvBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Hq, group, S, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((unsigned)((S + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  dq_kernel<T, HD><<<gq, kThreads, L::kDqBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Hq, group, S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Hq, int Hkv, int S, int hd,
                int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq: (B, Hq, S, hd); k, v, dk, dv: (B, Hkv, S, hd); all of
// one dtype (0 = float32, 1 = bfloat16), contiguous. lse: (B, Hq, S)
// float32 from the forward; delta: (B, Hq, S) float32 scratch. hd in
// {16, 32, 64, 128, 256}; Hq % Hkv == 0; window <= 0 means no window.
int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, void* dk, void* dv,
                           int dtype, int B, int Hq, int Hkv, int S, int hd,
                           int causal, int window, float scale,
                           void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0 || Hkv > 65535 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, hd, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, hd, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
