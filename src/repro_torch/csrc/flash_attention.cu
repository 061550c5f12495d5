// Blocked online-softmax attention for Hopper (sm_90a): causal, grouped
// query heads (GQA), optional sliding window.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:78
// (flash_attention). Same function: q (B, Hq, S, hd), k and v
// (B, Hkv, S, hd) with Hq a multiple of Hkv; query head h reads kv head
// h / (Hq / Hkv); the scores are scaled by hd^-0.5, masked to -1e30 where
// a key is in the future (causal) or at least `window` positions back,
// and reduced with a float32 online softmax; the output has q's dtype.
// The reference's VMEM residency assert (flash_attention.py:91) is a TPU
// limit and is dropped: k and v stream through shared memory one tile at
// a time, so any S works, and the ragged last tile is masked here.
//
// What bounds it on an H100: operations. At the serving shape (B = 8,
// Hq = 10, Hkv = 1, S = 4096, hd = 256, window 2048) the (q, k) pairs
// inside the window need 515.5 GFLOP, 0.52 ms at the 989 TFLOP/s bf16
// tensor-core peak; the bytes (q, k, v read once, the output written
// once) need 0.11 ms.
//
// What the design does about it, as a first, simple kernel: one block of
// 256 threads per (batch, query head, 64-row query tile). The block loops
// over 64-row kv tiles from kv_lo to kv_hi, the reference's causal and
// window skipping (flash_attention.py:36-42), so the work is O(S * window)
// and the masked upper triangle is never computed. Each tile of q (scaled
// once), k (stored transposed) and v is staged in shared memory as
// float32, with rows padded so that the reads of a warp hit distinct
// banks; at hd = 256 that is 214.5 KB of dynamic shared memory, set with
// cudaFuncSetAttribute. Thread (ty, tx) owns query rows ty + 16 i and key
// columns tx + 16 j (i, j < 4) of the 64 x 64 score tile, and output
// columns tx + 16 j of its four rows; the sixteen threads that share a row
// are one half-warp and reduce its max and sum with shuffles. The running
// max, sum and accumulator stay in registers in float32. The products run
// on the CUDA cores in float32, so the kernel is far from its bound: the
// tensor cores (wgmma, fed by TMA) are the later fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBKV = 64;      // key rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
struct Layout {
  static constexpr int kQStride = HD + 1;    // q row r at r * (HD + 1)
  static constexpr int kKStride = kBKV + 1;  // k transposed: dim d at d * 65
  static constexpr int kPStride = kBKV + 1;  // probabilities, row-major
  static constexpr int kQ = kBQ * kQStride;
  static constexpr int kK = HD * kKStride;
  static constexpr int kV = kBKV * HD;
  static constexpr int kP = kBQ * kPStride;
  static constexpr size_t kBytes = (size_t)(kQ + kK + kV + kP) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Hq, int group, int S,
                       int causal, int window, float scale) {
  using L = Layout<HD>;
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kts = qs + L::kQ;
  float* vs = kts + L::kK;
  float* ps = vs + L::kV;

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hkv = Hq / group;
  const long long q_off = ((long long)b * Hq + h) * S * HD;
  const long long kv_off = ((long long)b * hkv + h / group) * S * HD;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qi * kBQ;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    int r = idx / HD, d = idx % HD;
    int pos = q0 + r;
    qs[r * L::kQStride + d] =
        pos < S ? to_f(q[q_off + (long long)pos * HD + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int kv_hi = (S + kBKV - 1) / kBKV;
  if (causal && qi + 1 < kv_hi) kv_hi = qi + 1;  // kBQ == kBKV
  int kv_lo = 0;
  if (window > 0 && q0 - window > 0) kv_lo = (q0 - window) / kBKV;

  for (int j = kv_lo; j < kv_hi; ++j) {
    const int k0 = j * kBKV;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBKV * HD; idx += kThreads) {
      int c = idx / HD, d = idx % HD;
      int pos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (pos < S) {
        long long g = kv_off + (long long)pos * HD + d;
        kx = to_f(k[g]);
        vx = to_f(v[g]);
      }
      kts[d * L::kKStride + c] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * L::kQStride + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = kts[d * L::kKStride + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pq = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pk = k0 + tx + 16 * c;
        bool ok = pk < S;
        if (causal) ok = ok && pk <= pq;
        if (window > 0) ok = ok && (pq - pk) < window;
        if (!ok) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      // the 16 threads of a row are one half-warp: xor offsets below 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = expf(s[i][c] - m_new);
        rs += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[(ty + 16 * i) * L::kPStride + tx + 16 * c] = s[i][c];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * L::kPStride + c];
#pragma unroll
      for (int col = 0; col < kCols; ++col) {
        const float vv = vs[c * HD + tx + 16 * col];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][col] = fmaf(pv[i], vv, acc[i][col]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pq = q0 + ty + 16 * i;
    if (pq >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + q_off + (long long)pq * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(row + tx + 16 * c, acc[i][c] / denom);
    // log of the row's softmax denominator in the scaled scores, for the
    // backward (flash_attention_bwd.cu); only when asked for
    if (lse != nullptr && tx == 0) lse[q_off / HD + pq] = m[i] + logf(denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int S, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t bytes = Layout<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)Hq, (unsigned)B);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Hq, Hq / Hkv, S,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Hq, int Hkv, int S, int hd, int causal,
                int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike), all
// contiguous. hd in {16, 32, 64, 128, 256}; Hq % Hkv == 0; window <= 0
// means no window. lse: (B, Hq, S) float32 log-sum-exp of each row's
// scaled scores, written when not null.
int rt_flash_attention(const void* q, const void* k, const void* v,
                       void* out, float* lse, int dtype, int B, int Hq,
                       int Hkv, int S, int hd, int causal, int window,
                       float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, out, lse, B, Hq, Hkv, S, hd, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, out, lse, B, Hq, Hkv, S, hd, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
