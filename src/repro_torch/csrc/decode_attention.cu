// Decode attention for Hopper (sm_90a): one query token a sequence against
// its KV cache, in one pass over the cache's attended positions.
//
// Replaces no TPU kernel. The reference's decode attention is an XLA einsum
// (src/repro/nn/attention.py:193-203: bf16 operands with
// preferred_element_type=float32, a float32 softmax, P cast to the cache's
// dtype), and has no Pallas kernel. The port's plain decode copies the whole
// bf16 cache to float32 every step, keys and values over the cache's whole
// capacity, and runs two float32 products over the copies: at qwen2.5-14b's
// batch-48 decode (Hkv = 8, hd = 128, capacity 2,176) some 103 GB a step
// against the 19.9 GB the attention needs. This kernel was added to read
// each attended key and value once, in the cache's dtype, and nothing else.
//
// What it computes, for each sequence b and query head hq = h * G + r of
// kv head h (G = Hq / Hkv), over the positions j in [start, pos], start =
// max(0, pos - window + 1) with a window and 0 without:
//   s_j = q . k_j * scale (bf16 inputs, float32 sums), a float32 softmax
//   over the s_j, P rounded to the cache's dtype (the reference's
//   probs.astype(cv.dtype)), out = sum_j P_j v_j with float32 sums, in q's
//   dtype. A position outside [start, pos] is never read: its weight is
//   exactly 0 in the plain route's masked softmax. A float32 cache takes
//   the CUDA cores and leaves P unrounded, as the plain route does.
//
// What bounds it on an H100: device-memory bytes. The keys and values at
// the L = pos - start + 1 attended positions, 2 * B * Hkv * L * hd * esize
// bytes, plus q and the output, 2 * B * Hq * hd * esize; the arithmetic is
// 4 * hd operations a position and query head, G operations a byte (5 at
// qwen2.5-14b), far below the card's 295. At qwen2.5-14b.batch2k's decode
// (B = 48, L = 2,048-2,176) a layer moves 403-428 MB: 120-128 us at
// 3.35 TB/s.
//
// Design:
// - GQA: a block (one warp) takes the G query rows of one kv head, padded
//   to the 16 rows of an mma.sync m16n8k16 tile (G > 16: one block per 16
//   rows), so every key and value it reads serves all G heads: the scores
//   S = Q K^T and O += P V run on the tensor cores in bf16 with float32
//   sums. The scores' accumulator fragment is the A fragment of the second
//   product, so P is a round and a pack, no shuffle.
// - Bytes in flight: each block streams tiles of TP positions (TP x hd
//   keys and values, 16 KB at hd 64-256) through a ring of kStages tiles
//   in shared memory with cp.async, two tiles in flight while it computes
//   the third; the rows are XOR-swizzled in 16-byte chunks so that
//   ldmatrix reads hit distinct banks. The ragged last tile zero-fills the
//   rows past the range (cp.async with a source size of 0) and masks them.
// - A small B * Hkv, or a long cache: the attended range is cut into
//   `splits` runs of whole tiles, one block each (the wrapper chooses the
//   count from B * Hkv against the card's SMs and from the range's
//   tiles). Each block writes its rows' running max, sum and unnormalised
//   accumulator in float32; a second, small launch combines a query
//   head's splits in split order, so the result does not depend on the
//   order in which blocks ran. One split writes the output directly.
// - The position is device data: every block reads it from memory and
//   derives its range and its split's tiles from it, so the launch's grid
//   and arguments are the same at every position and a CUDA graph captured
//   at one step replays at the next (launch/steps.py). A caller that knows
//   the position only on the device chooses the split count for the
//   longest range the cache allows; a split then may hold no tile, and
//   writes a max of -inf and a sum of 0, which the combine weighs 0.
// - The softmax is online, in float32, in base 2 (the scale folds in
//   log2 e).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 16;   // query rows of an m16n8k16 tile
constexpr int kStages = 3;  // tiles in the shared-memory ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

// positions a tile holds: TP x hd keys and as many values, 16 KB at hd
// 64-256 in bf16 (at least the 16 positions of a P V product)
__host__ __device__ constexpr int tile_positions(int hd) {
  return hd >= 256 ? 16 : hd == 128 ? 32 : 64;
}

// 2^x (ex2.approx: 2 ulp; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Smem {
  static constexpr int kTP = tile_positions(HD);
  static constexpr int kQ = kRows * HD;    // bf16 elements
  static constexpr int kTile = kTP * HD;   // one stage of keys (or values)
  static constexpr size_t kBytes =
      sizeof(bf16) * (size_t)(kQ + 2 * kStages * kTile);
};

// where a sequence's attended positions start, and how many there are, for
// the query at the position the step wrote to device memory; a position
// outside [0, cap) attends to nothing (the wrapper refuses one on the host),
// so no read leaves the cache and the output is 0 / 0
struct Range {
  int start;
  int len;
};
__device__ __forceinline__ Range attended(const int* pos_ptr, int cap,
                                          int window) {
  const int pos = __ldg(pos_ptr);
  if (pos < 0 || pos >= cap) return {0, 0};
  const int start = window > 0 && pos - window + 1 > 0 ? pos - window + 1 : 0;
  return {start, pos - start + 1};
}

// the partial of (item, split, row): hd accumulator floats, then m, then l
__device__ __forceinline__ float* partial_row(float* part, int item,
                                              int split, int splits,
                                              int rows, int row, int hd) {
  return part + (((size_t)item * splits + split) * rows + row) * (hd + 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; a source size of 0 reads nothing
// and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// element offset of 16-byte chunk `c` of row `r` in a swizzled tile of
// HD-wide rows: chunk c ^ (r mod 8) (mod the row's chunks below 8), so
// that eight rows' chunk c lie in distinct banks
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = HD / 8;
  constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  return r * HD + ((c ^ (r & kMask)) << 3);
}

// keys and values of tile t (positions t * TP + [0, TP) of the range) into
// one ring stage; rows past the range are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(bf16* sk, bf16* sv,
                                          const bf16* kb, const bf16* vb,
                                          int t, int len, int lane) {
  constexpr int kTP = Smem<HD>::kTP;
  constexpr int kChunks = HD / 8;
  const int p0 = t * kTP;
#pragma unroll 4
  for (int i = lane; i < kTP * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = p0 + r < len;
    const size_t off = (size_t)(in ? p0 + r : 0) * HD + c * 8;
    const int bytes = in ? 16 : 0;
    cp_async16(sk + swz<HD>(r, c), kb + off, bytes);
    cp_async16(sv + swz<HD>(r, c), vb + off, bytes);
  }
}

// one block: one warp, the <= 16 query rows (row group rg) of kv head h of
// sequence b, over split `split` of the attended range
template <int HD>
__global__ void __launch_bounds__(32)
decode_attention_kernel_mma(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* out,
                            float* part, const int* __restrict__ pos,
                            int Hq, int Hkv, int cap, int window, int splits,
                            float scale_log2) {
  constexpr int kTP = Smem<HD>::kTP;
  constexpr int kChunks = HD / 8;
  constexpr int kSN = kTP / 8;   // score n-tiles of 8 positions
  constexpr int kON = HD / 8;    // output n-tiles of 8 dims
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + Smem<HD>::kQ;
  bf16* sv = sk + kStages * Smem<HD>::kTile;

  const int lane = threadIdx.x;
  const int G = Hq / Hkv;
  const int groups = (G + kRows - 1) / kRows;
  const int split = blockIdx.x % splits;
  const int item = blockIdx.x / splits;   // (b * Hkv + h) * groups + rg
  const int rg = item % groups;
  const int bh = item / groups;
  const int b = bh / Hkv, h = bh % Hkv;
  const int head0 = h * G + rg * kRows;   // the tile's first query head
  const int nrows = min(kRows, G - rg * kRows);
  const Range rng = attended(pos, cap, window);
  const int ntiles = (rng.len + kTP - 1) / kTP;
  const int t0 = (int)((long long)ntiles * split / splits);
  const int nt = (int)((long long)ntiles * (split + 1) / splits) - t0;
  const bf16* kb = k + ((size_t)bh * cap + rng.start) * HD;
  const bf16* vb = v + ((size_t)bh * cap + rng.start) * HD;

  // the first tiles in flight before q is staged
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt)
      load_tile<HD>(sk + s * Smem<HD>::kTile, sv + s * Smem<HD>::kTile, kb,
                    vb, t0 + s, rng.len, lane);
    cp_async_commit();
  }
  // q rows to shared memory, rows past nrows zero
  for (int i = lane; i < kRows * kChunks; i += 32) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nrows)
      x = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * Hq + head0 + r) * HD + c * 8);
    *reinterpret_cast<uint4*>(sq + swz<HD>(r, c)) = x;
  }

  // lane (g, tq): rows g and g + 8, columns 2 tq and 2 tq + 1 of a tile
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix x4: lane l gives row (l & 7) of matrix l >> 3
  const int mi = lane >> 3, mr = lane & 7;
  float o[kON][4];
#pragma unroll
  for (int n = 0; n < kON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max, rows g, g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of the sums

  for (int i = 0; i < nt; ++i) {
    cp_async_wait<kStages - 2>();   // tile i has landed (this lane's part)
    __syncwarp();                   // ... and every lane's
    {
      const int j = i + kStages - 1;   // into the stage read at i - 1
      if (j < nt)
        load_tile<HD>(sk + (j % kStages) * Smem<HD>::kTile,
                      sv + (j % kStages) * Smem<HD>::kTile, kb, vb, t0 + j,
                      rng.len, lane);
      cp_async_commit();
    }
    const bf16* tk = sk + (i % kStages) * Smem<HD>::kTile;
    const bf16* tv = sv + (i % kStages) * Smem<HD>::kTile;

    // S = Q K^T, 16 x TP
    float s[kSN][4];
#pragma unroll
    for (int n = 0; n < kSN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      // matrices: rows 0-7 / 8-15 (mi & 1) x dims 16 kk + 0-7 / 8-15
      ldmatrix_x4(a, sq + swz<HD>((mi & 1) * 8 + mr, 2 * kk + (mi >> 1)));
#pragma unroll
      for (int n = 0; n < kSN; n += 2) {
        uint32_t bk[4];
        // matrices: positions of n-tile n / n + 1 (mi >> 1) x dims
        // 16 kk + 0-7 / 8-15 (mi & 1)
        ldmatrix_x4(bk, tk + swz<HD>((n + (mi >> 1)) * 8 + mr,
                                     2 * kk + (mi & 1)));
        mma_bf16(s[n], a, bk[0], bk[1]);
        mma_bf16(s[n + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask the rows past the range, online softmax in base 2
    const int p0 = (t0 + i) * kTP;
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = p0 + n * 8 + 2 * tq + (e & 1) < rng.len;
        s[n][e] = in ? s[n][e] * scale_log2 : -INFINITY;
      }
      x0 = fmaxf(x0, fmaxf(s[n][0], s[n][1]));
      x1 = fmaxf(x1, fmaxf(s[n][2], s[n][3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, 2));
    // every tile holds a position of the range, so the new max is finite
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float c0 = exp2_approx(m0 - n0), c1 = exp2_approx(m1 - n1);
    m0 = n0;
    m1 = n1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int n = 0; n < kSN; ++n) {
      s[n][0] = exp2_approx(s[n][0] - n0);
      s[n][1] = exp2_approx(s[n][1] - n0);
      s[n][2] = exp2_approx(s[n][2] - n1);
      s[n][3] = exp2_approx(s[n][3] - n1);
      r0 += s[n][0] + s[n][1];
      r1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + r0;
    l1 = l1 * c1 + r1;
#pragma unroll
    for (int n = 0; n < kON; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }

    // O += P V: P rounded to bf16 (its float32 sum is l), V as B
#pragma unroll
    for (int kk = 0; kk < kTP / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kON; n += 2) {
        uint32_t bv[4];
        // matrices: positions 16 kk + 0-7 / 8-15 (mi & 1) x dims of
        // n-tile n / n + 1 (mi >> 1), transposed
        ldmatrix_x4_trans(bv, tv + swz<HD>(16 * kk + (mi & 1) * 8 + mr,
                                           n + (mi >> 1)));
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const int rows[2] = {g, g + 8};
  const float ms[2] = {m0, m1}, ls[2] = {l0, l1};
  if (out != nullptr && splits == 1) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (rows[e] >= nrows) continue;
      const float inv = 1.f / ls[e];
      bf16* dst = out + ((size_t)b * Hq + head0 + rows[e]) * HD + 2 * tq;
#pragma unroll
      for (int n = 0; n < kON; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
            __floats2bfloat162_rn(o[n][2 * e] * inv, o[n][2 * e + 1] * inv);
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] >= nrows) continue;
    float* dst = partial_row(part, item, split, splits, kRows, rows[e], HD);
#pragma unroll
    for (int n = 0; n < kON; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * tq) =
          make_float2(o[n][2 * e], o[n][2 * e + 1]);
    if (tq == 0) {
      dst[HD] = ms[e];
      dst[HD + 1] = ls[e];
    }
  }
}

// float32 caches on the CUDA cores (the checks' dtype): one block, one
// warp, per (b, query head, split); lane holds dims lane + 32 i
template <int HD>
__global__ void __launch_bounds__(32)
decode_attention_kernel_simt(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v, float* out,
                             float* part, const int* __restrict__ pos,
                             int Hq, int Hkv, int cap, int window, int splits,
                             float scale_log2) {
  constexpr int kPer = (HD + 31) / 32;
  const int lane = threadIdx.x;
  const int split = blockIdx.x % splits;
  const int item = blockIdx.x / splits;   // b * Hq + hq
  const int b = item / Hq, hq = item % Hq;
  const int h = hq / (Hq / Hkv);
  const Range rng = attended(pos, cap, window);
  const int lo = (int)((long long)rng.len * split / splits);
  const int hi = (int)((long long)rng.len * (split + 1) / splits);
  const float* kb = k + ((size_t)(b * Hkv + h) * cap + rng.start) * HD;
  const float* vb = v + ((size_t)(b * Hkv + h) * cap + rng.start) * HD;
  float qv[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < HD ? q[(size_t)item * HD + d] * scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = lo; j < hi; ++j) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dot += qv[i] * kb[(size_t)j * HD + d];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(kFull, dot, off);
    const float mn = fmaxf(m, dot);
    const float c = exp2f(m - mn), p = exp2f(dot - mn);
    m = mn;
    l = l * c + p;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc[i] = acc[i] * c + p * vb[(size_t)j * HD + d];
    }
  }
  if (out != nullptr && splits == 1) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) out[(size_t)item * HD + d] = acc[i] / l;
    }
    return;
  }
  float* dst = partial_row(part, item, split, splits, 1, 0, HD);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) dst[d] = acc[i];
  }
  if (lane == 0) {
    dst[HD] = m;
    dst[HD + 1] = l;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// one block per (b, query head): its splits' partials, in split order
// (a split with no position has m = -inf and weight 0)
template <typename T>
__global__ void __launch_bounds__(32)
decode_attention_kernel_combine(const float* __restrict__ part, T* out,
                                int Hq, int Hkv, int rows, int hd,
                                int splits) {
  const int lane = threadIdx.x;
  const int b = blockIdx.x / Hq, hq = blockIdx.x % Hq;
  const int G = Hq / Hkv, h = hq / G, r = hq % G;
  const int groups = (G + rows - 1) / rows;
  const int item = (b * Hkv + h) * groups + r / rows;
  const size_t step = (size_t)rows * (hd + 2);
  const float* first = part + ((size_t)item * splits * rows + r % rows) *
                                  (hd + 2);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s)
    mx = fmaxf(mx, __ldg(first + s * step + hd));
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = first + s * step;
    sum += __ldg(p + hd + 1) * exp2f(__ldg(p + hd) - mx);
  }
  const float inv = 1.f / sum;
  for (int d = lane; d < hd; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* p = first + s * step;
      acc += __ldg(p + d) * exp2f(__ldg(p + hd) - mx);
    }
    store(out + (size_t)blockIdx.x * hd + d, acc * inv);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               float* part, const int* pos, int B, int Hq, int Hkv, int cap,
               int window, int splits, float scale_log2, cudaStream_t s) {
  const int G = Hq / Hkv;
  const long long blocks =
      (long long)B * Hkv * ((G + kRows - 1) / kRows) * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = Smem<HD>::kBytes;
  // above 48 KB of dynamic shared memory only once allowed, per device
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(decode_attention_kernel_mma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  decode_attention_kernel_mma<HD><<<(unsigned)blocks, 32, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), part, pos, Hq,
      Hkv, cap, window, splits, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* out,
                float* part, const int* pos, int B, int Hq, int Hkv, int cap,
                int window, int splits, float scale_log2, cudaStream_t s) {
  const long long blocks = (long long)B * Hq * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_attention_kernel_simt<HD><<<(unsigned)blocks, 32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), part, pos, Hq,
      Hkv, cap, window, splits, scale_log2);
  return (int)cudaGetLastError();
}

#define DECODE_DISPATCH(NAME, FN)                                            \
  int NAME(int hd, const void* q, const void* k, const void* v, void* out, \
           float* part, const int* pos, int B, int Hq, int Hkv, int cap,    \
           int window, int splits, float sl, cudaStream_t s) {              \
    switch (hd) {                                                           \
      case 16:                                                              \
        return FN<16>(q, k, v, out, part, pos, B, Hq, Hkv, cap, window,    \
                      splits, sl, s);                                       \
      case 32:                                                              \
        return FN<32>(q, k, v, out, part, pos, B, Hq, Hkv, cap, window,    \
                      splits, sl, s);                                       \
      case 64:                                                              \
        return FN<64>(q, k, v, out, part, pos, B, Hq, Hkv, cap, window,    \
                      splits, sl, s);                                       \
      case 128:                                                             \
        return FN<128>(q, k, v, out, part, pos, B, Hq, Hkv, cap, window,   \
                       splits, sl, s);                                      \
      case 256:                                                             \
        return FN<256>(q, k, v, out, part, pos, B, Hq, Hkv, cap, window,   \
                       splits, sl, s);                                      \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  }
DECODE_DISPATCH(dispatch_mma, launch_mma)
DECODE_DISPATCH(dispatch_simt, launch_simt)
#undef DECODE_DISPATCH

int combine(const float* part, void* out, int dtype, int B, int Hq, int Hkv,
            int hd, int splits, cudaStream_t s) {
  const long long blocks = (long long)B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    decode_attention_kernel_combine<bf16><<<(unsigned)blocks, 32, 0, s>>>(
        part, static_cast<bf16*>(out), Hq, Hkv, kRows, hd, splits);
  else
    decode_attention_kernel_combine<float><<<(unsigned)blocks, 32, 0, s>>>(
        part, static_cast<float*>(out), Hq, Hkv, 1, hd, splits);
  return (int)cudaGetLastError();
}

int check_shape(int dtype, int B, int Hq, int Hkv, int cap, int hd,
                int window, int splits) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128 && hd != 256)
    return (int)cudaErrorInvalidValue;
  if (cap <= 0 || window < 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the caches and out alike), all
// contiguous and 16-byte aligned. q, out: (B, Hq, hd); k, v: (B, Hkv, cap,
// hd). pos: one int32 in device memory, the query's position, read by the
// kernel (so that a captured CUDA graph replays the launch at every
// position); a position outside [0, cap) reads nothing and gives NaN.
// window <= 0 means none. part: float32 scratch of
// B * Hkv * ceil(G / R) * splits * R * (hd + 2) floats, R = 16 for bf16
// and 1 for float32 (unused, and may be null, when splits == 1). With out
// null only the splits' partials are written (the combine is
// rt_decode_attention_combine); otherwise the output too, in a second
// launch when splits > 1. A split may hold no position of the range: its
// partial has max -inf and sum 0.
int rt_decode_attention(const void* q, const void* k, const void* v,
                        void* out, float* part, const int* pos, int dtype,
                        int B, int Hq, int Hkv, int cap, int hd, int window,
                        int splits, float scale, void* stream) {
  int e = check_shape(dtype, B, Hq, Hkv, cap, hd, window, splits);
  if (e) return e;
  if (pos == nullptr || ((splits > 1 || out == nullptr) && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float sl = scale * kLog2e;
  e = dtype == 1 ? dispatch_mma(hd, q, k, v, out, part, pos, B, Hq, Hkv, cap,
                                window, splits, sl, s)
                 : dispatch_simt(hd, q, k, v, out, part, pos, B, Hq, Hkv,
                                 cap, window, splits, sl, s);
  if (e || out == nullptr || splits == 1) return e;
  return combine(part, out, dtype, B, Hq, Hkv, hd, splits, s);
}

// The second launch alone: out (B, Hq, hd) from the partials of `splits`
// splits that rt_decode_attention wrote with a null out.
int rt_decode_attention_combine(const float* part, void* out, int dtype,
                                int B, int Hq, int Hkv, int hd, int splits,
                                void* stream) {
  int e = check_shape(dtype, B, Hq, Hkv, 1, hd, 0, splits);
  if (e) return e;
  if (part == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  return combine(part, out, dtype, B, Hq, Hkv, hd, splits,
                 (cudaStream_t)stream);
}

}  // extern "C"
