// Blocked online-softmax attention on Hopper's tensor cores (sm_90a):
// wgmma fed by TMA. Causal, grouped query heads (GQA), optional sliding
// window; bf16 q, k, v with head dim 64, 128 or 256. The other cases (float32,
// head dim 16 or 32) take the CUDA-core kernel in flash_attention.cu; the
// wrapper (kernels/flash_attention.py) picks the route from (dtype, hd)
// before it launches.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:78
// (flash_attention). Same function: q (B, Hq, S, hd), k and v (B, Hkv, S, hd),
// query head h reads kv head h / (Hq / Hkv); scores scaled by hd^-0.5 and
// masked to -1e30 where a key is in the future (causal) or at least `window`
// positions back; float32 online softmax; output in q's dtype, normalised by
// max(l, 1e-30). Any S: TMA zero-fills the ragged tile and the mask drops it.
//
// Numerics. S = Q K^T runs on the tensor cores from bf16 q and k with float32
// accumulation; the scale (with log2(e), for exp2) is applied to S in
// float32 — the reference scales q in float32 before its product, and at
// hd = 256 the scale 1/16 is exact. The running max, sum and the O
// accumulator stay in float32 registers. P is rounded to bf16 before
// O += P V. The Pallas kernel upcasts v and keeps P in float32
// (flash_attention.py:47,63-64); the reference's own model route rounds P to
// v's dtype (src/repro/nn/attention.py:86,150,202), and so does the port's
// plain route (src/repro_torch/nn/attention.py), so this kernel follows them.
//
// What bounds it on an H100: operations. At the serving shape (B = 8,
// Hq = 10, Hkv = 1, S = 4096, hd = 256, window 2048) the (q, k) pairs inside
// the window need 515.5 GFLOP, 0.52 ms at the 989 TFLOP/s bf16 tensor-core
// peak; the bytes (q, k, v read once, the output written once) need 0.11 ms.
//
// Design. One block per (batch x query head, 128-row q tile), 384 threads in
// three warpgroups. Grid y walks the q tiles in reverse, so the heaviest
// tiles (the causal ramp makes the first ones cheap) are scheduled first.
// - WG0 is the producer: it gives up registers (setmaxnreg.dec to 24) and
//   one thread issues every TMA load. Q (128 x hd) is loaded once; K and V
//   tiles of 64 rows run through a 2-stage ring with full and empty
//   mbarriers (K and V have a full barrier each, so S = Q K^T starts before
//   V has landed).
// - WG1 and WG2 are the consumers (setmaxnreg.inc to 240), 64 query rows
//   each. Per kv tile: S (64 x 64) = Q K^T by 16 (hd = 256) wgmma m64n64k16
//   with both operands in shared memory, K-major; softmax in registers; then
//   O (64 x hd) += P V by 4 wgmma m64n{hd}k16 with P from registers and V
//   from shared memory, MN-major (the transpose bit). The float32 S
//   accumulator fragment is the A-register fragment of the second product,
//   so P is a convert and a pack, no shuffle.
// - Shared memory at hd = 256: Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB
//   (cudaFuncSetAttribute). Consumer registers: O 128 floats, S 32, P 16
//   packed bf16 pairs.
// Where the trouble is, and what is done about it:
// - TMA layout: 3-d tensor maps over (hd, S, B * heads), so a tile that runs
//   past S is zero-filled inside its own head instead of reading the next
//   head's rows. Maps are encoded on the host per call and passed as
//   __grid_constant__ parameters; cuTensorMapEncodeTiled comes from
//   cudaGetDriverEntryPoint, so the library needs no -lcuda. Base pointers
//   must be 16-byte aligned (the wrapper checks; so does the C entry).
// - Swizzle: CU_TENSOR_MAP_SWIZZLE_128B with boxes 64 bf16 (128 B) wide, so
//   a row of hd columns is hd / 64 boxes, each box a [rows][64] block of its
//   own, 1024-byte aligned. The wgmma descriptors use the 128-byte swizzle
//   mode: K-major (Q, K) with stride offset 1024 (8 rows of 128 B), k-steps
//   of 16 columns advance the start by 32 B inside a box and by a whole box
//   every 4 steps; MN-major V with stride offset 1024 (8 kv rows) and
//   leading offset 64 x 128 B (the next box of 64 hd columns).
// - Masking and tile skipping: the block visits kv tiles kv_lo..kv_hi-1 for
//   its 128 rows; a consumer skips the compute of a tile that is fully masked
//   for its own 64 rows (it still waits for the tile and releases it, so the
//   barrier phases stay in step), and evaluates the mask only on tiles that
//   cross the diagonal, the window edge or S. A row whose first computed
//   tile is fully masked self-corrects: its max stays -1e30, and the next
//   tile's correction exp2(-1e30 - m) zeroes what it summed.
// - Output: predicated bf16x2 stores from the accumulator fragment; rows
//   >= S are never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;      // query rows per block: two consumers x 64
constexpr int kBKV = 64;      // key rows per tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384; // producer + two consumer warpgroups
constexpr int kBox = 64;      // bf16 columns per TMA box: one 128-B swizzle row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Smem {
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBKV * HD * 2;       // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;                     // stage s: + s * kTileBytes
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes; // 7 mbarriers
  static constexpr size_t kBytes = kBar + 8 * 8 + 1024;  // + 1024-B alignment
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t desc_v) {
  if constexpr (HD == 64) wgmma_m64n64k16_rs(o, a, desc_v);
  else if constexpr (HD == 128) wgmma_m64n128k16_rs(o, a, desc_v);
  else wgmma_m64n256k16_rs(o, a, desc_v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int Hq, int group,
                             int S, int causal, int window, float scale) {
  using L = Smem<HD>;
  constexpr int kChunks = HD / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  // k_full(s) = q_full + 8 (1 + s), v_full(s) = q_full + 8 (3 + s),
  // empty(s) = q_full + 8 (5 + s)

  const int bh = blockIdx.x;                   // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest q tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int bh_kv = b * (Hq / group) + h / group;
  const int q0 = qt * kBQ;
  int kv_hi = (S + kBKV - 1) / kBKV;
  if (causal) kv_hi = min(kv_hi, (q0 + kBQ - 1) / kBKV + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1) / kBKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * (1 + s), 1);
      mbar_init(q_full + 8 * (3 + s), 1);
      mbar_init(q_full + 8 * (5 + s), 2 * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        tma_load_3d(base + L::kQ + c * kBQ * 128, &tq, q_full, c * kBox, q0,
                    bh);
      for (int j = kv_lo; j < kv_hi; ++j) {
        const int it = j - kv_lo, s = it & 1;
        mbar_wait(q_full + 8 * (5 + s), ((it >> 1) & 1) ^ 1);
        const uint32_t kf = q_full + 8 * (1 + s), vf = q_full + 8 * (3 + s);
        const uint32_t kt = base + L::kK + s * L::kTileBytes;
        const uint32_t vt = base + L::kV + s * L::kTileBytes;
        mbar_arrive_expect_tx(kf, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(kt + c * kBKV * 128, &tk, kf, c * kBox, j * kBKV, bh_kv);
        mbar_arrive_expect_tx(vf, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(vt + c * kBKV * 128, &tv, vf, c * kBox, j * kBKV, bh_kv);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * cw;  // this warpgroup's first query row
    // accumulator fragment: registers 4c + {0, 1} hold row_a, 4c + {2, 3}
    // row_b, at columns 8c + 2 (lane % 4) + {0, 1}
    const int row_a = r_lo + 16 * warp + lane / 4, row_b = row_a + 8;
    const float sl2 = scale * kLog2e;
    const uint32_t q_tile = base + L::kQ + cw * 64 * 128;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    mbar_wait(q_full, 0);
    for (int j = kv_lo; j < kv_hi; ++j) {
      const int it = j - kv_lo, s = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      const uint32_t kf = q_full + 8 * (1 + s), vf = q_full + 8 * (3 + s);
      const int k0 = j * kBKV;
      const bool skip = r_lo >= S || (causal && k0 > r_lo + 63) ||
                        (window > 0 && r_lo - (k0 + kBKV - 1) >= window);
      mbar_wait(kf, ph);
      if (!skip) {
        const uint32_t k_tile = base + L::kK + s * L::kTileBytes;
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint64_t da = desc_sw128(
              q_tile + (kk >> 2) * kBQ * 128 + (kk & 3) * 32, 16, 1024);
          const uint64_t db = desc_sw128(
              k_tile + (kk >> 2) * kBKV * 128 + (kk & 3) * 32, 16, 1024);
          wgmma_m64n64k16_ss(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(sc[i]);

        const bool need_mask = k0 + kBKV > S ||
                               (causal && k0 + kBKV - 1 > r_lo) ||
                               (window > 0 && r_lo + 63 - k0 >= window);
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sc[i] * sl2;
          if (need_mask) {
            const int row = (i & 2) ? row_b : row_a;
            const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            bool ok = col < S;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) x = kNegInf;
          }
          sc[i] = x;
          if (i & 2) mx_b = fmaxf(mx_b, x);
          else mx_a = fmaxf(mx_a, x);
        }
        // the four lanes of a quad hold one row's 64 columns
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
        const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = exp2f(sc[i] - ((i & 2) ? m_b : m_a));
          sc[i] = p;
          if (i & 2) sum_b += p;
          else sum_a += p;
        }
        // per-thread partial sums: the quad is reduced once, at the end
        l_a = l_a * corr_a + sum_a;
        l_b = l_b * corr_b + sum_b;
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= (i & 2) ? corr_b : corr_a;
        uint32_t pa[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

        mbar_wait(vf, ph);
        const uint32_t v_tile = base + L::kV + s * L::kTileBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBKV / 16; ++kk) {
          const uint64_t dv =
              desc_sw128(v_tile + kk * 16 * 128, kBKV * 128, 1024);
          wgmma_pv<HD>(o, pa + 4 * kk, dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) fence_operand(o[i]);
      } else {
        mbar_wait(vf, ph);
      }
      mbar_arrive(q_full + 8 * (5 + s));  // release the stage
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
    // log-sum-exp of each row's scaled scores for the backward
    // (flash_attention_bwd.cu), only when asked for: m is in log2 units
    if (lse != nullptr && (lane & 3) == 0) {
      float* lrow = lse + (size_t)bh * S;
      if (row_a < S) lrow[row_a] = m_a * kLn2 + logf(den_a);
      if (row_b < S) lrow[row_b] = m_b * kLn2 + logf(den_b);
    }
    __nv_bfloat16* head = out + (size_t)bh * S * HD;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int row = (i & 2) ? row_b : row_a;
      const float den = (i & 2) ? den_b : den_a;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(head + (size_t)row * HD + col) =
            __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from libcuda once
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// 3-d map over (hd, S, heads) of a contiguous (heads, S, hd) bf16 tensor;
// boxes of 64 columns x `rows` rows x 1 head, 128-byte swizzle
bool encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int hd,
                int S, int heads, int rows) {
  cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads};
  cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)S * hd * 2};
  cuuint32_t box[3] = {(cuuint32_t)kBox, (cuuint32_t)rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Hq, int Hkv, int S, int causal, int window,
           float scale, cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_map(enc, &tq, q, HD, S, B * Hq, kBQ) ||
      !encode_map(enc, &tk, k, HD, S, B * Hkv, kBKV) ||
      !encode_map(enc, &tv, v, HD, S, B * Hkv, kBKV))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = Smem<HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  flash_attention_wgmma_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)out, lse, Hq, Hq / Hkv, S, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v and out, contiguous, 16-byte aligned. hd in {64, 128, 256};
// Hq % Hkv == 0; S < 65536 * 128; window <= 0 means no window. lse:
// (B, Hq, S) float32 log-sum-exp of each row's scaled scores, written when
// not null.
int rt_flash_attention_sm90(const void* q, const void* k, const void* v,
                            void* out, float* lse, int B, int Hq, int Hkv,
                            int S, int hd, int causal, int window,
                            float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0 || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    case 256: return launch<256>(q, k, v, out, lse, B, Hq, Hkv, S, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
