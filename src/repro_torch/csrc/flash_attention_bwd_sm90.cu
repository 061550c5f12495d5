// Backward of the blocked attention on Hopper's tensor cores (sm_90a):
// wgmma fed by TMA. The gradient of flash_attention_sm90.cu with respect to
// q, k and v, for bf16 with head dim 64, 128 or 256 (the wrapper's `wgmma`
// route, kernels/flash_attention.py); float32 and head dims 16 and 32 take
// the CUDA-core backward in flash_attention_bwd.cu (`simt`).
//
// The TPU has no counterpart: the JAX package differentiates its plain
// attention path with jax.grad (src/repro/launch/steps.py:26-35), and its
// Pallas kernel src/repro/kernels/flash_attention.py:78 has no backward.
// The plain version is kernels/ref.py:flash_attention_bwd. Same function as
// flash_attention_bwd.cu: with S = scale Q K^T under the forward's causal
// and window masks and lse = the forward's per-row log-sum-exp,
//   P = exp(S - lse), delta = rowsum(dO * O),
//   dV = P^T dO, dS = P * (dO V^T - delta), dK = scale dS^T Q,
//   dQ = scale dS K,
// and dK, dV of a kv head summed over the G = Hq / Hkv query heads of its
// group.
//
// What bounds it on an H100: operations. Per unmasked (query, key) pair the
// gradient needs 5 products of length hd, 10 hd operations; at the training
// shape (B = 2, Hq = 10, Hkv = 1, S = 4096, hd = 256, window 2048) that is
// 322 GFLOP, 0.326 ms at the 989 TFLOP/s bf16 tensor-core rate. This design
// does 7 products per pair (the dQ pass recomputes S and dP), 14 hd.
//
// Three launches, no atomics, every sum in a fixed order, so a call's
// result is the same bit for bit from run to run:
//  1. delta_sm90_kernel: one warp per query row (16-byte loads), delta in
//     float32.
//  2. dkv_wgmma_kernel: one block per (kv head x batch, 64-row kv tile),
//     kv tiles in ascending order (under causal masks the first kv tiles
//     see the most queries, so the heaviest blocks start first). 384
//     threads: a producer warpgroup (setmaxnreg.dec 24; one thread issues
//     every TMA load) and two consumer warpgroups (setmaxnreg.inc 240).
//     K and V of the tile stay resident; Q and dO tiles of 64 query rows
//     run through a 2-stage ring (each with its own full mbarrier, one
//     empty mbarrier per stage) over the G heads of the group and, for
//     each, the query tiles that the masks let reach the kv tile.
//     The products are transposed, so that every accumulator is the
//     A-register fragment of the next product: S^T = K Q^T and
//     dP^T = V dO^T by m64n64k16 with both operands K-major in shared
//     memory; dV += P^T dO and dK += dS^T Q by m64n{hd}k16 with P^T or
//     dS^T from registers and dO or Q read MN-major (the transpose bit), as
//     the forward reads V.
//     The split. dK and dV of 64 x 256 float32 are 128 registers a thread
//     each in one warpgroup: both do not fit under 240. So consumer 0 owns
//     dV (S^T -> P^T -> dV) and consumer 1 owns dK (dP^T -> dS^T -> dK).
//     Consumer 0 hands P^T to consumer 1 through 16 KB of shared memory in
//     float32, each thread's 32 values at stride 128 (no bank conflicts),
//     synchronised by two named barriers (P written / P read). Each
//     consumer holds its 128 accumulators, one 64 x 64 tile and 16 packed
//     bf16 pairs. P^T stays in float32 for dS^T = P^T (dP^T - delta), so
//     the only roundings before a product are the bf16 packs of P^T and
//     dS^T, as in the forward's P.
//     Shared memory at hd = 256: K, V 64 KB + 2 x (Q, dO) 128 KB + P 16 KB
//     = 208 KB (+ barriers and 1 KB for alignment).
//  3. dq_wgmma_kernel: one block per (batch x query head, 128-row q tile),
//     q tiles in reverse (the heaviest first), laid out like the forward:
//     Q and dO of the 128 rows resident, K and V tiles of 64 rows through
//     rings, two consumers of 64 rows each. S = Q K^T and dP = dO V^T by
//     m64n64k16 (K-major), P and dS in registers, dQ += dS K by
//     m64n{hd}k16 with K read MN-major. Consumer registers: dQ 128, S 32,
//     dP 32, 16 packed pairs. Shared memory at hd = 256: Q, dO 128 KB + a
//     2-stage K ring 64 KB + V 32 KB = 224 KB: V has one stage at hd = 256
//     (two below), released as soon as dP is done, so the next V tile loads
//     while dS and dQ += dS K run.
// Both wgmma kernels skip what the masks leave empty, as the forward does:
// the dK/dV block walks only the q tiles that reach its keys; a dQ consumer
// skips the compute of a kv tile fully masked for its 64 rows and still
// waits for and releases it, so the barrier phases stay in step. The mask
// is evaluated only on tiles that cross the diagonal, the window edge or S.
// TMA zero-fills rows past S; outputs past S are never written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;     // rows of a K, V (both kernels) or Q, dO (dK/dV) tile
constexpr int kBQ = 128;      // dQ: query rows per block, two consumers x 64
constexpr int kStages = 2;    // dK/dV: Q/dO ring depth
constexpr int kThreads = 384; // producer + two consumer warpgroups
constexpr int kBox = 64;      // bf16 columns per TMA box: one 128-B swizzle row
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarP = 1, kBarPFree = 2;  // named barriers of the dK/dV consumers

template <int HD>
struct DkvSmem {
  static constexpr int kTileBytes = kTile * HD * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTileBytes;
  static constexpr int kQ = 2 * kTileBytes;              // stage s: + s * kTileBytes
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kP = kDO + kStages * kTileBytes;  // 32 x 128 float32
  static constexpr int kBar = kP + 32 * 128 * 4;         // 7 mbarriers
  static constexpr size_t kBytes = kBar + 8 * 8 + 1024;  // + 1024-B alignment
  static_assert(kBytes <= kSmemLimit, "dK/dV tiles exceed shared memory");
};

template <int HD>
struct DqSmem {
  static constexpr int kKStages = 2;
  static constexpr int kVStages = HD == 256 ? 1 : 2;
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kTile * HD * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;                 // stage s: + s * kTileBytes
  static constexpr int kV = kK + kKStages * kTileBytes;
  static constexpr int kBar = kV + kVStages * kTileBytes;  // 9 mbarriers
  static constexpr size_t kBytes = kBar + 9 * 8 + 1024;
  static_assert(kBytes <= kSmemLimit, "dQ tiles exceed shared memory");
};

// D (64 x 64) = A (64 x HD) * B (64 x HD)^T, both 64-row tiles in shared
// memory, K-major, 128-byte swizzled boxes of `a_rows` / 64 rows
template <int HD>
__device__ __forceinline__ void wgmma_tile_ss(float* d, uint32_t a_tile,
                                              int a_rows, uint32_t b_tile) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da =
        desc_sw128(a_tile + (kk >> 2) * a_rows * 128 + (kk & 3) * 32, 16, 1024);
    const uint64_t db =
        desc_sw128(b_tile + (kk >> 2) * kTile * 128 + (kk & 3) * 32, 16, 1024);
    wgmma_m64n64k16_ss(d, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc (64 x HD) += A (64 x 64, registers: 16 packed pairs) * B, B a 64-row
// tile of HD columns in shared memory read MN-major
template <int HD>
__device__ __forceinline__ void wgmma_tile_rs(float* acc, const uint32_t* a,
                                              uint32_t b_tile) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) fence_operand(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_m64k16_rs<HD>(acc, a + 4 * kk,
                 desc_sw128(b_tile + kk * 16 * 128, kTile * 128, 1024));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) fence_operand(acc[i]);
}

// bf16 stores of a 64 x HD float32 accumulator fragment times `mul`, rows
// row_a (registers 4c + {0, 1}) and row_b (4c + {2, 3}) of a (S, HD) head;
// rows >= S are not written
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* head,
                                           const float* acc, int row_a,
                                           int row_b, int lane, int S,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int row = (i & 2) ? row_b : row_a;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(head + (size_t)row * HD + col) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
  }
}

// one warp per row: 16-byte loads of 8 bf16, hd / 8 of them per row
__global__ void __launch_bounds__(256)
delta_sm90_kernel(const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  float* __restrict__ delta, long long rows, int hd) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const uint4* a = reinterpret_cast<const uint4*>(o + row * hd);
  const uint4* b = reinterpret_cast<const uint4*>(dout + row * hd);
  float s = 0.f;
  for (int d = lane; d < hd / 8; d += 32) {
    const uint4 x = a[d], y = b[d];
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 u = __bfloat1622float2(xs[e]), w = __bfloat1622float2(ys[e]);
      s = fmaf(u.x, w.x, s);
      s = fmaf(u.y, w.y, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int Hq, int group, int S,
                 int causal, int window, float scale) {
  using L = DkvSmem<HD>;
  constexpr int kChunks = HD / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kv_full = base + L::kBar;
  // q_full(s) = kv_full + 8 (1 + s), do_full(s) = kv_full + 8 (3 + s),
  // empty(s) = kv_full + 8 (5 + s)

  const int bh_kv = blockIdx.x;  // b * Hkv + kv head
  const int kt = blockIdx.y;
  const int Hkv = Hq / group;
  const int b = bh_kv / Hkv, hkv = bh_kv % Hkv;
  const int k0 = kt * kTile;
  // the query tiles that reach keys [k0, k0 + 64)
  const int qt_lo = causal ? kt : 0;
  int qt_hi = (S + kTile - 1) / kTile;
  if (window > 0)
    qt_hi = (int)min((long long)qt_hi,
                     ((long long)k0 + kTile - 1 + window - 1) / kTile + 1);
  const int nq = max(0, qt_hi - qt_lo);
  const int n_it = group * nq;  // walk: head g of the group, then q tile

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * (1 + s), 1);
      mbar_init(kv_full + 8 * (3 + s), 1);
      mbar_init(kv_full + 8 * (5 + s), 2 * 128);  // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kTileBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_3d(base + L::kK + c * kTile * 128, &tk, kv_full, c * kBox,
                    k0, bh_kv);
        tma_load_3d(base + L::kV + c * kTile * 128, &tv, kv_full, c * kBox,
                    k0, bh_kv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int g = it / nq, q0 = (qt_lo + it % nq) * kTile;
        const int bh = b * Hq + hkv * group + g;
        const int s = it & 1;
        mbar_wait(kv_full + 8 * (5 + s), ((it >> 1) & 1) ^ 1);
        const uint32_t qf = kv_full + 8 * (1 + s), df = kv_full + 8 * (3 + s);
        const uint32_t qs = base + L::kQ + s * L::kTileBytes;
        const uint32_t ds = base + L::kDO + s * L::kTileBytes;
        mbar_arrive_expect_tx(qf, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(qs + c * kTile * 128, &tq, qf, c * kBox, q0, bh);
        mbar_arrive_expect_tx(df, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(ds + c * kTile * 128, &tdo, df, c * kBox, q0, bh);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<240>();
    const int cw = wg - 1;  // 0: dV (S^T, P^T); 1: dK (dP^T, dS^T)
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // accumulator fragment: registers 4c + {0, 1} hold kv row j_a, 4c +
    // {2, 3} row j_b, at query columns 8c + 2 (lane % 4) + {0, 1}
    const int j_a = k0 + 16 * warp + lane / 4, j_b = j_a + 8;
    const float sl2 = scale * kLog2e;
    // S^T's A operand is K, dP^T's is V
    const uint32_t a_tile = base + (cw == 0 ? L::kK : L::kV);
    float* pbuf = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kP);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int g = it / nq, q0 = (qt_lo + it % nq) * kTile;
      const int bh = b * Hq + hkv * group + g;
      const int s = it & 1;
      const uint32_t ph = (it >> 1) & 1;
      const uint32_t qf = kv_full + 8 * (1 + s), df = kv_full + 8 * (3 + s);
      const uint32_t qs = base + L::kQ + s * L::kTileBytes;
      const uint32_t ds = base + L::kDO + s * L::kTileBytes;

      // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1)
      mbar_wait(cw == 0 ? qf : df, ph);
      float sc[32];
      wgmma_tile_ss<HD>(sc, a_tile, kTile, cw == 0 ? qs : ds);
      // lse (consumer 0) or delta (consumer 1) of this thread's 16 query
      // columns, loaded while the product runs
      const float* stat = (cw == 0 ? lse : delta) + (size_t)bh * S;
      float st[16];
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = q0 + 8 * c + 2 * (lane & 3) + e;
          st[2 * c + e] = col < S ? stat[col] : 0.f;
        }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(sc[i]);

      uint32_t pa[16];
      if (cw == 0) {
        const bool need_mask = q0 + kTile > S || k0 + kTile > S ||
                               (causal && q0 < k0 + kTile - 1) ||
                               (window > 0 && q0 + kTile - 1 - k0 >= window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float p = exp2f(sc[i] * sl2 - st[2 * (i >> 2) + (i & 1)] * kLog2e);
          if (need_mask) {
            const int row = (i & 2) ? j_b : j_a;
            const int col = q0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            bool ok = col < S && row < S;
            if (causal) ok = ok && row <= col;
            if (window > 0) ok = ok && col - row < window;
            if (!ok) p = 0.f;
          }
          sc[i] = p;
        }
        // hand P^T to consumer 1 once it has read the previous tile's
        if (it > 0) named_bar_sync(kBarPFree, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i) pbuf[i * 128 + t] = sc[i];
        named_bar_arrive(kBarP, 256);
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
        // dV += P^T dO
        mbar_wait(df, ph);
        wgmma_tile_rs<HD>(acc, pa, ds);
      } else {
        // dS^T = P^T (dP^T - delta); masked pairs have P = 0. Registers
        // 2i and 2i + 1 are query columns 8 (i / 2) + 2 (lane % 4) + {0, 1}
        named_bar_sync(kBarP, 256);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          pa[i] = pack_bf16(
              pbuf[2 * i * 128 + t] * (sc[2 * i] - st[2 * (i >> 1)]),
              pbuf[(2 * i + 1) * 128 + t] * (sc[2 * i + 1] - st[2 * (i >> 1) + 1]));
        if (it + 1 < n_it) named_bar_arrive(kBarPFree, 256);
        // dK += dS^T Q
        mbar_wait(qf, ph);
        wgmma_tile_rs<HD>(acc, pa, qs);
      }
      mbar_arrive(kv_full + 8 * (5 + s));  // release the stage
    }

    const size_t head = (size_t)bh_kv * S * HD;
    if (cw == 0)
      store_rows<HD>(dv + head, acc, j_a, j_b, lane, S, 1.f);
    else
      store_rows<HD>(dk + head, acc, j_a, j_b, lane, S, scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int Hq, int group, int S,
                int causal, int window, float scale) {
  using L = DqSmem<HD>;
  constexpr int KS = L::kKStages, VS = L::kVStages;
  constexpr int kChunks = HD / kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBar;
  // k_full(s) = q_full + 8 (1 + s), v_full(s) = q_full + 8 (3 + s),
  // k_empty(s) = q_full + 8 (5 + s), v_empty(s) = q_full + 8 (7 + s)

  const int bh = blockIdx.x;                   // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest q tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int bh_kv = b * (Hq / group) + h / group;
  const int q0 = qt * kBQ;
  int kv_hi = (S + kTile - 1) / kTile;
  if (causal) kv_hi = min(kv_hi, (q0 + kBQ - 1) / kTile + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * (1 + s), 1);
      mbar_init(q_full + 8 * (3 + s), 1);
      mbar_init(q_full + 8 * (5 + s), 2 * 128);
      mbar_init(q_full + 8 * (7 + s), 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_3d(base + L::kQ + c * kBQ * 128, &tq, q_full, c * kBox, q0,
                    bh);
        tma_load_3d(base + L::kDO + c * kBQ * 128, &tdo, q_full, c * kBox,
                    q0, bh);
      }
      for (int j = kv_lo; j < kv_hi; ++j) {
        const int it = j - kv_lo;
        const int ks = it % KS, vs = it % VS;
        mbar_wait(q_full + 8 * (5 + ks), ((it / KS) & 1) ^ 1);
        const uint32_t kf = q_full + 8 * (1 + ks);
        mbar_arrive_expect_tx(kf, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(base + L::kK + ks * L::kTileBytes + c * kTile * 128,
                      &tk, kf, c * kBox, j * kTile, bh_kv);
        mbar_wait(q_full + 8 * (7 + vs), ((it / VS) & 1) ^ 1);
        const uint32_t vf = q_full + 8 * (3 + vs);
        mbar_arrive_expect_tx(vf, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < kChunks; ++c)
          tma_load_3d(base + L::kV + vs * L::kTileBytes + c * kTile * 128,
                      &tv, vf, c * kBox, j * kTile, bh_kv);
      }
    }
  } else {
    // ------------------------------------------------------------ consumer
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * cw;  // this warpgroup's first query row
    const int row_a = r_lo + 16 * warp + lane / 4, row_b = row_a + 8;
    const float sl2 = scale * kLog2e;
    const uint32_t q_tile = base + L::kQ + cw * 64 * 128;
    const uint32_t do_tile = base + L::kDO + cw * 64 * 128;
    const float* lrow = lse + (size_t)bh * S;
    const float* drow = delta + (size_t)bh * S;
    const float lse_a = row_a < S ? lrow[row_a] * kLog2e : 0.f;
    const float lse_b = row_b < S ? lrow[row_b] * kLog2e : 0.f;
    const float del_a = row_a < S ? drow[row_a] : 0.f;
    const float del_b = row_b < S ? drow[row_b] : 0.f;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int j = kv_lo; j < kv_hi; ++j) {
      const int it = j - kv_lo;
      const int ks = it % KS, vs = it % VS;
      const uint32_t kph = (it / KS) & 1, vph = (it / VS) & 1;
      const uint32_t kf = q_full + 8 * (1 + ks), vf = q_full + 8 * (3 + vs);
      const uint32_t k_tile = base + L::kK + ks * L::kTileBytes;
      const uint32_t v_tile = base + L::kV + vs * L::kTileBytes;
      const int k0 = j * kTile;
      const bool skip = r_lo >= S || (causal && k0 > r_lo + 63) ||
                        (window > 0 && r_lo - (k0 + kTile - 1) >= window);
      mbar_wait(kf, kph);
      if (!skip) {
        float sc[32], dp[32];
        wgmma_tile_ss<HD>(sc, q_tile, kBQ, k_tile);      // S = Q K^T
        mbar_wait(vf, vph);
        wgmma_tile_ss<HD>(dp, do_tile, kBQ, v_tile);     // dP = dO V^T
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(sc[i]);
        const bool need_mask = k0 + kTile > S ||
                               (causal && k0 + kTile - 1 > r_lo) ||
                               (window > 0 && r_lo + 63 - k0 >= window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float p = exp2f(sc[i] * sl2 - ((i & 2) ? lse_b : lse_a));
          if (need_mask) {
            const int row = (i & 2) ? row_b : row_a;
            const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            bool ok = col < S;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) p = 0.f;
          }
          sc[i] = p;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_operand(dp[i]);
        mbar_arrive(q_full + 8 * (7 + vs));  // V is no longer read
        uint32_t pa[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float d = (i & 1) ? del_b : del_a;  // registers 2i, 2i + 1
          pa[i] = pack_bf16(sc[2 * i] * (dp[2 * i] - d),
                            sc[2 * i + 1] * (dp[2 * i + 1] - d));
        }
        wgmma_tile_rs<HD>(acc, pa, k_tile);  // dQ += dS K
      } else {
        mbar_wait(vf, vph);
        mbar_arrive(q_full + 8 * (7 + vs));
      }
      mbar_arrive(q_full + 8 * (5 + ks));
    }
    store_rows<HD>(dq + (size_t)bh * S * HD, acc, row_a, row_b, lane, S,
                   scale);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Hq, int Hkv, int S, int causal,
           int window, float scale, cudaStream_t stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq64, tdo64, tq128, tdo128, tk, tv;
  if (!encode_map(enc, &tq64, q, HD, S, B * Hq, kTile) ||
      !encode_map(enc, &tdo64, dout, HD, S, B * Hq, kTile) ||
      !encode_map(enc, &tq128, q, HD, S, B * Hq, kBQ) ||
      !encode_map(enc, &tdo128, dout, HD, S, B * Hq, kBQ) ||
      !encode_map(enc, &tk, k, HD, S, B * Hkv, kTile) ||
      !encode_map(enc, &tv, v, HD, S, B * Hkv, kTile))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DkvSmem<HD>::kBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dq_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)DqSmem<HD>::kBytes);
  if (e != cudaSuccess) return (int)e;

  const long long rows = (long long)B * Hq * S;
  delta_sm90_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, rows, HD);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int group = Hq / Hkv;
  dim3 gkv((unsigned)(B * Hkv), (unsigned)((S + kTile - 1) / kTile));
  dkv_wgmma_kernel<HD><<<gkv, kThreads, DkvSmem<HD>::kBytes, stream>>>(
      tq64, tk, tv, tdo64, lse, delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, Hq, group, S, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((unsigned)(B * Hq), (unsigned)((S + kBQ - 1) / kBQ));
  dq_wgmma_kernel<HD><<<gq, kThreads, DqSmem<HD>::kBytes, stream>>>(
      tq128, tk, tv, tdo128, lse, delta, (__nv_bfloat16*)dq, Hq, group, S,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, o, dout, dq: (B, Hq, S, hd); k, v, dk, dv: (B, Hkv, S, hd);
// contiguous and 16-byte aligned. lse: (B, Hq, S)
// float32 from the forward; delta: (B, Hq, S) float32 scratch. hd in
// {64, 128, 256}; Hq % Hkv == 0; window <= 0 means no window.
int rt_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, float* delta, void* dq,
                                void* dk, void* dv, int B, int Hq, int Hkv,
                                int S, int hd, int causal, int window,
                                float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || Hq % Hkv != 0 || (S + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
       reinterpret_cast<uintptr_t>(dv)) % 16)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    case 256: return launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, S, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
