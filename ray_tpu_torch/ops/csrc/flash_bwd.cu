// Flash-attention backward, dQ and delta, for Hopper (sm_90a), bound
// through a plain C entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_bwd_dq_cuda). dK and dV are
// computed by csrc/flash_bwd_dkv.cu, which reads the delta written here.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel, and the
// delta = rowsum(dO * O) that _flash_backward computes in front of it. It
// rebuilds the probabilities from the forward's fp32 (natural-log)
// logsumexp:
//   delta = rowsum(dO * O)                     (fp32, written out for dK/dV)
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K
// with the forward's conventions: native GQA by index (the kv row of
// program bh is (bh / H) * KV + (bh % H) / (H / KV); K/V are never
// repeated), top-left causal masking (q_id >= k_id) with the k loop
// stopping at the diagonal, ragged q_len/k_len masked in-kernel, and the
// finite mask value. dS is rounded to the input dtype as the A operand of
// its product, as the forward rounds P.
//
// Layout at the boundary: q, o, do, dq [b*H, q_len, hd]; k, v [b*KV, k_len,
// hd]; lse, delta fp32 [b*H, q_len]; all contiguous, bf16 or fp16, hd a
// multiple of 16 up to 128.
//
// What bounds it on an H100. At the training shape ([12, 18, 2048, 128],
// causal) it does 6 * hd FLOPs per kept (q, k) pair (S, dP, dQ): 0.3519 ms
// at 989 TFLOP/s against ~0.20 ms of bytes at 3.35 TB/s (q, o, do, dq, k,
// v once; lse, delta), so tensor-core bound. Measured by chip_smoke.py on
// an NVIDIA H100 80GB HBM3 at 700 W: the first version of this kernel
// (mma.sync, K and V staged synchronously through registers, K^T written
// by scalar stores, 64 query rows a block) took 3.79 ms, 2.7x SDPA's whole
// backward (1.44 ms), and left delta to a torch expression that took
// 0.69 ms more; this design takes 0.57 ms, delta included.
//
// This design, in the shape of flash_fwd.cu:
//   - one block per pair of 128-row q tiles of one b*H row, from opposite
//     ends (flash::schedule in flash_common.cuh): under causal masking
//     every pair does the same work; three warpgroups: a producer (one
//     thread of it issues TMA; setmaxnreg drops it to 24 registers) and
//     two consumers of 64 query rows each (240 registers);
//   - the producer loads each tile's Q, dO and O once and streams 64-key K
//     and V tiles through rings of shared-memory stages (mbarrier
//     transactions); K and V have their own rings and barriers, since V is
//     free once dP is done while K stays until the dQ product has read it;
//     rank-3 tensor maps zero-fill rows past the length and columns past
//     hd;
//   - each consumer computes its rows' delta from the O and dO tiles in
//     shared memory while its first S and dP run, and writes it out;
//   - per key tile: S = Q K^T and dP = dO V^T by SS wgmma m64n64k16 (K and
//     V as stored are K-major B), then dQ += dS_{t-1} K_{t-1} by RS wgmma
//     m64n{D}k16 with dS from registers and K read MN-major through the
//     transpose flag: no transposed copy of K. P is formed while dP and
//     the dQ product run, dS while the dQ product runs. (The forward's
//     turn-taking between the consumers measured no gain here.)
//   - P = exp2(s * scale * log2 e - lse * log2 e): one FFMA and one MUFU.EX2
//     an element; only tiles crossing the diagonal or the ragged k edge pay
//     for the mask;
//   - dQ stays in fp32 registers for the whole loop, is scaled once, and
//     goes out through shared memory in TMA's swizzled layout with one TMA
//     store per consumer. Each dQ row is written once by one block, with no
//     atomics: the kernel is bitwise repeatable.
// 64-key tiles keep a consumer's loop at dQ (64 fp32 registers at D =
// 128), S and dP (32 each) and dS packed (16); 128-key tiles would need
// 224 of the 240 and spill.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;
using flash::pack2;

constexpr int kBlockQ = 128;  // query rows per tile, 64 per consumer
constexpr int kBlockK = 64;   // keys per K/V tile
// K is held until the dQ product has read it, V only until dP is done, so
// K gets the deeper ring (4 + 2 stages beat 3 + 3 at the training shape).
constexpr int kStagesK = 4;
constexpr int kStagesV = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Q | dO | O | K[kStagesK] | V[kStagesV] | dQ[kConsumers] |
// mbarriers, tiles 1024-byte aligned. O has its own buffer so that the
// next tile's Q, dO and O load while this one's dQ goes out.
template <int D>
struct Smem {
  using TQ = hopper::Tile<D, kBlockQ>;
  using TK = hopper::Tile<D, kBlockK>;
  using TD = hopper::Tile<D, 64>;  // one consumer's dQ rows
  static constexpr int kdO = TQ::kBytes;
  static constexpr int kO = 2 * TQ::kBytes;
  static constexpr int kK = 3 * TQ::kBytes;
  static constexpr int kV = kK + kStagesK * TK::kBytes;
  static constexpr int kdQ = kV + kStagesV * TK::kBytes;
  static constexpr int kBars = kdQ + kConsumers * TD::kBytes;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
};

template <bool kBf16>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (kBf16) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  else return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// delta = rowsum(dO * O) in fp32 for rows r and r + 8 of the 128-row tiles
// (TMA's swizzled layout): each thread of a quad sums every fourth
// 8-column chunk, then the quad adds its shares, so all four hold both
// rows' delta, as the wgmma fragments of those rows need it.
template <bool kBf16, int D>
__device__ __forceinline__ void row_delta(float (&dl)[2], const uint8_t* s_do, const uint8_t* s_o,
                                          int r, int tg) {
  using TQ = hopper::Tile<D, kBlockQ>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < D / 32; ++jj) {
      const uint32_t off = TQ::pair_off(r + 8 * i, 8 * (tg + 4 * jj));
      const uint4 a = *reinterpret_cast<const uint4*>(s_do + off);
      const uint4 b = *reinterpret_cast<const uint4*>(s_o + off);
      const uint32_t pa[4] = {a.x, a.y, a.z, a.w}, pb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack2<kBf16>(pa[e]), y = unpack2<kBf16>(pb[e]);
        sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[i] = sum;
  }
}

// Issues S = Q K^T and dP = dO V^T for this warpgroup's 64 rows x 64 keys
// as two wgmma groups (all operands K-major), S first.
template <bool kBf16, int D>
__device__ __forceinline__ void issue_s_dp(float (&sc)[kBlockK / 2], float (&dp)[kBlockK / 2],
                                           hopper::Desc dq, hopper::Desc ddo, hopper::Desc dk,
                                           hopper::Desc dv) {
  using TQ = hopper::Tile<D, kBlockQ>;
  using TK = hopper::Tile<D, kBlockK>;
  hopper::fence_regs(sc);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    hopper::wgmma_ss<kBlockK, kBf16, 0>(sc, hopper::desc_at(dq, TQ::k_off(k)),
                                        hopper::desc_at(dk, TK::k_off(k)), k > 0);
  hopper::wgmma_commit();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    hopper::wgmma_ss<kBlockK, kBf16, 0>(dp, hopper::desc_at(ddo, TQ::k_off(k)),
                                        hopper::desc_at(dv, TK::k_off(k)), k > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(sc);
  hopper::fence_regs(dp);
}

// Issues dQ += dS K as one wgmma group: dS from registers, K MN-major.
template <bool kBf16, int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2], uint32_t (&df)[kBlockK / 16][4],
                                         hopper::Desc dk_t) {
  using TK = hopper::Tile<D, kBlockK>;
  hopper::fence_regs(acc);
  hopper::fence_regs(df);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kBlockK / 16; ++k)
    hopper::wgmma_rs<D, kBf16, 1>(acc, df[k], hopper::desc_at(dk_t, TK::mn_off(k)), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
  hopper::fence_regs(df);
}

// P in place of S: exp2(s * scale_log2 - lse2) for this thread's rows row0
// and row0 + 8 and the keys of the tile at k0; masked entries get 0.
__device__ __forceinline__ void probs(float (&sc)[kBlockK / 2], const float (&lse2)[2],
                                      bool masked, int row0, int k0, int tg, int k_len,
                                      int causal, float scale_log2) {
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]);
      if (masked) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * tg + (e & 1);
        if (col >= k_len || (causal && row < col)) x = kMaskValue;
      }
      sc[4 * j + e] = hopper::exp2_fast(x);
    }
  }
}

// dS = P (dP - delta) in place of dP (accumulator i is in this thread's
// row row0 + 8 * ((i >> 1) & 1)).
__device__ __forceinline__ void grad_scores(float (&dp)[kBlockK / 2], const float (&p)[kBlockK / 2],
                                            const float (&dl)[2]) {
#pragma unroll
  for (int i = 0; i < kBlockK / 2; ++i) dp[i] = p[i] * (dp[i] - dl[(i >> 1) & 1]);
}

// dS as A fragments: the accumulators of keys 16k..16k+15, in pairs.
template <bool kBf16>
__device__ __forceinline__ void pack_ds(uint32_t (&df)[kBlockK / 16][4],
                                        const float (&ds)[kBlockK / 2]) {
#pragma unroll
  for (int k = 0; k < kBlockK / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) df[k][i] = pack2<kBf16>(ds[8 * k + 2 * i], ds[8 * k + 2 * i + 1]);
}

// D is head_dim rounded up to 32, 64 or 128; columns in [hd, D) are
// zero-filled by TMA and never stored.
template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                    float* __restrict__ delta, int H, int KV, int q_len, int k_len, float scale,
                    int causal, int n_heads, int singles) {
  using S = Smem<D>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using TD = typename S::TD;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t sQ = base, sdO = base + S::kdO, sO = base + S::kO;
  // mbarriers: full_k, empty_k [kStagesK], full_v, empty_v [kStagesV],
  // then the Q/dO/O tiles' full and empty. Key tile n (counted over both
  // items) is in K stage n % kStagesK and V stage n % kStagesV; the phase
  // parities follow from n too.
  const uint32_t bars = base + S::kBars;
  auto full_k = [&](int n) { return bars + 8 * (n % kStagesK); };
  auto empty_k = [&](int n) { return bars + 8 * (kStagesK + n % kStagesK); };
  auto full_v = [&](int n) { return bars + 8 * (2 * kStagesK + n % kStagesV); };
  auto empty_v = [&](int n) { return bars + 8 * (2 * kStagesK + kStagesV + n % kStagesV); };
  auto par_k = [](int n) { return (uint32_t)(n / kStagesK) & 1; };
  auto par_v = [](int n) { return (uint32_t)(n / kStagesV) & 1; };
  auto sK = [&](int n) { return base + S::kK + (n % kStagesK) * TK::kBytes; };
  auto sV = [&](int n) { return base + S::kV + (n % kStagesV) * TK::kBytes; };
  const uint32_t full_q = bars + 16 * (kStagesK + kStagesV), empty_q = full_q + 8;

  // One or two q tiles of one head (flash::schedule), the one with the
  // most keys first; the producer loads the second tile's Q, dO and O
  // while the consumers finish the first.
  const int n_qt = (q_len + kBlockQ - 1) / kBlockQ;
  const flash::Schedule sch =
      flash::schedule(blockIdx.x, n_qt, n_heads, singles, /*heavy_first=*/false);
  const int bh = sch.head;
  const int n_items = sch.tile_b >= 0 ? 2 : 1;
  auto item_q0 = [&](int it) { return (it == 0 ? sch.tile_a : sch.tile_b) * kBlockQ; };
  // The key tiles that query rows below q_end need: causal, keys up to the
  // last row.
  auto key_tiles = [&](int q_end) {
    const int k_end = causal ? min(k_len, q_end) : k_len;
    return (k_end + kBlockK - 1) / kBlockK;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesK; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(empty_k(s), kConsumers * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < kStagesV; ++s) {
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_v(s), kConsumers * 4);
    }
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(empty_q, kConsumers * 4);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The role is read through a shuffle so that the compiler sees it is
  // uniform across the warp, which setmaxnreg's per-role register
  // budgets need.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer ----------------------------------------------------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      const int kv_row = (bh / H) * KV + (bh % H) / (H / KV);
      hopper::prefetch_map(&tm_q);
      hopper::prefetch_map(&tm_do);
      hopper::prefetch_map(&tm_o);
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      int T = 0;  // k tiles loaded so far, over both items
      for (int it = 0; it < n_items; ++it) {
        const int q0 = item_q0(it), n_tiles = key_tiles(q0 + kBlockQ);
        hopper::mbar_wait(empty_q, (it & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full_q, 3 * TQ::kBytes);
#pragma unroll
        for (int b = 0; b < TQ::kBoxes; ++b) {
          const uint32_t off = b * TQ::kBoxBytes;
          hopper::tma_load_3d(sQ + off, &tm_q, full_q, b * TQ::kCols, q0, bh);
          hopper::tma_load_3d(sdO + off, &tm_do, full_q, b * TQ::kCols, q0, bh);
          hopper::tma_load_3d(sO + off, &tm_o, full_q, b * TQ::kCols, q0, bh);
        }
        for (int t = 0; t < n_tiles; ++t, ++T) {
          hopper::mbar_wait(empty_k(T), par_k(T) ^ 1);
          hopper::mbar_arrive_expect_tx(full_k(T), TK::kBytes);
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sK(T) + b * TK::kBoxBytes, &tm_k, full_k(T), b * TK::kCols,
                                t * kBlockK, kv_row);
          hopper::mbar_wait(empty_v(T), par_v(T) ^ 1);
          hopper::mbar_arrive_expect_tx(full_v(T), TK::kBytes);
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sV(T) + b * TK::kBoxBytes, &tm_v, full_v(T), b * TK::kCols,
                                t * kBlockK, kv_row);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    // Per k tile t: issue S_t, dP_t and dQ += dS_{t-1} K_{t-1}; form P_t
    // and dS_t while the later products run on the tensor cores.
    hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    const hopper::Desc dq_a = TQ::k_major(sQ, 64 * c), ddo_a = TQ::k_major(sdO, 64 * c);
    const uint32_t sdQ = base + S::kdQ + c * TD::kBytes;
    uint8_t* const dq_smem = base_ptr + S::kdQ + c * TD::kBytes;
    int T = 0;  // the global index of the item's first k tile
    for (int it = 0; it < n_items; ++it) {
      const int q0 = item_q0(it), n_tiles = key_tiles(q0 + kBlockQ);
      const int first_row = q0 + 64 * c;
      // Causal: the first consumer's rows need one key tile fewer.
      const int my_tiles = key_tiles(first_row + 64);
      const int r_local = 64 * c + 16 * warp + g;  // rows r_local, r_local + 8 of the tile
      const int row0 = q0 + r_local;
      // Only tiles crossing the diagonal or the ragged k edge pay for the mask.
      auto masked = [&](int k0) {
        return (k0 + kBlockK > k_len) || (causal && k0 + kBlockK - 1 > first_row);
      };
      float lse2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        lse2[i] = row0 + 8 * i < q_len ? lse[(size_t)bh * q_len + row0 + 8 * i] * kLog2e : 0.f;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float sc[kBlockK / 2], dp[kBlockK / 2], dl[2];
      uint32_t df[kBlockK / 16][4];

      hopper::mbar_wait(full_q, it & 1);
      {
        hopper::mbar_wait(full_k(T), par_k(T));
        hopper::mbar_wait(full_v(T), par_v(T));
        issue_s_dp<kBf16, D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(T), 0), TK::k_major(sV(T), 0));
        // delta while S and dP run.
        row_delta<kBf16, D>(dl, base_ptr + S::kdO, base_ptr + S::kO, r_local, tg);
        if (tg == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (row0 + 8 * i < q_len) delta[(size_t)bh * q_len + row0 + 8 * i] = dl[i];
        }
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        probs(sc, lse2, masked(0), row0, 0, tg, k_len, causal, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        release(empty_v(T));
        if (my_tiles == 1) release(empty_q);
        grad_scores(dp, sc, dl);
        pack_ds<kBf16>(df, dp);
      }
      for (int t = 1; t < my_tiles; ++t) {
        const int n = T + t;
        hopper::mbar_wait(full_k(n), par_k(n));
        hopper::mbar_wait(full_v(n), par_v(n));
        issue_s_dp<kBf16, D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(n), 0), TK::k_major(sV(n), 0));
        issue_dq<kBf16, D>(acc, df, TK::mn_major(sK(n - 1)));
        hopper::wgmma_wait<2>();
        hopper::fence_regs(sc);
        probs(sc, lse2, masked(t * kBlockK), row0, t * kBlockK, tg, k_len, causal, scale_log2);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(dp);
        release(empty_v(n));
        if (t == my_tiles - 1) release(empty_q);
        grad_scores(dp, sc, dl);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_k(n - 1));
        pack_ds<kBf16>(df, dp);
      }
      {
        const int n = T + my_tiles - 1;
        issue_dq<kBf16, D>(acc, df, TK::mn_major(sK(n)));
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_k(n));
      }
      // The tiles only the second consumer needs: the first frees them,
      // once loaded, so the ring moves on.
      for (int n = T + my_tiles; n < T + n_tiles; ++n) {
        hopper::mbar_wait(full_k(n), par_k(n));
        hopper::mbar_wait(full_v(n), par_v(n));
        release(empty_k(n));
        release(empty_v(n));
      }
      T += n_tiles;

      // dQ goes out through shared memory and one TMA store a consumer
      // (rows past q_len and columns past hd are not written); the
      // previous item's store must have read the buffer first.
      hopper::named_bar_sync(1 + c, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;  // row within this consumer's 64
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dq_smem + TD::pair_off(r, 8 * j + 2 * tg)) =
              pack2<kBf16>(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
      }
      hopper::fence_async_shared();
      hopper::named_bar_sync(1 + c, 128);
      if (tid == 0 && first_row < q_len) {
#pragma unroll
        for (int b = 0; b < TD::kBoxes; ++b)
          hopper::tma_store_3d(&tm_dq, sdQ + b * TD::kBoxBytes, b * TD::kCols, first_row, bh);
        hopper::store_commit();
        hopper::store_wait_read();
      }
    }
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* delta, int batch, int heads, int kv_heads,
                   int q_len, int k_len, int hd, float scale, int causal, cudaStream_t stream) {
  constexpr int kCols = hopper::Tile<D, kBlockQ>::kCols;
  auto kernel = flash_bwd_dq_kernel<kBf16, D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (err != cudaSuccess) return err;
    return hopper::check_register_pool(kernel, kThreads,
                                       128 * kProducerRegs + 128 * kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  const int bh = batch * heads, bkv = batch * kv_heads;
  CUtensorMap mq, mk, mv, mo, mdo, mdq;
  cudaError_t err;
  if ((err = hopper::make_map_3d(&mq, q, kBf16, bh, q_len, hd, kBlockQ, kCols)) ||
      (err = hopper::make_map_3d(&mo, o, kBf16, bh, q_len, hd, kBlockQ, kCols)) ||
      (err = hopper::make_map_3d(&mdo, dout, kBf16, bh, q_len, hd, kBlockQ, kCols)) ||
      (err = hopper::make_map_3d(&mdq, dq, kBf16, bh, q_len, hd, 64, kCols)) ||
      (err = hopper::make_map_3d(&mk, k, kBf16, bkv, k_len, hd, kBlockK, kCols)) ||
      (err = hopper::make_map_3d(&mv, v, kBf16, bkv, k_len, hd, kBlockK, kCols)))
    return err;
  int singles, blocks;
  flash::schedule_size((q_len + kBlockQ - 1) / kBlockQ, bh, &singles, &blocks);
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(
      mq, mk, mv, mo, mdo, mdq, static_cast<const float*>(lse), static_cast<float*>(delta),
      heads, kv_heads, q_len, k_len, scale, causal, bh, singles);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* delta, int batch,
                     int heads, int kv_heads, int q_len, int k_len, int hd, float scale,
                     int causal, cudaStream_t stream) {
  if (hd <= 32)
    return launch<kBf16, 32>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads, q_len,
                             k_len, hd, scale, causal, stream);
  if (hd <= 64)
    return launch<kBf16, 64>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads, q_len,
                             k_len, hd, scale, causal, stream);
  return launch<kBf16, 128>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads, q_len,
                            k_len, hd, scale, causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* dq, void* delta, int batch,
                            int heads, int kv_heads, int q_len, int k_len, int head_dim,
                            float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim <= 0 || head_dim % 16 != 0 || head_dim > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads,
                                        q_len, k_len, head_dim, scale, causal, s)
                       : dispatch<false>(q, k, v, o, dout, lse, dq, delta, batch, heads,
                                         kv_heads, q_len, k_len, head_dim, scale, causal, s));
}
