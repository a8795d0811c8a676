// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// entry point (loaded with ctypes by ray_tpu_torch/ops/attention.py).
//
// Replaces: ray_tpu/ops/attention.py:_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward). It computes the same function:
//   O   = softmax(scale * Q K^T + mask) V      (O in the input dtype)
//   lse = m + log(max(l, 1e-30))               (fp32, natural log, per row)
// with an fp32 online softmax (m, l, acc), native GQA (the kv row of
// program bh is (bh / H) * KV + (bh % H) / (H / KV); K/V are never
// repeated), top-left causal masking (q_id >= k_id) with the k loop
// stopping at the diagonal, ragged q_len/k_len masked in-kernel, and l
// clamped at 1e-30. The probabilities are rounded to the input dtype for
// the P V product (the row sum l stays fp32).
//
// Layout at the boundary: q, o [b*H, q_len, hd]; k, v [b*KV, k_len, hd];
// lse [b*H, q_len]; all contiguous, bf16 or fp16, hd a multiple of 16 up
// to 128.
//
// What bounds it on an H100. At the training shape ([12, 18, 2048, 128],
// causal) it does 4 * hd FLOPs per kept (q, k) pair: 0.2346 ms at
// 989 TFLOP/s against ~0.14 ms of bytes at 3.35 TB/s, so tensor-core
// bound. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W:
// SDPA takes 0.41 ms; the first version of this kernel (mma.sync, loads
// staged synchronously through registers, V transposed by scalar stores,
// 12 warps an SM) took 3.07 ms, its tensor cores idling behind its loads;
// this design takes 0.405 ms.
//
// This design feeds the tensor cores the way Hopper wants:
//   - one block per pair of 128-row q tiles of one b*H row, from opposite
//     ends (flash::schedule in flash_common.cuh): under causal masking
//     every pair does the same work, and single tiles of the last few heads
//     fill the last wave; three warpgroups: a producer (one thread of it
//     issues TMA; setmaxnreg drops it to 24 registers) and two consumers
//     of 64 query rows each (240 registers);
//   - the producer loads each Q tile once and keeps 128-key K and V tiles
//     in flight through a 2-stage ring of shared-memory buffers, each load
//     completing a transaction on an mbarrier; K and V have their own full
//     and empty mbarriers, so a K stage is refilled as soon as its S is
//     done; the second q tile's Q and K load while the first finishes;
//   - rank-3 tensor maps over [heads, len, hd]: a box never reaches into
//     the next head, and TMA zero-fills rows past len and columns past hd;
//   - S = Q K^T is an SS wgmma m64n128k16 (K stored [key][d] is K-major
//     B); O += P V is an RS wgmma m64n{D}k16 with P from registers (the S
//     accumulators of 16 keys are one A fragment) and V read MN-major
//     through the transpose flag straight from its row-major tile;
//   - per k tile each consumer issues S_t and then P_{t-1} V_{t-1}, and
//     runs the softmax of S_t while P V is on the tensor cores; the two
//     consumers take turns issuing (named barriers), so one's softmax
//     overlaps the other's products;
//   - the online softmax keeps the raw running max and computes
//     exp2(s * scale * log2 e - m * scale * log2 e) as one FFMA and one
//     MUFU.EX2; lse is converted back to natural log on the way out;
//   - each consumer writes its 64 rows of O, scaled by 1 / l, into shared
//     memory in TMA's swizzled layout and stores them with one TMA store.
//     (An IEEE division per element there compiled to a call and slowed
//     the whole kernel.)
// Only tiles crossing the diagonal or the ragged k edge pay for the mask;
// the mask value is finite, so exp never sees (-inf) - (-inf). scale must
// be positive (the max is taken on the raw scores).
//
// Registers at D = 128 (ptxas -v): 168 at entry, no spills; the consumer
// loop holds O (64), S (64) and P (32 packed) at once.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;
using flash::pack2;

constexpr int kBlockQ = 128;
constexpr int kBlockK = 128;
constexpr int kStages = 2;
constexpr int kConsumers = 2;  // warpgroups of 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: Q | K[kStages] | V[kStages] | O[kConsumers] | mbarriers,
// tiles 1024-byte aligned. K and V have their own barriers, so a K stage
// is refilled as soon as its S = Q K^T is done, while V waits for P V.
// Each consumer stages its 64 output rows in O for one TMA store.
template <int D>
struct Smem {
  using TQ = hopper::Tile<D, kBlockQ>;
  using TK = hopper::Tile<D, kBlockK>;
  using TO = hopper::Tile<D, 64>;
  static constexpr int kK = TQ::kBytes;
  static constexpr int kV = kK + kStages * TK::kBytes;
  static constexpr int kO = kV + kStages * TK::kBytes;
  static constexpr int kBars = kO + kConsumers * TO::kBytes;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
};

// One tile of the online softmax, in base 2. sc holds this warpgroup's
// raw scores for 64 rows x 128 keys (this thread: rows row0 and row0 + 8)
// and leaves as probabilities exp2(s * scale_log2 - m * scale_log2), one
// FFMA and one MUFU.EX2 an element, against the updated running max m_i
// (kept in raw units). l_i is this thread's share of the row sums (the
// four threads of a quad hold one row; their shares are added at the
// end), and corr is what the output accumulated so far must be multiplied
// by.
__device__ __forceinline__ void online_softmax(float (&sc)[kBlockK / 2], float (&m_i)[2],
                                               float (&l_i)[2], float (&corr)[2], bool masked,
                                               int row0, int k0, int tg, int k_len, int causal,
                                               float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * tg + (e & 1);
        if (col >= k_len || (causal && row < col)) sc[4 * j + e] = kMaskValue;
      }
    }
  }
  float m_scaled[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // A tree of maxima, not a chain: 16 independent pairs first.
    static_assert(kBlockK == 128, "the tree below is for 16 pairs");
    float mx[kBlockK / 8];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) mx[j] = fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) mx[j] = fmaxf(mx[j], mx[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[j] = fmaxf(mx[j], mx[j + 4]);
    float m = fmaxf(fmaxf(fmaxf(mx[0], mx[2]), fmaxf(mx[1], mx[3])), m_i[i]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    corr[i] = hopper::exp2_fast((m_i[i] - m) * scale_log2);
    m_i[i] = m;
    m_scaled[i] = m * scale_log2;
  }
  // Four partial sums a row, so the adds do not form one long chain.
  float part[2][4] = {};
#pragma unroll
  for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = hopper::exp2_fast(fmaf(sc[4 * j + e], scale_log2, -m_scaled[e >> 1]));
      part[e >> 1][(j & 1) * 2 + (e & 1)] += sc[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l_i[i] = l_i[i] * corr[i] + ((part[i][0] + part[i][1]) + (part[i][2] + part[i][3]));
}

// The output accumulated so far, scaled by each row's correction.
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    acc[4 * j + 0] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// P as A fragments: the accumulators of keys 16k..16k+15, in pairs.
template <bool kBf16>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[kBlockK / 16][4],
                                       const float (&sc)[kBlockK / 2]) {
#pragma unroll
  for (int k = 0; k < kBlockK / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[k][i] = pack2<kBf16>(sc[8 * k + 2 * i], sc[8 * k + 2 * i + 1]);
}

// Issues S = Q K^T for this warpgroup's 64 rows x 128 keys as one wgmma
// group (Q and K K-major).
template <bool kBf16, int D>
__device__ __forceinline__ void issue_s(float (&sc)[kBlockK / 2], hopper::Desc dq,
                                        hopper::Desc dk) {
  using TQ = hopper::Tile<D, kBlockQ>;
  using TK = hopper::Tile<D, kBlockK>;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    hopper::wgmma_ss<kBlockK, kBf16, 0>(sc, hopper::desc_at(dq, TQ::k_off(k)),
                                        hopper::desc_at(dk, TK::k_off(k)), k > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(sc);
}

// Issues O += P V as one wgmma group: P from registers, V MN-major.
template <bool kBf16, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pf)[kBlockK / 16][4],
                                         hopper::Desc dv) {
  using TK = hopper::Tile<D, kBlockK>;
  hopper::fence_regs(acc);
  hopper::fence_regs(pf);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kBlockK / 16; ++k)
    hopper::wgmma_rs<D, kBf16, 1>(acc, pf[k], hopper::desc_at(dv, TK::mn_off(k)), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
  hopper::fence_regs(pf);
}

// D is head_dim rounded up to 32, 64 or 128; columns in [hd, D) are
// zero-filled by TMA and never stored.
template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ lse, int H, int KV, int q_len, int k_len, float scale_log2,
                 int causal, int n_heads, int singles) {
  using S = Smem<D>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using TO = typename S::TO;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + S::kK + s * TK::kBytes; };
  auto sV = [&](int s) { return base + S::kV + s * TK::kBytes; };
  // mbarriers: full_k, full_v, empty_k, empty_v [kStages] each, then the
  // Q tile's full and empty.
  const uint32_t bars = base + S::kBars;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * kStages + s); };
  const uint32_t full_q = bars + 8 * 4 * kStages, empty_q = full_q + 8;

  // One or two q tiles of one head (flash::schedule): the one with the
  // most keys first; the producer loads the second tile's Q and K while the
  // consumers finish the first.
  const int n_qt = (q_len + kBlockQ - 1) / kBlockQ;
  const flash::Schedule sch =
      flash::schedule(blockIdx.x, n_qt, n_heads, singles, /*heavy_first=*/false);
  const int bh = sch.head;
  const int n_items = sch.tile_b >= 0 ? 2 : 1;
  auto item_q0 = [&](int it) { return (it == 0 ? sch.tile_a : sch.tile_b) * kBlockQ; };
  // Causal: keys beyond the tile's last row never contribute.
  auto item_tiles = [&](int q0) {
    const int k_end = causal ? min(k_len, q0 + kBlockQ) : k_len;
    return (k_end + kBlockK - 1) / kBlockK;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_k(s), kConsumers * 4);  // one arrival per consumer warp
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
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      int T = 0;  // k tiles loaded so far, over both items
      for (int it = 0; it < n_items; ++it) {
        const int q0 = item_q0(it), n_tiles = item_tiles(q0);
        hopper::mbar_wait(empty_q, (it & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full_q, TQ::kBytes);
#pragma unroll
        for (int b = 0; b < TQ::kBoxes; ++b)
          hopper::tma_load_3d(sQ + b * TQ::kBoxBytes, &tm_q, full_q, b * TQ::kCols, q0, bh);
        for (int t = 0; t < n_tiles; ++t, ++T) {
          const int s = T % kStages;
          const uint32_t parity = ((T / kStages) & 1) ^ 1;
          hopper::mbar_wait(empty_k(s), parity);
          hopper::mbar_arrive_expect_tx(full_k(s), TK::kBytes);
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sK(s) + b * TK::kBoxBytes, &tm_k, full_k(s), b * TK::kCols,
                                t * kBlockK, kv_row);
          hopper::mbar_wait(empty_v(s), parity);
          hopper::mbar_arrive_expect_tx(full_v(s), TK::kBytes);
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sV(s) + b * TK::kBoxBytes, &tm_v, full_v(s), b * TK::kCols,
                                t * kBlockK, kv_row);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    // Per k tile t: issue S_t = Q K_t^T, then O += P_{t-1} V_{t-1}; the
    // softmax of S_t runs while the P V product is on the tensor cores.
    hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    const hopper::Desc dq = TQ::k_major(sQ, 64 * c);
    const uint32_t sO = base + S::kO + c * TO::kBytes;
    uint8_t* const o_smem = smem_raw + (sO - hopper::smem_u32(smem_raw));
    // The two consumers take turns issuing their products (named barriers
    // 1 and 2), so one's softmax runs while the other's products use the
    // tensor cores; consumer 0 goes first.
    auto my_turn = [&] { hopper::named_bar_sync(1 + c, 256); };
    auto pass_turn = [&] { hopper::named_bar_arrive(2 - c, 256); };
    if (c == 1) pass_turn();

    int T = 0;  // the global index of the item's first k tile
    for (int it = 0; it < n_items; ++it) {
      const int q0 = item_q0(it), n_tiles = item_tiles(q0);
      const int row0 = q0 + 64 * c + 16 * warp + g;  // this thread's rows: row0, row0 + 8
      // Only tiles crossing the diagonal or the ragged k edge pay for the mask.
      auto masked = [&](int k0) {
        return (k0 + kBlockK > k_len) || (causal && k0 + kBlockK - 1 > q0 + 64 * c);
      };
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_i[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
      float l_i[2] = {0.f, 0.f};
      float sc[kBlockK / 2], corr[2];
      uint32_t pf[kBlockK / 16][4];

      hopper::mbar_wait(full_q, it & 1);
      hopper::mbar_wait(full_k(T % kStages), (T / kStages) & 1);
      my_turn();
      issue_s<kBf16, D>(sc, dq, TK::k_major(sK(T % kStages), 0));
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(empty_k(T % kStages));
      if (n_tiles == 1) release(empty_q);
      online_softmax(sc, m_i, l_i, corr, masked(0), row0, 0, tg, k_len, causal, scale_log2);
      pack_p<kBf16>(pf, sc);
      for (int t = 1; t < n_tiles; ++t) {
        const int s = (T + t) % kStages, sp = (T + t - 1) % kStages;
        hopper::mbar_wait(full_k(s), ((T + t) / kStages) & 1);
        hopper::mbar_wait(full_v(sp), ((T + t - 1) / kStages) & 1);
        my_turn();
        issue_s<kBf16, D>(sc, dq, TK::k_major(sK(s), 0));
        rescale(acc, corr);  // while S runs on the tensor cores
        issue_pv<kBf16, D>(acc, pf, TK::mn_major(sV(sp)));
        pass_turn();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        release(empty_k(s));
        if (t == n_tiles - 1) release(empty_q);
        online_softmax(sc, m_i, l_i, corr, masked(t * kBlockK), row0, t * kBlockK, tg, k_len,
                       causal, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_v(sp));
        pack_p<kBf16>(pf, sc);
      }
      T += n_tiles;
      {
        const int sp = (T - 1) % kStages;
        hopper::mbar_wait(full_v(sp), ((T - 1) / kStages) & 1);
        rescale(acc, corr);
        my_turn();
        issue_pv<kBf16, D>(acc, pf, TK::mn_major(sV(sp)));
        pass_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_v(sp));
      }

      // O goes out through shared memory and one TMA store a consumer
      // (rows past q_len and columns past hd are not written); the
      // previous item's store must have read the buffer first.
      hopper::named_bar_sync(3 + c, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
        const float l = fmaxf(l_i[i], 1e-30f), inv_l = __fdividef(1.f, l);
        const int r = 16 * warp + g + 8 * i;  // row within this consumer's 64
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(o_smem + TO::pair_off(r, 8 * j + 2 * tg)) =
              pack2<kBf16>(acc[4 * j + 2 * i] * inv_l, acc[4 * j + 2 * i + 1] * inv_l);
        if (tg == 0 && row0 + 8 * i < q_len)
          lse[(size_t)bh * q_len + row0 + 8 * i] = (m_i[i] * scale_log2 + __log2f(l)) * kLn2;
      }
      hopper::fence_async_shared();
      hopper::named_bar_sync(3 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < TO::kBoxes; ++b)
          hopper::tma_store_3d(&tm_o, sO + b * TO::kBoxBytes, b * TO::kCols, q0 + 64 * c, bh);
        hopper::store_commit();
        hopper::store_wait_read();
      }
    }
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int heads, int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int kCols = hopper::Tile<D, kBlockQ>::kCols;
  auto kernel = flash_fwd_kernel<kBf16, D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (err != cudaSuccess) return err;
    return hopper::check_register_pool(kernel, kThreads,
                                       128 * kProducerRegs + 128 * kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err;
  if ((err = hopper::make_map_3d(&mq, q, kBf16, batch * heads, q_len, hd, kBlockQ, kCols)) ||
      (err = hopper::make_map_3d(&mo, o, kBf16, batch * heads, q_len, hd, 64, kCols)) ||
      (err = hopper::make_map_3d(&mk, k, kBf16, batch * kv_heads, k_len, hd, kBlockK, kCols)) ||
      (err = hopper::make_map_3d(&mv, v, kBf16, batch * kv_heads, k_len, hd, kBlockK, kCols)))
    return err;
  int singles, blocks;
  flash::schedule_size((q_len + kBlockQ - 1) / kBlockQ, batch * heads, &singles, &blocks);
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(
      mq, mk, mv, mo, static_cast<float*>(lse), heads, kv_heads, q_len, k_len, scale * kLog2e,
      causal, batch * heads, singles);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                     int heads, int kv_heads, int q_len, int k_len, int hd, float scale,
                     int causal, cudaStream_t stream) {
  if (hd <= 32)
    return launch<kBf16, 32>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale, causal, stream);
  if (hd <= 64)
    return launch<kBf16, 64>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale, causal, stream);
  return launch<kBf16, 128>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale, causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int batch, int heads, int kv_heads, int q_len, int k_len,
                         int head_dim, float scale, int causal, int is_bf16,
                         void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      q_len <= 0 || k_len <= 0 || head_dim <= 0 || head_dim % 16 != 0 ||
      head_dim > 128 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<true>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, head_dim, scale, causal, s)
              : dispatch<false>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, head_dim, scale, causal, s);
  return (int)err;
}
