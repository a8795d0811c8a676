// Flash-attention forward for Hopper (sm_90a) at wide heads (head dims that
// are multiples of 8 in 129-256), bound through a plain C entry point
// (loaded with ctypes by ray_tpu_torch/ops/attention.py:flash_forward_wide_cuda).
//
// Replaces: ray_tpu/ops/attention.py:_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward) for the inputs flash_fwd.cu does not
// take because their rows are too wide for its tiles. It computes the same
// function as flash_fwd.cu:
//   O   = softmax(scale * Q K^T + mask) V      (O in the input dtype)
//   lse = m + log(max(l, 1e-30))               (fp32, natural log, per row)
// with an fp32 online softmax, native GQA (the kv row of program bh is
// (bh / H) * KV + (bh % H) / (H / KV)), top-left causal masking
// (q_id >= k_id), ragged q_len/k_len masked in-kernel, and the
// probabilities rounded to the input dtype for the P V product.
//
// Layout at the boundary: q, o [b*H, q_len, hd]; k, v [b*KV, k_len, hd];
// lse [b*H, q_len]; all contiguous, bf16 or fp16, hd a multiple of 8 in
// 129-256 (D = 192 holds 136-192, D = 256 holds 200-256; the columns past
// hd are zero-filled by TMA and never stored).
//
// What bounds it on an H100. At Gemma-7B's head shape ([1, 16, 2048, 256],
// causal) it does 4 * hd FLOPs per kept (q, k) pair: 0.0348 ms at
// 989 TFLOP/s against ~0.01 ms of bytes at 3.35 TB/s, so tensor-core
// bound. The general SIMT kernel (flash_general.cu) took 1.886 ms there.
//
// Why flash_fwd.cu's tiles do not widen. A consumer warpgroup of 64 query
// rows holds O as 64 x D fp32 accumulators: 128 registers a thread at
// D = 256. With 128-key tiles S (64) and packed P (32) come on top: 224
// before any address, against the 240 a consumer gets. Shared memory runs
// out as well: Q 64 KB and a 2-stage ring of 128-key K and V tiles would be
// 256 KB. So this design:
//   - keeps flash_fwd.cu's structure: one block per pair of 128-row q tiles
//     of one b*H row from opposite ends (flash::schedule), a producer
//     warpgroup (one thread issues TMA; setmaxnreg drops it to 24
//     registers) and two consumer warpgroups of 64 query rows (240);
//   - walks 64-key K and V tiles: a consumer holds O (128 registers at
//     D = 256), S (32) and packed P (16); shared memory holds each
//     consumer's Q rows (2 x 32 KB) and a 2-stage ring of K and V tiles
//     (4 x 32 KB): 192 KB of the 227 KB;
//   - no room is left for flash_fwd.cu's O staging buffers, so each
//     consumer stages its O tile in its own Q rows (the same 64-row
//     swizzled layout) for one TMA store, and releases them to the
//     producer only when the store has read them; each consumer's Q rows
//     have their own full and empty mbarriers, and for a second q tile the
//     producer puts the first K and V tiles in flight before it waits for
//     the Q rows, so the ring fills while the first tile's O goes out;
//   - S = Q K^T is an SS wgmma m64n64k16 per 16 columns of D; O += P V is
//     an RS wgmma m64n{D}k16 (one instruction a 16-key step, N = 192 or
//     256) with V read MN-major through the transpose flag straight from
//     its row-major tile (a row of V is D / 64 swizzled 64-column boxes);
//   - per k tile each consumer issues S_t and then P_{t-1} V_{t-1}, and
//     runs the softmax of S_t while P V is on the tensor cores; the two
//     consumers take turns issuing (named barriers 1 and 2);
//   - under causal masking the first consumer's rows end 64 keys before the
//     second's: it skips the tile no row of it sees (it only takes its turn
//     and releases the tile), where flash_fwd.cu's 128-key tiles split it.
// Only tiles crossing the diagonal or the ragged k edge pay for the mask;
// scale must be positive (the max is taken on the raw scores).

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;
using flash::pack2;

constexpr int kBlockQ = 128;  // two consumers of 64 rows
constexpr int kBlockK = 64;
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: Q[kConsumers] (64 rows each, also that consumer's O
// staging) | K[kStages] | V[kStages] | mbarriers, tiles 1024-byte aligned.
template <int D>
struct Smem {
  using TQ = hopper::Tile<D, 64>;
  using TK = hopper::Tile<D, kBlockK>;
  static constexpr int kK = kConsumers * TQ::kBytes;
  static constexpr int kV = kK + kStages * TK::kBytes;
  static constexpr int kBars = kV + kStages * TK::kBytes;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
};

// One 64-key tile of the online softmax in base 2, as flash_fwd.cu's: sc
// holds this warpgroup's raw scores for 64 rows x 64 keys (this thread:
// rows row0 and row0 + 8) and leaves as exp2(s * scale_log2 - m *
// scale_log2) against the updated running max m_i (raw units); l_i is this
// thread's share of the row sums (a quad of threads holds a row); corr is
// the factor for the output accumulated so far.
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
    // A tree of maxima, not a chain: 8 independent pairs first.
    static_assert(kBlockK == 64, "the tree below is for 8 pairs");
    float mx[kBlockK / 8];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) mx[j] = fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[j] = fmaxf(mx[j], mx[j + 4]);
    float m = fmaxf(fmaxf(fmaxf(mx[0], mx[2]), fmaxf(mx[1], mx[3])), m_i[i]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    corr[i] = hopper::exp2_fast((m_i[i] - m) * scale_log2);
    m_i[i] = m;
    m_scaled[i] = m * scale_log2;
  }
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

// Issues S = Q K^T for this warpgroup's 64 rows x 64 keys as one wgmma
// group (Q and K K-major).
template <bool kBf16, int D>
__device__ __forceinline__ void issue_s(float (&sc)[kBlockK / 2], hopper::Desc dq,
                                        hopper::Desc dk) {
  using T = hopper::Tile<D, 64>;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    hopper::wgmma_ss<kBlockK, kBf16, 0>(sc, hopper::desc_at(dq, T::k_off(k)),
                                        hopper::desc_at(dk, T::k_off(k)), k > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(sc);
}

// Issues O += P V as one wgmma group: P from registers, V MN-major, all D
// columns in one instruction a 16-key step.
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

template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int H,
                      int KV, int q_len, int k_len, float scale_log2, int causal, int n_heads,
                      int singles) {
  using S = Smem<D>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  auto sQ = [&](int c) { return base + c * TQ::kBytes; };
  auto sK = [&](int s) { return base + S::kK + s * TK::kBytes; };
  auto sV = [&](int s) { return base + S::kV + s * TK::kBytes; };
  // mbarriers: full_k, full_v, empty_k, empty_v [kStages] each, then each
  // consumer's Q rows' full and empty.
  const uint32_t bars = base + S::kBars;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * kStages + s); };
  auto full_q = [&](int c) { return bars + 8 * (4 * kStages + c); };
  auto empty_q = [&](int c) { return bars + 8 * (4 * kStages + kConsumers + c); };

  const int n_qt = (q_len + kBlockQ - 1) / kBlockQ;
  const flash::Schedule sch =
      flash::schedule(blockIdx.x, n_qt, n_heads, singles, /*heavy_first=*/false);
  const int bh = sch.head;
  const int n_items = sch.tile_b >= 0 ? 2 : 1;
  auto item_q0 = [&](int it) { return (it == 0 ? sch.tile_a : sch.tile_b) * kBlockQ; };
  // The k tiles rows [r0, r0 + rows) see: causal rows see no key past
  // their last row.
  auto tiles_for = [&](int r0, int rows) {
    const int k_end = causal ? min(k_len, r0 + rows) : k_len;
    return (k_end + kBlockK - 1) / kBlockK;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_k(s), kConsumers * 4);  // one arrival per consumer warp
      hopper::mbar_init(empty_v(s), kConsumers * 4);
    }
    for (int c = 0; c < kConsumers; ++c) {
      hopper::mbar_init(full_q(c), 1);
      hopper::mbar_init(empty_q(c), 1);  // the thread that stored the consumer's O
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer ----------------------------------------------------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      const int kv_row = (bh / H) * KV + (bh % H) / (H / KV);
      hopper::prefetch_map(&tm_q);
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      auto load_q = [&](int it, int q0) {
        for (int c = 0; c < kConsumers; ++c) {
          hopper::mbar_wait(empty_q(c), (it & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full_q(c), TQ::kBytes);
#pragma unroll
          for (int b = 0; b < TQ::kBoxes; ++b)
            hopper::tma_load_3d(sQ(c) + b * TQ::kBoxBytes, &tm_q, full_q(c), b * TQ::kCols,
                                q0 + 64 * c, bh);
        }
      };
      int T = 0;  // k tiles loaded so far, over both items
      for (int it = 0; it < n_items; ++it) {
        const int q0 = item_q0(it), n_tiles = tiles_for(q0, kBlockQ);
        // A second tile's Q rows free up only once the first tile's O has
        // gone out through them: fill the ring first.
        const int q_at = it == 0 ? 0 : min(kStages, n_tiles);
        for (int t = 0; t < n_tiles; ++t, ++T) {
          if (t == q_at) load_q(it, q0);
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
        if (q_at == n_tiles) load_q(it, q0);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    const hopper::Desc dq = TQ::k_major(sQ(c), 0);
    uint8_t* const o_smem = smem_raw + (sQ(c) - hopper::smem_u32(smem_raw));
    auto my_turn = [&] { hopper::named_bar_sync(1 + c, 256); };
    auto pass_turn = [&] { hopper::named_bar_arrive(2 - c, 256); };
    if (c == 1) pass_turn();

    int T = 0;  // the global index of the item's first k tile
    for (int it = 0; it < n_items; ++it) {
      const int q0 = item_q0(it), n_tiles = tiles_for(q0, kBlockQ);
      const int r_first = q0 + 64 * c;               // this warpgroup's first row
      const int n_mine = tiles_for(r_first, 64);     // <= n_tiles
      const int row0 = r_first + 16 * warp + g;      // this thread's rows: row0, row0 + 8
      auto masked = [&](int k0) {
        return (k0 + kBlockK > k_len) || (causal && k0 + kBlockK - 1 > r_first);
      };
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_i[2] = {-INFINITY, -INFINITY};
      float l_i[2] = {0.f, 0.f};
      float sc[kBlockK / 2], corr[2];
      uint32_t pf[kBlockK / 16][4];

      hopper::mbar_wait(full_q(c), it & 1);
      hopper::mbar_wait(full_k(T % kStages), (T / kStages) & 1);
      my_turn();
      issue_s<kBf16, D>(sc, dq, TK::k_major(sK(T % kStages), 0));
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(empty_k(T % kStages));
      online_softmax(sc, m_i, l_i, corr, masked(0), row0, 0, tg, k_len, causal, scale_log2);
      pack_p<kBf16>(pf, sc);
      for (int t = 1; t < n_mine; ++t) {
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
        online_softmax(sc, m_i, l_i, corr, masked(t * kBlockK), row0, t * kBlockK, tg, k_len,
                       causal, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_v(sp));
        pack_p<kBf16>(pf, sc);
      }
      {
        const int t = n_mine - 1, sp = (T + t) % kStages;
        hopper::mbar_wait(full_v(sp), ((T + t) / kStages) & 1);
        rescale(acc, corr);
        my_turn();
        issue_pv<kBf16, D>(acc, pf, TK::mn_major(sV(sp)));
        pass_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_v(sp));
      }
      // Tiles no row of this warpgroup sees (causal): take the turn and
      // release the stage once it has arrived, so both consumers take the
      // same turns and every stage's phase completes in order.
      for (int t = n_mine; t < n_tiles; ++t) {
        const int s = (T + t) % kStages;
        hopper::mbar_wait(full_k(s), ((T + t) / kStages) & 1);
        hopper::mbar_wait(full_v(s), ((T + t) / kStages) & 1);
        my_turn();
        pass_turn();
        release(empty_k(s));
        release(empty_v(s));
      }
      T += n_tiles;

      // O goes out through this consumer's Q rows (every wgmma that read
      // them has completed) and one TMA store; rows past q_len and columns
      // past hd are not written. The rows go back to the producer once the
      // store has read them.
      hopper::named_bar_sync(3 + c, 128);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
        const float l = fmaxf(l_i[i], 1e-30f), inv_l = __fdividef(1.f, l);
        const int r = 16 * warp + g + 8 * i;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(o_smem + TQ::pair_off(r, 8 * j + 2 * tg)) =
              pack2<kBf16>(acc[4 * j + 2 * i] * inv_l, acc[4 * j + 2 * i + 1] * inv_l);
        if (tg == 0 && row0 + 8 * i < q_len)
          lse[(size_t)bh * q_len + row0 + 8 * i] = (m_i[i] * scale_log2 + __log2f(l)) * kLn2;
      }
      hopper::fence_async_shared();
      hopper::named_bar_sync(3 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int b = 0; b < TQ::kBoxes; ++b)
          hopper::tma_store_3d(&tm_o, sQ(c) + b * TQ::kBoxBytes, b * TQ::kCols, r_first, bh);
        hopper::store_commit();
        hopper::store_wait_read();
        hopper::mbar_arrive(empty_q(c));
      }
    }
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                   int heads, int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int kCols = hopper::Tile<D, 64>::kCols;
  auto kernel = flash_fwd_wide_kernel<kBf16, D>;
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
  if ((err = hopper::make_map_3d(&mq, q, kBf16, batch * heads, q_len, hd, 64, kCols)) ||
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
  if (hd <= 192)
    return launch<kBf16, 192>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale,
                              causal, stream);
  return launch<kBf16, 256>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale,
                            causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                              int batch, int heads, int kv_heads, int q_len, int k_len,
                              int head_dim, float scale, int causal, int is_bf16,
                              void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim % 8 != 0 || head_dim < 129 || head_dim > 256 || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len,
                                        head_dim, scale, causal, s)
                       : dispatch<false>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len,
                                         head_dim, scale, causal, s));
}
