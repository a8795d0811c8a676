// Flash-attention backward, dK and dV, for fp32 inputs on Hopper (sm_90a)
// tensor cores, bound through a plain C entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_bwd_dkv_fp32_cuda).
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel for fp32
// q/k/v, scale > 0 and head dims up to 128 that are multiples of 4 (the
// "hopper_fp32" route). It rebuilds the probabilities from the forward's
// fp32 (natural-log) logsumexp:
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (fp32,
//        written by the fp32 dQ kernel, flash_bwd_dq_fp32.cu, which runs
//        first on this route)
//   dV = P^T dO,  dK = scale * dS^T Q
// to fp32 accuracy, with the forward's conventions: native GQA by index
// (K/V never repeated; dK and dV summed over each kv head's group of q
// heads), top-left causal masking (q_id >= k_id), ragged lengths masked
// in-kernel, the finite mask value.
//
// Layout at the boundary: q, do [b*H, q_len, hd]; k, v, dk, dv
// [b*KV, k_len, hd]; lse, delta [b*H, q_len]; all contiguous fp32,
// 16-byte aligned, hd a multiple of 4 up to 128 (D = 32, 64 or 128 is hd
// rounded up; TMA zero-fills the columns past hd, never stored).
//
// What bounds it on an H100. Four products in fp32 (S, dP, dV, dK): 8 * hd
// FLOPs a kept (q, k) pair. The SIMT general kernel does them as fp32
// FMAs, bound at 67 TFLOP/s (0.0642 ms at [2, 8/2, 1024, 64] causal; it
// took 0.6266). Here each product is six bf16 wgmma products of a
// three-way split (flash_fp32.cuh), bound at ~165 TFLOP/s: 0.0261 ms at
// that shape, against ~0.003 ms of bytes, so bound by operations.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: this
// design takes 0.0693 ms there (37% of that bound); with the SIMT general
// dQ (0.2127), which this route ran first until flash_bwd_dq_fp32.cu, the
// backward took 0.2820 against SDPA's 0.4334 (TF32 off).
//
// This design:
//   - a block owns kBlockK keys of one kv head: 128 keys as two consumer
//     warpgroups of 64 up to D = 64, 64 keys as one at D = 128 (shared
//     memory); plus a producer warpgroup. Key tiles with the most queries
//     are scheduled first;
//   - the grid: a key tile's work is its steps, kBlockQ queries of one q
//     head of the kv head's group each, and under causal masking the first
//     tiles have the most. [2, 8/2, 1024, 64] has only 32 key tiles for
//     132 SMs, the first with 64 steps and the last with 8. So each key
//     tile's steps are cut into parts of at most `steps_per_block` (Plan:
//     the wrapper picks the least that fits one wave: 10 there, 128
//     blocks), one block each; a block then writes its dK/dV sums to its
//     own slot of an fp32 scratch, and a second small kernel adds each key
//     tile's parts in a fixed order. No atomics: dK and dV are bitwise
//     repeatable. Where every tile is one part the sums go straight out;
//   - the producer streams fp32 tiles by TMA (one thread issues) into a
//     2-stage ring of dense fp32 buffers: K and V at the start, then Q and
//     dO for each step of kBlockQ queries; all 128 producer threads split
//     each into three bf16 parts in the swizzled layout wgmma reads (K and
//     V once, Q and dO through a 2-stage ring), and load the step's lse
//     (times log2 e) and delta rows beside them;
//   - per step each consumer computes S^T = K Q^T and dP^T = V dO^T by SS
//     wgmma (K and V as A, Q and dO as stored are K-major B), P^T and dS^T
//     in fp32 registers, split three ways as A fragments, and dV += P^T dO
//     and dK += dS^T Q by RS wgmma with dO and Q read MN-major through the
//     bf16 transpose flag: each product six split wgmmas, and no
//     transposed copies (TF32 wgmma takes only K-major operands, so 3xTF32
//     would need dO^T and Q^T written out every step). dS^T is formed
//     while dV's product runs, and the two consumers take turns issuing
//     (named barriers), so one's exponentials and splits overlap the
//     other's products (a little faster than without in a trial run);
//   - dK and dV stay in fp32 registers across the whole loop; scale is
//     applied to dK once at the end; keys that no query reaches get zeros.
// Variants that ran slower on an H100 in trial runs: splitting q, dO, k
// and v in passes before the loop, as the forward does (the passes' bytes
// and launches outweigh the split work they save here), issuing the next
// step's S^T and dP^T behind this step's dK product (ptxas then serialises
// the wgmmas), and a second set of fragment registers so that dK's product
// queues behind dV's without a wait (no gain).
// Shared memory: K and V parts 2 * 6 * D * kBlockK bytes, a step's Q and
// dO parts 2 * 6 * D * kBlockQ, two stages of those, and two fp32 buffers
// of 4 * D * kBlockQ: 224 KB at D = 64 (kBlockQ 64) and at D = 128
// (kBlockQ 32). Registers: dK and dV (D / 2 each), S^T and dP^T
// (kBlockQ / 2 each) and one set of three A fragments (3 * kBlockQ / 4):
// 176 at D = 64, 184 at D = 128.

#include <math.h>

#include "flash_common.cuh"
#include "flash_fp32.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;

constexpr int kStages = 2;  // the split Q/dO ring, and the fp32 ring
// The register hand-over (setmaxnreg) of the two-consumer blocks (384
// threads, 168 registers each at entry). A one-consumer block (256
// threads) keeps the registers ptxas gives it, up to 255, and hands over
// none.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kConsumers = D == 128 ? 1 : 2;  // warpgroups of 64 keys
  static constexpr int kBlockK = 64 * kConsumers;      // keys per block
  static constexpr int kBlockQ = D == 128 ? 32 : 64;   // queries per step
  static constexpr int kThreads = 128 * (kConsumers + 1);
  using TK = hopper::Tile<D, kBlockK>;
  using TQ = hopper::Tile<D, kBlockQ>;
  // Shared memory: K parts | V parts | Q parts, dO parts [kStages] | fp32
  // buffers [kStages] | lse [kStages][kBlockQ] | delta [...] | mbarriers.
  static constexpr int kRawBytes = kBlockQ * D * 4;
  static constexpr int kV = 3 * TK::kBytes;
  static constexpr int kQ = 2 * 3 * TK::kBytes;
  static constexpr int kRaw = kQ + kStages * 2 * 3 * TQ::kBytes;
  static constexpr int kRows = kRaw + kStages * kRawBytes;
  static constexpr int kBars = kRows + 2 * kStages * kBlockQ * 4;
  static constexpr int kBytes = kBars + 64 + 1024;  // + mbarriers + alignment slack
  static_assert(kBytes <= 232448, "shared memory");
  static_assert(kBlockK % kBlockQ == 0, "K and V load in kBlockQ-row chunks");
};

// Issues acc = A B^T over D columns as one wgmma group: A's three parts
// (K or V, K-major, this warpgroup's 64 rows) against B's (Q or dO,
// K-major): 64 keys x kBlockQ queries.
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[Cfg<D>::kBlockQ / 2], hopper::Desc da,
                                             hopper::Desc db) {
  using TK = typename Cfg<D>::TK;
  using TQ = typename Cfg<D>::TQ;
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_ss<Cfg<D>::kBlockQ, true, 0>(
          acc, hopper::desc_at(da, fp32x3::term_a(t) * TK::kBytes + TK::k_off(k)),
          hopper::desc_at(db, fp32x3::term_b(t) * TQ::kBytes + TQ::k_off(k)), k + t > 0);
  hopper::wgmma_commit();
}

// Issues acc += F B as one wgmma group: F's three parts from registers
// (P^T or dS^T, 64 keys x kBlockQ queries), B's three parts (dO or Q)
// MN-major.
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2],
                                           uint32_t (&f)[3][Cfg<D>::kBlockQ / 16][4],
                                           hopper::Desc db) {
  using TQ = typename Cfg<D>::TQ;
  hopper::fence_regs(acc);
#pragma unroll
  for (int s = 0; s < 3; ++s) hopper::fence_regs(f[s]);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < Cfg<D>::kBlockQ / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_rs<D, true, 1>(
          acc, f[fp32x3::term_a(t)][k],
          hopper::desc_at(db, fp32x3::term_b(t) * TQ::kBytes + TQ::mn_off(k)), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
#pragma unroll
  for (int s = 0; s < 3; ++s) hopper::fence_regs(f[s]);
}

// The blocks: key tile t (first the tiles with the most steps), then kv
// head, then part. Tile t has steps(t) steps (kBlockQ queries of one q head
// of the group each, the causal diagonal on), cut into parts(t) parts of at
// most steps_per_block.
template <int D>
struct Plan {
  int n_q, group, n_kv_heads, steps_per_block, causal;
  __host__ __device__ int steps(int t) const {
    const int t_begin = causal ? t * Cfg<D>::kBlockK / Cfg<D>::kBlockQ : 0;
    return n_q > t_begin ? group * (n_q - t_begin) : 0;
  }
  __host__ __device__ int parts(int t) const {
    const int n = steps(t);
    return n > steps_per_block ? (n + steps_per_block - 1) / steps_per_block : 1;
  }
  // The first block of tile t (the tiles before it, every kv head's parts).
  __host__ __device__ int first_block(int t) const {
    int first = 0;
    for (int u = 0; u < t; ++u) first += n_kv_heads * parts(u);
    return first;
  }
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_bwd_dkv_fp32_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int KV,
                          int q_len, int k_len, int hd, float scale, const Plan<D> plan,
                          int to_slots) {
  using C = Cfg<D>;
  using TK = typename C::TK;
  using TQ = typename C::TQ;
  constexpr int kBlockK = C::kBlockK, kBlockQ = C::kBlockQ, kConsumers = C::kConsumers;
  constexpr int kKvChunks = kBlockK / kBlockQ;  // fp32 buffers a K or V tile takes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + C::kV;
  auto sQ = [&](int s) { return base + C::kQ + s * 2 * 3 * TQ::kBytes; };
  auto sdO = [&](int s) { return sQ(s) + 3 * TQ::kBytes; };
  float* const sLse = reinterpret_cast<float*>(base_ptr + C::kRows);  // [kStages][kBlockQ]
  float* const sDelta = sLse + kStages * kBlockQ;
  // mbarriers: raw_full, full, empty [kStages] each, then kv_full.
  const uint32_t bars = base + C::kBars;
  auto raw_full = [&](int s) { return bars + 8 * s; };
  auto full = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * kStages + s); };
  const uint32_t kv_full = bars + 8 * 3 * kStages;

  // The block's key tile, kv head and part (Plan), and its steps
  // [n_first, n_first + n_steps) of the tile's group * per_head.
  int t = 0, first = 0;
  while ((int)blockIdx.x >= first + plan.n_kv_heads * plan.parts(t)) {
    first += plan.n_kv_heads * plan.parts(t);
    ++t;
  }
  const int n_parts = plan.parts(t);
  const int in_tile = (int)blockIdx.x - first;
  const int bkv = in_tile / n_parts, part = in_tile % n_parts;
  const int k0 = t * kBlockK;
  const int causal = plan.causal, group = plan.group;
  const int b = bkv / KV, kvh = bkv % KV;
  const int t_begin = causal ? k0 / kBlockQ : 0;  // queries before k0 see none of the keys
  const int per_head = max(0, plan.n_q - t_begin);
  const int tile_steps = plan.steps(t);
  const int n_first = (int)((long long)part * tile_steps / n_parts);
  const int n_steps = (int)((long long)(part + 1) * tile_steps / n_parts) - n_first;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(raw_full(s), 1);
      hopper::mbar_init(full(s), 128);              // every producer thread
      hopper::mbar_init(empty(s), kConsumers * 4);  // one arrival per consumer warp
    }
    hopper::mbar_init(kv_full, 128);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: TMA into the fp32 ring, split into the bf16 tiles --
    if constexpr (kConsumers == 2) hopper::reg_dealloc<kProducerRegs>();
    const int ptid = threadIdx.x - 128 * kConsumers;
    // fp32 tile j: K chunks, V chunks, then Q_n and dO_n for each step n.
    const int n_raw = n_steps > 0 ? 2 * kKvChunks + 2 * n_steps : 0;
    auto step_head = [&](int n) { return b * H + kvh * group + (n_first + n) / per_head; };
    auto step_q0 = [&](int n) { return (t_begin + (n_first + n) % per_head) * kBlockQ; };
    auto load = [&](int j) {
      const int s = j % kStages;
      hopper::mbar_arrive_expect_tx(raw_full(s), C::kRawBytes);
      if (j < 2 * kKvChunks) {
        hopper::tma_load_3d(base + C::kRaw + s * C::kRawBytes, j < kKvChunks ? &tm_k : &tm_v,
                            raw_full(s), 0, k0 + (j % kKvChunks) * kBlockQ, bkv);
      } else {
        const int n = (j - 2 * kKvChunks) / 2;
        hopper::tma_load_3d(base + C::kRaw + s * C::kRawBytes,
                            (j - 2 * kKvChunks) % 2 ? &tm_do : &tm_q, raw_full(s), 0,
                            step_q0(n), step_head(n));
      }
    };
    if (ptid == 0) {
      hopper::prefetch_map(&tm_q);
      hopper::prefetch_map(&tm_do);
      for (int j = 0; j < kStages && j < n_raw; ++j) load(j);
    }
    for (int j = 0; j < n_raw; ++j) {
      const int s = j % kStages;
      const float* raw = reinterpret_cast<const float*>(base_ptr + C::kRaw + s * C::kRawBytes);
      uint32_t arrive = 0;
      if (j < 2 * kKvChunks) {
        hopper::mbar_wait(raw_full(s), (j / kStages) & 1);
        fp32x3::split_tile<TK, D, kBlockQ>(raw, j < kKvChunks ? sK : sV,
                                           (j % kKvChunks) * kBlockQ, ptid, 128);
        if (j == 2 * kKvChunks - 1) arrive = kv_full;
      } else {
        const int n = (j - 2 * kKvChunks) / 2, ns = n % kStages;
        const bool is_do = (j - 2 * kKvChunks) % 2;
        if (!is_do) {
          hopper::mbar_wait(empty(ns), ((n / kStages) & 1) ^ 1);
          const int bh = step_head(n), q0 = step_q0(n);
          for (int r = ptid; r < kBlockQ; r += 128) {
            const bool in = q0 + r < q_len;
            const size_t i = (size_t)bh * q_len + q0 + r;
            sLse[ns * kBlockQ + r] = in ? lse[i] * kLog2e : 0.f;
            sDelta[ns * kBlockQ + r] = in ? delta[i] : 0.f;
          }
        }
        hopper::mbar_wait(raw_full(s), (j / kStages) & 1);
        fp32x3::split_tile<TQ, D, kBlockQ>(raw, is_do ? sdO(ns) : sQ(ns), 0, ptid, 128);
        if (is_do) arrive = full(ns);
      }
      // Every producer thread has read buffer s: TMA may refill it.
      hopper::named_bar_sync(3, 128);
      if (ptid == 0 && j + kStages < n_raw) load(j + kStages);
      if (arrive) {
        hopper::fence_async_shared();  // the parts, to the wgmma (async) proxy
        hopper::mbar_arrive(arrive);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    if constexpr (kConsumers == 2) hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    const int key_first = k0 + 64 * c;                  // this warpgroup's first key
    const int key0 = key_first + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    // This warpgroup's 64 keys of K and V, the A operands of S^T and dP^T.
    const hopper::Desc dk_a = TK::k_major(sK, 64 * c), dv_a = TK::k_major(sV, 64 * c);
    // Two consumers take turns issuing their products (named barriers 1
    // and 2), so one's exponentials and splits run while the other's
    // products use the tensor cores; consumer 0 goes first.
    auto my_turn = [&] {
      if constexpr (kConsumers == 2) hopper::named_bar_sync(1 + c, 256);
    };
    auto pass_turn = [&] {
      if constexpr (kConsumers == 2) hopper::named_bar_arrive(2 - c, 256);
    };
    if (c == 1) pass_turn();
    if (n_steps > 0) hopper::mbar_wait(kv_full, 0);
    for (int n = 0; n < n_steps; ++n) {
      const int s = n % kStages;
      const int q0 = (t_begin + (n_first + n) % per_head) * kBlockQ;
      hopper::mbar_wait(full(s), (n / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T as two groups, so P^T is formed
      // while dP^T is still on the tensor cores.
      float st[kBlockQ / 2], dpt[kBlockQ / 2];
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      my_turn();
      hopper::wgmma_fence();
      issue_scores<D>(st, dk_a, TQ::k_major(sQ(s), 0));
      issue_scores<D>(dpt, dv_a, TQ::k_major(sdO(s), 0));
      pass_turn();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(st);
      // P^T into st. Masked: steps with a query before one of the
      // warpgroup's keys, and the ragged last q step.
      const bool masked = (q0 + kBlockQ > q_len) || (causal && q0 < key_first + 63);
      const float* l2 = sLse + s * kBlockQ;
      const float* dl = sDelta + s * kBlockQ;
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tg + (e & 1);  // query in the step
          float x = st[4 * j + e] * scale_log2;
          if (masked) {
            const int key = key0 + 8 * (e >> 1);
            const int qi = q0 + col;
            if (qi >= q_len || (causal && qi < key)) x = kMaskValue;
          }
          st[4 * j + e] = hopper::exp2_fast(x - l2[col]);
        }
      }
      uint32_t f[3][kBlockQ / 16][4];
      fp32x3::split_fragments(st, f[0], f[1], f[2]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpt);
      // dV += P^T dO (dO read MN-major) runs while dS^T is formed.
      my_turn();
      issue_grad<D>(dv_acc, f, TQ::mn_major(sdO(s)));
      pass_turn();
#pragma unroll
      for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * tg + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl[col]);
        }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv_acc);
      // dK += dS^T Q (Q read MN-major).
      fp32x3::split_fragments(dpt, f[0], f[1], f[2]);
      my_turn();
      issue_grad<D>(dk_acc, f, TQ::mn_major(sQ(s)));
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));
    }

    // This block's sums: straight to dK/dV, or (to_slots) to its slot of
    // the scratch, [kBlockK][hd] from k0 on. Key rows past k_len are never
    // written; columns past hd neither (hd is even, so a pair is in or out).
    const size_t slot = (size_t)blockIdx.x * kBlockK * hd;
    float* const out_k = to_slots ? dk + slot - (size_t)k0 * hd : dk + (size_t)bkv * k_len * hd;
    float* const out_v = to_slots ? dv + slot - (size_t)k0 * hd : dv + (size_t)bkv * k_len * hd;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + 8 * i;
      if (key < k_len) {
        float* dk_row = out_k + (size_t)key * hd;
        float* dv_row = out_v + (size_t)key * hd;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = 8 * j + 2 * tg;
          if (col < hd) {
            *reinterpret_cast<float2*>(dk_row + col) =
                make_float2(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
            *reinterpret_cast<float2*>(dv_row + col) =
                make_float2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
          }
        }
      }
    }
  }
}

// dK and dV of one (key tile, kv head) per block as the sums of its
// parts' slots, added in order (bitwise repeatable): slot j of dK's sums
// is sums + j * kBlockK * hd, dV's follow all `blocks` of dK's.
template <int D>
__global__ void sum_parts_kernel(const float* __restrict__ sums, float* __restrict__ dk,
                                 float* __restrict__ dv, int k_len, int hd, const Plan<D> plan,
                                 int blocks) {
  constexpr int kBlockK = Cfg<D>::kBlockK;
  const int t = blockIdx.x / plan.n_kv_heads, bkv = blockIdx.x % plan.n_kv_heads;
  const int n_parts = plan.parts(t), k0 = t * kBlockK;
  const size_t slot = (size_t)kBlockK * hd;
  const float4* pk =
      reinterpret_cast<const float4*>(sums + (plan.first_block(t) + (size_t)bkv * n_parts) *
                                                 slot);
  const float4* pv = pk + (size_t)blocks * slot / 4;
  const size_t out = ((size_t)bkv * k_len + k0) * hd / 4;
  const int n4 = min(kBlockK, k_len - k0) * hd / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 a = pk[i], b = pv[i];
    for (int p = 1; p < n_parts; ++p) {
      const float4 x = pk[p * slot / 4 + i], y = pv[p * slot / 4 + i];
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      b.x += y.x, b.y += y.y, b.z += y.z, b.w += y.w;
    }
    reinterpret_cast<float4*>(dk)[out + i] = a;
    reinterpret_cast<float4*>(dv)[out + i] = b;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, void* sums, int batch,
                   int heads, int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                   int steps_per_block, int blocks, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_bwd_dkv_fp32_kernel<D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    if (C::kConsumers == 1) return cudaSuccess;  // no register hand-over
    return hopper::check_register_pool(kernel, C::kThreads,
                                       128 * kProducerRegs + 128 * C::kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  const Plan<D> plan{(q_len + C::kBlockQ - 1) / C::kBlockQ, heads / kv_heads, batch * kv_heads,
                     steps_per_block, causal};
  const int n_kt = (k_len + C::kBlockK - 1) / C::kBlockK;
  // The caller sized the scratch for `blocks`: it must be this plan's.
  long long planned = 0;
  for (int t = 0; t < n_kt; ++t) planned += (long long)plan.n_kv_heads * plan.parts(t);
  if (planned != blocks) return cudaErrorInvalidValue;
  const bool to_slots = planned > (long long)n_kt * plan.n_kv_heads;
  if (to_slots && sums == nullptr) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = hopper::make_map_3d_f32(&mq, q, batch * heads, q_len, hd, C::kBlockQ, D)) ||
      (err = hopper::make_map_3d_f32(&mdo, dout, batch * heads, q_len, hd, C::kBlockQ, D)) ||
      (err = hopper::make_map_3d_f32(&mk, k, batch * kv_heads, k_len, hd, C::kBlockQ, D)) ||
      (err = hopper::make_map_3d_f32(&mv, v, batch * kv_heads, k_len, hd, C::kBlockQ, D)))
    return err;
  float* const out_k = static_cast<float*>(to_slots ? sums : dk);
  float* const out_v =
      to_slots ? out_k + (size_t)blocks * C::kBlockK * hd : static_cast<float*>(dv);
  kernel<<<blocks, C::kThreads, C::kBytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta), out_k,
      out_v, heads, kv_heads, q_len, k_len, hd, scale, plan, to_slots);
  if ((err = cudaGetLastError()) != cudaSuccess || !to_slots) return err;
  sum_parts_kernel<D><<<n_kt * plan.n_kv_heads, 256, 0, stream>>>(
      static_cast<const float*>(sums), static_cast<float*>(dk), static_cast<float*>(dv), k_len,
      hd, plan, blocks);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: the launches' cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
// `steps_per_block` (Plan) cuts each key tile's steps into parts, and
// `blocks` is the plan's block count, which the caller computed to size
// `sums`: fp32 scratch of 2 * blocks * kBlockK * head_dim floats (kBlockK
// = 128 keys up to head dim 64, else 64) wherever a tile has more than one
// part (else unused). A `blocks` that is not the plan's is refused.
extern "C" int flash_bwd_dkv_fp32(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  void* sums, int batch, int heads, int kv_heads, int q_len,
                                  int k_len, int head_dim, float scale, int causal,
                                  int steps_per_block, int blocks, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim <= 0 || head_dim % 4 != 0 || head_dim > 128 || !(scale > 0.f) ||
      steps_per_block <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 32)
    return (int)launch<32>(q, k, v, dout, lse, delta, dk, dv, sums, batch, heads, kv_heads, q_len,
                           k_len, head_dim, scale, causal, steps_per_block, blocks, s);
  if (head_dim <= 64)
    return (int)launch<64>(q, k, v, dout, lse, delta, dk, dv, sums, batch, heads, kv_heads, q_len,
                           k_len, head_dim, scale, causal, steps_per_block, blocks, s);
  return (int)launch<128>(q, k, v, dout, lse, delta, dk, dv, sums, batch, heads, kv_heads, q_len,
                          k_len, head_dim, scale, causal, steps_per_block, blocks, s);
}
