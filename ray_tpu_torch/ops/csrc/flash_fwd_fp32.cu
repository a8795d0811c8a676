// Flash-attention forward for fp32 inputs on Hopper (sm_90a) tensor cores,
// bound through a plain C entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_forward_fp32_cuda).
//
// Replaces: ray_tpu/ops/attention.py:_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward) for fp32 q/k/v, scale > 0 and head
// dims up to 128 that are multiples of 4 (the "hopper_fp32" route). It
// computes the same function as flash_general.cu's general_fwd, to fp32
// accuracy:
//   O   = softmax(scale * Q K^T + mask) V      (fp32)
//   lse = m + log(max(l, 1e-30))               (fp32, natural log, per row)
// with an fp32 online softmax, native GQA (the kv row of q row bh is
// (bh / H) * KV + (bh % H) / (H / KV)), top-left causal masking
// (q_id >= k_id) with the k loop stopping at the diagonal, ragged lengths
// masked in-kernel, and l clamped at 1e-30.
//
// Layout at the boundary: q, o [b*H, q_len, hd]; k, v [b*KV, k_len, hd];
// lse [b*H, q_len]; all contiguous fp32, 16-byte aligned, hd a multiple of
// 4 up to 128 (the split reads a row as 16-byte groups and pads its parts'
// rows to a multiple of 8 columns, 16 bytes, for TMA). D = 32, 64 or 128 is
// hd rounded up; TMA zero-fills the columns past the parts' width, which
// are never stored.
//
// What bounds it on an H100. Both products in fp32: 4 * hd FLOPs a kept
// (q, k) pair. The SIMT general kernel does them as fp32 FMAs, bound at
// 67 TFLOP/s (0.0321 ms at [2, 8/2, 1024, 64] causal; it took 0.1723).
// Here each product is six bf16 wgmma products of a three-way split
// (flash_fp32.cuh), fp32-accurate, bound at 989 / 6 ~ 165 TFLOP/s: 0.0130
// ms at that shape, against ~0.003 ms of bytes, so bound by operations.
// Besides the tensor cores, the splits cost ALU work and bytes. Measured
// by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: this design takes
// 0.0327 ms there (40% of that bound; SDPA, TF32 off, 0.4056).
//
// This design:
//   - q, k and v are first split, each in one pass (fp32x3::split), into
//     three bf16 planes in a scratch the wrapper allocates: every key tile
//     is read by every q tile of its heads, so splitting it once beat
//     splitting TMA-loaded fp32 tiles in each block's shared memory in
//     trial runs (and one launch for the three passes ran slower);
//   - one block per 64-row q tile of one b*H row, the tiles with the most
//     keys first; three warpgroups: a producer (one thread issues TMA;
//     setmaxnreg drops it to 24 registers) and two consumers (240) that
//     take the tile's key tiles in turn, each keeping its own running max,
//     sum and output for all 64 rows, merged at the end through shared
//     memory. Under causal masking a 64-row tile's work grows with its
//     position: small tiles in two waves balance the SMs better than
//     128-row tiles with a consumer on each half (slower in trial runs);
//   - the producer loads Q's three parts once and each key tile's K and V
//     parts through their own 3-stage rings (TMA, mbarrier transactions),
//     so a K stage is refilled as soon as its S is done;
//   - S = Q K^T: 6 SS wgmma m64n{kBlockK}k16 per 16 columns (Q and K
//     K-major); O += P V: P split three ways in registers as A fragments
//     (the S accumulators of 16 keys are one fragment), V read MN-major
//     through the transpose flag: 6 RS wgmma m64n{D}k16 per 16 keys. No
//     transposed copies (which TF32 wgmma, K-major only, would need for V);
//   - per key tile each consumer issues S_t and then its previous P V, and
//     runs the softmax of S_t while P V is on the tensor cores; the two
//     consumers take turns issuing (named barriers);
//   - the online softmax keeps the raw running max and computes
//     exp2(s * scale * log2 e - m * scale * log2 e) as one FFMA and one
//     MUFU.EX2; lse is converted back to natural log on the way out; O is
//     scaled by 1 / l and stored from registers.
// Shared memory: Q's parts 384 * D bytes, a key tile's K or V parts
// 6 * D * kBlockK; kBlockK = 64 up to D = 64 (168 KB at D = 64) and 32 at
// D = 128 (192 KB). Registers: O (D / 2), S (kBlockK / 2) and P's three
// fragment sets (3 * kBlockK / 4) at once: 112 at D = 64, 104 at D = 128.

#include <math.h>

#include "flash_common.cuh"
#include "flash_fp32.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;

constexpr int kBlockQ = 64;
constexpr int kStages = 3;     // the K and V rings
constexpr int kConsumers = 2;  // warpgroups, each on every other key tile of the 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int kBlockK = D == 128 ? 32 : 64;
  using TQ = hopper::Tile<D, kBlockQ>;
  using TK = hopper::Tile<D, kBlockK>;
  // Shared memory: Q parts | K parts [kStages] | V parts [kStages] |
  // mbarriers; every piece 1024-byte aligned. After the last product the K
  // ring holds consumer 1's sums for the merge.
  static constexpr int kK = 3 * TQ::kBytes;
  static constexpr int kV = kK + kStages * 3 * TK::kBytes;
  static constexpr int kBars = kV + kStages * 3 * TK::kBytes;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
  static_assert(kBytes <= 232448, "shared memory");
  static_assert((D / 2 + 4) * 128 * 4 <= kStages * 3 * TK::kBytes, "the merge's buffer");
};

// One tile of the online softmax, in base 2 (as flash_fwd.cu): sc holds
// this warpgroup's raw scores for 64 rows x kBlockK keys (this thread:
// rows row0 and row0 + 8) and leaves as probabilities; m_i is the running
// max in raw units, l_i this thread's share of the row sums, corr what the
// output so far must be multiplied by.
template <int kBlockK>
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
    float mx[kBlockK / 8];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) mx[j] = fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
#pragma unroll
    for (int w = kBlockK / 16; w >= 1; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) mx[j] = fmaxf(mx[j], mx[j + w]);
    float m = fmaxf(mx[0], m_i[i]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    corr[i] = hopper::exp2_fast((m_i[i] - m) * scale_log2);
    m_i[i] = m;
    // A row with every key so far masked (a consumer's tiles can all lie
    // past the diagonal) keeps l = 0: its masked scores give exp2 of the
    // mask value, 0, where fmaf(mask, s, -mask * s) would give exp2 of the
    // rounding of a 1e37, 0 or inf.
    m_scaled[i] = m == kMaskValue ? 0.f : m * scale_log2;
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

// Issues S = Q K^T for this warpgroup's 64 rows x kBlockK keys as one
// wgmma group: six split products per 16 columns. dq and dk describe the
// first part of Q (at this warpgroup's rows) and of the K stage; the other
// parts follow at TQ::kBytes and TK::kBytes.
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<D>::kBlockK / 2], hopper::Desc dq,
                                        hopper::Desc dk) {
  using TQ = typename Cfg<D>::TQ;
  using TK = typename Cfg<D>::TK;
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_ss<Cfg<D>::kBlockK, true, 0>(
          sc, hopper::desc_at(dq, fp32x3::term_a(t) * TQ::kBytes + TQ::k_off(k)),
          hopper::desc_at(dk, fp32x3::term_b(t) * TK::kBytes + TK::k_off(k)), k + t > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(sc);
}

// Issues O += P V as one wgmma group: P's three parts from registers, V's
// three parts MN-major.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pf)[3][Cfg<D>::kBlockK / 16][4],
                                         hopper::Desc dv) {
  using TK = typename Cfg<D>::TK;
  hopper::fence_regs(acc);
#pragma unroll
  for (int s = 0; s < 3; ++s) hopper::fence_regs(pf[s]);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < Cfg<D>::kBlockK / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_rs<D, true, 1>(
          acc, pf[fp32x3::term_a(t)][k],
          hopper::desc_at(dv, fp32x3::term_b(t) * TK::kBytes + TK::mn_off(k)), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
#pragma unroll
  for (int s = 0; s < 3; ++s) hopper::fence_regs(pf[s]);
}

template <int D>
__device__ __forceinline__ void split_p(uint32_t (&pf)[3][Cfg<D>::kBlockK / 16][4],
                                        const float (&sc)[Cfg<D>::kBlockK / 2]) {
  fp32x3::split_fragments(sc, pf[0], pf[1], pf[2]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_fp32_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                      float* __restrict__ lse, int H, int KV, int q_len, int k_len, int hd,
                      float scale_log2, int causal, int n_heads, int n_kv_heads) {
  using C = Cfg<D>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  constexpr int kBlockK = C::kBlockK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + C::kK + s * 3 * TK::kBytes; };
  auto sV = [&](int s) { return base + C::kV + s * 3 * TK::kBytes; };
  // mbarriers: full_k, full_v, empty_k, empty_v [kStages] each, then
  // full_q.
  const uint32_t bars = base + C::kBars;
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (kStages + s); };
  auto empty_k = [&](int s) { return bars + 8 * (2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8 * (3 * kStages + s); };
  const uint32_t full_q = bars + 8 * 4 * kStages;

  // The q tile: tiles with the most keys first (under causal masking the
  // last ones), then the heads of each tile.
  const int n_qt = (q_len + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x % n_heads;
  const int q0 = (n_qt - 1 - blockIdx.x / n_heads) * kBlockQ;
  const int k_end = causal ? min(k_len, q0 + kBlockQ) : k_len;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_k(s), 4);  // one arrival per warp of the tile's consumer
      hopper::mbar_init(empty_v(s), 4);
    }
    hopper::mbar_init(full_q, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: one thread loads the parts by TMA ------------------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      const int kv_row = (bh / H) * KV + (bh % H) / (H / KV);
      hopper::prefetch_map(&tm_q);
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      hopper::mbar_arrive_expect_tx(full_q, 3 * TQ::kBytes);
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int b = 0; b < TQ::kBoxes; ++b)
          hopper::tma_load_3d(sQ + p * TQ::kBytes + b * TQ::kBoxBytes, &tm_q, full_q,
                              b * TQ::kCols, q0, p * n_heads + bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = ((t / kStages) & 1) ^ 1;
        hopper::mbar_wait(empty_k(s), parity);
        hopper::mbar_arrive_expect_tx(full_k(s), 3 * TK::kBytes);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sK(s) + p * TK::kBytes + b * TK::kBoxBytes, &tm_k, full_k(s),
                                b * TK::kCols, t * kBlockK, p * n_kv_heads + kv_row);
        hopper::mbar_wait(empty_v(s), parity);
        hopper::mbar_arrive_expect_tx(full_v(s), 3 * TK::kBytes);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sV(s) + p * TK::kBytes + b * TK::kBoxBytes, &tm_v, full_v(s),
                                b * TK::kCols, t * kBlockK, p * n_kv_heads + kv_row);
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
    const hopper::Desc dq = TQ::k_major(sQ, 0);
    // The two consumers take turns issuing their products (named barriers
    // 1 and 2), so one's softmax runs while the other's products use the
    // tensor cores; consumer 0 goes first. Both take n0 + 1 turns (n0: the
    // tiles of consumer 0, which has the odd one out), consumer 1 idling
    // through the turns it has no tile for.
    auto my_turn = [&] { hopper::named_bar_sync(1 + c, 256); };
    auto pass_turn = [&] { hopper::named_bar_arrive(2 - c, 256); };
    if (c == 1) pass_turn();
    const int n_mine = n_tiles > c ? (n_tiles - c + 1) / 2 : 0;  // tiles c, c + 2, ...
    const int turns = (n_tiles + 1) / 2 + 1;

    const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    auto masked = [&](int k0) {
      return (k0 + kBlockK > k_len) || (causal && k0 + kBlockK - 1 > q0);
    };
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[kBlockK / 2], corr[2];
    uint32_t pf[3][kBlockK / 16][4];

    if (n_mine > 0) {
      const int t0 = c;
      hopper::mbar_wait(full_q, 0);
      hopper::mbar_wait(full_k(t0 % kStages), (t0 / kStages) & 1);
      my_turn();
      issue_s<D>(sc, dq, TK::k_major(sK(t0 % kStages), 0));
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(empty_k(t0 % kStages));
      online_softmax<kBlockK>(sc, m_i, l_i, corr, masked(t0 * kBlockK), row0, t0 * kBlockK, tg,
                              k_len, causal, scale_log2);
      split_p<D>(pf, sc);
      for (int i = 1; i < n_mine; ++i) {
        const int t = 2 * i + c, tp = t - 2;
        const int s = t % kStages, sp = tp % kStages;
        hopper::mbar_wait(full_k(s), (t / kStages) & 1);
        hopper::mbar_wait(full_v(sp), (tp / kStages) & 1);
        my_turn();
        issue_s<D>(sc, dq, TK::k_major(sK(s), 0));
        rescale(acc, corr);  // while S runs on the tensor cores
        issue_pv<D>(acc, pf, TK::mn_major(sV(sp)));
        pass_turn();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        release(empty_k(s));
        online_softmax<kBlockK>(sc, m_i, l_i, corr, masked(t * kBlockK), row0, t * kBlockK, tg,
                                k_len, causal, scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_v(sp));
        split_p<D>(pf, sc);
      }
      const int tp = 2 * (n_mine - 1) + c, sp = tp % kStages;
      hopper::mbar_wait(full_v(sp), (tp / kStages) & 1);
      rescale(acc, corr);
      my_turn();
      issue_pv<D>(acc, pf, TK::mn_major(sV(sp)));
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(empty_v(sp));
    }
    for (int i = n_mine + (n_mine > 0); i < turns; ++i) {
      my_turn();
      pass_turn();
    }

    // Merge: consumer 1 leaves its sums (acc, m, l) in the K ring, free
    // once both consumers' products are done; consumer 0 adds them in with
    // the usual softmax correction (each fragment slot is the same row and
    // column in both), then stores O scaled by 1 / l straight from the
    // accumulators: rows past q_len and columns past hd (hd is even, so a
    // pair is in or out) are not written.
    float* const merge = reinterpret_cast<float*>(base_ptr + C::kK);
    hopper::named_bar_sync(3, 256);
    if (c == 1) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) merge[j * 128 + tid] = acc[j];
      *reinterpret_cast<float4*>(merge + (D / 2) * 128 + 4 * tid) =
          make_float4(m_i[0], m_i[1], l_i[0], l_i[1]);
    }
    hopper::named_bar_sync(3, 256);
    if (c == 0) {
      const float4 ml = *reinterpret_cast<const float4*>(merge + (D / 2) * 128 + 4 * tid);
      const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
      float f0[2], f1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m = fmaxf(m_i[i], m1[i]);
        f0[i] = hopper::exp2_fast((m_i[i] - m) * scale_log2);
        f1[i] = hopper::exp2_fast((m1[i] - m) * scale_log2);
        l_i[i] = l_i[i] * f0[i] + l1[i] * f1[i];
        m_i[i] = m;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j)
        acc[j] = acc[j] * f0[(j >> 1) & 1] + merge[j * 128 + tid] * f1[(j >> 1) & 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
        l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
        const int row = row0 + 8 * i;
        if (row < q_len) {
          const float l = fmaxf(l_i[i], 1e-30f), inv_l = 1.f / l;
          float* o_row = o + ((size_t)bh * q_len + row) * hd;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int col = 8 * j + 2 * tg;
            if (col < hd)
              *reinterpret_cast<float2*>(o_row + col) =
                  make_float2(acc[4 * j + 2 * i] * inv_l, acc[4 * j + 2 * i + 1] * inv_l);
          }
          if (tg == 0)
            lse[(size_t)bh * q_len + row] = (m_i[i] * scale_log2 + __log2f(l)) * kLn2;
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   uint16_t* parts, int batch, int heads, int kv_heads, int q_len, int k_len,
                   int hd, float scale, int causal, cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_fwd_fp32_kernel<D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    return hopper::check_register_pool(kernel, kThreads,
                                       128 * kProducerRegs + 128 * kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  // The parts of q, then k, then v (fp32x3::split).
  const long long q_rows = (long long)batch * heads * q_len;
  const long long kv_rows = (long long)batch * kv_heads * k_len;
  const int hdp = fp32x3::parts_head_dim(hd);
  uint16_t* const q_parts = parts;
  uint16_t* const k_parts = q_parts + 3 * q_rows * hdp;
  uint16_t* const v_parts = k_parts + 3 * kv_rows * hdp;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = fp32x3::split(q, q_parts, q_rows, hd, stream)) ||
      (err = fp32x3::split(k, k_parts, kv_rows, hd, stream)) ||
      (err = fp32x3::split(v, v_parts, kv_rows, hd, stream)) ||
      (err = fp32x3::make_parts_map(&mq, q_parts, batch * heads, q_len, hd, kBlockQ,
                                    C::TQ::kCols)) ||
      (err = fp32x3::make_parts_map(&mk, k_parts, batch * kv_heads, k_len, hd, C::kBlockK,
                                    C::TK::kCols)) ||
      (err = fp32x3::make_parts_map(&mv, v_parts, batch * kv_heads, k_len, hd, C::kBlockK,
                                    C::TK::kCols)))
    return err;
  const long long blocks = (long long)((q_len + kBlockQ - 1) / kBlockQ) * batch * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, C::kBytes, stream>>>(
      mq, mk, mv, static_cast<float*>(o), static_cast<float*>(lse), heads, kv_heads, q_len,
      k_len, hd, scale * kLog2e, causal, batch * heads, batch * kv_heads);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: the launches' cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence). `parts` is
// bf16 scratch of 3 * hdp * (batch * heads * q_len + 2 * batch * kv_heads *
// k_len) elements, hdp = head_dim rounded up to 8. `flag` is unused (the
// other entry points' dtype flag; the inputs are fp32).
extern "C" int flash_fwd_fp32(const void* q, const void* k, const void* v, void* o, void* lse,
                              void* parts, int batch, int heads, int kv_heads, int q_len,
                              int k_len, int head_dim, float scale, int causal, int flag,
                              void* stream) {
  (void)flag;
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim <= 0 || head_dim % 4 != 0 || head_dim > 128 || !(scale > 0.f) ||
      parts == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint16_t* const p = static_cast<uint16_t*>(parts);
  if (head_dim <= 32)
    return (int)launch<32>(q, k, v, o, lse, p, batch, heads, kv_heads, q_len, k_len, head_dim,
                           scale, causal, s);
  if (head_dim <= 64)
    return (int)launch<64>(q, k, v, o, lse, p, batch, heads, kv_heads, q_len, k_len, head_dim,
                           scale, causal, s);
  return (int)launch<128>(q, k, v, o, lse, p, batch, heads, kv_heads, q_len, k_len, head_dim,
                          scale, causal, s);
}
