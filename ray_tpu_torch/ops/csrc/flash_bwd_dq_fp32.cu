// Flash-attention backward, dQ and delta, for fp32 inputs on Hopper
// (sm_90a) tensor cores, bound through a plain C entry point (loaded with
// ctypes by ray_tpu_torch/ops/attention.py:flash_bwd_dq_fp32_cuda). dK and
// dV are computed by flash_bwd_dkv_fp32.cu, which reads the delta written
// here.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel, and the
// delta = rowsum(dO * O) that _flash_backward computes in front of it, for
// fp32 q/k/v, scale > 0 and head dims up to 128 that are multiples of 4
// (the "hopper_fp32" route). It rebuilds the probabilities from the
// forward's fp32 (natural-log) logsumexp:
//   delta = rowsum(dO * O)                     (fp32, written out for dK/dV)
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K
// to fp32 accuracy, with the conventions of flash_bwd_dkv_fp32.cu: native
// GQA by index (the kv row of q row bh is (bh / H) * KV + (bh % H) /
// (H / KV); K and V are never repeated), top-left causal masking
// (q_id >= k_id) with the key loop stopping at the diagonal, ragged
// lengths masked in-kernel, the finite mask value. P and dS stay fp32.
//
// Layout at the boundary: q, o, do, dq [b*H, q_len, hd]; k, v
// [b*KV, k_len, hd]; lse, delta [b*H, q_len]; all contiguous fp32,
// 16-byte aligned, hd a multiple of 4 up to 128 (D = 32, 64 or 128 is hd
// rounded up; the columns past hd are zeros in every split tile, and are
// never stored).
//
// What bounds it on an H100. Three products in fp32 (S, dP, dQ): 6 * hd
// FLOPs a kept (q, k) pair. The SIMT general kernel (flash_general.cu),
// which this route ran before, does them as fp32 FMAs, bound at
// 67 TFLOP/s (0.0481 ms at [2, 8/2, 1024, 64] causal; it took 0.2127, and
// 1.8040 at [1, 16/16, 2048, 128], more than SDPA's whole fp32 backward).
// Here each product is six bf16 wgmma products of a three-way split
// (flash_fp32.cuh), fp32-accurate, bound at 989 / 6 ~ 165 TFLOP/s: 0.0195
// ms at that shape, against ~0.006 ms of bytes, so bound by operations.
//
// This design, in the shape of flash_fwd_fp32.cu (dQ streams K and V tiles
// past a resident q tile, as the forward does):
//   - k and v are first split, each in one pass (fp32x3::split), into three
//     bf16 planes in a scratch the wrapper allocates: every key tile is read
//     by every q tile of its heads, so its parts are made once and loaded by
//     TMA like any 16-bit operand. A q tile is one block's alone, so its Q
//     and dO are split in the block: both consumers load the fp32 rows,
//     split them into the swizzled layout wgmma reads, and add delta's
//     shares from dO and O as they go (one read of dO for both), before
//     the first product. Splitting q and dO in passes too, as the forward
//     splits q (two more launches, and each part written out and read
//     back), ran slower at all three fp32 shapes of chip_smoke.py in a
//     trial run, most at the small ones;
//   - one block per 64-row q tile of one b*H row, the tiles with the most
//     keys first (under causal masking the last ones): at fp32 GQA [2, 8/2,
//     1024, 64] 256 blocks, about two waves on 132 SMs, where pairs of
//     128-row tiles (flash_bwd.cu) would give 64; three warpgroups: a
//     producer (one thread issues TMA; setmaxnreg drops it to 24
//     registers) and two consumers (240) that take the tile's key tiles in
//     turn, each keeping its own dQ sums for all 64 rows;
//   - the producer loads each key tile's K and V parts through their own
//     rings (TMA, mbarrier transactions), starting while the consumers
//     split Q and dO: V is free once dP is done, K only once the dQ product
//     has read it, so K gets the deeper ring;
//   - per key tile each consumer issues S = Q K^T and dP = dO V^T (6 SS
//     wgmma m64n{kBlockK}k16 per 16 columns each, all K-major) and then the
//     dQ product of its previous tile; P = exp2(s * scale * log2 e - lse *
//     log2 e) (one FFMA and one MUFU.EX2; only tiles crossing the diagonal
//     or the ragged key edge pay for the mask) is formed while dP and that
//     product run, and dS = P (dP - delta) while the product runs; dS is
//     split three ways into A fragments (the accumulators of 16 keys are
//     one fragment) once the product has freed the last ones: dQ += dS K
//     is 6 RS wgmma m64n{D}k16 per 16 keys with K read MN-major through
//     the transpose flag: no transposed copy of K (TF32 wgmma, K-major
//     only, would need one). The two consumers take turns issuing (named
//     barriers), so one's exponentials and splits run while the other's
//     products use the tensor cores;
//   - dQ stays in fp32 registers through the whole loop. At the end
//     consumer 1 leaves its sums in the K ring and consumer 0 adds them to
//     its own (always in that order), scales once and stores from
//     registers. No atomics: dQ is bitwise repeatable.
// Shared memory: Q's and dO's parts 768 * D bytes, a key tile's K or V
// parts 6 * D * kBlockK; kBlockK = 64 and 4 K / 3 V stages up to D = 64
// (216 KB at D = 64), 32 keys and 3 / 2 stages at D = 128 (216 KB).
// Registers: dQ (D / 2), S and dP (kBlockK / 2 each) and dS's three
// fragment sets (3 * kBlockK / 4) at once: 144 at D = 64, 120 at D = 128.

#include <math.h>

#include "flash_common.cuh"
#include "flash_fp32.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;

constexpr int kBlockQ = 64;
constexpr int kConsumers = 2;  // warpgroups, each on every other key tile of the 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBlockK = D == 128 ? 32 : 64;
  static constexpr int kStagesK = D == 128 ? 3 : 4;
  static constexpr int kStagesV = D == 128 ? 2 : 3;
  using TQ = hopper::Tile<D, kBlockQ>;
  using TK = hopper::Tile<D, kBlockK>;
  // Shared memory: Q parts | dO parts | K parts [kStagesK] | V parts
  // [kStagesV] | mbarriers | delta [kBlockQ]; the tiles 1024-byte aligned.
  // After the last product the K ring holds consumer 1's sums for the
  // merge.
  static constexpr int kdO = 3 * TQ::kBytes;
  static constexpr int kK = 6 * TQ::kBytes;
  static constexpr int kV = kK + kStagesK * 3 * TK::kBytes;
  static constexpr int kBars = kV + kStagesV * 3 * TK::kBytes;
  static constexpr int kDelta = kBars + 128;
  static constexpr int kBytes = kDelta + 4 * kBlockQ + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "shared memory");
  static_assert(8 * 2 * (kStagesK + kStagesV) <= 128, "mbarriers");
  static_assert((D / 2) * 128 * 4 <= kStagesK * 3 * TK::kBytes, "the merge's buffer");
};

// Issues S = Q K^T and dP = dO V^T for this warpgroup's 64 rows x kBlockK
// keys as two wgmma groups, S first: six split products per 16 columns
// each. dq, ddo, dk and dv describe the first part of each tile; the other
// parts follow at TQ::kBytes and TK::kBytes.
template <int D>
__device__ __forceinline__ void issue_s_dp(float (&sc)[Cfg<D>::kBlockK / 2],
                                           float (&dp)[Cfg<D>::kBlockK / 2], hopper::Desc dq,
                                           hopper::Desc ddo, hopper::Desc dk, hopper::Desc dv) {
  using TQ = typename Cfg<D>::TQ;
  using TK = typename Cfg<D>::TK;
  hopper::fence_regs(sc);
  hopper::fence_regs(dp);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_ss<Cfg<D>::kBlockK, true, 0>(
          sc, hopper::desc_at(dq, fp32x3::term_a(t) * TQ::kBytes + TQ::k_off(k)),
          hopper::desc_at(dk, fp32x3::term_b(t) * TK::kBytes + TK::k_off(k)), k + t > 0);
  hopper::wgmma_commit();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_ss<Cfg<D>::kBlockK, true, 0>(
          dp, hopper::desc_at(ddo, fp32x3::term_a(t) * TQ::kBytes + TQ::k_off(k)),
          hopper::desc_at(dv, fp32x3::term_b(t) * TK::kBytes + TK::k_off(k)), k + t > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(sc);
  hopper::fence_regs(dp);
}

// Issues dQ += dS K as one wgmma group: dS's three parts from registers,
// K's three parts MN-major.
template <int D>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2],
                                         uint32_t (&df)[3][Cfg<D>::kBlockK / 16][4],
                                         hopper::Desc dk_t) {
  using TK = typename Cfg<D>::TK;
  hopper::fence_regs(acc);
#pragma unroll
  for (int s = 0; s < 3; ++s) hopper::fence_regs(df[s]);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < Cfg<D>::kBlockK / 16; ++k)
#pragma unroll
    for (int t = 0; t < fp32x3::kTerms; ++t)
      hopper::wgmma_rs<D, true, 1>(
          acc, df[fp32x3::term_a(t)][k],
          hopper::desc_at(dk_t, fp32x3::term_b(t) * TK::kBytes + TK::mn_off(k)), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
#pragma unroll
  for (int s = 0; s < 3; ++s) hopper::fence_regs(df[s]);
}

// P in place of S: exp2(s * scale_log2 - lse2) for this thread's rows row0
// and row0 + 8 and the keys of the tile at k0; masked entries get 0.
template <int kBlockK>
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
template <int N>
__device__ __forceinline__ void grad_scores(float (&dp)[N], const float (&p)[N],
                                            const float (&dl)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) dp[i] = p[i] * (dp[i] - dl[(i >> 1) & 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_fp32_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ q,
                         const float* __restrict__ o, const float* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         float* __restrict__ dq, int H, int KV, int q_len, int k_len, int hd,
                         float scale, int causal, int n_heads, int n_kv_heads) {
  using C = Cfg<D>;
  using TQ = typename C::TQ;
  using TK = typename C::TK;
  constexpr int kBlockK = C::kBlockK, kStagesK = C::kStagesK, kStagesV = C::kStagesV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t sQ = base, sdO = base + C::kdO;
  auto sK = [&](int t) { return base + C::kK + (t % kStagesK) * 3 * TK::kBytes; };
  auto sV = [&](int t) { return base + C::kV + (t % kStagesV) * 3 * TK::kBytes; };
  // mbarriers: full_k, empty_k [kStagesK], full_v, empty_v [kStagesV].
  // Key tile t is in K stage t % kStagesK and V stage t % kStagesV; the
  // phase parities follow from t.
  const uint32_t bars = base + C::kBars;
  auto full_k = [&](int t) { return bars + 8 * (t % kStagesK); };
  auto empty_k = [&](int t) { return bars + 8 * (kStagesK + t % kStagesK); };
  auto full_v = [&](int t) { return bars + 8 * (2 * kStagesK + t % kStagesV); };
  auto empty_v = [&](int t) { return bars + 8 * (2 * kStagesK + kStagesV + t % kStagesV); };
  auto par_k = [](int t) { return (uint32_t)(t / kStagesK) & 1; };
  auto par_v = [](int t) { return (uint32_t)(t / kStagesV) & 1; };

  // The q tile: tiles with the most keys first (under causal masking the
  // last ones), then the heads of each tile.
  const int n_qt = (q_len + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x % n_heads;
  const int q0 = (n_qt - 1 - blockIdx.x / n_heads) * kBlockQ;
  const int k_end = causal ? min(k_len, q0 + kBlockQ) : k_len;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesK; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(empty_k(s), 4);  // one arrival per warp of the tile's consumer
    }
    for (int s = 0; s < kStagesV; ++s) {
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_v(s), 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: one thread loads K's and V's parts by TMA ---------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      const int kv_row = (bh / H) * KV + (bh % H) / (H / KV);
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      for (int t = 0; t < n_tiles; ++t) {
        hopper::mbar_wait(empty_k(t), par_k(t) ^ 1);
        hopper::mbar_arrive_expect_tx(full_k(t), 3 * TK::kBytes);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sK(t) + p * TK::kBytes + b * TK::kBoxBytes, &tm_k, full_k(t),
                                b * TK::kCols, t * kBlockK, p * n_kv_heads + kv_row);
        hopper::mbar_wait(empty_v(t), par_v(t) ^ 1);
        hopper::mbar_arrive_expect_tx(full_v(t), 3 * TK::kBytes);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int b = 0; b < TK::kBoxes; ++b)
            hopper::tma_load_3d(sV(t) + p * TK::kBytes + b * TK::kBoxBytes, &tm_v, full_v(t),
                                b * TK::kCols, t * kBlockK, p * n_kv_heads + kv_row);
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    const hopper::Desc dq_a = TQ::k_major(sQ, 0), ddo_a = TQ::k_major(sdO, 0);

    // Q's and dO's parts, split here from fp32 by both consumers (each q
    // tile is one block's, so nothing is split twice), and delta =
    // rowsum(dO * O) of the 64 rows, written out for the dK/dV kernel.
    // A row's D / 4 groups of four columns are consecutive lanes of one
    // warp, which add their shares of delta by shuffles; rows past q_len
    // and columns past hd are zeros.
    float* const s_delta = reinterpret_cast<float*>(base_ptr + C::kDelta);
    {
      constexpr int kGroups = D / 4;
#pragma unroll
      for (int it = 0; it < kBlockQ * kGroups / 256; ++it) {
        const int i = it * 256 + (int)threadIdx.x;
        const int r = i / kGroups, col = (i % kGroups) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x, z = x;
        if (q0 + r < q_len && col < hd) {
          const size_t off = ((size_t)bh * q_len + q0 + r) * hd + col;
          x = *reinterpret_cast<const float4*>(q + off);
          y = *reinterpret_cast<const float4*>(dout + off);
          z = *reinterpret_cast<const float4*>(o + off);
        }
        float sum = fmaf(y.w, z.w, fmaf(y.z, z.z, fmaf(y.y, z.y, y.x * z.x)));
#pragma unroll
        for (int m = kGroups / 2; m >= 1; m /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, m);
        if (col == 0) s_delta[r] = sum;
        fp32x3::store_split<TQ>(sQ, r, col, x);
        fp32x3::store_split<TQ>(sdO, r, col, y);
      }
      hopper::fence_async_shared();  // the parts, to the wgmma (async) proxy
      hopper::named_bar_sync(3, 256);
      if (threadIdx.x < kBlockQ && q0 + (int)threadIdx.x < q_len)
        delta[(size_t)bh * q_len + q0 + threadIdx.x] = s_delta[threadIdx.x];
    }

    // The two consumers take turns issuing their products (named barriers
    // 1 and 2), consumer 0 first; both take n0 + 1 turns (n0: the tiles of
    // consumer 0, which has the odd one out), consumer 1 idling through
    // the turns it has no tile for.
    auto my_turn = [&] { hopper::named_bar_sync(1 + c, 256); };
    auto pass_turn = [&] { hopper::named_bar_arrive(2 - c, 256); };
    if (c == 1) pass_turn();
    const int n_mine = n_tiles > c ? (n_tiles - c + 1) / 2 : 0;  // tiles c, c + 2, ...
    const int turns = (n_tiles + 1) / 2 + 1;

    const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    auto masked = [&](int k0) {
      return (k0 + kBlockK > k_len) || (causal && k0 + kBlockK - 1 > q0);
    };
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = row0 + 8 * i < q_len;
      lse2[i] = in ? lse[(size_t)bh * q_len + row0 + 8 * i] * kLog2e : 0.f;
      dl[i] = s_delta[16 * warp + g + 8 * i];
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBlockK / 2], dp[kBlockK / 2];
    uint32_t df[3][kBlockK / 16][4];

    if (n_mine > 0) {
      const int t0 = c;
      hopper::mbar_wait(full_k(t0), par_k(t0));
      hopper::mbar_wait(full_v(t0), par_v(t0));
      my_turn();
      issue_s_dp<D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(t0), 0), TK::k_major(sV(t0), 0));
      pass_turn();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      probs<kBlockK>(sc, lse2, masked(t0 * kBlockK), row0, t0 * kBlockK, tg, k_len, causal,
                     scale_log2);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      release(empty_v(t0));
      grad_scores(dp, sc, dl);
      fp32x3::split_fragments(dp, df[0], df[1], df[2]);
      for (int i = 1; i < n_mine; ++i) {
        const int t = 2 * i + c, tp = t - 2;
        hopper::mbar_wait(full_k(t), par_k(t));
        hopper::mbar_wait(full_v(t), par_v(t));
        my_turn();
        issue_s_dp<D>(sc, dp, dq_a, ddo_a, TK::k_major(sK(t), 0), TK::k_major(sV(t), 0));
        issue_dq<D>(acc, df, TK::mn_major(sK(tp)));
        pass_turn();
        hopper::wgmma_wait<2>();
        hopper::fence_regs(sc);
        probs<kBlockK>(sc, lse2, masked(t * kBlockK), row0, t * kBlockK, tg, k_len, causal,
                       scale_log2);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(dp);
        release(empty_v(t));
        grad_scores(dp, sc, dl);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(empty_k(tp));
        fp32x3::split_fragments(dp, df[0], df[1], df[2]);
      }
      const int tp = 2 * (n_mine - 1) + c;
      my_turn();
      issue_dq<D>(acc, df, TK::mn_major(sK(tp)));
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(empty_k(tp));
    }
    for (int i = n_mine + (n_mine > 0); i < turns; ++i) {
      my_turn();
      pass_turn();
    }

    // Merge: consumer 1 leaves its sums in the K ring, free once both
    // consumers' products are done (every tile loaded was waited for);
    // consumer 0 adds them to its own (each fragment slot is the same row
    // and column in both), then stores dQ scaled once straight from the
    // accumulators: rows past q_len and columns past hd (hd is even, so a
    // pair is in or out) are not written.
    float* const merge = reinterpret_cast<float*>(base_ptr + C::kK);
    hopper::named_bar_sync(3, 256);
    if (c == 1) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) merge[j * 128 + tid] = acc[j];
    }
    hopper::named_bar_sync(3, 256);
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] += merge[j * 128 + tid];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < q_len) {
          float* dq_row = dq + ((size_t)bh * q_len + row) * hd;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int col = 8 * j + 2 * tg;
            if (col < hd)
              *reinterpret_cast<float2*>(dq_row + col) =
                  make_float2(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
          }
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* delta, uint16_t* parts, int batch, int heads,
                   int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = flash_bwd_dq_fp32_kernel<D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (err != cudaSuccess) return err;
    return hopper::check_register_pool(kernel, kThreads,
                                       128 * kProducerRegs + 128 * kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  // The parts of k, then v (fp32x3::split).
  const long long kv_rows = (long long)batch * kv_heads * k_len;
  uint16_t* const k_parts = parts;
  uint16_t* const v_parts = k_parts + 3 * kv_rows * fp32x3::parts_head_dim(hd);
  CUtensorMap mk, mv;
  cudaError_t err;
  if ((err = fp32x3::split(k, k_parts, kv_rows, hd, stream)) ||
      (err = fp32x3::split(v, v_parts, kv_rows, hd, stream)) ||
      (err = fp32x3::make_parts_map(&mk, k_parts, batch * kv_heads, k_len, hd, C::kBlockK,
                                    C::TK::kCols)) ||
      (err = fp32x3::make_parts_map(&mv, v_parts, batch * kv_heads, k_len, hd, C::kBlockK,
                                    C::TK::kCols)))
    return err;
  const long long blocks = (long long)((q_len + kBlockQ - 1) / kBlockQ) * batch * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, C::kBytes, stream>>>(
      mk, mv, static_cast<const float*>(q), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<float*>(dq), heads, kv_heads, q_len, k_len, hd, scale, causal, batch * heads,
      batch * kv_heads);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: the launches' cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence). `parts` is
// bf16 scratch of 6 * hdp * batch * kv_heads * k_len elements (the parts
// of k and v), hdp = head_dim rounded up to 8. `flag` is unused (the
// other entry points' dtype flag; the inputs are fp32).
extern "C" int flash_bwd_dq_fp32(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* dq, void* delta,
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
    return (int)launch<32>(q, k, v, o, dout, lse, dq, delta, p, batch, heads, kv_heads, q_len,
                           k_len, head_dim, scale, causal, s);
  if (head_dim <= 64)
    return (int)launch<64>(q, k, v, o, dout, lse, dq, delta, p, batch, heads, kv_heads, q_len,
                           k_len, head_dim, scale, causal, s);
  return (int)launch<128>(q, k, v, o, dout, lse, dq, delta, p, batch, heads, kv_heads, q_len,
                          k_len, head_dim, scale, causal, s);
}
