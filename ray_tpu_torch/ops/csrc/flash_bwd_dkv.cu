// Flash-attention backward, dK and dV, for Hopper (sm_90a), bound through
// a plain C entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_bwd_dkv_cuda).
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel. It rebuilds
// the probabilities from the forward's fp32 (natural-log) logsumexp:
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (fp32,
//        written by the dQ kernel, flash_bwd.cu, which runs first)
//   dV = P^T dO,  dK = scale * dS^T Q
// with the forward's conventions: native GQA by index (K/V never
// repeated; dK and dV summed over each kv head's group of q heads),
// top-left causal masking (q_id >= k_id), ragged q_len/k_len masked
// in-kernel, and the finite mask value. P and dS are rounded to the input
// dtype as the A operands of their products.
//
// Layout at the boundary: q, do [b*H, q_len, hd]; k, v, dk, dv
// [b*KV, k_len, hd]; lse, delta fp32 [b*H, q_len]; all contiguous, bf16 or
// fp16, hd a multiple of 8 up to 128 (D = 32, 64 or 128 is hd rounded up;
// the columns past hd are zero-filled by TMA and never stored: the column
// pairs the stores write end at an even hd).
//
// What bounds it on an H100. At the training shape ([12, 18, 2048, 128],
// causal) it does 8 * hd FLOPs per kept (q, k) pair (S, dP, dV, dK):
// 0.4692 ms at 989 TFLOP/s against ~0.20 ms of bytes at 3.35 TB/s, so
// tensor-core bound. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3
// at 700 W: the first version of this kernel (mma.sync, synchronous
// staging with two barriers per 32-query step, Q^T and dO^T copied by
// scalar stores with bank conflicts, 8 warps an SM) took 6.31 ms; this
// design takes 0.89 ms (SDPA's whole backward: 1.43 ms).
//
// This design:
//   - one block per pair of 128-key tiles of one b*KV row, from opposite
//     ends (flash::schedule in flash_common.cuh): under causal masking
//     every pair does the same work, and single tiles of the last few heads
//     fill the last wave; three warpgroups: a producer (its first warp
//     loads; setmaxnreg drops it to 24 registers) and two consumers of 64
//     keys each (240 registers);
//   - both tiles' K and V are loaded once by TMA, at the start, into their
//     own buffers; the producer streams 64-row Q and dO tiles through a
//     2-stage ring (TMA, mbarrier transactions), issuing the copies before
//     it loads and writes their lse (times log2 e) and delta rows beside
//     them, so the copies overlap those loads;
//   - per q tile each consumer computes S^T = K Q^T and dP^T = V dO^T by SS
//     wgmma m64n64k16 (Q and dO as stored are K-major B), P^T and dS^T in
//     registers, and dV += P^T dO and dK += dS^T Q by RS wgmma m64n{D}k16
//     with dO and Q read MN-major through the transpose flag: no
//     transposed copies. P^T is formed while dP^T runs, and dS^T while
//     dV's product runs;
//   - the loop walks the kv head's group of q heads and, inside it, the q
//     tiles from the causal diagonal (k0 / 64) on; dK and dV stay in fp32
//     registers across the whole loop and are written once, in the input
//     dtype: deterministic, no atomics. scale is applied to dK once at the
//     end; keys that no query reaches get zeros.
// Only tiles crossing the diagonal or the ragged q edge pay for the mask.
//
// Registers at D = 128 (ptxas -v): 168 at entry, no spills; the consumer
// loop holds dK and dV (64 + 64), S^T and dP^T (32 + 32) and P^T packed
// (16) at once.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;
using flash::pack2;

constexpr int kBlockK = 128;  // keys per block
constexpr int kBlockQ = 64;   // queries per step
constexpr int kStages = 2;
constexpr int kConsumers = 2;  // warpgroups of 64 keys each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: K V for each of the block's two key tiles | Q0 dO0 |
// Q1 dO1 | lse[kStages][64] | delta[kStages][64] | mbarriers, 1024-byte
// aligned tiles.
template <int D>
struct Smem {
  using TK = hopper::Tile<D, kBlockK>;
  using TQ = hopper::Tile<D, kBlockQ>;
  static constexpr int kKV = TK::kBytes;  // one of K or V
  static constexpr int kQ = TQ::kBytes;   // one of Q or dO
  static constexpr int kRows = 4 * kKV + kStages * 2 * kQ;
  static constexpr int kBars = kRows + 2 * kStages * kBlockQ * 4;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
};

// D is head_dim rounded up to 32, 64 or 128; columns in [hd, D) are
// zero-filled by TMA and never stored.
template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
                     const float* __restrict__ delta, uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv, int H, int KV, int q_len, int k_len, int hd,
                     float scale, int causal, int n_kv_heads, int singles) {
  using S = Smem<D>;
  using TK = typename S::TK;
  using TQ = typename S::TQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  auto sK = [&](int it) { return base + 2 * it * S::kKV; };
  auto sV = [&](int it) { return sK(it) + S::kKV; };
  auto sQ = [&](int s) { return base + 4 * S::kKV + s * 2 * S::kQ; };
  auto sdO = [&](int s) { return sQ(s) + S::kQ; };
  float* const sLse = reinterpret_cast<float*>(base_ptr + S::kRows);  // [kStages][kBlockQ]
  float* const sDelta = sLse + kStages * kBlockQ;
  const uint32_t bars = base + S::kBars;
  // mbarriers: full[kStages], empty[kStages], kv[2] (one per key tile).
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto bar_kv = [&](int it) { return bars + 16 * kStages + 8 * it; };

  // One or two key tiles of one kv head (flash::schedule): the one that
  // sees the most queries first; both K/V tiles load at the start.
  const int n_kt = (k_len + kBlockK - 1) / kBlockK;
  const flash::Schedule sch =
      flash::schedule(blockIdx.x, n_kt, n_kv_heads, singles, /*heavy_first=*/true);
  const int bkv = sch.head;
  const int n_items = sch.tile_b >= 0 ? 2 : 1;
  const int group = H / KV;
  const int b = bkv / KV, kvh = bkv % KV;
  const int n_q = (q_len + kBlockQ - 1) / kBlockQ;
  auto item_k0 = [&](int it) { return (it == 0 ? sch.tile_a : sch.tile_b) * kBlockK; };
  // Causal: query rows before k0 see none of the key tile.
  auto item_t_begin = [&](int k0) { return causal ? k0 / kBlockQ : 0; };
  auto item_per_head = [&](int k0) { return max(0, n_q - item_t_begin(k0)); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 32);               // the producer warp's lanes
      hopper::mbar_init(empty(s), kConsumers * 4);  // one arrival per consumer warp
    }
    hopper::mbar_init(bar_kv(0), 1);
    hopper::mbar_init(bar_kv(1), 1);
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
    const int lane = threadIdx.x - 128 * kConsumers;  // its first warp loads
    if (lane < 32) {
      if (lane == 0) {
        hopper::prefetch_map(&tm_q);
        hopper::prefetch_map(&tm_do);
        for (int it = 0; it < n_items; ++it) {
          const int k0 = item_k0(it);
          if (item_per_head(k0) == 0) continue;
          hopper::mbar_arrive_expect_tx(bar_kv(it), 2 * S::kKV);
#pragma unroll
          for (int bx = 0; bx < TK::kBoxes; ++bx) {
            const uint32_t off = bx * TK::kBoxBytes;
            hopper::tma_load_3d(sK(it) + off, &tm_k, bar_kv(it), bx * TK::kCols, k0, bkv);
            hopper::tma_load_3d(sV(it) + off, &tm_v, bar_kv(it), bx * TK::kCols, k0, bkv);
          }
        }
      }
      int n = 0;  // q steps streamed so far, over both key tiles
      for (int it = 0; it < n_items; ++it) {
        const int k0 = item_k0(it), t_begin = item_t_begin(k0), per_head = item_per_head(k0);
        for (int step = 0; step < group * per_head; ++step, ++n) {
          const int s = n % kStages;
          const int bh = b * H + kvh * group + step / per_head;
          const int q0 = (t_begin + step % per_head) * kBlockQ;
          hopper::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
          // The tiles first, so their copy overlaps the lse/delta loads.
          if (lane == 0) {
            hopper::mbar_expect_tx(full(s), 2 * S::kQ);
#pragma unroll
            for (int bx = 0; bx < TQ::kBoxes; ++bx) {
              const uint32_t off = bx * TQ::kBoxBytes;
              hopper::tma_load_3d(sQ(s) + off, &tm_q, full(s), bx * TQ::kCols, q0, bh);
              hopper::tma_load_3d(sdO(s) + off, &tm_do, full(s), bx * TQ::kCols, q0, bh);
            }
          }
#pragma unroll
          for (int r = lane; r < kBlockQ; r += 32) {
            const bool in = q0 + r < q_len;
            const size_t i = (size_t)bh * q_len + q0 + r;
            sLse[s * kBlockQ + r] = in ? lse[i] * kLog2e : 0.f;
            sDelta[s * kBlockQ + r] = in ? delta[i] : 0.f;
          }
          hopper::mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    int n = 0;  // q steps consumed so far, over both key tiles
    for (int it = 0; it < n_items; ++it) {
      const int k0 = item_k0(it), t_begin = item_t_begin(k0), per_head = item_per_head(k0);
      const int n_steps = group * per_head;
      const int key_first = k0 + 64 * c;          // this warpgroup's first key
      const int key0 = key_first + 16 * warp + g;  // this thread's keys: key0, key0 + 8

      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

      // This warpgroup's 64 keys of K and V, the A operands of S^T and dP^T.
      const hopper::Desc dk_a = TK::k_major(sK(it), 64 * c), dv_a = TK::k_major(sV(it), 64 * c);
      if (n_steps > 0) hopper::mbar_wait(bar_kv(it), 0);
      for (int step = 0; step < n_steps; ++step, ++n) {
        const int s = n % kStages;
        const int q0 = (t_begin + step % per_head) * kBlockQ;
        hopper::mbar_wait(full(s), (n / kStages) & 1);

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, as two
        // groups, so P^T is formed while dP^T is still on the tensor cores.
        float st[kBlockQ / 2], dpt[kBlockQ / 2];
        const hopper::Desc dq = TQ::k_major(sQ(s), 0), ddo = TQ::k_major(sdO(s), 0);
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss<kBlockQ, kBf16, 0>(st, hopper::desc_at(dk_a, TK::k_off(k)),
                                              hopper::desc_at(dq, TQ::k_off(k)), k > 0);
        hopper::wgmma_commit();
#pragma unroll
        for (int k = 0; k < D / 16; ++k)
          hopper::wgmma_ss<kBlockQ, kBf16, 0>(dpt, hopper::desc_at(dv_a, TK::k_off(k)),
                                              hopper::desc_at(ddo, TQ::k_off(k)), k > 0);
        hopper::wgmma_commit();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(st);
        // P^T into st. Masked: tiles with a query before one of the
        // warpgroup's keys, and the ragged last q tile.
        const bool masked = (q0 + kBlockQ > q_len) || (causal && q0 < key_first + 63);
        const float* l2 = sLse + s * kBlockQ;
        const float* dl = sDelta + s * kBlockQ;
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tg + (e & 1);  // query in the tile
            float x = st[4 * j + e] * scale_log2;
            if (masked) {
              const int key = key0 + 8 * (e >> 1);
              const int qi = q0 + col;
              if (qi >= q_len || (causal && qi < key)) x = kMaskValue;
            }
            st[4 * j + e] = hopper::exp2_fast(x - l2[col]);
          }
        }
        uint32_t pf[kBlockQ / 16][4], df[kBlockQ / 16][4];
#pragma unroll
        for (int k = 0; k < kBlockQ / 16; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pf[k][i] = pack2<kBf16>(st[8 * k + 2 * i], st[8 * k + 2 * i + 1]);
        // dV += P^T dO (dO read MN-major) runs while dS^T is formed.
        const hopper::Desc ddo_t = TQ::mn_major(sdO(s)), dq_t = TQ::mn_major(sQ(s));
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(pf);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBlockQ / 16; ++k)
          hopper::wgmma_rs<D, kBf16, 1>(dv_acc, pf[k], hopper::desc_at(ddo_t, TQ::mn_off(k)), 1);
        hopper::wgmma_commit();
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(pf);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(dpt);
        // dS^T = P^T (dP^T - delta), then dK += dS^T Q (Q read MN-major).
#pragma unroll
        for (int j = 0; j < kBlockQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * tg + (e & 1);
            dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dl[col]);
          }
#pragma unroll
        for (int k = 0; k < kBlockQ / 16; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            df[k][i] = pack2<kBf16>(dpt[8 * k + 2 * i], dpt[8 * k + 2 * i + 1]);
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(df);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBlockQ / 16; ++k)
          hopper::wgmma_rs<D, kBf16, 1>(dk_acc, df[k], hopper::desc_at(dq_t, TQ::mn_off(k)), 1);
        hopper::wgmma_commit();
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(df);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty(s));
      }

      // Key rows past k_len (the partial last tile) are never written.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key < k_len) {
          uint16_t* dk_row = dk + ((size_t)bkv * k_len + key) * hd;
          uint16_t* dv_row = dv + ((size_t)bkv * k_len + key) * hd;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int col = 8 * j + 2 * tg;
            if (col < hd) {
              *reinterpret_cast<uint32_t*>(dk_row + col) =
                  pack2<kBf16>(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
              *reinterpret_cast<uint32_t*>(dv_row + col) =
                  pack2<kBf16>(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
            }
          }
        }
      }
    }
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int batch, int heads,
                   int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int kCols = hopper::Tile<D, kBlockQ>::kCols;
  auto kernel = flash_bwd_dkv_kernel<kBf16, D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (err != cudaSuccess) return err;
    return hopper::check_register_pool(kernel, kThreads,
                                       128 * kProducerRegs + 128 * kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err;
  if ((err = hopper::make_map_3d(&mq, q, kBf16, batch * heads, q_len, hd, kBlockQ, kCols)) ||
      (err = hopper::make_map_3d(&mdo, dout, kBf16, batch * heads, q_len, hd, kBlockQ,
                                 kCols)) ||
      (err = hopper::make_map_3d(&mk, k, kBf16, batch * kv_heads, k_len, hd, kBlockK, kCols)) ||
      (err = hopper::make_map_3d(&mv, v, kBf16, batch * kv_heads, k_len, hd, kBlockK, kCols)))
    return err;
  int singles, blocks;
  flash::schedule_size((k_len + kBlockK - 1) / kBlockK, batch * kv_heads, &singles, &blocks);
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), heads, kv_heads, q_len, k_len, hd,
      scale, causal, batch * kv_heads, singles);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int batch,
                     int heads, int kv_heads, int q_len, int k_len, int hd, float scale,
                     int causal, cudaStream_t stream) {
  if (hd <= 32)
    return launch<kBf16, 32>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len,
                             k_len, hd, scale, causal, stream);
  if (hd <= 64)
    return launch<kBf16, 64>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len,
                             k_len, hd, scale, causal, stream);
  return launch<kBf16, 128>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len,
                            k_len, hd, scale, causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int batch,
                             int heads, int kv_heads, int q_len, int k_len, int head_dim,
                             float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim <= 0 || head_dim % 8 != 0 || head_dim > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads,
                                        q_len, k_len, head_dim, scale, causal, s)
                       : dispatch<false>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                                         kv_heads, q_len, k_len, head_dim, scale, causal, s));
}
