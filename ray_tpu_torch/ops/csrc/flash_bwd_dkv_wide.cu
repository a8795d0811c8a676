// Flash-attention backward, dK and dV, for Hopper (sm_90a) at wide heads
// (head dims that are multiples of 8 in 129-256), bound through a plain C
// entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_bwd_dkv_wide_cuda).
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel for the inputs
// flash_bwd_dkv.cu does not take because their rows are too wide for its
// tiles. It computes the same function as flash_bwd_dkv.cu:
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (fp32,
//        written by the wide dQ kernel, flash_bwd_wide.cu, which runs first)
//   dV = P^T dO,  dK = scale * dS^T Q
// with native GQA by index (dK and dV summed over each kv head's group of q
// heads), top-left causal masking (q_id >= k_id), ragged q_len/k_len masked
// in-kernel, and the finite mask value. P and dS are rounded to the input
// dtype as the A operands of their products; everything else is fp32.
//
// Layout at the boundary: q, do [b*H, q_len, hd]; k, v, dk, dv
// [b*KV, k_len, hd]; lse, delta fp32 [b*H, q_len]; all contiguous, bf16 or
// fp16, hd a multiple of 8 in 129-256 (D = 192 holds 136-192, D = 256
// holds 200-256; columns past hd are zero-filled by TMA and never stored).
//
// What bounds it on an H100. At Gemma-7B's head shape ([1, 16, 2048, 256],
// causal) it does 8 * hd FLOPs per kept (q, k) pair (S, dP, dV, dK):
// 0.0695 ms at 989 TFLOP/s against ~0.01 ms of bytes at 3.35 TB/s, so
// tensor-core bound. The general SIMT kernel (flash_general.cu) took
// 4.237 ms there.
//
// Why flash_bwd_dkv.cu's layout does not widen. There a consumer
// warpgroup owns 64 keys and holds their dK and dV, 64 x D fp32 each: 256
// registers a thread at D = 256, more than a thread has. So this design
// splits the work between the two consumers by what they accumulate, not
// by keys:
//   - one block per pair of 64-key tiles of one b*KV row from opposite
//     ends (flash::schedule); a producer warpgroup (its first warp loads;
//     setmaxnreg drops it to 24 registers) and two consumers (240);
//   - consumer 0 owns dV: per 64-query step it computes S^T = K Q^T (SS
//     wgmma m64n64k16, Q as stored is K-major B), P^T in fp32, and dV +=
//     P^T dO (RS wgmma m64n{D}k16, P^T from registers, dO read MN-major
//     through the transpose flag); consumer 1 owns dK: dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta), dK += dS^T Q. Each holds one 64 x D
//     accumulator (128 registers at D = 256), and the four products split
//     evenly, with no product computed twice;
//   - P^T goes from consumer 0 to consumer 1 through 16 KB of shared memory
//     in fp32 (dS is formed from the fp32 P, as flash_bwd_dkv.cu forms it),
//     in the accumulator fragment order: thread t of one warpgroup reads
//     what thread t of the other wrote, so the hand-over needs no swizzle
//     and has no bank conflicts; named barriers 1 (P written) and 2 (P
//     read) order it;
//   - shared memory: the block's K and V tile (2 x 32 KB), a 2-stage ring
//     of 64-row Q and dO tiles (4 x 32 KB) with their lse (times log2 e)
//     and delta rows, and P^T: 209 KB of the 227 KB. The ring is too
//     shallow to hide much, so the producer gates every step: it reads a
//     step's lse and delta rows before it waits for the stage (read after
//     the wait they spilled at 24 registers, and the kernel took a sixth
//     longer: chip_tune_dkv_wide.py). K is released when
//     consumer 0 has computed its last S^T and V when consumer 1 has
//     computed its last dP^T, so a second key tile's K and V load while the
//     first tile's dK and dV are written;
//   - the loop walks the kv head's group of q heads and, inside it, the q
//     tiles from the causal diagonal (k0 / 64) on; dK and dV stay in fp32
//     registers across the whole loop and are written once, in the input
//     dtype: deterministic, no atomics. scale is applied to dK once at the
//     end; keys that no query reaches get zeros.
// Only tiles crossing the diagonal or the ragged q edge pay for the mask.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;
using flash::pack2;

constexpr int kBlockK = 64;  // keys per tile
constexpr int kBlockQ = 64;  // queries per step
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarPFull = 1;   // consumer 0 has written P^T
constexpr int kBarPEmpty = 2;  // consumer 1 has read it

// Shared memory: K | V | Q0 dO0 | Q1 dO1 | P^T (fp32, fragment order) |
// lse[kStages][64] | delta[kStages][64] | mbarriers, 1024-byte aligned tiles.
template <int D>
struct Smem {
  using T = hopper::Tile<D, 64>;  // every operand tile: 64 rows of D
  static constexpr int kTile = T::kBytes;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kP = kRing + kStages * 2 * kTile;
  static constexpr int kRows = kP + 64 * kBlockQ * 4;
  static constexpr int kBars = kRows + 2 * kStages * kBlockQ * 4;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
};

template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int H, int KV,
                          int q_len, int k_len, int hd, float scale, int causal, int n_kv_heads,
                          int singles) {
  using S = Smem<D>;
  using T = typename S::T;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + S::kTile;
  auto sQ = [&](int s) { return base + S::kRing + s * 2 * S::kTile; };
  auto sdO = [&](int s) { return sQ(s) + S::kTile; };
  float* const sP = reinterpret_cast<float*>(base_ptr + S::kP);        // [32][128]
  float* const sLse = reinterpret_cast<float*>(base_ptr + S::kRows);   // [kStages][kBlockQ]
  float* const sDelta = sLse + kStages * kBlockQ;
  const uint32_t bars = base + S::kBars;
  // mbarriers: full[kStages], empty[kStages], then K's and V's full and empty.
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const uint32_t full_k = bars + 16 * kStages, full_v = full_k + 8;
  const uint32_t empty_k = full_k + 16, empty_v = full_k + 24;

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
    hopper::mbar_init(full_k, 1);
    hopper::mbar_init(full_v, 1);
    hopper::mbar_init(empty_k, 4);  // consumer 0's warps
    hopper::mbar_init(empty_v, 4);  // consumer 1's warps
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer ----------------------------------------------------
    hopper::reg_dealloc<kProducerRegs>();
    const int lane = threadIdx.x - 128 * kConsumers;  // its first warp loads
    if (lane < 32) {
      if (lane == 0) {
        hopper::prefetch_map(&tm_q);
        hopper::prefetch_map(&tm_do);
        hopper::prefetch_map(&tm_k);
        hopper::prefetch_map(&tm_v);
      }
      int n = 0;       // q steps streamed so far, over both key tiles
      int loads = 0;   // K/V tiles loaded so far
      for (int it = 0; it < n_items; ++it) {
        const int k0 = item_k0(it), t_begin = item_t_begin(k0), per_head = item_per_head(k0);
        if (per_head == 0) continue;  // keys no query reaches: zeros, nothing to load
        if (lane == 0) {
          const uint32_t parity = (loads & 1) ^ 1;
          hopper::mbar_wait(empty_k, parity);
          hopper::mbar_arrive_expect_tx(full_k, S::kTile);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            hopper::tma_load_3d(sK + bx * T::kBoxBytes, &tm_k, full_k, bx * T::kCols, k0, bkv);
          hopper::mbar_wait(empty_v, parity);
          hopper::mbar_arrive_expect_tx(full_v, S::kTile);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            hopper::tma_load_3d(sV + bx * T::kBoxBytes, &tm_v, full_v, bx * T::kCols, k0, bkv);
        }
        ++loads;
        for (int step = 0; step < group * per_head; ++step, ++n) {
          const int s = n % kStages;
          const int bh = b * H + kvh * group + step / per_head;
          const int q0 = (t_begin + step % per_head) * kBlockQ;
          // This step's lse and delta rows are read before the stage is
          // free, so their latency hides behind the wait.
          float l2[kBlockQ / 32], dl[kBlockQ / 32];
#pragma unroll
          for (int j = 0; j < kBlockQ / 32; ++j) {
            const int r = lane + 32 * j;
            const bool in = q0 + r < q_len;
            const size_t i = (size_t)bh * q_len + q0 + r;
            l2[j] = in ? lse[i] * kLog2e : 0.f;
            dl[j] = in ? delta[i] : 0.f;
          }
          hopper::mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
          if (lane == 0) {
            hopper::mbar_expect_tx(full(s), 2 * S::kTile);
#pragma unroll
            for (int bx = 0; bx < T::kBoxes; ++bx) {
              const uint32_t off = bx * T::kBoxBytes;
              hopper::tma_load_3d(sQ(s) + off, &tm_q, full(s), bx * T::kCols, q0, bh);
              hopper::tma_load_3d(sdO(s) + off, &tm_do, full(s), bx * T::kCols, q0, bh);
            }
          }
#pragma unroll
          for (int j = 0; j < kBlockQ / 32; ++j) {
            sLse[s * kBlockQ + lane + 32 * j] = l2[j];
            sDelta[s * kBlockQ + lane + 32 * j] = dl[j];
          }
          hopper::mbar_arrive(full(s));
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    // Consumer 0: S^T, P^T, dV. Consumer 1: dP^T, dS^T, dK.
    hopper::reg_alloc<kConsumerRegs>();
    const int c = wg;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    // Consumer 0's first P^T goes into an empty buffer.
    if (c == 1) hopper::named_bar_arrive(kBarPEmpty, 256);
    int n = 0;      // q steps consumed so far, over both key tiles
    int loads = 0;  // K/V tiles consumed so far
    for (int it = 0; it < n_items; ++it) {
      const int k0 = item_k0(it), t_begin = item_t_begin(k0), per_head = item_per_head(k0);
      const int n_steps = group * per_head;
      const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8

      float acc[D / 2];  // consumer 0: dV; consumer 1: dK (unscaled)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      if (n_steps > 0) {
        // The A operand of this consumer's first product: K (S^T) or V (dP^T).
        const hopper::Desc da = T::k_major(c == 0 ? sK : sV, 0);
        hopper::mbar_wait(c == 0 ? full_k : full_v, loads & 1);
        for (int step = 0; step < n_steps; ++step, ++n) {
          const int s = n % kStages;
          const int q0 = (t_begin + step % per_head) * kBlockQ;
          hopper::mbar_wait(full(s), (n / kStages) & 1);

          // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1): 64 keys
          // x 64 queries.
          float x[kBlockQ / 2];
          const hopper::Desc db = T::k_major(c == 0 ? sQ(s) : sdO(s), 0);
          hopper::fence_regs(x);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < D / 16; ++k)
            hopper::wgmma_ss<kBlockQ, kBf16, 0>(x, hopper::desc_at(da, T::k_off(k)),
                                                hopper::desc_at(db, T::k_off(k)), k > 0);
          hopper::wgmma_commit();
          hopper::fence_regs(x);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(x);
          if (step == n_steps - 1) release(c == 0 ? empty_k : empty_v);

          uint32_t af[kBlockQ / 16][4];
          if (c == 0) {
            // P^T, into x. Masked: tiles with a query before one of the
            // block's keys, and the ragged last q tile.
            const bool masked = (q0 + kBlockQ > q_len) || (causal && q0 < k0 + kBlockK - 1);
            const float* l2 = sLse + s * kBlockQ;
#pragma unroll
            for (int j = 0; j < kBlockQ / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = 8 * j + 2 * tg + (e & 1);  // query in the tile
                float v = x[4 * j + e] * scale_log2;
                if (masked) {
                  const int key = key0 + 8 * (e >> 1);
                  const int qi = q0 + col;
                  if (qi >= q_len || (causal && qi < key)) v = kMaskValue;
                }
                x[4 * j + e] = hopper::exp2_fast(v - l2[col]);
              }
            }
            // Hand P^T over (once consumer 1 has read the previous one).
            hopper::named_bar_sync(kBarPEmpty, 256);
#pragma unroll
            for (int j = 0; j < kBlockQ / 8; ++j)
              reinterpret_cast<float4*>(sP)[j * 128 + tid] =
                  make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
            hopper::named_bar_arrive(kBarPFull, 256);
          } else {
            // dS^T = P^T (dP^T - delta), into x.
            const float* dl = sDelta + s * kBlockQ;
            hopper::named_bar_sync(kBarPFull, 256);
#pragma unroll
            for (int j = 0; j < kBlockQ / 8; ++j) {
              const float4 p = reinterpret_cast<const float4*>(sP)[j * 128 + tid];
              const int col = 8 * j + 2 * tg;
              x[4 * j + 0] = p.x * (x[4 * j + 0] - dl[col]);
              x[4 * j + 1] = p.y * (x[4 * j + 1] - dl[col + 1]);
              x[4 * j + 2] = p.z * (x[4 * j + 2] - dl[col]);
              x[4 * j + 3] = p.w * (x[4 * j + 3] - dl[col + 1]);
            }
            hopper::named_bar_arrive(kBarPEmpty, 256);
          }
#pragma unroll
          for (int k = 0; k < kBlockQ / 16; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) af[k][i] = pack2<kBf16>(x[8 * k + 2 * i], x[8 * k + 2 * i + 1]);

          // dV += P^T dO (consumer 0) or dK += dS^T Q (consumer 1); the B
          // operand read MN-major.
          const hopper::Desc dbt = T::mn_major(c == 0 ? sdO(s) : sQ(s));
          hopper::fence_regs(acc);
          hopper::fence_regs(af);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < kBlockQ / 16; ++k)
            hopper::wgmma_rs<D, kBf16, 1>(acc, af[k], hopper::desc_at(dbt, T::mn_off(k)), 1);
          hopper::wgmma_commit();
          hopper::fence_regs(acc);
          hopper::fence_regs(af);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          release(empty(s));
        }
        ++loads;
      }

      // Key rows past k_len (the partial last tile) are never written.
      uint16_t* const out = c == 0 ? dv : dk;
      const float out_scale = c == 0 ? 1.f : scale;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key < k_len) {
          uint16_t* row = out + ((size_t)bkv * k_len + key) * hd;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const int col = 8 * j + 2 * tg;
            if (col < hd)
              *reinterpret_cast<uint32_t*>(row + col) = pack2<kBf16>(
                  acc[4 * j + 2 * i] * out_scale, acc[4 * j + 2 * i + 1] * out_scale);
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
  constexpr int kCols = hopper::Tile<D, 64>::kCols;
  auto kernel = flash_bwd_dkv_wide_kernel<kBf16, D>;
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
  if (hd <= 192)
    return launch<kBf16, 192>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len,
                              k_len, hd, scale, causal, stream);
  return launch<kBf16, 256>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len,
                            k_len, hd, scale, causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_bwd_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  int batch, int heads, int kv_heads, int q_len, int k_len,
                                  int head_dim, float scale, int causal, int is_bf16,
                                  void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim % 8 != 0 || head_dim < 129 || head_dim > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads,
                                        q_len, k_len, head_dim, scale, causal, s)
                       : dispatch<false>(q, k, v, dout, lse, delta, dk, dv, batch, heads,
                                         kv_heads, q_len, k_len, head_dim, scale, causal, s));
}
