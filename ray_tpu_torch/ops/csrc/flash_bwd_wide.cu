// Flash-attention backward, dQ and delta, for Hopper (sm_90a) at wide heads
// (head dims that are multiples of 8 in 129-256), bound through a plain C
// entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_bwd_dq_wide_cuda). dK and dV are
// computed by csrc/flash_bwd_dkv_wide.cu, which reads the delta written here.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel, and the
// delta = rowsum(dO * O) that _flash_backward computes in front of it, for
// the inputs flash_bwd.cu does not take because their rows are too wide for
// its tiles. It computes the same function as flash_bwd.cu:
//   delta = rowsum(dO * O)                     (fp32, written out for dK/dV)
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta)
//   dQ = scale * dS K
// with native GQA by index (the kv row of program bh is
// (bh / H) * KV + (bh % H) / (H / KV)), top-left causal masking
// (q_id >= k_id) with the k loop stopping at the diagonal, ragged
// q_len/k_len masked in-kernel, and the finite mask value. dS is rounded to
// the input dtype as the A operand of its product, as flash_bwd.cu rounds
// it; everything else is fp32.
//
// Layout at the boundary: q, o, do, dq [b*H, q_len, hd]; k, v
// [b*KV, k_len, hd]; lse, delta fp32 [b*H, q_len]; all contiguous, bf16 or
// fp16, hd a multiple of 8 in 129-256 (D = 192 holds 136-192, D = 256
// holds 200-256; columns past hd are zero-filled by TMA or read as zeros by
// the 8-column chunks of Q, dO and O, and never stored).
//
// What bounds it on an H100. At Gemma-7B's head shape ([1, 16, 2048, 256],
// causal) it does 6 * hd FLOPs per kept (q, k) pair (S, dP, dQ): 0.0521 ms
// at 989 TFLOP/s against ~0.03 ms of bytes at 3.35 TB/s (q, o, do, dq once;
// k, v; lse, delta), so tensor-core bound. The general SIMT kernel
// (flash_general.cu), the wide route's dQ before this one, took 3.8834 ms
// there (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W).
//
// Why flash_bwd.cu's layout does not widen. There a consumer warpgroup owns
// 64 query rows and holds their dQ, 64 x D fp32: 128 registers a thread at
// D = 256, with S, dP and packed dS (32 + 32 + 16) on top, past the 240 a
// consumer has. Its 128-row Q, dO and O tiles alone would take 192 KB of
// shared memory at D = 256. So this design splits the work between the two
// consumers by product and by dQ's columns, as flash_bwd_dkv_wide.cu splits
// it by accumulator:
//   - one block per pair of 64-row q tiles of one b*H row from opposite
//     ends (flash::schedule, the heavy end last); a producer warpgroup (one
//     thread issues TMA; setmaxnreg drops it to 24 registers) and two
//     consumers (240), both on the tile's 64 rows;
//   - per tile, consumer 0 holds Q's rows and consumer 1 dO's as wgmma A
//     fragments in registers (64 a thread at D = 256), loaded once from
//     global memory by 16-byte loads and transposed within each quad by
//     shuffles; shared memory holds only K and V, in rings of 64-key tiles
//     (4 + 2 stages at D = 256, 5 + 3 at D = 192: K stays until both dQ
//     products have read it, V only until dP is done);
//   - per key tile, consumer 0 computes S = Q K^T and consumer 1
//     dP = dO V^T (RS wgmma m64n64k16, K and V as stored are K-major B). Each
//     forms dS for 32 of the 64 keys: consumer 0 hands its raw S of keys
//     32-63 to consumer 1, consumer 1 its dP of keys 0-31 (and its rows'
//     delta) to consumer 0, through shared memory in the accumulator
//     fragment order (thread t of one warpgroup reads what thread t of the
//     other wrote: no swizzle, no bank conflicts); each forms P and
//     dS = P (dP - delta) for its keys, rounds dS to 16 bits, and the two
//     packed halves change hands the same way. Named barriers 1 and 2 join
//     the two hand-overs; each consumer reads back both halves as the A
//     fragments of dQ's product, so both use the same dS bit for bit;
//   - each consumer adds dQ[:, its columns] += dS K[:, its columns] by RS
//     wgmma (K read MN-major through the transpose flag from its swizzled
//     tile). Consumer 0 takes columns 0-127 and consumer 1 the rest: 128 at
//     D = 256, so each does 1.5 of the 3 products; 64 at D = 192, where an
//     even split of 96 would start consumer 1's B operand inside a
//     64-column swizzle box (and wgmma_ss/rs take no N = 96 here). dQ is 64
//     registers a thread at most;
//   - the key loop takes two tiles a pass: tile t + 1's S or dP is issued as
//     soon as tile t's is read, so it runs with dQ += dS_{t-1} K_{t-1}
//     while dS_t is formed; every wgmma group is retired by the end of the
//     pass (groups left in flight across the loop's back edge made ptxas
//     serialise the products, C7514);
//   - delta is summed by consumer 1 from its dO chunks and O's chunks at the
//     same places (O is read once, straight from global memory), and
//     written out;
//   - dQ stays in fp32 registers for the whole key loop, is scaled once and
//     written once from the fragments, in the input dtype. Each dQ row is
//     written by one block with no atomics: the kernel is bitwise
//     repeatable.
// Only tiles crossing the diagonal or the ragged k edge pay for the mask.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.1155 ms at
// [1, 16, 2048, 256] causal (45% of its bound; SDPA's whole backward
// 0.3360) and 0.7206 ms at the wide-head flagship's [12, 9, 2048, 256] (49%)
// in chip_smoke.py; 0.094 ms at [1, 16, 2048, 192] (41%) in
// chip_tune_dq_wide.py, whose variants show what holds it there: without
// the K/V loads it takes 4% less, without the products 28% less; the rest
// is each tile's chain of products, hand-overs and dS.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::kMaskValue;
using flash::pack2;

constexpr int kBlockQ = 64;  // query rows per tile, both consumers'
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarHalves = 1;  // both consumers have written their half of S or dP
constexpr int kBarPacked = 2;  // both consumers have written their half of dS
// What each consumer hands the other per key tile, in the accumulator
// fragment order: 32 keys of S or dP in fp32 (8 KB), then its 32 keys of dS
// packed to 16 bits (4 KB).
constexpr int kHalfBytes = kBlockQ * kBlockK / 2 * 4;
constexpr int kPackedBytes = kBlockQ * kBlockK / 2 * 2;

// Shared memory: K[kStagesK] | V[kStagesV] | halves[2] | packed[2] | delta
// (a float2 per thread) | mbarriers, tiles 1024-byte aligned.
template <int D>
struct Smem {
  using T = hopper::Tile<D, 64>;  // every operand tile: 64 rows of D
  static constexpr int kStagesK = D == 256 ? 4 : 5;
  static constexpr int kStagesV = D == 256 ? 2 : 3;
  static constexpr int kV = kStagesK * T::kBytes;
  static constexpr int kP = kV + kStagesV * T::kBytes;
  static constexpr int kPacked = kP + 2 * kHalfBytes;
  static constexpr int kDelta = kPacked + 2 * kPackedBytes;
  static constexpr int kBars = kDelta + 128 * 8;
  static constexpr int kBytes = kBars + 128 + 1024;  // + mbarriers + alignment slack
  static_assert(2 * (kStagesK + kStagesV) * 8 <= 128, "mbarriers");
};

// The dQ columns of consumer kC: 0-127, then the rest.
template <int D, int kC>
struct Cols {
  static constexpr int k0 = 128 * kC;
  static constexpr int kN = kC == 0 ? 128 : D - 128;
};

// The block's view of shared memory and its mbarriers: full_k, empty_k
// [kStagesK], then full_v, empty_v [kStagesV]. Key tile n (counted over
// both items) is in stage n % kStagesK of the K ring and n % kStagesV of
// the V ring; the phase parities follow from n.
template <int D>
struct Layout {
  using S = Smem<D>;
  using T = typename S::T;
  uint32_t base;
  uint8_t* base_ptr;
  __device__ uint32_t k(int n) const { return base + (n % S::kStagesK) * T::kBytes; }
  __device__ uint32_t v(int n) const { return base + S::kV + (n % S::kStagesV) * T::kBytes; }
  __device__ float4* half(int c) const {
    return reinterpret_cast<float4*>(base_ptr + S::kP + c * kHalfBytes);
  }
  __device__ uint4* packed(int c) const {
    return reinterpret_cast<uint4*>(base_ptr + S::kPacked + c * kPackedBytes);
  }
  __device__ float2* delta() const { return reinterpret_cast<float2*>(base_ptr + S::kDelta); }
  __device__ uint32_t bar(int i) const { return base + S::kBars + 8 * i; }
  __device__ uint32_t full_k(int n) const { return bar(n % S::kStagesK); }
  __device__ uint32_t empty_k(int n) const { return bar(S::kStagesK + n % S::kStagesK); }
  __device__ uint32_t full_v(int n) const { return bar(2 * S::kStagesK + n % S::kStagesV); }
  __device__ uint32_t empty_v(int n) const {
    return bar(2 * S::kStagesK + S::kStagesV + n % S::kStagesV);
  }
  __device__ static uint32_t par_k(int n) { return (uint32_t)(n / S::kStagesK) & 1; }
  __device__ static uint32_t par_v(int n) { return (uint32_t)(n / S::kStagesV) & 1; }
};

struct Args {
  const uint16_t* q;
  const uint16_t* o;
  const uint16_t* dout;
  const float* lse;
  float* delta;
  uint16_t* dq;
  int H, KV, q_len, k_len, hd;
  float scale;
  int causal, n_heads, singles;
};

// The tile's q0 and key tiles for one or two q tiles of one head
// (flash::schedule, the one with the most keys first).
struct Work {
  int bh, n_items, tile_a, tile_b;
  __device__ int q0(int it) const { return (it == 0 ? tile_a : tile_b) * kBlockQ; }
  // The key tiles that the tile's rows need: causal, keys up to its last row.
  __device__ static int key_tiles(const Args& a, int q0) {
    const int k_end = a.causal ? min(a.k_len, q0 + kBlockQ) : a.k_len;
    return (k_end + kBlockK - 1) / kBlockK;
  }
};

template <bool kBf16>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if constexpr (kBf16) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  else return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// The tile's rows r and r + 8 of a 16-bit [.., len, hd] tensor as this
// thread's share of 16-byte chunks (8 columns): chunk 4m + tg of each row,
// so that a quad's loads cover whole rows (rows is the tile's first row;
// rows_left the rows before the tensor's end; rows and columns past them
// read as zeros).
template <int D>
__device__ __forceinline__ void load_chunks(uint4 (&raw)[2][D / 32], const uint16_t* rows,
                                            int rows_left, int hd, int r, int tg) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const int rr = r + 8 * h, col = 8 * (4 * m + tg);
      raw[h][m] = rr < rows_left && col < hd
                      ? __ldg(reinterpret_cast<const uint4*>(rows + (size_t)rr * hd + col))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
}

// v[i] for a runtime i in 0..3, by selects (no dynamic register indexing).
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  const uint32_t lo = (i & 1) ? v[1] : v[0], hi = (i & 1) ? v[3] : v[2];
  return (i & 2) ? hi : lo;
}

// The wgmma A fragments from load_chunks' chunks: for reduction step k,
// f[k][i] holds the pair at row r + 8 (i & 1), columns 16k + 8 (i >> 1) +
// 2tg (hopper.cuh's A layout), i.e. pair tg of chunk 2k + (i >> 1). Each
// group of four chunks is transposed within the quad by shuffles: in round
// i, thread t takes pair t of chunk 4m + ((t + i) & 3) from the thread
// that loaded it.
template <int D>
__device__ __forceinline__ void chunks_to_frags(uint32_t (&f)[D / 16][4],
                                                const uint4 (&raw)[2][D / 32], int tg) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const uint32_t in[4] = {raw[h][m].x, raw[h][m].y, raw[h][m].z, raw[h][m].w};
      uint32_t rot[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rot[i] = __shfl_sync(0xffffffffu, pick4(in, (tg - i) & 3), (lane & ~3) | ((tg + i) & 3));
#pragma unroll
      for (int c = 0; c < 4; ++c) f[2 * m + c / 2][h + 2 * (c % 2)] = pick4(rot, (c - tg) & 3);
    }
}

// delta = rowsum(dO * O) in fp32 for rows r and r + 8 of the tile, from dO's
// chunks and the O chunks at the same places: each thread of a quad sums a
// quarter of the columns, then the quad adds its shares, so all four hold
// both rows' delta, as the fragments of those rows need it.
template <bool kBf16, int D>
__device__ __forceinline__ void chunk_delta(float (&dl)[2], const uint4 (&d_o)[2][D / 32],
                                            const uint16_t* o_rows, int rows_left, int hd, int r,
                                            int tg) {
  uint4 o[2][D / 32];
  load_chunks<D>(o, o_rows, rows_left, hd, r, tg);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const uint32_t x[4] = {d_o[h][m].x, d_o[h][m].y, d_o[h][m].z, d_o[h][m].w};
      const uint32_t y[4] = {o[h][m].x, o[h][m].y, o[h][m].z, o[h][m].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack2<kBf16>(x[e]), b = unpack2<kBf16>(y[e]);
        sum = fmaf(a.x, b.x, fmaf(a.y, b.y, sum));
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[h] = sum;
  }
}

// Issues X = A B^T for the tile's 64 rows x 64 keys as one wgmma group, A
// from registers and B K-major: S = Q K^T (consumer 0) or dP = dO V^T
// (consumer 1).
template <bool kBf16, int D>
__device__ __forceinline__ void issue_x(float (&x)[kBlockK / 2], const uint32_t (&af)[D / 16][4],
                                        hopper::Desc db) {
  using T = hopper::Tile<D, 64>;
  hopper::fence_regs(x);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    hopper::wgmma_rs<kBlockK, kBf16, 0>(x, af[k], hopper::desc_at(db, T::k_off(k)), k > 0);
  hopper::wgmma_commit();
  hopper::fence_regs(x);
}

// Issues dQ[:, N columns] += dS K[:, N columns] as one wgmma group: dS from
// registers, K MN-major from the descriptor of its first column.
template <bool kBf16, int D, int N>
__device__ __forceinline__ void issue_dq(float (&acc)[N / 2], uint32_t (&df)[kBlockK / 16][4],
                                         hopper::Desc dk_t) {
  using T = hopper::Tile<D, 64>;
  hopper::fence_regs(acc);
  hopper::fence_regs(df);
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < kBlockK / 16; ++k)
    hopper::wgmma_rs<N, kBf16, 1>(acc, df[k], hopper::desc_at(dk_t, T::mn_off(k)), 1);
  hopper::wgmma_commit();
  hopper::fence_regs(acc);
  hopper::fence_regs(df);
}

// Consumer kC forms dS for 32 keys of each tile (consumer 0 keys 0-31,
// consumer 1 keys 32-63: accumulators x[16 kC..16 kC + 15]). Once its S or
// dP is done, give_half hands the other consumer the half it needs (consumer
// 0 its raw S of keys 32-63, consumer 1 its dP of keys 0-31 and its rows'
// delta) and keeps its own half in `mine`, so that x can take the next
// tile's product.
template <int kC, int D>
__device__ __forceinline__ void give_half(float (&mine)[16], const float (&x)[kBlockK / 2],
                                          const float (&dl)[2], const Layout<D>& l, int tid) {
  constexpr int kMine = 16 * kC, kTheirs = 16 - kMine;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    l.half(kC)[j * 128 + tid] = make_float4(x[kTheirs + 4 * j], x[kTheirs + 4 * j + 1],
                                            x[kTheirs + 4 * j + 2], x[kTheirs + 4 * j + 3]);
  if (kC == 1) l.delta()[tid] = make_float2(dl[0], dl[1]);
#pragma unroll
  for (int i = 0; i < 16; ++i) mine[i] = x[kMine + i];
}

// Then form_half takes the other's half and forms P = exp2(s * scale_log2 -
// lse2) (masked entries 0) and dS = P (dP - delta) for its keys, packed to
// 16 bits as the A fragments of reduction steps 2 kC and 2 kC + 1.
// Accumulator i is in this thread's row row0 + 8 * ((i >> 1) & 1).
template <bool kBf16, int kC, int D>
__device__ __forceinline__ void form_half(uint32_t (&own)[2][4], const float (&mine)[16],
                                          float (&dl)[2], const float (&lse2)[2], bool masked,
                                          int row0, int k0, int tg, int k_len, int causal,
                                          float scale_log2, const Layout<D>& l, int tid) {
  hopper::named_bar_sync(kBarHalves, 256);
  if (kC == 0) {
    const float2 d = l.delta()[tid];
    dl[0] = d.x;
    dl[1] = d.y;
  }
  float ds[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 y = l.half(1 - kC)[j * 128 + tid];
    const float other[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sc = kC == 0 ? mine[4 * j + e] : other[e];
      const float dp = kC == 0 ? other[e] : mine[4 * j + e];
      float v = fmaf(sc, scale_log2, -lse2[e >> 1]);
      if (masked) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 32 * kC + 8 * j + 2 * tg + (e & 1);
        if (col >= k_len || (causal && row < col)) v = kMaskValue;
      }
      ds[4 * j + e] = hopper::exp2_fast(v) * (dp - dl[e >> 1]);
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) own[k][i] = pack2<kBf16>(ds[8 * k + 2 * i], ds[8 * k + 2 * i + 1]);
}

// The packed halves of dS change hands through shared memory: each
// consumer writes its own; once the dQ product that read df has finished,
// take_ds reads both halves back as the A fragments of the next one (its
// own half too: kept in registers, the compiler would build df in place
// while that product still reads it, and serialise the wgmma).
template <int kC, int D>
__device__ __forceinline__ void hand_over(const uint32_t (&own)[2][4], const Layout<D>& l,
                                          int tid) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
    l.packed(kC)[k * 128 + tid] = make_uint4(own[k][0], own[k][1], own[k][2], own[k][3]);
  hopper::named_bar_sync(kBarPacked, 256);
}

template <int D>
__device__ __forceinline__ void take_ds(uint32_t (&df)[kBlockK / 16][4], const Layout<D>& l,
                                        int tid) {
#pragma unroll
  for (int k = 0; k < kBlockK / 16; ++k) {
    const uint4 u = l.packed(k / 2)[(k % 2) * 128 + tid];
    df[k][0] = u.x;
    df[k][1] = u.y;
    df[k][2] = u.z;
    df[k][3] = u.w;
  }
}

// Consumer kC: per item, its A operand (Q for consumer 0, dO for consumer 1)
// into registers; then per key tile t, S_t (consumer 0) or dP_t (consumer
// 1), its half of dS_t, and dQ[:, its columns] += dS_t K_t.
template <bool kBf16, int D, int kC>
__device__ __forceinline__ void consume(const Args& a, const Work& w, const Layout<D>& l) {
  using T = hopper::Tile<D, 64>;
  constexpr int N = Cols<D, kC>::kN;
  constexpr int col0 = Cols<D, kC>::k0;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const float scale_log2 = a.scale * kLog2e;
  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  const uint32_t k_cols = (col0 / T::kCols) * T::kBoxBytes;  // this consumer's first K column
  int T0 = 0;  // the global index of the item's first k tile
  for (int it = 0; it < w.n_items; ++it) {
    const int q0 = w.q0(it), n_tiles = Work::key_tiles(a, q0);
    const int r_local = 16 * warp + g;  // rows r_local, r_local + 8 of the tile
    const int row0 = q0 + r_local;
    const size_t first = (size_t)w.bh * a.q_len + q0;  // the tile's first row
    // Only tiles crossing the diagonal or the ragged k edge pay for the mask.
    auto masked = [&](int k0) {
      return (k0 + kBlockK > a.k_len) || (a.causal && k0 + kBlockK - 1 > q0);
    };
    uint32_t af[D / 16][4];
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    {
      uint4 raw[2][D / 32];
      load_chunks<D>(raw, (kC == 0 ? a.q : a.dout) + first * a.hd, a.q_len - q0, a.hd, r_local,
                     tg);
      if (kC == 1)
        chunk_delta<kBf16, D>(dl, raw, a.o + first * a.hd, a.q_len - q0, a.hd, r_local, tg);
      chunks_to_frags<D>(af, raw, tg);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row0 + 8 * i < a.q_len) lse2[i] = a.lse[first + r_local + 8 * i] * kLog2e;
    if (kC == 1 && tg == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < a.q_len) a.delta[first + r_local + 8 * i] = dl[i];
    }
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    float x[kBlockK / 2];
    uint32_t df[kBlockK / 16][4];
    auto issue = [&](int n) {
      hopper::mbar_wait(l.full_k(n), Layout<D>::par_k(n));
      if (kC == 1) hopper::mbar_wait(l.full_v(n), Layout<D>::par_v(n));
      issue_x<kBf16, D>(x, af, T::k_major(kC == 0 ? l.k(n) : l.v(n), 0));
    };
    float mine[16];
    uint32_t own[2][4];
    // Tile t's S or dP is done: V_t is free (consumer 1); the other
    // consumer's half goes out, this one's is kept.
    auto done_x = [&](int t) {
      hopper::fence_regs(x);
      if (kC == 1) release(l.empty_v(T0 + t));
      give_half<kC, D>(mine, x, dl, l, tid);
    };
    // This consumer's half of dS_t, to the other.
    auto form = [&](int t) {
      form_half<kBf16, kC, D>(own, mine, dl, lse2, masked(t * kBlockK), row0, t * kBlockK, tg,
                              a.k_len, a.causal, scale_log2, l, tid);
      hand_over<kC, D>(own, l, tid);
    };

    // Every wgmma group is retired at the end of each pass of the loop
    // below (ptxas serialises the products when groups stay in flight
    // across a loop's back edge). A pass takes two key tiles t and t + 1:
    // tile t + 1's S or dP is issued as soon as tile t's is read, and runs
    // with dQ += dS_{t-1} K_{t-1} while dS_t is formed; then dQ += dS_t K_t
    // runs while dS_{t+1} is formed. A last tile left over takes a pass of
    // its own.
    auto dq_product = [&](int n) {
      issue_dq<kBf16, D, N>(acc, df, T::mn_major(l.k(n) + k_cols));
    };
    auto dq_done = [&](int n) {
      hopper::fence_regs(acc);
      release(l.empty_k(n));
    };

    issue(T0);
    hopper::wgmma_wait<0>();
    done_x(0);
    form(0);
    take_ds<D>(df, l, tid);
    int t = 1;
    for (; t + 1 < n_tiles; t += 2) {
      const int n = T0 + t;
      issue(n);
      dq_product(n - 1);
      hopper::wgmma_wait<1>();
      done_x(t);
      issue(n + 1);
      form(t);
      hopper::wgmma_wait<1>();
      dq_done(n - 1);
      take_ds<D>(df, l, tid);
      dq_product(n);
      hopper::wgmma_wait<1>();
      done_x(t + 1);
      form(t + 1);
      hopper::wgmma_wait<0>();
      dq_done(n);
      take_ds<D>(df, l, tid);
    }
    if (t < n_tiles) {
      const int n = T0 + t;
      issue(n);
      dq_product(n - 1);
      hopper::wgmma_wait<1>();
      done_x(t);
      form(t);
      hopper::wgmma_wait<0>();
      dq_done(n - 1);
      take_ds<D>(df, l, tid);
    }
    dq_product(T0 + n_tiles - 1);
    hopper::wgmma_wait<0>();
    dq_done(T0 + n_tiles - 1);
    T0 += n_tiles;

    // dQ, scaled once, straight from the fragments (rows past q_len and
    // columns past hd are not written).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < a.q_len) {
        uint16_t* const out = a.dq + (first + r_local + 8 * i) * a.hd + col0;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int col = 8 * j + 2 * tg;
          if (col0 + col < a.hd)
            *reinterpret_cast<uint32_t*>(out + col) =
                pack2<kBf16>(acc[4 * j + 2 * i] * a.scale, acc[4 * j + 2 * i + 1] * a.scale);
        }
      }
    }
  }
}

template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const Args a) {
  using S = Smem<D>;
  using T = typename S::T;
  extern __shared__ uint8_t smem_raw[];
  Layout<D> l;
  l.base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  l.base_ptr = smem_raw + (l.base - hopper::smem_u32(smem_raw));

  const int n_qt = (a.q_len + kBlockQ - 1) / kBlockQ;
  const flash::Schedule sch =
      flash::schedule(blockIdx.x, n_qt, a.n_heads, a.singles, /*heavy_first=*/false);
  const Work w{sch.head, sch.tile_b >= 0 ? 2 : 1, sch.tile_a, sch.tile_b};

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStagesK; ++s) {
      hopper::mbar_init(l.full_k(s), 1);
      hopper::mbar_init(l.empty_k(s), kConsumers * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < S::kStagesV; ++s) {
      hopper::mbar_init(l.full_v(s), 1);
      hopper::mbar_init(l.empty_v(s), 4);  // consumer 1's warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // The role is read through a shuffle so that the compiler sees it is
  // uniform across the warp, which setmaxnreg's per-role register budgets
  // need.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // ---- producer: K and V tiles through their rings -----------------
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      const int kv_row = (w.bh / a.H) * a.KV + (w.bh % a.H) / (a.H / a.KV);
      hopper::prefetch_map(&tm_k);
      hopper::prefetch_map(&tm_v);
      int n = 0;  // k tiles loaded so far, over both items
      for (int it = 0; it < w.n_items; ++it) {
        const int n_tiles = Work::key_tiles(a, w.q0(it));
        for (int t = 0; t < n_tiles; ++t, ++n) {
          hopper::mbar_wait(l.empty_k(n), Layout<D>::par_k(n) ^ 1);
          hopper::mbar_arrive_expect_tx(l.full_k(n), T::kBytes);
#pragma unroll
          for (int b = 0; b < T::kBoxes; ++b)
            hopper::tma_load_3d(l.k(n) + b * T::kBoxBytes, &tm_k, l.full_k(n), b * T::kCols,
                                t * kBlockK, kv_row);
          hopper::mbar_wait(l.empty_v(n), Layout<D>::par_v(n) ^ 1);
          hopper::mbar_arrive_expect_tx(l.full_v(n), T::kBytes);
#pragma unroll
          for (int b = 0; b < T::kBoxes; ++b)
            hopper::tma_load_3d(l.v(n) + b * T::kBoxBytes, &tm_v, l.full_v(n), b * T::kCols,
                                t * kBlockK, kv_row);
        }
      }
    }
  } else {
    // ---- consumers ---------------------------------------------------
    hopper::reg_alloc<kConsumerRegs>();
    if (wg == 0) consume<kBf16, D, 0>(a, w, l);
    else consume<kBf16, D, 1>(a, w, l);
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq, void* delta, int batch, int heads, int kv_heads,
                   int q_len, int k_len, int hd, float scale, int causal, cudaStream_t stream) {
  constexpr int kCols = hopper::Tile<D, 64>::kCols;
  auto kernel = flash_bwd_dq_wide_kernel<kBf16, D>;
  static const cudaError_t ready = [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (err != cudaSuccess) return err;
    return hopper::check_register_pool(kernel, kThreads,
                                       128 * kProducerRegs + 128 * kConsumers * kConsumerRegs);
  }();
  if (ready != cudaSuccess) return ready;
  const int bh = batch * heads, bkv = batch * kv_heads;
  CUtensorMap mk, mv;
  cudaError_t err;
  if ((err = hopper::make_map_3d(&mk, k, kBf16, bkv, k_len, hd, kBlockK, kCols)) ||
      (err = hopper::make_map_3d(&mv, v, kBf16, bkv, k_len, hd, kBlockK, kCols)))
    return err;
  int singles, blocks;
  flash::schedule_size((q_len + kBlockQ - 1) / kBlockQ, bh, &singles, &blocks);
  const Args args{static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(o),
                  static_cast<const uint16_t*>(dout), static_cast<const float*>(lse),
                  static_cast<float*>(delta), static_cast<uint16_t*>(dq), heads, kv_heads,
                  q_len, k_len, hd, scale, causal, bh, singles};
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(mk, mv, args);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dq, void* delta, int batch,
                     int heads, int kv_heads, int q_len, int k_len, int hd, float scale,
                     int causal, cudaStream_t stream) {
  if (hd <= 192)
    return launch<kBf16, 192>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads, q_len,
                              k_len, hd, scale, causal, stream);
  return launch<kBf16, 256>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads, q_len,
                            k_len, hd, scale, causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel up (shared memory, register pool, tensor maps), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_bwd_dq_wide(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* dq, void* delta,
                                 int batch, int heads, int kv_heads, int q_len, int k_len,
                                 int head_dim, float scale, int causal, int is_bf16,
                                 void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
      k_len <= 0 || head_dim % 8 != 0 || head_dim < 129 || head_dim > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<true>(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads,
                                        q_len, k_len, head_dim, scale, causal, s)
                       : dispatch<false>(q, k, v, o, dout, lse, dq, delta, batch, heads,
                                         kv_heads, q_len, k_len, head_dim, scale, causal, s));
}
