// Flash-attention backward, dQ, for Hopper (sm_90a), bound through a
// plain C entry point (loaded with ctypes by
// ray_tpu_torch/ops/attention.py:flash_bwd_dq_cuda). dK and dV are
// computed by csrc/flash_bwd_dkv.cu.
//
// It rebuilds the probabilities from the forward's fp32 (natural-log)
// logsumexp instead of re-running the softmax:
//   P  = exp(scale * Q K^T + mask - lse)       (masked entries underflow to 0)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O) (fp32,
//        computed by the wrapper as one torch op, as the JAX package does
//        outside Pallas)
//   dQ = scale * dS K
// with the forward's conventions: native GQA by index (K/V never
// repeated), top-left causal masking (q_id >= k_id), ragged q_len/k_len
// masked in-kernel with zero-filled shared tiles, and the finite mask
// value so a fully masked entry never computes inf - inf. All products run
// on the tensor cores (mma.sync m16n8k16, fp32 accumulators); dS is
// rounded to the input dtype as the A operand of its product, as the
// forward rounds P.
//
// Layout at the boundary: q, do, dq [b*H, q_len, hd]; k, v [b*KV, k_len,
// hd]; lse, delta fp32 [b*H, q_len]; all contiguous, bf16 or fp16, hd a
// multiple of 16 up to 128.
//
// flash_bwd_dq_kernel replaces ray_tpu/ops/attention.py:_flash_bwd_dq_kernel.
//   One 128-thread block per (b*H, 64-row q tile), each warp owning 16 query
//   rows; a loop over 64-row K/V tiles up to the causal diagonal (the TPU
//   kernel's sequential k-block loop). The dQ tile stays in fp32 registers
//   for the whole loop and is written once.
//
// What bounds it on an H100. At the training shape ([12, 18, 2048, 128],
// causal) dQ does 6*hd FLOPs per kept (q, k) pair (three products: S, dP,
// dQ): 0.35 ms at 989 TFLOP/s, against 0.17 ms of bytes at 3.35 TB/s:
// tensor-core bound. The design keeps every S x S quantity (S, P, dP, dS)
// in registers and streams K/V through shared memory, once per tile. It is
// the simple first version: synchronous staging through registers, no
// cp.async/TMA pipelining, no wgmma, K^T written by scalar stores
// (168 registers at hd 128, no spills). Its Hopper redesign is the next
// kernel step (flash_fwd.cu and flash_bwd_dkv.cu show the shape).

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::kMaskValue;
using flash::load_a;
using flash::load_b;
using flash::load_tile;
using flash::mma16816;
using flash::pack2;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// dQ kernel tiles: 64 query rows (16 a warp) x 64-key steps.
constexpr int kDqBlockQ = kWarps * 16;
constexpr int kDqBlockK = 64;

template <int D>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO [kDqBlockQ][D+8]; sK, sV [kDqBlockK][D+8]; sKt [D][kDqBlockK+8].
  return (size_t)(2 * kDqBlockQ * (D + 8) + 2 * kDqBlockK * (D + 8) + D * (kDqBlockK + 8)) * 2;
}

// D is head_dim rounded up to 32, 64 or 128; columns in [hd, D) are
// zero-filled in shared memory and never stored.
template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int H, int KV, int q_len, int k_len, int hd,
                    float scale, int causal) {
  constexpr int BQ = kDqBlockQ, BK = kDqBlockK;
  constexpr int LD = D + 8, LDT = BK + 8;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sdO = sQ + BQ * LD;
  uint16_t* sK = sdO + BQ * LD;
  uint16_t* sV = sK + BK * LD;
  uint16_t* sKt = sV + BK * LD;

  const int bh = blockIdx.y;
  // Reverse tile order: under causal masking the last q tiles do the most
  // work, so they start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kv_row = (bh / H) * KV + (bh % H) / (H / KV);
  const uint16_t* kb = k + (size_t)kv_row * k_len * hd;
  const uint16_t* vb = v + (size_t)kv_row * k_len * hd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wrow = warp * 16;

  load_tile<BQ, D, kThreads, true, false>(sQ, nullptr, q + (size_t)bh * q_len * hd, q0, q_len,
                                          hd, tid);
  load_tile<BQ, D, kThreads, true, false>(sdO, nullptr, dout + (size_t)bh * q_len * hd, q0,
                                          q_len, hd, tid);
  // Rows g and g + 8 of the warp's 16: their lse and delta.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    const bool in = row < q_len;
    lse_r[i] = in ? lse[(size_t)bh * q_len + row] : 0.f;
    delta_r[i] = in ? delta[(size_t)bh * q_len + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  // Causal: keys beyond the tile's last row never contribute.
  const int k_end = causal ? min(k_len, q0 + BQ) : k_len;
  const int n_tiles = (k_end + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<BK, D, kThreads, true, true>(sK, sKt, kb, k0, k_len, hd, tid);
    load_tile<BK, D, kThreads, true, false>(sV, nullptr, vb, k0, k_len, hd, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, sQ, LD, wrow, kk * 16, g, tg);
      load_a(ado, sdO, LD, wrow, kk * 16, g, tg);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t bk[2], bv[2];
        load_b(bk, sK, LD, n * 8, kk * 16, g, tg);
        load_b(bv, sV, LD, n * 8, kk * 16, g, tg);
        mma16816<kBf16>(s[n], aq, bk);
        mma16816<kBf16>(dp[n], ado, bv);
      }
    }
    // dS = P * (dP - delta), kept in dp. Only tiles crossing the diagonal
    // or the ragged K edge pay for the mask.
    const bool masked = (k0 + BK > k_len) || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int row = q0 + wrow + g + (e >> 1) * 8;
          const int col = k0 + n * 8 + tg * 2 + (e & 1);
          if (col >= k_len || (causal && row < col)) x = kMaskValue;
        }
        const float p = expf(x - lse_r[e >> 1]);
        dp[n][e] = p * (dp[n][e] - delta_r[e >> 1]);
      }
    }
    // dQ += dS K: two adjacent dS n-tiles are one A fragment; K^T in
    // shared memory gives the B fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t af[4] = {
          pack2<kBf16>(dp[2 * kk][0], dp[2 * kk][1]),
          pack2<kBf16>(dp[2 * kk][2], dp[2 * kk][3]),
          pack2<kBf16>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack2<kBf16>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint32_t b[2];
        load_b(b, sKt, LDT, dn * 8, kk * 16, g, tg);
        mma16816<kBf16>(acc[dn], af, b);
      }
    }
  }

  // Rows past q_len (the partial last tile) are never written.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row < q_len) {
      uint16_t* out = dq + ((size_t)bh * q_len + row) * hd;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + tg * 2;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(out + col) =
              pack2<kBf16>(acc[dn][2 * i] * scale, acc[dn][2 * i + 1] * scale);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int batch, heads, kv_heads, q_len, k_len, hd;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <bool kBf16, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<kBf16, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.q_len + kDqBlockQ - 1) / kDqBlockQ, a.batch * a.heads);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<const uint16_t*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<uint16_t*>(a.dq), a.heads, a.kv_heads, a.q_len, a.k_len, a.hd, a.scale,
      a.causal);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch_hd(const Args& a) {
  if (a.hd <= 32) return launch_dq<kBf16, 32>(a);
  if (a.hd <= 64) return launch_dq<kBf16, 64>(a);
  return launch_dq<kBf16, 128>(a);
}

bool valid(const Args& a) {
  return a.batch > 0 && a.heads > 0 && a.kv_heads > 0 && a.heads % a.kv_heads == 0 &&
         a.q_len > 0 && a.k_len > 0 && a.hd > 0 && a.hd % 16 == 0 && a.hd <= 128 &&
         (long long)a.batch * a.heads <= 65535;
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int batch, int heads,
                            int kv_heads, int q_len, int k_len, int head_dim, float scale,
                            int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, batch, heads, kv_heads,
               q_len, k_len, head_dim, scale, causal, static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch_hd<true>(a) : dispatch_hd<false>(a));
}
