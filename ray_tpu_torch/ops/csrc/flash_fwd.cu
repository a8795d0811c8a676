// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// entry point (loaded with ctypes by ray_tpu_torch/ops/attention.py).
//
// Replaces: ray_tpu/ops/attention.py:_flash_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward). It computes the same function:
//   O   = softmax(scale * Q K^T + mask) V      (O in the input dtype)
//   lse = m + log(max(l, 1e-30))               (fp32, per query row)
// with an fp32 online softmax (m, l, acc), native GQA (the kv row of
// program bh is (bh / H) * KV + (bh % H) / (H / KV); K/V are never
// repeated), top-left causal masking (q_id >= k_id) with the k loop
// stopping at the diagonal, ragged q_len/k_len masked in-kernel, the
// scale applied to the fp32 scores, and l clamped at 1e-30.
//
// Layout at the boundary: q, o [b*H, q_len, hd]; k, v [b*KV, k_len, hd];
// lse [b*H, q_len]; all contiguous, bf16 or fp16, hd a multiple of 16
// up to 128.
//
// What bounds it on an H100: causal FLOPs ~ 2 * 2 * S^2 * hd * H / 2 and
// bytes ~ 4 * S * H * hd * 2 (q, k, v, o in 16 bits). At the serving
// prefill shapes ([1, 32, S, 128]) that is memory for short prompts and
// tensor-core throughput for long ones (S=1024: 8.6 GFLOP vs 33.6 MB).
// The design keeps the S x S scores out of device memory (one pass over
// K/V per 64-row query tile, scores and probabilities live in registers)
// and runs both products on the tensor cores (mma.sync m16n8k16, fp32
// accumulators). It is the simple first version: one 128-thread block per
// (b*H, 64-row q tile), 64-row K/V tiles staged synchronously in shared
// memory (V transposed on the way in), no cp.async/TMA pipelining, no
// wgmma, no warp specialisation. The probabilities are rounded to the
// input dtype for the P V product (the row sum l stays fp32).

#include <math.h>

#include "flash_common.cuh"

namespace {

using flash::kMaskValue;
using flash::ld32;
using flash::mma16816;
using flash::pack2;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;  // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;

template <int D>
constexpr size_t smem_bytes() {
  // sQ [kBlockQ][D+8] + sK [kBlockK][D+8] + sVt [D][kBlockK+8], 16-bit.
  return (size_t)(kBlockQ * (D + 8) + kBlockK * (D + 8) + D * (kBlockK + 8)) * 2;
}

// D is head_dim rounded up to 32, 64 or 128; columns in [hd, D) are
// zero-filled in shared memory and never stored.
template <bool kBf16, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int q_len, int k_len,
                 int hd, float scale, int causal) {
  constexpr int LD = D + 8;         // padded row stride of sQ/sK (no bank conflicts)
  constexpr int LDV = kBlockK + 8;  // padded row stride of the transposed V tile
  constexpr int kChunks = D / 8;    // 16-byte chunks per row
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sK = sQ + kBlockQ * LD;
  uint16_t* sVt = sK + kBlockK * LD;

  const int bh = blockIdx.y;
  // Reverse tile order: under causal masking the last q tiles do the most
  // work, so they start first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int kv_row = (bh / H) * KV + (bh % H) / (H / KV);
  const uint16_t* qb = q + (size_t)bh * q_len * hd;
  const uint16_t* kb = k + (size_t)kv_row * k_len * hd;
  const uint16_t* vb = v + (size_t)kv_row * k_len * hd;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group / column pair
  const int wrow = warp * 16;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < q_len && col < hd)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * hd + col);
    *reinterpret_cast<uint4*>(sQ + r * LD + col) = val;
  }
  __syncthreads();

  uint32_t qf[D / 16][4];  // this warp's 16 query rows as mma A fragments
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint16_t* p = sQ + (wrow + g) * LD + kk * 16 + tg * 2;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  // Rows g and g + 8 of the warp's 16: running max and row sum.
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  // Causal: keys beyond the tile's last row never contribute.
  const int k_end = causal ? min(k_len, q0 + kBlockQ) : k_len;
  const int n_tiles = (k_end + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 k4 = zero, v4 = zero;
      if (k0 + r < k_len && col < hd) {
        const size_t off = (size_t)(k0 + r) * hd + col;
        k4 = *reinterpret_cast<const uint4*>(kb + off);
        v4 = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + col) = k4;
      const uint16_t* ve = reinterpret_cast<const uint16_t*>(&v4);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(col + i) * LDV + r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* p = sK + (n * 8 + g) * LD + kk * 16 + tg * 2;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma16816<kBf16>(s[n], qf[kk], bf);
      }
    }
    // Only tiles crossing the diagonal or the ragged K edge pay for the mask.
    const bool masked = (k0 + kBlockK > k_len) || (causal && k0 + kBlockK - 1 > q0);
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int row = q0 + wrow + g + (e >> 1) * 8;
          const int col = k0 + n * 8 + tg * 2 + (e & 1);
          if (col >= k_len || (causal && row < col)) x = kMaskValue;
        }
        s[n][e] = x;
      }
    }
    // Online softmax. The mask value is finite, so m is finite after the
    // first tile and exp never sees (-inf) - (-inf).
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx);
      corr[i] = expf(m_i[i] - m_new);
      m_i[i] = m_new;
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_i[e >> 1]);
        row_sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 1);
      row_sum[i] += __shfl_xor_sync(0xffffffffu, row_sum[i], 2);
      l_i[i] = l_i[i] * corr[i] + row_sum[i];
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }
    // acc += P V: the S accumulators of two adjacent n-tiles are exactly
    // one A fragment of P (16 rows x 16 keys).
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pf[4] = {
          pack2<kBf16>(s[2 * kk][0], s[2 * kk][1]),
          pack2<kBf16>(s[2 * kk][2], s[2 * kk][3]),
          pack2<kBf16>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<kBf16>(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* p = sVt + (dn * 8 + g) * LDV + kk * 16 + tg * 2;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma16816<kBf16>(acc[dn], pf, bf);
      }
    }
  }

  // Rows past q_len (the partial last tile) are never written.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row < q_len) {
      const float l = fmaxf(l_i[i], 1e-30f);
      uint16_t* orow = o + ((size_t)bh * q_len + row) * hd;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + tg * 2;
        if (col < hd)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack2<kBf16>(acc[dn][2 * i] / l, acc[dn][2 * i + 1] / l);
      }
      if (tg == 0) lse[(size_t)bh * q_len + row] = m_i[i] + logf(l);
    }
  }
}

template <bool kBf16, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int batch, int heads, int kv_heads, int q_len, int k_len, int hd,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<kBf16, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + kBlockQ - 1) / kBlockQ, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), heads, kv_heads, q_len, k_len, hd, scale, causal);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
                     int batch, int heads, int kv_heads, int q_len, int k_len, int hd,
                     float scale, int causal, cudaStream_t stream) {
  if (hd <= 32)
    return launch<kBf16, 32>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale, causal, stream);
  if (hd <= 64)
    return launch<kBf16, 64>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale, causal, stream);
  return launch<kBf16, 128>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale, causal, stream);
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for shapes the kernel does not take (the Python
// wrapper validates first; this is the last line of defence).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                         int batch, int heads, int kv_heads, int q_len, int k_len,
                         int head_dim, float scale, int causal, int is_bf16,
                         void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      q_len <= 0 || k_len <= 0 || head_dim <= 0 || head_dim % 16 != 0 ||
      head_dim > 128 || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<true>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, head_dim, scale, causal, s)
              : dispatch<false>(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, head_dim, scale, causal, s);
  return (int)err;
}
