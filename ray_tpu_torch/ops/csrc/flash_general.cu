// Flash attention for the inputs the Hopper kernels do not take, bound
// through plain C entry points (loaded with ctypes by
// ray_tpu_torch/ops/attention.py): fp32 inputs, and head dims that are not
// a multiple of 16 or lie between 129 and 256, in fp32, bf16 or fp16.
//
// Replaces the same three Pallas TPU kernels as flash_fwd.cu, flash_bwd.cu
// and flash_bwd_dkv.cu, for every shape and type they take and those do not
// (ray_tpu/ops/attention.py):
//   general_fwd  <- _flash_fwd_kernel:      O = softmax(scale Q K^T + mask) V,
//                                           lse = m + log(max(l, 1e-30)) (fp32)
//   general_dq   <- _flash_bwd_dq_kernel:   dQ = scale sum_j dS_j K_j with
//                   dS = P (dO V^T - Delta), P = exp(scale Q K^T - lse), and
//                   Delta = rowsum(dO O), which it writes for general_dkv
//                   (an XLA fusion in the reference)
//   general_dkv  <- _flash_bwd_dkv_kernel:  dV = sum_i P_i^T dO_i,
//                   dK = scale sum_i dS_i^T Q_i, summed over the GQA group
// Like the Pallas kernels, every element is upcast to fp32 and every
// product, exponent and sum is fp32 (P and dS are never rounded); outputs
// are rounded once to the input type. GQA is native (the kv row of q row bh
// is (bh / H) * KV + (bh % H) / (H / KV)), the causal mask is top-left
// (q_id >= k_id), masked scores take the reference's finite mask value,
// and ragged lengths are masked in-kernel.
//
// Layout at the boundary: q, o, dO, dQ [b*H, q_len, hd]; k, v, dK, dV
// [b*KV, k_len, hd]; lse, Delta [b*H, q_len] fp32; all contiguous. Any
// head dim from 1 to 256 and any b*H (a one-dimensional grid, 64-bit
// offsets).
//
// Design: SIMT fp32 FMAs, no tensor cores. A block holds 16 rows of its
// own side (queries, or keys for dK/dV) in shared memory as fp32, 4 to
// each of its 4 warps (the forward at head dim 256: 32 rows, 8 a warp),
// and walks the other side in tiles of 32 rows staged in shared memory by
// 16-byte loads. For a tile, lane j takes row j of the tile and forms its
// rows' dot products over the head dim (float4 loads; rows padded by 4
// floats so that lanes hit distinct banks); the per-row softmax terms go
// through shared memory, and each lane then accumulates head-dim columns
// lane, lane + 32, ... of its rows in registers (at most 8 columns a row:
// 64 fp32 accumulators a lane for dK and dV at head dim 256). Nothing is
// reduced across blocks, so there are no atomics. The heaviest blocks are
// scheduled first under the causal mask.
//
// What bounds it on an H100: fp32 FMAs at 67 TFLOP/s, and in practice the
// shared-memory loads that feed them (one float4 of the tile row and one
// broadcast float4 a block row for every 4 FMAs a row), and the tile loads,
// which nothing overlaps with the FMAs. A tensor-core instantiation at head
// dim 256 and an fp32-input route through TF32 or bf16x3 wgmma are later
// work (ROADMAP).
#include "flash_common.cuh"

#include <math.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                     // rows of the block's side a warp owns
constexpr int kBlockRows = kWarps * kRows;   // 16
constexpr int kTile = 32;                    // rows of the other side a tile: one a lane
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The two 16-bit values of a word (the lower address in the lower half)
// as fp32.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
  } else {
    return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(x & 0xffffu))),
                       __half2float(__ushort_as_half(static_cast<unsigned short>(x >> 16))));
  }
}

// A 16-byte chunk of T (4 fp32, or 8 bf16 or fp16) stored as fp32 at d,
// unpacked from the loaded words without a trip through local memory.
template <typename T>
__device__ __forceinline__ void store_chunk(float* d, uint4 w) {
  if constexpr (std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(d) = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                                                __uint_as_float(w.z), __uint_as_float(w.w));
  } else {
    const float2 a = unpack2<T>(w.x), b = unpack2<T>(w.y);
    const float2 c = unpack2<T>(w.z), e = unpack2<T>(w.w);
    *reinterpret_cast<float4*>(d) = make_float4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<float4*>(d + 4) = make_float4(c.x, c.y, e.x, e.y);
  }
}

// Shared-memory layout of a head-dim bucket D (32, 64, 128 or 256): rows of
// S = D + 4 floats, so that 16-byte loads by neighbouring lanes of
// neighbouring rows fall in distinct banks.
template <int D>
struct Rows {
  static constexpr int S = D + 4;
  static constexpr int kCols = D / 32;  // accumulator columns a lane
  // Query rows a warp in the forward: 8 at head dim 256, where the shared-
  // memory loads that feed the FMAs limit it (a K element read serves 8
  // rows), 4 below (more blocks for short sequences).
  static constexpr int kFwdRows = D == 256 ? 8 : 4;
};

// Rows [0, n_rows) of a tile into shared memory as fp32: rows past n_valid
// and columns in [hd, round_up(hd, 32)) are zero, so that dot products and
// column accumulators over the padded width add nothing. With rows of whole
// 16-byte vectors from a 16-byte aligned source, each thread moves a
// 16-byte chunk a load (neighbouring threads, neighbouring chunks);
// otherwise one element.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int n_valid, int n_rows,
                                          int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const int cols = (hd + 31) & ~31;
  if (hd % kVec == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int chunks = cols / kVec;  // a row's chunks, the padding's included
    for (int idx = threadIdx.x; idx < n_rows * chunks; idx += kThreads) {
      const int r = idx / chunks, c = (idx - r * chunks) * kVec;
      float* d = dst + r * Rows<D>::S + c;
      if (r < n_valid && c < hd) {
        store_chunk<T>(d, *reinterpret_cast<const uint4*>(src + (long long)r * hd + c));
      } else {
#pragma unroll
        for (int i = 0; i < kVec; i += 4)
          *reinterpret_cast<float4*>(d + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < n_rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * Rows<D>::S + c] =
        (r < n_valid && c < hd) ? to_f<T>(src[(long long)r * hd + c]) : 0.f;
  }
}

// ---- forward -------------------------------------------------------------

template <int D>
constexpr int fwd_smem_floats() {
  return (kWarps * Rows<D>::kFwdRows + 2 * kTile) * Rows<D>::S +
         kWarps * Rows<D>::kFwdRows * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
general_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, float* __restrict__ lse, int H, int KV, int q_len, int k_len,
            int hd, float scale, int causal, long long n_bh) {
  constexpr int S = Rows<D>::S, C = Rows<D>::kCols;
  constexpr int kRows = Rows<D>::kFwdRows, kBlockRows = kWarps * kRows;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // kBlockRows x S
  float* sK = sQ + kBlockRows * S;              // kTile x S
  float* sV = sK + kTile * S;                   // kTile x S
  float* sP = sV + kTile * S;                   // kWarps x kRows x kTile

  const int n_qb = (q_len + kBlockRows - 1) / kBlockRows;
  const long long bh = blockIdx.x % n_bh;
  const int q0 = (n_qb - 1 - (int)(blockIdx.x / n_bh)) * kBlockRows;  // last rows first
  const long long kv_bh = (bh / H) * KV + (bh % H) / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int hd4 = (hd + 3) & ~3, n_cols = (hd + 31) / 32;
  float* wP = sP + warp * kRows * kTile;

  load_rows<D>(sQ, q + (bh * q_len + q0) * hd, min(kBlockRows, q_len - q0), kBlockRows, hd);

  float m[kRows], l[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int i = 0; i < C; ++i) acc[r][i] = 0.f;
  }

  const int k_end = causal ? min(k_len, q0 + kBlockRows) : k_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    const int n_valid = min(kTile, k_len - k0);
    load_rows<D>(sK, k + (kv_bh * k_len + k0) * hd, n_valid, kTile, hd);
    load_rows<D>(sV, v + (kv_bh * k_len + k0) * hd, n_valid, kTile, hd);
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* k_row = sK + lane * S;
    for (int d = 0; d < hd4; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(k_row + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        s[r] = dot4(*reinterpret_cast<const float4*>(sQ + (r0 + r) * S + d), k4, s[r]);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
      const float sr =
          (key < k_len && !(causal && key > row)) ? s[r] * scale : flash::kMaskValue;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile (m = -inf)
      const float p = expf(sr - m_new);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < C; ++i) acc[r][i] *= alpha;
      wP[r * kTile + lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < kTile; j += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p4[r] = *reinterpret_cast<const float4*>(wP + r * kTile + j);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < n_cols) {
          const int c = lane + 32 * i;
          const float v0 = sV[j * S + c], v1 = sV[(j + 1) * S + c];
          const float v2 = sV[(j + 2) * S + c], v3 = sV[(j + 3) * S + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][i] = dot4(p4[r], make_float4(v0, v1, v2, v3), acc[r][i]);
        }
      }
    }
    __syncwarp();  // wP is read before the next tile writes it
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    const float l_row = fmaxf(warp_sum(l[r]), 1e-30f);
    if (row < q_len) {
      const float inv = 1.f / l_row;
      T* o_row = o + (bh * q_len + row) * hd;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = lane + 32 * i;
        if (c < hd) o_row[c] = from_f<T>(acc[r][i] * inv);
      }
      if (lane == 0) lse[bh * q_len + row] = m[r] + logf(l_row);
    }
  }
}

// ---- dQ (and Delta) ------------------------------------------------------

template <int D>
constexpr int dq_smem_floats() {
  return (2 * kBlockRows + 2 * kTile) * Rows<D>::S + kWarps * kRows * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
general_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
           T* __restrict__ dq, float* __restrict__ delta, int H, int KV, int q_len, int k_len,
           int hd, float scale, int causal, long long n_bh) {
  constexpr int S = Rows<D>::S, C = Rows<D>::kCols;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // kBlockRows x S
  float* sG = sQ + kBlockRows * S;              // dO, kBlockRows x S
  float* sK = sG + kBlockRows * S;              // kTile x S
  float* sV = sK + kTile * S;                   // kTile x S
  float* sP = sV + kTile * S;                   // dS, kWarps x kRows x kTile

  const int n_qb = (q_len + kBlockRows - 1) / kBlockRows;
  const long long bh = blockIdx.x % n_bh;
  const int q0 = (n_qb - 1 - (int)(blockIdx.x / n_bh)) * kBlockRows;
  const long long kv_bh = (bh / H) * KV + (bh % H) / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int hd4 = (hd + 3) & ~3, n_cols = (hd + 31) / 32;
  float* wP = sP + warp * kRows * kTile;

  const int n_rows = min(kBlockRows, q_len - q0);
  load_rows<D>(sQ, q + (bh * q_len + q0) * hd, n_rows, kBlockRows, hd);
  load_rows<D>(sG, dout + (bh * q_len + q0) * hd, n_rows, kBlockRows, hd);
  __syncthreads();

  // Delta = rowsum(dO O) and lse of this warp's rows.
  float dl[kRows], ls[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    float part = 0.f;
    if (row < q_len) {
      const T* o_row = o + (bh * q_len + row) * hd;
      for (int c = lane; c < hd; c += 32)
        part = fmaf(sG[(r0 + r) * S + c], to_f<T>(o_row[c]), part);
    }
    dl[r] = warp_sum(part);
    ls[r] = row < q_len ? lse[bh * q_len + row] : 0.f;
    if (lane == 0 && row < q_len) delta[bh * q_len + row] = dl[r];
#pragma unroll
    for (int i = 0; i < C; ++i) acc[r][i] = 0.f;
  }

  const int k_end = causal ? min(k_len, q0 + kBlockRows) : k_len;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    const int n_valid = min(kTile, k_len - k0);
    load_rows<D>(sK, k + (kv_bh * k_len + k0) * hd, n_valid, kTile, hd);
    load_rows<D>(sV, v + (kv_bh * k_len + k0) * hd, n_valid, kTile, hd);
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* k_row = sK + lane * S;
    const float* v_row = sV + lane * S;
    for (int d = 0; d < hd4; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(k_row + d);
      const float4 v4 = *reinterpret_cast<const float4*>(v_row + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = dot4(*reinterpret_cast<const float4*>(sQ + (r0 + r) * S + d), k4, s[r]);
        dp[r] = dot4(*reinterpret_cast<const float4*>(sG + (r0 + r) * S + d), v4, dp[r]);
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
      const bool keep = key < k_len && row < q_len && !(causal && key > row);
      const float p = keep ? expf(s[r] * scale - ls[r]) : 0.f;
      wP[r * kTile + lane] = p * (dp[r] - dl[r]);
    }
    __syncwarp();
    for (int j = 0; j < kTile; j += 4) {
      float4 ds4[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) ds4[r] = *reinterpret_cast<const float4*>(wP + r * kTile + j);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (i < n_cols) {
          const int c = lane + 32 * i;
          const float4 k4 = make_float4(sK[j * S + c], sK[(j + 1) * S + c], sK[(j + 2) * S + c],
                                        sK[(j + 3) * S + c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][i] = dot4(ds4[r], k4, acc[r][i]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row < q_len) {
      T* dq_row = dq + (bh * q_len + row) * hd;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = lane + 32 * i;
        if (c < hd) dq_row[c] = from_f<T>(acc[r][i] * scale);
      }
    }
  }
}

// ---- dK/dV ---------------------------------------------------------------

template <int D>
constexpr int dkv_smem_floats() {
  return (2 * kBlockRows + 2 * kTile) * Rows<D>::S + 2 * kWarps * kRows * kTile + 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
general_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
            int KV, int q_len, int k_len, int hd, float scale, int causal, long long n_bkv) {
  constexpr int S = Rows<D>::S, C = Rows<D>::kCols;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // kBlockRows x S
  float* sV = sK + kBlockRows * S;              // kBlockRows x S
  float* sQ = sV + kBlockRows * S;              // kTile x S
  float* sG = sQ + kTile * S;                   // dO, kTile x S
  float* sP = sG + kTile * S;                   // P, kWarps x kRows x kTile
  float* sS = sP + kWarps * kRows * kTile;      // dS, kWarps x kRows x kTile
  float* sL = sS + kWarps * kRows * kTile;      // lse of the tile's rows
  float* sD = sL + kTile;                       // Delta of the tile's rows

  const long long bkv = blockIdx.x % n_bkv;
  const int k0 = (int)(blockIdx.x / n_bkv) * kBlockRows;  // first keys (most queries) first
  const long long b = bkv / KV;
  const int kvh = (int)(bkv % KV), G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * kRows;
  const int hd4 = (hd + 3) & ~3, n_cols = (hd + 31) / 32;
  float* wP = sP + warp * kRows * kTile;
  float* wS = sS + warp * kRows * kTile;

  const int n_keys = min(kBlockRows, k_len - k0);
  load_rows<D>(sK, k + (bkv * k_len + k0) * hd, n_keys, kBlockRows, hd);
  load_rows<D>(sV, v + (bkv * k_len + k0) * hd, n_keys, kBlockRows, hd);

  float acc_k[kRows][C], acc_v[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < C; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  // Causal: only queries at or after the block's first key see it.
  const int i_start = causal ? (k0 / kTile) * kTile : 0;
  for (int g = 0; g < G; ++g) {
    const long long bh = b * H + (long long)kvh * G + g;
    for (int i0 = i_start; i0 < q_len; i0 += kTile) {
      __syncthreads();
      const int n_valid = min(kTile, q_len - i0);
      load_rows<D>(sQ, q + (bh * q_len + i0) * hd, n_valid, kTile, hd);
      load_rows<D>(sG, dout + (bh * q_len + i0) * hd, n_valid, kTile, hd);
      if (threadIdx.x < kTile) {
        const bool ok = (int)threadIdx.x < n_valid;
        sL[threadIdx.x] = ok ? lse[bh * q_len + i0 + threadIdx.x] : 0.f;
        sD[threadIdx.x] = ok ? delta[bh * q_len + i0 + threadIdx.x] : 0.f;
      }
      __syncthreads();

      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
      const float* q_row = sQ + lane * S;
      const float* g_row = sG + lane * S;
      for (int d = 0; d < hd4; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(q_row + d);
        const float4 g4 = *reinterpret_cast<const float4*>(g_row + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r] = dot4(q4, *reinterpret_cast<const float4*>(sK + (r0 + r) * S + d), s[r]);
          dp[r] = dot4(g4, *reinterpret_cast<const float4*>(sV + (r0 + r) * S + d), dp[r]);
        }
      }
      const int qi = i0 + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = k0 + r0 + r;
        const bool keep = qi < q_len && key < k_len && !(causal && key > qi);
        const float p = keep ? expf(s[r] * scale - sL[lane]) : 0.f;
        wP[r * kTile + lane] = p;
        wS[r * kTile + lane] = p * (dp[r] - sD[lane]);
      }
      __syncwarp();
      for (int j = 0; j < kTile; j += 4) {
        float4 p4[kRows], ds4[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(wP + r * kTile + j);
          ds4[r] = *reinterpret_cast<const float4*>(wS + r * kTile + j);
        }
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (i < n_cols) {
            const int c = lane + 32 * i;
            const float4 g4 = make_float4(sG[j * S + c], sG[(j + 1) * S + c],
                                          sG[(j + 2) * S + c], sG[(j + 3) * S + c]);
            const float4 q4 = make_float4(sQ[j * S + c], sQ[(j + 1) * S + c],
                                          sQ[(j + 2) * S + c], sQ[(j + 3) * S + c]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc_v[r][i] = dot4(p4[r], g4, acc_v[r][i]);
              acc_k[r][i] = dot4(ds4[r], q4, acc_k[r][i]);
            }
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + r0 + r;
    if (key < k_len) {
      T* dk_row = dk + (bkv * k_len + key) * hd;
      T* dv_row = dv + (bkv * k_len + key) * hd;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = lane + 32 * i;
        if (c < hd) {
          dk_row[c] = from_f<T>(acc_k[r][i] * scale);
          dv_row[c] = from_f<T>(acc_v[r][i]);
        }
      }
    }
  }
}

// ---- launchers -----------------------------------------------------------

// Opt in to the kernel's dynamic shared memory once (above 48 KB at head
// dim 256), then launch it on a one-dimensional grid.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int smem_floats, long long blocks, cudaStream_t stream,
                   Args... args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int bytes = smem_floats * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                int heads, int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                cudaStream_t stream) {
  constexpr int kBlockRows = kWarps * Rows<D>::kFwdRows;
  const long long n_bh = (long long)batch * heads;
  const long long blocks = n_bh * ((q_len + kBlockRows - 1) / kBlockRows);
  return launch(general_fwd<T, D>, fwd_smem_floats<D>(), blocks, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), heads, kv_heads, q_len, k_len, hd,
                scale, causal, n_bh);
}

template <typename T, int D>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq_out, void* delta, int batch, int heads, int kv_heads,
               int q_len, int k_len, int hd, float scale, int causal, cudaStream_t stream) {
  const long long n_bh = (long long)batch * heads;
  const long long blocks = n_bh * ((q_len + kBlockRows - 1) / kBlockRows);
  return launch(general_dq<T, D>, dq_smem_floats<D>(), blocks, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(o), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<T*>(dq_out),
                static_cast<float*>(delta), heads, kv_heads, q_len, k_len, hd, scale, causal,
                n_bh);
}

template <typename T, int D>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int batch, int heads, int kv_heads,
                int q_len, int k_len, int hd, float scale, int causal, cudaStream_t stream) {
  const long long n_bkv = (long long)batch * kv_heads;
  const long long blocks = n_bkv * ((k_len + kBlockRows - 1) / kBlockRows);
  return launch(general_dkv<T, D>, dkv_smem_floats<D>(), blocks, stream,
                static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
                heads, kv_heads, q_len, k_len, hd, scale, causal, n_bkv);
}

// The element type (0 fp32, 1 bf16, 2 fp16) and the head-dim bucket.
#define FLASH_GENERAL_DISPATCH(FN, ...)                                          \
  if (dtype == 0) {                                                            \
    if (hd <= 32) return FN<float, 32>(__VA_ARGS__);                             \
    if (hd <= 64) return FN<float, 64>(__VA_ARGS__);                             \
    if (hd <= 128) return FN<float, 128>(__VA_ARGS__);                           \
    return FN<float, 256>(__VA_ARGS__);                                          \
  }                                                                              \
  if (dtype == 1) {                                                              \
    if (hd <= 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__);                     \
    if (hd <= 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);                     \
    if (hd <= 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__);                   \
    return FN<__nv_bfloat16, 256>(__VA_ARGS__);                                  \
  }                                                                              \
  if (hd <= 32) return FN<__half, 32>(__VA_ARGS__);                              \
  if (hd <= 64) return FN<__half, 64>(__VA_ARGS__);                              \
  if (hd <= 128) return FN<__half, 128>(__VA_ARGS__);                            \
  return FN<__half, 256>(__VA_ARGS__)

bool bad_shape(int batch, int heads, int kv_heads, int q_len, int k_len, int hd, int dtype) {
  return batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || q_len <= 0 ||
         k_len <= 0 || hd <= 0 || hd > 256 || dtype < 0 || dtype > 2;
}

cudaError_t fwd_any(const void* q, const void* k, const void* v, void* o, void* lse, int batch,
                    int heads, int kv_heads, int q_len, int k_len, int hd, float scale,
                    int causal, int dtype, cudaStream_t s) {
  FLASH_GENERAL_DISPATCH(fwd, q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, hd, scale,
                         causal, s);
}

cudaError_t dq_any(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* dq_out, void* delta, int batch, int heads,
                   int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                   int dtype, cudaStream_t s) {
  FLASH_GENERAL_DISPATCH(dq, q, k, v, o, dout, lse, dq_out, delta, batch, heads, kv_heads, q_len,
                         k_len, hd, scale, causal, s);
}

cudaError_t dkv_any(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int batch, int heads,
                    int kv_heads, int q_len, int k_len, int hd, float scale, int causal,
                    int dtype, cudaStream_t s) {
  FLASH_GENERAL_DISPATCH(dkv, q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len,
                         k_len, hd, scale, causal, s);
}

}  // namespace

// Each returns a cudaError_t: the launch's cudaGetLastError(), an error from
// setting the kernel's shared memory, or cudaErrorInvalidValue for shapes
// the kernels do not take (the Python wrapper validates first; this is the
// last line of defence). `dtype` is 0 for fp32, 1 for bf16, 2 for fp16.
extern "C" int flash_general_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int batch, int heads, int kv_heads, int q_len,
                                 int k_len, int head_dim, float scale, int causal, int dtype,
                                 void* stream) {
  if (bad_shape(batch, heads, kv_heads, q_len, k_len, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  return (int)fwd_any(q, k, v, o, lse, batch, heads, kv_heads, q_len, k_len, head_dim, scale,
                      causal, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_general_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* dq, void* delta,
                                int batch, int heads, int kv_heads, int q_len, int k_len,
                                int head_dim, float scale, int causal, int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, q_len, k_len, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  return (int)dq_any(q, k, v, o, dout, lse, dq, delta, batch, heads, kv_heads, q_len, k_len,
                     head_dim, scale, causal, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_general_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 int batch, int heads, int kv_heads, int q_len, int k_len,
                                 int head_dim, float scale, int causal, int dtype,
                                 void* stream) {
  if (bad_shape(batch, heads, kv_heads, q_len, k_len, head_dim, dtype))
    return (int)cudaErrorInvalidValue;
  return (int)dkv_any(q, k, v, dout, lse, delta, dk, dv, batch, heads, kv_heads, q_len, k_len,
                      head_dim, scale, causal, dtype, static_cast<cudaStream_t>(stream));
}
