// Building blocks of the fp32 attention kernels (flash_fwd_fp32.cu,
// flash_bwd_dq_fp32.cu, flash_bwd_dkv_fp32.cu): the three-way bf16 split
// that lets bf16 wgmma compute fp32 products, in registers (P and dS),
// into a shared-memory tile from fp32 values in registers (store_split:
// the dQ kernel's Q and dO, split_tile: the dK/dV kernel's TMA-loaded fp32
// tiles), and as a pass over a whole fp32 input into three bf16 planes
// that the forward and dQ kernels then load by TMA like any 16-bit
// operand.
//
// The split (bf16x3). x = b0 + b1 + b2 + r with b0 = bf16(x),
// b1 = bf16(x - b0), b2 = bf16(x - b0 - b1), each rounded to nearest; both
// subtractions are exact in fp32, and |r| <= 2^-27 |x|. A product a b is
// taken as the six leading terms
//   a1 b1 + a0 b2 + a2 b0 + a0 b1 + a1 b0 + a0 b0
// (smallest first; the dropped a1 b2, a2 b1, a2 b2 are below 2^-25 |a b|),
// each a bf16 wgmma into the same fp32 accumulators. Six products at the
// bf16 rate of 989 TFLOP/s are one fp32-accurate product at ~165 TFLOP/s,
// 2.5x the fp32 FMA peak (67 TFLOP/s) the SIMT kernels are bound by.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace fp32x3 {

// The six (A split, B split) pairs of a product, smallest terms first.
constexpr int kTerms = 6;
__host__ __device__ constexpr int term_a(int t) {
  constexpr int a[kTerms] = {1, 0, 2, 0, 1, 0};
  return a[t];
}
__host__ __device__ constexpr int term_b(int t) {
  constexpr int b[kTerms] = {1, 2, 0, 1, 0, 0};
  return b[t];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The three bf16 parts of a pair (lo, hi), each packed with the lower
// index in the lower half (the wgmma fragment order).
__device__ __forceinline__ void split_pair(float lo, float hi, uint32_t (&s)[3]) {
  s[0] = pack_bf16(lo, hi);
  const float rl = lo - __uint_as_float(s[0] << 16);
  const float rh = hi - __uint_as_float(s[0] & 0xffff0000u);
  s[1] = pack_bf16(rl, rh);
  s[2] = pack_bf16(rl - __uint_as_float(s[1] << 16), rh - __uint_as_float(s[1] & 0xffff0000u));
}

// Accumulators as the three A-fragment splits of the next product: the
// accumulators of columns 16k..16k+15 (hopper.cuh) are fragment k.
template <int N>
__device__ __forceinline__ void split_fragments(const float (&acc)[N], uint32_t (&f0)[N / 8][4],
                                                uint32_t (&f1)[N / 8][4],
                                                uint32_t (&f2)[N / 8][4]) {
#pragma unroll
  for (int k = 0; k < N / 8; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t s[3];
      split_pair(acc[8 * k + 2 * i], acc[8 * k + 2 * i + 1], s);
      f0[k][i] = s[0];
      f1[k][i] = s[1];
      f2[k][i] = s[2];
    }
}

// Splits four columns x of row r, from the even column col on, into the
// three bf16 tiles of geometry T (hopper::Tile: swizzled boxes, as wgmma
// descriptors read them) at dst, dst + T::kBytes, dst + 2 T::kBytes: the
// group's two pairs share a 16-byte chunk of the swizzled row, so each
// part is one 8-byte store.
template <typename T>
__device__ __forceinline__ void store_split(uint32_t dst, int r, int col, float4 x) {
  uint32_t a[3], b[3];
  split_pair(x.x, x.y, a);
  split_pair(x.z, x.w, b);
  const uint32_t at = dst + T::pair_off(r, col);
#pragma unroll
  for (int s = 0; s < 3; ++s)
    asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(at + s * T::kBytes), "r"(a[s]),
                 "r"(b[s])
                 : "memory");
}

// Splits kRows rows of a dense row-major fp32 tile (D columns, as an
// unswizzled TMA box leaves it) into rows row0.. of three bf16 tiles of
// geometry T (hopper::Tile: swizzled boxes, as wgmma descriptors read them)
// at dst, dst + T::kBytes, dst + 2 T::kBytes (store_split). Called by
// `threads` threads, thread `tid` taking every threads-th group of four
// columns.
template <typename T, int D, int kRows>
__device__ __forceinline__ void split_tile(const float* raw, uint32_t dst, int row0, int tid,
                                           int threads) {
  constexpr int kGroups = kRows * D / 4;
#pragma unroll 2
  for (int i = tid; i < kGroups; i += threads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    store_split<T>(dst, row0 + r, c, reinterpret_cast<const float4*>(raw)[i]);
  }
}

// The head dim of the parts: hd (a multiple of 4) rounded up to 8, so a
// bf16 row is a multiple of 16 bytes, as TMA needs.
inline int parts_head_dim(int hd) { return (hd + 7) / 8 * 8; }

// x [rows][hd] fp32 (hd a multiple of 4) into its three bf16 parts,
// parts[s] [rows][hdp] (hdp = parts_head_dim(hd), the columns past hd
// zero), the planes one after another. A thread splits four columns: one
// 16-byte load, one 8-byte store a part.
__global__ void split_kernel(const float* __restrict__ x, uint16_t* __restrict__ parts,
                            long long rows, int hd, int hdp) {
  const long long groups = rows * (hdp / 4);
  const size_t plane = (size_t)rows * hdp;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < groups;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (hdp / 4);
    const int c = (int)(i % (hdp / 4)) * 4;
    const float4 v = c < hd ? *reinterpret_cast<const float4*>(x + r * hd + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t a[3], b[3];
    split_pair(v.x, v.y, a);
    split_pair(v.z, v.w, b);
#pragma unroll
    for (int s = 0; s < 3; ++s)
      *reinterpret_cast<uint2*>(parts + s * plane + r * hdp + c) = make_uint2(a[s], b[s]);
  }
}

inline cudaError_t split(const void* x, uint16_t* parts, long long rows, int hd,
                         cudaStream_t stream) {
  const int hdp = parts_head_dim(hd);
  const long long want = (rows * (hdp / 4) + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
  split_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float*>(x), parts, rows, hd, hdp);
  return cudaGetLastError();
}

// A tensor map over the parts of an fp32 [heads, len, hd] tensor, as the
// 16-bit kernels' maps (hopper::make_map_3d): [3 * heads, len, hdp] bf16,
// part s of head h at head index s * heads + h.
inline cudaError_t make_parts_map(CUtensorMap* map, const uint16_t* parts, int heads, int len,
                                  int hd, int box_rows, int box_cols) {
  return hopper::make_map_3d(map, parts, true, 3 * heads, len, parts_head_dim(hd), box_rows,
                             box_cols);
}

}  // namespace fp32x3
