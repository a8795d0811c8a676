// Building blocks shared by the flash-attention kernels: the mask value
// and 16-bit packing (all of them); the block schedule of the TMA/wgmma
// kernels (flash_fwd.cu, flash_bwd_dkv.cu); and for the dQ kernel
// (flash_bwd.cu) the m16n8k16 tensor-core product and tile copies from
// device memory into padded shared memory.
//
// Fragment layout of mma.sync m16n8k16 (row.col), with g = lane / 4 and
// tg = lane % 4:
//   A (16 x 16, row-major): a0 = (g, 2tg..2tg+1), a1 = (g+8, 2tg..),
//                            a2 = (g, 8+2tg..),  a3 = (g+8, 8+2tg..)
//   B (16 x 8):             b0 = (k = 2tg..2tg+1, n = g), b1 = (k = 8+2tg.., n = g)
//   C (16 x 8, fp32):       c0,c1 = (g, 2tg..2tg+1), c2,c3 = (g+8, 2tg..)
// So a B operand is read from a shared tile stored [n][k] (k contiguous),
// and the C accumulators of two adjacent n-tiles are one A fragment.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// ray_tpu/ops/attention.py DEFAULT_MASK_VALUE = -0.7 * fp32 max: finite,
// so exp(mask - m) underflows to 0 and never computes inf - inf.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

template <bool kBf16>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  if constexpr (kBf16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// Two floats rounded to the 16-bit input type, the lower index in the
// lower half (the mma fragment order).
template <bool kBf16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kBf16) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 block at (row0, col0) of a row-major shared
// tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* s, int ld, int row0,
                                       int col0, int g, int tg) {
  const uint16_t* p = s + (row0 + g) * ld + col0 + tg * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment of the 16 (k) x 8 (n) block at (k0, n0) of a shared tile
// stored [n][k] with row stride ld.
__device__ __forceinline__ void load_b(uint32_t b[2], const uint16_t* s, int ld, int n0, int k0,
                                       int g, int tg) {
  const uint16_t* p = s + (n0 + g) * ld + k0 + tg * 2;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// Copy rows [r0, r0 + R) of a row-major [n_rows, hd] matrix into shared
// memory: kRowMajor into s[R][D + 8], kTransposed into st[D][R + 8].
// Rows >= n_rows and columns in [hd, D) are zero-filled. hd is a
// multiple of 16, so each 16-byte chunk is wholly inside or outside.
template <int R, int D, int kThreads, bool kRowMajor, bool kTransposed>
__device__ __forceinline__ void load_tile(uint16_t* s, uint16_t* st, const uint16_t* src, int r0,
                                          int n_rows, int hd, int tid) {
  constexpr int kChunks = D / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (r0 + r < n_rows && col < hd)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * hd + col);
    if constexpr (kRowMajor) *reinterpret_cast<uint4*>(s + r * (D + 8) + col) = val;
    if constexpr (kTransposed) {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) st[(col + i) * (R + 8) + r] = e[i];
    }
  }
}

// Block schedule of the TMA/wgmma kernels (flash_fwd.cu, flash_bwd_dkv.cu).
// Each kernel splits one sequence into n_t tiles per head; under causal
// masking tile work falls (or rises) linearly along it. A block takes a
// pair of tiles from opposite ends of one head, so every pair does the
// same work, and the second tile's loads overlap the first's tail. Equal
// pairs leave a ragged last wave, so the last `singles` heads are cut into
// single tiles instead, heaviest first across those heads, and fill it.
// The grid is one-dimensional: pairs (head-major) first, then singles.
struct Schedule {
  int head, tile_a, tile_b;  // tile_b < 0: a single tile
};

// `heavy_first` names the end of the sequence with the most work: the
// first tile (dK/dV: the first keys see the most queries) or the last
// (forward: the last queries see the most keys).
__device__ __forceinline__ Schedule schedule(int block, int n_t, int n_heads, int singles,
                                             bool heavy_first) {
  const int n_pairs = (n_t + 1) / 2;
  const int paired = (n_heads - singles) * n_pairs;
  int head, a, b;
  if (block < paired) {
    head = block / n_pairs;
    const int x = block % n_pairs;
    a = x;
    b = n_t - 1 - x > x ? n_t - 1 - x : -1;
  } else {
    const int j = block - paired;
    head = n_heads - singles + j % singles;
    a = j / singles;
    b = -1;
  }
  if (!heavy_first) {
    a = n_t - 1 - a;
    if (b >= 0) b = n_t - 1 - b;
  }
  return {head, a, b};
}

// The number of heads cut into single tiles, and the grid size. Pairs
// alone when they fit in one wave of blocks (one block an SM); otherwise
// about two waves' worth of single tiles at the end.
inline void schedule_size(int n_t, int n_heads, int* singles, int* blocks) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_pairs = (n_t + 1) / 2;
  const int wave_fill = (2 * sms + n_t - 1) / n_t;
  *singles = n_heads * n_pairs <= sms ? 0 : (wave_fill < n_heads ? wave_fill : n_heads);
  *blocks = (n_heads - *singles) * n_pairs + *singles * n_t;
}

}  // namespace flash
