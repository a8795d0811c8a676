// Building blocks shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu, flash_bwd_dkv.cu): the mask value, 16-bit packing, and the
// block schedule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// ray_tpu/ops/attention.py DEFAULT_MASK_VALUE = -0.7 * fp32 max: finite,
// so exp(mask - m) underflows to 0 and never computes inf - inf.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// Two floats rounded to the 16-bit input type, the lower index in the
// lower half (the wgmma fragment order).
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

// Block schedule of the three kernels. Each kernel splits one sequence
// into n_t tiles per head; under causal masking tile work falls (or rises)
// linearly along it. A block takes a pair of tiles from opposite ends of
// one head, so every pair does the same work, and the second tile's loads
// overlap the first's tail. Equal pairs leave a ragged last wave, so the
// last `singles` heads are cut into single tiles instead, heaviest first
// across those heads, and fill it. The grid is one-dimensional: pairs
// (head-major) first, then singles.
struct Schedule {
  int head, tile_a, tile_b;  // tile_b < 0: a single tile
};

// `heavy_first` names the end of the sequence with the most work: the
// first tile (dK/dV: the first keys see the most queries) or the last
// (forward and dQ: the last queries see the most keys).
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
