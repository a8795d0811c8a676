// Hopper (sm_90a) building blocks for the flash-attention kernels, as
// inline PTX: TMA tensor maps, loads and stores, mbarriers and named
// barriers, register hand-over between warpgroups (setmaxnreg), and
// warpgroup matrix products (wgmma) with their shared-memory descriptors.
//
// Shared-memory tiles. Every operand tile is loaded by TMA as boxes of
// kSwizzle-byte rows (128 bytes = 64 16-bit columns, or 64 bytes = 32
// columns) with the matching TMA swizzle; a head_dim of 128 is two boxes
// side by side, each box [rows][64]. Each box starts on a 1024-byte
// boundary, so a descriptor's base offset is always 0.
//   K-major operand (the reduction dim runs along the row): SBO = 8 rows
//     x kSwizzle bytes; the k-th 16-column step adds 32 bytes inside the
//     box (the next box after kSwizzle / 32 steps); LBO unused.
//   MN-major operand (the reduction dim runs down the rows; the wgmma
//     transpose flag): SBO = 8 rows x kSwizzle bytes, LBO = one box (the
//     next kSwizzle / 2 output columns); the k-th 16-row step adds
//     16 x kSwizzle bytes.
// wgmma m64nNk16 fragments (thread t of the warpgroup, warp w = t / 32,
// g = (t % 32) / 4, tg = t % 4):
//   accumulator d[4j + e]: row 16w + g + 8 (e / 2), column 8j + 2tg + e % 2;
//   A from registers, a[0..3]: rows 16w + g (+8 for a[1], a[3]), columns
//   2tg..2tg+1 (+8 for a[2], a[3]) of the 64 x 16 step, two 16-bit values
//   each, the lower column in the lower half.
// So the accumulators of columns 16k..16k+15 are, packed in pairs, the A
// fragment of reduction step k of the next product.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- host --

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda. nullptr if the driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return (EncodeTiledFn) nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A rank-3 map over a contiguous 16-bit [heads, len, hd] tensor, loading
// boxes of box_rows x box_cols (one head). Rows past len and columns past
// hd are zero-filled, and a box never reaches into the next head.
inline cudaError_t make_map_3d(CUtensorMap* map, const void* ptr, bool bf16, int heads, int len,
                               int hd, int box_rows, int box_cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)len, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)len * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 3,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A warp-specialised kernel's register hand-over (setmaxnreg) only works
// if the block was launched with at least the registers it hands out;
// otherwise setmaxnreg.inc would wait forever. Checked before launching.
template <typename Kernel>
cudaError_t check_register_pool(Kernel kernel, int threads, int needed) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return attr.numRegs * threads >= needed ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// -------------------------------------------------------------- device --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Adds to the bytes the current phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of the given parity has completed. A wait that
// never ends is a bug (a wrong byte count, a missing arrival); after 2^26
// polls, seconds at the least, it gives up, so such a bug shows as wrong
// output in the checks instead of a hung card. (It does not trap: a trap
// path outside the warp-specialised branches makes ptxas budget registers
// for it at the kernel's entry count, and the consumers spill.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; polls < (1u << 26); ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// Named barriers (ids 1..15; 0 is __syncthreads): sync waits until
// `threads` threads have arrived, counting its own; arrive does not wait.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box at (column c0, row c1, head c2) into shared memory at dst; its
// bytes complete a transaction on the mbarrier bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box from shared memory at src to (column c0, row c1, head c2);
// elements past the tensor's edges are not written. Completion is tracked
// by the issuing thread's bulk groups (store_commit, store_wait_read).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- registers

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// 2^x in one MUFU.EX2 (flushes denormal results to zero; the softmax
// only needs the normal range). exp2f adds range fix-ups around it.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle (1 = 128 bytes, 2 = 64 bytes). Kept as
// its two 32-bit halves; desc_at adds a byte offset to the start address
// in an asm volatile, so the compiler rebuilds each descriptor where a
// wgmma needs it instead of holding dozens of loop-invariant descriptors
// in registers across the main loop.
struct Desc {
  uint32_t lo, hi;
};

__device__ __forceinline__ Desc make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                          uint32_t swizzle_bytes) {
  return {((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16),
          ((sbo >> 4) & 0x3FFF) | ((swizzle_bytes == 128 ? 1u : 2u) << 30)};
}

__device__ __forceinline__ uint64_t desc_at(Desc d, uint32_t offset_bytes) {
  uint64_t out;
  asm volatile(
      "{\n.reg .b32 lo;\n"
      "add.u32 lo, %1, %2;\n"
      "mov.b64 %0, {lo, %3};\n}\n"
      : "=l"(out)
      : "r"(d.lo), "r"(offset_bytes >> 4), "r"(d.hi));
  return out;
}

#define HOPPER_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOPPER_REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_ACC8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC16(d) HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)
#define HOPPER_ACC32(d) HOPPER_ACC16(d), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
#define HOPPER_ACC64(d) \
  HOPPER_ACC32(d), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40), HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)

// d (+)= A B, A and B from shared memory (descriptors); A K-major.
#define HOPPER_WGMMA_SS(N, TY, REGS, ACC, IA, IB, IS, IT)                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                               \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " REGS ", %" #IA \
               ", %" #IB ", p, 1, 1, 0, %" #IT ";\n}\n"                                        \
               : ACC                                                                           \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB))

// d (+)= A B, A from registers, B from shared memory.
#define HOPPER_WGMMA_RS(N, TY, REGS, ACC, AREGS, IB, IS, IT)                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #IS ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " " REGS ", " AREGS \
               ", %" #IB ", p, 1, 1, %" #IT ";\n}\n"                                        \
               : ACC                                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),     \
                 "n"(kTransB))

// m64nNk16, fp32 accumulators d[N / 2]; scale_d = 0 overwrites d.
// kTransB = 1 reads B MN-major.
template <int N, bool kBf16, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 128) {
    if constexpr (kBf16) HOPPER_WGMMA_SS(128, "bf16", HOPPER_REGS64, HOPPER_ACC64(d), 64, 65, 66, 67);
    else HOPPER_WGMMA_SS(128, "f16", HOPPER_REGS64, HOPPER_ACC64(d), 64, 65, 66, 67);
  } else {
    if constexpr (kBf16) HOPPER_WGMMA_SS(64, "bf16", HOPPER_REGS32, HOPPER_ACC32(d), 32, 33, 34, 35);
    else HOPPER_WGMMA_SS(64, "f16", HOPPER_REGS32, HOPPER_ACC32(d), 32, 33, 34, 35);
  }
}

template <int N, bool kBf16, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_rs: N is 32, 64 or 128");
  if constexpr (N == 128) {
    if constexpr (kBf16)
      HOPPER_WGMMA_RS(128, "bf16", HOPPER_REGS64, HOPPER_ACC64(d), "{%64, %65, %66, %67}", 68, 69, 70);
    else
      HOPPER_WGMMA_RS(128, "f16", HOPPER_REGS64, HOPPER_ACC64(d), "{%64, %65, %66, %67}", 68, 69, 70);
  } else if constexpr (N == 64) {
    if constexpr (kBf16)
      HOPPER_WGMMA_RS(64, "bf16", HOPPER_REGS32, HOPPER_ACC32(d), "{%32, %33, %34, %35}", 36, 37, 38);
    else
      HOPPER_WGMMA_RS(64, "f16", HOPPER_REGS32, HOPPER_ACC32(d), "{%32, %33, %34, %35}", 36, 37, 38);
  } else {
    if constexpr (kBf16)
      HOPPER_WGMMA_RS(32, "bf16", HOPPER_REGS16, HOPPER_ACC16(d), "{%16, %17, %18, %19}", 20, 21, 22);
    else
      HOPPER_WGMMA_RS(32, "f16", HOPPER_REGS16, HOPPER_ACC16(d), "{%16, %17, %18, %19}", 20, 21, 22);
  }
}

#undef HOPPER_WGMMA_SS
#undef HOPPER_WGMMA_RS

// ---- tile geometry

// A [kRows][D] 16-bit operand tile in shared memory as TMA leaves it:
// D / kCols boxes of [kRows][kCols], kSwizzle-byte rows.
template <int D, int kRows>
struct Tile {
  static constexpr int kSwizzle = D >= 64 ? 128 : 64;  // bytes per box row
  static constexpr int kCols = kSwizzle / 2;           // columns per box
  static constexpr int kBoxes = D / kCols;
  static constexpr int kBoxBytes = kRows * kSwizzle;
  static constexpr int kBytes = kBoxes * kBoxBytes;
  static_assert(D % kCols == 0, "D is 32, 64 or 128");
  static constexpr uint32_t kSbo = 8 * kSwizzle;

  // K-major use (the reduction runs along the row), from row r0 of the
  // tile on: the base descriptor, and the offset of reduction step k
  // (16 columns).
  __device__ static Desc k_major(uint32_t tile, int r0) {
    return make_desc(tile + r0 * kSwizzle, 16, kSbo, kSwizzle);
  }
  __device__ static constexpr uint32_t k_off(int k) {
    return (k * 16 / kCols) * kBoxBytes + (k * 16 % kCols) * 2;
  }
  // MN-major use (the reduction runs down the rows; all D columns through
  // LBO across boxes): the base descriptor, and the offset of reduction
  // step k (16 rows).
  __device__ static Desc mn_major(uint32_t tile) {
    return make_desc(tile, kBoxBytes, kSbo, kSwizzle);
  }
  __device__ static constexpr uint32_t mn_off(int k) { return k * 16 * kSwizzle; }
  // Byte offset of the 4-byte pair at (row r, even column col) in the
  // swizzled layout TMA reads and writes: the 16-byte chunk index is
  // XORed with bits 7.. of the row's byte offset (the row within its group
  // of eight for 128-byte rows, half of it for 64-byte rows).
  __device__ static uint32_t pair_off(int r, int col) {
    const int box = col / kCols, cc = col % kCols;
    const int chunk = (cc * 2 / 16) ^ ((r * kSwizzle >> 7) & (kSwizzle / 16 - 1));
    return box * kBoxBytes + r * kSwizzle + chunk * 16 + (cc * 2) % 16;
  }
};

}  // namespace hopper
