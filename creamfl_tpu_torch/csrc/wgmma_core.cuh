// A tile GEMM core for Hopper (sm_90a): bf16 operands, fp32 accumulators,
// TMA loads into an S-stage shared-memory ring, wgmma on the tensor cores.
//
//   C[128, BN] += sum over depth d of A(r, d) * B(c, d)
//
// * Block: 256 threads, two consumer warpgroups; warpgroup g owns rows
//   64g .. 64g + 63 of the tile and holds them in BN / 2 fp32 registers a
//   thread (wgmma.m64nBNk16 accumulator layout, see acc_row / acc_col).
// * Ring: S stages of one A tile (128 x 64) and one B tile (BN x 64), each
//   written by TMA with the 128-byte swizzle; one full and one empty
//   mbarrier per stage. Thread 0 issues the copies (no separate producer
//   warpgroup): S stages ahead at the start, then one stage as soon as all
//   256 threads have released it.
// * Depth step: 64 elements (one 128-byte swizzle row), four k16 wgmmas.
// * Two operand layouts, chosen by kMN:
//     - K-major (kMN = false): the depth is the contiguous global dimension
//       of both operands. A TMA box is 64 depth x rows; the tile is rows of
//       128 bytes, 8-row groups 1024 bytes apart (SBO); a k16 step advances
//       the descriptor by 32 bytes inside the swizzled row.
//     - MN-major (kMN = true): both operands are stored [depth][rows], the
//       rows contiguous. A TMA box is 64 rows x 64 depth (8 KB); the tile
//       holds one box per 64 rows (LBO = 8 KB apart) of 64 depth rows of
//       128 bytes (8-depth groups 1024 bytes apart: SBO); a k16 step
//       advances by 16 depth rows (2 KB). wgmma reads them through its
//       transpose immediates.
//
// The host builds one CUtensorMap per operand (encode_tensor_map_2d) and
// passes it to the kernel as a __grid_constant__ parameter.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_core {

constexpr int kThreads = 256;      // two consumer warpgroups
constexpr int kTileRows = 128;     // A tile rows
constexpr int kDepth = 64;         // depth step (elements)
constexpr int kBoxBytes = 64 * 64 * 2;     // one 64 x 64 bf16 box: 8 KB
constexpr int kSwizzleGroup = 8 * 128;     // 8 rows of 128 bytes

// Ring geometry for a B tile of BN rows: S stages of (A + B), then S full
// and S empty barriers; the base is rounded up to 1024 bytes. By default
// S fills ~96 KB (two blocks an SM); a product one depth step deep takes
// S = 1, so that stages it never uses cost it no occupancy.
template <int BN, int S = (BN == 64 ? 4 : 3)>
struct Ring {
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static_assert(S >= 1, "at least one stage");
  static constexpr int kStages = S;
  static constexpr int kABytes = kTileRows * kDepth * 2;
  static constexpr int kBBytes = BN * kDepth * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                                    + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed: the j-th
// completion of a barrier (j = 0, 1, ...) is waited for with parity j & 1.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Box at (c0 along the contiguous dimension, c1 along the outer one) into
// shared memory at dst; its bytes complete on the barrier at bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WG_ACC8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// acc += A (64 x 16, desc da) * B (16 x BN, desc db); kT: both operands
// MN-major (transpose immediates 1).
template <int BN, bool kT>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db);

template <>
__device__ __forceinline__ void wgmma_k16<64, false>(float (&d)[32],
                                                     uint64_t da, uint64_t db) {
  asm volatile(
      "{\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_k16<64, true>(float (&d)[32],
                                                    uint64_t da, uint64_t db) {
  asm volatile(
      "{\nwgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 1, 1;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_k16<128, false>(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24),
        WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_k16<128, true>(float (&d)[64],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 1, 1;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24),
        WG_ACC8(d, 32), WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "l"(da), "l"(db));
}

#undef WG_ACC8

// Accumulator register i of a thread holds C(acc_row(i), acc_col(i)) of its
// warpgroup's 64 x BN block (the m64nNk16 fp32 layout).
__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// ---------------------------------------------------------------------------
// The main loop
// ---------------------------------------------------------------------------

// Runs nk depth steps into acc (zeroed here). issue(a_dst, b_dst, bar, kt)
// is called by thread 0 alone: it announces the stage's bytes on bar
// (mbar_expect_tx) and issues the TMA copies of depth step kt into the A
// and B tiles at shared addresses a_dst and b_dst. On return every copy
// has landed and been consumed; after a __syncthreads() the caller may
// reuse the ring's memory (ring_base); its stages, not its barriers.
template <int BN, bool kMN, int S = Ring<BN>::kStages, typename Issue>
__device__ __forceinline__ void mainloop(unsigned char* smem, int nk,
                                         const Issue& issue,
                                         float (&acc)[BN / 2]) {
  using R = Ring<BN, S>;
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + S * R::kStageBytes;
  const uint32_t empty = full + S * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < S && s < nk; ++s)
      issue(base + s * R::kStageBytes, base + s * R::kStageBytes + R::kABytes,
            full + 8 * s, s);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t wg_off = (threadIdx.x >> 7) * 64 * 128;  // 64 rows: 8 KB
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    const uint32_t parity = (kt / S) & 1;
    const uint32_t a_s = base + s * R::kStageBytes;
    const uint32_t b_s = a_s + R::kABytes;
    mbar_wait(full + 8 * s, parity);
    __syncwarp();  // reconverge the spinning lanes before .aligned ops
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 16; ++kk) {
      uint64_t da, db;
      if (kMN) {
        // LBO: the next 64 rows (box); SBO: the next 8 depth rows.
        da = make_desc(a_s + wg_off + kk * 16 * 128, kBoxBytes, kSwizzleGroup);
        db = make_desc(b_s + kk * 16 * 128, kBoxBytes, kSwizzleGroup);
      } else {
        // LBO unused (the k16 step lies inside one swizzled row); SBO:
        // the next 8 rows.
        da = make_desc(a_s + wg_off + kk * 32, 16, kSwizzleGroup);
        db = make_desc(b_s + kk * 32, 16, kSwizzleGroup);
      }
      wgmma_k16<BN, kMN>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(empty + 8 * s);
    if (threadIdx.x == 0 && kt + S < nk) {
      mbar_wait(empty + 8 * s, parity);
      issue(a_s, b_s, full + 8 * s, kt + S);
    }
    __syncwarp();
  }
}

// Generic pointer to the (1024-aligned) ring, for reuse after the loop.
__device__ __forceinline__ unsigned char* ring_base(unsigned char* smem) {
  const uint32_t raw = smem_u32(smem);
  return smem + (((raw + 1023u) & ~1023u) - raw);
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API symbol: fetched through the
// runtime, so the library links no libcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A row-major [outer, inner] matrix at ``base`` (bf16 unless another type
// of elem_bytes bytes is given), read in boxes of box_inner (128 bytes:
// one swizzle row; 64 bf16, 32 fp32) x box_outer; out-of-bounds elements
// read as zero. inner * elem_bytes % 16 == 0 and a 16-byte aligned base.
inline cudaError_t encode_tensor_map_2d(
    CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
    uint32_t box_inner, uint32_t box_outer,
    CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    uint32_t elem_bytes = 2) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * elem_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, dtype, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wgmma_core
