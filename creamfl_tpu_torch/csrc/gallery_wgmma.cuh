// The gallery's lse partial pass on Hopper's warpgroup tensor-core path
// (sm_90a): 3xTF32 products on wgmma, both operands fed by TMA into a
// 128-byte-swizzled shared-memory ring. Included by gallery.cu, whose
// "wgmma" route (K1, K3's forward and K4) launches lse_wgmma_kernel.
//
// What it computes: per split of the gallery's 128-row column tiles, each
// v row's partial (max, sum of exp(logit - max)) of (v @ g^T) * inv_tau in
// fp32, into part_max / part_sum [M, splits] -- what the simt
// lse_partial_kernel writes, so the merges of gallery.cu take either.
//
// What bounds it: 3 x 2 M N D tensor operations (3xTF32) on (M + N) D
// floats: at K4's 50 000^2 x 256 and K1's 128 x 50 000 x 256, hundreds of
// operations a byte, so the TF32 rate (495 TFLOP/s dense on an H100 SXM;
// chip_smoke.py's wgmma_peak_phase measures this kernel's instruction
// shape: ~480 on an H100) and not HBM. Inside the SM two further budgets
// sit close to it: shared memory (a m64n128k8 wgmma reads 6 KB of
// operands for 131 072 operations: ~100 bytes a clock at the TF32 rate,
// of 128), and the L2 reads of the ring (V's chunks come again for every
// gallery tile). On an H100 80GB HBM3 at 700 W (chip_smoke.py): K4 at
// 50 000^2 x 256 12.9 ms against 26.5 on an mma.sync lse kernel, ~60 %
// of its 7.76 ms bound; K1 at 128 x 50 000 x 256 0.054 ms of device time
// against 0.079.
//
// Design:
//   * Operands. A product is small*big + big*small + big*big, the small
//     terms first, each operand x split as big = x itself (the tensor core
//     reads an fp32 operand as TF32 by dropping its 13 low bits, i.e. big =
//     trunc_tf32(x)) and small = x - trunc_tf32(x) (exact in fp32, read
//     truncated in its turn). The halves carry x to ~2^-20 relative; the
//     dropped small*small term is below 2^-20 of the product; both are
//     biased toward zero, ~3 * 2^-22 of |product| on average. No thread
//     splits anything in the mainloop. Where the small halves come from is
//     the template's choice (kSplit), made by the host from M
//     (ops/gallery_kernels.py:wgmma_split_for):
//       - kPrepass ("prepass", from 512 v rows: K4): tf32_small_kernel
//         writes them once a call into scratch the wrapper allocates, and
//         TMA brings four boxes a stage. The pre-pass is a fixed cost (one
//         pass over v and g), paid back where many row blocks share a tile;
//       - kSmem ("smem", fewer rows: K1, K3): TMA brings the two fp32 boxes
//         and three producer warps write their small halves into the
//         stage's other two boxes (fence.proxy.async, then a "ready"
//         barrier): half the L2 reads and no scratch, but a split on every
//         stage's path, which costs K4 ~35 % on an H100.
//   * Ring. 3 stages of [V 128 x 32 | V small | G 128 x 32 | G small]
//     fp32 boxes (16 KB each, 64 KB a stage, ~193 KB in all: one block an
//     SM), a depth chunk of 32 floats (one 128-byte swizzle row) a stage.
//     Barriers per stage: full (TMA bytes), ready (the small halves,
//     kSmem only) and empty (the 256 consumer threads).
//   * Block. 384 threads: two consumer warpgroups, each owning 64 of the
//     block's 128 v rows, and a producer warpgroup (one thread issues the
//     copies; with kSmem its other three warps split). One gallery tile
//     serves 128 rows (an mma.sync block: 64). 384 threads leave 168 registers
//     a thread; setmaxnreg moves the producer's to the consumers (40 /
//     232), whose chunk accumulator and tile logits take 128.
//   * Products. wgmma.m64n128k8.f32.tf32.tf32, both operands K-major from
//     shared memory; a k8 step advances the descriptors 32 bytes inside
//     the swizzled row. Each 32-deep chunk (12 wgmmas: 4 k8 steps x 3) is
//     summed in a fresh accumulator (scale-d 0 on its first) and added
//     with round-to-nearest fp32 adds to the tile's running logits: the
//     tensor core's accumulation truncates (gallery_core.cuh). Each chunk
//     is waited for (wait_group 0) before its registers are read: a second
//     accumulator in turn would not fit the registers, and ptxas
//     serializes wgmmas whose accumulators other instructions touch while
//     they are in flight.
//   * Epilogue. After a tile's last chunk each thread folds its 2 rows x
//     32 logits into online (max, sum) per row; the logits never leave
//     registers. Rows past M and gallery rows past N are zero-filled by
//     TMA, and the missing columns masked; D is zero-filled past its end.
//     At the end the four lanes sharing a row merge by shuffles.
//   * TMA needs D * 4 % 16 == 0 and 16-byte aligned bases: the planner's
//     rule for the tensor-core routes (fp32, D % 8 == 0, D <= 512, aligned,
//     contiguous) covers it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gallery_core.cuh"
#include "wgmma_core.cuh"

namespace gwgmma {

using gcore::lse_combine;
using wgmma_core::mbar_arrive;
using wgmma_core::mbar_expect_tx;
using wgmma_core::mbar_init;
using wgmma_core::mbar_wait;
using wgmma_core::make_desc;
using wgmma_core::smem_u32;
using wgmma_core::tma_load_2d;
using wgmma_core::wgmma_commit;
using wgmma_core::wgmma_fence;
using wgmma_core::wgmma_wait_all;

constexpr int kRows = 128;       // v rows per block
constexpr int kCols = 128;       // gallery rows (logit columns) per tile
constexpr int kDepth = 32;       // floats per depth chunk (128 bytes)
constexpr int kStages = 3;
constexpr int kBox = kRows * kDepth * 4;  // 16 KB: one 128 x 32 fp32 box
constexpr int kStageBytes = 4 * kBox;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kThreads = 384;    // + the producer warpgroup
constexpr int kSplitters = 96;   // producer warps 1-3 (kSmem)
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 3 * kStages * 8;
static_assert(kCols == kRows, "one box shape for V and G");

#define GW_ACC8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 8, desc da) * B (8 x 128, desc db), TF32 operands read
// from fp32 in shared memory, both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : GW_ACC8(d, 0), GW_ACC8(d, 8), GW_ACC8(d, 16), GW_ACC8(d, 24),
        GW_ACC8(d, 32), GW_ACC8(d, 40), GW_ACC8(d, 48), GW_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef GW_ACC8

// K-major 128-byte-swizzled operand at shared address a: 8-row groups 1024
// bytes apart (SBO); LBO unused inside one swizzle row.
__device__ __forceinline__ uint64_t desc_k(uint32_t a) {
  return make_desc(a, 16, 1024);
}

// x - trunc_tf32(x): exact in fp32.
__device__ __forceinline__ float tf32_small(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ float4 tf32_small4(float4 x) {
  return make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z),
                     tf32_small(x.w));
}

// The split pre-pass: a_small = a - trunc_tf32(a) over na4 float4s, then
// the same for b (16-byte aligned bases).
__global__ void tf32_small_kernel(const float4* __restrict__ a,
                                  float4* __restrict__ a_small, size_t na4,
                                  const float4* __restrict__ b,
                                  float4* __restrict__ b_small, size_t nb4) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < na4 + nb4; i += stride) {
    if (i < na4)
      a_small[i] = tf32_small4(a[i]);
    else
      b_small[i - na4] = tf32_small4(b[i - na4]);
  }
}

// Where the small halves come from (see the note at the top).
enum Split { kPrepass = 0, kSmem = 1 };

constexpr float kLog2e = 1.4426950408889634f;

// Partial row logsumexp of (v @ g^T) * inv_tau over one split of the
// gallery's column tiles: part_max / part_sum[row, split]. map_v / map_g:
// v [M][D] and g [N][D] in 32 x 128 boxes; map_vs / map_gs their small
// halves (read by kPrepass only).
template <int kSplit>
__global__ void __launch_bounds__(kThreads, 1)
lse_wgmma_kernel(const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_vs,
                 const __grid_constant__ CUtensorMap map_g,
                 const __grid_constant__ CUtensorMap map_gs, int M, int N,
                 int D, float inv_tau, int tiles_per_split,
                 float* __restrict__ part_max, float* __restrict__ part_sum) {
  extern __shared__ __align__(1024) unsigned char gw_smem[];
  const uint32_t raw = smem_u32(gw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* ring = gw_smem + (base - raw);  // generic view of the ring
  const uint32_t full = base + kStages * kStageBytes;
  const uint32_t ready = full + kStages * 8;
  const uint32_t empty = ready + kStages * 8;

  const int row0 = blockIdx.x * kRows;
  const int split = blockIdx.y;
  const int n_tiles = (N + kCols - 1) / kCols;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_chunks = (D + kDepth - 1) / kDepth;
  const int n_steps = max(t_end - t_begin, 0) * n_chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(ready + 8 * s, kSplitters);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= kConsumers) {
    // The producer warpgroup, its registers handed to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pwarp = (threadIdx.x - kConsumers) >> 5;
    if (pwarp == 0 && lane == 0) {
      // The copies: stage q holds depth chunk q % n_chunks of the block's v
      // rows and of gallery tile t_begin + q / n_chunks.
      for (int q = 0; q < n_steps; ++q) {
        const int s = q % kStages;
        if (q >= kStages) mbar_wait(empty + 8 * s, ((q / kStages) - 1) & 1);
        const int c0 = (q % n_chunks) * kDepth;
        const int g0 = (t_begin + q / n_chunks) * kCols;
        const uint32_t st = base + s * kStageBytes;
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kSplit == kPrepass ? 4 * kBox : 2 * kBox);
        tma_load_2d(st, &map_v, c0, row0, bar);
        tma_load_2d(st + 2 * kBox, &map_g, c0, g0, bar);
        if (kSplit == kPrepass) {
          tma_load_2d(st + kBox, &map_vs, c0, row0, bar);
          tma_load_2d(st + 3 * kBox, &map_gs, c0, g0, bar);
        }
      }
    } else if (kSplit == kSmem && pwarp > 0) {
      // The small halves of each landed stage, written beside the fp32
      // boxes at the same offsets (same swizzle), for the async proxy.
      const int id = threadIdx.x - kConsumers - 32;
      constexpr int kVec = kBox / 16;  // float4s a box
      for (int q = 0; q < n_steps; ++q) {
        const int s = q % kStages;
        mbar_wait(full + 8 * s, (q / kStages) & 1);
        unsigned char* st = ring + s * kStageBytes;
        for (int i = id; i < 2 * kVec; i += kSplitters) {
          float4* src = reinterpret_cast<float4*>(
              st + (i / kVec) * 2 * kBox) + (i % kVec);
          float4* dst = reinterpret_cast<float4*>(
              reinterpret_cast<unsigned char*>(src) + kBox);
          *dst = tf32_small4(*src);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(ready + 8 * s);
      }
    }
  } else {
    // The consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the
    // block; register i holds logit (wrow + 8 ((i >> 1) & 1), 8 (i >> 2) +
    // 2 (lane & 3) + (i & 1)) of the tile (the m64nNk8 accumulator
    // layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x >> 7;
    const int wrow = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const uint32_t wg_off = wg * 64 * 128;  // 64 rows of 128 bytes
    const float scale = inv_tau * kLog2e;
    float logits[64], chunk[64];
    float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) logits[i] = chunk[i] = 0.f;

    for (int q = 0; q < n_steps; ++q) {
      const int s = q % kStages;
      mbar_wait((kSplit == kSmem ? ready : full) + 8 * s, (q / kStages) & 1);
      __syncwarp();  // reconverge the spinning lanes before .aligned ops
      const uint32_t st = base + s * kStageBytes;
      const uint32_t v_big = st + wg_off, v_small = v_big + kBox;
      const uint32_t g_big = st + 2 * kBox, g_small = g_big + kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDepth / 8; ++kk) {
        const uint32_t o = kk * 32;  // 8 floats along the swizzled row
        wgmma_tf32(chunk, desc_k(v_small + o), desc_k(g_big + o), kk > 0);
        wgmma_tf32(chunk, desc_k(v_big + o), desc_k(g_small + o), 1);
        wgmma_tf32(chunk, desc_k(v_big + o), desc_k(g_big + o), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty + 8 * s);
      const int kc = q % n_chunks;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) logits[i] = chunk[i];
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) logits[i] += chunk[i];
      }
      if (kc == n_chunks - 1) {
        // The tile into each owned row's online (max, sum); columns past N
        // (zero-filled) masked. exp(x inv_tau - m) as exp2(x scale - m
        // log2 e).
        const int lim = N - (t_begin + q / n_chunks) * kCols - 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + e < lim) mx = fmaxf(mx, logits[4 * j + 2 * h + e]);
          if (mx != -INFINITY) {
            const float new_max = fmaxf(run_max[h], mx * inv_tau);
            const float off = new_max * kLog2e;
            float sum = run_sum[h] * exp2f(fmaf(run_max[h], kLog2e, -off));
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (8 * j + e < lim)
                  sum += exp2f(fmaf(logits[4 * j + 2 * h + e], scale, -off));
            run_max[h] = new_max;
            run_sum[h] = sum;
          }
        }
      }
    }

    // The four lanes of a row (lane & 3) hold its other columns.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, run_max[h], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, run_sum[h], off);
        lse_combine(run_max[h], run_sum[h], m2, s2);
      }
      const int row = row0 + wrow + 8 * h;
      if ((lane & 3) == 0 && row < M) {
        part_max[static_cast<size_t>(row) * gridDim.y + split] = run_max[h];
        part_sum[static_cast<size_t>(row) * gridDim.y + split] = run_sum[h];
      }
    }
  }
}

// The card's rate for this kernel's instruction: each of two warpgroups
// runs `iters` rounds of 12 wgmma.m64n128k8 TF32 products (the shape and
// count of one depth chunk) from a 32 KB shared-memory tile pair into its
// accumulators, one commit a round with at most two rounds in flight;
// then writes one sum per thread so that nothing is dropped.
__global__ void __launch_bounds__(kConsumers, 1)
wgmma_peak_kernel(int iters, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char gw_smem[];
  const uint32_t raw = smem_u32(gw_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* tile = reinterpret_cast<float*>(gw_smem + (base - raw));
  for (int i = threadIdx.x; i < 2 * kBox / 4; i += kConsumers)
    tile[i] = 1.0f + 1e-3f * static_cast<float>(i & 255);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a = base + (threadIdx.x >> 7) * 64 * 128, b = base + kBox;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const uint32_t o = (k & 3) * 32;
      wgmma_tf32(d, desc_k(a + o), desc_k(b + o), 1);
    }
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  wgmma_wait_all();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += d[i];
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x] = sum;
}

// Dynamic shared memory of the peak probe: two boxes, 1024-aligned.
constexpr int kPeakSmemBytes = 1024 + 2 * kBox;

}  // namespace gwgmma
