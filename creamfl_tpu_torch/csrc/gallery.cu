// Gallery kernels for Hopper (sm_90a), fp32 in and fp32 accumulation.
//
// Replace the Pallas TPU kernels of creamfl_tpu/ops/pallas_gallery.py:
//   * an lse partial pass + lse_merge_kernel <- row_logsumexp / _lse_kernel
//     (K1); with the diagonal dot in the merge, conw_diag_pallas (K4); with
//     the label logit and the mean in the merge (one block per segment),
//     the forward of fused_gallery_ce (K3);
//   * a matvec partial pass + merge_splits_kernel <- _softmax_matvec /
//     _softmax_matvec_kernel (K2); with the label row, gbar and 1/(tau M)
//     in the merge, the backward of fused_gallery_ce (K3).
// K3 is thus two launches forward and two backward, nothing between them.
// Batched over a stacked client family (the JAX package's K3 under
// jax.vmap over the client axis), K3's M rows are S equal segments, one per
// member: the partial passes do not see them (a row's lse and softmax.G do
// not depend on its segment), the CE merge writes one mean per segment and
// the dfeats merge scales each row by its segment's gbar / (tau M / S). The
// gallery is then read once per family batch, not once per member.
//
// The partial passes have three routes, chosen from the inputs, per call
// and per pass, by the host wrapper
// (ops/gallery_kernels.py:plan_gallery_route):
//   * "wgmma", the lse pass: 3xTF32 wgmma fed by TMA (gallery_wgmma.cuh)
//     for fp32, D % 8 == 0, D <= 512, 16-byte aligned bases;
//   * "tc", the matvec pass on the same inputs: 3xTF32 mma.sync tile
//     kernels on gallery_core.cuh;
//   * "simt": the first fp32 FMA kernels, for every other call.
//
// What bounds them on an H100: K1 does 2*M*N*D operations and K2 4*M*N*D
// on inputs of (M + N) * D floats. At the main-path shapes (con_w: M = N =
// 50 000, D = 256; contrast CE: M = 128, N = 50 000) that is hundreds of
// operations per byte, so they are bound by operations, not by the 51 MB
// gallery read (~15 us at 3.35 TB/s): 67 TFLOP/s for fp32 FMAs; for 3xTF32
// on the tensor cores, a third of the TF32 rate -- 495 TFLOP/s for wgmma
// (~480 measured: chip_smoke.py's wgmma_peak_phase), ~310 measured for
// mma.sync (gallery_core.cuh has that and the error argument: fp32
// accuracy to within a few roundings, so the plain fp32 versions'
// tolerances hold on unit-norm features; gallery_wgmma.cuh the same for
// its truncated halves).
//
// What the design does about it:
//   * The TPU grid walked the gallery's column blocks in order on one core,
//     carrying the running (max, sum) in VMEM. Here the column range is
//     split across blocks (the host picks the split count from M: "tc" and
//     "wgmma" aim at one wave of resident blocks, each walking many tiles),
//     each block writes a partial (max, sum) per row -- or a partial [rows, D]
//     product -- and a merge pass sums the splits in a fixed order
//     (deterministic; no float atomics).
//   * "wgmma" lse: see gallery_wgmma.cuh (128 v rows a block, both
//     operands streamed by TMA in 32-float depth chunks, 3xTF32 from
//     operand halves split outside the mainloop).
//   * "tc" matvec: 64 v rows resident (32 past D 256); whole 64-row
//     (32-row) gallery tiles through a 2-stage ring, each used twice:
//     logits on the tensor cores, p = exp(logit - lse) through a small
//     shared tile (in TF32 halves), then p @ g_tile on the tensor cores
//     into [rows, D] register accumulators; each warp holds two m16 row
//     tiles, so that a gallery fragment, loaded and split once, serves two
//     products.
//   * tc fragments read along D come by ldmatrix, and operands are split
//     with integer instructions: the split and the shared-memory loads, not
//     the products, set the tc kernel's pace (chip_smoke.py times it);
//     the wgmma route takes that work out of the lse pass.
//   * "simt": K1 a register-tiled SGEMM (128 x 128 block tile, 8 x 8 per
//     thread) with the online-softmax epilogue; K2 one 64-row gallery tile
//     in shared memory used for the logits and for p @ g_tile (4 rows x
//     D/32 columns per thread). Ragged M, N and any D are masked.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// every function returns the cudaError_t of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gallery_core.cuh"
#include "gallery_wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// route "simt": fp32 FMA kernels
// ---------------------------------------------------------------------------

constexpr int kLseBM = 128;      // rows of v per block
constexpr int kLseBN = 128;      // gallery rows (logit columns) per tile
constexpr int kLseBK = 8;        // depth step
constexpr int kLseThreads = 256; // 16 x 16 threads, 8 x 8 logits each

template <bool kVec4>
__device__ __forceinline__ void load_tile_rows(const float* __restrict__ src,
                                               int n_rows, int D, int row,
                                               int k, float (&dst)[4]) {
  // Four consecutive depth values of one row; zero outside [n_rows, D).
  if (kVec4) {
    if (row < n_rows && k < D) {
      const float4 q = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row) * D + k);
      dst[0] = q.x; dst[1] = q.y; dst[2] = q.z; dst[3] = q.w;
    } else {
      dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[i] = (row < n_rows && k + i < D)
                   ? src[static_cast<size_t>(row) * D + k + i]
                   : 0.f;
    }
  }
}

// Partial row logsumexp of (v @ g^T) * inv_tau over one split of the
// gallery's column tiles: part_max/part_sum[row, split].
template <bool kVec4>
__global__ void __launch_bounds__(kLseThreads, 2)
lse_partial_kernel(const float* __restrict__ v, const float* __restrict__ g,
                   int M, int N, int D, float inv_tau, int tiles_per_split,
                   float* __restrict__ part_max,
                   float* __restrict__ part_sum) {
  __shared__ __align__(16) float As[kLseBK][kLseBM];
  __shared__ __align__(16) float Bs[kLseBK][kLseBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns logit columns tx*8 .. tx*8+7
  const int ty = tid / 16;  // owns rows ty*8 .. ty*8+7
  const int row0 = blockIdx.x * kLseBM;
  const int split = blockIdx.y;
  const int n_tiles = (N + kLseBN - 1) / kLseBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  const int ld_row = tid / 2;       // 0..127
  const int ld_k = (tid % 2) * 4;   // 0 or 4
  const int v_row = row0 + ld_row;

  float run_max[8], run_sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run_max[i] = -INFINITY;
    run_sum[i] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * kLseBN;
    const int g_row = col0 + ld_row;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kLseBK) {
      float a4[4], b4[4];
      load_tile_rows<kVec4>(v, M, D, v_row, k0 + ld_k, a4);
      load_tile_rows<kVec4>(g, N, D, g_row, k0 + ld_k, b4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        As[ld_k + i][ld_row] = a4[i];
        Bs[ld_k + i][ld_row] = b4[i];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kLseBK; ++k) {
        float a[8], b[8];
        *reinterpret_cast<float4*>(&a[0]) =
            *reinterpret_cast<const float4*>(&As[k][ty * 8]);
        *reinterpret_cast<float4*>(&a[4]) =
            *reinterpret_cast<const float4*>(&As[k][ty * 8 + 4]);
        *reinterpret_cast<float4*>(&b[0]) =
            *reinterpret_cast<const float4*>(&Bs[k][tx * 8]);
        *reinterpret_cast<float4*>(&b[4]) =
            *reinterpret_cast<const float4*>(&Bs[k][tx * 8 + 4]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Online-softmax epilogue: fold this tile's logits into the per-thread
    // (max, sum) of each owned row. Tail columns (>= N) are skipped.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col0 + tx * 8 + j < N) tile_max = fmaxf(tile_max, acc[i][j] * inv_tau);
      }
      if (tile_max == -INFINITY) continue;
      const float new_max = fmaxf(run_max[i], tile_max);
      float s = run_sum[i] * expf(run_max[i] - new_max);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col0 + tx * 8 + j < N) s += expf(acc[i][j] * inv_tau - new_max);
      }
      run_max[i] = new_max;
      run_sum[i] = s;
    }
  }

  // Merge the 16 threads that share a row (lanes 0-15 or 16-31 of a warp).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = run_max[i], s = run_sum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      const float nm = fmaxf(m, m2);
      s = (nm == -INFINITY) ? 0.f : s * expf(m - nm) + s2 * expf(m2 - nm);
      m = nm;
    }
    const int row = row0 + ty * 8 + i;
    if (tx == 0 && row < M) {
      part_max[static_cast<size_t>(row) * gridDim.y + split] = m;
      part_sum[static_cast<size_t>(row) * gridDim.y + split] = s;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int kMvBM = 32;       // rows of v per block (4 per warp)
constexpr int kMvBN = 64;       // gallery rows per tile
constexpr int kMvThreads = 256;

// Partial softmax(v g^T * inv_tau) @ g over one split of the gallery's
// column tiles: part[split, row, :]. kNJ = ceil(D / 32) columns per lane.
template <int kNJ>
__global__ void __launch_bounds__(kMvThreads)
matvec_partial_kernel(const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ lse, int M, int N, int D,
                      float inv_tau, int tiles_per_split,
                      float* __restrict__ part) {
  extern __shared__ float smem[];
  const int Dp = (D % 2 == 0) ? D + 1 : D;  // odd pitch: no bank conflicts
  float* Vs = smem;                          // [kMvBM][Dp]
  float* Gs = Vs + kMvBM * Dp;               // [kMvBN][Dp]
  float* Ps = Gs + kMvBN * Dp;               // [kMvBM][kMvBN]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kMvBM;
  const int split = blockIdx.y;
  const int n_tiles = (N + kMvBN - 1) / kMvBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  for (int r = warp; r < kMvBM; r += kMvThreads / 32) {
    const int gr = row0 + r;
    for (int d = lane; d < D; d += 32)
      Vs[r * Dp + d] = gr < M ? v[static_cast<size_t>(gr) * D + d] : 0.f;
  }
  float lse_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + warp * 4 + i;
    lse_r[i] = gr < M ? lse[gr] : 0.f;
  }
  float acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * kMvBN;
    __syncthreads();  // the previous tile's readers are done with Gs
    for (int r = warp; r < kMvBN; r += kMvThreads / 32) {
      const int gr = col0 + r;
      for (int d = lane; d < D; d += 32)
        Gs[r * Dp + d] = gr < N ? g[static_cast<size_t>(gr) * D + d] : 0.f;
    }
    __syncthreads();

    // Logits of rows warp*4+i against gallery rows lane and lane+32.
    float l[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i][0] = l[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float g0 = Gs[lane * Dp + d];
      const float g1 = Gs[(lane + 32) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = Vs[(warp * 4 + i) * Dp + d];
        l[i][0] = fmaf(a, g0, l[i][0]);
        l[i][1] = fmaf(a, g1, l[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        Ps[(warp * 4 + i) * kMvBN + c] =
            (col0 + c < N) ? expf(l[i][h] * inv_tau - lse_r[i]) : 0.f;
      }
    __syncwarp();  // a warp reads back only its own four rows of Ps

    for (int c = 0; c < kMvBN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(warp * 4 + i) * kMvBN + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          const float gv = Gs[c * Dp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], gv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + warp * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) part[(static_cast<size_t>(split) * M + gr) * D + d] = acc[i][j];
    }
  }
}

template <int kNJ>
cudaError_t launch_matvec(const float* v, const float* g, const float* lse,
                          int M, int N, int D, float inv_tau,
                          int tiles_per_split, int splits, float* part,
                          cudaStream_t stream) {
  const int Dp = (D % 2 == 0) ? D + 1 : D;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kMvBM + kMvBN) * Dp + kMvBM * kMvBN);
  cudaError_t err = cudaFuncSetAttribute(
      matvec_partial_kernel<kNJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kMvBM - 1) / kMvBM, splits);
  matvec_partial_kernel<kNJ><<<grid, kMvThreads, smem, stream>>>(
      v, g, lse, M, N, D, inv_tau, tiles_per_split, part);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route "tc": 3xTF32 mma.sync on the tile core of gallery_core.cuh
// ---------------------------------------------------------------------------

// Partial softmax(v g^T * inv_tau - lse) @ g over one split of the
// gallery's kBN-row tiles, on the tensor cores: part[split, row, :].
// kBM rows of v stay in shared memory; whole gallery tiles [kBN][Dpad]
// stream through a kStages ring: 64 x 64 and 2 stages up to D 256 (226
// KB), 32 x 32 and 2 stages up to D 512. Warps as 2 (rows: kMT m16 tiles
// each) x 4 (columns). Per tile:
//   1. logits [kBM, kBN] = v @ g_tile^T over D, each warp kMT x kNJ1
//      m16n8 tiles, summed per 32-deep chunk;
//   2. p = exp(logit * inv_tau - lse) (0 past N), split once into its
//      TF32 halves, into two [kBM][kBN + 4] tiles;
//   3. acc [kBM, D] += p @ g_tile, each warp its kMT m16 tiles x the
//      8-column tiles w, w + 4, ... of D (w its column), in a fresh
//      accumulator per gallery tile; each B fragment serves kMT products.
template <int kBM, int kBN, int kStages>
__global__ void __launch_bounds__(gcore::kThreads, 1)
matvec_tc_kernel(const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ lse, int M, int N, int D,
                 int Dpad, float inv_tau, int tiles_per_split,
                 float* __restrict__ part) {
  using namespace gcore;
  constexpr int kWM = 2, kWN = 4;
  constexpr int kMT = kBM / 16 / kWM;   // m16 tiles per warp
  constexpr int kNJ1 = kBN / kWN / 8;   // logit n8 tiles per warp
  constexpr int kQ = 16 / kMT;          // D's 8-column tiles per warp, most
  constexpr int kPsPitch = kBN + 4;     // 4 mod 32: conflict-free rows
  extern __shared__ __align__(16) float smem[];
  float* Vs = smem;                         // [kBM][Dpad]
  float* ring = Vs + kBM * Dpad;            // kStages x [kBN][Dpad]
  float* Ps = ring + kStages * kBN * Dpad;  // [kBM][kPsPitch] x 2:
  float* Ps_small = Ps + kBM * kPsPitch;    // p's TF32 halves

  const int warp = threadIdx.x / 32;
  const int wm = warp % kWM, wn = warp / kWM;
  const int r_warp = wm * kMT * 16;     // the warp's first row in the block
  const int c_warp = wn * (kBN / kWN);  // and first logit column
  const int gq = lane_group(), tq = lane_in_group();
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int n_steps = max(t_end - t_begin, 0);
  const int n_d8 = D / 8;

  auto load_tile = [&](int q) {
    load_rows_async(ring + (q % kStages) * (kBN * Dpad), g,
                    (t_begin + q) * kBN, kBN, N, D, Dpad);
  };

  load_rows_async(Vs, v, row0, kBM, M, D, Dpad);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_tile(s);
    cp_async_commit();
  }

  float lse_r[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + r_warp + i * 16 + gq + 8 * h;
      lse_r[i][h] = gr < M ? lse[gr] : 0.f;
    }
  float acc[kMT][kQ][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile q landed; tile q - 1 and its p are consumed
    if (q + kStages - 1 < n_steps) load_tile(q + kStages - 1);
    cp_async_commit();
    const float* Gs = ring + (q % kStages) * (kBN * Dpad);

    // Logits summed over 32-deep chunks (t1: one chunk's, on the tensor
    // cores); D % 8 == 0, so a chunk may end early at D.
    float s1[kMT][kNJ1][4], t1[kMT][kNJ1][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNJ1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s1[i][j][e] = t1[i][j][e] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kDepth) {
#pragma unroll
      for (int ks = 0; ks < kDepth; ks += 8) {
        if (c0 + ks < D) {
          FragA a[kMT];
#pragma unroll
          for (int i = 0; i < kMT; ++i)
            load_a(Vs, Dpad, r_warp + i * 16, c0 + ks, a[i]);
          FragB b[kNJ1];
          if constexpr (kNJ1 == 1) {
            load_b_nk1(Gs, Dpad, c_warp, c0 + ks, b[0]);
          } else {
#pragma unroll
            for (int jj = 0; jj < kNJ1; jj += 2)
              load_b_nk2(Gs, Dpad, c_warp + jj * 8, c0 + ks, b[jj],
                         b[jj + 1]);
          }
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < kNJ1; ++j) mma3(t1[i][j], a[i], b[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNJ1; ++j) add_to(s1[i][j], t1[i][j]);
    }
    const int col_base = (t_begin + q) * kBN;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNJ1; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c_warp + j * 8 + 2 * tq;
          const float p0 = col_base + c < N
                               ? expf(s1[i][j][2 * h] * inv_tau - lse_r[i][h])
                               : 0.f;
          const float p1 =
              col_base + c + 1 < N
                  ? expf(s1[i][j][2 * h + 1] * inv_tau - lse_r[i][h])
                  : 0.f;
          const float b0 = __uint_as_float(to_tf32(p0));
          const float b1 = __uint_as_float(to_tf32(p1));
          const int o = (r_warp + i * 16 + gq + 8 * h) * kPsPitch + c;
          *reinterpret_cast<float2*>(Ps + o) = make_float2(b0, b1);
          *reinterpret_cast<float2*>(Ps_small + o) =
              make_float2(p0 - b0, p1 - b1);
        }
    __syncthreads();  // p complete

    // This tile's p @ g_tile in fresh accumulators (t2), then into acc.
    float t2[kMT][kQ][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) t2[i][j][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < kBN; k0 += 8) {
      FragA a[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        load_a_halves(Ps, Ps_small, kPsPitch, r_warp + i * 16, k0, a[i]);
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int d8 = wn + kWN * j;
        if (d8 < n_d8) {
          FragB b;
          load_b_kn(Gs, Dpad, k0, d8 * 8, b);
#pragma unroll
          for (int i = 0; i < kMT; ++i) mma3(t2[i][j], a[i], b);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kQ; ++j) add_to(acc[i][j], t2[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int d8 = wn + kWN * j;
      if (d8 >= n_d8) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + r_warp + i * 16 + gq + 8 * h;
        if (gr < M)
          *reinterpret_cast<float2*>(
              part + (static_cast<size_t>(split) * M + gr) * D + d8 * 8 +
              2 * tq) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// Dynamic shared memory of the "tc" matvec kernel (mirrored by
// ops/gallery_kernels.py:tc_smem_bytes).
template <int kBM, int kBN, int kStages>
size_t matvec_tc_smem(int Dpad) {
  return sizeof(float) * (static_cast<size_t>(kBM + kStages * kBN) * Dpad +
                          2 * kBM * (kBN + 4));
}

template <int kBM, int kBN, int kStages>
cudaError_t launch_matvec_tc(const float* v, const float* g, const float* lse,
                             int M, int N, int D, int Dpad, float inv_tau,
                             int tiles_per_split, int splits, float* part,
                             cudaStream_t stream) {
  const size_t smem = matvec_tc_smem<kBM, kBN, kStages>(Dpad);
  auto kernel = matvec_tc_kernel<kBM, kBN, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM, splits);
  kernel<<<grid, gcore::kThreads, smem, stream>>>(
      v, g, lse, M, N, D, Dpad, inv_tau, tiles_per_split, part);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// merges (both routes)
// ---------------------------------------------------------------------------

enum LseMode { kLse = 0, kDiag = 1, kCe = 2 };

__device__ __forceinline__ float warp_dot(const float* __restrict__ a,
                                          const float* __restrict__ b, int D) {
  float dot = 0.f;
  for (int d = threadIdx.x % 32; d < D; d += 32) dot = fmaf(a[d], b[d], dot);
  return warp_sum(dot);
}

// One warp per row (rows strided over the grid): lse = max + log(sum) over
// the splits in order. kLse: out = lse. kDiag (M == N): out = <v_i, g_i> -
// lse (con_w's diag(log_softmax(V G^T))). kCe (one block per segment of
// seg_rows rows, the members of a stacked client family; one segment of M
// rows for a single client): out = lse, and loss[b] = mean over segment
// b's rows of lse_i - <v_i, g_{labels_i}> * inv_tau, summed per warp in row
// order and then over the warps in order; a label outside [0, N) gives NaN.
__global__ void lse_merge_kernel(const float* __restrict__ part_max,
                                 const float* __restrict__ part_sum, int M,
                                 int S, const float* __restrict__ v,
                                 const float* __restrict__ g, int N, int D,
                                 float inv_tau, int mode,
                                 const long long* __restrict__ labels,
                                 int seg_rows, float* __restrict__ out,
                                 float* __restrict__ loss) {
  __shared__ float warp_total[32];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool ce = mode == kCe;
  const int row_end = ce ? (blockIdx.x + 1) * seg_rows : M;
  const int stride = ce ? warps : gridDim.x * warps;
  float total = 0.f;
  for (int row = blockIdx.x * (ce ? seg_rows : warps) + warp; row < row_end;
       row += stride) {  // uniform across the warp
    // The row's S partials are contiguous: each lane merges its share in
    // order, then the lanes merge in a fixed butterfly.
    const float* pm = part_max + static_cast<size_t>(row) * S;
    const float* ps = part_sum + static_cast<size_t>(row) * S;
    float m = -INFINITY, sum = 0.f;
    for (int s = lane; s < S; s += 32) gcore::lse_combine(m, sum, pm[s], ps[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, sum, off);
      gcore::lse_combine(m, sum, m2, s2);
    }
    const float lse = m + logf(sum);
    float result = lse;
    const float* vr = v + static_cast<size_t>(row) * D;
    if (mode == kDiag) {
      result = warp_dot(vr, g + static_cast<size_t>(row) * D, D) - lse;
    } else if (mode == kCe) {
      const long long label = labels[row];
      const float dot =
          (label >= 0 && label < N)
              ? warp_dot(vr, g + static_cast<size_t>(label) * D, D)
              : NAN;
      total += lse - dot * inv_tau;
    }
    if (lane == 0) out[row] = result;
  }
  if (mode == kCe) {
    if (lane == 0) warp_total[warp] = total;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int w = 0; w < warps; ++w) s += warp_total[w];
      loss[blockIdx.x] = s / static_cast<float>(seg_rows);
    }
  }
}

// out[i] = sum over the splits, in order, of part[k, i] (i over M x D).
// With dfeats != 0 (K3's backward): out[row, d] = (sum - g[labels_row, d])
// * (gbar[row / seg_rows] / tau_m), tau_m = tau * seg_rows, gbar (one per
// segment of seg_rows rows) read from device memory; a label outside
// [0, N) gives NaN. out is bf16 when out_bf16, else fp32.
__global__ void merge_splits_kernel(const float* __restrict__ part, int S,
                                    int M, int D, int dfeats,
                                    const long long* __restrict__ labels,
                                    const float* __restrict__ g, int N,
                                    const float* __restrict__ gbar,
                                    int seg_rows, float tau_m, int out_bf16,
                                    void* __restrict__ out) {
  const size_t n = static_cast<size_t>(M) * D;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[static_cast<size_t>(k) * n + i];
  if (dfeats) {
    const long long label = labels[i / D];
    const float gv = (label >= 0 && label < N)
                         ? g[static_cast<size_t>(label) * D + i % D]
                         : NAN;
    s = (s - gv) * (gbar[i / D / seg_rows] / tau_m);
  }
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(out)[i] = s;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The "wgmma" lse partial pass (gallery_wgmma.cuh): without smem_split,
// first the split pre-pass into v_small [M, D] and g_small [N, D].
cudaError_t launch_lse_wgmma(int split, const float* v, const float* g,
                             float* v_small, float* g_small, int M, int N,
                             int D, float inv_tau, int tiles_per_split,
                             int splits, float* part_max, float* part_sum,
                             cudaStream_t stream) {
  using namespace gwgmma;
  cudaError_t err;
  const bool smem_split = split != kPrepass;
  if (!smem_split) {
    const size_t na4 = static_cast<size_t>(M) * D / 4;
    const size_t nb4 = static_cast<size_t>(N) * D / 4;
    const size_t blocks = std::min<size_t>((na4 + nb4 + 255) / 256, 4096);
    tf32_small_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        reinterpret_cast<const float4*>(v), reinterpret_cast<float4*>(v_small),
        na4, reinterpret_cast<const float4*>(g),
        reinterpret_cast<float4*>(g_small), nb4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap maps[4];
  const float* srcs[4] = {v, smem_split ? v : v_small, g,
                          smem_split ? g : g_small};
  for (int i = 0; i < 4; ++i) {
    err = wgmma_core::encode_tensor_map_2d(
        &maps[i], srcs[i], D, i < 2 ? M : N, kDepth, kRows,
        CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4);
    if (err != cudaSuccess) return err;
  }
  // Both instances' shared-memory limit, once per process (as in
  // fused_bn_mm.cu).
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        lse_wgmma_kernel<kPrepass>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     lse_wgmma_kernel<kSmem>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }();
  if (attr != cudaSuccess) return attr;
  auto kernel = lse_wgmma_kernel<kPrepass>;
  if (smem_split) kernel = lse_wgmma_kernel<kSmem>;
  const dim3 grid((M + kRows - 1) / kRows, splits);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], M, N, D, inv_tau, tiles_per_split,
      part_max, part_sum);
  return cudaGetLastError();
}

// The card's mma.sync m16n8k8 TF32 rate, the ceiling of the "tc" kernel:
// each warp runs `iters` rounds of 8 independent mma.sync on register
// operands (no loads), then writes one sum per thread so that nothing is
// dropped.
__global__ void __launch_bounds__(gcore::kThreads)
tc_peak_kernel(int iters, float* __restrict__ out) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(1.0f + 1e-3f * static_cast<float>(threadIdx.x + i));
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) gcore::mma_tf32(acc[j], a, b);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += acc[j][e];
  out[static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

extern "C" {

// route 0 ("simt", the fp32 FMA kernel), 2 ("wgmma", small halves by the
// pre-pass into v_small [M, D] and g_small [N, D]) or 3 ("wgmma", small
// halves in shared memory; v_small and g_small unused); 2 and 3 need
// D % 8 == 0, D <= 512, 16-byte aligned v and g. Row logsumexp
// of (v @ g^T) * inv_tau through [M, splits] partials part_max / part_sum,
// whose splits * tiles_per_split must cover the route's column tiles (128
// gallery rows on every route), then one merge in `mode` (see
// lse_merge_kernel): kLse and kDiag write out[M]; kCe writes out[M] = lse
// and loss[M / seg_rows], one mean per segment of seg_rows rows (seg_rows
// divides M), labels [M] int64.
int gallery_lse(int route, const void* v, const void* g, int M, int N, int D,
                float inv_tau, int splits, int tiles_per_split,
                void* part_max, void* part_sum, int mode, const void* labels,
                int seg_rows, void* out, void* loss, void* v_small,
                void* g_small, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  float* pm = static_cast<float*>(part_max);
  float* ps = static_cast<float*>(part_sum);
  if (route == 2 || route == 3) {
    if (D % 8 != 0 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = launch_lse_wgmma(
        route - 2, vf, gf, static_cast<float*>(v_small),
        static_cast<float*>(g_small), M, N, D, inv_tau, tiles_per_split,
        splits, pm, ps, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (route == 0) {
    const dim3 grid((M + kLseBM - 1) / kLseBM, splits);
    const bool vec4 = (D % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                      (reinterpret_cast<uintptr_t>(g) % 16 == 0);
    if (vec4) {
      lse_partial_kernel<true><<<grid, kLseThreads, 0, s>>>(
          vf, gf, M, N, D, inv_tau, tiles_per_split, pm, ps);
    } else {
      lse_partial_kernel<false><<<grid, kLseThreads, 0, s>>>(
          vf, gf, M, N, D, inv_tau, tiles_per_split, pm, ps);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // kCe: one block of 32 warps per segment (its loss sums in a fixed
  // order).
  if (mode == kCe && (seg_rows <= 0 || M % seg_rows != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps_per_block = mode == kCe ? 32 : 8;
  const int blocks =
      mode == kCe ? M / seg_rows : (M + warps_per_block - 1) / warps_per_block;
  lse_merge_kernel<<<blocks, 32 * warps_per_block, 0, s>>>(
      pm, ps, M, splits, vf, gf, N, D, inv_tau, mode,
      static_cast<const long long*>(labels), seg_rows,
      static_cast<float*>(out), static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

// softmax((v @ g^T) * inv_tau - lse) @ g through [splits, M, D] partials
// `part` (splits * tiles_per_split must cover the route's tiles: simt 64,
// tc 64 gallery rows up to D 256, else 32), then one merge: out[M, D] fp32 = the sum, or with
// dfeats != 0 K3's dfeats (see merge_splits_kernel; gbar one per segment
// of seg_rows rows, tau_m = tau * seg_rows), bf16 when out_bf16.
// Requires D <= 512; route 1 ("tc") also D % 8 == 0 and 16-byte aligned
// v and g.
int gallery_matvec(int route, const void* v, const void* g, const void* lse,
                   int M, int N, int D, float inv_tau, int splits,
                   int tiles_per_split, void* part, int dfeats,
                   const void* labels, const void* gbar, int seg_rows,
                   float tau_m, int out_bf16, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* lf = static_cast<const float*>(lse);
  float* pf = static_cast<float*>(part);
  cudaError_t err;
  if (D > 512 || (dfeats && (seg_rows <= 0 || M % seg_rows != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int Dpad = round_up(D, gcore::kDepth);
    if (Dpad <= 256) {
      err = launch_matvec_tc<64, 64, 2>(vf, gf, lf, M, N, D, Dpad, inv_tau,
                                        tiles_per_split, splits, pf, s);
    } else {
      err = launch_matvec_tc<32, 32, 2>(vf, gf, lf, M, N, D, Dpad, inv_tau,
                                        tiles_per_split, splits, pf, s);
    }
  } else {
    const int nj = (D + 31) / 32;
    if (nj <= 1) {
      err = launch_matvec<1>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
    } else if (nj <= 2) {
      err = launch_matvec<2>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
    } else if (nj <= 4) {
      err = launch_matvec<4>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
    } else if (nj <= 8) {
      err = launch_matvec<8>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
    } else {
      err = launch_matvec<16>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(M) * D;
  const int threads = 256;
  merge_splits_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                        threads, 0, s>>>(
      pf, splits, M, D, dfeats, static_cast<const long long*>(labels), gf, N,
      static_cast<const float*>(gbar), seg_rows, tau_m, out_bf16, out);
  return static_cast<int>(cudaGetLastError());
}

// tc_peak_kernel on `blocks` blocks of 256 threads; out holds blocks * 256
// floats. Each block does 8 warps x iters x 8 m16n8k8 products.
int gallery_tc_peak(int blocks, int iters, void* out, void* stream) {
  tc_peak_kernel<<<blocks, gcore::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// gwgmma::wgmma_peak_kernel on `blocks` blocks of 256 threads; out holds
// blocks * 256 floats. Each block does 2 warpgroups x iters x 12
// m64n128k8 products.
int gallery_wgmma_peak(int blocks, int iters, void* out, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      gwgmma::wgmma_peak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gwgmma::kPeakSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gwgmma::wgmma_peak_kernel<<<blocks, gwgmma::kConsumers,
                              gwgmma::kPeakSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
