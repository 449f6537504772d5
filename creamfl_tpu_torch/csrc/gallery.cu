// Gallery kernels for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas TPU kernels of creamfl_tpu/ops/pallas_gallery.py:
//   * lse_partial_kernel + lse_merge_kernel  <- row_logsumexp / _lse_kernel
//     (K1) and, with the diagonal folded into the merge pass,
//     conw_diag_pallas (K4);
//   * matvec_partial_kernel + sum_splits_kernel <- _softmax_matvec /
//     _softmax_matvec_kernel (K2), the backward of fused_gallery_ce (K3).
//
// What bounds them on an H100: both do 2*M*N*D (K1) or 4*M*N*D (K2) fp32
// FMA operations on inputs of (M + N) * D floats. At the main-path shapes
// (con_w: M = N = 50 000, D = 256; contrast CE: M = 128, N = 50 000) the
// arithmetic intensity is hundreds of operations per byte, so they are
// bound by fp32 FMA throughput (67 TFLOP/s outside the tensor cores), not by
// the 51 MB gallery read (~15 us at 3.35 TB/s).
//
// What the design does about it:
//   * The TPU grid walked the gallery's column blocks in order on one core,
//     carrying the running (max, sum) in VMEM. Here the column range is also
//     split across blocks (the split count is chosen from M by the host
//     wrapper), so that M = 128 still fills all 132 SMs. Each block writes a
//     partial (max, sum) per row -- or a partial [rows, D] product for K2 --
//     and a second small pass merges the splits in a fixed order
//     (deterministic; no float atomics).
//   * K1 is a register-tiled SGEMM (128 x 128 block tile, 8 x 8 per thread,
//     operands staged through shared memory) whose epilogue, instead of
//     storing logits, folds each tile into per-thread online-softmax
//     accumulators; the logits never leave registers.
//   * K2 stages one 64-row gallery tile in shared memory and uses it twice:
//     once for the logits (then p = exp(logit - lse)), once for p @ g_tile,
//     accumulated in registers (4 rows x D/32 columns per thread).
//   * Ragged M, N and any D (no padding of D to a lane multiple) are masked
//     inside the kernels. No TF32: plain fp32 FMAs, so results agree with
//     the fp32 plain versions up to summation order.
//
// C interface (bound with ctypes): every pointer and the stream are void*,
// every function returns the cudaError_t of its launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
// gallery's column tiles: part_max/part_sum[split, row].
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
      part_max[static_cast<size_t>(split) * M + row] = m;
      part_sum[static_cast<size_t>(split) * M + row] = s;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One warp per row: lse = max + log(sum) over the splits; with the diagonal,
// out = <v_row, g_row> - lse (con_w's diag(log_softmax(V G^T))).
__global__ void lse_merge_kernel(const float* __restrict__ part_max,
                                 const float* __restrict__ part_sum, int M,
                                 int S, const float* __restrict__ v,
                                 const float* __restrict__ g, int D,
                                 int with_diag, float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;  // uniform across the warp
  float m = -INFINITY;
  for (int s = lane; s < S; s += 32)
    m = fmaxf(m, part_max[static_cast<size_t>(s) * M + row]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float pm = part_max[static_cast<size_t>(s) * M + row];
    if (pm != -INFINITY)
      sum += part_sum[static_cast<size_t>(s) * M + row] * expf(pm - m);
  }
  sum = warp_sum(sum);
  float result = m + logf(sum);
  if (with_diag) {
    float dot = 0.f;
    for (int d = lane; d < D; d += 32)
      dot = fmaf(v[static_cast<size_t>(row) * D + d],
                 g[static_cast<size_t>(row) * D + d], dot);
    result = warp_sum(dot) - result;
  }
  if (lane == 0) out[row] = result;
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

__global__ void sum_splits_kernel(const float* __restrict__ part, int S,
                                  size_t n, float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += part[static_cast<size_t>(k) * n + i];
  out[i] = s;
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

}  // namespace

extern "C" {

// Row logsumexp of (v @ g^T) * inv_tau -> out[M]; with with_diag != 0 (and
// M == N) out[i] = <v_i, g_i> - lse_i instead. part_max / part_sum are
// [splits, M] scratch; splits * tiles_per_split must cover ceil(N / 128).
int gallery_row_lse(const void* v, const void* g, int M, int N, int D,
                    float inv_tau, int splits, int tiles_per_split,
                    void* part_max, void* part_sum, int with_diag, void* out,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  float* pm = static_cast<float*>(part_max);
  float* ps = static_cast<float*>(part_sum);
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_per_block = 8;
  lse_merge_kernel<<<(M + warps_per_block - 1) / warps_per_block,
                     32 * warps_per_block, 0, s>>>(
      pm, ps, M, splits, vf, gf, D, with_diag, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// softmax((v @ g^T) * inv_tau - lse) @ g -> out[M, D], given the row lse.
// part is [splits, M, D] scratch; splits * tiles_per_split must cover
// ceil(N / 64). Requires D <= 512.
int gallery_softmax_matvec(const void* v, const void* g, const void* lse,
                           int M, int N, int D, float inv_tau, int splits,
                           int tiles_per_split, void* part, void* out,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vf = static_cast<const float*>(v);
  const float* gf = static_cast<const float*>(g);
  const float* lf = static_cast<const float*>(lse);
  float* pf = static_cast<float*>(part);
  const int nj = (D + 31) / 32;
  cudaError_t err;
  if (nj <= 1) {
    err = launch_matvec<1>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
  } else if (nj <= 2) {
    err = launch_matvec<2>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
  } else if (nj <= 4) {
    err = launch_matvec<4>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
  } else if (nj <= 8) {
    err = launch_matvec<8>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
  } else if (nj <= 16) {
    err = launch_matvec<16>(vf, gf, lf, M, N, D, inv_tau, tiles_per_split, splits, pf, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(M) * D;
  const int threads = 256;
  sum_splits_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                      threads, 0, s>>>(pf, splits, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
