// Fused BatchNorm-normalise -> ReLU -> 1x1 conv with a BatchNorm-stats
// epilogue, and its backward, for Hopper (sm_90a); bf16 or fp32 operands,
// fp32 accumulation.
//
// Replaces the Pallas TPU kernels of creamfl_tpu/ops/fused_bn_mm.py:
//   * K5, _fwd_pallas / _fwd_kernel (creamfl_tpu/ops/fused_bn_mm.py:99):
//       y = relu?(x * inv + beta) @ W, plus the fp32 column sum and sum of
//       squares of the STORED y (rounded to the compute dtype); on two
//       routes, with the same conditions as K6's below:
//       - wgmma: fwd_activation_kernel (only where x needs the affine or
//         the relu) + fwd_wgmma_kernel (on the TMA + wgmma core) +
//         fwd_stats_merge_kernel;
//       - tiled: fwd_kernel + fwd_stats_merge_kernel;
//   * K6, _bwd_pallas / _bwd_kernel (creamfl_tpu/ops/fused_bn_mm.py:212):
//       dyt = dy + dssum + 2 y dssq (rounded to the compute dtype),
//       dx = (dyt W^T masked by the relu) * inv, dW = a^T dyt,
//       dinv = sum_m da * x, dbeta = sum_m da; on two routes:
//       - wgmma (bf16; K, N multiples of 8; 16-byte aligned bases):
//         bwd_prologue_kernel + bwd_dx_wgmma_kernel + bwd_dw_wgmma_kernel
//         (on the TMA + wgmma core of wgmma_core.cuh) + sum_splits_kernel
//         + sum_rows_kernel;
//       - tiled (fp32, or shapes TMA cannot describe): bwd_dx_kernel +
//         bwd_dw_kernel + the same merges.
// The identity variant (inv = 1, beta = 0 statically) skips the fp32
// affine and computes neither dinv nor dbeta.
//
// What bounds them on an H100: a 1x1 conv of the R101 trunk is an
// [M, K] x [K, N] product with M = B*H*W rows (6 272 to 401 408 at batch
// 128) and K, N between 64 and 2048: 2*M*K*N operations on (M*K + M*N)
// compute-dtype elements. At K = N = 64 (stage 1) that is 32 operations per
// byte, so the bytes bound it; from stage 2 on (K, N >= 128 and up to
// 2048) the bf16 tensor cores bound it (989 TFLOP/s dense).
//
// K6's wgmma route, and what it does about that:
//   * The prologue is one elementwise pass (16-byte loads and stores) that
//     writes dyt [M, N] and a = relu?(x * inv + beta) [M, K] in bf16, with
//     the same rounded fp32 steps as the tiled route's fetches (bit for bit
//     the plain version). Both products then read plain bf16 operands that
//     TMA can copy into swizzled shared memory: dx with both operands
//     K-major (dyt rows, and W held as [K, N]), dW with both MN-major
//     (a and dyt are stored [M][.], the depth m as the row), through
//     wgmma's transpose immediates. dW puts the larger of K and N on the
//     tile's 128 rows and is split over M into fp32 partials as below.
//   * The extra pass costs bytes: it reads dy, y, x and writes dyt and a,
//     about 1.8 KB a row at stage 1 (0.72 GB at M = 401 408, ~0.21 ms at
//     3.35 TB/s, beside a whole-K6 bound of 0.153 ms). From stage 2 on,
//     where the tensor cores bound the products, it costs little. Folding
//     it back into the operand path is a later step.
//   * The dx epilogue works from the accumulator registers: the relu mask
//     from the fp32 pre-activation recomputed from x, dx = bf16(da * inv),
//     and column partials of da * x and da reduced by warp shuffles and
//     then across the 8 warps in order.
//
// K5's wgmma route:
//   * Its one transformed operand is x. The identity variant without relu
//     (conv1 and the projections) needs no pass: TMA reads x itself. Else
//     one elementwise pass writes a = bf16(relu?(x * inv + beta)) [M, K]
//     (the same code as the a half of K6's prologue): 2 * M * K * 2 bytes,
//     0.10 GB at stage 1's conv3.
//   * The GEMM is plain: a (or x) and W [N, K] both K-major, B tile 64 or
//     128 columns. A product one depth step deep (K = 64) runs a one-stage
//     ring, so the stages it would not use cost it no occupancy.
//   * y is most of the bytes (M * N * 2: 0.21 GB of ~0.26 GB at stage 1's
//     conv3). The epilogue rounds each accumulator to bf16 once, sums the
//     rounded values and their squares per column (warp shuffles over the
//     8 lanes of a column, then the 8 warps in order), stages the rounded
//     tile in the free ring (16-byte chunks XOR-swizzled by row, so both
//     the register-layout writes and the row reads are free of bank
//     conflicts) and stores it as 16-byte row segments: a warp writes
//     whole 128- or 256-byte rows.
//
// K5 and K6's tiled route: one tiled GEMM core (128 x 64 block tile, depth
// step 32, 256 threads) serves all three of their products.
//   * The operands are staged through shared
//     memory by per-kernel "fetch" functions that apply the prologue on the
//     way in (the fp32 affine + relu of x, or the fold of the stat
//     cotangents into dy), so the normalised operand never exists in device
//     memory. A fetch reads 8 consecutive elements along the operand's
//     contiguous global dimension (one 16-byte load in bf16 when the rows
//     allow it; element by element at a ragged edge), and each tile keeps
//     that dimension contiguous in shared memory (row- or column-major as
//     the product needs). The next tile's loads are issued into registers
//     before the current tile is multiplied, so their latency overlaps the
//     tensor-core work.
//   * bf16: the product runs on the tensor cores through nvcuda::wmma
//     16x16x16 fragments with fp32 accumulators (8 warps, 32 x 32 each).
//     fp32: plain FMAs (8 x 4 per thread), so fp32 results agree with an
//     fp32 reference up to summation order (no TF32).
//   * The accumulator tile goes to shared memory once; the epilogue rounds
//     each value to the compute dtype, stores it and sums the ROUNDED value
//     (and its square) per column over the valid rows.
//   * Ragged M, K and N are masked in the fetches and epilogues: no padding
//     to 128 lanes, so K = 64 costs a 64-deep product.
//
// On both routes: the TPU grid ran its row blocks in order and carried the
// stats and dW in VMEM across them. Here row blocks run in parallel: each
// writes per-block column partials, and dW is split over M (the split
// count is chosen by the host from M and the dW tile count) into fp32
// partials. Small second passes merge them in a fixed order:
// deterministic, no float atomics. On the wgmma route TMA fills rows past
// M with zeros, which add nothing to dW, dinv or dbeta, and the epilogue
// stores no dx there.
//
// C interface (bound with ctypes): pointers and the stream are void*;
// dtype 0 = fp32, 1 = bf16; every function returns the cudaError_t of its
// launches (0 = success). The tiled functions take W as [N, K] row-major
// (torch's [out, in] conv weight) and return dW in the same layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_core.cuh"

namespace {

using namespace nvcuda;

constexpr int kBM = 128;      // tile rows (M for fwd/dx, N for dW)
constexpr int kBN = 64;       // tile cols (N for fwd, K for dx/dW)
constexpr int kBK = 32;       // depth step
constexpr int kPad = 8;       // shared-memory row padding (elements)
constexpr int kCPad = 4;      // padding of the fp32 accumulator tile
constexpr int kThreads = 256;
constexpr int kLdC = kBN + kCPad;
constexpr int kSmemC = kBM * kLdC * 4;        // 34 816 bytes
constexpr int kGroups = kThreads / kBN;       // row groups in an epilogue

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Operand staging: 8 consecutive elements along the contiguous dimension.
// ---------------------------------------------------------------------------

constexpr int kVec = 8;

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}
__device__ __forceinline__ bf16 lo(uint32_t u) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
}
__device__ __forceinline__ bf16 hi(uint32_t u) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
}

// One 16-byte (bf16) or two 16-byte (fp32) accesses; both ends aligned.
__device__ __forceinline__ void load8(const bf16* src, bf16 (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  v[0] = lo(u.x); v[1] = hi(u.x); v[2] = lo(u.y); v[3] = hi(u.y);
  v[4] = lo(u.z); v[5] = hi(u.z); v[6] = lo(u.w); v[7] = hi(u.w);
}
__device__ __forceinline__ void load8(const float* src, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* dst, const bf16 (&v)[kVec]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
      pack2(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* dst, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// v[j] = row[start + j] for start + j < len, else 0. ``vec``: the row is
// 16-byte aligned and len a multiple of 8, so a chunk starting at a multiple
// of 8 is whole or wholly out of range.
template <typename T>
__device__ __forceinline__ void load_masked(const T* __restrict__ row,
                                            int start, int len, bool vec,
                                            T (&v)[kVec]) {
  if (vec && start + kVec <= len) {
    load8(row + start, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    v[j] = start + j < len ? row[start + j] : from_f<T>(0.f);
}

template <typename T>
__device__ __forceinline__ void zero8(T (&v)[kVec]) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) v[j] = from_f<T>(0.f);
}

// A ROWS x kBK operand tile in shared memory. kDepthContig: element (r, d)
// at r * ld + d (depth contiguous); else at d * ld + r (rows contiguous).
template <int ROWS, bool kDepthContig>
struct Tile {
  static constexpr int kLd = kDepthContig ? kBK + kPad : ROWS + kPad;
  static constexpr int kElems = kDepthContig ? ROWS * kLd : kBK * kLd;
  __device__ static __forceinline__ int at(int r, int d) {
    return kDepthContig ? r * kLd + d : d * kLd + r;
  }
};

// One thread's share of a tile, held in registers between the global loads
// and the shared-memory stores, so the next tile's loads are in flight
// while the current tile is multiplied. Chunk c covers 8 elements along the
// tile's contiguous dimension; consecutive threads take consecutive chunks.
template <typename T, int ROWS, bool kDepthContig>
struct Stage {
  static constexpr int kChunks = ROWS * kBK / kVec / kThreads;
  static_assert(kChunks * kVec * kThreads == ROWS * kBK, "tile split");
  T v[kChunks][kVec];

  __device__ static __forceinline__ void coords(int c, int& r, int& d) {
    if (kDepthContig) {
      r = c / (kBK / kVec);
      d = (c % (kBK / kVec)) * kVec;
    } else {
      d = c / (ROWS / kVec);
      r = (c % (ROWS / kVec)) * kVec;
    }
  }
  // fetch(r, d, out): the 8 elements from (r, d) along the contiguous
  // dimension, with d the global depth index; 0 out of range.
  template <typename Fetch>
  __device__ __forceinline__ void fetch(int d0, const Fetch& f) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int r, d;
      coords(threadIdx.x + i * kThreads, r, d);
      f(r, d0 + d, v[i]);
    }
  }
  __device__ __forceinline__ void store(T* s) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int r, d;
      coords(threadIdx.x + i * kThreads, r, d);
      store8(s + Tile<ROWS, kDepthContig>::at(r, d), v[i]);
    }
  }
};

// bf16 product on the tensor cores: 8 warps in 4 x 2, 32 x 32 each.
template <bool kADepth, bool kBDepth>
struct WmmaCore {
  using TA = Tile<kBM, kADepth>;
  using TB = Tile<kBN, kBDepth>;
  using LayA = typename std::conditional<kADepth, wmma::row_major,
                                         wmma::col_major>::type;
  using LayB = typename std::conditional<kBDepth, wmma::col_major,
                                         wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  int wr, wc;

  __device__ __forceinline__ WmmaCore() {
    const int warp = threadIdx.x / 32;
    wr = warp / 2;
    wc = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  __device__ __forceinline__ void step(const bf16* As, const bf16* Bs) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + TA::at(wr * 32 + i * 16, kk),
                               TA::kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + TB::at(wc * 32 + j * 16, kk),
                               TB::kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + (wr * 32 + i * 16) * kLdC + wc * 32 + j * 16, acc[i][j],
            kLdC, wmma::mem_row_major);
  }
};

// fp32 product with plain FMAs: 8 x 4 outputs per thread.
template <bool kADepth, bool kBDepth>
struct SimtCore {
  using TA = Tile<kBM, kADepth>;
  using TB = Tile<kBN, kBDepth>;
  float acc[8][4];
  int tr, tc;

  __device__ __forceinline__ SimtCore() {
    tr = threadIdx.x / 16;
    tc = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ __forceinline__ void step(const float* As, const float* Bs) {
#pragma unroll 4
    for (int d = 0; d < kBK; ++d) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[TA::at(tr + 16 * i, d)];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[TB::at(tc + 16 * j, d)];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(tr + 16 * i) * kLdC + tc + 16 * j] = acc[i][j];
  }
};

// C[kBM, kBN] = sum over depth [d_begin, d_end) of A(r, d) * B(d, c). The
// fetches fill 8-element chunks of A (rows r, depth d) and B (cols c, depth
// d) and return 0 out of range. The fp32 result is left in shared memory at
// smem[r * kLdC + c].
template <typename T, bool kADepth, bool kBDepth, typename FetchA,
          typename FetchB>
__device__ void gemm_tile(unsigned char* smem, int d_begin, int d_end,
                          const FetchA& fetch_a, const FetchB& fetch_b) {
  using TA = Tile<kBM, kADepth>;
  using TB = Tile<kBN, kBDepth>;
  using Core = typename std::conditional<std::is_same<T, bf16>::value,
                                         WmmaCore<kADepth, kBDepth>,
                                         SimtCore<kADepth, kBDepth>>::type;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + TA::kElems;
  static_assert((TA::kElems + TB::kElems) * sizeof(T) <= kSmemC,
                "operand tiles must fit in the accumulator tile's memory");
  Stage<T, kBM, kADepth> sa;
  Stage<T, kBN, kBDepth> sb;
  Core core;
  sa.fetch(d_begin, fetch_a);
  sb.fetch(d_begin, fetch_b);
  sa.store(As);
  sb.store(Bs);
  __syncthreads();
  for (int d0 = d_begin; d0 < d_end; d0 += kBK) {
    const bool more = d0 + kBK < d_end;
    if (more) {
      sa.fetch(d0 + kBK, fetch_a);
      sb.fetch(d0 + kBK, fetch_b);
    }
    core.step(As, Bs);
    __syncthreads();
    if (more) {
      sa.store(As);
      sb.store(Bs);
      __syncthreads();
    }
  }
  core.store(reinterpret_cast<float*>(smem));
  __syncthreads();
}

// The operand a = relu?(x * inv + beta), rounded to the compute dtype. The
// affine is one fp32 multiply and one fp32 add, each rounded (no FMA), as
// in the plain version.
template <typename T, bool kAffine, bool kRelu>
__device__ __forceinline__ T activation(T xv, const float* __restrict__ inv,
                                        const float* __restrict__ beta,
                                        int k) {
  if (kAffine) {
    float a = __fadd_rn(__fmul_rn(to_f(xv), inv[k]), beta[k]);
    if (kRelu) a = fmaxf(a, 0.f);
    return from_f<T>(a);
  }
  if (kRelu) return to_f(xv) > 0.f ? xv : from_f<T>(0.f);
  return xv;
}

// a(m, k .. k+7) from row m of x.
template <typename T, bool kAffine, bool kRelu>
__device__ __forceinline__ void activation8(
    const T* __restrict__ x, const float* __restrict__ inv,
    const float* __restrict__ beta, int m, int k, int K, bool vec,
    T (&o)[kVec]) {
  load_masked(x + static_cast<size_t>(m) * K, k, K, vec, o);
  if (!kAffine && !kRelu) return;
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (k + j < K) o[j] = activation<T, kAffine, kRelu>(o[j], inv, beta,
                                                         k + j);
}

// dyt(m, n .. n+7) = dy + dssum + 2 y dssq in fp32 from the stored y,
// rounded; 0 for n >= N.
template <typename T>
__device__ __forceinline__ void fold8(const T* __restrict__ dy,
                                      const T* __restrict__ y,
                                      const float* __restrict__ dssum,
                                      const float* __restrict__ dssq, int m,
                                      int n, int N, bool vec, T (&o)[kVec]) {
  T yv[kVec];
  const size_t row = static_cast<size_t>(m) * N;
  load_masked(dy + row, n, N, vec, o);
  load_masked(y + row, n, N, vec, yv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (n + j < N) {
      const float t = __fadd_rn(__fadd_rn(to_f(o[j]), dssum[n + j]),
                                __fmul_rn(2.f * to_f(yv[j]), dssq[n + j]));
      o[j] = from_f<T>(t);
    }
  }
}

// Per-column sums of a tile's epilogue values: each of kGroups row groups
// has summed its rows into red[group][col]; group 0 adds them in order.
__device__ __forceinline__ void write_column_partial(float* red, int c,
                                                     int group, bool valid,
                                                     float* out) {
  __syncthreads();
  if (group == 0 && valid) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += red[g * kBN + c];
    *out = s;
  }
}

// ---------------------------------------------------------------------------
// K5: y[M, N] = act(x)[M, K] @ W^T, W [N, K]; column partials of y, y^2.
// grid (ceil(N / kBN), ceil(M / kBM)); part [gridDim.y, 2N]: a block's
// row holds its N column sums, then its N sums of squares. vec_k: x and W
// rows take 16-byte loads (K % 8 == 0, aligned).
// ---------------------------------------------------------------------------
template <typename T, bool kAffine, bool kRelu>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const float* __restrict__ inv, const float* __restrict__ beta,
           int M, int K, int N, bool vec_k, T* __restrict__ y,
           float* __restrict__ part) {
  __shared__ __align__(128) unsigned char smem[kSmemC];
  __shared__ float red_s[kGroups * kBN], red_q[kGroups * kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  auto fetch_a = [&](int r, int k, T (&o)[kVec]) {  // a(m, k..k+7)
    const int m = m0 + r;
    if (m >= M) return zero8(o);
    activation8<T, kAffine, kRelu>(x, inv, beta, m, k, K, vec_k, o);
  };
  auto fetch_b = [&](int c, int k, T (&o)[kVec]) {  // W(n, k..k+7)
    const int n = n0 + c;
    if (n >= N) return zero8(o);
    load_masked(w + static_cast<size_t>(n) * K, k, K, vec_k, o);
  };
  gemm_tile<T, true, true>(smem, 0, K, fetch_a, fetch_b);
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int c = threadIdx.x % kBN, group = threadIdx.x / kBN;
  const int n = n0 + c;
  float s = 0.f, q = 0.f;
  if (n < N) {
    for (int r = group; r < kBM; r += kGroups) {
      const int m = m0 + r;
      if (m >= M) break;
      const T v = from_f<T>(Cs[r * kLdC + c]);
      y[static_cast<size_t>(m) * N + n] = v;
      const float f = to_f(v);
      s += f;
      q += f * f;
    }
  }
  red_s[group * kBN + c] = s;
  red_q[group * kBN + c] = q;
  const size_t at = static_cast<size_t>(blockIdx.y) * 2 * N + n;
  write_column_partial(red_s, c, group, n < N, part + at);
  write_column_partial(red_q, c, group, n < N, part + at + N);
}

// ---------------------------------------------------------------------------
// K6, part 1: da[M, K] = dyt @ W (W [N, K]); relu mask; dx = da * inv;
// column partials of da * x and da. grid (ceil(K / kBN), ceil(M / kBM)).
// vec_n: dy and y rows take 16-byte loads; vec_k: W rows do.
// ---------------------------------------------------------------------------
template <typename T, bool kAffine, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ inv, const float* __restrict__ beta,
              const T* __restrict__ y, const T* __restrict__ dy,
              const float* __restrict__ dssum,
              const float* __restrict__ dssq, int M, int K, int N,
              bool vec_k, bool vec_n, T* __restrict__ dx,
              float* __restrict__ part_dinv, float* __restrict__ part_dbeta) {
  __shared__ __align__(128) unsigned char smem[kSmemC];
  __shared__ float red_i[kGroups * kBN], red_b[kGroups * kBN];
  const int m0 = blockIdx.y * kBM, k0 = blockIdx.x * kBN;
  auto fetch_a = [&](int r, int n, T (&o)[kVec]) {  // dyt(m, n..n+7)
    const int m = m0 + r;
    if (m >= M) return zero8(o);
    fold8(dy, y, dssum, dssq, m, n, N, vec_n, o);
  };
  auto fetch_b = [&](int c, int n, T (&o)[kVec]) {  // W(n, k..k+7)
    if (n >= N) return zero8(o);
    load_masked(w + static_cast<size_t>(n) * K, k0 + c, K, vec_k, o);
  };
  gemm_tile<T, true, false>(smem, 0, N, fetch_a, fetch_b);
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int c = threadIdx.x % kBN, group = threadIdx.x / kBN;
  const int k = k0 + c;
  float si = 0.f, sb = 0.f;
  if (k < K) {
    const float iv = kAffine ? inv[k] : 1.f;
    const float bt = kAffine ? beta[k] : 0.f;
    for (int r = group; r < kBM; r += kGroups) {
      const int m = m0 + r;
      if (m >= M) break;
      const size_t at = static_cast<size_t>(m) * K + k;
      float da = Cs[r * kLdC + c];
      const float xv = to_f(x[at]);
      if (kAffine) {
        const float a = __fadd_rn(__fmul_rn(xv, iv), bt);
        if (kRelu && !(a > 0.f)) da = 0.f;
        dx[at] = from_f<T>(__fmul_rn(da, iv));
        si += da * xv;
        sb += da;
      } else {
        if (kRelu && !(xv > 0.f)) da = 0.f;
        dx[at] = from_f<T>(da);
      }
    }
  }
  if (kAffine) {
    red_i[group * kBN + c] = si;
    red_b[group * kBN + c] = sb;
    const size_t at = static_cast<size_t>(blockIdx.y) * K + k;
    write_column_partial(red_i, c, group, k < K, part_dinv + at);
    write_column_partial(red_b, c, group, k < K, part_dbeta + at);
  }
}

// ---------------------------------------------------------------------------
// K6, part 2: dW[N, K] partials = sum over this split's rows m of
// dyt(m, n) * a(m, k). grid (ceil(K / kBN), ceil(N / kBM), splits);
// part [splits, N, K].
// ---------------------------------------------------------------------------
template <typename T, bool kAffine, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bwd_dw_kernel(const T* __restrict__ x, const float* __restrict__ inv,
              const float* __restrict__ beta, const T* __restrict__ y,
              const T* __restrict__ dy, const float* __restrict__ dssum,
              const float* __restrict__ dssq, int M, int K, int N,
              bool vec_k, bool vec_n, int rows_per_split,
              float* __restrict__ part) {
  __shared__ __align__(128) unsigned char smem[kSmemC];
  const int n0 = blockIdx.y * kBM, k0 = blockIdx.x * kBN;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);
  auto fetch_a = [&](int r, int m, T (&o)[kVec]) {  // dyt(m, n..n+7)
    if (m >= m_end) return zero8(o);
    fold8(dy, y, dssum, dssq, m, n0 + r, N, vec_n, o);
  };
  auto fetch_b = [&](int c, int m, T (&o)[kVec]) {  // a(m, k..k+7)
    if (m >= m_end) return zero8(o);
    activation8<T, kAffine, kRelu>(x, inv, beta, m, k0 + c, K, vec_k, o);
  };
  gemm_tile<T, false, false>(smem, m_begin, m_end, fetch_a, fetch_b);
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int c = threadIdx.x % kBN, group = threadIdx.x / kBN;
  const int k = k0 + c;
  if (k >= K) return;
  for (int r = group; r < kBM; r += kGroups) {
    const int n = n0 + r;
    if (n >= N) break;
    part[(static_cast<size_t>(blockIdx.z) * N + n) * K + k] =
        Cs[r * kLdC + c];
  }
}

// out[i] = sum over s (in order) of part[s * count + i], rounded to T.
template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits,
                                  size_t count, T* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[static_cast<size_t>(k) * count + i];
  out[i] = from_f<T>(s);
}

// out[c] = sum over rows of part[row, c]: 32 columns x 32 row groups per
// block; each group sums its rows in order, then group 0 adds the groups in
// order (deterministic).
constexpr int kSumCols = 32, kSumGroups = 32;
__device__ __forceinline__ void sum_rows_block(const float* __restrict__ part,
                                               int rows, int cols,
                                               float* __restrict__ out) {
  __shared__ float red[kSumGroups][kSumCols + 1];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  const int g = threadIdx.y;
  float s = 0.f;
  if (c < cols)
    for (int r = g; r < rows; r += kSumGroups)
      s += part[static_cast<size_t>(r) * cols + c];
  red[g][threadIdx.x] = s;
  __syncthreads();
  if (g == 0 && c < cols) {
    float t = 0.f;
    for (int k = 0; k < kSumGroups; ++k) t += red[k][threadIdx.x];
    out[c] = t;
  }
}

// K6's merges of dinv / dbeta.
__global__ void sum_rows_kernel(const float* __restrict__ part, int rows,
                                int cols, float* __restrict__ out) {
  sum_rows_block(part, rows, cols, out);
}

// K5's merge of its [blocks, 2N] stat partials into [2N]: the same sum,
// under its own name so that a profile tells K5's time from K6's.
__global__ void fwd_stats_merge_kernel(const float* __restrict__ part,
                                       int rows, int cols,
                                       float* __restrict__ out) {
  sum_rows_block(part, rows, cols, out);
}

const dim3 kSumBlock(kSumCols, kSumGroups);

cudaError_t sum_rows(const float* part, int rows, int cols, float* out,
                     cudaStream_t s) {
  sum_rows_kernel<<<(cols + kSumCols - 1) / kSumCols, kSumBlock, 0, s>>>(
      part, rows, cols, out);
  return cudaGetLastError();
}

cudaError_t merge_stats(const float* part, int rows, int n, float* stats,
                        cudaStream_t s) {
  fwd_stats_merge_kernel<<<(2 * n + kSumCols - 1) / kSumCols, kSumBlock, 0,
                           s>>>(part, rows, 2 * n, stats);
  return cudaGetLastError();
}

inline unsigned cdiv(int a, int b) { return static_cast<unsigned>((a + b - 1) / b); }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool kAffine, bool kRelu>
cudaError_t forward(const void* x, const void* w, const void* inv,
                    const void* beta, int M, int K, int N, void* y,
                    void* part, void* stats, cudaStream_t s) {
  const dim3 grid(cdiv(N, kBN), cdiv(M, kBM));
  const bool vec_k = K % kVec == 0 && aligned16(x) && aligned16(w);
  fwd_kernel<T, kAffine, kRelu><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(inv), static_cast<const float*>(beta), M, K,
      N, vec_k, static_cast<T*>(y), static_cast<float*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_stats(static_cast<const float*>(part), grid.y, N,
                     static_cast<float*>(stats), s);
}

template <typename T, bool kAffine, bool kRelu>
cudaError_t backward(const void* x, const void* w, const void* inv,
                     const void* beta, const void* y, const void* dy,
                     const void* dssum, const void* dssq, int M, int K, int N,
                     int splits, int rows_per_split, void* dx, void* part_dw,
                     void* dw, void* part_dinv, void* part_dbeta, void* dinv,
                     void* dbeta, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* invf = static_cast<const float*>(inv);
  const float* betaf = static_cast<const float*>(beta);
  const T* yt = static_cast<const T*>(y);
  const T* dyt = static_cast<const T*>(dy);
  const float* dsum = static_cast<const float*>(dssum);
  const float* dsq = static_cast<const float*>(dssq);
  const dim3 grid_dx(cdiv(K, kBN), cdiv(M, kBM));
  const bool vec_k = K % kVec == 0 && aligned16(x) && aligned16(w);
  const bool vec_n = N % kVec == 0 && aligned16(y) && aligned16(dy);
  bwd_dx_kernel<T, kAffine, kRelu><<<grid_dx, kThreads, 0, s>>>(
      xt, static_cast<const T*>(w), invf, betaf, yt, dyt, dsum, dsq, M, K, N,
      vec_k, vec_n, static_cast<T*>(dx), static_cast<float*>(part_dinv),
      static_cast<float*>(part_dbeta));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dw(cdiv(K, kBN), cdiv(N, kBM), splits);
  bwd_dw_kernel<T, kAffine, kRelu><<<grid_dw, kThreads, 0, s>>>(
      xt, invf, betaf, yt, dyt, dsum, dsq, M, K, N, vec_k, vec_n,
      rows_per_split, static_cast<float*>(part_dw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(N) * K;
  sum_splits_kernel<T><<<static_cast<unsigned>((count + 255) / 256), 256, 0,
                         s>>>(static_cast<const float*>(part_dw), splits,
                              count, static_cast<T*>(dw));
  err = cudaGetLastError();
  if (err != cudaSuccess || !kAffine) return err;
  err = sum_rows(static_cast<const float*>(part_dinv), grid_dx.y, K,
                 static_cast<float*>(dinv), s);
  if (err != cudaSuccess) return err;
  return sum_rows(static_cast<const float*>(part_dbeta), grid_dx.y, K,
                  static_cast<float*>(dbeta), s);
}

// ===========================================================================
// The wgmma routes of K5 and K6 (bf16, K % 8 == 0, N % 8 == 0, 16-byte
// aligned bases): elementwise passes, then plain GEMMs on the TMA + wgmma
// core of wgmma_core.cuh, then the same merges as above.
// ===========================================================================

// Chunk i (8 elements; K % 8 == 0, so within one row) of a = bf16(relu?(x *
// inv + beta)) [M, K] (relu?(x) on the identity variant): one 16-byte load
// and store, rounded as in ``activation``, so bit for bit the plain version.
template <bool kAffine, bool kRelu>
__device__ __forceinline__ void activation_chunk(
    const bf16* __restrict__ x, const float* __restrict__ inv,
    const float* __restrict__ beta, int K, size_t i, bf16* __restrict__ a) {
  const size_t e = i * kVec;
  const int k = static_cast<int>(e % K);
  bf16 v[kVec];
  load8(x + e, v);
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    v[j] = activation<bf16, kAffine, kRelu>(v[j], inv, beta, k + j);
  store8(a + e, v);
}

// K5's pass: a over [M, K], one thread per chunk.
template <bool kAffine, bool kRelu>
__global__ void __launch_bounds__(256)
fwd_activation_kernel(const bf16* __restrict__ x,
                      const float* __restrict__ inv,
                      const float* __restrict__ beta, size_t chunks, int K,
                      bf16* __restrict__ a) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < chunks) activation_chunk<kAffine, kRelu>(x, inv, beta, K, i, a);
}

// y[M, N] = A[M, K] . W^T (A = a, or x itself; W [N, K]: both operands
// K-major, as in bwd_dx_wgmma_kernel), over a ring of S stages. Epilogue:
// each accumulator rounded to bf16 once; per-block column partials of the
// rounded y and y^2 over the rows < M (warp shuffles over the 8 lanes that
// share a column, then the 8 warps in order) into part [ceil(M / 128), 2N]
// (a block's N sums, then its N sums of squares); the rounded tile staged
// in the free ring and stored as 16-byte row segments, no row past M.
// grid (ceil(N / BN), ceil(M / 128)).
template <int BN, int S>
__global__ void __launch_bounds__(wgmma_core::kThreads)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w, int M, int K,
                 int N, bf16* __restrict__ y, float* __restrict__ part) {
  using namespace wgmma_core;
  extern __shared__ unsigned char smem[];
  __shared__ float red[2][8][BN];  // [sum | square][warp][tile column]
  const int m0 = blockIdx.y * kTileRows, n0 = blockIdx.x * BN;
  float acc[BN / 2];
  auto issue = [&](uint32_t a_dst, uint32_t b_dst, uint32_t bar, int kt) {
    mbar_expect_tx(bar, Ring<BN, S>::kStageBytes);
    tma_load_2d(a_dst, &map_a, kt * kDepth, m0, bar);
    tma_load_2d(b_dst, &map_w, kt * kDepth, n0, bar);
  };
  mainloop<BN, false, S>(smem, (K + kDepth - 1) / kDepth, issue, acc);

  // The rounded tile, 128 rows of BN / 8 16-byte chunks; chunk j of row r
  // at r * BN / 8 + (j ^ (r & 7)). It fits in the ring's first stage.
  constexpr int kChunks = BN / 8;
  static_assert(kTileRows * BN * 2 <= Ring<BN, S>::kStageBytes,
                "the y tile fits in one stage");
  const int row0 = (threadIdx.x >> 7) * 64;  // this warpgroup's tile rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the ring is free
  uint32_t* tile = reinterpret_cast<uint32_t*>(ring_base(smem));
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = acc_col(4 * j);  // = 8j + 2 (lane & 3): chunk j
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + acc_row(4 * j + 2 * h);
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                     acc[4 * j + 2 * h + 1]);
      tile[(r * kChunks + (j ^ (r & 7))) * 4 + (lane & 3)] =
          *reinterpret_cast<const uint32_t*>(&v);
      if (m0 + r < M) {
        const float f0 = __low2float(v), f1 = __high2float(v);
        s0 += f0;
        s1 += f1;
        q0 += f0 * f0;
        q1 += f1 * f1;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      q0 += __shfl_xor_sync(0xffffffffu, q0, o);
      q1 += __shfl_xor_sync(0xffffffffu, q1, o);
    }
    if (lane < 4) {
      red[0][warp][c] = s0;
      red[0][warp][c + 1] = s1;
      red[1][warp][c] = q0;
      red[1][warp][c + 1] = q1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * BN) {
    const int which = threadIdx.x / BN, t = threadIdx.x % BN;
    if (n0 + t < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[which][w][t];
      part[static_cast<size_t>(blockIdx.y) * 2 * N + which * N + n0 + t] = s;
    }
  }
  const uint4* tile16 = reinterpret_cast<const uint4*>(tile);
  static_assert(kTileRows * kChunks % kThreads == 0, "whole store rounds");
#pragma unroll
  for (int it = 0; it < kTileRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, j = i % kChunks;
    const int m = m0 + r, n = n0 + 8 * j;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(m) * N + n) =
          tile16[r * kChunks + (j ^ (r & 7))];
  }
}

template <int BN, int S>
cudaError_t launch_fwd_wgmma(const bf16* act, const bf16* w_nk, int M, int K,
                             int N, bf16* y, float* part, cudaStream_t s) {
  using R = wgmma_core::Ring<BN, S>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fwd_wgmma_kernel<BN, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_a, map_w;
  cudaError_t err = wgmma_core::encode_tensor_map_2d(
      &map_a, act, K, M, wgmma_core::kDepth, wgmma_core::kTileRows);
  if (err != cudaSuccess) return err;
  err = wgmma_core::encode_tensor_map_2d(&map_w, w_nk, K, N,
                                         wgmma_core::kDepth, BN);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(N, BN), cdiv(M, wgmma_core::kTileRows));
  fwd_wgmma_kernel<BN, S><<<grid, wgmma_core::kThreads, R::kSmemBytes, s>>>(
      map_a, map_w, M, K, N, y, part);
  return cudaGetLastError();
}

// One depth step (K <= 64) takes the one-stage ring.
template <int BN>
cudaError_t fwd_gemm(const bf16* act, const bf16* w_nk, int M, int K, int N,
                     bf16* y, float* part, cudaStream_t s) {
  return K <= wgmma_core::kDepth
             ? launch_fwd_wgmma<BN, 1>(act, w_nk, M, K, N, y, part, s)
             : launch_fwd_wgmma<BN, wgmma_core::Ring<BN>::kStages>(
                   act, w_nk, M, K, N, y, part, s);
}

template <bool kAffine, bool kRelu>
cudaError_t forward_wgmma(const void* x, const void* w_nk, const void* inv,
                          const void* beta, int M, int K, int N, int bn,
                          void* a, void* y, void* part, void* stats,
                          cudaStream_t s) {
  const bf16* act = static_cast<const bf16*>(x);
  if (kAffine || kRelu) {
    const size_t chunks = static_cast<size_t>(M) * K / kVec;
    fwd_activation_kernel<kAffine, kRelu>
        <<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
            act, static_cast<const float*>(inv),
            static_cast<const float*>(beta), chunks, K, static_cast<bf16*>(a));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    act = static_cast<const bf16*>(a);
  }
  const bf16* w = static_cast<const bf16*>(w_nk);
  bf16* yb = static_cast<bf16*>(y);
  float* pf = static_cast<float*>(part);
  const cudaError_t err =
      bn == 128 ? fwd_gemm<128>(act, w, M, K, N, yb, pf, s)
                : fwd_gemm<64>(act, w, M, K, N, yb, pf, s);
  if (err != cudaSuccess) return err;
  return merge_stats(pf, static_cast<int>(cdiv(M, wgmma_core::kTileRows)), N,
                     static_cast<float*>(stats), s);
}

// dyt = bf16((dy + dssum) + 2y * dssq) over [M, N], and a = bf16(relu?(x *
// inv + beta)) over [M, K] (relu?(x) on the identity variant; no a at all
// without affine and relu: the GEMM reads x). One thread per 8 elements,
// 16-byte loads and stores; dyt chunks first, then a chunks. The rounding
// steps are those of fold8 and activation, so the pass equals the plain
// version bit for bit.
template <bool kAffine, bool kRelu>
__global__ void __launch_bounds__(256)
bwd_prologue_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ y,
                    const float* __restrict__ dssum,
                    const float* __restrict__ dssq,
                    const bf16* __restrict__ x, const float* __restrict__ inv,
                    const float* __restrict__ beta, size_t chunks_dyt,
                    size_t chunks_a, int N, int K, bf16* __restrict__ dyt,
                    bf16* __restrict__ a) {
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < chunks_dyt) {
    const size_t e = i * kVec;
    const int n = static_cast<int>(e % N);
    bf16 v[kVec], yv[kVec];
    load8(dy + e, v);
    load8(y + e, yv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = from_f<bf16>(__fadd_rn(__fadd_rn(to_f(v[j]), dssum[n + j]),
                                    __fmul_rn(2.f * to_f(yv[j]), dssq[n + j])));
    store8(dyt + e, v);
    return;
  }
  i -= chunks_dyt;
  if (i < chunks_a) activation_chunk<kAffine, kRelu>(x, inv, beta, K, i, a);
}

// da[M, K] = dyt[M, N] . W (W held as [K, N]: both operands K-major, the
// depth n contiguous). Epilogue from the accumulator registers: the relu
// mask from the fp32 pre-activation recomputed from x, dx = bf16(da * inv),
// and per-block column partials of da * x and da (warp shuffles over the
// 8 lanes that share a column, then the 8 warps in order through shared
// memory) into part_dinv / part_dbeta [ceil(M / 128), K].
// grid (ceil(K / BN), ceil(M / 128)).
template <int BN, bool kAffine, bool kRelu>
__global__ void __launch_bounds__(wgmma_core::kThreads)
bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap map_dyt,
                    const __grid_constant__ CUtensorMap map_w,
                    const bf16* __restrict__ x,
                    const float* __restrict__ inv,
                    const float* __restrict__ beta, int M, int K, int N,
                    bf16* __restrict__ dx, float* __restrict__ part_dinv,
                    float* __restrict__ part_dbeta) {
  using namespace wgmma_core;
  extern __shared__ unsigned char smem[];
  const int m0 = blockIdx.y * kTileRows, k0 = blockIdx.x * BN;
  float acc[BN / 2];
  auto issue = [&](uint32_t a_dst, uint32_t b_dst, uint32_t bar, int kt) {
    mbar_expect_tx(bar, Ring<BN>::kStageBytes);
    tma_load_2d(a_dst, &map_dyt, kt * kDepth, m0, bar);
    tma_load_2d(b_dst, &map_w, kt * kDepth, k0, bar);
  };
  mainloop<BN, false>(smem, (N + kDepth - 1) / kDepth, issue, acc);

  const int row0 = m0 + (threadIdx.x >> 7) * 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the ring is free: column partials go there
  float* red_i = reinterpret_cast<float*>(ring_base(smem));
  float* red_b = red_i + 8 * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = acc_col(4 * j), k = k0 + c;
    float si0 = 0.f, si1 = 0.f, sb0 = 0.f, sb1 = 0.f;
    if (k < K) {
      const float iv0 = kAffine ? inv[k] : 1.f, iv1 = kAffine ? inv[k + 1] : 1.f;
      const float bt0 = kAffine ? beta[k] : 0.f;
      const float bt1 = kAffine ? beta[k + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + acc_row(4 * j + 2 * h);
        if (m >= M) continue;
        const size_t at = static_cast<size_t>(m) * K + k;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + at);
        const float x0 = __low2float(xv), x1 = __high2float(xv);
        float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
        if (kAffine) {
          if (kRelu && !(__fadd_rn(__fmul_rn(x0, iv0), bt0) > 0.f)) d0 = 0.f;
          if (kRelu && !(__fadd_rn(__fmul_rn(x1, iv1), bt1) > 0.f)) d1 = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(dx + at) =
              __floats2bfloat162_rn(__fmul_rn(d0, iv0), __fmul_rn(d1, iv1));
          si0 += d0 * x0;
          si1 += d1 * x1;
          sb0 += d0;
          sb1 += d1;
        } else {
          if (kRelu && !(x0 > 0.f)) d0 = 0.f;
          if (kRelu && !(x1 > 0.f)) d1 = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(dx + at) =
              __floats2bfloat162_rn(d0, d1);
        }
      }
    }
    if (kAffine) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        si0 += __shfl_xor_sync(0xffffffffu, si0, o);
        si1 += __shfl_xor_sync(0xffffffffu, si1, o);
        sb0 += __shfl_xor_sync(0xffffffffu, sb0, o);
        sb1 += __shfl_xor_sync(0xffffffffu, sb1, o);
      }
      if (lane < 4) {
        red_i[warp * BN + c] = si0;
        red_i[warp * BN + c + 1] = si1;
        red_b[warp * BN + c] = sb0;
        red_b[warp * BN + c + 1] = sb1;
      }
    }
  }
  if (!kAffine) return;
  __syncthreads();
  const int t = threadIdx.x % BN;
  const float* red = threadIdx.x < BN ? red_i : red_b;
  float* part = threadIdx.x < BN ? part_dinv : part_dbeta;
  if (threadIdx.x < 2 * BN && k0 + t < K) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * BN + t];
    part[static_cast<size_t>(blockIdx.y) * K + k0 + t] = s;
  }
}

// C[R, C] partials over one split of the rows m: C(r, c) = sum over m of
// P[m, r] * Q[m, c], both operands stored [M][.] (MN-major for wgmma).
// The host passes (P, Q) = (a, dyt) for dW [K, N] or (dyt, a) for dW^T
// [N, K], whichever puts the larger width on the 128-row side.
// grid (ceil(C / BN), ceil(R / 128), splits); part [splits, R, C] fp32.
template <int BN>
__global__ void __launch_bounds__(wgmma_core::kThreads)
bwd_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_p,
                    const __grid_constant__ CUtensorMap map_q, int R, int C,
                    int M, int rows_per_split, float* __restrict__ part) {
  using namespace wgmma_core;
  extern __shared__ unsigned char smem[];
  const int r0 = blockIdx.y * kTileRows, c0 = blockIdx.x * BN;
  const int m_begin = blockIdx.z * rows_per_split;
  const int rows = min(rows_per_split, M - m_begin);
  // A box wholly past R (R = 64) is not loaded: the warpgroup that reads
  // it computes rows that are never stored.
  const int a_boxes = R - r0 > 64 ? 2 : 1;
  float acc[BN / 2];
  auto issue = [&](uint32_t a_dst, uint32_t b_dst, uint32_t bar, int kt) {
    const int m = m_begin + kt * kDepth;
    mbar_expect_tx(bar, (a_boxes + BN / 64) * kBoxBytes);
    for (int b = 0; b < a_boxes; ++b)
      tma_load_2d(a_dst + b * kBoxBytes, &map_p, r0 + 64 * b, m, bar);
    for (int b = 0; b < BN / 64; ++b)
      tma_load_2d(b_dst + b * kBoxBytes, &map_q, c0 + 64 * b, m, bar);
  };
  mainloop<BN, true>(smem, (rows + kDepth - 1) / kDepth, issue, acc);

  const int row0 = r0 + (threadIdx.x >> 7) * 64;
  float* out = part + static_cast<size_t>(blockIdx.z) * R * C;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = row0 + acc_row(i), c = c0 + acc_col(i);
    if (r < R && c < C)
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * C + c) =
          make_float2(acc[i], acc[i + 1]);
  }
}

template <int BN, bool kAffine, bool kRelu>
cudaError_t launch_dx_wgmma(const bf16* dyt, const bf16* w_kn, const bf16* x,
                            const float* inv, const float* beta, int M, int K,
                            int N, bf16* dx, float* part_dinv,
                            float* part_dbeta, cudaStream_t s) {
  using wgmma_core::Ring;
  // The ring is above the 48 KB of dynamic shared memory given by default.
  static const cudaError_t attr = cudaFuncSetAttribute(
      bwd_dx_wgmma_kernel<BN, kAffine, kRelu>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_dyt, map_w;
  cudaError_t err = wgmma_core::encode_tensor_map_2d(
      &map_dyt, dyt, N, M, wgmma_core::kDepth, wgmma_core::kTileRows);
  if (err != cudaSuccess) return err;
  err = wgmma_core::encode_tensor_map_2d(&map_w, w_kn, N, K,
                                         wgmma_core::kDepth, BN);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(K, BN), cdiv(M, wgmma_core::kTileRows));
  bwd_dx_wgmma_kernel<BN, kAffine, kRelu>
      <<<grid, wgmma_core::kThreads, Ring<BN>::kSmemBytes, s>>>(
          map_dyt, map_w, x, inv, beta, M, K, N, dx, part_dinv, part_dbeta);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_dw_wgmma(const bf16* p, const bf16* q, int R, int C, int M,
                            int splits, int rows_per_split, float* part,
                            cudaStream_t s) {
  using wgmma_core::Ring;
  static const cudaError_t attr = cudaFuncSetAttribute(
      bwd_dw_wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Ring<BN>::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  CUtensorMap map_p, map_q;
  cudaError_t err =
      wgmma_core::encode_tensor_map_2d(&map_p, p, R, M, 64, wgmma_core::kDepth);
  if (err != cudaSuccess) return err;
  err = wgmma_core::encode_tensor_map_2d(&map_q, q, C, M, 64,
                                         wgmma_core::kDepth);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(C, BN), cdiv(R, wgmma_core::kTileRows), splits);
  bwd_dw_wgmma_kernel<BN>
      <<<grid, wgmma_core::kThreads, Ring<BN>::kSmemBytes, s>>>(
          map_p, map_q, R, C, M, rows_per_split, part);
  return cudaGetLastError();
}

template <bool kAffine, bool kRelu>
cudaError_t backward_wgmma(const void* x, const void* w_kn, const void* inv,
                           const void* beta, const void* y, const void* dy,
                           const void* dssum, const void* dssq, int M, int K,
                           int N, int bn_dx, int dw_rows_k, int bn_dw,
                           int splits, int rows_per_split, void* dyt,
                           void* a, void* dx, void* part_dw, void* dw,
                           void* part_dinv, void* part_dbeta, void* dinv,
                           void* dbeta, cudaStream_t s) {
  const bf16* xt = static_cast<const bf16*>(x);
  const float* invf = static_cast<const float*>(inv);
  const float* betaf = static_cast<const float*>(beta);
  bf16* dytb = static_cast<bf16*>(dyt);
  const bool copy_a = kAffine || kRelu;
  const bf16* act = copy_a ? static_cast<const bf16*>(a) : xt;
  const size_t chunks_dyt = static_cast<size_t>(M) * N / kVec;
  const size_t chunks_a = copy_a ? static_cast<size_t>(M) * K / kVec : 0;
  const size_t chunks = chunks_dyt + chunks_a;
  bwd_prologue_kernel<kAffine, kRelu>
      <<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, s>>>(
          static_cast<const bf16*>(dy), static_cast<const bf16*>(y),
          static_cast<const float*>(dssum), static_cast<const float*>(dssq),
          xt, invf, betaf, chunks_dyt, chunks_a, N, K, dytb,
          static_cast<bf16*>(a));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  float* pdinv = static_cast<float*>(part_dinv);
  float* pdbeta = static_cast<float*>(part_dbeta);
  const bf16* wk = static_cast<const bf16*>(w_kn);
  err = bn_dx == 128
            ? launch_dx_wgmma<128, kAffine, kRelu>(dytb, wk, xt, invf, betaf,
                                                   M, K, N,
                                                   static_cast<bf16*>(dx),
                                                   pdinv, pdbeta, s)
            : launch_dx_wgmma<64, kAffine, kRelu>(dytb, wk, xt, invf, betaf,
                                                  M, K, N,
                                                  static_cast<bf16*>(dx),
                                                  pdinv, pdbeta, s);
  if (err != cudaSuccess) return err;

  const bf16* p = dw_rows_k ? act : dytb;
  const bf16* q = dw_rows_k ? dytb : act;
  const int R = dw_rows_k ? K : N, C = dw_rows_k ? N : K;
  float* pdw = static_cast<float*>(part_dw);
  err = bn_dw == 128
            ? launch_dw_wgmma<128>(p, q, R, C, M, splits, rows_per_split, pdw,
                                   s)
            : launch_dw_wgmma<64>(p, q, R, C, M, splits, rows_per_split, pdw,
                                  s);
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(R) * C;
  sum_splits_kernel<bf16><<<static_cast<unsigned>((count + 255) / 256), 256,
                            0, s>>>(pdw, splits, count,
                                    static_cast<bf16*>(dw));
  err = cudaGetLastError();
  if (err != cudaSuccess || !kAffine) return err;
  const int blocks = static_cast<int>(cdiv(M, wgmma_core::kTileRows));
  err = sum_rows(pdinv, blocks, K, static_cast<float*>(dinv), s);
  if (err != cudaSuccess) return err;
  return sum_rows(pdbeta, blocks, K, static_cast<float*>(dbeta), s);
}

}  // namespace

// One instantiation per (dtype, affine, relu).
#define FBM_DISPATCH(FN, DTYPE, AFFINE, RELU, ...)                         \
  do {                                                                     \
    if ((DTYPE) == 1) {                                                    \
      if (AFFINE) {                                                        \
        return static_cast<int>(RELU ? FN<bf16, true, true>(__VA_ARGS__)   \
                                     : FN<bf16, true, false>(__VA_ARGS__)); \
      }                                                                    \
      return static_cast<int>(RELU ? FN<bf16, false, true>(__VA_ARGS__)    \
                                   : FN<bf16, false, false>(__VA_ARGS__)); \
    }                                                                      \
    if ((DTYPE) == 0) {                                                    \
      if (AFFINE) {                                                        \
        return static_cast<int>(RELU ? FN<float, true, true>(__VA_ARGS__)  \
                                     : FN<float, true, false>(__VA_ARGS__)); \
      }                                                                    \
      return static_cast<int>(RELU ? FN<float, false, true>(__VA_ARGS__)   \
                                   : FN<float, false, false>(__VA_ARGS__)); \
    }                                                                      \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  } while (0)

// The wgmma routes (bf16 only): one instantiation per (affine, relu).
#define WG_DISPATCH(FN, AFFINE, RELU, ...)                                 \
  do {                                                                     \
    if (AFFINE) {                                                          \
      return static_cast<int>(RELU ? FN<true, true>(__VA_ARGS__)           \
                                   : FN<true, false>(__VA_ARGS__));        \
    }                                                                      \
    return static_cast<int>(RELU ? FN<false, true>(__VA_ARGS__)            \
                                 : FN<false, false>(__VA_ARGS__));         \
  } while (0)

extern "C" {

// K5. x [M, K], w [N, K] in the compute dtype; inv, beta [K] fp32 (null
// when affine == 0); y [M, N] out; part [ceil(M/128), 2N] fp32 scratch;
// stats [2N] fp32 out: the N column sums, then the N sums of squares.
int fbm_forward(int dtype, int affine, int relu, const void* x,
                const void* w, const void* inv, const void* beta, int M,
                int K, int N, void* y, void* part, void* stats,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FBM_DISPATCH(forward, dtype, affine, relu, x, w, inv, beta, M, K, N, y,
               part, stats, s);
}

// K5 on the wgmma route: bf16 only; K and N multiples of 8 and x, w_nk, y
// (and a, where it is written) 16-byte aligned. w_nk is W as [N, K]; bn the
// B tile width (64 or 128). a [M, K] bf16 scratch, null without affine and
// relu; part and stats as for fbm_forward.
int fbm_forward_wgmma(int affine, int relu, const void* x, const void* w_nk,
                      const void* inv, const void* beta, int M, int K, int N,
                      int bn, void* a, void* y, void* part, void* stats,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* need[] = {x, w_nk, y, affine || relu ? a : x};
  bool ok = M > 0 && K > 0 && N > 0 && K % kVec == 0 && N % kVec == 0 &&
            (bn == 64 || bn == 128) && part != nullptr && stats != nullptr;
  for (const void* p : need) ok = ok && p != nullptr && aligned16(p);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  WG_DISPATCH(forward_wgmma, affine, relu, x, w_nk, inv, beta, M, K, N, bn,
              a, y, part, stats, s);
}

// K6. x [M, K], w [N, K], y and dy [M, N] in the compute dtype; inv, beta,
// dinv, dbeta [K] and dssum, dssq [N] fp32; dx [M, K] and dw [N, K] out in
// the compute dtype. part_dw [splits, N, K] and part_dinv / part_dbeta
// [ceil(M/128), K] fp32 scratch; splits * rows_per_split must cover M and
// rows_per_split must be a multiple of 32. With affine == 0, inv, beta,
// dinv, dbeta and the dinv/dbeta scratch may be null.
int fbm_backward(int dtype, int affine, int relu, const void* x,
                 const void* w, const void* inv, const void* beta,
                 const void* y, const void* dy, const void* dssum,
                 const void* dssq, int M, int K, int N, int splits,
                 int rows_per_split, void* dx, void* part_dw, void* dw,
                 void* part_dinv, void* part_dbeta, void* dinv, void* dbeta,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_split % kBK != 0 ||
      static_cast<long long>(splits) * rows_per_split < M)
    return static_cast<int>(cudaErrorInvalidValue);
  FBM_DISPATCH(backward, dtype, affine, relu, x, w, inv, beta, y, dy, dssum,
               dssq, M, K, N, splits, rows_per_split, dx, part_dw, dw,
               part_dinv, part_dbeta, dinv, dbeta, s);
}

// K6 on the wgmma route: bf16 only; K and N multiples of 8 and every
// pointer 16-byte aligned (TMA's global strides). w_kn is W as [K, N] (the
// depth n contiguous). bn_dx, bn_dw: the B tile width of the dx and dW
// GEMMs (64 or 128). dw_rows_k: dw is written as [K, N] (1) or [N, K] (0).
// dyt [M, N] and a [M, K] bf16 scratch (a may be null without affine and
// relu); part_dw [splits, rows, cols] and part_dinv / part_dbeta
// [ceil(M/128), K] fp32 scratch; rows_per_split a multiple of 64.
int fbm_backward_wgmma(int affine, int relu, const void* x, const void* w_kn,
                       const void* inv, const void* beta, const void* y,
                       const void* dy, const void* dssum, const void* dssq,
                       int M, int K, int N, int bn_dx, int dw_rows_k,
                       int bn_dw, int splits, int rows_per_split, void* dyt,
                       void* a, void* dx, void* part_dw, void* dw,
                       void* part_dinv, void* part_dbeta, void* dinv,
                       void* dbeta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool copy_a = affine || relu;
  const void* need[] = {x, w_kn, y, dy, dyt, dx, copy_a ? a : x};
  bool ok = M > 0 && K % kVec == 0 && N % kVec == 0 && K > 0 && N > 0 &&
            (bn_dx == 64 || bn_dx == 128) && (bn_dw == 64 || bn_dw == 128) &&
            rows_per_split % wgmma_core::kDepth == 0 &&
            static_cast<long long>(splits) * rows_per_split >= M;
  for (const void* p : need) ok = ok && p != nullptr && aligned16(p);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  WG_DISPATCH(backward_wgmma, affine, relu, x, w_kn, inv, beta, y, dy, dssum,
              dssq, M, K, N, bn_dx, dw_rows_k, bn_dw, splits, rows_per_split,
              dyt, a, dx, part_dw, dw, part_dinv, part_dbeta, dinv, dbeta, s);
}

}  // extern "C"
