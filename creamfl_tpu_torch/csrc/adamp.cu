// AdamP's step (Heo et al., ICLR 2021) over a whole list of fp32
// parameters, for Hopper (sm_90a): three launches for up to kMaxLeaves
// (536) leaves.
//
// Replaces no TPU kernel: the JAX package's AdamP (creamfl_tpu/optim/
// adamp.py) is plain optax code that XLA fuses. It was added because the
// port's eager AdamP (the plain version, ops/adamp.py:adamp_reference)
// runs ~10 multi-tensor passes over every leaf and then ~35 small kernels
// per matrix for the projection (row norms, a max, views, three wheres),
// plus a copy of each channels_last conv weight for its reshape: thousands
// of launches a step, each doing a few microseconds of work.
//
// What it computes, per leaf (ops/adamp.py:adamp_reference, in the same
// fp32 steps): m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
// pert = m / (sqrt(v / bc2) + eps), bc_i = 1 - b_i^step in float64 from the
// leaf's own float64 step, rounded to fp32 where it meets fp32. For a leaf
// of two or more dimensions, seen as rows (the output channel: numel /
// shape[0] elements, contiguous in memory for a contiguous or a
// channels_last tensor): where max_r |cos(g_r, p_r)| < delta / sqrt(row)
// (the channel view), else where |cos(g, p)| < delta / sqrt(numel) (the
// layer view), the radial part is taken out of pert, pert -= p c with
// c = sum(p pert) / (|p| + eps)^2 over the row or the whole leaf, and the
// decay is scaled by wd_ratio. Then p = p (1 - lr wd [x wd_ratio]) +
// pert (-lr / bc1), the projection read from p before the decay.
//
// What bounds it on an H100: the bytes. The least a step moves is g, p, m
// and v read once and p, m and v written once: 28 bytes an element, 4.33
// GB for the server's 154.7 M parameters, 1.29 ms at 3.35 TB/s. The
// projection's decision needs every row of a leaf before any element can
// be written, so this design reads p, m and v twice: 40 bytes an element
// (6.19 GB, 1.85 ms).
//
// The design:
//   * Pass 1, moments_kernel: reads g, p, m, v; writes m, v; reduces, per
//     row of each matrix, sum(g p), sum(g^2), sum(p^2) and sum(p pert)
//     into an fp32 scratch of 4 floats a row. A block takes a tile of whole
//     rows; a row is reduced by 1, 2, 4 or 8 warps (by its length: at most
//     32 elements a lane), by shuffles and then across the row's warps in
//     order, with no atomics: the sums are the same on every run.
//   * Pass 2, decide_kernel: a block per leaf. From the row sums it forms
//     the channel and layer cosines, picks none, channel or layer, writes
//     each row's coefficient c (the row's, the leaf's, or 0) over the
//     row's first sum, and the leaf's fp32 constants (bc2, -lr / bc1, the
//     decay factor); it increments the leaf's step.
//   * Pass 3, apply_kernel: reads p, m, v and the row's c, recomputes pert
//     (the same fp32 steps as pass 1, so the same bits), projects, decays
//     and steps; writes p.
//   * Pointers, sizes and tiles go by value in the kernel parameters
//     (Leaves, read in place through __grid_constant__; up to 32 764 bytes
//     since CUDA 12.1): no table in device memory and no copy to the
//     device, so an eager step takes gradients at new addresses and a CUDA
//     graph captures the parameters with the launch. Nothing synchronises
//     with the host; the scratch is the caller's (torch.empty).
//   * fp32 throughout; the fp32 operations are written as _rn intrinsics,
//     in the plain version's order, so that nvcc contracts none of them.
//
// Interface (plain C, loaded with ctypes by ops/adamp.py):
//   adamp_capacity() -> leaves per launch;
//   adamp_step(n, ptrs [n][5] (p, g, m, v, step), meta [n][4] (numel, row
//              length, info, first row in the scratch), tiles [n + 1]
//              (prefix sums of the leaves' tiles), lr, hyperparameters,
//              sums [rows][4], consts [n][4], modes [n], stream)
//   -> 0 or the CUDA error of a launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The most leaves whose arguments fit a launch's 32 764 bytes.
constexpr int kMaxLeaves = 536;

// info: rows per tile in the low 24 bits; log2 of the warps a row takes in
// bits 24-25; bit 26: a matrix (reduce and project); bit 27: 16-byte
// accesses (every pointer 16-byte aligned and the row length a multiple
// of 4). Must match ops/adamp.py.
constexpr int kRowsMask = (1 << 24) - 1;
constexpr int kMatrixBit = 1 << 26;
constexpr int kVectorBit = 1 << 27;

struct Leaves {
  int n;      // leaves in this launch
  int first;  // index of the launch's first leaf in the step
  const double* lr;
  float* sums;    // [rows][4]: per row of every matrix; c after pass 2
  float* consts;  // [leaves][4]: bc2, -lr / bc1, decay factor
  int* modes;     // [leaves]: 0 none, 1 channel, 2 layer
  double beta1, beta2, weight_decay, delta;
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd_ratio;
  int tile_start[kMaxLeaves + 1];  // relative to this launch
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  double* step[kMaxLeaves];
  int numel[kMaxLeaves];
  int row_len[kMaxLeaves];
  int row_base[kMaxLeaves];
  int info[kMaxLeaves];
};
static_assert(sizeof(Leaves) <= 32764, "kernel parameters over 32 764 B");

struct Tile {
  int leaf, r0, r1, len, numel, info;
};

// The leaf and rows of this block's tile.
__device__ __forceinline__ Tile find_tile(const Leaves& a) {
  int tile = blockIdx.x;
  int lo = 0, hi = a.n - 1;  // the last leaf whose first tile <= tile
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (a.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  Tile t;
  t.leaf = lo;
  t.info = a.info[lo];
  t.len = a.row_len[lo];
  t.numel = a.numel[lo];
  int per = t.info & kRowsMask;
  int rows = (int)(((int64_t)t.numel + t.len - 1) / t.len);
  t.r0 = (tile - a.tile_start[lo]) * per;
  t.r1 = min(t.r0 + per, rows);
  return t;
}

__device__ __forceinline__ float perturbation(float m, float v, float bc2,
                                              float eps) {
  return __fdiv_rn(m, __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
}

struct Sums {
  float gp = 0.f, gg = 0.f, pp = 0.f, ppert = 0.f;
};

// One element of pass 1: the moments in place, the row sums.
__device__ __forceinline__ void moment(float g, float p, float& m, float& v,
                                       const Leaves& a, float bc2, Sums& s) {
  m = __fmaf_rn(a.one_minus_b1, g, __fmul_rn(m, a.b1));
  v = __fmaf_rn(__fmul_rn(a.one_minus_b2, g), g, __fmul_rn(v, a.b2));
  float pert = perturbation(m, v, bc2, a.eps);
  s.gp = __fmaf_rn(g, p, s.gp);
  s.gg = __fmaf_rn(g, g, s.gg);
  s.pp = __fmaf_rn(p, p, s.pp);
  s.ppert = __fmaf_rn(p, pert, s.ppert);
}

// One element of pass 3: p from the stored moments.
__device__ __forceinline__ float applied(float p, float m, float v,
                                         float bc2, float eps, float c,
                                         float decay, float scale) {
  float pert = perturbation(m, v, bc2, eps);
  pert = __fsub_rn(pert, __fmul_rn(p, c));
  return __fadd_rn(__fmul_rn(p, decay), __fmul_rn(pert, scale));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1. Groups of (1 << wlog) warps take the tile's rows in turn; every
// warp runs the same number of turns, so the block's barriers line up.
__global__ void __launch_bounds__(kThreads)
moments_kernel(const __grid_constant__ Leaves a) {
  __shared__ float red[kWarps][4];
  __shared__ float bc2_s;
  const Tile t = find_tile(a);
  const int i = t.leaf;
  if (threadIdx.x == 0)
    bc2_s = (float)(1.0 - pow(a.beta2, *a.step[i] + 1.0));
  __syncthreads();
  const float bc2 = bc2_s;
  const int wlog = (t.info >> 24) & 3, wpr = 1 << wlog;
  const int groups = kWarps >> wlog;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> wlog;
  const int gt = ((warp & (wpr - 1)) << 5) | lane, gthreads = wpr << 5;
  const bool matrix = t.info & kMatrixBit, vec = t.info & kVectorBit;
  float* P = a.p[i];
  const float* G = a.g[i];
  float* M = a.m[i];
  float* V = a.v[i];
  for (int base = t.r0; base < t.r1; base += groups) {
    const int r = base + group;
    Sums s;
    if (r < t.r1) {
      const int64_t off = (int64_t)r * t.len;
      const int len = min(t.len, (int)(t.numel - off));
      int done = 0;
      if (vec) {
        const int n4 = len >> 2;
        const float4* g4 = reinterpret_cast<const float4*>(G + off);
        const float4* p4 = reinterpret_cast<const float4*>(P + off);
        float4* m4 = reinterpret_cast<float4*>(M + off);
        float4* v4 = reinterpret_cast<float4*>(V + off);
        for (int j = gt; j < n4; j += gthreads) {
          float4 gv = g4[j], pv = p4[j], mv = m4[j], vv = v4[j];
          moment(gv.x, pv.x, mv.x, vv.x, a, bc2, s);
          moment(gv.y, pv.y, mv.y, vv.y, a, bc2, s);
          moment(gv.z, pv.z, mv.z, vv.z, a, bc2, s);
          moment(gv.w, pv.w, mv.w, vv.w, a, bc2, s);
          m4[j] = mv;
          v4[j] = vv;
        }
        done = n4 << 2;
      }
      for (int j = done + gt; j < len; j += gthreads) {
        float mv = M[off + j], vv = V[off + j];
        moment(G[off + j], P[off + j], mv, vv, a, bc2, s);
        M[off + j] = mv;
        V[off + j] = vv;
      }
    }
    if (!matrix) continue;  // uniform over the block
    s.gp = warp_sum(s.gp);
    s.gg = warp_sum(s.gg);
    s.pp = warp_sum(s.pp);
    s.ppert = warp_sum(s.ppert);
    float4* out = reinterpret_cast<float4*>(a.sums) + a.row_base[i];
    if (wpr == 1) {
      if (lane == 0 && r < t.r1)
        out[r] = make_float4(s.gp, s.gg, s.pp, s.ppert);
      continue;
    }
    if (lane == 0) {
      red[warp][0] = s.gp;
      red[warp][1] = s.gg;
      red[warp][2] = s.pp;
      red[warp][3] = s.ppert;
    }
    __syncthreads();
    if (gt == 0 && r < t.r1) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = warp; w < warp + wpr; ++w) {
        sum.x += red[w][0];
        sum.y += red[w][1];
        sum.z += red[w][2];
        sum.w += red[w][3];
      }
      out[r] = sum;
    }
    __syncthreads();
  }
}

// Pass 2: a block per leaf.
__global__ void __launch_bounds__(kThreads)
decide_kernel(const __grid_constant__ Leaves a) {
  __shared__ double red_d[kWarps][4];
  __shared__ float red_max[kWarps];
  __shared__ int mode_s;
  __shared__ float layer_c_s;
  const int i = blockIdx.x, leaf = a.first + i;
  const int info = a.info[i];
  const bool matrix = info & kMatrixBit;
  const int numel = a.numel[i], len = a.row_len[i];
  const float eps = a.eps;
  int mode = 0;
  if (matrix) {
    const int rows = numel / len;
    float4* rs = reinterpret_cast<float4*>(a.sums) + a.row_base[i];
    float cmax = 0.f;
    double gp = 0.0, gg = 0.0, pp = 0.0, ppert = 0.0;
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const float4 s = rs[r];
      const float den = fmaxf(__fmul_rn(__fsqrt_rn(s.y), __fsqrt_rn(s.z)),
                              eps);
      cmax = fmaxf(cmax, __fdiv_rn(fabsf(s.x), den));
      gp += s.x;
      gg += s.y;
      pp += s.z;
      ppert += s.w;
    }
    for (int o = 16; o > 0; o >>= 1) {
      cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
      gp += __shfl_xor_sync(0xffffffffu, gp, o);
      gg += __shfl_xor_sync(0xffffffffu, gg, o);
      pp += __shfl_xor_sync(0xffffffffu, pp, o);
      ppert += __shfl_xor_sync(0xffffffffu, ppert, o);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red_max[warp] = cmax;
      red_d[warp][0] = gp;
      red_d[warp][1] = gg;
      red_d[warp][2] = pp;
      red_d[warp][3] = ppert;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        cmax = fmaxf(cmax, red_max[w]);
        gp += red_d[w][0];
        gg += red_d[w][1];
        pp += red_d[w][2];
        ppert += red_d[w][3];
      }
      const float cos_layer = __fdiv_rn(
          fabsf((float)gp),
          fmaxf(__fmul_rn(__fsqrt_rn((float)gg), __fsqrt_rn((float)pp)),
                eps));
      if (cmax < (float)(a.delta / sqrt((double)len)))
        mode = 1;
      else if (cos_layer < (float)(a.delta / sqrt((double)numel)))
        mode = 2;
      const float norm = __fadd_rn(__fsqrt_rn((float)pp), eps);
      layer_c_s = __fdiv_rn((float)ppert, __fmul_rn(norm, norm));
      mode_s = mode;
    }
    __syncthreads();
    mode = mode_s;
    const float layer_c = layer_c_s;
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      float c = 0.f;
      if (mode == 1) {
        const float4 s = rs[r];
        const float norm = __fadd_rn(__fsqrt_rn(s.z), eps);
        c = __fdiv_rn(s.w, __fmul_rn(norm, norm));
      } else if (mode == 2) {
        c = layer_c;
      }
      a.sums[4 * ((int64_t)a.row_base[i] + r)] = c;
    }
  }
  if (threadIdx.x != 0) return;
  const double step = *a.step[i] + 1.0;
  const double bc1 = 1.0 - pow(a.beta1, step);
  const double bc2 = 1.0 - pow(a.beta2, step);
  const double lr = *a.lr;
  float decay = 1.f;
  if (a.weight_decay > 0) {
    const double lr_wd = lr * a.weight_decay;
    decay = matrix ? __fsub_rn(1.f, __fmul_rn((float)lr_wd,
                                               mode ? a.wd_ratio : 1.f))
                   : (float)(1.0 - lr_wd);
  }
  float* k = a.consts + 4 * (int64_t)leaf;
  k[0] = (float)bc2;
  k[1] = (float)(-lr / bc1);
  k[2] = decay;
  a.modes[leaf] = mode;
  *a.step[i] = step;
}

// Pass 3: the tiles of pass 1.
__global__ void __launch_bounds__(kThreads)
apply_kernel(const __grid_constant__ Leaves a) {
  const Tile t = find_tile(a);
  const int i = t.leaf;
  const float* k = a.consts + 4 * (int64_t)(a.first + i);
  const float bc2 = k[0], scale = k[1], decay = k[2], eps = a.eps;
  const int wlog = (t.info >> 24) & 3, wpr = 1 << wlog;
  const int groups = kWarps >> wlog;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> wlog;
  const int gt = ((warp & (wpr - 1)) << 5) | lane, gthreads = wpr << 5;
  const bool matrix = t.info & kMatrixBit, vec = t.info & kVectorBit;
  float* P = a.p[i];
  const float* M = a.m[i];
  const float* V = a.v[i];
  for (int r = t.r0 + group; r < t.r1; r += groups) {
    const float c =
        matrix ? a.sums[4 * ((int64_t)a.row_base[i] + r)] : 0.f;
    const int64_t off = (int64_t)r * t.len;
    const int len = min(t.len, (int)(t.numel - off));
    int done = 0;
    if (vec) {
      const int n4 = len >> 2;
      float4* p4 = reinterpret_cast<float4*>(P + off);
      const float4* m4 = reinterpret_cast<const float4*>(M + off);
      const float4* v4 = reinterpret_cast<const float4*>(V + off);
      for (int j = gt; j < n4; j += gthreads) {
        float4 pv = p4[j];
        const float4 mv = m4[j], vv = v4[j];
        pv.x = applied(pv.x, mv.x, vv.x, bc2, eps, c, decay, scale);
        pv.y = applied(pv.y, mv.y, vv.y, bc2, eps, c, decay, scale);
        pv.z = applied(pv.z, mv.z, vv.z, bc2, eps, c, decay, scale);
        pv.w = applied(pv.w, mv.w, vv.w, bc2, eps, c, decay, scale);
        p4[j] = pv;
      }
      done = n4 << 2;
    }
    for (int j = done + gt; j < len; j += gthreads)
      P[off + j] = applied(P[off + j], M[off + j], V[off + j], bc2, eps, c,
                           decay, scale);
  }
}

}  // namespace

extern "C" {

int adamp_capacity() { return kMaxLeaves; }

int adamp_step(int n, const unsigned long long* ptrs, const int* meta,
               const int* tiles, const void* lr, double beta1, double beta2,
               double eps, double weight_decay, double delta,
               double wd_ratio, void* sums, void* consts, void* modes,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static thread_local Leaves a;  // 32 KB: off the caller's stack
  a.lr = static_cast<const double*>(lr);
  a.sums = static_cast<float*>(sums);
  a.consts = static_cast<float*>(consts);
  a.modes = static_cast<int*>(modes);
  a.beta1 = beta1;
  a.beta2 = beta2;
  a.weight_decay = weight_decay;
  a.delta = delta;
  // The fp32 values the plain version's tensor operations round the
  // Python floats to.
  a.b1 = (float)beta1;
  a.one_minus_b1 = (float)(1.0 - beta1);
  a.b2 = (float)beta2;
  a.one_minus_b2 = (float)(1.0 - beta2);
  a.eps = (float)eps;
  a.wd_ratio = (float)wd_ratio;
  for (int first = 0; first < n; first += kMaxLeaves) {
    const int k = n - first < kMaxLeaves ? n - first : kMaxLeaves;
    a.n = k;
    a.first = first;
    for (int j = 0; j < k; ++j) {
      const unsigned long long* q = ptrs + 5 * (int64_t)(first + j);
      const int* x = meta + 4 * (int64_t)(first + j);
      a.p[j] = reinterpret_cast<float*>(q[0]);
      a.g[j] = reinterpret_cast<const float*>(q[1]);
      a.m[j] = reinterpret_cast<float*>(q[2]);
      a.v[j] = reinterpret_cast<float*>(q[3]);
      a.step[j] = reinterpret_cast<double*>(q[4]);
      a.numel[j] = x[0];
      a.row_len[j] = x[1];
      a.info[j] = x[2];
      a.row_base[j] = x[3];
      a.tile_start[j] = tiles[first + j] - tiles[first];
    }
    a.tile_start[k] = tiles[first + k] - tiles[first];
    const int grid = a.tile_start[k];
    moments_kernel<<<grid, kThreads, 0, s>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decide_kernel<<<k, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    apply_kernel<<<grid, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
