// Train-mode BatchNorm of a bf16 channels-last activation, with what
// follows it in a ResNet block fused in (K8): the epilogue is nothing, a
// ReLU, or the residual add and a ReLU. Two launches forward, two
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it with its neighbours. It was added because the port's eager
// trunk ran ATen's four channels-last BatchNorm kernels at ~42 % of the
// card's bandwidth (the statistics pass at ~18 %), plus a separate pass
// for the ReLU, its backward and the residual add.
//
// What it computes (ops/batchnorm.py gives the plain version step for
// step). The activation x is [M = N*H*W, C] rows of channels-last memory.
//   forward: mean and the biased variance of each channel over the M rows
//     in fp32; invstd = 1 / sqrt(var + eps);
//     y = bf16(w (x - mean) invstd + b), ATen's expression and rounding;
//     z = y (none), relu(y) (relu), relu(bf16(y + r)) (add_relu: the
//     residual r added in fp32 to the rounded y and rounded again, as the
//     unfused chain rounds).
//   backward, from dz: g = dz where the ReLU passed (relu: the mask
//     recomputed from x with the forward's own arithmetic; add_relu: the
//     saved output z > 0, and g is the residual's gradient, written once),
//     g = dz (none); xhat = (x - mean) invstd;
//     db = sum g, dw = sum g xhat (fp32);
//     dx = bf16(w invstd (g - db / M - xhat dw / M)).
//
// What bounds it on an H100: the bytes (a few operations an element, far
// below the 295 a byte where the tensor cores would be the limit). The
// least a forward moves is x read and z written (and r read), 4 (6) bytes
// an element; this design reads x twice (6, 8). The least a backward
// moves is dz and x read and dx written (and z read and g written for
// add_relu): 6 (10) bytes; this design reads its inputs twice but the
// saved z once (10, 14). ATen's chain moves 14 (20) forward and 16
// backward. Layer 3's and 4's activations (<= 51 MB) mostly stay in the
// 50 MB L2 between the two passes.
//
// The design:
//   * A block of 256 threads takes a slab of at most 64 channels (one
//     128-byte line of a row) and a chunk of rows; a thread takes 8
//     channels (one 16-byte vector) of every rows_per_iter-th row of the
//     chunk, four rows ahead (eight in the statistics pass). The grid
//     (chunks x slabs, about two blocks an SM) and the chunk's rows are
//     planned by the wrapper (ops/batchnorm.py:plan). Narrow slabs keep
//     each slab's merge short and let the slabs merge in parallel: a
//     first design with 256-channel slabs spent most of its statistics
//     pass in one block's serial merge of ~264 partials.
//   * Statistics: Welford within a thread (8 independent channels), Chan's
//     merge across the block's row groups by a tree in shared memory, and
//     one partial (mean, M2) per block and channel in a workspace. The
//     last block of a slab to finish (an integer ticket, reset by that
//     block) merges the slab's partials, 16 loads in flight a thread, each
//     16 by a fixed tree, then across threads by a tree: the result is the
//     same on every run, with
//     no float atomics and no third launch. E[x^2] - E[x]^2 is never
//     formed. Backward sums: plain fp32 sums, merged the same way.
//   * Apply and dx passes: each thread keeps its 8 channels' constants in
//     registers. The fp32 arithmetic is written with _rn intrinsics where
//     the recomputed ReLU mask must equal the forward's, so that nvcc
//     contracts it the same way in both.
//   * Capture-safe for CUDA graphs: no host synchronisation, no
//     allocation (workspace and tickets are the caller's, from torch's
//     caching allocator, cached per device and stream; tickets start at 0
//     and are left at 0).
//
// Interface (plain C, loaded with ctypes by ops/batchnorm.py):
//   bn_act_forward(epilogue, x, r, w, b, z, stats [2][C] (mean, invstd),
//                  part, tickets, M, C, chunks, rows_per_chunk, eps, stream)
//   bn_act_backward(epilogue, dz, x, z, w, b, stats, dx, g, sums [2][C]
//                   (db, dw), part, tickets, M, C, chunks, rows_per_chunk,
//                   stream)
//   -> 0 or the CUDA error of a launch. Every pointer 16-byte aligned, C a
//   multiple of 8 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kVec = 8;       // bf16 channels in a 16-byte vector
constexpr int kSlab = 64;     // channels a block takes at most
constexpr int kUnroll = 4;    // rows a thread has in flight
constexpr int kStatsUnroll = 8;  // the same in the statistics pass
constexpr int kBatch = 16;    // partials a thread of the last block loads
                              // at once

enum Epilogue { kNone = 0, kRelu = 1, kAddRelu = 2 };

struct Geometry {
  long long m;         // rows
  int c;               // channels
  int tpr;             // threads a row of the slab takes
  int rows_per_iter;   // rows a block takes at once
  int rows_per_chunk;  // rows of a block (the last chunk may be short)
};

Geometry geometry(long long m, int c, int rows_per_chunk) {
  Geometry g;
  g.m = m;
  g.c = c;
  const int slab = c < kSlab ? c : kSlab;
  g.tpr = slab / kVec;
  g.rows_per_iter = kThreads / g.tpr;
  g.rows_per_chunk = rows_per_chunk;
  return g;
}

// Where a thread sits: its first channel, its row group, the chunk's rows.
struct Lane {
  int c0, rg, tc, width;
  bool active;
  long long r0, r1;
};

__device__ __forceinline__ Lane lane_of(const Geometry& g) {
  Lane l;
  l.tc = threadIdx.x % g.tpr;
  l.rg = threadIdx.x / g.tpr;
  l.width = min(kSlab, g.c - (int)blockIdx.y * kSlab);
  l.c0 = blockIdx.y * kSlab + l.tc * kVec;
  l.active = l.rg < g.rows_per_iter && l.tc * kVec < l.width;
  l.r0 = (long long)blockIdx.x * g.rows_per_chunk;
  l.r1 = min(g.m, l.r0 + g.rows_per_chunk);
  return l;
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void unpack(const uint4& u, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j)
    h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The normalised output before its rounding: ATen's channels-last
// transform, w * (x - mean) * invstd + b, its multiply-add contracted.
__device__ __forceinline__ float normalised(float x, float mean, float inv,
                                            float w, float b) {
  return __fmaf_rn(__fmul_rn(w, __fsub_rn(x, mean)), inv, b);
}

// ReLU of a value already rounded to bf16 (NaN passes, as ATen's).
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// The channel constants of a thread's 8 channels.
struct Channels {
  float mean[kVec], inv[kVec], w[kVec], b[kVec];
};

__device__ __forceinline__ void load_channels(Channels& ch, const float* stats,
                                              const float* w, const float* b,
                                              int c, int c0) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    ch.mean[j] = stats[c0 + j];
    ch.inv[j] = stats[c + c0 + j];
    ch.w[j] = w[c0 + j];
    ch.b[j] = b[c0 + j];
  }
}

// ---------------------------------------------------------------------------
// merging partials
// ---------------------------------------------------------------------------

// Chan's merge of (mb, qb) into (ma, qa), means and M2, with f = nb / n
// and naf = na f of the counts na, nb and n = na + nb.
__device__ __forceinline__ void chan_step(float& ma, float& qa, float mb,
                                          float qb, float f, float naf) {
  const float d = mb - ma;
  ma = fmaf(d, f, ma);
  qa = qa + qb + d * d * naf;
}

// Chan's merge of (nb, mb, qb) into (na, ma, qa): counts, means, M2.
__device__ __forceinline__ void chan(float& na, float& ma, float& qa, float nb,
                                     float mb, float qb) {
  if (nb == 0.f) return;
  const float n = na + nb;
  const float f = nb / n;
  chan_step(ma, qa, mb, qb, f, na * f);
  na = n;
}

// Partials of a slab in the workspace: [slabs][chunks][2][kSlab] floats.
__device__ __forceinline__ float* partial(float* part, int slab, int chunk,
                                          int chunks) {
  return part + ((size_t)slab * chunks + chunk) * 2 * kSlab;
}

// After this block wrote its partial: true in the last block of its slab
// to arrive, which then resets the slab's ticket for the next launch.
__device__ __forceinline__ bool last_to_arrive(unsigned* tickets) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x == 0) tickets[blockIdx.y] = 0;
  return last;
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The last block's merge: thread (group, cc) takes channel cc of the slab
// and the chunks group, group + groups, ... in order, kBatch of them loaded
// at once; then the groups merge by a tree. Returns true in the threads of
// group 0, which hold a channel's result in (a0, a1): (mean, M2) for
// MERGE_STATS, else the two sums.
template <bool MERGE_STATS>
__device__ __forceinline__ bool merge_slab(const Geometry& g, float* part,
                                           int width, float& a0, float& a1) {
  __shared__ float sh[3][kThreads];
  const int groups = kThreads / width;
  const int cc = threadIdx.x % width, group = threadIdx.x / width;
  const int chunks = gridDim.x;
  float n = 0.f, s0 = 0.f, s1 = 0.f;
  if (group < groups) {
    for (int base = group; base < chunks; base += kBatch * groups) {
      float v0[kBatch], v1[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int chunk = base + k * groups;
        v0[k] = v1[k] = 0.f;
        if (chunk < chunks) {
          const float* p = partial(part, blockIdx.y, chunk, chunks);
          v0[k] = __ldcg(p + cc);
          v1[k] = __ldcg(p + kSlab + cc);
        }
      }
      // The batch merged pairwise (a tree of independent merges), then
      // into the running result; a chunk past the end counts 0 rows.
      float nv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long r0 = (long long)(base + k * groups) *
                             g.rows_per_chunk;
        nv[k] = (float)max(0ll, min(g.m, r0 + g.rows_per_chunk) - r0);
      }
#pragma unroll
      for (int h = 1; h < kBatch; h <<= 1) {
#pragma unroll
        for (int k = 0; k + h < kBatch; k += 2 * h) {
          if (MERGE_STATS) {
            chan(nv[k], v0[k], v1[k], nv[k + h], v0[k + h], v1[k + h]);
          } else {
            v0[k] += v0[k + h];
            v1[k] += v1[k + h];
          }
        }
      }
      if (MERGE_STATS) {
        chan(n, s0, s1, nv[0], v0[0], v1[0]);
      } else {
        s0 += v0[0];
        s1 += v1[0];
      }
    }
  }
  sh[0][threadIdx.x] = n;
  sh[1][threadIdx.x] = s0;
  sh[2][threadIdx.x] = s1;
  __syncthreads();
  for (int h = pow2_ceil(groups) >> 1; h > 0; h >>= 1) {
    if (group < h && group + h < groups) {
      const int o = threadIdx.x + h * width;
      if (MERGE_STATS) {
        chan(n, s0, s1, sh[0][o], sh[1][o], sh[2][o]);
      } else {
        s0 += sh[1][o];
        s1 += sh[2][o];
      }
      sh[0][threadIdx.x] = n;
      sh[1][threadIdx.x] = s0;
      sh[2][threadIdx.x] = s1;
    }
    __syncthreads();
  }
  a0 = s0;
  a1 = s1;
  return group == 0;
}

// The block's row groups merged by a tree in shared memory (Chan's merge
// for MERGE_STATS, else sums); the threads of row group 0 end with the
// block's partial of their 8 channels and write it.
template <bool MERGE_STATS>
__device__ __forceinline__ void block_partial(const Geometry& g, const Lane& l,
                                              float n, float (&a)[kVec],
                                              float (&q)[kVec], float* part) {
  __shared__ float sh_n[kThreads];
  __shared__ float sh_a[kVec][kThreads];
  __shared__ float sh_q[kVec][kThreads];
  const int t = threadIdx.x;
  sh_n[t] = n;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sh_a[j][t] = a[j];
    sh_q[j][t] = q[j];
  }
  __syncthreads();
  for (int h = pow2_ceil(g.rows_per_iter) >> 1; h > 0; h >>= 1) {
    if (l.rg < h && l.rg + h < g.rows_per_iter) {
      const int o = t + h * g.tpr;
      if (MERGE_STATS) {
        // The 8 channels share their counts.
        const float nb = sh_n[o];
        if (nb > 0.f) {
          const float nn = n + nb, f = nb / nn, naf = n * f;
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            chan_step(a[j], q[j], sh_a[j][o], sh_q[j][o], f, naf);
          n = nn;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          a[j] += sh_a[j][o];
          q[j] += sh_q[j][o];
        }
      }
      sh_n[t] = n;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sh_a[j][t] = a[j];
        sh_q[j][t] = q[j];
      }
    }
    __syncthreads();
  }
  if (l.rg == 0 && l.tc * kVec < l.width) {
    float* p = partial(part, blockIdx.y, blockIdx.x, gridDim.x) + l.tc * kVec;
    float4* pa = reinterpret_cast<float4*>(p);
    float4* pq = reinterpret_cast<float4*>(p + kSlab);
    pa[0] = make_float4(a[0], a[1], a[2], a[3]);
    pa[1] = make_float4(a[4], a[5], a[6], a[7]);
    pq[0] = make_float4(q[0], q[1], q[2], q[3]);
    pq[1] = make_float4(q[4], q[5], q[6], q[7]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__device__ __forceinline__ void welford(float& n, float (&mean)[kVec],
                                        float (&m2)[kVec], const uint4& raw) {
  float v[kVec];
  unpack(raw, v);
  n += 1.f;
  const float inv_n = __frcp_rn(n);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float d = v[j] - mean[j];
    mean[j] = fmaf(d, inv_n, mean[j]);
    m2[j] = fmaf(d, v[j] - mean[j], m2[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
    stats_kernel(Geometry g, const bf16* __restrict__ x,
                 float* __restrict__ part, unsigned* __restrict__ tickets,
                 float* __restrict__ stats, float eps) {
  const Lane l = lane_of(g);
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  if (l.active) {
    const long long step = g.rows_per_iter;
    // Every load of an iteration in flight at once, the chunk's ragged end
    // included.
    for (long long r = l.r0 + l.rg; r < l.r1; r += kStatsUnroll * step) {
      uint4 raw[kStatsUnroll];
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        if (r + u * step < l.r1)
          raw[u] = load16(x + (r + u * step) * g.c + l.c0);
#pragma unroll
      for (int u = 0; u < kStatsUnroll; ++u)
        if (r + u * step < l.r1) welford(n, mean, m2, raw[u]);
    }
  }
  block_partial<true>(g, l, n, mean, m2, part);
  if (!last_to_arrive(tickets)) return;
  float mu, q;
  if (merge_slab<true>(g, part, l.width, mu, q) &&
      (int)threadIdx.x < l.width) {
    const int c = blockIdx.y * kSlab + threadIdx.x;
    stats[c] = mu;
    // ATen's inverse std: the biased variance, a correctly rounded sqrt and
    // division.
    stats[g.c + c] = 1.f / sqrtf(q / (float)g.m + eps);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(Geometry g, const bf16* __restrict__ x,
                 const bf16* __restrict__ res, const float* __restrict__ stats,
                 const float* __restrict__ w, const float* __restrict__ b,
                 bf16* __restrict__ z) {
  const Lane l = lane_of(g);
  if (!l.active) return;
  Channels ch;
  load_channels(ch, stats, w, b, g.c, l.c0);
  const long long step = g.rows_per_iter;
  for (long long r = l.r0 + l.rg; r < l.r1; r += kUnroll * step) {
    uint4 raw[kUnroll], rr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * step;
      if (row < l.r1) {
        raw[u] = load16(x + row * g.c + l.c0);
        if (EPI == kAddRelu) rr[u] = load16(res + row * g.c + l.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * step;
      if (row >= l.r1) break;
      float v[kVec], o[kVec];
      unpack(raw[u], v);
      if (EPI == kAddRelu) unpack(rr[u], o);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float y = round_bf16(
            normalised(v[j], ch.mean[j], ch.inv[j], ch.w[j], ch.b[j]));
        if (EPI == kAddRelu) y = relu(round_bf16(y + o[j]));
        if (EPI == kRelu) y = relu(y);
        o[j] = y;
      }
      *reinterpret_cast<uint4*>(z + row * g.c + l.c0) = pack(o);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The gradient through the epilogue, g, of one vector: dz where the ReLU
// passed (relu: recomputed from x; add_relu: from the saved output).
template <int EPI>
__device__ __forceinline__ void through_epilogue(const Channels& ch,
                                                 const float (&xv)[kVec],
                                                 const uint4& dz_raw,
                                                 const uint4& z_raw,
                                                 float (&gv)[kVec]) {
  unpack(dz_raw, gv);
  if (EPI == kRelu) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float y = round_bf16(
          normalised(xv[j], ch.mean[j], ch.inv[j], ch.w[j], ch.b[j]));
      if (y <= 0.f) gv[j] = 0.f;
    }
  } else if (EPI == kAddRelu) {
    float zv[kVec];
    unpack(z_raw, zv);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (zv[j] <= 0.f) gv[j] = 0.f;
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(Geometry g, const bf16* __restrict__ dz,
                  const bf16* __restrict__ x, const bf16* __restrict__ zs,
                  const float* __restrict__ stats,
                  const float* __restrict__ w, const float* __restrict__ b,
                  bf16* __restrict__ gout, float* __restrict__ part,
                  unsigned* __restrict__ tickets, float* __restrict__ sums) {
  const Lane l = lane_of(g);
  float sg[kVec], sgx[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) sg[j] = sgx[j] = 0.f;
  if (l.active) {
    Channels ch;
    load_channels(ch, stats, w, b, g.c, l.c0);
    const long long step = g.rows_per_iter;
    for (long long r = l.r0 + l.rg; r < l.r1; r += kUnroll * step) {
      uint4 xr[kUnroll], dr[kUnroll], zr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + u * step;
        if (row < l.r1) {
          xr[u] = load16(x + row * g.c + l.c0);
          dr[u] = load16(dz + row * g.c + l.c0);
          if (EPI == kAddRelu) zr[u] = load16(zs + row * g.c + l.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + u * step;
        if (row >= l.r1) break;
        float xv[kVec], gv[kVec];
        unpack(xr[u], xv);
        through_epilogue<EPI>(ch, xv, dr[u], zr[u], gv);
        if (EPI == kAddRelu)
          *reinterpret_cast<uint4*>(gout + row * g.c + l.c0) = pack(gv);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float xh = (xv[j] - ch.mean[j]) * ch.inv[j];
          sg[j] += gv[j];
          sgx[j] = fmaf(gv[j], xh, sgx[j]);
        }
      }
    }
  }
  block_partial<false>(g, l, 0.f, sg, sgx, part);
  if (!last_to_arrive(tickets)) return;
  float s0, s1;
  if (merge_slab<false>(g, part, l.width, s0, s1) &&
      (int)threadIdx.x < l.width) {
    const int c = blockIdx.y * kSlab + threadIdx.x;
    sums[c] = s0;
    sums[g.c + c] = s1;
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(Geometry g, const bf16* __restrict__ src,
              const bf16* __restrict__ x, const float* __restrict__ stats,
              const float* __restrict__ w, const float* __restrict__ b,
              const float* __restrict__ sums, bf16* __restrict__ dx) {
  const Lane l = lane_of(g);
  if (!l.active) return;
  Channels ch;
  load_channels(ch, stats, w, b, g.c, l.c0);
  float k[kVec], mg[kVec], mgx[kVec];
  const float inv_m = 1.f / (float)g.m;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    k[j] = ch.w[j] * ch.inv[j];
    mg[j] = sums[l.c0 + j] * inv_m;
    mgx[j] = sums[g.c + l.c0 + j] * inv_m;
  }
  const long long step = g.rows_per_iter;
  const uint4 none = make_uint4(0, 0, 0, 0);
  for (long long r = l.r0 + l.rg; r < l.r1; r += kUnroll * step) {
    uint4 xr[kUnroll], sr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * step;
      if (row < l.r1) {
        xr[u] = load16(x + row * g.c + l.c0);
        sr[u] = load16(src + row * g.c + l.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = r + u * step;
      if (row >= l.r1) break;
      float xv[kVec], gv[kVec], o[kVec];
      unpack(xr[u], xv);
      // add_relu reads the g of the reduce pass; relu recomputes its mask.
      through_epilogue<EPI == kRelu ? kRelu : kNone>(ch, xv, sr[u], none, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xh = (xv[j] - ch.mean[j]) * ch.inv[j];
        o[j] = k[j] * (gv[j] - mg[j] - xh * mgx[j]);
      }
      *reinterpret_cast<uint4*>(dx + row * g.c + l.c0) = pack(o);
    }
  }
}

int slabs_of(int c) { return (c + kSlab - 1) / kSlab; }

template <int EPI>
int forward(const Geometry& g, dim3 grid, const bf16* x, const bf16* r,
            const float* w, const float* b, bf16* z, float* stats,
            float* part, unsigned* tickets, float eps, cudaStream_t s) {
  stats_kernel<<<grid, kThreads, 0, s>>>(g, x, part, tickets, stats, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<EPI><<<grid, kThreads, 0, s>>>(g, x, r, stats, w, b, z);
  return (int)cudaGetLastError();
}

template <int EPI>
int backward(const Geometry& g, dim3 grid, const bf16* dz, const bf16* x,
             const bf16* z, const float* w, const float* b,
             const float* stats, bf16* dx, bf16* gout, float* sums,
             float* part, unsigned* tickets, cudaStream_t s) {
  reduce_kernel<EPI><<<grid, kThreads, 0, s>>>(g, dz, x, z, stats, w, b,
                                               gout, part, tickets, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // add_relu's dx reads the g just written; the others read dz again.
  const bf16* src = EPI == kAddRelu ? gout : dz;
  dx_kernel<EPI><<<grid, kThreads, 0, s>>>(g, src, x, stats, w, b, sums, dx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bn_act_slab() { return kSlab; }

int bn_act_forward(int epilogue, const void* x, const void* r, const void* w,
                   const void* b, void* z, void* stats, void* part,
                   void* tickets, long long m, int c, int chunks,
                   int rows_per_chunk, double eps, void* stream) {
  const Geometry g = geometry(m, c, rows_per_chunk);
  const dim3 grid(chunks, slabs_of(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* rb = static_cast<const bf16*>(r);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  bf16* zb = static_cast<bf16*>(z);
  float* st = static_cast<float*>(stats);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  const float e = (float)eps;
  switch (epilogue) {
    case kNone:
      return forward<kNone>(g, grid, xb, rb, wf, bf, zb, st, pt, tk, e, s);
    case kRelu:
      return forward<kRelu>(g, grid, xb, rb, wf, bf, zb, st, pt, tk, e, s);
    case kAddRelu:
      return forward<kAddRelu>(g, grid, xb, rb, wf, bf, zb, st, pt, tk, e, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bn_act_backward(int epilogue, const void* dz, const void* x,
                    const void* z, const void* w, const void* b,
                    const void* stats, void* dx, void* gout, void* sums,
                    void* part, void* tickets, long long m, int c, int chunks,
                    int rows_per_chunk, void* stream) {
  const Geometry g = geometry(m, c, rows_per_chunk);
  const dim3 grid(chunks, slabs_of(c));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* db = static_cast<const bf16*>(dz);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* zb = static_cast<const bf16*>(z);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* st = static_cast<const float*>(stats);
  bf16* dxb = static_cast<bf16*>(dx);
  bf16* gb = static_cast<bf16*>(gout);
  float* sm = static_cast<float*>(sums);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  switch (epilogue) {
    case kNone:
      return backward<kNone>(g, grid, db, xb, zb, wf, bf, st, dxb, gb, sm, pt,
                             tk, s);
    case kRelu:
      return backward<kRelu>(g, grid, db, xb, zb, wf, bf, st, dxb, gb, sm, pt,
                             tk, s);
    case kAddRelu:
      return backward<kAddRelu>(g, grid, db, xb, zb, wf, bf, st, dxb, gb, sm,
                                pt, tk, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
