// The gallery kernels' mma.sync tile core for Hopper (sm_90a): fp32
// products in 3xTF32 on warp-level mma.sync, fed by cp.async copies into
// XOR-swizzled shared-memory tiles. Included by gallery.cu, whose "tc"
// kernel (the softmax-matvec partial pass of K2 / K3's backward; the lse
// pass runs on gallery_wgmma.cuh) is built on it.
//
// Products. mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: a 16 x 8
// A fragment, an 8 x 8 B fragment, a 16 x 8 fp32 accumulator. Each fp32
// operand x is split in registers as big = tf32(x) (to nearest, see
// to_tf32; the wgmma route instead reads x itself as its big half,
// truncated) and small = x - big (exact in fp32; the tensor core reads its
// top 11 bits), and a
// product is taken as three: small*big + big*small + big*big, the small
// terms first. A product of two TF32 values is exact in fp32; the halves
// carry x to ~2^-22 and the dropped small*small term is ~2^-22 of the
// product. The tensor core's accumulation truncates, so the kernels sum
// each 32-deep chunk (or 8-deep step) in a fresh accumulator and add it to
// the running fp32 sum with a round-to-nearest add; the sums then agree
// with fp32 FMAs to within a few fp32 roundings. That costs 3x the tensor
// operations: on an H100 mma.sync runs TF32 at ~310 TFLOP/s
// (chip_smoke.py's tc_peak_phase; 495 is wgmma's), ~105 effective.
//
// Why the matvec stays on mma.sync: TF32 wgmma reads only K-major
// operands, and the matvec's second product p @ G_tile has K = gallery
// rows while G is stored [N][D] (MN-major there). mma.sync fragments are
// gathered by the threads from shared memory in any layout. The lse pass
// (v @ G^T, both operands K-major along D) has no such product: its
// wgmma kernel is gallery_wgmma.cuh.
//
// Shared memory. Every fp32 tile is stored with rows of `pitch` floats, a
// multiple of 32, and the 16-byte chunks of a row XOR-swizzled by the row:
// chunk c of row r sits at c ^ s(r), s(r) = ((r & 3) << 1) | ((r >> 2) & 1)
// (a permutation of 0..7, so a chunk stays inside its aligned group of 8).
// Then all three fragment loads are free of bank conflicts:
//   * A or "col" B read along k (rows r0 + 0..7, columns k0 + 0..3): the
//     eight rows have eight distinct s(r), so the chunks land on eight
//     distinct 4-bank groups;
//   * B read along n from a [k][n] tile (rows k0 + 0..3 (+4), columns
//     n0 + 0..7): rows k0 + t give s = 2t (or 2t + 1), and the two chunks
//     of the eight columns differ in bit 0, so again eight distinct groups.
// A plain pitch would put every row of a 256-float tile on the same bank.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gcore {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kDepth = 32;     // floats per row of an lse depth chunk

__device__ __forceinline__ int swizzle_of(int r) {
  return ((r & 3) << 1) | ((r >> 2) & 1);
}

// Float index of element (r, c) of a swizzled tile with rows of `pitch`.
__device__ __forceinline__ int swz(int r, int c, int pitch) {
  return r * pitch + ((((c >> 2) ^ swizzle_of(r)) << 2) | (c & 3));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros
// (and reads nothing from src, which must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [row0, row0 + n_rows) x columns [0, pitch) of a row-major [rows, D]
// fp32 array into a swizzled tile; rows >= rows_valid and columns >= D are
// zero-filled. D % 4 == 0 and a 16-byte aligned base (the "tc" route's
// conditions) make each 16-byte chunk wholly inside or outside.
__device__ __forceinline__ void load_rows_async(float* tile, const float* src,
                                                int row0, int n_rows,
                                                int rows_valid, int D,
                                                int pitch) {
  const int chunks = pitch / 4;
  for (int id = threadIdx.x; id < n_rows * chunks; id += kThreads) {
    const int r = id / chunks;
    const int c = (id - r * chunks) * 4;
    const bool ok = row0 + r < rows_valid && c < D;
    const float* s = ok ? src + static_cast<size_t>(row0 + r) * D + c : src;
    cp_async16(tile + swz(r, c, pitch), s, ok ? 16 : 0);
  }
}

// x to the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32's
// result for finite x): half of the 13 dropped bits' range added to the
// magnitude, then those bits cleared -- two integer instructions, cheaper
// here than cvt.rna (measured on the H100).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// Three instructions a value; see the note at the top.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 8) split into TF32 halves.
struct FragA {
  uint32_t big[4], small[4];
};
// B fragment (8 x 8) split into TF32 halves.
struct FragB {
  uint32_t big[2], small[2];
};

// d += a @ b in 3xTF32, accumulated by the tensor core (truncating): d
// is a fresh accumulator of one chunk, added to the running sum with
// add_to (a few hundred truncating accumulations into one large sum -- a
// logit of ~20, a row of p @ G -- would drift by up to an ulp of that sum
// each, ~1e-4 relative in all).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// sum += t, and t = 0 for the next chunk: round-to-nearest fp32 adds.
__device__ __forceinline__ void add_to(float (&sum)[4], float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum[i] += t[i];
    t[i] = 0.f;
  }
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes), and register i holds matrix i's
// element (row l / 4, 32-bit column l % 4): read as TF32, exactly an
// m16n8k8 fragment element.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// Lane coordinates of the m16n8k8 fragments: group (row of A / column of
// B) and thread in group (column of A / row of B).
__device__ __forceinline__ int lane_group() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_in_group() { return threadIdx.x & 3; }

// A = tile[r0 .. r0+16)[k0 .. k0+8) of a swizzled row-major tile, by one
// ldmatrix: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) are
// matrices 0-3: rows r0 + 0..7 / + 8..15, 16-byte chunks k0 / k0 + 4.
__device__ __forceinline__ void load_a(const float* tile, int pitch, int r0,
                                       int k0, FragA& f) {
  const int l = threadIdx.x & 31;
  uint32_t x[4];
  ldmatrix_x4(x, tile + swz(r0 + (l & 15), k0 + ((l >> 4) << 2), pitch));
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32(__uint_as_float(x[i]), f.big[i], f.small[i]);
}

// The same from two unswizzled tiles holding the TF32 halves already
// split, whose pitch is 4 mod 32 floats (conflict-free 16-byte rows).
__device__ __forceinline__ void load_a_halves(const float* big,
                                              const float* small, int pitch,
                                              int r0, int k0, FragA& f) {
  const int l = threadIdx.x & 31;
  const int o = (r0 + (l & 15)) * pitch + k0 + ((l >> 4) << 2);
  ldmatrix_x4(f.big, big + o);
  ldmatrix_x4(f.small, small + o);
}

// Two B fragments (k x n = 8 x 8 each: columns n0 .. n0+8 and n0+8 ..
// n0+16) from a swizzled tile stored [n][k] (a gallery tile in the logits
// product), by one ldmatrix: b0 (k = t, n = g) and b1 (k = t + 4, n = g) of
// the first are matrices 0-1 (rows n0 + 0..7, chunks k0 / k0 + 4), of the
// second matrices 2-3 (rows n0 + 8..15).
__device__ __forceinline__ void load_b_nk2(const float* tile, int pitch,
                                           int n0, int k0, FragB& lo,
                                           FragB& hi) {
  const int l = threadIdx.x & 31;
  uint32_t x[4];
  ldmatrix_x4(x, tile + swz(n0 + (l & 7) + ((l >> 4) << 3),
                            k0 + ((l >> 3) & 1) * 4, pitch));
  split_tf32(__uint_as_float(x[0]), lo.big[0], lo.small[0]);
  split_tf32(__uint_as_float(x[1]), lo.big[1], lo.small[1]);
  split_tf32(__uint_as_float(x[2]), hi.big[0], hi.small[0]);
  split_tf32(__uint_as_float(x[3]), hi.big[1], hi.small[1]);
}

// One B fragment (columns n0 .. n0+8) as load_b_nk2, by ldmatrix.x2 (lanes
// 0-15 give the addresses).
__device__ __forceinline__ void load_b_nk1(const float* tile, int pitch,
                                           int n0, int k0, FragB& f) {
  const int l = threadIdx.x & 15;
  uint32_t x[2];
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(x[0]), "=r"(x[1])
               : "r"(smem_u32(tile + swz(n0 + (l & 7), k0 + (l >> 3) * 4,
                                          pitch))));
  split_tf32(__uint_as_float(x[0]), f.big[0], f.small[0]);
  split_tf32(__uint_as_float(x[1]), f.big[1], f.small[1]);
}

// B from a swizzled tile stored [k][n] (a gallery tile in p @ G_tile).
__device__ __forceinline__ void load_b_kn(const float* tile, int pitch,
                                          int k0, int n0, FragB& f) {
  const int g = lane_group(), t = lane_in_group();
  split_tf32(tile[swz(k0 + t, n0 + g, pitch)], f.big[0], f.small[0]);
  split_tf32(tile[swz(k0 + t + 4, n0 + g, pitch)], f.big[1], f.small[1]);
}

// Online-softmax merge of (m2, s2) into (m, s); an empty side has m = -inf.
__device__ __forceinline__ void lse_combine(float& m, float& s, float m2,
                                            float s2) {
  const float nm = fmaxf(m, m2);
  s = (nm == -INFINITY) ? 0.f : s * expf(m - nm) + s2 * expf(m2 - nm);
  m = nm;
}

}  // namespace gcore
