// Warp-level building blocks of the bridged flash-attention kernels
// (flash_bridge.cu, flash_bridge_bwd.cu) for Hopper (sm_90a):
//
//   * mma16816: one bf16 tensor-core product D += A B of a 16 x 16 A tile
//     and a 16 x 8 B tile with fp32 accumulators (mma.sync m16n8k16).
//     Fragment layouts, with g = lane / 4 and t = lane % 4:
//       A (16 x 16): a[0] = (g, 2t..2t+1)  a[1] = (g+8, 2t..)
//                    a[2] = (g, 2t+8..)    a[3] = (g+8, 2t+8..)
//       B (16 x 8):  b[0] = (k 2t..2t+1, n g)   b[1] = (k 2t+8.., n g)
//       C (16 x 8):  c[0..1] = (g, 2t..2t+1)    c[2..3] = (g+8, 2t..2t+1)
//     Two C tiles side by side (keys 0-7 and 8-15) are one A tile of 16
//     keys once packed to bf16 (pack_a), so a probability tile goes from
//     the score product to the value product in registers.
//   * ldmatrix (plain and .trans) loads of those fragments from shared
//     memory tiles whose rows are 128 bf16 (256 bytes, 16 chunks of 16
//     bytes) or 64 bf16 (128 bytes, 8 chunks). Chunk c of row r is stored
//     at chunk c ^ (r % 8), so the 8 row addresses of one 8 x 8 matrix
//     fall on 8 different 16-byte bank groups: no bank conflicts.
//   * cp.async 16-byte copies from device memory into those tiles, with
//     zero fill for rows past the end (src-size 0), and commit / wait
//     groups for a 2-stage ring.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fmma {

constexpr float BIG_NEG = -1073741824.0f;   // -2^30, the masked score
// A tile may be skipped only where each of its terms is exactly 0 in fp32:
// every bias entry at most SKIP_BIAS and every row's max at least SKIP_MAX.
// Then s - m <= -2^29 + 2^28 + |scale * raw score|, and exp of that is 0
// for any raw score below 2^27 in magnitude.
constexpr float SKIP_BIAS = -536870912.0f;  // BIG_NEG / 2
constexpr float SKIP_MAX = -268435456.0f;   // BIG_NEG / 4

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of CHUNKS
// chunks a row.
template <int CHUNKS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * CHUNKS * 16 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The A fragment of rows row0..row0+15, columns 16 kc..16 kc+15 of a
// row-major swizzled tile.
template <int CHUNKS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile,
                                       int row0, int kc, int lane) {
  ldsm_x4(a, tile + swz<CHUNKS>(row0 + (lane & 15), 2 * kc + (lane >> 4)));
}

// B fragments of two n-blocks (n0..n0+7, n0+8..n0+15) where B[k][n] is
// stored as rows n, columns k (K for S = Q K^T): b[0], b[1] for the first
// n-block, b[2], b[3] for the second; k = 16 kc..16 kc+15.
template <int CHUNKS>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], uint32_t tile,
                                          int n0, int kc, int lane) {
  ldsm_x4(b, tile + swz<CHUNKS>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                2 * kc + ((lane >> 3) & 1)));
}

// The same where B[k][n] is stored as rows k, columns n (V for O = P V):
// rows k0..k0+15, columns n0..n0+15 (n0 a multiple of 8).
template <int CHUNKS>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], uint32_t tile,
                                          int k0, int n0, int lane) {
  ldsm_x4_t(b, tile + swz<CHUNKS>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  (n0 >> 3) + (lane >> 4)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 C tiles (columns 0-7 and 8-15 of a 16 x 16 block), rounded to
// bf16, as the A fragment of that block.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes from global to shared; 16 zero bytes when !pred (src is then
// not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows row0..row0+ROWS-1 of a (rows, 128) bf16 operand (row stride
// `ld` elements, rows from `nrows` on zero-filled) into a swizzled tile,
// 16 bytes a copy, spread over NT threads.
template <int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* base,
                                          long long ld, int row0, int nrows, int tid) {
  static_assert(ROWS * 16 % NT == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * 16 / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i >> 4, c = i & 15, gr = row0 + r;
    const bool ok = gr < nrows;
    cp_async16(tile + swz<16>(r, c), base + (ok ? gr * ld : 0) + c * 8, ok);
  }
}

}  // namespace fmma
