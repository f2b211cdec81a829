// Group-int4-weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libra_tpu/ops/pallas/int4_matmul.py::int4_matmul
// (bodies _kernel and _kernel_stacked):
//
//   out[m, o] = sum_g s[g, o] * sum_{k in group g} x[m, k] * w[k, o]
//
// packed (K/2, O) int8 holds two weights a byte: byte r of column o is
// (w[2r+1] << 4) | (w[2r] + 8), so w[2r] = (b & 15) - 8 and w[2r+1] = b >> 4
// (arithmetic shift of the signed byte); the +8 bias is removed exactly in
// the unpack. scales (K/G, O) fp32, G even. A layer of a stacked buffer is
// passed as a pointer to its first byte, no copy.
//
//   * weight-only (A8 = false): fp32 products of the bf16 x and the weights,
//     summed per group in fp32, times the group scale;
//   * W4A8 (A8 = true): each row of x is quantized to int8 with
//     sx = absmax / 127 and round-to-nearest-even, the group sums are exact
//     int32, each is multiplied by its group scale in fp32, and the row's
//     sx multiplies the total (int4_matmul.py:166-182, 232-235).
//
// What bounds it on this card: at decode (M <= 8) reading the packed
// weights from device memory (half the int8 bytes: 22.5 MB at
// 4096 -> 11008, 6.7 us at 3.35 TB/s); each byte feeds 2 * M
// multiply-adds plus its unpack, so the unpack and the products must cost
// a few instructions a byte or they, and not the bytes, set the time.
//
// Three templates; int4_matmul picks one per call (int4_matmul_template):
//
// * decode (M <= 8, the decode step of every int4 projection): a lane owns
//   4 adjacent output columns, so one warp load is one whole 128-byte line
//   of a byte row, and a block a 128-column tile. K is split into 16-k
//   units over the 8 blocks of a cluster and over the 8 warps of each
//   block, each warp a contiguous run of units. The grid holds as many
//   clusters as fit on the card at once, and each walks over column tiles,
//   so a block stages its K slice of x in shared memory once for all its
//   tiles: as fp32 (weight-only) or, W4A8, as int8 words of 4 consecutive
//   k, after the cluster has taken each row's absmax over its 8 slices
//   through distributed shared memory. A warp issues its weight loads
//   (ld.global.nc.L1::no_allocate) in batches of NB byte-row pairs, the
//   next batch before the current one is used, and the next tile's first
//   two batches before the current tile's reduction; there is no barrier
//   in the K loop. W4A8 takes two byte rows (4 k) at a time: two masks
//   give 16 q of each nibble as a signed byte, a 4x4 byte transpose (8
//   PRMT) one word per column, and one __dp4a per column and row of x the
//   exact product sum (the 16 goes into the fp32 group scale as s / 16,
//   exact). Weight-only turns each nibble into its exact float with a
//   magic-number subtraction, no I2F. A warp's group sums, times the
//   group's scale, go into the lane's fp32 sums in shared memory whenever
//   its rows cross into the next group. At the end of a tile the block
//   sums its warps in warp order and stores each sum into the receive
//   buffer of the rank that finishes its column (16 columns a rank); after
//   one cluster barrier each rank adds the 8 blocks' sums in rank order,
//   applies sx and writes bf16. One launch, no workspace, no atomics, a
//   fixed order. It needs 16-byte x loads and scale loads and 4-byte weight
//   loads (ldx, lds, F, ldp and the bases aligned to them), G % 4 == 0,
//   K % 16 == 0, and a K slice of x that fits in shared memory.
// * rows (8 < M <= 160 with aligned operands: the split prompt pass's 128
//   text rows; rows_mma.cuh holds the template, namespace rows the two
//   weight modes): the weights as the A operand of mma.sync, 128 columns x
//   128 rows of x a block, K in stages of 128 k through a cp.async ring and
//   split over a cluster, a fixed-order cluster reduction.
//   - weight-only: bf16 m16n8k16; each packed byte is one bf16x2 A
//     register (its two k of one column) by the experiment's exact nibble
//     conversion (XOR, masks, PRMT under 0x4300, one bf16x2 fma; no I2F);
//     a group's fp32 sums times its scale as the K walk leaves the group.
//   - W4A8: one pre-pass in the same call quantizes x (a block a row: the
//     absmax, sx = absmax / 127 by IEEE division, rint(x / sx) as the
//     chunked template does) into a workspace the wrapper allocates: xq
//     (M, K) int8, each 8 k stored as its 4 even k then its 4 odd k, each
//     row's group sums of xq, and sx. Then s8 mma.sync m16n8k32 with the
//     experiment's mapping (a lane's 4 words transposed by 8 PRMT, the
//     nibbles as u8 q + 8 against int8 x): a group's exact s32 sums less
//     8 sum xq, as fp32 by a magic-number add, times the group scale; sx
//     at the end.
//   It needs 16-byte rows for cp.async (ldx % 8, ldp % 16, F % 16, lds % 4,
//   the bases 16-byte aligned), K % 32 == 0 and K >= 256, and G % 32 == 0
//   dividing 128 and K.
// * chunked (every other call: unaligned operands, odd groups): one block
//   per (32 output columns, MT rows of x), 256 threads = 8 column groups
//   of 4 adjacent columns x 32 k-slices; x is staged through shared memory
//   in chunks of 512 k (quantized there in W4A8 mode); each thread owns 8
//   consecutive byte rows of a chunk, loads them all before using any, and
//   folds its per-group partial sums into the accumulator with the group
//   scale whenever its rows cross into the next group. In W4A8 mode each
//   block first takes the absmax of its MT rows of x over all of K (from
//   L2). Exported on its own as int4_matmul_chunked.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_mma.cuh"
#include "split_k.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// The chunked template (any M <= 160)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BF = 32;            // output columns per block
constexpr int CPT = 4;            // adjacent columns per thread
constexpr int CG = BF / CPT;      // column groups: 8
constexpr int KS = THREADS / CG;  // k-slices: 32
constexpr int KC = 512;           // k per staged x chunk
constexpr int RC = KC / 2;        // byte rows per chunk
constexpr int RPT = RC / KS;      // byte rows per thread per chunk: 8

struct Args {
  const __nv_bfloat16* x;
  long long ldx;
  const int8_t* p;
  long long ldp;
  const float* s;
  long long lds;
  __nv_bfloat16* out;
  long long ldo;
  int M, K, F, G;
  // the rows template's W4A8 workspace: xq (M, K), the group sums of xq
  // (K / G, mp), sx (mp), mp = M rounded up to 4
  int8_t* xq;
  int* gsum;
  float* sx;
  int mp;
};

template <bool VEC>
__device__ __forceinline__ uint32_t load4(const int8_t* row, int f0, int F) {
  if (VEC) return f0 < F ? __ldg(reinterpret_cast<const uint32_t*>(row + f0)) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (f0 + c < F) w |= (uint32_t)(uint8_t)__ldg(row + f0 + c) << (8 * c);
  return w;
}

// The two weights of byte c of w: (w[2r], w[2r+1]).
__device__ __forceinline__ int lo_nib(uint32_t w, int c) {
  return (int)((w >> (8 * c)) & 15u) - 8;
}
__device__ __forceinline__ int hi_nib(uint32_t w, int c) {
  return (int)(int8_t)(uint8_t)(w >> (8 * c)) >> 4;
}

template <int MT, bool VEC, bool A8>
__global__ void __launch_bounds__(THREADS) int4_matmul_kernel(const Args a) {
  // x chunk as fp32 (weight-only) or as exact small integers (W4A8); then
  // the warp partials
  __shared__ float smem[MT * KC];
  __shared__ float sx[MT];          // W4A8 row scales
  using Part = typename std::conditional<A8, int, float>::type;

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int ks = tid / CG;
  const int f0 = blockIdx.x * BF + cg * CPT;
  const int m0 = blockIdx.y * MT;
  const int warp = tid / 32, lane = tid % 32;
  const int Kh = a.K / 2;

  if (A8) {
    for (int m = warp; m < MT; m += WARPS) {
      float amax = 0.f;
      if (m0 + m < a.M)
        for (int k = lane; k < a.K; k += 32)
          amax = fmaxf(amax, fabsf(__bfloat162float(a.x[(m0 + m) * a.ldx + k])));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) sx[m] = __fdiv_rn(amax > 0.f ? amax : 1.f, 127.f);
    }
  }

  float acc[MT][CPT];
  Part part[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] = 0.f;
      part[m][c] = 0;
    }
  int gcur = 0;   // the group `part` belongs to

  auto flush = [&](int g) {
    float sc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      sc[c] = f0 + c < a.F ? __ldg(a.s + (long long)g * a.lds + f0 + c) : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        acc[m][c] = fmaf((float)part[m][c], sc[c], acc[m][c]);
        part[m][c] = 0;
      }
  };

  for (int k0 = 0; k0 < a.K; k0 += KC) {
    __syncthreads();   // the previous chunk is consumed (and sx is written)
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int m = i / KC, k = k0 + i % KC;
      float v = 0.f;
      if (m0 + m < a.M && k < a.K) {
        v = __bfloat162float(a.x[(m0 + m) * a.ldx + k]);
        if (A8) v = rintf(__fdiv_rn(v, sx[m]));
      }
      smem[i] = v;
    }
    const int r0 = k0 / 2 + ks * RPT;   // this thread's first byte row
    uint32_t w[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      w[i] = r0 + i < Kh ? load4<VEC>(a.p + (long long)(r0 + i) * a.ldp, f0, a.F) : 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      if (r >= Kh) continue;   // and so are the rest: past the last row
      const int g = 2 * r / a.G;
      if (g != gcur) {
        flush(gcur);
        gcur = g;
      }
      const int kk = 2 * (ks * RPT + i);   // k of the even weight, in the chunk
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xe = smem[m * KC + kk], xo = smem[m * KC + kk + 1];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if constexpr (A8)
            part[m][c] += (int)xe * lo_nib(w[i], c) + (int)xo * hi_nib(w[i], c);
          else
            part[m][c] = fmaf(xe, (float)lo_nib(w[i], c),
                              fmaf(xo, (float)hi_nib(w[i], c), part[m][c]));
        }
      }
    }
  }
  flush(gcur);

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 8);
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
    }
  __syncthreads();   // the x chunk is no longer read
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) smem[(warp * MT + m) * BF + lane * CPT + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < MT * BF; i += THREADS) {
    const int m = i / BF, col = i % BF;
    const int mm = m0 + m, f = blockIdx.x * BF + col;
    if (mm >= a.M || f >= a.F) continue;
    float t = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) t += smem[(wi * MT + m) * BF + col];
    if (A8) t *= sx[m];
    a.out[mm * a.ldo + f] = __float2bfloat16(t);
  }
}

template <int MT, bool VEC, bool A8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.F + BF - 1) / BF, (a.M + MT - 1) / MT);
  int4_matmul_kernel<MT, VEC, A8><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mt(const Args& a, bool vec, bool a8, cudaStream_t stream) {
  if (a8) return vec ? launch<MT, true, true>(a, stream) : launch<MT, false, true>(a, stream);
  return vec ? launch<MT, true, false>(a, stream) : launch<MT, false, false>(a, stream);
}


// ---------------------------------------------------------------------------
// The decode template (M <= 8)
// ---------------------------------------------------------------------------

namespace dec {

namespace cg = cooperative_groups;
using splitk::ld_stream;

constexpr int THREADS = 256;
constexpr int WARPS = 8;
constexpr int TILE = 128;              // output columns a block: 32 lanes x 4
constexpr int KSPLIT = 8;              // blocks of a cluster, one K slice each
constexpr int UNIT_K = 16;             // k of a slicing unit: 4 byte-row pairs
constexpr int SLICES = KSPLIT * WARPS;
constexpr int CPR = TILE / KSPLIT;     // output columns each rank finishes
// A byte b = (q[2r+1] << 4) | (q[2r] + 8), four to a word (one a column):
// w & NIB_HI holds 16 q[2r+1] and ((w << 4) ^ NIB_FLIP) & NIB_HI holds
// 16 q[2r], each as a signed byte.
constexpr uint32_t NIB_HI = 0xF0F0F0F0u;
constexpr uint32_t NIB_FLIP = 0x80808080u;
// 4x4 byte transpose: __byte_perm(a, b, SEL_LO) = (a0, b0, a1, b1),
// SEL_HI = (a2, b2, a3, b3); then SEL_W0 takes the low halves of two
// words, SEL_W1 the high halves.
constexpr uint32_t SEL_LO = 0x5140u;
constexpr uint32_t SEL_HI = 0x7362u;
constexpr uint32_t SEL_W0 = 0x5410u;
constexpr uint32_t SEL_W1 = 0x7632u;
// A nibble n (0..15) as the fp32 2^23 + n, minus 2^23 + 8: n - 8, exact.
constexpr uint32_t MAGIC = 0x4B000000u;
constexpr float MAGIC_BIAS = 8388616.f;
constexpr float DP4A_SCALE = 0.0625f;  // 1/16: the masked bytes hold 16 q
constexpr int SMEM_MAX = 160 * 1024;   // dynamic shared memory the template takes

__host__ __device__ constexpr int k_stride(int K) {   // k of the largest K slice
  return UNIT_K * ((K / UNIT_K + KSPLIT - 1) / KSPLIT);
}

// Dynamic shared memory: the block's x slice as fp32 (MT, k_stride) and,
// W4A8, as int8 words (MT, k_stride / 4); the warps' fp32 sums (WARPS, MT,
// TILE), which take the fp32 slice's room in W4A8 (it is dead once x is
// quantized); two receive buffers of the cluster reduction (2, KSPLIT, MT,
// CPR), never shared: other blocks write them.
__host__ __device__ constexpr int sums_offset(int MT, bool a8, int K) {
  return a8 ? MT * k_stride(K) : MT * k_stride(K) * 4;
}
__host__ __device__ constexpr int recv_offset(int MT, bool a8, int K) {
  return a8 && MT * k_stride(K) * 4 > WARPS * MT * TILE * 4
             ? MT * k_stride(K) * 5
             : sums_offset(MT, a8, K) + WARPS * MT * TILE * 4;
}
__host__ __device__ constexpr int smem_bytes(int MT, bool a8, int K) {
  return recv_offset(MT, a8, K) + 2 * KSPLIT * MT * CPR * 4;
}

__device__ __forceinline__ float4 ld_scale(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float lo_f(uint32_t w, int c) {   // q[2r] of byte c
  return __int_as_float(MAGIC | ((w >> (8 * c)) & 15u)) - MAGIC_BIAS;
}
__device__ __forceinline__ float hi_f(uint32_t w, int c) {   // q[2r+1] of byte c
  return __int_as_float(MAGIC | (((w >> (8 * c + 4)) & 15u) ^ 8u)) - MAGIC_BIAS;
}

// the bf16 in the low and in the high half of a word, as fp32
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

__device__ __forceinline__ uint32_t q8(float v) {   // an exact int8 value's byte
  return (uint32_t)__float2int_rn(v) & 255u;
}

// Each cluster walks over column tiles blockIdx.x, + gridDim.x, ... (the
// launch starts as many clusters as fit on the card at once), so a block
// stages and quantizes its K slice of x once for all its tiles, and the
// next tile's first weight batches are in flight during the current tile's
// reduction.
template <int MT, bool A8>
__global__ void __cluster_dims__(1, KSPLIT, 1) __launch_bounds__(THREADS, 3)
    int4_decode_kernel(const Args a) {
  constexpr int NB = A8 && MT <= 4 ? 8 : 4;   // byte-row pairs a load batch
  constexpr int XR = 2;                        // x loads a thread issues first
  using Part = typename std::conditional<A8, int, float>::type;
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ float amax_s[MT], sx_s[MT];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int U = a.K / UNIT_K;
  const int nks = k_stride(a.K);
  const int ub = U * rank / KSPLIT;                     // the block's units
  const int nkb = UNIT_K * (U * (rank + 1) / KSPLIT - ub);
  const int sl = rank * WARPS + warp;                   // the warp's units
  const int u0 = U * sl / SLICES;
  const int np = 4 * (U * (sl + 1) / SLICES - u0);      // its byte-row pairs
  const int p0 = 4 * u0;                                // its first pair
  const int lp0 = p0 - 4 * ub;                          // ... in the x slice
  const int PG = a.G / 4;                               // pairs a group
  const int g0 = p0 / PG;                               // the group of pair p0
  const int ntiles = (a.F + TILE - 1) / TILE;
  int* xq = reinterpret_cast<int*>(dsm);                                // W4A8 (MT, nks / 4)
  float* xs = reinterpret_cast<float*>(dsm + (A8 ? MT * nks : 0));      // (MT, nks)
  float* red = reinterpret_cast<float*>(dsm + sums_offset(MT, A8, a.K));  // (WARPS, MT, TILE)
  float* recv = reinterpret_cast<float*>(dsm + recv_offset(MT, A8, a.K));  // (2, KSPLIT, MT, CPR)
  float4* acc = reinterpret_cast<float4*>(red) + warp * MT * 32 + lane;  // this lane's sums

  // x first (from L2, 16 bytes a load), then the first tile's weights, then
  // x into shared memory
  const __nv_bfloat16* xb = a.x + (long long)UNIT_K * ub;
  const int nv = nkb / 8;   // loads of x a row
  uint4 xr[XR];
#pragma unroll
  for (int r = 0; r < XR; ++r) {
    const int i = tid + r * THREADS, m = i / max(nv, 1);
    xr[r] = i < MT * nv && m < a.M
                ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)m * a.ldx) + (i - m * nv))
                : make_uint4(0u, 0u, 0u, 0u);
  }

  int tile = blockIdx.x;
  int f0 = tile * TILE + lane * 4;
  bool live = f0 < a.F;
  const int8_t* wp = a.p + (long long)(2 * p0) * a.ldp + f0;
  uint32_t wa[2 * NB], wb[2 * NB];
  auto load = [&](uint32_t(&w)[2 * NB], int b) {
    if (b * NB >= np) return;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int j = b * NB + i;
      const int8_t* r = wp + (long long)(2 * j) * a.ldp;
      w[2 * i] = ld_stream(r, live && j < np);
      w[2 * i + 1] = ld_stream(r + a.ldp, live && j < np);
    }
  };
  load(wa, 0);
  load(wb, 1);
  float4 sc = ld_scale(a.s + (long long)g0 * a.lds + f0, live && np > 0);

  auto put = [&](int i, const uint4& u) {
    const int m = i / nv, v = i - m * nv;
    float* d = xs + m * nks + 8 * v;
    *reinterpret_cast<float4*>(d) = make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
    *reinterpret_cast<float4*>(d + 4) = make_float4(bf_lo(u.z), bf_hi(u.z), bf_lo(u.w), bf_hi(u.w));
  };
#pragma unroll
  for (int r = 0; r < XR; ++r)
    if (tid + r * THREADS < MT * nv) put(tid + r * THREADS, xr[r]);
  for (int i = tid + XR * THREADS; i < MT * nv; i += THREADS) {
    const int m = i / nv;
    put(i, m < a.M ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)m * a.ldx) + (i - m * nv))
                   : make_uint4(0u, 0u, 0u, 0u));
  }
  __syncthreads();
  if constexpr (A8) {
    if (warp < MT) {
      float v = 0.f;
      for (int k = lane; k < nkb; k += 32) v = fmaxf(v, fabsf(xs[warp * nks + k]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) amax_s[warp] = v;
    }
    cluster.sync();
    if (tid < MT) {
      float v = 0.f;
      for (int q = 0; q < KSPLIT; ++q) v = fmaxf(v, *cluster.map_shared_rank(&amax_s[tid], q));
      sx_s[tid] = __fdiv_rn(v > 0.f ? v : 1.f, 127.f);
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float s = sx_s[m];
      for (int j = tid; j < nkb / 4; j += THREADS) {
        const float4 v = *reinterpret_cast<const float4*>(xs + m * nks + 4 * j);
        xq[m * (nks / 4) + j] = (int)(q8(rintf(__fdiv_rn(v.x, s))) |
                                      q8(rintf(__fdiv_rn(v.y, s))) << 8 |
                                      q8(rintf(__fdiv_rn(v.z, s))) << 16 |
                                      q8(rintf(__fdiv_rn(v.w, s))) << 24);
      }
    }
    __syncthreads();
  }

  Part part[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[m][c] = 0;
  // a group's sums times its scale, into this lane's sums in shared memory
  auto flush = [&]() {
    const float k = A8 ? DP4A_SCALE : 1.f;
    const float s0 = sc.x * k, s1 = sc.y * k, s2 = sc.z * k, s3 = sc.w * k;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float4 t = acc[m * 32];
      t.x = fmaf((float)part[m][0], s0, t.x);
      t.y = fmaf((float)part[m][1], s1, t.y);
      t.z = fmaf((float)part[m][2], s2, t.z);
      t.w = fmaf((float)part[m][3], s3, t.w);
      acc[m * 32] = t;
#pragma unroll
      for (int c = 0; c < 4; ++c) part[m][c] = 0;
    }
  };

  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
    int g = g0, pend = (g0 + 1) * PG;   // the group of the sums; the next group's first pair
    auto step = [&](const uint32_t(&w)[2 * NB], int b) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int j = b * NB + i;   // np is a multiple of 4, NB too: a batch is whole or past np
        if (j >= np) break;
        if (p0 + j >= pend) {   // the pair opens the next group
          flush();
          ++g;
          pend += PG;
          sc = ld_scale(a.s + (long long)g * a.lds + f0, live);
        }
        const uint32_t w0 = w[2 * i], w1 = w[2 * i + 1];
        if constexpr (A8) {
          const uint32_t lo0 = ((w0 << 4) ^ NIB_FLIP) & NIB_HI, hi0 = w0 & NIB_HI;
          const uint32_t lo1 = ((w1 << 4) ^ NIB_FLIP) & NIB_HI, hi1 = w1 & NIB_HI;
          const uint32_t t0 = __byte_perm(lo0, hi0, SEL_LO), t1 = __byte_perm(lo0, hi0, SEL_HI);
          const uint32_t t2 = __byte_perm(lo1, hi1, SEL_LO), t3 = __byte_perm(lo1, hi1, SEL_HI);
          const int col[4] = {(int)__byte_perm(t0, t2, SEL_W0), (int)__byte_perm(t0, t2, SEL_W1),
                              (int)__byte_perm(t1, t3, SEL_W0), (int)__byte_perm(t1, t3, SEL_W1)};
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int xv = xq[m * (nks / 4) + lp0 + j];
#pragma unroll
            for (int c = 0; c < 4; ++c) part[m][c] = __dp4a(col[c], xv, part[m][c]);
          }
        } else {
          float q[4][4];   // [column][k - 4p]
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            q[c][0] = lo_f(w0, c);
            q[c][1] = hi_f(w0, c);
            q[c][2] = lo_f(w1, c);
            q[c][3] = hi_f(w1, c);
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float4 v = *reinterpret_cast<const float4*>(xs + m * nks + 4 * (lp0 + j));
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[m][c] = fmaf(v.w, q[c][3], fmaf(v.z, q[c][2],
                           fmaf(v.y, q[c][1], fmaf(v.x, q[c][0], part[m][c]))));
          }
        }
      }
    };
    const int nb = (np + NB - 1) / NB;
    for (int b = 0; b < nb; b += 2) {
      step(wa, b);
      load(wa, b + 2);
      step(wb, b + 1);
      load(wb, b + 3);
    }
    flush();

    // the next tile's first batches go out before this tile's reduction
    const int f = tile * TILE;   // this tile's first column
    if (tile + (int)gridDim.x < ntiles) {
      f0 += gridDim.x * TILE;
      live = f0 < a.F;
      wp += gridDim.x * TILE;
      load(wa, 0);
      load(wb, 1);
      sc = ld_scale(a.s + (long long)g0 * a.lds + f0, live && np > 0);
    }

    // the block's sums over its warps, in warp order, sent to the rank that
    // finishes their columns: rank r, columns [CPR r, CPR (r + 1))
    __syncthreads();
    for (int i = tid; i < MT * TILE; i += THREADS) {
      const int m = i / TILE, col = i % TILE;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += red[w * MT * TILE + i];
      float* dst = cluster.map_shared_rank(recv, col / CPR);
      dst[((buf * KSPLIT + rank) * MT + m) * CPR + col % CPR] = t;
    }
    cluster.sync();
    // the cluster's sums, in rank order, from this block's receive buffer
    if (tid < MT * CPR) {
      const int m = tid / CPR, col = rank * CPR + tid % CPR;
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < KSPLIT; ++q) t += recv[((buf * KSPLIT + q) * MT + m) * CPR + tid % CPR];
      if (A8) t *= sx_s[m];
      if (m < a.M && f + col < a.F) a.out[(long long)m * a.ldo + f + col] = __float2bfloat16(t);
    }
  }
  // Nothing reads or writes another block's shared memory after the last
  // cluster.sync (the receive buffers alternate, and a block writes a
  // buffer again only after the cluster.sync that follows its last read).
}

template <int MT, bool A8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return splitk::launch_persistent<&int4_decode_kernel<MT, A8>, KSPLIT, THREADS, SMEM_MAX>(
      a, (a.F + TILE - 1) / TILE, smem_bytes(MT, A8, a.K), stream);
}

template <int MT>
cudaError_t launch_mt(const Args& a, bool a8, cudaStream_t stream) {
  return a8 ? launch<MT, true>(a, stream) : launch<MT, false>(a, stream);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// The rows template (8 < M <= 160): its two weight modes (rows_mma.cuh)
// ---------------------------------------------------------------------------

namespace rows {

using rowsmma::Lane;
using rowsmma::NJ;
using rowsmma::KT;
using rowsmma::UNIT_K;
using rowsmma::UNITS;
using rowsmma::ROW;
using rowsmma::X16_ROW;
using rowsmma::WROWS;
using rowsmma::TILE_F;
using rowsmma::TILE_M;
using rowsmma::comp;
using splitk::prmt;

// Weight-only (the experiment's C mode): a word w of 4 packed bytes (byte c
// = column c), u = w ^ SIGN_FLIP holds q1 + 8 in each high nibble and q0 +
// 8 in each low one; lo = u & NIB_MASK and hi = (u >> 4) & NIB_MASK are
// the nibbles as bytes. SELc puts lo's byte c under the low half and hi's
// byte c under the high half of a word, 0x00 above each (a sign-replicating
// selector on a nibble byte); OR BF16_128 makes the halves the bf16 128 +
// n, and a bf16x2 fma by BF16_ONE plus OFFSET = {-136, -136} gives {q0,
// q1}, exact: the byte's two k of its column, one bf16x2 A register.
constexpr uint32_t SIGN_FLIP = 0x80808080u;
constexpr uint32_t NIB_MASK = 0x0F0F0F0Fu;
constexpr uint32_t SEL0 = 0xC480u;
constexpr uint32_t SEL1 = 0xD591u;
constexpr uint32_t SEL2 = 0xE6A2u;
constexpr uint32_t SEL3 = 0xF7B3u;
constexpr uint32_t BF16_128 = 0x43004300u;
constexpr uint32_t BF16_ONE = 0x3F803F80u;
constexpr uint32_t OFFSET = 0xC308C308u;
// W4A8 (the experiment's mapping): the lane's 4 words of a unit (word r:
// byte row 4 t + r) become one word a column by a 4x4 byte transpose:
// prmt(a, b, SEL_LO) = (a0, b0, a1, b1), SEL_HI = (a2, b2, a3, b3), then
// SEL_W0 takes the low halves of two words and SEL_W1 the high halves, so
// word c holds column 4 g + c, byte r its byte row 4 t + r. Of such a
// word, w & NIB_MASK is q0 + 8 of each byte and ((w >> 4) ^ HI_FLIP) &
// NIB_MASK is q1 + 8, both 0..15 as u8: the 4 even and the 4 odd k of the
// lane's slots, against x staged as each 8 k's 4 even k, then its 4 odd k.
constexpr uint32_t SEL_LO = 0x5140u;
constexpr uint32_t SEL_HI = 0x7362u;
constexpr uint32_t SEL_W0 = 0x5410u;
constexpr uint32_t SEL_W1 = 0x7632u;
constexpr uint32_t HI_FLIP = 0x08080808u;
// An integer n with |n| < 2^22 as fp32 without I2F: MAGIC_I + n are the
// bits of the fp32 1.5 * 2^23 + n, and minus MAGIC_F that is n, exact. A
// group sum is |sum xq q| <= 127 * 8 * G <= 2^17 (G <= KT).
constexpr uint32_t MAGIC_I = 0x4B400000u;
constexpr float MAGIC_F = 12582912.0;
constexpr int MAX_GROUPS = 1024;       // K / G the pre-pass's shared group sums take
constexpr int GSLOTS = KT / UNIT_K;    // groups a stage holds (G divides KT)

static_assert(1016 * KT < (1 << 22), "a W4A8 group sum converts exactly");

__host__ __device__ constexpr int pad4(int M) { return (M + 3) & ~3; }
// The W4A8 workspace: xq (M, K) int8, then the group sums (K / G, pad4(M))
// int32, then sx (pad4(M)) fp32; each part 16-byte aligned (K % 32 == 0).
__host__ __device__ constexpr long long gsum_offset(int M, int K) { return (long long)M * K; }
__host__ __device__ constexpr long long sx_offset(int M, int K, int G) {
  return gsum_offset(M, K) + 4LL * pad4(M) * (K / G);
}
__host__ __device__ constexpr long long workspace_bytes(int M, int K, int G) {
  return sx_offset(M, K, G) + 4LL * pad4(M);
}

// byte c (selector sel) of a word's nibbles lo, hi as the bf16 pair {q0, q1}
__device__ __forceinline__ uint32_t nib_pair(uint32_t lo, uint32_t hi, uint32_t sel) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(prmt(lo, hi, sel) | BF16_128), "r"(BF16_ONE), "r"(OFFSET));
  return d;
}

// The W4A8 pre-pass: a block a row of x. The row's absmax, sx = absmax /
// 127 (1 / 127 for a zero row), each xq = rint(x / sx) by IEEE division,
// as int4_matmul_plain; xq stored as each 8 k's 4 even k, then its 4 odd k
// (the order the B fragments read), with each group's sum of xq.
__global__ void __launch_bounds__(rowsmma::THREADS) quantize_kernel(const Args a) {
  __shared__ float wmax[rowsmma::WARPS];
  __shared__ int gs[MAX_GROUPS];
  const int m = blockIdx.x, tid = threadIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(a.x + (long long)m * a.ldx);
  const int nc = a.K / 8, ng = a.K / a.G;
  float v = 0.f;
  for (int c = tid; c < nc; c += rowsmma::THREADS) {
    const uint4 u = __ldg(xr + c);
    const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) v = fmaxf(v, fmaxf(fabsf(dec::bf_lo(h[i])), fabsf(dec::bf_hi(h[i]))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (tid % 32 == 0) wmax[tid / 32] = v;
  for (int g = tid; g < ng; g += rowsmma::THREADS) gs[g] = 0;
  __syncthreads();
  float amax = 0.f;
#pragma unroll
  for (int w = 0; w < rowsmma::WARPS; ++w) amax = fmaxf(amax, wmax[w]);
  const float s = __fdiv_rn(amax > 0.f ? amax : 1.f, 127.f);
  for (int c = tid; c < nc; c += rowsmma::THREADS) {
    const uint4 u = __ldg(xr + c);
    const uint32_t h[4] = {u.x, u.y, u.z, u.w};
    uint32_t even = 0u, odd = 0u;
    int sum = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // k 8 c + 2 i and 8 c + 2 i + 1
      const int q0 = (int)rintf(__fdiv_rn(dec::bf_lo(h[i]), s));
      const int q1 = (int)rintf(__fdiv_rn(dec::bf_hi(h[i]), s));
      even |= ((uint32_t)q0 & 255u) << (8 * i);
      odd |= ((uint32_t)q1 & 255u) << (8 * i);
      sum += q0 + q1;
    }
    *reinterpret_cast<uint2*>(a.xq + (long long)m * a.K + 8 * c) = make_uint2(even, odd);
    atomicAdd(&gs[8 * c / a.G], sum);
  }
  __syncthreads();
  for (int g = tid; g < ng; g += rowsmma::THREADS) a.gsum[(long long)g * a.mp + m] = gs[g];
  if (tid == 0) a.sx[m] = s;
}

// The weight modes of the rows template. A stage's weights are its 64 byte
// rows of the tile's 128 columns (swizzle shift 2: the lane of thread t
// reads byte rows 4 t .. 4 t + 3 of each unit); its aux rows the scales of
// the (at most GSLOTS) groups it holds and, W4A8, the tile rows' group sums
// of xq. In a unit (32 k, 16 byte rows) the lane holds the words of byte
// rows 4 t .. 4 t + 3 of its 4 columns 4 g .. 4 g + 3: column pair p's A
// rows g and g + 8 are the columns 4 g + 2 p and 4 g + 2 p + 1.
// * weight-only, m16n8k16 twice a column pair: in the h-th, thread t's k
//   slots 2 t, 2 t + 1 are the two k of byte row 4 t + 2 h and its slots
//   2 t + 8, 2 t + 9 those of byte row 4 t + 2 h + 1, so B is x row g's
//   bf16 words at k 8 t + 4 h and 8 t + 4 h + 2 of the unit: one 16-byte
//   load an n8 tile covers both h.
// * W4A8, one m16n8k32 a column pair: thread t's k slots 4 t .. 4 t + 3 are
//   the even k of byte rows 4 t .. 4 t + 3 (their low nibbles), its slots
//   16 + 4 t .. the odd k (the high nibbles), and B is x row g's 8 bytes at
//   k 8 t .. 8 t + 7 of the unit as staged (4 even k, then 4 odd k).
// Any assignment of k to slots gives the same sum when A and B agree on it.
template <bool A8>
struct Mode {
  using Args = ::Args;
  using P = typename std::conditional<A8, int, float>::type;
  struct Part {
    P v[2][NJ][4];   // the current group's sums: [column pair][n8 tile][C fragment]
  };
  static constexpr bool X8 = A8;
  static constexpr int W_BYTES = KT / 2 * ROW;
  static constexpr int S_BYTES = GSLOTS * TILE_F * 4;
  static constexpr int AUX_BYTES = S_BYTES + (A8 ? GSLOTS * TILE_M * 4 : 0);

  __device__ static void zero(Part& part) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) part.v[p][j][c] = 0;
  }

  __device__ static void load(const Args& a, unsigned char* w, unsigned char* aux, int f0, int m0,
                              int kbase, int tid) {
    rowsmma::stage_bytes_of<KT / 2, 2>(w, a.p, a.ldp, kbase / 2, a.K / 2, f0, a.F, tid);
    if (tid < GSLOTS * 32) {
      const int sl = tid / 32, c = tid % 32;
      const int g = kbase / a.G + sl;
      const bool in = g * a.G < min(kbase + KT, a.K);   // a group of this stage
      const bool ok = in && f0 + 4 * c < a.F;
      rowsmma::cp_async16(aux + sl * TILE_F * 4 + 16 * c,
                          ok ? a.s + (long long)g * a.lds + f0 + 4 * c : a.s, ok ? 16 : 0);
      if constexpr (A8) {
        const int m = m0 + 4 * c, n = in && m < a.M ? min(4, a.M - m) : 0;
        rowsmma::cp_async16(aux + S_BYTES + sl * TILE_M * 4 + 16 * c,
                            n ? a.gsum + (long long)g * a.mp + m : a.gsum, 4 * n);
      }
    }
  }

  // a group's sums times its scale (W4A8: less 8 sum xq, exact, then as
  // fp32) into the lane's sums; C rows g, g + 8 are the columns 4 g + 2 p,
  // + 1; C columns 2 t, 2 t + 1 are rows of x
  __device__ static void fold(const Args& a, Part& part, float (&acc)[2][NJ][4],
                              const unsigned char* aux, const Lane& L, int sl, int nj) {
    const float4 sc = *reinterpret_cast<const float4*>(aux + sl * TILE_F * 4 +
                                                       (32 * L.cw + 4 * L.g) * 4);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
      int2 gsum = make_int2(0, 0);
      if constexpr (A8)
        gsum = *reinterpret_cast<const int2*>(aux + S_BYTES + sl * TILE_M * 4 +
                                              (WROWS * L.rw + 8 * j + 2 * L.t) * 4);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float s = comp(sc, 2 * p + c / 2);
          if constexpr (A8) {
            const int n = part.v[p][j][c] - 8 * (c % 2 ? gsum.y : gsum.x);
            acc[p][j][c] = fmaf(__uint_as_float(MAGIC_I + (uint32_t)n) - MAGIC_F, s, acc[p][j][c]);
          } else {
            acc[p][j][c] = fmaf(part.v[p][j][c], s, acc[p][j][c]);
          }
          part.v[p][j][c] = 0;
        }
    }
  }

  __device__ static void stage(const Args& a, Part& part, float (&acc)[2][NJ][4],
                               const unsigned char* w, const unsigned char* x,
                               const unsigned char* aux, const Lane& L, int kbase, int kend,
                               int nj) {
    const unsigned char* wl = rowsmma::w_lane<2>(w, L);
    const int g_lo = kbase / a.G;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int kk = kbase + UNIT_K * u;
      if (kk >= kend) break;
      uint32_t wv[4];   // byte rows 4 t + r of the unit, columns 4 g .. 4 g + 3
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[r] = *reinterpret_cast<const uint32_t*>(wl + (16 * u + r) * ROW);
      if constexpr (A8) {
        const uint32_t t0 = prmt(wv[0], wv[1], SEL_LO), t1 = prmt(wv[0], wv[1], SEL_HI);
        const uint32_t t2 = prmt(wv[2], wv[3], SEL_LO), t3 = prmt(wv[2], wv[3], SEL_HI);
        const uint32_t col[4] = {prmt(t0, t2, SEL_W0), prmt(t0, t2, SEL_W1),
                                 prmt(t1, t3, SEL_W0), prmt(t1, t3, SEL_W1)};
        uint32_t lo[4], hi[4];   // [column 4 g + c]: q0 + 8 and q1 + 8 of its byte rows
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = col[c] & NIB_MASK;
          hi[c] = ((col[c] >> 4) ^ HI_FLIP) & NIB_MASK;
        }
        // x row 64 rw + 8 j + g: bytes 8 t .. 8 t + 7 of the unit
        const unsigned char* xl = x + (WROWS * L.rw + L.g) * ROW +
                                  (((2 * u + (L.t >> 1)) ^ ((L.g & 3) << 1)) << 4) +
                                  8 * (L.t & 1);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint2 xv = *reinterpret_cast<const uint2*>(xl + 8 * j * ROW);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            rowsmma::mma_u8s8(part.v[p][j], lo[2 * p], lo[2 * p + 1], hi[2 * p], hi[2 * p + 1],
                              xv.x, xv.y);
        }
      } else {
        uint32_t q[4][4];   // [byte row 4 t + r][column 4 g + c]: bf16 pairs {q0, q1}
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t uw = wv[r] ^ SIGN_FLIP;
          const uint32_t lo = uw & NIB_MASK, hi = (uw >> 4) & NIB_MASK;
          q[r][0] = nib_pair(lo, hi, SEL0);
          q[r][1] = nib_pair(lo, hi, SEL1);
          q[r][2] = nib_pair(lo, hi, SEL2);
          q[r][3] = nib_pair(lo, hi, SEL3);
        }
        // x row 64 rw + 8 j + g: k 8 t .. 8 t + 7 of the unit
        const unsigned char* xl =
            x + (WROWS * L.rw + L.g) * X16_ROW + (((4 * u + L.t) ^ ((L.g & 1) << 2)) << 4);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xl + 8 * j * X16_ROW);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            rowsmma::mma_bf16(part.v[p][j], q[0][2 * p], q[0][2 * p + 1], q[1][2 * p],
                              q[1][2 * p + 1], xv.x, xv.y);
            rowsmma::mma_bf16(part.v[p][j], q[2][2 * p], q[2][2 * p + 1], q[3][2 * p],
                              q[3][2 * p + 1], xv.z, xv.w);
          }
        }
      }
      if ((kk + UNIT_K) % a.G == 0) fold(a, part, acc, aux, L, kk / a.G - g_lo, nj);
    }
  }

  __device__ static float row_scale(const Args& a, int m) { return A8 ? a.sx[m] : 1.f; }
  __device__ static float col_scale(const Args&, int) { return 1.f; }
};

cudaError_t launch(Args a, bool a8, void* ws, long long ws_bytes, cudaStream_t st) {
  if (!a8) return rowsmma::launch<Mode<false>>(a, st);
  if (ws == nullptr || ws_bytes < workspace_bytes(a.M, a.K, a.G)) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(ws);
  a.mp = pad4(a.M);
  a.xq = reinterpret_cast<int8_t*>(base);
  a.gsum = reinterpret_cast<int*>(base + gsum_offset(a.M, a.K));
  a.sx = reinterpret_cast<float*>(base + sx_offset(a.M, a.K, a.G));
  quantize_kernel<<<a.M, rowsmma::THREADS, 0, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return rowsmma::launch<Mode<true>>(a, st);
}

}  // namespace rows

Args make_args(const void* x, long long ldx, const void* packed, long long ldp,
               const void* scales, long long lds, void* out, long long ldo,
               int M, int K, int F, int G) {
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ldx = ldx;
  a.p = static_cast<const int8_t*>(packed);
  a.ldp = ldp;
  a.s = static_cast<const float*>(scales);
  a.lds = lds;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.M = M;
  a.K = K;
  a.F = F;
  a.G = G;
  return a;
}

cudaError_t launch_chunked(const Args& a, bool a8, cudaStream_t st) {
  const bool vec = a.F % CPT == 0 && a.ldp % CPT == 0 &&
                   reinterpret_cast<uintptr_t>(a.p) % CPT == 0;
  if (a.M <= 4) return launch_mt<4>(a, vec, a8, st);
  if (a.M <= 8) return launch_mt<8>(a, vec, a8, st);
  return launch_mt<16>(a, vec, a8, st);
}

}  // namespace

// The template int4_matmul runs for these operands: 1 the decode template,
// 2 the rows template, 0 the chunked one; the choice does not depend on a8.
// The decode template takes M <= 8 rows of x, 16-byte x loads (ldx a
// multiple of 8, x's base 16-byte aligned), 4-byte weight loads (F, ldp and
// the packed base multiples of 4), 16-byte scale loads (lds a multiple of
// 4, the scales' base 16-byte aligned), whole 16-k units and 4-k pairs
// inside a group (K % 16 == 0, G % 4 == 0), and a K slice of x within its
// shared-memory limit in either mode. The rows template takes M > 8 rows
// and 16-byte cp.async rows (ldx % 8, ldp % 16, F % 16, lds % 4, every base
// 16-byte aligned), whole 32-k units and at least two 128-k stages (K % 32
// == 0, K >= 256: a cluster has at least two ranks), groups of whole units
// that divide a stage (G % 32 == 0, 128 % G == 0), and at most MAX_GROUPS
// groups (the pre-pass's shared sums).
extern "C" int int4_matmul_template(int M, int K, int F, int G, long long ldx,
                                    long long ldp, long long lds, const void* x,
                                    const void* packed, const void* scales) {
  const bool aligned16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  if (M >= 1 && M <= 8 && K % dec::UNIT_K == 0 && G % 4 == 0 && F % 4 == 0 && ldx % 8 == 0 &&
      ldp % 4 == 0 && lds % 4 == 0 && aligned16 && reinterpret_cast<uintptr_t>(packed) % 4 == 0 &&
      dec::smem_bytes(8, false, K) <= dec::SMEM_MAX && dec::smem_bytes(8, true, K) <= dec::SMEM_MAX)
    return 1;
  if (M > 8 && K % rowsmma::UNIT_K == 0 && K >= 2 * rowsmma::KT && G > 0 &&
      G % rowsmma::UNIT_K == 0 && rowsmma::KT % G == 0 && K % G == 0 &&
      K / G <= rows::MAX_GROUPS && F % 16 == 0 && ldx % 8 == 0 && ldp % 16 == 0 &&
      lds % 4 == 0 && aligned16 && reinterpret_cast<uintptr_t>(packed) % 16 == 0)
    return 2;
  return 0;
}

// The bytes of workspace int4_matmul needs for these rows (the rows
// template's W4A8 pre-pass: xq, the group sums, sx); 0 without a8 or at
// the decode template's M <= 8. Under 2^31 for the wrapper's M <= 160
// rows and the gate's K / G <= MAX_GROUPS, G <= 128.
extern "C" int int4_matmul_workspace(int M, int K, int G, int a8) {
  return a8 && M > 8 && G > 0 ? (int)rows::workspace_bytes(M, K, G) : 0;
}

// The rows template's split of K for these rows: the cluster size KS (K
// in whole 128-k stages over KS blocks) and the clusters resident on the
// card at once, as its launch picks them. Returns the CUDA error code.
extern "C" int int4_matmul_rows_split(int M, int K, int F, int a8, int* ks, int* clusters) {
  return (int)(a8 ? rowsmma::split<rows::Mode<true>>(M, K, F, ks, clusters)
                  : rowsmma::split<rows::Mode<false>>(M, K, F, ks, clusters));
}

// x (M, K) bf16, row stride ldx, unit stride in K; packed (K/2, F) int8,
// row stride ldp; scales (K/G, F) fp32, row stride lds; out (M, F) bf16,
// row stride ldo. K and G even, K % G == 0 (the wrapper checks). a8: run
// W4A8. ws: ws_bytes of device memory for the rows template's W4A8
// pre-pass (int4_matmul_workspace; unused by the other templates).
// Launches the template int4_matmul_template names. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int int4_matmul(const void* x, long long ldx, const void* packed,
                           long long ldp, const void* scales, long long lds,
                           void* out, long long ldo, int M, int K, int F,
                           int G, int a8, void* ws, long long ws_bytes, void* stream) {
  const Args a = make_args(x, ldx, packed, ldp, scales, lds, out, ldo, M, K, F, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (int4_matmul_template(M, K, F, G, ldx, ldp, lds, x, packed, scales)) {
    case 1:
      if (M <= 1) return (int)dec::launch_mt<1>(a, a8 != 0, st);
      if (M <= 2) return (int)dec::launch_mt<2>(a, a8 != 0, st);
      if (M <= 4) return (int)dec::launch_mt<4>(a, a8 != 0, st);
      return (int)dec::launch_mt<8>(a, a8 != 0, st);
    case 2:
      return (int)rows::launch(a, a8 != 0, ws, ws_bytes, st);
    default:
      return (int)launch_chunked(a, a8 != 0, st);
  }
}

// The chunked template alone, for any M, with int4_matmul's arguments.
extern "C" int int4_matmul_chunked(const void* x, long long ldx, const void* packed,
                                   long long ldp, const void* scales, long long lds,
                                   void* out, long long ldo, int M, int K, int F,
                                   int G, int a8, void*, long long, void* stream) {
  const Args a = make_args(x, ldx, packed, ldp, scales, lds, out, ldo, M, K, F, G);
  return (int)launch_chunked(a, a8 != 0, static_cast<cudaStream_t>(stream));
}
