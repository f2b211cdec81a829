// int8-weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libra_tpu/ops/pallas/int8_matmul.py::int8_matmul
// (bodies _kernel and _kernel_stacked):
//
//   out[m, f] = (sum_k x[m, k] * q[k, f]) * scale[f]
//
// x (M, K) bf16 with unit stride in K; q (K, F) int8 with F contiguous (a
// layer of a stacked (L, K, F) buffer is passed as a pointer to its first
// byte, no copy); scale (F,) fp32; out (M, F) bf16. Sums are fp32 and the
// per-out-channel scale goes on the accumulator, as on the TPU.
//
// What bounds it on this card: at decode (M <= 8) every weight byte is read
// once and used for M multiply-adds, so reading q from device memory is the
// limit (a 4096 x 11008 projection is 45 MB: 13.5 us at 3.35 TB/s); each
// byte needs its conversion to a float and M products, so these must cost
// a few instructions a byte or they, and not the bytes, set the time.
//
// Three templates; int8_matmul picks one per call (int8_matmul_template):
//
// * decode (M <= 8, the decode step of every int8 projection): a block
//   takes a 128-column tile, and K is split into 16-k units over the 8
//   blocks of a cluster and over 4 pairs of warps of each block (the two
//   warps of a pair take the two 64-column halves of the tile), each pair a
//   contiguous run of units. The grid holds as many clusters as fit on the
//   card at once (3 blocks an SM), and each walks over column tiles, so a
//   block stages its K slice of x in shared memory as fp32 once for all its
//   tiles, its x loads issued before its first weight loads. A warp loads a
//   unit (16 k rows of its 64 columns, 1 KB) as a batch with
//   ld.global.nc.L1::no_allocate, each lane 4 adjacent columns of 4 k rows
//   in each 32-column group, the
//   next batch before the current one is used and the next tile's first
//   two batches before the current tile's reduction; there is no barrier
//   in the K loop. Each weight becomes its exact float without I2F: one
//   XOR a word maps the signed bytes b to b + 128, one PRMT a weight puts
//   that byte under the exponent of 2^23, one FADD takes 2^23 + 128 off.
//   The products run on the tensor cores (mma.sync m16n8k8, tf32: an int8
//   weight and a bf16 x value are exact in tf32; fp32 sums), the weights as
//   A straight from the lane's own words, x as B from 16-byte shared loads,
//   so a weight costs the same instructions for every M <= 8. At the end of a
//   tile the block sums its K slices in warp order and stores each sum into
//   the receive buffer of the rank that finishes its column (16 columns a
//   rank); after one cluster barrier each rank adds the 8 blocks' sums in
//   rank order, applies the column's scale and writes bf16. One launch, no
//   workspace, no atomics, a fixed order, so results repeat bit for bit.
//   It needs 16-byte x loads and 4-byte weight loads (ldx, F, ldq and the
//   bases aligned to them), K % 16 == 0, and a K slice of x that fits in
//   shared memory.
// * rows (8 < M <= 160 with aligned operands: the split prompt pass's 128
//   text rows; rows_mma.cuh holds the template, namespace rows the weight
//   mode): the weights as the A operand of bf16 mma.sync m16n8k16, 128
//   columns x 128 rows of x a block, K in stages of 128 k through a
//   cp.async ring and split over a cluster, a fixed-order cluster
//   reduction, the column's scale on the fp32 sum. Each int8 weight
//   becomes its exact fp32 by the decode template's XOR + PRMT + FADD, and
//   a pair of k rows of one column one bf16x2 A register by one PRMT of the
//   two floats' high halves (the values are exact in bf16: |q| <= 128 has 8
//   significant bits). It needs 16-byte cp.async rows (ldx % 8, ldq % 16,
//   F % 16, x and q 16-byte aligned), K % 32 == 0 and K >= 256.
// * chunked (every other call: unaligned operands; the only template before
//   the decode one, exported alone as int8_matmul_chunked):
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rows_mma.cuh"
#include "split_k.cuh"

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
constexpr int KC = 512;           // k rows per staged x chunk
constexpr int RPT = KC / KS;      // weight rows per thread per chunk: 16

struct Args {
  const __nv_bfloat16* x;
  long long ldx;
  const int8_t* q;
  long long ldq;
  const float* scale;
  __nv_bfloat16* out;
  long long ldo;
  int M, K, F;
};

// Four int8 weights q[k, f0 .. f0 + 3] as one word (byte c = column f0 + c);
// zero past the matrix.
template <bool VEC>
__device__ __forceinline__ uint32_t load4(const int8_t* row, int f0, int F) {
  if (VEC) return f0 < F ? __ldg(reinterpret_cast<const uint32_t*>(row + f0)) : 0u;
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (f0 + c < F) w |= (uint32_t)(uint8_t)__ldg(row + f0 + c) << (8 * c);
  return w;
}

__device__ __forceinline__ float byte_f32(uint32_t w, int c) {
  return (float)(int8_t)(uint8_t)(w >> (8 * c));
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS) int8_matmul_kernel(const Args a) {
  __shared__ float smem[MT * KC];   // the x chunk; then the warp partials
  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int ks = tid / CG;
  const int f0 = blockIdx.x * BF + cg * CPT;
  const int m0 = blockIdx.y * MT;

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += KC) {
    __syncthreads();   // the previous chunk is consumed
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int m = m0 + i / KC, k = k0 + i % KC;
      smem[i] = (m < a.M && k < a.K) ? __bfloat162float(a.x[m * a.ldx + k]) : 0.f;
    }
    uint32_t w[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int k = k0 + ks + KS * i;
      w[i] = k < a.K ? load4<VEC>(a.q + (long long)k * a.ldq, f0, a.F) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float wf[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) wf[c] = byte_f32(w[i], c);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = smem[m * KC + ks + KS * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
      }
    }
  }

  // k-slices: 4 in a warp (lane bits 3-4), then 8 warps in shared memory
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 8);
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
    }
  __syncthreads();   // the x chunk is no longer read
  const int warp = tid / 32, lane = tid % 32;
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
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += smem[(wi * MT + m) * BF + col];
    a.out[mm * a.ldo + f] = __float2bfloat16(s * a.scale[f]);
  }
}

template <int MT, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.F + BF - 1) / BF, (a.M + MT - 1) / MT);
  int8_matmul_kernel<MT, VEC><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int MT>
cudaError_t launch_mt(const Args& a, bool vec, cudaStream_t stream) {
  return vec ? launch<MT, true>(a, stream) : launch<MT, false>(a, stream);
}

// ---------------------------------------------------------------------------
// The decode template (M <= 8)
// ---------------------------------------------------------------------------

namespace dec {

namespace cg = cooperative_groups;
using splitk::ld_stream;

constexpr int THREADS = 256;
constexpr int WARPS = 8;
constexpr int KWARPS = 4;              // warps of a block along K, each pair on both column halves
constexpr int TILE = 128;              // output columns a block
constexpr int WCOLS = 64;              // output columns a warp: half the tile
constexpr int KSPLIT = 8;              // blocks of a cluster, one K slice each
constexpr int UNIT_K = 16;             // k rows of a slicing unit and of a load batch
constexpr int SLICES = KSPLIT * KWARPS;
constexpr int CPR = TILE / KSPLIT;     // output columns each rank finishes
constexpr int GROUPS = WCOLS / 32;     // column groups of a warp, 32 columns each
// A load batch: in each column group, the lane of mma group g and thread
// t (lane = 4 g + t) loads the 4 columns 4 g .. 4 g + 3 of the k rows
// 4 t .. 4 t + 3 of the batch, so one warp load is 4 rows x 32 bytes and a
// batch 1 KB a warp. The card streams 3.35 TB/s over 132 SMs, 25 bytes a
// ns an SM; at ~0.6-0.8 us a device-memory load under load, an SM needs
// ~15-20 KB in flight. With the next batch out while one is used, a warp
// keeps 1-2 KB in flight, 24-48 KB an SM at 3 blocks an SM.
//
// A word w of 4 int8 weights (byte c = column c): w ^ SIGN_FLIP holds each
// b + 128 (0..255) as an unsigned byte; __byte_perm(that, MAGIC, SELc) is
// the word 0x4B0000uu with uu the byte of column c, the fp32 2^23 + b + 128;
// minus MAGIC_BIAS = 2^23 + 128 it is b, exact.
constexpr uint32_t SIGN_FLIP = 0x80808080u;
constexpr uint32_t MAGIC = 0x4B000000u;
constexpr uint32_t SEL0 = 0x7440u;
constexpr uint32_t SEL1 = 0x7441u;
constexpr uint32_t SEL2 = 0x7442u;
constexpr uint32_t SEL3 = 0x7443u;
constexpr float MAGIC_BIAS = 8388736.f;
constexpr int SMEM_MAX = 160 * 1024;   // dynamic shared memory the template takes

static_assert(UNIT_K == 16, "a batch is 4 k rows for each of the 4 threads of an mma group");
static_assert(WARPS == 2 * KWARPS && 2 * WCOLS == TILE && GROUPS * 32 == WCOLS,
              "two warps of each K slice split the tile's columns in whole groups");

__host__ __device__ constexpr int k_stride(int K) {   // k of the largest K slice
  return UNIT_K * ((K / UNIT_K + KSPLIT - 1) / KSPLIT);
}

// Dynamic shared memory: the block's x slice as fp32 (MT, k_stride), the
// warps' fp32 sums (KWARPS, MT, TILE) and two receive buffers of the cluster
// reduction (2, KSPLIT, MT, CPR), never shared: other blocks write them.
__host__ __device__ constexpr int sums_offset(int MT, int K) {
  return MT * k_stride(K) * 4;
}
__host__ __device__ constexpr int recv_offset(int MT, int K) {
  return sums_offset(MT, K) + KWARPS * MT * TILE * 4;
}
__host__ __device__ constexpr int smem_bytes(int MT, int K) {
  return recv_offset(MT, K) + 2 * KSPLIT * MT * CPR * 4;
}

// the bf16 in the low and in the high half of a word, as fp32
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// the weight of the byte sel picks from u = w ^ SIGN_FLIP, as its exact fp32
__device__ __forceinline__ uint32_t weight(uint32_t u, uint32_t sel) {
  return __float_as_uint(__uint_as_float(__byte_perm(u, MAGIC, sel)) - MAGIC_BIAS);
}

// d += a b on the tensor cores, tf32 operands (an int8 weight and a bf16 x
// value are exact in tf32), fp32 sums: a m16n8k8 tile, A row-major (16 x
// 8), B column-major (8 x 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Each cluster walks over column tiles blockIdx.x, + gridDim.x, ... (the
// launch starts as many clusters as fit on the card at once), so a block
// stages its K slice of x once for all its tiles, and the next tile's
// first weight batches are in flight during the current tile's reduction.
//
// The products run on the tensor cores, out = W^T x^T a tile of 16 columns
// by the 8 rows of x (MT of them live) at a time. In the mma of column
// group j, column pair p and k pair h, A row g is column 32 j + 4 g + 2 p
// of the warp's half of the tile, A row g + 8 the column after it, and
// thread t's k slots t and t + 4 are the batch's k rows 4 t + 2 h and
// 4 t + 2 h + 1: so A comes from the bytes of the lane's own words (a0,
// a1: bytes 2 p, 2 p + 1 of row 4 t + 2 h; a2, a3: of the row after), and
// B from its own x values (x row g, the same two k rows). Any assignment
// of k rows to slots gives the same sum when A and B agree on it, so no
// data moves between lanes.
template <int MT>
__global__ void __cluster_dims__(1, KSPLIT, 1) __launch_bounds__(THREADS, 3)
    int8_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                 // mma group, thread in it
  const int half = warp / KWARPS, kw = warp % KWARPS;   // column half, K slice
  const int U = a.K / UNIT_K;
  const int nks = k_stride(a.K);
  const int ub = U * rank / KSPLIT;                     // the block's units
  const int nkb = UNIT_K * (U * (rank + 1) / KSPLIT - ub);
  const int sl = rank * KWARPS + kw;                    // the warp's units
  const int u0 = U * sl / SLICES;
  const int nb = U * (sl + 1) / SLICES - u0;            // its batches
  const int ntiles = (a.F + TILE - 1) / TILE;
  float* xs = reinterpret_cast<float*>(dsm);                                // (MT, nks)
  float* red = reinterpret_cast<float*>(dsm + sums_offset(MT, a.K));       // (KWARPS, MT, TILE)
  float* recv = reinterpret_cast<float*>(dsm + recv_offset(MT, a.K));      // (2, KSPLIT, MT, CPR)
  // this block has started: the others may write into its receive buffers
  // once they have waited on this arrival
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // x first (from L2, 16 bytes a load: a thread's first of each row), then
  // the first tile's weights, then x into shared memory (no division by a
  // runtime count: the kernel has no I2F)
  const __nv_bfloat16* xb = a.x + (long long)UNIT_K * ub;
  const int nv = nkb / 8;   // loads of x a row
  auto xload = [&](int m, int v) {
    return m < a.M ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)m * a.ldx) + v)
                   : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = tid < nv ? xload(m, tid) : make_uint4(0u, 0u, 0u, 0u);

  int tile = blockIdx.x;
  int fl = tile * TILE + WCOLS * half + 4 * g;   // the lane's first column in column group 0
  const int8_t* wp = a.q + ((long long)UNIT_K * u0 + 4 * t) * a.ldq + fl;
  uint32_t wa[GROUPS][4], wb[GROUPS][4];   // [column group][k row 4 t + r]
  auto load = [&](uint32_t(&w)[GROUPS][4], int b) {
    if (b >= nb) return;
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[j][r] = ld_stream(wp + (long long)(UNIT_K * b + r) * a.ldq + 32 * j, fl + 32 * j < a.F);
  };
  load(wa, 0);
  load(wb, 1);

  auto put = [&](int m, int v, const uint4& u) {
    float* d = xs + m * nks + 8 * v;
    *reinterpret_cast<float4*>(d) = make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
    *reinterpret_cast<float4*>(d + 4) = make_float4(bf_lo(u.z), bf_hi(u.z), bf_lo(u.w), bf_hi(u.w));
  };
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (tid < nv) put(m, tid, xr[m]);
    for (int v = tid + THREADS; v < nv; v += THREADS) put(m, v, xload(m, v));
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started

  // this thread's x: row g, from the warp's first k row + 4 t
  const float* xw = xs + g * nks + UNIT_K * (u0 - ub) + 4 * t;
  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    float acc[GROUPS][2][4];   // [column group][column pair][mma C fragment]
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][p][c] = 0.f;
    auto step = [&](const uint32_t(&w)[GROUPS][4], int b) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < MT) v = *reinterpret_cast<const float4*>(xw + UNIT_K * b);
      const uint32_t x0 = __float_as_uint(v.x), x1 = __float_as_uint(v.y);
      const uint32_t x2 = __float_as_uint(v.z), x3 = __float_as_uint(v.w);
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) {
        uint32_t q[4][4];   // [k row 4 t + r][column 4 g + c], exact floats
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t u = w[j][r] ^ SIGN_FLIP;
          q[r][0] = weight(u, SEL0);
          q[r][1] = weight(u, SEL1);
          q[r][2] = weight(u, SEL2);
          q[r][3] = weight(u, SEL3);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma_tf32(acc[j][p], q[0][2 * p], q[0][2 * p + 1], q[1][2 * p], q[1][2 * p + 1], x0, x1);
          mma_tf32(acc[j][p], q[2][2 * p], q[2][2 * p + 1], q[3][2 * p], q[3][2 * p + 1], x2, x3);
        }
      }
    };
    for (int b = 0; b < nb; b += 2) {
      step(wa, b);
      load(wa, b + 2);
      if (b + 1 < nb) {
        step(wb, b + 1);
        load(wb, b + 3);
      }
    }
    // this lane's sums into shared memory (the last tile's reads of them
    // ended before its cluster barrier): C row g is column 32 j + 4 g + 2 p
    // of the warp's half, row g + 8 the next; C columns 2 t and 2 t + 1 are
    // rows of x
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float* d = red + (kw * MT + 2 * t) * TILE + WCOLS * half + 32 * j + 4 * g + 2 * p;
        if (2 * t < MT) *reinterpret_cast<float2*>(d) = make_float2(acc[j][p][0], acc[j][p][2]);
        if (2 * t + 1 < MT)
          *reinterpret_cast<float2*>(d + TILE) = make_float2(acc[j][p][1], acc[j][p][3]);
      }

    // the next tile's first batches go out before this tile's reduction,
    // and the scale this thread applies
    const int f = tile * TILE;   // this tile's first column
    const int col = rank * CPR + tid % CPR;
    const float sc = tid < MT * CPR && f + col < a.F ? __ldg(a.scale + f + col) : 0.f;
    if (tile + (int)gridDim.x < ntiles) {
      fl += gridDim.x * TILE;
      wp += gridDim.x * TILE;
      load(wa, 0);
      load(wb, 1);
    }

    // the block's sums over its K slices, in warp order, sent to the rank
    // that finishes their columns: rank r, columns [CPR r, CPR (r + 1))
    __syncthreads();
    for (int i = tid; i < MT * TILE; i += THREADS) {
      const int m = i / TILE, c = i % TILE;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < KWARPS; ++w) s += red[w * MT * TILE + i];
      float* dst = cluster.map_shared_rank(recv, c / CPR);
      dst[((buf * KSPLIT + rank) * MT + m) * CPR + c % CPR] = s;
    }
    cluster.sync();
    // the cluster's sums, in rank order, from this block's receive buffer,
    // then the column's scale
    if (tid < MT * CPR) {
      const int m = tid / CPR;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < KSPLIT; ++r) s += recv[((buf * KSPLIT + r) * MT + m) * CPR + tid % CPR];
      if (m < a.M && f + col < a.F) a.out[(long long)m * a.ldo + f + col] = __float2bfloat16(s * sc);
    }
  }
  // Nothing reads or writes another block's shared memory after the last
  // cluster.sync (the receive buffers alternate, and a block writes a
  // buffer again only after the cluster.sync that follows its last read).
}

template <int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return splitk::launch_persistent<&int8_decode_kernel<MT>, KSPLIT, THREADS, SMEM_MAX>(
      a, (a.F + TILE - 1) / TILE, smem_bytes(MT, a.K), stream);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// The rows template (8 < M <= 160): its weight mode (rows_mma.cuh)
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

// Two exact weights of one column as one bf16x2 A register: the fp32
// values from dec::weight hold integers of at most 8 significant bits, so
// their high halves are their bf16; PRMT by PAIR_HI joins the high half of
// the first (the low half of the pair) and of the second.
constexpr uint32_t PAIR_HI = 0x7632u;

// The weight mode. A stage's weights are its 128 k rows of the tile's 128
// columns (swizzle shift 3: the lane of thread t reads k rows 8 t .. 8 t +
// 7 of each unit). In a unit (32 k) the lane holds the words of k rows 8 t
// .. 8 t + 7 of its 4 columns 4 g .. 4 g + 3, and column pair p's A rows g
// and g + 8 are the columns 4 g + 2 p and 4 g + 2 p + 1. Two m16n8k16 a
// column pair: in the h-th, thread t's k slots 2 t, 2 t + 1 are k rows 8 t
// + 4 h and 8 t + 4 h + 1, its slots 2 t + 8, 2 t + 9 the k rows 8 t + 4 h
// + 2 and + 3, so B is x row g's bf16 words at k 8 t + 4 h and 8 t + 4 h +
// 2 of the unit: one 16-byte load an n8 tile covers both h. The column
// scale multiplies the cluster's sum in the epilogue.
struct Mode {
  using Args = ::Args;
  struct Part {};
  static constexpr bool X8 = false;
  static constexpr int W_BYTES = KT * ROW;
  static constexpr int AUX_BYTES = 0;

  __device__ static void zero(Part&) {}

  __device__ static void load(const Args& a, unsigned char* w, unsigned char*, int f0, int,
                              int kbase, int tid) {
    rowsmma::stage_bytes_of<KT, 3>(w, a.q, a.ldq, kbase, a.K, f0, a.F, tid);
  }

  __device__ static void stage(const Args&, Part&, float (&acc)[2][NJ][4], const unsigned char* w,
                               const unsigned char* x, const unsigned char*, const Lane& L,
                               int kbase, int kend, int) {
    const unsigned char* wl = rowsmma::w_lane<3>(w, L);
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      if (kbase + UNIT_K * u >= kend) break;
      uint32_t pr[4][4];   // [k rows 8 t + 2 i, + 1][column 4 g + c]: bf16 pairs
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(wl + (32 * u + 2 * i) * ROW);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(wl + (32 * u + 2 * i + 1) * ROW);
        const uint32_t v0 = u0 ^ dec::SIGN_FLIP, v1 = u1 ^ dec::SIGN_FLIP;
        pr[i][0] = __byte_perm(dec::weight(v0, dec::SEL0), dec::weight(v1, dec::SEL0), PAIR_HI);
        pr[i][1] = __byte_perm(dec::weight(v0, dec::SEL1), dec::weight(v1, dec::SEL1), PAIR_HI);
        pr[i][2] = __byte_perm(dec::weight(v0, dec::SEL2), dec::weight(v1, dec::SEL2), PAIR_HI);
        pr[i][3] = __byte_perm(dec::weight(v0, dec::SEL3), dec::weight(v1, dec::SEL3), PAIR_HI);
      }
      // x row 64 rw + 8 j + g: k 8 t .. 8 t + 7 of the unit
      const unsigned char* xl =
          x + (WROWS * L.rw + L.g) * X16_ROW + (((4 * u + L.t) ^ ((L.g & 1) << 2)) << 4);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xl + 8 * j * X16_ROW);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          rowsmma::mma_bf16(acc[p][j], pr[0][2 * p], pr[0][2 * p + 1], pr[1][2 * p],
                            pr[1][2 * p + 1], xv.x, xv.y);
          rowsmma::mma_bf16(acc[p][j], pr[2][2 * p], pr[2][2 * p + 1], pr[3][2 * p],
                            pr[3][2 * p + 1], xv.z, xv.w);
        }
      }
    }
  }

  __device__ static float row_scale(const Args&, int) { return 1.f; }
  __device__ static float col_scale(const Args& a, int f) { return __ldg(a.scale + f); }
};

}  // namespace rows

Args make_args(const void* x, long long ldx, const void* q, long long ldq,
               const void* scale, void* out, long long ldo, int M, int K, int F) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ldx = ldx;
  a.q = static_cast<const int8_t*>(q);
  a.ldq = ldq;
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ldo = ldo;
  a.M = M;
  a.K = K;
  a.F = F;
  return a;
}

cudaError_t launch_chunked(const Args& a, cudaStream_t st) {
  const bool vec = a.F % CPT == 0 && a.ldq % CPT == 0 &&
                   reinterpret_cast<uintptr_t>(a.q) % CPT == 0;
  if (a.M <= 4) return launch_mt<4>(a, vec, st);
  if (a.M <= 8) return launch_mt<8>(a, vec, st);
  return launch_mt<16>(a, vec, st);
}

}  // namespace

// The template int8_matmul runs for these operands: 1 the decode template,
// 2 the rows template, 0 the chunked one. The decode template takes M <= 8
// rows of x, 16-byte x loads (ldx a multiple of 8, x's base 16-byte
// aligned), 4-byte weight loads (F, ldq and q's base multiples of 4), whole
// 16-k units (K % 16 == 0), and a K slice of x within its shared-memory
// limit. The rows template takes M > 8 rows and 16-byte cp.async rows
// (ldx % 8, ldq % 16, F % 16, x and q 16-byte aligned), whole 32-k units
// and at least two 128-k stages (K % 32 == 0, K >= 256: a cluster has at
// least two ranks).
extern "C" int int8_matmul_template(int M, int K, int F, long long ldx,
                                    long long ldq, const void* x, const void* q) {
  if (M >= 1 && M <= 8 && K % dec::UNIT_K == 0 && F % 4 == 0 && ldx % 8 == 0 && ldq % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
      dec::smem_bytes(8, K) <= dec::SMEM_MAX)
    return 1;
  if (M > 8 && K % rowsmma::UNIT_K == 0 && K >= 2 * rowsmma::KT && F % 16 == 0 &&
      ldx % 8 == 0 && ldq % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(q) % 16 == 0)
    return 2;
  return 0;
}

// The rows template's split of K for these rows: the cluster size KS (K
// in whole 128-k stages over KS blocks) and the clusters resident on the
// card at once, as its launch picks them. Returns the CUDA error code.
extern "C" int int8_matmul_rows_split(int M, int K, int F, int* ks, int* clusters) {
  return (int)rowsmma::split<rows::Mode>(M, K, F, ks, clusters);
}

// x (M, K) bf16, row stride ldx, unit stride in K; q (K, F) int8, row
// stride ldq, unit stride in F; scale (F,) fp32 contiguous; out (M, F)
// bf16, row stride ldo. Launches the template int8_matmul_template names.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int int8_matmul(const void* x, long long ldx, const void* q,
                           long long ldq, const void* scale, void* out,
                           long long ldo, int M, int K, int F, void* stream) {
  const Args a = make_args(x, ldx, q, ldq, scale, out, ldo, M, K, F);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (int8_matmul_template(M, K, F, ldx, ldq, x, q)) {
    case 1:
      if (M <= 1) return (int)dec::launch<1>(a, st);
      if (M <= 2) return (int)dec::launch<2>(a, st);
      if (M <= 4) return (int)dec::launch<4>(a, st);
      return (int)dec::launch<8>(a, st);
    case 2:
      return (int)rowsmma::launch<rows::Mode>(a, st);
    default:
      return (int)launch_chunked(a, st);
  }
}

// The chunked template alone, for any M, with int8_matmul's arguments.
extern "C" int int8_matmul_chunked(const void* x, long long ldx, const void* q,
                                   long long ldq, const void* scale, void* out,
                                   long long ldo, int M, int K, int F, void* stream) {
  const Args a = make_args(x, ldx, q, ldq, scale, out, ldo, M, K, F);
  return (int)launch_chunked(a, static_cast<cudaStream_t>(stream));
}
