// The rows template for Hopper (sm_90a): x (M, K) times a quantized weight
// (K, F) for the calls with more rows than the decode templates take (8 < M
// <= 160: the split prompt pass's B * 32 = 128 text rows), on the tensor
// cores. Shared by the int4 matmul (B5, weight-only and W4A8;
// int4_matmul.cu, namespace rows) and the int8 matmul (B2; int8_matmul.cu,
// namespace rows). This header holds what the two share: the tile walk, the
// cp.async ring, the staging of x, the split-K reduction and the epilogue.
// Each source gives only its weight mode (a "Mode" class): how a stage's
// weight bytes are copied, how they become A fragments, and how a group of
// k is folded with its scale.
//
// What bounds it on this card: at M = 128 on 4096 -> 11008 the weights are
// 22.5 MB (int4) or 45 MB (int8) from device memory, 6.7 or 13.5 us at
// 3.35 TB/s, and the 11.5 GFLOP take 6 us at the int8 and 12 us at the
// bf16 dense peak. The chunked template before it ran its products as
// fp32 FFMA and re-read (and re-unpacked) every weight byte once per 16
// rows; here each weight is read and converted once per 128 rows.
//
// Orientation, as in the decode templates: the weights are the A operand
// (A rows are output columns, A columns are k) and x is the B operand (the
// n8 tiles are rows of x), so each A fragment a warp converts serves all
// NJ n8 tiles of the warp's rows.
//
// * A block of 8 warps takes a tile of TILE_F = 128 output columns x TILE_M
//   = 128 rows of x; warp w covers the 32 columns 32 (w % 4) .. + 31 (two
//   m16 tiles, the column pairs p of the decode templates) and the 64 rows
//   64 (w / 4) .. + 63 (NJ = 8 n8 tiles). M in 129 .. 160 takes a second
//   row tile. Warps wholly past M skip the stage; n8 tiles past M multiply
//   the zero rows of x, so a unit's products are straight-line code (a
//   branch around each tile cost 12-15% at M = 128 on an H100:
//   tools/rows_variants.py, variant skip).
// * K walks in stages of KT = 128 k (one group at G = 128): a stage is the
//   weights' KT k rows of the tile's 128 columns, x's 128 rows over those
//   k, and the mode's aux rows (the group scales; W4A8 also the rows' group
//   sums of xq), copied with 16-byte cp.async.cg into a ring of NS = 3
//   slots in shared memory, NS - 1 stages in flight while one is used. The
//   ring runs on across the block's tiles, so the next tile's first stages
//   load during this tile's last stage and its reduction. Rows past M,
//   columns past F and k past K are zero-filled by the copies.
// * Every 16-byte chunk of a staged row goes to a swizzled place (chunk ^
//   a function of the row), so that the lanes' 4-, 8- and 16-byte fragment
//   loads take distinct banks.
// * K is split over the KS blocks of a cluster (KS = 2, 4 or 8, cluster
//   dims (1, KS, 1)) in whole stages; the launch picks KS from the tile
//   count and the clusters that fit on the card, and the clusters are
//   persistent over tiles (splitk::launch_persistent). At a tile's end warp
//   w of each rank sends its fp32 sums (8 KB) into the receive buffer of
//   rank w % KS over distributed shared memory, and after one cluster
//   barrier that rank adds the KS partials in rank order, multiplies by
//   the mode's row scale and column scale and writes bf16: one launch, no
//   workspace for the sums, no atomics, a fixed order, so results repeat
//   bit for bit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace rowsmma {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int WARPS = 8;
constexpr int CWARPS = 4;                  // warps along a tile's columns
constexpr int TILE_F = 128;                // output columns a block: CWARPS x 32
constexpr int WROWS = 64;                  // rows of x a warp
constexpr int TILE_M = WROWS * WARPS / CWARPS;   // rows of x a block: 128
constexpr int NJ = WROWS / 8;              // n8 tiles a warp
constexpr int KT = 128;                    // k of a stage
constexpr int UNIT_K = 32;                 // k of a unit: one m16n8k32, or two m16n8k16
constexpr int UNITS = KT / UNIT_K;         // units a stage
constexpr int NS = 3;                      // slots of the cp.async ring
constexpr int REGION = 2 * NJ * 32 * 16;   // bytes of a warp's sums: 2 x NJ float4 a lane
constexpr int X16_ROW = KT * 2;            // bytes of a staged bf16 x row
constexpr int ROW = 128;                   // bytes of a staged weight row and int8 x row

static_assert(TILE_F == CWARPS * 32 && TILE_M == 128 && KT % UNIT_K == 0,
              "a warp takes two m16 tiles of columns and NJ n8 tiles of rows");

// Offsets in a staged region of ROW-byte rows: 16-byte chunk c of row r
// goes to chunk c ^ (2 ((r >> sh) & 3)). With sh chosen so that the four
// threads t of an mma group read four rows whose (r >> sh) & 3 is t (or
// four rows of x, r & 3 = g & 3), their 32-byte spans take the four
// distinct 32-byte bank groups of a 128-byte line.
__host__ __device__ constexpr int swz(int r, int c, int sh) {
  return r * ROW + ((c ^ (((r >> sh) & 3) << 1)) << 4);
}
// A staged bf16 x row (X16_ROW bytes): chunk c of row r goes to chunk
// c ^ (4 (r & 1)), so the 16-byte loads of a quarter warp (rows g, g + 1)
// take the two 64-byte halves of a line.
__host__ __device__ constexpr int swz16(int r, int c) {
  return r * X16_ROW + ((c ^ ((r & 1) << 2)) << 4);
}

template <class Mode>
__host__ __device__ constexpr int x_bytes() {
  return TILE_M * KT * (Mode::X8 ? 1 : 2);
}
template <class Mode>
__host__ __device__ constexpr int stage_bytes() {
  return Mode::W_BYTES + x_bytes<Mode>() + Mode::AUX_BYTES;
}
// Dynamic shared memory: NS stage slots, then the receive buffers of the
// cluster reduction: for each of the WARPS / KS warp regions this rank
// finishes, one REGION from each other rank.
template <int KS>
__host__ __device__ constexpr int recv_bytes() {
  return WARPS / KS * (KS - 1) * REGION;
}
template <class Mode, int KS>
__host__ __device__ constexpr int smem_bytes() {
  return NS * stage_bytes<Mode>() + recv_bytes<KS>();
}

struct Lane {
  int lane, g, t;   // lane = 4 g + t: mma group, thread in it
  int cw, rw;       // the warp's 32 columns and 64 rows of the tile
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d += a b on the tensor cores, bf16 operands, fp32 sums: a m16n8k16 tile,
// A row-major (16 x 16), B column-major (16 x 8).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b on the tensor cores, u8 A, s8 B, s32 sums: a m16n8k32 tile, A
// row-major (16 x 32), B column-major (32 x 8).
__device__ __forceinline__ void mma_u8s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Rows r0 .. r0 + NROWS - 1 of a (rows, F) byte matrix (row stride ld), its
// columns f0 .. f0 + 127, into dst (NROWS x ROW bytes, swizzled by sh);
// rows >= rmax and columns >= F are zero. F % 16 == 0, so a chunk is whole.
template <int NROWS, int SH>
__device__ __forceinline__ void stage_bytes_of(unsigned char* dst, const int8_t* src, long long ld,
                                               int r0, int rmax, int f0, int F, int tid) {
#pragma unroll
  for (int i = tid; i < NROWS * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    const bool ok = r0 + r < rmax && f0 + 16 * c < F;
    cp_async16(dst + swz(r, c, SH), ok ? src + (long long)(r0 + r) * ld + f0 + 16 * c : src,
               ok ? 16 : 0);
  }
}

// x's rows m0 .. m0 + 127 at k kbase .. kbase + KT - 1: bf16 (16 chunks of 8
// k a row) or, X8, the int8 rows of the W4A8 workspace (8 chunks of 16 k);
// rows >= M and k >= K are zero.
template <bool X8, class T>
__device__ __forceinline__ void stage_x(unsigned char* dst, const T* x, long long ldx, int M, int K,
                                        int m0, int kbase, int tid) {
  constexpr int CPR = X8 ? 8 : 16;   // chunks a row
  constexpr int EPC = 16 / sizeof(T);  // elements a chunk
#pragma unroll
  for (int i = tid; i < TILE_M * CPR; i += THREADS) {
    const int m = i / CPR, c = i % CPR, k = kbase + EPC * c;
    const bool ok = m0 + m < M && k < K;
    cp_async16(dst + (X8 ? swz(m, c, 0) : swz16(m, c)),
               ok ? x + (long long)(m0 + m) * ldx + k : x, ok ? 16 : 0);
  }
}

// The lane's weight words of a unit: byte (or k) row `row` of the stage,
// the 4 columns 4 g .. 4 g + 3 of the warp's 32, in a region staged with
// swizzle sh where (row >> sh) & 3 == t.
template <int SH>
__device__ __forceinline__ const unsigned char* w_lane(const unsigned char* w, const Lane& L) {
  return w + ((((2 * L.cw + (L.g >> 2)) ^ (L.t << 1))) << 4) + 4 * (L.g & 3) + (L.t << SH) * ROW;
}

// The tile's sums, this warp's region (columns 32 cw + 4 g + 2 p + {0, 1},
// rows 64 rw + 8 j + 2 t + {0, 1}: the mma C fragment), times the mode's
// row and column scales, as bf16; rows >= M and columns >= F not written.
template <class Mode>
__device__ __forceinline__ void store(const typename Mode::Args& a, const float (&v)[2][NJ][4],
                                      const Lane& L, int f0, int m0, int nj) {
  const int fb = f0 + 32 * L.cw + 4 * L.g;
  if (fb >= a.F) return;   // F % 16 == 0: the lane's 4 columns are all in or all out
  float cs[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) cs[c] = Mode::col_scale(a, fb + c);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) break;
    const int m = m0 + WROWS * L.rw + 8 * j + 2 * L.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m + h >= a.M) break;
      const float rs = Mode::row_scale(a, m + h);
      __nv_bfloat16* o = a.out + (long long)(m + h) * a.ldo + fb;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        o[2 * p] = __float2bfloat16(v[p][j][h] * rs * cs[2 * p]);
        o[2 * p + 1] = __float2bfloat16(v[p][j][2 + h] * rs * cs[2 * p + 1]);
      }
    }
  }
}

// The receive buffer (in REGIONs) of rank `fin` that holds rank q's sums of
// region li, one of the regions fin finishes (q != fin).
__device__ __forceinline__ int recv_slot(int KS, int li, int q, int fin) {
  return li * (KS - 1) + (q < fin ? q : q - 1);
}

// The tile's end: the K slices meet in rank order, then the epilogue.
// Warp w's region is finished by rank w % KS; the other ranks send theirs.
template <class Mode, int KS>
__device__ __forceinline__ void finish_tile(const typename Mode::Args& a, float (&acc)[2][NJ][4],
                                            float4* recv, cg::cluster_group& cluster, int rank,
                                            int warp, const Lane& L, int f0, int m0, int nj,
                                            bool more) {
  const int fin = warp % KS, li = warp / KS;
  cluster_wait();   // every receive buffer is free: the last tile's sums were read
  if (nj > 0 && fin != rank) {
    float4* dst = cluster.map_shared_rank(recv, fin) + recv_slot(KS, li, rank, fin) * (REGION / 16);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dst[(p * NJ + j) * 32 + L.lane] = make_float4(acc[p][j][0], acc[p][j][1], acc[p][j][2],
                                                      acc[p][j][3]);
  }
  cluster_arrive();
  cluster_wait();   // every rank's sums are in place
  if (nj > 0 && fin == rank) {
    float s[2][NJ][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[p][j][c] = 0.f;
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const float4* src = recv + recv_slot(KS, li, q, rank) * (REGION / 16);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 v = q == rank ? make_float4(acc[p][j][0], acc[p][j][1], acc[p][j][2],
                                                   acc[p][j][3])
                                     : src[(p * NJ + j) * 32 + L.lane];
          s[p][j][0] += v.x;
          s[p][j][1] += v.y;
          s[p][j][2] += v.z;
          s[p][j][3] += v.w;
        }
    }
    store<Mode>(a, s, L, f0, m0, nj);
  }
  if (more) cluster_arrive();   // this rank's receive buffers may be written again
}

// The template's kernel. Each cluster walks over the tiles blockIdx.x,
// + gridDim.x, ... (tile = column tile + row tile x column tiles); rank r
// of the cluster takes the stages S r / KS .. S (r + 1) / KS - 1 of K
// (S = ceil(K / KT) >= KS, so each takes at least one). The block's
// (tile, stage) items stream through the ring: at item it the block waits
// for its copies, issues item it + NS - 1 into the slot item it - 1 left,
// and runs item it.
template <class Mode, int KS>
__global__ void __cluster_dims__(1, KS, 1) __launch_bounds__(THREADS, 1)
    rows_kernel(const typename Mode::Args a) {
  constexpr int STAGE = stage_bytes<Mode>();
  constexpr int XOFF = Mode::W_BYTES, AOFF = Mode::W_BYTES + x_bytes<Mode>();
  extern __shared__ __align__(128) unsigned char smem[];
  float4* recv = reinterpret_cast<float4*>(smem + NS * STAGE);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32;
  Lane L;
  L.lane = tid % 32;
  L.g = L.lane / 4;
  L.t = L.lane % 4;
  L.cw = warp % CWARPS;
  L.rw = warp / CWARPS;
  const int S = (a.K + KT - 1) / KT;
  const int s0 = S * rank / KS, ns = S * (rank + 1) / KS - s0;
  const int kend = min(a.K, KT * (s0 + ns));   // this rank's last k + 1
  const int nft = (a.F + TILE_F - 1) / TILE_F;
  const int ntiles = nft * ((a.M + TILE_M - 1) / TILE_M);
  const int total = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * ns;

  auto tile_of = [&](int it, int& f0, int& m0) {
    const int tile = (int)blockIdx.x + it / ns * (int)gridDim.x;
    f0 = tile % nft * TILE_F;
    m0 = tile / nft * TILE_M;
  };
  auto issue = [&](int it) {
    if (it < total) {
      int f0, m0;
      tile_of(it, f0, m0);
      const int kbase = KT * (s0 + it % ns);
      unsigned char* slot = smem + it % NS * STAGE;
      Mode::load(a, slot, slot + AOFF, f0, m0, kbase, tid);
      if constexpr (Mode::X8)
        stage_x<true>(slot + XOFF, a.xq, a.K, a.M, a.K, m0, kbase, tid);
      else
        stage_x<false>(slot + XOFF, a.x, a.ldx, a.M, a.K, m0, kbase, tid);
    }
    cp_commit();   // one group an item, empty past the last
  };

  cluster_arrive();   // this block has started: the others may write into it
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);

  float acc[2][NJ][4];
  typename Mode::Part part;
  Mode::zero(part);
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][j][c] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_wait<NS - 2>();
    __syncthreads();   // item it is in place, and item it - 1's slot is free
    issue(it + NS - 1);
    int f0, m0;
    tile_of(it, f0, m0);
    const int ks = it % ns, kbase = KT * (s0 + ks);
    const int nj = max(0, min(NJ, (a.M - m0 - WROWS * L.rw + 7) / 8));   // live n8 tiles
    const unsigned char* slot = smem + it % NS * STAGE;
    if (nj > 0) Mode::stage(a, part, acc, slot, slot + XOFF, slot + AOFF, L, kbase, kend, nj);
    if (ks == ns - 1) {
      finish_tile<Mode, KS>(a, acc, recv, cluster, rank, warp, L, f0, m0, nj, it + 1 < total);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[p][j][c] = 0.f;
    }
  }
  // No block reads or writes another's shared memory after its last
  // tile's second cluster barrier, so a block may leave.
}

// The split of K for M rows of x, K and F: KS in {2, 4, 8} with at most S
// = ceil(K / KT) ranks, the one that gives the fewest stages a block runs
// in all (rounds of the resident clusters over the tiles, times the
// stages of a rank's slice), the smaller on a tie; and the clusters of
// that KS resident on the card at once (the launch's grid, at most one a
// tile).
template <class Mode, int KS>
cudaError_t split_cost(int tiles, int S, long long* cost, int* clusters) {
  const cudaError_t e =
      splitk::resident_clusters<&rows_kernel<Mode, KS>, KS, THREADS, smem_bytes<Mode, KS>()>(
          smem_bytes<Mode, KS>(), clusters);
  if (e == cudaSuccess) *cost = (long long)((tiles + *clusters - 1) / *clusters) * ((S + KS - 1) / KS);
  return e;
}

template <class Mode>
cudaError_t split(int M, int K, int F, int* ks, int* clusters) {
  const int tiles = (F + TILE_F - 1) / TILE_F * ((M + TILE_M - 1) / TILE_M);
  const int S = (K + KT - 1) / KT;
  long long best = 0, cost = 0;
  int n = 0;
  cudaError_t e = split_cost<Mode, 2>(tiles, S, &best, clusters);
  *ks = 2;
  if (e == cudaSuccess && S >= 4 && (e = split_cost<Mode, 4>(tiles, S, &cost, &n)) == cudaSuccess &&
      cost < best) {
    best = cost;
    *ks = 4;
    *clusters = n;
  }
  if (e == cudaSuccess && S >= 8 && (e = split_cost<Mode, 8>(tiles, S, &cost, &n)) == cudaSuccess &&
      cost < best) {
    *ks = 8;
    *clusters = n;
  }
  return e;
}

template <class Mode>
cudaError_t launch(const typename Mode::Args& a, cudaStream_t stream) {
  const int tiles = (a.F + TILE_F - 1) / TILE_F * ((a.M + TILE_M - 1) / TILE_M);
  int ks = 0, n = 0;
  const cudaError_t e = split<Mode>(a.M, a.K, a.F, &ks, &n);
  if (e != cudaSuccess) return e;
  if (ks == 8)
    return splitk::launch_persistent<&rows_kernel<Mode, 8>, 8, THREADS, smem_bytes<Mode, 8>()>(
        a, tiles, smem_bytes<Mode, 8>(), stream);
  if (ks == 4)
    return splitk::launch_persistent<&rows_kernel<Mode, 4>, 4, THREADS, smem_bytes<Mode, 4>()>(
        a, tiles, smem_bytes<Mode, 4>(), stream);
  return splitk::launch_persistent<&rows_kernel<Mode, 2>, 2, THREADS, smem_bytes<Mode, 2>()>(
      a, tiles, smem_bytes<Mode, 2>(), stream);
}

}  // namespace rowsmma
