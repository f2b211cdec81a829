// Bridged flash attention, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// libra_tpu/ops/pallas/flash_bridge.py::_bwd_impl (body _bwd_kernel). With
// the forward's notation (flash_bridge.cu), cross[q,k] = flag_q != flag_kv,
// the forward's row max m and denominator l, and the output cotangent dO:
//
//   p[q,k]  = exp(s[q,k] - m[q]) / l[q]               (s recomputed, clamped)
//   delta[q] = sum_c dO[q,c] * O[q,c]
//   dp[q,k] = dO[q] . V[k] + cross[q,k] * dO[q] . Vb[k]
//   ds[q,k] = p[q,k] * (dp[q,k] - delta[q]),  0 on a fully masked row
//   dQ  = scale * sum_k ds (K + cross Kb)       dK  = scale * sum_q ds Q
//   dKb = scale * sum_q ds cross Q              dV  = sum_q p dO
//   dVb = sum_q p cross dO
//
// with p, p cross, ds and ds cross rounded to bf16 before the gradient
// products, as the TPU kernel does (flash_bridge.py:228-233). A fully
// masked row (m == BIG_NEG: every score clamped) gets ds = 0, so its dq is
// exactly zero, while its uniform probabilities still feed dV and dVb, as
// in the TPU kernel (flash_bridge.py:218-226). No bias cotangent: the bias
// is mask-derived everywhere, and its gradient is zero by contract.
//
// What bounds it on this card: at the training shape (B=8, H=32,
// Nq=Nk=698, d=128, bridge) the function needs 10 products, 2*B*H*Nq*Nk*d*10
// = 319 GFLOP over every pair (0.32 ms at 989 TFLOP/s), about half of them
// on live pairs under the causal mask; the 0.57 GB it must move (operands,
// the 62 MB fp32 bias plane, the gradients) takes about as long (0.17 ms at
// 3.35 TB/s). This kernel recomputes the four score products in both the dq and
// the dk/dv pass, 14 products in all, and skips the (query, key) tiles
// whose terms are all exactly zero (below). Its dk/dv kernel holds 255
// registers a thread (128 of them accumulators), one block of 8 warps an
// SM, so latency, not the tensor cores' rate, sets its time.
//
// Design: the TPU kernel accumulated dK/dV across query blocks in an output
// block that its sequential grid revisited. GPU blocks run in no order, so
// the backward is three launches, none with atomics, each deterministic:
//   1. a row pass: delta = rowsum(dO * O) in fp32, one warp a row;
//   2. dq, query-tile-major: one block per (64 query rows, head, batch),
//      4 warps of 16 rows, streams key tiles of 32 (K, V, Kb, Vb) through a
//      2-stage cp.async ring. Per tile each warp does S = Q K^T, Sb = Q Kb^T,
//      dP = dO V^T and dPb = dO Vb^T on the tensor cores (mma.sync
//      m16n8k16 bf16, fp32 sums; Q and dO fragments by ldmatrix), forms p
//      from the saved m and l and ds in fp32, packs ds and ds cross to bf16
//      in registers and accumulates dq += ds K + (ds cross) Kb in fp32
//      registers (K, Kb as the B operand through ldmatrix.trans);
//   3. dk/dv/dkb/dvb, key-tile-major: one block per (64 keys, head, batch),
//      8 warps, streams query tiles of 64 (Q, dO) through a 2-stage ring.
//      The four fp32 (64 x 128) accumulators are 256 registers a thread for
//      16 keys a warp, over the limit, so each pair of warps shares 16 keys
//      and splits the 128 gradient columns in halves (128 accumulator
//      registers a thread). The pair first splits the query tile to compute
//      the transposed score tiles once (S^T = K Q^T and the other three, so
//      that keys are the rows), and stages bf16 P^T, (P cross)^T, dS^T and
//      (dS cross)^T in shared memory (32 KB); then each warp accumulates
//      dV += P^T dO, dVb += (P cross)^T dO, dK += dS^T Q, dKb += (dS cross)^T Q
//      over the whole tile for its half of the columns.
// Exact skipping (SKIP_BIAS, SKIP_MAX in flash_mma.cuh): a (16 rows, tile)
// piece is skipped where every bias entry is <= BIG_NEG / 2 and every query
// row's final max is >= BIG_NEG / 4, so that p and ds are exactly 0 there.
// In the dq pass a fully masked row (ds = 0) never blocks a skip; in the
// dk/dv pass it always does (its p = 1/l feeds dV). Operands are read in
// their (B, N, H, d) layout through strides (16-byte aligned, checked by the
// wrapper), the bias with 4-byte loads; ragged query and key tails are
// zero-filled by the copies and masked in the kernels; dq is written in q's
// dtype, the key-side gradients in k's (bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using namespace fmma;
using T = __nv_bfloat16;

constexpr int D = 128;            // head dim (libra-11b's)
constexpr int ROW = D * 2;        // bytes of an operand row
constexpr int DELTA_THREADS = 256;
constexpr int BQ = 64;            // dq pass: query rows per block
constexpr int BK = 32;            // dq pass: keys per tile
constexpr int DQ_THREADS = 32 * (BQ / 16);
constexpr int BKV = 64;           // dk/dv pass: keys per block
constexpr int BQ2 = 64;           // dk/dv pass: query rows per tile
constexpr int DKV_THREADS = 32 * 2 * (BKV / 16);
constexpr int PTILE = BKV * BQ2 * 2;   // bytes of one staged bf16 (keys, queries) tile

// Element strides of a (B, N, H, d) operand; d has unit stride.
struct Strides {
  long long b, n, h;
};

struct Args {
  const void *q, *k, *v, *kb, *vb, *o, *dout;
  const uint8_t* flag_q;   // (B, Nq) contiguous, 0/1
  const uint8_t* flag_kv;  // (B, Nk) contiguous, 0/1
  const float* bias;       // (B, 1, Nq, Nk), key stride 1
  const float* row_max;    // (B, H, Nq) from the forward
  const float* row_sum;    // (B, H, Nq) from the forward
  float* delta;            // (B, H, Nq) scratch
  void *dq, *dk, *dv, *dkb, *dvb;   // contiguous (B, N, H, d)
  Strides sq, sk, sv, skb, svb, so, sdo;
  long long bias_b, bias_q;
  int B, Nq, Nk, H;
  float scale;
};

__device__ __forceinline__ const T* head(const void* base, const Strides& s, int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

__device__ __forceinline__ void store2(T* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 1. delta[b, h, q] = sum_c dO[b, q, h, c] * O[b, q, h, c]; one warp a row.
__global__ void __launch_bounds__(DELTA_THREADS) delta_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Nq * a.H) return;   // whole warps leave together
  const int h = (int)(row % a.H);
  const int qi = (int)((row / a.H) % a.Nq);
  const int b = (int)(row / ((long long)a.H * a.Nq));
  const T* o = head(a.o, a.so, b, h) + qi * a.so.n;
  const T* d = head(a.dout, a.sdo, b, h) + qi * a.sdo.n;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s = fmaf(__bfloat162float(d[c]), __bfloat162float(o[c]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[((long long)b * a.H + h) * a.Nq + qi] = s;
}

template <bool BRIDGE>
constexpr int dq_smem_bytes() {
  return 2 * BQ * ROW + 2 * (BRIDGE ? 4 : 2) * BK * ROW;
}

// 2. dq. Warp w owns query rows 16w..16w+15 of the block; lane (g, t) holds
//    rows g, g + 8 and, of each 8-key n-block j, keys 8j + 2t, 8j + 2t + 1.
template <bool BRIDGE>
__global__ void __launch_bounds__(DQ_THREADS) dq_kernel(const Args a) {
  constexpr int NOPS = BRIDGE ? 4 : 2;   // K, V (, Kb, Vb) in a stage
  constexpr int KT = BK * ROW;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const uint32_t sQ = smem_addr(smem), sDO = sQ + BQ * ROW, s_kv = sDO + BQ * ROW;

  const T* ops[4] = {head(a.k, a.sk, b, h), head(a.v, a.sv, b, h),
                     BRIDGE ? head(a.kb, a.skb, b, h) : nullptr,
                     BRIDGE ? head(a.vb, a.svb, b, h) : nullptr};
  const long long lds[4] = {a.sk.n, a.sv.n, a.skb.n, a.svb.n};
  const uint8_t* flag_kv = a.flag_kv + (long long)b * a.Nk;

  auto load_keys = [&](int stage, int k0) {
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
      load_tile<BK, DQ_THREADS>(s_kv + (stage * NOPS + o) * KT, ops[o], lds[o], k0, a.Nk,
                                tid);
  };
  load_tile<BQ, DQ_THREADS>(sQ, head(a.q, a.sq, b, h), a.sq.n, q0, a.Nq, tid);
  load_tile<BQ, DQ_THREADS>(sDO, head(a.dout, a.sdo, b, h), a.sdo.n, q0, a.Nq, tid);
  load_keys(0, 0);
  cp_commit();

  bool rvalid[2], live[2];
  uint8_t rflag[2];
  const float* brow[2];
  float m[2], l[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * warp + g + 8 * i;
    rvalid[i] = qi < a.Nq;
    const long long st = ((long long)b * a.H + h) * a.Nq + (rvalid[i] ? qi : 0);
    m[i] = a.row_max[st];
    l[i] = a.row_sum[st];
    dl[i] = a.delta[st];
    live[i] = rvalid[i] && m[i] > BIG_NEG;   // a fully masked row: ds = 0
    rflag[i] = rvalid[i] ? a.flag_q[(long long)b * a.Nq + qi] : 0;
    brow[i] = a.bias + b * a.bias_b + (rvalid[i] ? qi : 0) * a.bias_q;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  const int ntiles = (a.Nk + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_wait<0>();
    __syncthreads();   // tile `it` has landed; tile it - 1 is fully consumed
    if (it + 1 < ntiles) load_keys((it + 1) & 1, k0 + BK);
    cp_commit();
    const uint32_t sK = s_kv + (it & 1) * NOPS * KT;
    const uint32_t sV = sK + KT, sKb = sK + 2 * KT, sVb = sK + 3 * KT;

    // bias of (row g + 8i, key k0 + 8j + 2t + e) at [4j + 2i + e]; the warp
    // skips the tile when every ds of its rows there is exactly 0
    float bias[4 * (BK / 8)];
    bool skip = true;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, kj = k0 + 8 * j + 2 * t + (c & 1);
        const float bv = kj < a.Nk ? __ldg(brow[i] + kj) : -INFINITY;
        bias[4 * j + c] = bv;
        skip &= !live[i] || (m[i] >= SKIP_MAX && bv <= SKIP_BIAS);
      }
    if (__all_sync(0xffffffffu, skip)) continue;

    float s[BK / 8][4], sb[BK / 8][4], dp[BK / 8][4], dpb[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = sb[j][c] = dp[j][c] = dpb[j][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ado[4];
      load_a<16>(aq, sQ, 16 * warp, kc, lane);
      load_a<16>(ado, sDO, 16 * warp, kc, lane);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bm[4];
        load_b_nk<16>(bm, sK, 16 * np, kc, lane);
        mma16816(s[2 * np], aq, bm[0], bm[1]);
        mma16816(s[2 * np + 1], aq, bm[2], bm[3]);
        load_b_nk<16>(bm, sV, 16 * np, kc, lane);
        mma16816(dp[2 * np], ado, bm[0], bm[1]);
        mma16816(dp[2 * np + 1], ado, bm[2], bm[3]);
        if (BRIDGE) {
          load_b_nk<16>(bm, sKb, 16 * np, kc, lane);
          mma16816(sb[2 * np], aq, bm[0], bm[1]);
          mma16816(sb[2 * np + 1], aq, bm[2], bm[3]);
          load_b_nk<16>(bm, sVb, 16 * np, kc, lane);
          mma16816(dpb[2 * np], ado, bm[0], bm[1]);
          mma16816(dpb[2 * np + 1], ado, bm[2], bm[3]);
        }
      }
    }

    // ds (in s) and ds cross (in sb), fp32
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, kj = k0 + 8 * j + 2 * t + (c & 1);
        const bool cx = BRIDGE && kj < a.Nk && flag_kv[kj] != rflag[i];
        float ds = 0.f;
        if (live[i] && kj < a.Nk) {
          float x = s[j][c] * a.scale;
          if (cx) x += sb[j][c] * a.scale;
          x = fmaxf(x + bias[4 * j + c], BIG_NEG);
          const float p = expf(x - m[i]) / l[i];
          const float dpt = cx ? dp[j][c] + dpb[j][c] : dp[j][c];
          ds = p * (dpt - dl[i]);
        }
        s[j][c] = ds;
        sb[j][c] = cx ? ds : 0.f;
      }

    // dq += bf16(ds) K + bf16(ds cross) Kb, 16 keys at a time
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t da[4], dxa[4];
      pack_a(da, s[2 * kc], s[2 * kc + 1]);
      if (BRIDGE) pack_a(dxa, sb[2 * kc], sb[2 * kc + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bm[4];
        load_b_kn<16>(bm, sK, 16 * kc, 16 * np, lane);
        mma16816(acc[2 * np], da, bm[0], bm[1]);
        mma16816(acc[2 * np + 1], da, bm[2], bm[3]);
        if (BRIDGE) {
          load_b_kn<16>(bm, sKb, 16 * kc, 16 * np, lane);
          mma16816(acc[2 * np], dxa, bm[0], bm[1]);
          mma16816(acc[2 * np + 1], dxa, bm[2], bm[3]);
        }
      }
    }
  }
  cp_wait<0>();

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int qi = q0 + 16 * warp + g + 8 * i;
    T* row = dq + (((long long)b * a.Nq + qi) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(row + 8 * n + 2 * t, acc[n][2 * i] * a.scale, acc[n][2 * i + 1] * a.scale);
  }
}

template <bool BRIDGE>
constexpr int dkv_smem_bytes() {
  return (BRIDGE ? 4 : 2) * BKV * ROW     // K, V (+ Kb, Vb) of the block's keys
         + 2 * 2 * BQ2 * ROW              // Q, dO tiles, two stages
         + (BRIDGE ? 4 : 2) * PTILE;      // staged P^T, dS^T (+ the cross ones)
}

// 3. dk/dv/dkb/dvb. Warp w = 2 kg + hf owns keys 16 kg..16 kg + 15 of the
//    block. Score phase: it computes those keys against queries
//    32 hf..32 hf + 31 of the tile, 16 at a time (lane (g, t) holds keys g,
//    g + 8 and queries 8j + 2t, 8j + 2t + 1); sum phase: it accumulates
//    gradient columns 64 hf..64 hf + 63 over all 64 queries of the tile.
template <bool BRIDGE>
__global__ void __launch_bounds__(DKV_THREADS, 1) dkv_kernel(const Args a) {
  constexpr int NOPS = BRIDGE ? 4 : 2;
  constexpr int KT = BKV * ROW;
  constexpr int QT = BQ2 * ROW;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int skipped[BKV / 16][BQ2 / 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp >> 1, hf = warp & 1;
  const int k0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const uint32_t sK = smem_addr(smem), sV = sK + KT, sKb = sK + 2 * KT, sVb = sK + 3 * KT;
  const uint32_t s_qdo = sK + NOPS * KT;   // stage s: Q at + 2 s QT, dO at + (2 s + 1) QT
  const uint32_t sP = s_qdo + 4 * QT, sDS = sP + PTILE, sPX = sP + 2 * PTILE,
                 sDSX = sP + 3 * PTILE;
  uint8_t* const gP = smem + (sP - sK);   // the same tiles through generic pointers

  const T* q = head(a.q, a.sq, b, h);
  const T* dout = head(a.dout, a.sdo, b, h);
  const uint8_t* flag_q = a.flag_q + (long long)b * a.Nq;
  const float* bias = a.bias + b * a.bias_b;
  const long long st0 = ((long long)b * a.H + h) * a.Nq;

  load_tile<BKV, DKV_THREADS>(sK, head(a.k, a.sk, b, h), a.sk.n, k0, a.Nk, tid);
  load_tile<BKV, DKV_THREADS>(sV, head(a.v, a.sv, b, h), a.sv.n, k0, a.Nk, tid);
  if (BRIDGE) {
    load_tile<BKV, DKV_THREADS>(sKb, head(a.kb, a.skb, b, h), a.skb.n, k0, a.Nk, tid);
    load_tile<BKV, DKV_THREADS>(sVb, head(a.vb, a.svb, b, h), a.svb.n, k0, a.Nk, tid);
  }
  auto load_queries = [&](int stage, int q0) {
    load_tile<BQ2, DKV_THREADS>(s_qdo + 2 * stage * QT, q, a.sq.n, q0, a.Nq, tid);
    load_tile<BQ2, DKV_THREADS>(s_qdo + (2 * stage + 1) * QT, dout, a.sdo.n, q0, a.Nq, tid);
  };
  load_queries(0, 0);
  cp_commit();

  // this lane's keys in the score phase: rows g, g + 8 of the warp's 16
  int kj[2];
  bool kok[2];
  uint8_t kflag[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kj[i] = k0 + 16 * kg + g + 8 * i;
    kok[i] = kj[i] < a.Nk;
    kflag[i] = kok[i] ? a.flag_kv[(long long)b * a.Nk + kj[i]] : 0;
  }
  float dk[8][4], dv[8][4], dkb[8][4], dvb[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[n][c] = dv[n][c] = dkb[n][c] = dvb[n][c] = 0.f;

  const int ntiles = (a.Nq + BQ2 - 1) / BQ2;
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = it * BQ2;
    cp_wait<0>();
    __syncthreads();   // tile `it` has landed; tile it - 1 is fully consumed
    if (it + 1 < ntiles) load_queries((it + 1) & 1, q0 + BQ2);
    cp_commit();
    const uint32_t sQ = s_qdo + 2 * (it & 1) * QT, sDO = sQ + QT;

    // score phase: 16 keys x 16 queries at a time, queries 32 hf + 16 sp ..
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {
      const int qb = 32 * hf + 16 * sp;   // within the tile
      // the four queries of this lane: qb + 8j + 2t + e at [2j + e]
      float mq[4], lq[4], dq_[4], bv[2][4];
      uint8_t fq[4];
      bool qok[4], skip = true;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int qi = q0 + qb + 8 * (x >> 1) + 2 * t + (x & 1);
        qok[x] = qi < a.Nq;
        const int qc = qok[x] ? qi : 0;
        mq[x] = a.row_max[st0 + qc];
        lq[x] = a.row_sum[st0 + qc];
        dq_[x] = a.delta[st0 + qc];
        fq[x] = flag_q[qc];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bv[i][x] = kok[i] ? __ldg(bias + qc * a.bias_q + kj[i]) : 0.f;
          skip &= !qok[x] || !kok[i] || (mq[x] >= SKIP_MAX && bv[i][x] <= SKIP_BIAS);
        }
      }
      const bool skip_all = __all_sync(0xffffffffu, skip);
      if (lane == 0) skipped[kg][2 * hf + sp] = skip_all;
      if (skip_all) continue;

      float s[2][4], sb[2][4], dp[2][4], dpb[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = sb[j][c] = dp[j][c] = dpb[j][c] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ak[4], bq[4], bdo[4];
        load_b_nk<16>(bq, sQ, qb, kc, lane);
        load_b_nk<16>(bdo, sDO, qb, kc, lane);
        load_a<16>(ak, sK, 16 * kg, kc, lane);
        mma16816(s[0], ak, bq[0], bq[1]);
        mma16816(s[1], ak, bq[2], bq[3]);
        load_a<16>(ak, sV, 16 * kg, kc, lane);
        mma16816(dp[0], ak, bdo[0], bdo[1]);
        mma16816(dp[1], ak, bdo[2], bdo[3]);
        if (BRIDGE) {
          load_a<16>(ak, sKb, 16 * kg, kc, lane);
          mma16816(sb[0], ak, bq[0], bq[1]);
          mma16816(sb[1], ak, bq[2], bq[3]);
          load_a<16>(ak, sVb, 16 * kg, kc, lane);
          mma16816(dpb[0], ak, bdo[0], bdo[1]);
          mma16816(dpb[1], ak, bdo[2], bdo[3]);
        }
      }

      // p and ds of (key row g + 8i, query 8j + 2t + e), element c = 2i + e
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4], px[4], ds[4], dsx[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1, x = 2 * j + (c & 1);
          const bool cross = BRIDGE && fq[x] != kflag[i];
          p[c] = ds[c] = 0.f;
          if (qok[x] && kok[i]) {
            float y = s[j][c] * a.scale;
            if (cross) y += sb[j][c] * a.scale;
            y = fmaxf(y + bv[i][x], BIG_NEG);
            p[c] = expf(y - mq[x]) / lq[x];
            if (mq[x] > BIG_NEG) {   // a fully masked row feeds dV, not dK
              const float dpt = cross ? dp[j][c] + dpb[j][c] : dp[j][c];
              ds[c] = p[c] * (dpt - dq_[x]);
            }
          }
          px[c] = cross ? p[c] : 0.f;
          dsx[c] = cross ? ds[c] : 0.f;
        }
        // staged tiles: row = key (16 kg + g + 8i), column = query
        const int col = qb + 8 * j + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t off = swz<BQ2 / 8>(16 * kg + g + 8 * i, col >> 3) + (col & 7) * 2;
          *reinterpret_cast<uint32_t*>(gP + off) = pack_bf16(p[2 * i], p[2 * i + 1]);
          *reinterpret_cast<uint32_t*>(gP + PTILE + off) = pack_bf16(ds[2 * i], ds[2 * i + 1]);
          if (BRIDGE) {
            *reinterpret_cast<uint32_t*>(gP + 2 * PTILE + off) =
                pack_bf16(px[2 * i], px[2 * i + 1]);
            *reinterpret_cast<uint32_t*>(gP + 3 * PTILE + off) =
                pack_bf16(dsx[2 * i], dsx[2 * i + 1]);
          }
        }
      }
    }
    __syncthreads();   // the pair's staged halves and skip flags are written

    // sum phase: this warp's 16 keys x columns 64 hf.., over the tile's queries
#pragma unroll
    for (int qc = 0; qc < BQ2 / 16; ++qc) {
      if (skipped[kg][qc]) continue;
      uint32_t ap[4], ads[4], apx[4], adsx[4];
      load_a<BQ2 / 8>(ap, sP, 16 * kg, qc, lane);
      load_a<BQ2 / 8>(ads, sDS, 16 * kg, qc, lane);
      if (BRIDGE) {
        load_a<BQ2 / 8>(apx, sPX, 16 * kg, qc, lane);
        load_a<BQ2 / 8>(adsx, sDSX, 16 * kg, qc, lane);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int n0 = 64 * hf + 16 * np;
        uint32_t bdo[4], bq[4];
        load_b_kn<16>(bdo, sDO, 16 * qc, n0, lane);
        load_b_kn<16>(bq, sQ, 16 * qc, n0, lane);
        mma16816(dv[2 * np], ap, bdo[0], bdo[1]);
        mma16816(dv[2 * np + 1], ap, bdo[2], bdo[3]);
        mma16816(dk[2 * np], ads, bq[0], bq[1]);
        mma16816(dk[2 * np + 1], ads, bq[2], bq[3]);
        if (BRIDGE) {
          mma16816(dvb[2 * np], apx, bdo[0], bdo[1]);
          mma16816(dvb[2 * np + 1], apx, bdo[2], bdo[3]);
          mma16816(dkb[2 * np], adsx, bq[0], bq[1]);
          mma16816(dkb[2 * np + 1], adsx, bq[2], bq[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // gradient rows: keys 16 kg + g + 8i, columns 64 hf + 8n + 2t
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * kg + g + 8 * i;
    if (key >= a.Nk) continue;
    const long long off = (((long long)b * a.Nk + key) * a.H + h) * D + 64 * hf + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(static_cast<T*>(a.dk) + off + 8 * n, dk[n][2 * i] * a.scale,
             dk[n][2 * i + 1] * a.scale);
      store2(static_cast<T*>(a.dv) + off + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
      if (BRIDGE) {
        store2(static_cast<T*>(a.dkb) + off + 8 * n, dkb[n][2 * i] * a.scale,
               dkb[n][2 * i + 1] * a.scale);
        store2(static_cast<T*>(a.dvb) + off + 8 * n, dvb[n][2 * i], dvb[n][2 * i + 1]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool BRIDGE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Nq * a.H;
  const int warps = DELTA_THREADS / 32;
  delta_kernel<<<(unsigned)((rows + warps - 1) / warps), DELTA_THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dq_smem = dq_smem_bytes<BRIDGE>();
  err = allow_smem(dq_kernel<BRIDGE>, dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<BRIDGE><<<dim3((a.Nq + BQ - 1) / BQ, a.H, a.B), DQ_THREADS, dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int dkv_smem = dkv_smem_bytes<BRIDGE>();
  err = allow_smem(dkv_kernel<BRIDGE>, dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<BRIDGE><<<dim3((a.Nk + BKV - 1) / BKV, a.H, a.B), DKV_THREADS, dkv_smem,
                       stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Operands are bfloat16 with head dim 128, 16-byte aligned with b/n/h
// strides that are multiples of 8 elements; the wrapper checks all three.
// kb/vb (and dkb/dvb) are null without the bridge. row_max/row_sum: the
// forward's fp32 (B, H, Nq) softmax stats; delta: an fp32 (B, H, Nq)
// scratch buffer.
// strides: 23 element strides, in order
//   q, k, v, kb, vb, o, dout (b, n, h each), bias (b, q).
// The gradients are written contiguous (B, N, H, d).
// Returns the CUDA error code of the launches (0 = launched).
extern "C" int flash_bridge_bwd(const void* q, const void* k, const void* v,
                                const void* kb, const void* vb, const void* o,
                                const void* dout, const void* flag_q,
                                const void* flag_kv, const void* bias,
                                const void* row_max, const void* row_sum,
                                void* delta, void* dq, void* dk, void* dv,
                                void* dkb, void* dvb, const long long* strides,
                                int B, int Nq, int Nk, int H, float scale,
                                void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kb = kb;
  a.vb = vb;
  a.o = o;
  a.dout = dout;
  a.flag_q = static_cast<const uint8_t*>(flag_q);
  a.flag_kv = static_cast<const uint8_t*>(flag_kv);
  a.bias = static_cast<const float*>(bias);
  a.row_max = static_cast<const float*>(row_max);
  a.row_sum = static_cast<const float*>(row_sum);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dkb = dkb;
  a.dvb = dvb;
  Strides* s[7] = {&a.sq, &a.sk, &a.sv, &a.skb, &a.svb, &a.so, &a.sdo};
  for (int i = 0; i < 7; ++i) {
    s[i]->b = strides[3 * i];
    s[i]->n = strides[3 * i + 1];
    s[i]->h = strides[3 * i + 2];
  }
  a.bias_b = strides[21];
  a.bias_q = strides[22];
  a.B = B;
  a.Nq = Nq;
  a.Nk = Nk;
  a.H = H;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kb != nullptr ? launch<true>(a, st) : launch<false>(a, st));
}
