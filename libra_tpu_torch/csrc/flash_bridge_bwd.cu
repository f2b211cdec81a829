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
// A fully masked row (m == BIG_NEG: every score clamped) gets ds = 0, so its
// dq is exactly zero, while its uniform probabilities still feed dV and dVb,
// as in the TPU kernel (flash_bridge.py:218-226). No bias cotangent: the
// bias is mask-derived everywhere, and its gradient is zero by contract.
//
// What bounds it on this card: at the training shape (B=8, H=32,
// Nq=Nk=698, d=128, bridge) the work is about 2*B*H*Nq*Nk*d*11 = 256 GFLOP
// (the TPU kernel's cost estimate; this kernel recomputes the four score
// products in both passes, 14 products in all) against ~0.2 GB of operands
// and a 62 MB fp32 bias plane, so arithmetic bounds it. This first version
// does that arithmetic as fp32 FMAs out of shared memory, with no tensor
// cores, like the forward.
//
// Design: the TPU kernel accumulated dK/dV across query blocks in an
// output block that its sequential grid revisited. GPU blocks run in no
// order, so the backward is three launches, none with atomics, each
// deterministic:
//   1. a row pass: delta = rowsum(dO * O) in fp32, one warp a row;
//   2. dq, query-tile-major: one block per (64 query rows, head, batch)
//      streams key tiles of 32, recomputes p from the saved m and l (no
//      second softmax pass), and keeps its rows' dq in registers;
//   3. dk/dv/dkb/dvb, key-tile-major: one block per (32 keys, head, batch)
//      streams query tiles of 32 and keeps its keys' four gradients in
//      registers (64 fp32 a thread).
// cross comes from the two flag vectors, bias is read through its strides,
// ragged query and key tails are masked in the kernels (no padding of Nq
// to a multiple of 128), and every sum is fp32; dq is written in q's dtype,
// the key-side gradients in k's (bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head dim (libra-11b's)
constexpr int DP = D + 1;       // padded shared-memory row
constexpr int CPT = D / 8;      // columns a thread owns: tx + 8 * c
constexpr int THREADS = 256;
constexpr int BQ = 64;          // dq pass: query rows per block
constexpr int BK = 32;          // dq pass: keys per tile; dkv pass: keys per block
constexpr int BQ2 = 32;         // dkv pass: query rows per tile
constexpr float BIG_NEG = -1073741824.0f;

using T = __nv_bfloat16;

__device__ __forceinline__ float to_f32(T x) { return __bfloat162float(x); }

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

// 1. delta[b, h, q] = sum_c dO[b, q, h, c] * O[b, q, h, c]; one warp a row.
__global__ void __launch_bounds__(THREADS) delta_kernel(const Args a) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.Nq * a.H) return;   // whole warps leave together
  const int h = (int)(row % a.H);
  const int qi = (int)((row / a.H) % a.Nq);
  const int b = (int)(row / ((long long)a.H * a.Nq));
  const T* o = head(a.o, a.so, b, h) + qi * a.so.n;
  const T* d = head(a.dout, a.sdo, b, h) + qi * a.sdo.n;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) s = fmaf(to_f32(d[c]), to_f32(o[c]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.delta[((long long)b * a.H + h) * a.Nq + qi] = s;
}

template <bool BRIDGE>
constexpr int dq_smem_floats() {
  return 2 * BQ * DP                        // Q, dO tiles
         + BK * DP * (BRIDGE ? 4 : 2)       // K, V (+ Kb, Vb) tiles
         + BQ * (BK + 1);                   // dS tile
}

// 2. dq: 256 threads, thread (ty, tx) owns rows 2ty, 2ty+1 of the block, keys
//    tx + 8*jj of each key tile, and columns tx + 8*c of its rows' dq.
template <bool BRIDGE>
__global__ void __launch_bounds__(THREADS) dq_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* DOs = Qs + BQ * DP;
  float* Ks = DOs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* KBs = Vs + BK * DP;
  float* VBs = KBs + (BRIDGE ? BK * DP : 0);
  float* DSs = VBs + (BRIDGE ? BK * DP : 0);
  constexpr int SP = BK + 1;
  __shared__ uint8_t fk[BK];

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* q = head(a.q, a.sq, b, h);
  const T* dout = head(a.dout, a.sdo, b, h);
  const T* k = head(a.k, a.sk, b, h);
  const T* v = head(a.v, a.sv, b, h);
  const T* kb = BRIDGE ? head(a.kb, a.skb, b, h) : nullptr;
  const T* vb = BRIDGE ? head(a.vb, a.svb, b, h) : nullptr;
  const uint8_t* flag_kv = a.flag_kv + (long long)b * a.Nk;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    const bool ok = qi < a.Nq;
    Qs[r * DP + c] = ok ? to_f32(q[qi * a.sq.n + c]) : 0.f;
    DOs[r * DP + c] = ok ? to_f32(dout[qi * a.sdo.n + c]) : 0.f;
  }

  bool live[2], rvalid[2];
  uint8_t rflag[2];
  const float* brow[2];
  float m[2], l[2], dl[2], acc[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * ty + i;
    rvalid[i] = qi < a.Nq;
    const long long st = ((long long)b * a.H + h) * a.Nq + (rvalid[i] ? qi : 0);
    m[i] = a.row_max[st];
    l[i] = a.row_sum[st];
    dl[i] = a.delta[st];
    live[i] = rvalid[i] && m[i] > BIG_NEG;   // a fully masked row: ds = 0
    rflag[i] = rvalid[i] ? a.flag_q[(long long)b * a.Nq + qi] : 0;
    brow[i] = a.bias + b * a.bias_b + (rvalid[i] ? qi : 0) * a.bias_q;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < a.Nk; k0 += BK) {
    __syncthreads();   // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, c = i % D, kj = k0 + j;
      const bool ok = kj < a.Nk;
      Ks[j * DP + c] = ok ? to_f32(k[kj * a.sk.n + c]) : 0.f;
      Vs[j * DP + c] = ok ? to_f32(v[kj * a.sv.n + c]) : 0.f;
      if (BRIDGE) {
        KBs[j * DP + c] = ok ? to_f32(kb[kj * a.skb.n + c]) : 0.f;
        VBs[j * DP + c] = ok ? to_f32(vb[kj * a.svb.n + c]) : 0.f;
      }
    }
    if (tid < BK) fk[tid] = k0 + tid < a.Nk ? flag_kv[k0 + tid] : 0;
    __syncthreads();

    // scores s = q.k, sb = q.kb and dp = dO.v, dpb = dO.vb for 2 rows x 4 keys
    float s[2][4], sb[2][4], dp[2][4], dpb[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = sb[i][jj] = dp[i][jj] = dpb[i][jj] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qa = Qs[(2 * ty) * DP + c], qb = Qs[(2 * ty + 1) * DP + c];
      const float da = DOs[(2 * ty) * DP + c], db = DOs[(2 * ty + 1) * DP + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tx + 8 * jj;
        const float kv = Ks[j * DP + c], vv = Vs[j * DP + c];
        s[0][jj] = fmaf(qa, kv, s[0][jj]);
        s[1][jj] = fmaf(qb, kv, s[1][jj]);
        dp[0][jj] = fmaf(da, vv, dp[0][jj]);
        dp[1][jj] = fmaf(db, vv, dp[1][jj]);
        if (BRIDGE) {
          const float kbv = KBs[j * DP + c], vbv = VBs[j * DP + c];
          sb[0][jj] = fmaf(qa, kbv, sb[0][jj]);
          sb[1][jj] = fmaf(qb, kbv, sb[1][jj]);
          dpb[0][jj] = fmaf(da, vbv, dpb[0][jj]);
          dpb[1][jj] = fmaf(db, vbv, dpb[1][jj]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tx + 8 * jj, kj = k0 + j;
        float ds = 0.f;
        if (live[i] && kj < a.Nk) {
          const bool cross = BRIDGE && fk[j] != rflag[i];
          float x = s[i][jj] * a.scale;
          if (cross) x += sb[i][jj] * a.scale;
          x = fmaxf(x + brow[i][kj], BIG_NEG);
          const float p = expf(x - m[i]) / l[i];
          const float dpt = cross ? dp[i][jj] + dpb[i][jj] : dp[i][jj];
          ds = p * (dpt - dl[i]);
        }
        DSs[(2 * ty + i) * SP + j] = ds;
      }
    }
    __syncwarp();   // a row's dS entries are written and read by one warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float dsa = DSs[(2 * ty) * SP + j];
      const float dsb = DSs[(2 * ty + 1) * SP + j];
      const float dsxa = BRIDGE && fk[j] != rflag[0] ? dsa : 0.f;
      const float dsxb = BRIDGE && fk[j] != rflag[1] ? dsb : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = Ks[j * DP + tx + 8 * c];
        acc[0][c] = fmaf(dsa, kv, acc[0][c]);
        acc[1][c] = fmaf(dsb, kv, acc[1][c]);
        if (BRIDGE) {
          const float kbv = KBs[j * DP + tx + 8 * c];
          acc[0][c] = fmaf(dsxa, kbv, acc[0][c]);
          acc[1][c] = fmaf(dsxb, kbv, acc[1][c]);
        }
      }
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int qi = q0 + 2 * ty + i;
    T* row = dq + (((long long)b * a.Nq + qi) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) row[tx + 8 * c] = __float2bfloat16(acc[i][c] * a.scale);
  }
}

template <bool BRIDGE>
constexpr int dkv_smem_floats() {
  return BK * DP * (BRIDGE ? 4 : 2)         // K, V (+ Kb, Vb) of the block's keys
         + 2 * BQ2 * DP                     // Q, dO tiles
         + 2 * BQ2 * (BK + 1);              // P, dS tiles
}

// 3. dk/dv/dkb/dvb. Score phase: thread (w = tid / 32, lane) takes key `lane`
//    and query rows w + 8*i of the tile. Sum phase: thread (kr = tid / 8, tx)
//    owns key kr and columns tx + 8*c of its four gradients.
template <bool BRIDGE>
__global__ void __launch_bounds__(THREADS) dkv_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DP;
  float* KBs = Vs + BK * DP;
  float* VBs = KBs + (BRIDGE ? BK * DP : 0);
  float* Qs = VBs + (BRIDGE ? BK * DP : 0);
  float* DOs = Qs + BQ2 * DP;
  float* Ps = DOs + BQ2 * DP;
  float* DSs = Ps + BQ2 * (BK + 1);
  constexpr int SP = BK + 1;
  __shared__ uint8_t fk[BK], fq[BQ2];
  __shared__ float mrow[BQ2], lrow[BQ2], drow[BQ2];

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;     // score phase
  const int kr = tid >> 3, tx = tid & 7;       // sum phase
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* q = head(a.q, a.sq, b, h);
  const T* dout = head(a.dout, a.sdo, b, h);
  const T* k = head(a.k, a.sk, b, h);
  const T* v = head(a.v, a.sv, b, h);
  const T* kb = BRIDGE ? head(a.kb, a.skb, b, h) : nullptr;
  const T* vb = BRIDGE ? head(a.vb, a.svb, b, h) : nullptr;
  const uint8_t* flag_q = a.flag_q + (long long)b * a.Nq;
  const float* bias = a.bias + b * a.bias_b;
  const long long st0 = ((long long)b * a.H + h) * a.Nq;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int j = i / D, c = i % D, kj = k0 + j;
    const bool ok = kj < a.Nk;
    Ks[j * DP + c] = ok ? to_f32(k[kj * a.sk.n + c]) : 0.f;
    Vs[j * DP + c] = ok ? to_f32(v[kj * a.sv.n + c]) : 0.f;
    if (BRIDGE) {
      KBs[j * DP + c] = ok ? to_f32(kb[kj * a.skb.n + c]) : 0.f;
      VBs[j * DP + c] = ok ? to_f32(vb[kj * a.svb.n + c]) : 0.f;
    }
  }
  if (tid < BK) fk[tid] = k0 + tid < a.Nk ? a.flag_kv[(long long)b * a.Nk + k0 + tid] : 0;

  const int kj = k0 + lane;        // this thread's key in the score phase
  const bool kvalid = kj < a.Nk;
  float dk[CPT], dv[CPT], dkb[CPT], dvb[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) dk[c] = dv[c] = dkb[c] = dvb[c] = 0.f;

  for (int q0 = 0; q0 < a.Nq; q0 += BQ2) {
    __syncthreads();   // the previous query tile is fully consumed
    for (int i = tid; i < BQ2 * D; i += THREADS) {
      const int r = i / D, c = i % D, qi = q0 + r;
      const bool ok = qi < a.Nq;
      Qs[r * DP + c] = ok ? to_f32(q[qi * a.sq.n + c]) : 0.f;
      DOs[r * DP + c] = ok ? to_f32(dout[qi * a.sdo.n + c]) : 0.f;
    }
    if (tid < BQ2) {
      const int qi = q0 + tid;
      const bool ok = qi < a.Nq;
      fq[tid] = ok ? flag_q[qi] : 0;
      mrow[tid] = ok ? a.row_max[st0 + qi] : 0.f;
      lrow[tid] = ok ? a.row_sum[st0 + qi] : 1.f;
      drow[tid] = ok ? a.delta[st0 + qi] : 0.f;
    }
    __syncthreads();

    float s[4], sb[4], dp[4], dpb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = sb[i] = dp[i] = dpb[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float kv = Ks[lane * DP + c], vv = Vs[lane * DP + c];
      const float kbv = BRIDGE ? KBs[lane * DP + c] : 0.f;
      const float vbv = BRIDGE ? VBs[lane * DP + c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = w + 8 * i;
        const float qa = Qs[r * DP + c], da = DOs[r * DP + c];
        s[i] = fmaf(qa, kv, s[i]);
        dp[i] = fmaf(da, vv, dp[i]);
        if (BRIDGE) {
          sb[i] = fmaf(qa, kbv, sb[i]);
          dpb[i] = fmaf(da, vbv, dpb[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = w + 8 * i, qi = q0 + r;
      float p = 0.f, ds = 0.f;
      if (kvalid && qi < a.Nq) {
        const bool cross = BRIDGE && fk[lane] != fq[r];
        float x = s[i] * a.scale;
        if (cross) x += sb[i] * a.scale;
        x = fmaxf(x + bias[qi * a.bias_q + kj], BIG_NEG);
        p = expf(x - mrow[r]) / lrow[r];
        if (mrow[r] > BIG_NEG) {   // a fully masked row feeds dV, not dK
          const float dpt = cross ? dp[i] + dpb[i] : dp[i];
          ds = p * (dpt - drow[r]);
        }
      }
      Ps[r * SP + lane] = p;
      DSs[r * SP + lane] = ds;
    }
    __syncthreads();

#pragma unroll 2
    for (int r = 0; r < BQ2; ++r) {
      const float p = Ps[r * SP + kr], ds = DSs[r * SP + kr];
      const bool cross = BRIDGE && fk[kr] != fq[r];
      const float px = cross ? p : 0.f, dsx = cross ? ds : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float dov = DOs[r * DP + tx + 8 * c], qv = Qs[r * DP + tx + 8 * c];
        dv[c] = fmaf(p, dov, dv[c]);
        dk[c] = fmaf(ds, qv, dk[c]);
        if (BRIDGE) {
          dvb[c] = fmaf(px, dov, dvb[c]);
          dkb[c] = fmaf(dsx, qv, dkb[c]);
        }
      }
    }
  }

  const int key = k0 + kr;
  if (key >= a.Nk) return;
  const long long off = (((long long)b * a.Nk + key) * a.H + h) * D;
  T* gk = static_cast<T*>(a.dk) + off;
  T* gv = static_cast<T*>(a.dv) + off;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    gk[tx + 8 * c] = __float2bfloat16(dk[c] * a.scale);
    gv[tx + 8 * c] = __float2bfloat16(dv[c]);
  }
  if (BRIDGE) {
    T* gkb = static_cast<T*>(a.dkb) + off;
    T* gvb = static_cast<T*>(a.dvb) + off;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      gkb[tx + 8 * c] = __float2bfloat16(dkb[c] * a.scale);
      gvb[tx + 8 * c] = __float2bfloat16(dvb[c]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool BRIDGE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Nq * a.H;
  const int warps = THREADS / 32;
  delta_kernel<<<(unsigned)((rows + warps - 1) / warps), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dq_smem = dq_smem_floats<BRIDGE>() * sizeof(float);
  err = allow_smem(dq_kernel<BRIDGE>, dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<BRIDGE><<<dim3((a.Nq + BQ - 1) / BQ, a.H, a.B), THREADS, dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = dkv_smem_floats<BRIDGE>() * sizeof(float);
  err = allow_smem(dkv_kernel<BRIDGE>, dkv_smem);
  if (err != cudaSuccess) return err;
  dkv_kernel<BRIDGE><<<dim3((a.Nk + BK - 1) / BK, a.H, a.B), THREADS, dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Operands are bfloat16 with head dim 128; the wrapper checks both. kb/vb
// (and dkb/dvb) are null without the bridge. row_max/row_sum: the forward's
// fp32 (B, H, Nq) softmax stats; delta: an fp32 (B, H, Nq) scratch buffer.
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
