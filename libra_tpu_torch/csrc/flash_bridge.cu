// Bridged flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libra_tpu/ops/pallas/flash_bridge.py::_fwd_impl
// (body _kernel). For each batch b, head h and query row q:
//
//   s[k]  = (q . K[k]) * scale + cross[q,k] * (q . Kb[k]) * scale + bias[b,0,q,k]
//   s[k]  = max(s[k], BIG_NEG)                      BIG_NEG = -2^30
//   p[k]  = exp(s[k] - m),  m = max_k s[k]
//   out   = (sum_k bf16(p[k]) V[k] + sum_k bf16(p[k] cross[q,k]) Vb[k]) / sum_k p[k]
//
// with cross[q,k] = flag_q[b,q] != flag_kv[b,k]. Like the TPU kernel, the
// probabilities are rounded to bf16 for the value products and the
// denominator sums them in fp32.
//
// What bounds it on this card: at the prompt shape (B=4, H=32, Nq=610,
// Nk=738, d=128) the four products take 2*B*H*Nq*Nk*d*4 = 59 GFLOP if every
// (query, key) pair is computed (0.06 ms at the 989 TFLOP/s bf16 peak), but
// the causal mask and the unwritten cache tail leave only ~41% of the pairs
// live, so the 0.14 GB of operands, bias plane and output (0.043 ms at 3.35
// TB/s) bound it. This kernel computes the live tiles on the tensor cores;
// what holds it back is latency: at 213 registers a thread two blocks (8
// warps) fit an SM, and each warp's 16 rows feed only 2 products per
// ldmatrix, so the per-tile barrier, the bias loads from L2 and the mma
// chains are not hidden.
//
// Design (FlashAttention-2's forward with the bridge):
//   * one block per (64 query rows, head, batch), 4 warps of 16 rows; each
//     warp keeps its rows' Q fragments, fp32 output accumulator (16 x 128)
//     and online-softmax state in registers;
//   * keys stream in tiles of 32 through a 2-stage cp.async ring holding
//     K, V (and Kb, Vb) in swizzled shared memory (flash_mma.cuh), the next
//     tile's copies in flight while the current one is computed;
//   * per tile, S = Q K^T and Sb = Q Kb^T on the tensor cores (mma.sync
//     m16n8k16 bf16, fp32 sums), s = scale S + cross scale Sb + bias clamped to
//     BIG_NEG in fp32, the online max and sum in fp32, then P and P * cross
//     packed to bf16 in registers as the A operand of O += P V + (P cross) Vb;
//   * operands are read in their (B, N, H, d) layout through strides (the
//     wrapper checks 16-byte aligned rows); the bias plane (rows of Nk fp32,
//     not 16-byte aligned in general) is read with 4-byte loads straight
//     into the accumulator layout; cross comes from the two flag vectors;
//   * exact skipping: a warp skips a key tile when every bias entry of its
//     16 rows there is <= BIG_NEG / 2 and every row already has a running
//     max >= BIG_NEG / 4, so that every skipped probability is exactly 0 in
//     fp32 (SKIP_BIAS, SKIP_MAX in flash_mma.cuh). A row with no live key yet never
//     skips: its masked terms are either wiped exactly later (alpha = 0) or
//     make up its uniform average if the row stays fully masked. This drops
//     the causal upper triangle and the unwritten cache tail;
//   * keys past Nk get probability 0; masked scores are clamped to BIG_NEG,
//     never -inf, and the running max starts at BIG_NEG, so a fully masked
//     row is the uniform average of V (+ Vb) that the reference gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using namespace fmma;
using T = __nv_bfloat16;

constexpr int D = 128;              // head dim (libra-11b's)
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int QTILE = BQ * D * 2;   // bytes of the Q tile
constexpr int KTILE = BK * D * 2;   // bytes of one operand's key tile

// Element strides of a (B, N, H, d) operand; d has unit stride.
struct Strides {
  long long b, n, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* kb;
  const void* vb;
  const uint8_t* flag_q;   // (B, Nq) contiguous, 0/1
  const uint8_t* flag_kv;  // (B, Nk) contiguous, 0/1
  const float* bias;       // (B, 1, Nq, Nk), key stride 1
  void* out;               // (B, Nq, H, d) contiguous
  float* row_max;          // (B, H, Nq) or null: each row's final max
  float* row_sum;          // (B, H, Nq) or null: each row's denominator
  Strides sq, sk, sv, skb, svb;
  long long bias_b, bias_q;
  int Nq, Nk, H;
  float scale;
};

template <bool BRIDGE>
constexpr int smem_bytes() {
  return QTILE + 2 * (BRIDGE ? 4 : 2) * KTILE;
}

template <bool BRIDGE>
__global__ void __launch_bounds__(THREADS)
flash_bridge_fwd_kernel(const Args a) {
  constexpr int NOPS = BRIDGE ? 4 : 2;   // K, V (, Kb, Vb) in a stage
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_kv = s_q + QTILE;

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* ops[4] = {
      static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h,
      static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h,
      BRIDGE ? static_cast<const T*>(a.kb) + b * a.skb.b + h * a.skb.h : nullptr,
      BRIDGE ? static_cast<const T*>(a.vb) + b * a.svb.b + h * a.svb.h : nullptr};
  const long long lds[4] = {a.sk.n, a.sv.n, a.skb.n, a.svb.n};
  const uint8_t* flag_kv = a.flag_kv + (long long)b * a.Nk;

  auto load_keys = [&](int stage, int k0) {
#pragma unroll
    for (int o = 0; o < NOPS; ++o)
      load_tile<BK, THREADS>(s_kv + (stage * NOPS + o) * KTILE, ops[o], lds[o], k0,
                             a.Nk, tid);
  };
  load_tile<BQ, THREADS>(s_q, q, a.sq.n, q0, a.Nq, tid);
  load_keys(0, 0);
  cp_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  bool rvalid[2];
  uint8_t rflag[2];
  const float* brow[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 16 * warp + g + 8 * i;
    rvalid[i] = qi < a.Nq;
    rflag[i] = rvalid[i] ? a.flag_q[(long long)b * a.Nq + qi] : 0;
    brow[i] = a.bias + b * a.bias_b + (rvalid[i] ? qi : 0) * a.bias_q;
    m[i] = BIG_NEG;
    l[i] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  uint32_t qa[D / 16][4];   // the warp's Q rows as A fragments

  const int ntiles = (a.Nk + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_wait<0>();
    __syncthreads();   // tile `it` has landed; tile it - 1 is fully consumed
    if (it + 1 < ntiles) load_keys((it + 1) & 1, k0 + BK);
    cp_commit();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) load_a<16>(qa[kc], s_q, 16 * warp, kc, lane);
    }
    const uint32_t sK = s_kv + (it & 1) * NOPS * KTILE;
    const uint32_t sV = sK + KTILE, sKb = sK + 2 * KTILE, sVb = sK + 3 * KTILE;

    // bias of (row g + 8i, key k0 + 8j + 2t + e) at [4j + 2i + e] (the C
    // fragment's order), -inf past Nk; the warp skips the tile when it is
    // masked for all its rows and each of them has a live key already
    float bias[4 * (BK / 8)];
    bool skip = true;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, kj = k0 + 8 * j + 2 * t + (c & 1);
        const float bv = kj < a.Nk ? __ldg(brow[i] + kj) : -INFINITY;
        bias[4 * j + c] = bv;
        skip &= !rvalid[i] || (m[i] >= SKIP_MAX && bv <= SKIP_BIAS);
      }
    if (__all_sync(0xffffffffu, skip)) continue;

    float s[BK / 8][4], sb[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = sb[j][c] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        load_b_nk<16>(bk, sK, 16 * np, kc, lane);
        mma16816(s[2 * np], qa[kc], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa[kc], bk[2], bk[3]);
        if (BRIDGE) {
          load_b_nk<16>(bk, sKb, 16 * np, kc, lane);
          mma16816(sb[2 * np], qa[kc], bk[0], bk[1]);
          mma16816(sb[2 * np + 1], qa[kc], bk[2], bk[3]);
        }
      }

    // scores, the online max, and the unnormalised probabilities
    uint32_t cross = 0;   // bit 4j + c: element c of n-block j is cross-modal
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, kj = k0 + 8 * j + 2 * t + (c & 1);
        float x = s[j][c] * a.scale;
        if (BRIDGE && kj < a.Nk && flag_kv[kj] != rflag[i]) {
          x += sb[j][c] * a.scale;
          cross |= 1u << (4 * j + c);
        }
        x += bias[4 * j + c];
        x = kj < a.Nk ? fmaxf(x, BIG_NEG) : -INFINITY;
        s[j][c] = x;
        mt[i] = fmaxf(mt[i], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = expf(m[i] - m_new);   // both finite: never NaN
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
    float px[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[j][c] - m[c >> 1]);
        l[c >> 1] += p;
        s[j][c] = p;
        px[j][c] = (cross >> (4 * j + c)) & 1u ? p : 0.f;
      }

    // O += bf16(P) V + bf16(P cross) Vb, 16 keys at a time
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4], pxa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
      if (BRIDGE) pack_a(pxa, px[2 * kc], px[2 * kc + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bv[4];
        load_b_kn<16>(bv, sV, 16 * kc, 16 * np, lane);
        mma16816(acc[2 * np], pa, bv[0], bv[1]);
        mma16816(acc[2 * np + 1], pa, bv[2], bv[3]);
        if (BRIDGE) {
          load_b_kn<16>(bv, sVb, 16 * kc, 16 * np, lane);
          mma16816(acc[2 * np], pxa, bv[0], bv[1]);
          mma16816(acc[2 * np + 1], pxa, bv[2], bv[3]);
        }
      }
    }
  }
  cp_wait<0>();

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];   // this lane's share of the row sum
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (!rvalid[i]) continue;
    const int qi = q0 + 16 * warp + g + 8 * i;
    if (a.row_max != nullptr && t == 0) {   // the backward's softmax stats
      const long long st = ((long long)b * a.H + h) * a.Nq + qi;
      a.row_max[st] = m[i];
      a.row_sum[st] = lt;
    }
    T* orow = out + (((long long)b * a.Nq + qi) * a.H + h) * D;
    const float inv = 1.f / lt;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

template <bool BRIDGE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BRIDGE>();
  auto kernel = flash_bridge_fwd_kernel<BRIDGE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Operands are bfloat16 with head dim 128 (libra-11b's), 16-byte aligned
// with b/n/h strides that are multiples of 8 elements; the wrapper checks
// all three. kb/vb are null without the bridge. row_max/row_sum are
// null for inference; training passes fp32 (B, H, Nq) buffers that get each
// row's final max and softmax denominator, which the backward
// (flash_bridge_bwd.cu) reads instead of recomputing them.
// strides: 17 element strides, in order
//   q (b, n, h), k (b, n, h), v (b, n, h), kb (b, n, h), vb (b, n, h),
//   bias (b, q).
// scale: the score scale, 1/sqrt(128).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_bridge_fwd(const void* q, const void* k, const void* v,
                                const void* kb, const void* vb,
                                const void* flag_q, const void* flag_kv,
                                const void* bias, void* out,
                                void* row_max, void* row_sum,
                                const long long* strides,
                                int B, int Nq, int Nk, int H,
                                float scale, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kb = kb;
  a.vb = vb;
  a.flag_q = static_cast<const uint8_t*>(flag_q);
  a.flag_kv = static_cast<const uint8_t*>(flag_kv);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.row_max = static_cast<float*>(row_max);
  a.row_sum = static_cast<float*>(row_sum);
  Strides* s[5] = {&a.sq, &a.sk, &a.sv, &a.skb, &a.svb};
  for (int i = 0; i < 5; ++i) {
    s[i]->b = strides[3 * i];
    s[i]->n = strides[3 * i + 1];
    s[i]->h = strides[3 * i + 2];
  }
  a.bias_b = strides[15];
  a.bias_q = strides[16];
  a.Nq = Nq;
  a.Nk = Nk;
  a.H = H;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kb != nullptr ? launch<true>(a, B, st) : launch<false>(a, B, st));
}
