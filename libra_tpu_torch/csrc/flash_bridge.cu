// Bridged flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel libra_tpu/ops/pallas/flash_bridge.py::_fwd_impl
// (body _kernel). For each batch b, head h and query row q:
//
//   s[k]  = (q . K[k]) * scale + cross[q,k] * (q . Kb[k]) * scale + bias[b,0,q,k]
//   s[k]  = max(s[k], BIG_NEG)                      BIG_NEG = -2^30
//   out   = sum_k exp(s[k] - m) (V[k] + cross[q,k] Vb[k]) / sum_k exp(s[k] - m)
//
// with cross[q,k] = flag_q[b,q] != flag_kv[b,k]. Because cross is one scalar
// per (q, k) pair, one accumulator carries both value terms.
//
// What bounds it on this card: at the prompt shape (B=4, H=32, Nq=610,
// Nk=738, d=128) the kernel does about 2*B*H*Nq*Nk*d*3 = 44 GFLOP and reads
// q/k/v/kb/vb plus the fp32 bias plane (B*Nq*Nk*4 = 7 MB), so arithmetic,
// not memory, is the limit. This first version does that arithmetic as fp32
// FMAs out of shared memory, with no tensor cores; shared-memory load
// bandwidth (about one load per two FMAs in the inner loops) bounds it.
//
// Design:
//   * one block per (q-tile of 64 rows, head, batch); 256 threads, each
//     owning 2 query rows x 4 keys of a score tile and 2 rows x d/8 output
//     columns, so a row's softmax state lives in the 8 lanes that own it;
//   * keys stream through shared memory in tiles of 32 with an online
//     softmax (fp32 running max, running sum and accumulator), so K/V of any
//     length fit (the TPU kernel held all of a head's K/V in VMEM);
//   * cross is built in the kernel from the two flag vectors; operands are
//     read in their (B, N, H, d) layout through strides (no head-major
//     transposes, no dense cross plane);
//   * the ragged query tail and key tail are masked in the kernel;
//   * masked scores are clamped to BIG_NEG, never -inf, and the running max
//     starts at BIG_NEG, so a fully masked query row is the uniform average
//     of V that the reference gives; keys past Nk get probability 0.
//   * padded shared-memory rows (d+1, 32+1 floats) keep the inner loops free
//     of bank conflicts; P * cross is formed from the flags as it is read,
//     not stored, so two blocks fit on an SM at d = 128 with the bridge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 32;         // keys per shared-memory tile
constexpr int THREADS = 256;   // 32 row groups x 8 lanes
constexpr float BIG_NEG = -1073741824.0f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <int D, bool BRIDGE>
constexpr int smem_floats() {
  return BQ * (D + 1)                       // Q tile
         + BK * (D + 1) * (BRIDGE ? 2 : 1)  // K (+ Kb) tiles
         + BK * D * (BRIDGE ? 2 : 1)        // V (+ Vb) tiles
         + BQ * (BK + 1);                   // P tile
}

template <int D, bool BRIDGE>
__global__ void __launch_bounds__(THREADS)
flash_bridge_fwd_kernel(const Args a) {
  using T = __nv_bfloat16;
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int CPT = D / 8;   // output columns per thread: tx + 8 * c
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* KBs = Ks + BK * DP;
  float* Vs = KBs + (BRIDGE ? BK * DP : 0);
  float* VBs = Vs + BK * D;
  float* Ps = VBs + (BRIDGE ? BK * D : 0);
  __shared__ uint8_t fk[BK];

  const int tid = threadIdx.x;
  const int ty = tid >> 3;   // rows 2*ty, 2*ty + 1 of the tile
  const int tx = tid & 7;    // keys tx + 8*jj of a key tile
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* kb = BRIDGE ? static_cast<const T*>(a.kb) + b * a.skb.b + h * a.skb.h : nullptr;
  const T* vb = BRIDGE ? static_cast<const T*>(a.vb) + b * a.svb.b + h * a.svb.h : nullptr;
  const uint8_t* flag_kv = a.flag_kv + (long long)b * a.Nk;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, qi = q0 + r;
    Qs[r * DP + c] = qi < a.Nq ? to_f32(q[qi * a.sq.n + c]) : 0.f;
  }

  bool rvalid[2];
  uint8_t rflag[2];
  const float* brow[2];
  float m[2], l[2], acc[2][CPT];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + 2 * ty + i;
    rvalid[i] = qi < a.Nq;
    rflag[i] = rvalid[i] ? a.flag_q[(long long)b * a.Nq + qi] : 0;
    brow[i] = a.bias + b * a.bias_b + (rvalid[i] ? qi : 0) * a.bias_q;
    m[i] = BIG_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < a.Nk; k0 += BK) {
    __syncthreads();   // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, c = i % D, kj = k0 + j;
      const bool ok = kj < a.Nk;
      Ks[j * DP + c] = ok ? to_f32(k[kj * a.sk.n + c]) : 0.f;
      Vs[j * D + c] = ok ? to_f32(v[kj * a.sv.n + c]) : 0.f;
      if (BRIDGE) {
        KBs[j * DP + c] = ok ? to_f32(kb[kj * a.skb.n + c]) : 0.f;
        VBs[j * D + c] = ok ? to_f32(vb[kj * a.svb.n + c]) : 0.f;
      }
    }
    if (tid < BK) fk[tid] = k0 + tid < a.Nk ? flag_kv[k0 + tid] : 0;
    __syncthreads();

    float s[2][4], sb[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = sb[i][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qa = Qs[(2 * ty) * DP + c];
      const float qb = Qs[(2 * ty + 1) * DP + c];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float kv = Ks[(tx + 8 * jj) * DP + c];
        s[0][jj] = fmaf(qa, kv, s[0][jj]);
        s[1][jj] = fmaf(qb, kv, s[1][jj]);
        if (BRIDGE) {
          const float kbv = KBs[(tx + 8 * jj) * DP + c];
          sb[0][jj] = fmaf(qa, kbv, sb[0][jj]);
          sb[1][jj] = fmaf(qb, kbv, sb[1][jj]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = BIG_NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = tx + 8 * jj, kj = k0 + j;
        float x = -INFINITY;   // past the last key: probability 0
        if (kj < a.Nk) {
          x = s[i][jj] * a.scale;
          if (BRIDGE && fk[j] != rflag[i]) x += sb[i][jj] * a.scale;
          if (rvalid[i]) x += brow[i][kj];
          x = fmaxf(x, BIG_NEG);
        }
        s[i][jj] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);   // both finite: never NaN
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
      const int r = 2 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        l[i] += p;
        Ps[r * PP + tx + 8 * jj] = p;
      }
    }
    __syncwarp();   // a row's P entries are written and read by one warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float pa = Ps[(2 * ty) * PP + j];
      const float pb = Ps[(2 * ty + 1) * PP + j];
      // P * cross, from the flags (cross is one bit per (row, key))
      const float pca = BRIDGE && fk[j] != rflag[0] ? pa : 0.f;
      const float pcb = BRIDGE && fk[j] != rflag[1] ? pb : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[j * D + tx + 8 * c];
        acc[0][c] = fmaf(pa, vv, acc[0][c]);
        acc[1][c] = fmaf(pb, vv, acc[1][c]);
        if (BRIDGE) {
          const float vbv = VBs[j * D + tx + 8 * c];
          acc[0][c] = fmaf(pca, vbv, acc[0][c]);
          acc[1][c] = fmaf(pcb, vbv, acc[1][c]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];   // this lane's share of the row sum
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    if (!rvalid[i]) continue;
    const int qi = q0 + 2 * ty + i;
    if (a.row_max != nullptr && tx == 0) {   // the backward's softmax stats
      const long long st = ((long long)b * a.H + h) * a.Nq + qi;
      a.row_max[st] = m[i];
      a.row_sum[st] = lt;
    }
    T* orow = out + (((long long)b * a.Nq + qi) * a.H + h) * D;
    const float inv = 1.f / lt;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + tx + 8 * c, acc[i][c] * inv);
  }
}

template <bool BRIDGE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int D = 128;
  const size_t smem = smem_floats<D, BRIDGE>() * sizeof(float);
  auto kernel = flash_bridge_fwd_kernel<D, BRIDGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Nq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Operands are bfloat16 with head dim 128 (libra-11b's); the wrapper
// checks both. kb/vb are null without the bridge. row_max/row_sum are
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
