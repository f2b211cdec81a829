// Bridged decode attention over the head-major int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// libra_tpu/ops/pallas/decode_attention.py::int8_decode_attention (bodies
// _kernel_bridge and _kernel_plain). For batch b, head h and query row n:
//
//   s[j]  = (q . k[j]) * ks[j] * scale + cross[n,j] * (q . kb[j]) * kbs[j] * scale
//   s[j]  = max(s[j] + bias[b,n,j], BIG_NEG)                 BIG_NEG = -2^30
//   out   = sum_j a[j] * (vs[j] * v[j] + cross[n,j] * vbs[j] * vb[j])
//
// with a = softmax(s) in fp32 over all S cache slots, k/v/kb/vb the raw int8
// rows and ks/vs/kbs/vbs their fp32 per-(token, head) scales, and
// cross[n,j] = flag_q[b,n] != flag_kv[b,j]. The K scales multiply the
// scores and the V scales the probabilities, so the cache is read once, as
// int8. A row whose keys are all masked is the uniform average of V, as the
// BIG_NEG clamp gives it.
//
// What bounds it on this card: reading the cache. At B=4, H=32, S=674 one
// layer's four int8 buffers are 44 MB (about 15 us at 3 TB/s); each byte
// feeds N multiply-adds.
//
// Design (simple first): one block per (head, batch), 256 threads, keys in
// tiles of 32 with an online softmax over the N <= 64 query rows:
//   * each warp loads 4 keys of a tile, one 128-byte row of each buffer a
//     key (4 bytes a lane, all issued before use), takes the N dot products
//     with the query rows from shared memory and reduces them with shuffles;
//     it also writes the V rows to shared memory as fp32;
//   * warp w keeps the running max and sum of rows w, w + 8, ..., with lane
//     j on key j of the tile, and writes p * vs (and p * cross * vbs) to
//     shared memory, with each row's rescale factor;
//   * thread t accumulates column t % 128 of every row over the even
//     (t < 128) or odd (t >= 128) keys of the tile; the halves are added at
//     the end and divided by the row sum;
//   * keys past S get probability exactly 0; the running max starts at
//     BIG_NEG, so exponents never see -inf - -inf.
// Splitting S over blocks (flash-decoding) is later work: B*H = 128 blocks
// fill the card's 132 SMs once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head dim: libra-11b's, the only one built
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BS = 32;          // keys per tile (one a lane in the softmax)
constexpr int KPW = BS / WARPS; // keys per warp per tile: 4
constexpr float BIG_NEG = -1073741824.0f;

struct Args {
  const __nv_bfloat16* q;         // (B, N, H, D), unit stride in D
  long long q_b, q_n, q_h;
  const int8_t* k;                // (B, H, S, D) layer views, one layout
  const int8_t* v;
  const int8_t* kb;               // null without the bridge
  const int8_t* vb;
  long long c_b, c_h, c_s;
  const float* ks;                // (B, H, S) fp32 scales, one layout
  const float* vs;
  const float* kbs;
  const float* vbs;
  long long s_b, s_h;
  const uint8_t* flag_q;          // (B, N) contiguous, 0/1
  const uint8_t* flag_kv;         // (B, S) contiguous, 0/1
  const float* bias;              // (B, N, S), unit stride in S
  long long bias_b, bias_n;
  __nv_bfloat16* out;             // (B, N, H, D) contiguous
  int N, S, H;
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float byte_f32(uint32_t w, int e) {
  return (float)(int8_t)(uint8_t)(w >> (8 * e));
}

template <int NMAX>
constexpr int smem_floats(bool bridge) {
  return NMAX * D                        // query rows; at the end, half sums
         + BS * D * (bridge ? 2 : 1)     // V (+ Vb) tile
         + NMAX * BS * (bridge ? 2 : 1)  // p * vs (+ p * cross * vbs)
         + NMAX * BS                     // scores
         + NMAX;                         // rescale factors; at the end, sums
}

template <int NMAX, bool BRIDGE>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Vs = Qs + NMAX * D;
  float* VBs = Vs + BS * D;
  float* Ps = VBs + (BRIDGE ? BS * D : 0);
  float* PBs = Ps + NMAX * BS;
  float* Ss = PBs + (BRIDGE ? NMAX * BS : 0);
  float* Al = Ss + NMAX * BS;
  __shared__ uint8_t fq[NMAX];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int N = a.N;

  for (int i = tid; i < NMAX * D; i += THREADS) {
    const int n = i / D, c = i % D;
    Qs[i] = n < N ? __bfloat162float(a.q[b * a.q_b + n * a.q_n + h * a.q_h + c]) : 0.f;
  }
  if (tid < NMAX) fq[tid] = tid < N ? a.flag_q[(long long)b * N + tid] : 0;

  const long long cbase = b * a.c_b + h * a.c_h;
  const long long sbase = b * a.s_b + h * a.s_h;
  const uint8_t* fkv = a.flag_kv + (long long)b * a.S;

  constexpr int RPW = NMAX / WARPS > 0 ? NMAX / WARPS : 1;   // softmax rows a warp
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = BIG_NEG;
    l_run[i] = 0.f;
  }
  const int col = tid % D, half = tid / D;
  float acc[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) acc[n] = 0.f;

  for (int s0 = 0; s0 < a.S; s0 += BS) {
    __syncthreads();   // Q is staged; the previous tile is consumed

    // --- scores and the V tile: warp w takes keys w * KPW .. + KPW - 1 ---
    uint32_t kw[KPW], vw[KPW], kbw[KPW], vbw[KPW];
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int sj = s0 + warp * KPW + jj;
      const long long off = cbase + sj * a.c_s + lane * 4;
      const bool ok = sj < a.S;
      kw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.k + off)) : 0u;
      vw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.v + off)) : 0u;
      if (BRIDGE) {
        kbw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.kb + off)) : 0u;
        vbw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.vb + off)) : 0u;
      }
    }
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int j = warp * KPW + jj, sj = s0 + j;
      const bool ok = sj < a.S;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Vs[j * D + lane * 4 + e] = byte_f32(vw[jj], e);
        if (BRIDGE) VBs[j * D + lane * 4 + e] = byte_f32(vbw[jj], e);
      }
      const float ksc = ok ? a.ks[sbase + sj] : 0.f;
      const float kbsc = (BRIDGE && ok) ? a.kbs[sbase + sj] : 0.f;
      const uint8_t fk = ok ? fkv[sj] : 0;
      for (int n = 0; n < N; ++n) {
        const float* qr = Qs + n * D + lane * 4;
        float d = 0.f, db = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d = fmaf(qr[e], byte_f32(kw[jj], e), d);
          if (BRIDGE) db = fmaf(qr[e], byte_f32(kbw[jj], e), db);
        }
        d = warp_sum(d);
        if (BRIDGE) db = warp_sum(db);
        if (lane == 0) {
          float x = -INFINITY;   // past the last key: probability 0
          if (ok) {
            x = d * ksc * a.scale;
            if (BRIDGE && fq[n] != fk) x += db * kbsc * a.scale;
            x = fmaxf(x + a.bias[b * a.bias_b + n * a.bias_n + sj], BIG_NEG);
          }
          Ss[n * BS + j] = x;
        }
      }
    }
    __syncthreads();

    // --- online softmax: warp w owns rows w, w + 8, ...; lane j is key j ---
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int n = warp + WARPS * i;
      if (n >= N) continue;   // the warp's remaining rows are past N too
      const int sj = s0 + lane;
      const bool ok = sj < a.S;
      const float x = Ss[n * BS + lane];
      const float m_new = fmaxf(m_run[i], warp_max(x));
      const float alpha = expf(m_run[i] - m_new);   // both finite
      const float p = expf(x - m_new);              // 0 past the last key
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
      Ps[n * BS + lane] = ok ? p * a.vs[sbase + sj] : 0.f;
      if (BRIDGE)
        PBs[n * BS + lane] = (ok && fq[n] != fkv[sj]) ? p * a.vbs[sbase + sj] : 0.f;
      if (lane == 0) Al[n] = alpha;
    }
    __syncthreads();

    // --- values: column `col` of every row, keys of this thread's half ---
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        float t = acc[n] * Al[n];
#pragma unroll 4
        for (int j = half; j < BS; j += 2) {
          t = fmaf(Ps[n * BS + j], Vs[j * D + col], t);
          if (BRIDGE) t = fmaf(PBs[n * BS + j], VBs[j * D + col], t);
        }
        acc[n] = t;
      }
    }
  }

  // --- add the two halves, divide by the row sums, store bf16 ---
  __syncthreads();   // Q and the last tile are no longer read
  float* Hs = Qs;    // odd-key half sums, NMAX x D
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int n = warp + WARPS * i;
    if (n < N && lane == 0) Al[n] = l_run[i];
  }
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) Hs[n * D + col] = acc[n];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        const float o = (acc[n] + Hs[n * D + col]) / Al[n];
        a.out[(((long long)b * N + n) * a.H + h) * D + col] = __float2bfloat16(o);
      }
    }
  }
}

template <int NMAX, bool BRIDGE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_floats<NMAX>(BRIDGE) * sizeof(float);
  auto kernel = decode_attention_kernel<NMAX, BRIDGE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, B), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t launch_n(const Args& a, int B, cudaStream_t stream) {
  return a.kb != nullptr ? launch<NMAX, true>(a, B, stream)
                         : launch<NMAX, false>(a, B, stream);
}

}  // namespace

// q (B, N, H, 128) bf16; k/v/kb/vb (B, H, S, 128) int8 with one layout,
// unit stride in the head dim, row stride a multiple of 4 bytes; ks/vs/
// kbs/vbs (B, H, S) fp32 with one layout, unit stride in S; kb/vb/kbs/vbs
// null without the bridge; flag_q (B, N) and flag_kv (B, S) uint8
// contiguous; bias (B, N, S) fp32, unit stride in S; out (B, N, H, 128)
// bf16 contiguous; N <= 64.
// strides: 10 element strides, in order
//   q (b, n, h), cache (b, h, s), scales (b, h), bias (b, n).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int int8_decode_attention(
    const void* q, const void* k, const void* v, const void* kb,
    const void* vb, const void* ks, const void* vs, const void* kbs,
    const void* vbs, const void* flag_q, const void* flag_kv,
    const void* bias, void* out, const long long* strides, int B, int N,
    int S, int H, float scale, void* stream) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.kb = static_cast<const int8_t*>(kb);
  a.vb = static_cast<const int8_t*>(vb);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.kbs = static_cast<const float*>(kbs);
  a.vbs = static_cast<const float*>(vbs);
  a.flag_q = static_cast<const uint8_t*>(flag_q);
  a.flag_kv = static_cast<const uint8_t*>(flag_kv);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_b = strides[0];
  a.q_n = strides[1];
  a.q_h = strides[2];
  a.c_b = strides[3];
  a.c_h = strides[4];
  a.c_s = strides[5];
  a.s_b = strides[6];
  a.s_h = strides[7];
  a.bias_b = strides[8];
  a.bias_n = strides[9];
  a.N = N;
  a.S = S;
  a.H = H;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 8) return (int)launch_n<8>(a, B, st);
  return (int)launch_n<64>(a, B, st);
}
