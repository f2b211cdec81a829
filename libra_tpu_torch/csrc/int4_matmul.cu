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
// What bounds it on this card: at decode (M = 4) reading the packed weights
// from device memory (half the int8 bytes); each byte feeds 2 * M
// multiply-adds plus its unpack.
//
// Design (simple first; no tensor cores, no dp4a): the int8 kernel's
// (csrc/int8_matmul.cu) layout, with byte rows in place of k rows: one block
// per (32 output columns, MT rows of x), 256 threads = 8 column groups of 4
// adjacent columns x 32 k-slices; x is staged through shared memory in
// chunks of 512 k (quantized there in W4A8 mode); each thread owns 8
// consecutive byte rows of a chunk, loads them all before using any, and
// folds its per-group partial sums into the accumulator with the group
// scale whenever its rows cross into the next group. In W4A8 mode each block
// first takes the absmax of its MT rows of x over all of K (from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

}  // namespace

// x (M, K) bf16, row stride ldx, unit stride in K; packed (K/2, F) int8,
// row stride ldp; scales (K/G, F) fp32, row stride lds; out (M, F) bf16,
// row stride ldo. K and G even, K % G == 0 (the wrapper checks). a8: run
// W4A8. Returns the CUDA error code of the launch (0 = launched).
extern "C" int int4_matmul(const void* x, long long ldx, const void* packed,
                           long long ldp, const void* scales, long long lds,
                           void* out, long long ldo, int M, int K, int F,
                           int G, int a8, void* stream) {
  Args a;
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
  const bool vec = F % CPT == 0 && ldp % CPT == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % CPT == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return (int)launch_mt<4>(a, vec, a8 != 0, st);
  if (M <= 8) return (int)launch_mt<8>(a, vec, a8 != 0, st);
  return (int)launch_mt<16>(a, vec, a8 != 0, st);
}
