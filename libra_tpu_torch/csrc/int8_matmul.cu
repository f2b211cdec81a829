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
// What bounds it on this card: at decode (M = 4) every weight byte is read
// once and used for M multiply-adds, so reading q from device memory is the
// limit (a 4096 x 11008 projection is 45 MB: about 15 us at 3 TB/s).
//
// Design (simple first; no tensor cores):
//   * one block per (32 output columns, MT rows of x); 256 threads, each
//     owning 4 adjacent columns (one 4-byte load of q per k row) and one of
//     32 k-slices, so a warp reads 4 rows x 32 contiguous bytes;
//   * x is staged through shared memory in chunks of 512 k as fp32; each
//     thread issues its 16 weight loads of a chunk before using any, to
//     keep bytes in flight;
//   * MT is 4, 8 or 16 (the smallest that covers M, tiled above 16), so
//     decode does no multiply-adds on padding rows;
//   * the 32 k-slices are summed with warp shuffles, then across the 8 warps
//     through shared memory; the scale is applied once per output;
//   * ragged M, K and F are masked in the kernel; without 4-byte aligned
//     rows the weight loads go byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// x (M, K) bf16, row stride ldx, unit stride in K; q (K, F) int8, row
// stride ldq, unit stride in F; scale (F,) fp32 contiguous; out (M, F)
// bf16, row stride ldo. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int int8_matmul(const void* x, long long ldx, const void* q,
                           long long ldq, const void* scale, void* out,
                           long long ldo, int M, int K, int F, void* stream) {
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
  const bool vec = F % CPT == 0 && ldq % CPT == 0 &&
                   reinterpret_cast<uintptr_t>(q) % CPT == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return (int)launch_mt<4>(a, vec, st);
  if (M <= 8) return (int)launch_mt<8>(a, vec, st);
  return (int)launch_mt<16>(a, vec, st);
}
