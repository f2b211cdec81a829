// The int4 decode-matvec experiment's weight-only kernels D and C for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/exp_int4.py::main, build_d
// (mode 0) and build_c (mode 1): for the M <= 8 rows of x against one layer
// of a stacked group-int4 buffer, out (8, F) fp32, rows >= M zero:
//
//   D: out[m, o] = sum_r xe[m, r] * bf16(u0[r, o] * sh[g(r), o])
//                + xo[m, r] * bf16(q1[r, o] * sh[g(r), o])
//                - 8 * sum_g bf16(cg[m, g]) * sh[g, o],     sh = bf16(s)
//   C: out[m, o] = sum_g s[g, o] * sum_{r in g} (xe[m, r] * u0[r, o] + xo[m, r] * q1[r, o])
//                - 8 * sum_g cg[m, g] * s[g, o]
//
// with byte r of column o holding u0 = q[2r] + 8 in its low nibble (b & 15)
// and q1 = q[2r + 1] in its high one (b >> 4, arithmetic), xe and xo the
// even and odd columns of x, and cg[m, g] the fp32 sum of xe over group g.
// bf16() rounds to nearest even; u0 * sh and q1 * sh are exact in fp32, so
// D's weights are its TPU kernel's bf16 products. Everything else is fp32.
// The TPU kernel's host-side prep (x padded to 8 rows, split into even and
// odd columns, the group sums) is done here, from x and M. The W16 flag is
// the experiment's int16 unpack (build_d's wdt): the nibbles are taken from
// int16_t values. The card's integer registers are 32 bits wide, so nvcc
// may emit the same instructions; the result is the same.
//
// What bounds it on this card: reading the packed weights (K/2 bytes a
// column) and the fp32 scales from device memory, 23.95 MB at K = 4096,
// F = 11008, G = 128 (7.15 us at 3.35 TB/s). Each byte feeds 2 * M
// multiply-adds plus its unpack (and in D two bf16 roundings).
//
// Design (simple first; no tensor cores): the layout of csrc/int4_matmul.cu.
// One block per 32 output columns (344 blocks at F = 11008), 256 threads =
// 8 column groups of 4 adjacent columns x 32 k-slices. Each block first sums
// the groups of x's even columns into shared memory (one warp per row and
// group), then stages x through shared memory in chunks of 512 k as fp32,
// so the 8 x 4096 bf16 rows never have to fit at once; each thread loads
// its 8 consecutive byte rows of the chunk (4 bytes, 4 columns, a row)
// before using any. The warps' partial sums meet in shared memory, and the
// thread that writes an output adds its bias correction over the groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BP = 8;             // rows of the result
constexpr int BF = 32;            // output columns per block
constexpr int CPT = 4;            // adjacent columns per thread
constexpr int CG = BF / CPT;      // column groups: 8
constexpr int KS = THREADS / CG;  // k-slices: 32
constexpr int KC = 512;           // k per staged x chunk
constexpr int RC = KC / 2;        // byte rows per chunk
constexpr int RPT = RC / KS;      // byte rows per thread per chunk: 8
constexpr int MAX_GROUPS = 256;   // K / G (the wrapper checks)

struct Args {
  const __nv_bfloat16* x;
  long long ldx;
  const int8_t* p;
  long long ldp;
  const float* s;
  long long lds;
  float* out;
  long long ldo;
  int M, K, F, G;
};

__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The two nibbles of byte c of w: u0 = q[2r] + 8 and q1 = q[2r + 1].
template <bool W16>
__device__ __forceinline__ void nibbles(uint32_t w, int c, float& u0, float& q1) {
  if constexpr (W16) {
    const int16_t b = (int16_t)(int8_t)(uint8_t)(w >> (8 * c));
    u0 = (float)(int16_t)(b & (int16_t)15);
    q1 = (float)(int16_t)(b >> 4);
  } else {
    const int b = (int)(int8_t)(uint8_t)(w >> (8 * c));
    u0 = (float)(b & 15);
    q1 = (float)(b >> 4);
  }
}

template <int MT, bool C, bool W16>
__global__ void __launch_bounds__(THREADS) int4_exp_kernel(const Args a) {
  // the x chunk in fp32; after the loop, the warps' partial sums
  __shared__ float xs[MT * KC];
  __shared__ float cg[MT * MAX_GROUPS];   // group sums of x's even columns

  const int tid = threadIdx.x;
  const int cgi = tid % CG;
  const int ks = tid / CG;
  const int f0 = blockIdx.x * BF + cgi * CPT;
  const int warp = tid / 32, lane = tid % 32;
  const int Kh = a.K / 2, NG = a.K / a.G, gh = a.G / 2;

  for (int i = warp; i < MT * NG; i += WARPS) {
    const int m = i / NG, g = i % NG;
    float t = 0.f;
    if (m < a.M)
      for (int j = lane; j < gh; j += 32)
        t += __bfloat162float(a.x[m * a.ldx + g * a.G + 2 * j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) cg[i] = t;
  }

  float acc[MT][CPT];
  float part[MT][CPT];   // C: the current group's sums
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = part[m][c] = 0.f;
  float sc[CPT];         // the current group's scales (D: rounded to bf16)
  int gcur = -1;

  for (int k0 = 0; k0 < a.K; k0 += KC) {
    __syncthreads();   // the previous chunk is consumed
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int m = i / KC, k = k0 + i % KC;
      xs[i] = m < a.M && k < a.K ? __bfloat162float(a.x[m * a.ldx + k]) : 0.f;
    }
    const int r0 = k0 / 2 + ks * RPT;   // this thread's first byte row
    uint32_t w[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      w[i] = r0 + i < Kh && f0 < a.F
                 ? __ldg(reinterpret_cast<const uint32_t*>(a.p + (long long)(r0 + i) * a.ldp + f0))
                 : 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      if (r >= Kh) break;   // and so are the rest: past the last row
      const int g = r / gh;
      if (g != gcur) {
        if (C && gcur >= 0) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              acc[m][c] += part[m][c] * sc[c];
              part[m][c] = 0.f;
            }
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float v = f0 < a.F ? __ldg(a.s + (long long)g * a.lds + f0 + c) : 0.f;
          sc[c] = C ? v : bf16_rn(v);
        }
        gcur = g;
      }
      float wl[CPT], wh[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        nibbles<W16>(w[i], c, wl[c], wh[c]);
        if (!C) {
          wl[c] = bf16_rn(wl[c] * sc[c]);
          wh[c] = bf16_rn(wh[c] * sc[c]);
        }
      }
      const int kk = 2 * (ks * RPT + i);   // k of the even weight, in the chunk
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xe = xs[m * KC + kk], xo = xs[m * KC + kk + 1];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float& t = C ? part[m][c] : acc[m][c];
          t = fmaf(xe, wl[c], fmaf(xo, wh[c], t));
        }
      }
    }
  }
  if (C && gcur >= 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[m][c] += part[m][c] * sc[c];
  }

  // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same columns
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
      for (int c = 0; c < CPT; ++c) xs[(warp * MT + m) * BF + lane * CPT + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < BP * BF; i += THREADS) {
    const int m = i / BF, col = i % BF;
    const int f = blockIdx.x * BF + col;
    if (f >= a.F) continue;
    float t = 0.f;
    if (m < MT && m < a.M) {
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) t += xs[(wi * MT + m) * BF + col];
      float corr = 0.f;
      for (int g = 0; g < NG; ++g) {
        const float sv = __ldg(a.s + (long long)g * a.lds + f), cv = cg[m * NG + g];
        corr = C ? fmaf(cv, sv, corr) : fmaf(bf16_rn(cv), bf16_rn(sv), corr);
      }
      t -= 8.f * corr;
    }
    a.out[m * a.ldo + f] = t;
  }
}

template <int MT>
cudaError_t launch(const Args& a, int mode, bool w16, cudaStream_t stream) {
  const dim3 grid((a.F + BF - 1) / BF);
  if (mode == 1)
    int4_exp_kernel<MT, true, false><<<grid, THREADS, 0, stream>>>(a);
  else if (w16)
    int4_exp_kernel<MT, false, true><<<grid, THREADS, 0, stream>>>(a);
  else
    int4_exp_kernel<MT, false, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, row stride ldx, unit stride in K, M <= 8; packed (K/2, F)
// int8 (one layer), row stride ldp, 4-byte aligned, F % 4 == 0; scales
// (K/G, F) fp32, row stride lds; out (8, F) fp32, row stride ldo. G even,
// K % G == 0, K / G <= 256 (the wrapper checks). mode 0 runs D (w16: the
// int16 unpack), mode 1 runs C. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int int4_exp(const void* x, long long ldx, const void* packed, long long ldp,
                        const void* scales, long long lds, void* out, long long ldo,
                        int M, int K, int F, int G, int mode, int w16, void* stream) {
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ldx = ldx;
  a.p = static_cast<const int8_t*>(packed);
  a.ldp = ldp;
  a.s = static_cast<const float*>(scales);
  a.lds = lds;
  a.out = static_cast<float*>(out);
  a.ldo = ldo;
  a.M = M;
  a.K = K;
  a.F = F;
  a.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return (int)launch<4>(a, mode, w16 != 0, st);
  return (int)launch<BP>(a, mode, w16 != 0, st);
}
