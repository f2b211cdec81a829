// The int4 decode-matvec experiment's W4A8 kernels E, H and F for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of tools/exp_int4.py::main, build_e and
// _a8_fn (bodies build_h and build_f). All of them compute one function of
// the M <= 8 rows of x against one layer of a stacked group-int4 buffer,
// out (bp, F) fp32 with bp = 8 or 32, rows >= M zero:
//
//   xs[m]  = absmax_k |x[m, k]| / 127, or 1 for a zero row
//   xq     = clip(rint(x / xs), -127, 127)                  (half to even)
//   d      = sum_{r in g} xe[m, r] * u0[r, o] + xo[m, r] * q1[r, o]  (exact int)
//   out[m, o] = (sum_g d * s[g, o] - 8 * sum_g cg[m, g] * s[g, o]) * xs[m]
//
// with byte r of column o holding u0 = q[2r] + 8 in its low nibble and
// q1 = q[2r + 1] in its high one (the signed byte b = 16 * q1 + u0), xe and xo
// the even and odd columns of xq, and cg[m, g] the sum of xe over group g
// (an exact integer). The group loop and the fp32 sums are
// those of csrc/int4_matmul.cu's W4A8 mode; the result stays fp32, and the
// +8 low-nibble bias comes off at the end, as in csrc/int4_exp.cu's C.
//
// The rows differ only in how they take the nibbles out of the bytes, which
// is the experiment's question, so each keeps its own unpack (template
// flags):
//   * I8MASK (E; H and F with i8mask): on the whole 32-bit word, 4 bytes an
//     op: u0 x 4 = w & 0x0F0F0F0F, and q1 x 4 as the high nibbles moved
//     down and sign-extended inside their bytes (t ^ 8) - 8 (__vsub4).
//   * otherwise (H, F): each byte sign-extended to 32 bits, then b & 15 and
//     b >> 4 (arithmetic).
//   * LOW_ONLY (F, FM8): q1 is never unpacked. xo * q1 = (xo * b - xo * u0)
//     / 16, so the kernel sums (16 xe - xo) * u0 + xo * b = 16 d per group
//     in int32 and shifts the sum right by 4: exact, since it is a multiple
//     of 16.
//
// x's quantization is the TPU kernel's host prep, moved into the kernel:
// each block takes the absmax of its rows over K in a prologue (from L2),
// quantizes each staged chunk of x with IEEE division and rint, so xq is
// bitwise the reference's, and adds the chunk's share of the group sums cg
// from the staged chunk, rather than in a prologue pass over x that would
// repeat the divisions before the first weight load.
//
// What bounds it on this card: reading the packed weights (K/2 bytes a
// column) and the fp32 scales, 23.95 MB at K = 4096, F = 11008, G = 128
// (7.15 us at 3.35 TB/s); each byte feeds 2 * M integer multiply-adds plus
// its unpack.
//
// Design (simple first; integer multiply-adds, no dp4a, no tensor cores):
// csrc/int4_matmul.cu's layout. One block per 32 output columns (344 blocks
// at F = 11008), 256 threads = 8 column groups of 4 adjacent columns x 32
// k-slices; the quantized x is staged through shared memory in chunks of
// 512 k as exact integers; each thread loads its 8 consecutive byte rows of
// the chunk (4 bytes, 4 columns, a row) before using any, keeps an int32
// partial sum per (row, column) for the current group and folds it into an
// fp32 accumulator with the group scale when its rows cross into the next
// group. Only the MT = 4 or 8 live rows are computed; the warps' partial
// sums meet in shared memory, and the thread that writes an output takes
// off its bias correction over the groups and applies xs. At MT = 4 the
// registers are held to 80 a thread (__launch_bounds__), so 3 blocks fit on
// an SM and the 344 blocks run in one wave (at 98 they took two).

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
  int M, K, F, G, bp;
};

// x's element quantized with its row's scale: clip(rint(v / xs), -127, 127).
__device__ __forceinline__ int quant(__nv_bfloat16 v, float xs) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(__bfloat162float(v), xs)), -127.f), 127.f);
}

// The 4 bytes of w as (lo, hi) pairs: lo = u0 in [0, 16); hi = q1, or under
// LOW_ONLY the raw signed byte b.
template <bool I8MASK, bool LOW_ONLY>
__device__ __forceinline__ void unpack(uint32_t w, int (&lo)[CPT], int (&hi)[CPT]) {
  if constexpr (I8MASK) {
    const uint32_t u4 = w & 0x0F0F0F0Fu;
    const uint32_t h4 =
        LOW_ONLY ? w : __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      lo[c] = (int)((u4 >> (8 * c)) & 0xFFu);
      hi[c] = (int)(int8_t)(uint8_t)(h4 >> (8 * c));
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int b = (int)(int8_t)(uint8_t)(w >> (8 * c));
      lo[c] = b & 15;
      hi[c] = LOW_ONLY ? b : b >> 4;
    }
  }
}

template <int MT, bool I8MASK, bool LOW_ONLY>
__global__ void __launch_bounds__(THREADS, MT <= 4 ? 3 : 1) int4_exp_a8_kernel(const Args a) {
  __shared__ int xq[MT * KC];                  // the quantized x chunk
  __shared__ float red[WARPS * MT * BF];       // the warps' partial sums
  __shared__ int cg[MT * MAX_GROUPS];          // group sums of xq's even columns
  __shared__ float sx[MT];                     // row scales

  const int tid = threadIdx.x;
  const int cgi = tid % CG;
  const int ks = tid / CG;
  const int f0 = blockIdx.x * BF + cgi * CPT;
  const int warp = tid / 32, lane = tid % 32;
  const int Kh = a.K / 2, NG = a.K / a.G, gh = a.G / 2;

  for (int m = warp; m < MT; m += WARPS) {
    float amax = 0.f;
    if (m < a.M)
      for (int k = lane; k < a.K; k += 32)
        amax = fmaxf(amax, fabsf(__bfloat162float(a.x[m * a.ldx + k])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) sx[m] = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  }
  for (int i = tid; i < MT * NG; i += THREADS) cg[i] = 0;

  float acc[MT][CPT];
  int part[MT][CPT];   // the current group's sums (LOW_ONLY: 16 times them)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] = 0.f;
      part[m][c] = 0;
    }
  int gcur = -1;   // the group `part` belongs to

  auto flush = [&](int g) {
    float sc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      sc[c] = f0 < a.F ? __ldg(a.s + (long long)g * a.lds + f0 + c) : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = LOW_ONLY ? part[m][c] >> 4 : part[m][c];
        acc[m][c] = fmaf((float)d, sc[c], acc[m][c]);
        part[m][c] = 0;
      }
  };

  for (int k0 = 0; k0 < a.K; k0 += KC) {
    __syncthreads();   // the previous chunk is consumed (and sx is written)
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int m = i / KC, k = k0 + i % KC;
      xq[i] = m < a.M && k < a.K ? quant(a.x[m * a.ldx + k], sx[m]) : 0;
    }
    const int r0 = k0 / 2 + ks * RPT;   // this thread's first byte row
    uint32_t w[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      w[i] = r0 + i < Kh && f0 < a.F
                 ? __ldg(reinterpret_cast<const uint32_t*>(a.p + (long long)(r0 + i) * a.ldp + f0))
                 : 0u;
    __syncthreads();
    {
      // the chunk's share of cg: one warp per (row, group it touches)
      const int kend = min(k0 + KC, a.K), ga = k0 / a.G, ng = (kend - 1) / a.G - ga + 1;
      for (int it = warp; it < MT * ng; it += WARPS) {
        const int m = it / ng, g = ga + it % ng;
        const int kb = max(k0, g * a.G) - k0, ke = min(kend, (g + 1) * a.G) - k0;
        int t = 0;
        for (int k = kb + 2 * lane; k < ke; k += 64) t += xq[m * KC + k];
        t = __reduce_add_sync(0xffffffffu, t);
        if (lane == 0) cg[m * NG + g] += t;
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      if (r >= Kh) break;   // and so are the rest: past the last row
      const int g = r / gh;
      if (g != gcur) {
        if (gcur >= 0) flush(gcur);
        gcur = g;
      }
      int lo[CPT], hi[CPT];
      unpack<I8MASK, LOW_ONLY>(w[i], lo, hi);
      const int kk = 2 * (ks * RPT + i);   // k of the even weight, in the chunk
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int xe = xq[m * KC + kk], xo = xq[m * KC + kk + 1];
        const int xl = LOW_ONLY ? 16 * xe - xo : xe;
#pragma unroll
        for (int c = 0; c < CPT; ++c) part[m][c] += xl * lo[c] + xo * hi[c];
      }
    }
  }
  if (gcur >= 0) flush(gcur);

  // lanes l, l ^ 8, l ^ 16, l ^ 24 hold the same columns
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 8);
      acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], 16);
    }
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < CPT; ++c) red[(warp * MT + m) * BF + lane * CPT + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < a.bp * BF; i += THREADS) {
    const int m = i / BF, col = i % BF;
    const int f = blockIdx.x * BF + col;
    if (f >= a.F) continue;
    float t = 0.f;
    if (m < MT && m < a.M) {
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) t += red[(wi * MT + m) * BF + col];
      float corr = 0.f;
      for (int g = 0; g < NG; ++g)
        corr = fmaf((float)cg[m * NG + g], __ldg(a.s + (long long)g * a.lds + f), corr);
      t = (t - 8.f * corr) * sx[m];
    }
    a.out[m * a.ldo + f] = t;
  }
}

template <int MT>
cudaError_t launch(const Args& a, bool i8mask, bool low_only, cudaStream_t stream) {
  const dim3 grid((a.F + BF - 1) / BF);
  if (i8mask && low_only)
    int4_exp_a8_kernel<MT, true, true><<<grid, THREADS, 0, stream>>>(a);
  else if (i8mask)
    int4_exp_a8_kernel<MT, true, false><<<grid, THREADS, 0, stream>>>(a);
  else if (low_only)
    int4_exp_a8_kernel<MT, false, true><<<grid, THREADS, 0, stream>>>(a);
  else
    int4_exp_a8_kernel<MT, false, false><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, row stride ldx, unit stride in K, M <= 8; packed (K/2, F)
// int8 (one layer), row stride ldp, 4-byte aligned, F % 4 == 0; scales
// (K/G, F) fp32, row stride lds; out (bp, F) fp32, row stride ldo, M <= bp.
// G even, K % G == 0, K / G <= 256 (the wrapper checks). i8mask: the unpack
// on whole words (E, and the i8mask rows); low_only: F's low-nibble-only
// sums. Returns the CUDA error code of the launch (0 = launched).
extern "C" int int4_exp_a8(const void* x, long long ldx, const void* packed, long long ldp,
                           const void* scales, long long lds, void* out, long long ldo,
                           int M, int K, int F, int G, int bp, int i8mask, int low_only,
                           void* stream) {
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
  a.bp = bp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return (int)launch<4>(a, i8mask != 0, low_only != 0, st);
  return (int)launch<8>(a, i8mask != 0, low_only != 0, st);
}
