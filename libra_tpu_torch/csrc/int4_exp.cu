// The int4 decode-matvec experiment's kernels for Hopper (sm_90a): the
// weight-only D and C, and the W4A8 function of E, H and F.
//
// Replaces the Pallas TPU kernels of tools/exp_int4.py::main: build_d
// (mode 0), build_c (mode 1), build_e and _a8_fn (bodies build_h and
// build_f). Each computes, for the M <= 8 rows of x against one layer of a
// stacked group-int4 buffer, out (bp, F) fp32, rows >= M zero (bp = 8; the
// W4A8 rows also take bp = 32, the experiment's F32R):
//
//   D: out[m, o] = sum_r xe[m, r] * bf16(u0[r, o] * sh[g(r), o])
//                + xo[m, r] * bf16(q1[r, o] * sh[g(r), o])
//                - 8 * sum_g bf16(cg[m, g]) * sh[g, o],     sh = bf16(s)
//   C: out[m, o] = sum_g s[g, o] * sum_{r in g} (xe[m, r] * u0[r, o] + xo[m, r] * q1[r, o])
//                - 8 * sum_g cg[m, g] * s[g, o]
//   W4A8 (E, H, F):
//        xs[m]  = absmax_k |x[m, k]| / 127, or 1 for a zero row
//        xq     = clip(rint(x / xs), -127, 127)                  (half to even)
//        out[m, o] = (sum_g d[m, g, o] * s[g, o] - 8 * sum_g cq[m, g] * s[g, o]) * xs[m],
//        d = sum_{r in g} xqe[m, r] * u0[r, o] + xqo[m, r] * q1[r, o]  (exact integers)
//
// with byte r of column o holding u0 = q[2r] + 8 in its low nibble (b & 15)
// and q1 = q[2r + 1] in its high one (b >> 4, arithmetic), xe and xo (xqe,
// xqo) the even and odd columns of x (of xq), cg[m, g] the fp32 sum of xe
// over group g and cq[m, g] the integer sum of xqe. bf16() rounds to
// nearest even; u0 * sh and q1 * sh are exact in fp32, so D's weights are
// its TPU kernel's bf16 products. Everything else is fp32. The TPU
// kernels' host-side prep (x padded to 8 rows, split into even and odd
// columns, the group sums; W4A8: x's quantization) is done here, from x
// and M. The W4A8 rows differ only in how they take the nibbles out of
// the bytes (E and the i8mask rows on the int8 bytes, H and F on bytes
// widened to int32; F never unpacks the high nibble), and D's two rows in
// the width of the unpack (W16): flags of the chunked templates. The
// decode template takes neither: the card's integer registers are 32 bits
// wide, so the int8-domain and the widened unpack are the same word
// operations, and F's saving (no high nibble) buys nothing where the high
// nibble costs one LOP3 a word, while F's raw byte would need a third
// product. The result is the same either way.
//
// What bounds them on this card: reading the packed weights (K/2 bytes a
// column) and the fp32 scales from device memory, 23.95 MB at K = 4096,
// F = 11008, G = 128 (7.15 us at 3.35 TB/s). Each byte feeds 2 * M
// multiply-adds plus its unpack (and in D two bf16 roundings), so these
// must cost a few instructions a byte or they, and not the bytes, set the
// time.
//
// Two templates of each function; int4_exp and int4_exp_a8 pick one per
// call (int4_exp_template, int4_exp_a8_template):
//
// * decode (M <= 8, G % 32 == 0, aligned operands: every call of the
//   experiment): the int8 matmul's decode template (csrc/int8_matmul.cu)
//   on the packed bytes, one kernel in three modes (D, C, W4A8). A block
//   takes a 128-column tile, and K is split into units of 16 byte rows (32
//   k) over the 8 blocks of a cluster and over 4 pairs of warps of each
//   block (the two warps of a pair take the two 64-column halves of the
//   tile), each pair a contiguous run of units (one group each at K =
//   4096, G = 128). The grid holds as many clusters as fit on the card at
//   once (2 blocks an SM, at most 128 registers a thread, no spills), and
//   each walks over column tiles, so a block stages its K slice of x in
//   shared memory once for all its tiles, its x loads issued before its
//   first weight loads. A warp loads a unit (16 byte rows of its 64
//   columns, 1 KB) and the unit's group scales as a batch,
//   ld.global.nc.L1::no_allocate for the bytes, each lane the words of 4
//   adjacent columns of 4 byte rows in each 32-column group; NBUF batches
//   in flight (the next one issued as one is used), and the next tile's
//   first NBUF batches before the current tile's reduction; there is no
//   barrier in the K loop. At the end of a tile the block sums its warps
//   in warp order and stores each sum into the receive buffer of the rank
//   that finishes its column (16 columns a rank); after one cluster
//   barrier each rank adds the 8 blocks' sums in rank order and writes
//   fp32, rows M .. bp - 1 as exact zeros. One launch, no workspace, no
//   atomics, a fixed order, so results repeat bit for bit. It needs
//   16-byte x and scale loads and 4-byte weight loads (ldx, lds, F, ldp and
//   the bases aligned to them), G % 32 == 0, and a K slice of x that fits
//   in shared memory.
//   - D and C, bf16 on the tensor cores: a byte holds the two k of one
//     column that one bf16x2 register of an mma.sync m16n8k16 A fragment
//     holds, and a word of x as stored (bf16) holds the two k of its B
//     register, so no data moves between lanes. Each byte becomes its bf16
//     pair without I2F: one XOR a word turns the high nibble into q1 + 8,
//     one mask and one shift-and-mask a word split the nibbles, one PRMT a
//     byte puts its two nibbles under the two halves (a sign-replicating
//     selector on a nibble byte gives 0x00), one OR makes them the bf16
//     values 128 + n, and one bf16x2 add takes {128, 136} off: {u0, q1}
//     for D, {q0, q1} for C (its +8 bias folded, so C needs no group sums
//     of x). D multiplies the pair by {sh, sh} with one bf16x2 multiply
//     that rounds once (the products are exact before it), its TPU
//     kernel's weights bit for bit. The products are exact in fp32, the
//     sums fp32. C multiplies a group's fp32 sums by the fp32 s[g, o] as
//     the warp's rows leave the group; D adds -8 * bf16(cg) * sh in fp32
//     in the warp that holds the group's first unit, with the block's cg
//     taken from x in its prologue.
//   - W4A8, u8 x s8 on the tensor cores (mma.sync m16n8k32): each block
//     takes its rows' absmax over its K slice, the cluster's 8 maxima meet
//     through distributed shared memory, and the block quantizes its slice
//     as the plain version does (IEEE division, rint), once for all its
//     tiles, into int8 in the order the B fragments read it, with each
//     unit's sum of xq per row. A lane's 4 words of a column group are
//     transposed (8 PRMT) into one word a column (its 4 byte rows), and
//     one mask a word gives u0 = q0 + 8, one shift and one LOP3 a word q1 +
//     8, each word one u8 A register: the low nibbles are the 4 even k of
//     the lane's slots, the high ones the 4 odd k, and x is staged with
//     the same order, so no data moves between lanes. A group's s32 sums
//     hold sum xq * (q + 8); 8 times the unit sums of xq over the k the
//     warp covered come off in int32, leaving sum xq * q exactly, which
//     becomes fp32 by a magic-number add (no I2F) and is multiplied by
//     s[g, o] as the warp's rows leave the group; the rank that finishes a
//     column multiplies by xs.
// * chunked (every other call; the only templates before the decode one,
//   exported alone as int4_exp_chunked and int4_exp_a8_chunked): no
//   tensor cores. One block per 32 output columns (344 blocks at F =
//   11008), 256 threads = 8 column groups of 4 adjacent columns x 32
//   k-slices; x is staged through shared memory in chunks of 512 k (fp32,
//   or W4A8 the quantized integers), so the 8 x 4096 bf16 rows never have
//   to fit at once; each thread loads its 8 consecutive byte rows of the
//   chunk (4 bytes, 4 columns, a row) before using any. The warps' partial
//   sums meet in shared memory, and the thread that writes an output adds
//   its bias correction over the groups. D and C: each block first sums the
//   groups of x's even columns (one warp per row and group). W4A8: each
//   block takes its rows' absmax over K in a prologue (from L2), quantizes
//   each staged chunk with IEEE division and rint, adds the chunk's share
//   of cq, keeps an int32 sum per (row, column) for the current group and
//   folds it into an fp32 accumulator with the group scale when its rows
//   cross into the next group; xs applies at the end. Its unpack flags:
//   I8MASK (E; H and F with i8mask) on the whole word, 4 bytes an op (u0 x
//   4 = w & 0x0F0F0F0F, q1 x 4 the high nibbles moved down and
//   sign-extended in their bytes, (t ^ 8) - 8 by __vsub4), otherwise each
//   byte sign-extended to 32 bits, then b & 15 and b >> 4; LOW_ONLY (F,
//   FM8) never unpacks q1: xo * q1 = (xo * b - xo * u0) / 16, so it sums
//   (16 xe - xo) * u0 + xo * b = 16 d in int32 and shifts right by 4.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace {

// ---------------------------------------------------------------------------
// The chunked templates (any G, M <= 8)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BP = 8;             // rows of the result (W4A8: bp, 8 or 32)
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
  unsigned long long gmagic;   // the decode template: ceil(2^32 / (G / 32))
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

// The W4A8 chunked template. At MT = 4 the registers are held to 80 a
// thread (__launch_bounds__), so 3 blocks fit on an SM and the 344 blocks
// run in one wave.
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
      // the chunk's share of cq: one warp per (row, group it touches)
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
cudaError_t launch_a8(const Args& a, bool i8mask, bool low_only, cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// The decode template (M <= 8, G % 32 == 0, aligned operands)
// ---------------------------------------------------------------------------

namespace dec {

namespace cg = cooperative_groups;
using splitk::ld_stream;
using splitk::prmt;
using splitk::warp_sum;

constexpr int MODE_D = 0;              // D (int4_exp mode 0)
constexpr int MODE_C = 1;              // C (int4_exp mode 1)
constexpr int MODE_A8 = 2;             // W4A8: E, H and F (int4_exp_a8)
constexpr int THREADS = 256;
constexpr int WARPS = 8;
constexpr int KWARPS = 4;              // warps of a block along K, each pair on both column halves
constexpr int BLOCKS_PER_SM = 2;       // the register cap: 128 a thread (at 3, 80 spills)
constexpr int NBUF = 2;                // load batches in flight a warp
constexpr int TILE = 128;              // output columns a block
constexpr int WCOLS = 64;              // output columns a warp: half the tile
constexpr int KSPLIT = 8;              // blocks of a cluster, one K slice each
constexpr int UNIT_ROWS = 16;          // byte rows of a slicing unit and of a load batch
constexpr int UNIT_K = 2 * UNIT_ROWS;  // k of a unit
constexpr int SLICES = KSPLIT * KWARPS;
constexpr int CPR = TILE / KSPLIT;     // output columns each rank finishes
constexpr int GROUPS = WCOLS / 32;     // column groups of a warp, 32 columns each
// A load batch: in each column group, the lane of mma group g and thread
// t (lane = 4 g + t) loads the 4 columns 4 g .. 4 g + 3 of the byte rows
// 4 t .. 4 t + 3 of the unit, so one warp load is 4 rows x 32 bytes and a
// batch 1 KB a warp, with the two float4 scales of its columns' group.
//
// D and C. A word w of 4 packed bytes (byte c = column c): u = w ^
// SIGN_FLIP holds q1 + 8 (0..15) in each high nibble and u0 in each low
// one; lo = u & NIB_MASK and hi = (u >> 4) & NIB_MASK are the nibbles as
// bytes. The selector SELc puts lo's byte c under the low half and hi's
// byte c under the high half of a word, with 0x00 above each (bit 3
// replicates the sign of a nibble byte: 0); OR BF16_128 makes the halves
// the bf16 128 + n; a bf16x2 add of OFFSET_D = {-128, -136} (low half
// first) gives {u0, q1}, of OFFSET_C = {-136, -136} {q0, q1}, all exact.
constexpr uint32_t SIGN_FLIP = 0x80808080u;
constexpr uint32_t NIB_MASK = 0x0F0F0F0Fu;
constexpr uint32_t SEL0 = 0xC480u;
constexpr uint32_t SEL1 = 0xD591u;
constexpr uint32_t SEL2 = 0xE6A2u;
constexpr uint32_t SEL3 = 0xF7B3u;
constexpr uint32_t BF16_128 = 0x43004300u;
constexpr uint32_t OFFSET_D = 0xC308C300u;
constexpr uint32_t OFFSET_C = 0xC308C308u;
constexpr uint32_t BF16_ONE = 0x3F803F80u;     // {1, 1}
constexpr uint32_t BF16_NEG_ZERO = 0x80008000u;
// W4A8. The lane's 4 words of a column group (word r: byte row 4 t + r)
// become one word a column by a 4x4 byte transpose: prmt(a, b, SEL_LO) =
// (a0, b0, a1, b1), SEL_HI = (a2, b2, a3, b3), then SEL_W0 takes the low
// halves of two words and SEL_W1 the high halves, so word c holds column
// 4 g + c, byte r its byte row 4 t + r. Of such a word, w & NIB_MASK is
// u0 = q0 + 8 of each byte and ((w >> 4) ^ HI_FLIP) & NIB_MASK is q1 + 8
// (the high nibble's sign bit flipped), both 0..15 as u8.
constexpr uint32_t SEL_LO = 0x5140u;
constexpr uint32_t SEL_HI = 0x7362u;
constexpr uint32_t SEL_W0 = 0x5410u;
constexpr uint32_t SEL_W1 = 0x7632u;
constexpr uint32_t HI_FLIP = 0x08080808u;
// x staged for the B fragments: prmt(a, b, XQ_PAIR) puts byte 0 of b
// above byte 0 of a; SEL_W0 then joins two such pairs into a word.
constexpr uint32_t XQ_PAIR = 0x0040u;
// An integer n with |n| < 2^22 as fp32 without I2F: MAGIC_I + n are the
// bits of the fp32 1.5 * 2^23 + n, and minus MAGIC_F that is n, exact.
// The same add rounds a float y with |y| < 2^22 to the nearest integer,
// ties to even, in the low bits: rint without F2I.
constexpr uint32_t MAGIC_I = 0x4B400000u;
constexpr float MAGIC_F = 12582912.0;
// The group sums stay exact through that add: |xq q| <= 127 * 8 = 1016, so
// a warp's sum over at most G k of a group is under 2^22 for G <= 4096.
constexpr int MAX_GROUP_A8 = 4096;
constexpr int SMEM_MAX = 160 * 1024;   // dynamic shared memory the template takes

static_assert(UNIT_ROWS == 16, "a batch is 4 byte rows for each of the 4 threads of an mma group");
static_assert(WARPS == 2 * KWARPS && 2 * WCOLS == TILE && GROUPS * 32 == WCOLS,
              "two warps of each K slice split the tile's columns in whole groups");
static_assert(1016 * MAX_GROUP_A8 < (1 << 22), "a W4A8 group sum converts exactly");

__host__ __device__ constexpr int k_stride(int K) {   // k of the largest K slice
  return UNIT_K * ((K / UNIT_K + KSPLIT - 1) / KSPLIT);
}
// The row stride of the staged x in elements (bf16, W4A8 also int8):
// k_stride, an odd multiple of 32 (64 bytes mod 128 in bf16, 32 in int8),
// so the 16-byte (bf16) and 8-byte (int8) loads of lanes of two (four)
// rows of x take different banks.
__host__ __device__ constexpr int x_stride(int K) { return k_stride(K) | 32; }
__host__ __device__ constexpr int slice_units(int K) { return k_stride(K) / UNIT_K; }

// Dynamic shared memory: the block's x slice as bf16 (MT, x_stride); then
// D's bf16-rounded group sums of x of the groups that start in the block
// (at most a group a unit, MT each), or W4A8's quantized slice (MT,
// x_stride) int8 and its unit sums of xq (units, MT) int32; the warps'
// fp32 sums (KWARPS, MT, TILE); two receive buffers of the cluster
// reduction (2, KSPLIT, MT, CPR), never shared: other blocks write them.
// The per-unit region holds a multiple of 4 units, so what follows it
// stays 16-byte aligned (the warps' sums take float2 stores) at any MT
// and an odd count of units a slice.
__host__ __device__ constexpr int aux_offset(int MT, int K) { return MT * x_stride(K) * 2; }
__host__ __device__ constexpr int sums_offset(int MT, int mode, int K) {   // 16-byte aligned
  return aux_offset(MT, K) + (mode == MODE_A8 ? MT * x_stride(K) : 0) +
         MT * ((slice_units(K) + 3) & ~3) * 4;
}
__host__ __device__ constexpr int recv_offset(int MT, int mode, int K) {
  return sums_offset(MT, mode, K) + KWARPS * MT * TILE * 4;
}
__host__ __device__ constexpr int smem_bytes(int MT, int mode, int K) {
  return recv_offset(MT, mode, K) + 2 * KSPLIT * MT * CPR * 4;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_dup(float s) {   // {bf16(s), bf16(s)}
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %1;\n" : "=r"(d) : "f"(s));
  return d;
}

// byte c (selector sel) of a word's nibbles lo, hi as a bf16 pair, minus off
__device__ __forceinline__ uint32_t nib_pair(uint32_t lo, uint32_t hi, uint32_t sel,
                                             uint32_t off) {
  return fma_bf16x2(prmt(lo, hi, sel) | BF16_128, BF16_ONE, off);
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

// Each cluster walks over column tiles blockIdx.x, + gridDim.x, ... (the
// launch starts as many clusters as fit on the card at once), so a block
// stages its K slice of x once for all its tiles, and the next tile's
// first weight batches are in flight during the current tile's reduction.
//
// The products run on the tensor cores, out = W^T x^T a tile of 16 columns
// by the 8 rows of x (MT of them live) at a time; C row g of an mma is
// column 32 j + 4 g + 2 p of the warp's half of the tile (column group j,
// column pair p), C row g + 8 the column after it. D and C: in the mma of
// column pair p and byte-row pair h, thread t's k slots 2 t, 2 t + 1 are
// the two k of byte row 4 t + 2 h (its low and its high nibble) and its
// slots 2 t + 8, 2 t + 9 those of byte row 4 t + 2 h + 1: so A comes from
// the bytes of the lane's own words (a0, a1: bytes 2 p, 2 p + 1 of row 4 t
// + 2 h; a2, a3: of the row after), and B from its own words of x (x row g
// at the k pairs of those two byte rows). W4A8: one m16n8k32 a column pair
// covers the unit; thread t's k slots 4 t .. 4 t + 3 are the even k of
// byte rows 4 t .. 4 t + 3 (their low nibbles) and its slots 4 t + 16 ..
// 4 t + 19 the odd k (the high nibbles): a0, a1 the low nibbles of
// columns 2 p and 2 p + 1, a2, a3 their high nibbles, and B x row g's
// 8 bytes at k 8 t .. 8 t + 7 of the unit, staged as its 4 even k, then
// its 4 odd k. Any assignment of k to slots gives the same sum when A and
// B agree on it, so no data moves between lanes.
template <int MT, int MODE>
__global__ void __cluster_dims__(1, KSPLIT, 1) __launch_bounds__(THREADS, BLOCKS_PER_SM)
    int4_exp_decode_kernel(const Args a) {
  constexpr bool C = MODE == MODE_C, D = MODE == MODE_D, A8 = MODE == MODE_A8;
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ float amax_s[MT], xsc_s[MT];   // W4A8: the block's row maxima; the rows' scales

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;                 // mma group, thread in it
  const int half = warp / KWARPS, kw = warp % KWARPS;   // column half, K slice
  const int U = a.K / UNIT_K;
  const int GU = a.G / UNIT_K;                          // units a group
  // u / GU without a division by a runtime count (the kernel has no I2F):
  // exact for u, GU < 2^16 (the host checks)
  auto group_of = [&](int u) { return (int)(((unsigned long long)u * a.gmagic) >> 32); };
  const int xstr = x_stride(a.K);
  const int ub = U * rank / KSPLIT;                     // the block's units
  const int nub = U * (rank + 1) / KSPLIT - ub;
  const int sl = rank * KWARPS + kw;                    // the warp's units
  const int u0 = U * sl / SLICES;
  const int nb = U * (sl + 1) / SLICES - u0;            // its batches
  const int gfirst = group_of(ub + GU - 1);             // the first group that starts in the block
  const int ntiles = (a.F + TILE - 1) / TILE;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dsm);               // (MT, xstr)
  float* cgs = reinterpret_cast<float*>(dsm + aux_offset(MT, a.K));        // D: (groups, MT)
  int8_t* xq = reinterpret_cast<int8_t*>(dsm + aux_offset(MT, a.K));      // W4A8: (MT, xstr)
  int* usum = reinterpret_cast<int*>(dsm + aux_offset(MT, a.K) + MT * xstr);  // W4A8: (units, MT)
  float* red = reinterpret_cast<float*>(dsm + sums_offset(MT, MODE, a.K));    // (KWARPS, MT, TILE)
  float* recv = reinterpret_cast<float*>(dsm + recv_offset(MT, MODE, a.K));   // (2, KSPLIT, MT, CPR)
  // this block has started: the others may write into its receive buffers
  // once they have waited on this arrival (W4A8 arrives once its row
  // maxima are in place, for the others to read)
  if constexpr (!A8) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // x first (from L2, 16 bytes a load: a thread's first of each row), then
  // the first tile's weights, then x into shared memory
  const __nv_bfloat16* xb = a.x + (long long)UNIT_K * ub;
  const int nv = UNIT_K * nub / 8;   // loads of x a row
  auto xload = [&](int m, int v) {
    return m < a.M ? __ldg(reinterpret_cast<const uint4*>(xb + (long long)m * a.ldx) + v)
                   : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 xr[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) xr[m] = tid < nv ? xload(m, tid) : make_uint4(0u, 0u, 0u, 0u);

  int tile = blockIdx.x;
  int fl = tile * TILE + WCOLS * half + 4 * g;   // the lane's first column in column group 0
  const int8_t* wp = a.p + ((long long)UNIT_ROWS * u0 + 4 * t) * a.ldp + fl;
  uint32_t wq[NBUF][GROUPS][4];   // [batch % NBUF][column group][byte row 4 t + r]
  float4 sq[NBUF][GROUPS];         // [batch % NBUF][column group]: the batch's group scales
  auto load = [&](uint32_t(&w)[GROUPS][4], float4(&s)[GROUPS], int b) {
    if (b >= nb) return;
    const float* sp = a.s + (long long)group_of(u0 + b) * a.lds + fl;
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const bool live = fl + 32 * j < a.F;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[j][r] = ld_stream(wp + (long long)(UNIT_ROWS * b + r) * a.ldp + 32 * j, live);
      s[j] = live ? __ldg(reinterpret_cast<const float4*>(sp + 32 * j))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
#pragma unroll
  for (int i = 0; i < NBUF; ++i) load(wq[i], sq[i], i);

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint4* d = reinterpret_cast<uint4*>(xs + m * xstr);
    if (tid < nv) d[tid] = xr[m];
    for (int v = tid + THREADS; v < nv; v += THREADS) d[v] = xload(m, v);
  }
  if constexpr (D) {
    // D: bf16(cg[m, g]) of the groups that start in this block (a group
    // may reach past the block's slice of x: from L2), one warp a group
    const int ng = group_of(ub + nub + GU - 1) - gfirst;
    for (int gl = warp; gl < ng; gl += WARPS) {
      const __nv_bfloat16* xg = a.x + (long long)(gfirst + gl) * a.G;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float s = 0.f;
        if (m < a.M)
          for (int i = lane; i < a.G / 2; i += 32) s += __bfloat162float(xg[m * a.ldx + 2 * i]);
        s = warp_sum(s);
        if (lane == 0) cgs[gl * MT + m] = __bfloat162float(__float2bfloat16_rn(s));
      }
    }
  }
  if constexpr (A8) {
    // each row's absmax over the block's slice, one warp a row, on the
    // bf16 bits: |x| is x & 0x7FFF, and non-negative values order as their
    // bits; then released to the cluster by the arrival
    __syncthreads();
    for (int m = warp; m < MT; m += WARPS) {
      uint32_t v = 0u;
      const uint4* r = reinterpret_cast<const uint4*>(xs + m * xstr);
      for (int i = lane; i < nv; i += 32) {
        const uint4 q = r[i];
        v = __vmaxu2(v, __vmaxu2(__vmaxu2(q.x & 0x7FFF7FFFu, q.y & 0x7FFF7FFFu),
                                 __vmaxu2(q.z & 0x7FFF7FFFu, q.w & 0x7FFF7FFFu)));
      }
      v = __reduce_max_sync(0xffffffffu, max(v & 0xFFFFu, v >> 16));
      if (lane == 0) amax_s[m] = __uint_as_float(v << 16);
    }
    __syncthreads();
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started
  if constexpr (A8) {
    // the rows' scales from the cluster's 8 maxima (the experiment's rule:
    // amax / 127, or 1 for a zero row), then the slice quantized as the
    // plain version does it, clip(rint(x / xs), -127, 127), each thread 8
    // k of a row (byte rows 4 (v % 4) .. + 3 of unit v / 4) stored as its 4
    // even k then its 4 odd k, and each unit's sum of xq per row (the 4
    // threads of a unit are adjacent lanes)
    if (tid < MT) {
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < KSPLIT; ++r) v = fmaxf(v, *cluster.map_shared_rank(&amax_s[tid], r));
      xsc_s[tid] = v > 0.f ? __fdiv_rn(v, 127.f) : 1.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float s = xsc_s[m];
      for (int v0 = 0; v0 < nv; v0 += THREADS) {
        const int v = v0 + tid;
        int sum = 0;
        if (v < nv) {
          const uint4 q = reinterpret_cast<const uint4*>(xs + m * xstr)[v];
          const uint32_t h[4] = {q.x, q.y, q.z, q.w};
          uint32_t b[8];   // the fp32 bits of 1.5 * 2^23 + xq
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float y = __uint_as_float(i % 2 ? h[i / 2] & 0xFFFF0000u : h[i / 2] << 16);
            b[i] = __float_as_uint(fminf(fmaxf(__fdiv_rn(y, s), -127.f), 127.f) + MAGIC_F);
            sum += (int)(b[i] - MAGIC_I);
          }
          *reinterpret_cast<uint2*>(xq + m * xstr + 8 * v) = make_uint2(
              prmt(prmt(b[0], b[2], XQ_PAIR), prmt(b[4], b[6], XQ_PAIR), SEL_W0),
              prmt(prmt(b[1], b[3], XQ_PAIR), prmt(b[5], b[7], XQ_PAIR), SEL_W0));
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (v < nv && v % 4 == 0) usum[v / 4 * MT + m] = sum;
      }
    }
    __syncthreads();
  }

  // this thread's x: row g, k 8 t of the warp's first unit (W4A8: its
  // bytes), and the unit sums of rows 2 t and 2 t + 1
  const __nv_bfloat16* xw = xs + g * xstr + UNIT_K * (u0 - ub) + 8 * t;
  const int8_t* xqw = xq + g * xstr + UNIT_K * (u0 - ub) + 8 * t;
  const int* usw = usum + (u0 - ub) * MT + 2 * t;
  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    // [column group][column pair][mma C fragment]: C and W4A8 the finished
    // groups' scaled sums, D the sums
    float acc[GROUPS][2][4];
    float part[GROUPS][2][4];   // C: the current group's sums
    int ipart[GROUPS][2][4];    // W4A8: the current group's sums of xq (q + 8)
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[j][p][c] = part[j][p][c] = 0.f;
          ipart[j][p][c] = 0;
        }
    int xsum0 = 0, xsum1 = 0;   // W4A8: the current group's sums of xq, rows 2 t, 2 t + 1
    auto step = [&](const uint32_t(&w)[GROUPS][4], const float4(&s)[GROUPS], int b) {
      const int u = u0 + b, grp = group_of(u);
      const bool leaves = u + 1 == (grp + 1) * GU || b + 1 == nb;   // the warp's rows leave the group
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      uint2 xv8 = make_uint2(0u, 0u);
      if constexpr (A8) {
        if (g < MT) xv8 = *reinterpret_cast<const uint2*>(xqw + UNIT_K * b);
        if constexpr (MT == 1) {
          if (t == 0) xsum0 += usw[b];
        } else if (2 * t < MT) {
          const int2 us = *reinterpret_cast<const int2*>(usw + MT * b);
          xsum0 += us.x;
          xsum1 += us.y;
        }
      } else {
        if (g < MT) xv = *reinterpret_cast<const uint4*>(xw + UNIT_K * b);
      }
#pragma unroll
      for (int j = 0; j < GROUPS; ++j) {
        if constexpr (A8) {
          const uint32_t t0 = prmt(w[j][0], w[j][1], SEL_LO), t1 = prmt(w[j][0], w[j][1], SEL_HI);
          const uint32_t t2 = prmt(w[j][2], w[j][3], SEL_LO), t3 = prmt(w[j][2], w[j][3], SEL_HI);
          const uint32_t col[4] = {prmt(t0, t2, SEL_W0), prmt(t0, t2, SEL_W1),
                                   prmt(t1, t3, SEL_W0), prmt(t1, t3, SEL_W1)};
          uint32_t lo[4], hi[4];   // [column 4 g + c]: u0 and q1 + 8 of its byte rows
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            lo[c] = col[c] & NIB_MASK;
            hi[c] = ((col[c] >> 4) ^ HI_FLIP) & NIB_MASK;
          }
#pragma unroll
          for (int p = 0; p < 2; ++p)
            mma_u8s8(ipart[j][p], lo[2 * p], lo[2 * p + 1], hi[2 * p], hi[2 * p + 1], xv8.x,
                     xv8.y);
          if (leaves) {
            // sum xq q = sum xq (q + 8) - 8 sum xq, exact; then as fp32
            // times the scales
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int n = ipart[j][p][c] - 8 * (c % 2 ? xsum1 : xsum0);
                acc[j][p][c] = fmaf(__uint_as_float(MAGIC_I + (uint32_t)n) - MAGIC_F,
                                    comp(s[j], 2 * p + c / 2), acc[j][p][c]);
                ipart[j][p][c] = 0;
              }
          }
        } else {
          uint32_t sh[4];   // D: {bf16(s), bf16(s)} of column 4 g + c
          if (D) {
            sh[0] = bf16x2_dup(s[j].x);
            sh[1] = bf16x2_dup(s[j].y);
            sh[2] = bf16x2_dup(s[j].z);
            sh[3] = bf16x2_dup(s[j].w);
          }
          uint32_t q[4][4];   // [byte row 4 t + r][column 4 g + c]: bf16 pairs
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t uw = w[j][r] ^ SIGN_FLIP;
            const uint32_t lo = uw & NIB_MASK, hi = (uw >> 4) & NIB_MASK;
            const uint32_t off = C ? OFFSET_C : OFFSET_D;
            q[r][0] = nib_pair(lo, hi, SEL0, off);
            q[r][1] = nib_pair(lo, hi, SEL1, off);
            q[r][2] = nib_pair(lo, hi, SEL2, off);
            q[r][3] = nib_pair(lo, hi, SEL3, off);
            if (D) {   // D's weights: bf16(u0 sh), bf16(q1 sh), one rounding
#pragma unroll
              for (int c = 0; c < 4; ++c) q[r][c] = fma_bf16x2(q[r][c], sh[c], BF16_NEG_ZERO);
            }
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            float(&d)[4] = *(C ? &part[j][p] : &acc[j][p]);
            mma_bf16(d, q[0][2 * p], q[0][2 * p + 1], q[1][2 * p], q[1][2 * p + 1], xv.x, xv.y);
            mma_bf16(d, q[2][2 * p], q[2][2 * p + 1], q[3][2 * p], q[3][2 * p + 1], xv.z, xv.w);
          }
          if (C && leaves) {
            // the warp's rows leave the group: its sums times the scales
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                acc[j][p][c] = fmaf(part[j][p][c], comp(s[j], 2 * p + c / 2), acc[j][p][c]);
                part[j][p][c] = 0.f;
              }
          }
          if (D && u == grp * GU) {
            // D: the group starts here; its bias correction, C columns 2 t
            // and 2 t + 1 are rows of x
            const float* cv = cgs + (grp - gfirst) * MT;
            const float c0 = 2 * t < MT ? -8.f * cv[2 * t] : 0.f;
            const float c1 = 2 * t + 1 < MT ? -8.f * cv[2 * t + 1] : 0.f;
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float sv = __uint_as_float(sh[2 * p + c / 2] << 16);
                acc[j][p][c] = fmaf(c % 2 ? c1 : c0, sv, acc[j][p][c]);
              }
          }
        }
      }
      if (A8 && leaves) xsum0 = xsum1 = 0;
    };
    for (int b0 = 0; b0 < nb; b0 += NBUF) {
#pragma unroll
      for (int i = 0; i < NBUF; ++i)
        if (b0 + i < nb) {
          step(wq[i], sq[i], b0 + i);
          load(wq[i], sq[i], b0 + i + NBUF);
        }
    }
    // this lane's sums into shared memory (the last tile's reads of them
    // ended before its cluster barrier): C row g is column 32 j + 4 g + 2 p
    // of the warp's half, row g + 8 the next; C columns 2 t and 2 t + 1 are
    // rows of x
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float* d = red + (kw * MT + 2 * t) * TILE + WCOLS * half + 32 * j + 4 * g + 2 * p;
        if (2 * t < MT) *reinterpret_cast<float2*>(d) = make_float2(acc[j][p][0], acc[j][p][2]);
        if (2 * t + 1 < MT)
          *reinterpret_cast<float2*>(d + TILE) = make_float2(acc[j][p][1], acc[j][p][3]);
      }

    // the next tile's first batches go out before this tile's reduction
    const int f = tile * TILE;   // this tile's first column
    if (tile + (int)gridDim.x < ntiles) {
      fl += gridDim.x * TILE;
      wp += gridDim.x * TILE;
#pragma unroll
      for (int i = 0; i < NBUF; ++i) load(wq[i], sq[i], i);
    }

    // the block's sums over its K slices, in warp order, sent to the rank
    // that finishes their columns: rank r, columns [CPR r, CPR (r + 1))
    __syncthreads();
    for (int i = tid; i < MT * TILE; i += THREADS) {
      const int m = i / TILE, c = i % TILE;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < KWARPS; ++w) s += red[w * MT * TILE + i];
      float* dst = cluster.map_shared_rank(recv, c / CPR);
      dst[((buf * KSPLIT + rank) * MT + m) * CPR + c % CPR] = s;
    }
    cluster.sync();
    // the cluster's sums, in rank order, from this block's receive buffer
    // (W4A8: times xs); every row of the (bp, F) result, rows >= M exactly 0
    for (int i = tid; i < a.bp * CPR; i += THREADS) {
      const int m = i / CPR, col = rank * CPR + i % CPR;
      float s = 0.f;
      if (m < MT) {
#pragma unroll
        for (int r = 0; r < KSPLIT; ++r) s += recv[((buf * KSPLIT + r) * MT + m) * CPR + i % CPR];
        if (A8) s *= xsc_s[m];
      }
      if (f + col < a.F) a.out[(long long)m * a.ldo + f + col] = m < a.M ? s : 0.f;
    }
  }
  // Nothing reads or writes another block's shared memory after the last
  // cluster.sync (the receive buffers alternate, and a block writes a
  // buffer again only after the cluster.sync that follows its last read;
  // W4A8's maxima are read before the first one).
}

template <int MT, int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  return splitk::launch_persistent<&int4_exp_decode_kernel<MT, MODE>, KSPLIT, THREADS, SMEM_MAX>(
      a, (a.F + TILE - 1) / TILE, smem_bytes(MT, MODE, a.K), stream);
}

template <int MODE>
cudaError_t launch_m(const Args& a, cudaStream_t st) {
  if (a.M <= 1) return launch<1, MODE>(a, st);
  if (a.M <= 2) return launch<2, MODE>(a, st);
  if (a.M <= 4) return launch<4, MODE>(a, st);
  return launch<8, MODE>(a, st);
}

}  // namespace dec

Args make_args(const void* x, long long ldx, const void* packed, long long ldp,
               const void* scales, long long lds, void* out, long long ldo, int M, int K,
               int F, int G, int bp) {
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
  const unsigned long long gu = G >= dec::UNIT_K ? G / dec::UNIT_K : 1;
  a.gmagic = ((1ull << 32) + gu - 1) / gu;
  return a;
}

cudaError_t launch_chunked(const Args& a, int mode, bool w16, cudaStream_t st) {
  if (a.M <= 4) return launch<4>(a, mode, w16, st);
  return launch<BP>(a, mode, w16, st);
}

cudaError_t launch_a8_chunked(const Args& a, bool i8mask, bool low_only, cudaStream_t st) {
  if (a.M <= 4) return launch_a8<4>(a, i8mask, low_only, st);
  return launch_a8<BP>(a, i8mask, low_only, st);
}

// The operands both functions' decode templates take: M <= 8 rows of x,
// whole 32-k units in a group (G % 32 == 0), 16-byte x loads (ldx a
// multiple of 8, x's base 16-byte aligned), 16-byte scale loads (lds a
// multiple of 4, the scales' base 16-byte aligned), 4-byte weight loads (F,
// ldp and the packed base multiples of 4), fewer than 2^16 units.
bool decode_operands(const void* x, long long ldx, const void* packed, long long ldp,
                     const void* scales, long long lds, int M, int K, int F, int G) {
  return M >= 1 && M <= 8 && G > 0 && G % dec::UNIT_K == 0 && K % G == 0 &&
         K / dec::UNIT_K < 65536 && F % 4 == 0 && ldx % 8 == 0 && lds % 4 == 0 &&
         ldp % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(scales) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(packed) % 4 == 0;
}

}  // namespace

// The template int4_exp runs for these operands: 1 the decode template, 0
// the chunked one. The decode template takes decode_operands' operands and
// a K slice of x within its shared-memory limit.
extern "C" int int4_exp_template(const void* x, long long ldx, const void* packed,
                                 long long ldp, const void* scales, long long lds, int M,
                                 int K, int F, int G) {
  return decode_operands(x, ldx, packed, ldp, scales, lds, M, K, F, G) &&
         dec::smem_bytes(8, dec::MODE_D, K) <= dec::SMEM_MAX;
}

// x (M, K) bf16, row stride ldx, unit stride in K, M <= 8; packed (K/2, F)
// int8 (one layer), row stride ldp, 4-byte aligned, F % 4 == 0; scales
// (K/G, F) fp32, row stride lds; out (8, F) fp32, row stride ldo. G even,
// K % G == 0, K / G <= 256 (the wrapper checks). mode 0 runs D (w16: the
// int16 unpack), mode 1 runs C. Launches the template int4_exp_template
// names. Returns the CUDA error code of the launch (0 = launched).
extern "C" int int4_exp(const void* x, long long ldx, const void* packed, long long ldp,
                        const void* scales, long long lds, void* out, long long ldo,
                        int M, int K, int F, int G, int mode, int w16, void* stream) {
  const Args a = make_args(x, ldx, packed, ldp, scales, lds, out, ldo, M, K, F, G, BP);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!int4_exp_template(x, ldx, packed, ldp, scales, lds, M, K, F, G))
    return (int)launch_chunked(a, mode, w16 != 0, st);
  return mode == 1 ? (int)dec::launch_m<dec::MODE_C>(a, st)
                   : (int)dec::launch_m<dec::MODE_D>(a, st);
}

// The chunked template alone, with int4_exp's arguments.
extern "C" int int4_exp_chunked(const void* x, long long ldx, const void* packed,
                                long long ldp, const void* scales, long long lds, void* out,
                                long long ldo, int M, int K, int F, int G, int mode, int w16,
                                void* stream) {
  const Args a = make_args(x, ldx, packed, ldp, scales, lds, out, ldo, M, K, F, G, BP);
  return (int)launch_chunked(a, mode, w16 != 0, static_cast<cudaStream_t>(stream));
}

// The template int4_exp_a8 runs for these operands: 1 the decode template,
// 0 the chunked one. The decode template takes decode_operands' operands,
// G <= MAX_GROUP_A8 (its group sums convert exactly), bp 8 or 32, and a K
// slice of x within its shared-memory limit.
extern "C" int int4_exp_a8_template(const void* x, long long ldx, const void* packed,
                                    long long ldp, const void* scales, long long lds, int M,
                                    int K, int F, int G, int bp) {
  return decode_operands(x, ldx, packed, ldp, scales, lds, M, K, F, G) &&
         G <= dec::MAX_GROUP_A8 && (bp == 8 || bp == 32) &&
         dec::smem_bytes(8, dec::MODE_A8, K) <= dec::SMEM_MAX;
}

// x (M, K) bf16, row stride ldx, unit stride in K, M <= 8; packed (K/2, F)
// int8 (one layer), row stride ldp, 4-byte aligned, F % 4 == 0; scales
// (K/G, F) fp32, row stride lds; out (bp, F) fp32, row stride ldo, M <= bp.
// G even, K % G == 0, K / G <= 256 (the wrapper checks). i8mask: the
// chunked template's unpack on whole words (E, and the i8mask rows);
// low_only: its low-nibble-only sums (F). Launches the template
// int4_exp_a8_template names (the decode template takes neither flag).
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int int4_exp_a8(const void* x, long long ldx, const void* packed, long long ldp,
                           const void* scales, long long lds, void* out, long long ldo,
                           int M, int K, int F, int G, int bp, int i8mask, int low_only,
                           void* stream) {
  const Args a = make_args(x, ldx, packed, ldp, scales, lds, out, ldo, M, K, F, G, bp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!int4_exp_a8_template(x, ldx, packed, ldp, scales, lds, M, K, F, G, bp))
    return (int)launch_a8_chunked(a, i8mask != 0, low_only != 0, st);
  return (int)dec::launch_m<dec::MODE_A8>(a, st);
}

// The W4A8 chunked template alone, with int4_exp_a8's arguments.
extern "C" int int4_exp_a8_chunked(const void* x, long long ldx, const void* packed,
                                   long long ldp, const void* scales, long long lds,
                                   void* out, long long ldo, int M, int K, int F, int G,
                                   int bp, int i8mask, int low_only, void* stream) {
  const Args a = make_args(x, ldx, packed, ldp, scales, lds, out, ldo, M, K, F, G, bp);
  return (int)launch_a8_chunked(a, i8mask != 0, low_only != 0,
                                static_cast<cudaStream_t>(stream));
}
