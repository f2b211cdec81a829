// Bridged decode attention over the head-major int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// libra_tpu/ops/pallas/decode_attention.py::int8_decode_attention (bodies
// _kernel_bridge and _kernel_plain). For batch b, head h and query row n:
//
//   s[j]  = (q . k[j]) * ks[j] * scale + cross[n,j] * (q . kb[j]) * kbs[j] * scale
//   s[j]  = max(s[j] + bias[b,n,j], BIG_NEG)                 BIG_NEG = -2^30
//   a     = softmax(s) in fp32 over all S cache slots
//   out   = sum_j bf16(a[j] * vs[j]) * v[j] + bf16(a[j] * cross[n,j] * vbs[j]) * vb[j]
//
// with k/v/kb/vb the raw int8 rows and ks/vs/kbs/vbs their fp32 per-(token,
// head) scales, and cross[n,j] = flag_q[b,n] != flag_kv[b,j]. The K scales
// multiply the scores and the V scales the probabilities, so the cache is
// read once, as int8. A row whose keys are all masked is the uniform average
// of V, as the BIG_NEG clamp gives it.
//
// What bounds it on this card: reading the cache. At B=4, H=32, S=674 one
// layer's four int8 buffers are 44 MB (13.6 us at 3.35 TB/s); each byte
// feeds N multiply-adds, so every byte must cost a few instructions or
// they, and not the bytes, set the time. At a chat turn's delta (N = 64
// query rows, S = 1024) each byte feeds 64 of them: the products belong on
// the tensor cores, and each byte's conversion must serve many of them.
//
// Three templates; int8_decode_attention picks one per call
// (int8_decode_attention_template: 1 decode, 2 wide, 0 rows):
//
// * decode (N <= 8: the decode step and the spec-decode verify pass; 16-byte
//   aligned cache rows): a cluster of RANKS = 4 blocks per (head, batch),
//   each block a contiguous run of 16-key units of S (the last unit ragged),
//   so 512 blocks of 128 threads at B=4, H=32, all resident at once (43 KB
//   of shared memory at S = 674 with the bridge and at most 102 registers
//   a thread: 5 blocks an SM). A block streams its run through two stage
//   buffers of PASS_UNITS units each, with cp.async copies: its K (and Kb) passes
//   first, the first two at once with its scales and bias, each next pass
//   as soon as a buffer is consumed, then its V (and Vb) passes the same
//   way, so V streams in while the last scores and the softmax are taken.
//   The scores stay in shared memory. Each int8 value becomes its exact
//   float without I2F (one XOR a word, one PRMT and one FADD a value: B2's
//   decode conversion), and both products run on the tensor cores
//   (mma.sync m16n8k8 tf32: int8 values, bf16 q and bf16-rounded
//   probabilities are exact in tf32; fp32 sums), so a byte costs the same
//   for every N <= 8:
//   - scores S^T = K Q^T, 16 keys by the 8 query rows an mma, the K
//     fragments by ldmatrix from chunk ^ (row % 8) swizzled rows, q held in
//     registers under the same mapping of d to k slots;
//   - softmax with the Pallas kernel's rounding: each block takes its rows'
//     local max, the cluster exchanges the maxima over distributed shared
//     memory, then the sums of exp(s - M), added in rank order; then
//     p = bf16((exp(s - M) / L) * vs), and the same with vbs where cross
//     holds, else 0 (keys past S: exactly 0);
//   - values out^T = V^T P^T, 16 of warp w's 32 d columns by the 8 rows an
//     mma, 8 keys deep: a lane reads whole words of two V rows (chunk ^
//     2 ((row / 2) % 4) swizzled, so the loads are conflict-free) and takes
//     the A operands from their bytes; P comes from shared memory as B;
//   - merge: after one cluster barrier, block r adds the RANKS partial
//     outputs of its 128 / RANKS d columns in rank order and writes
//     bf16. One launch, no workspace, no atomics: results repeat bit for bit.
// * wide (8 < N <= 64: a chat turn's 64-row text delta; the decode
//   template's alignment): the decode template's slicing (a cluster of
//   RANKS = 4 blocks per (head, batch) over 16-key units of S), 256 threads
//   and about 90 KB of shared memory a block at S = 1024 with the bridge, so
//   two blocks an SM (at most 128 registers a thread). Passes of PASS_KEYS =
//   32 keys of K (and Kb), then of V (and Vb), stream through NSTAGE = 2
//   stage buffers with 16-byte cp.async copies into swizzled rows; the bias
//   rows of the live query rows land in the score region with the first
//   pass. Warp w takes 32 query rows (two m16 tiles; wr = 32 (w % 2)) and
//   c = w / 2 picks its keys or d columns. Both products run on bf16
//   mma.sync m16n8k16 with fp32 sums; each int8 value becomes its exact
//   fp32 by the decode template's XOR + PRMT + FADD and two of them one
//   bf16x2 register by one PRMT of their high halves (exact: |v| <= 128 has
//   8 significant bits, so with bf16 q or bf16 p every product is exact):
//   - scores S = Q K^T, the warp's two m16 tiles of q rows by keys 8 c ..
//     8 c + 7 of a pass: q stays in registers as the A operand for the whole
//     kernel (rows past N zero), loaded once with 8-byte loads in the k slot
//     order of the keys' words: a lane reads chunks 2 t and 2 t + 1 of its
//     key row with two 16-byte loads (chunk ^ (row % 8) swizzle: no bank
//     conflicts), and each word is b0 and b1 of one k step, serving both
//     m16 tiles. The epilogue is the decode template's (x ks x scale, +
//     cross x the bridge score x kbs x scale, + bias, max with BIG_NEG,
//     -inf past S) into a row stride of 12 mod 32 floats;
//   - softmax as the decode template's, 8 rows a warp; p = bf16((e / L) vs)
//     and p_b = bf16((e / L) vbs) where cross holds (else 0) overwrite each
//     row's e in place: with the bridge (p, p_b) as the key's word, so that
//     [P | P_b] [V ; Vb] is one product whose k slots alternate V and Vb;
//     without, p as the key's bf16;
//   - values out = P V (+ P_b Vb), the warp's rows by d = 32 c .. 32 c + 31
//     (four n8 tiles, column g of tile e being d = 32 c + 4 g + e): P by
//     ldmatrix from the score region as A; V as B, a lane reading word
//     8 c + g of two rows (V and Vb of one key with the bridge, two keys
//     without) and pairing each byte of the one with the same byte of the
//     other, so one conversion feeds the warp's two m16 tiles;
//   - merge: once every block of the cluster has finished its values (the
//     receive buffers lie over P), each lane sends its 8 adjacent columns
//     of each row to the rank that finishes them; after one cluster barrier
//     block r adds the RANKS partials of its 128 / RANKS d columns in rank
//     order and writes bf16. One launch, no workspace, no atomics.
//   Every key is computed, also where the bias masks it: a fully masked row
//   is the uniform average of V.
// * rows (every other call: unaligned operands, or an S whose shared memory
//   does not fit the other two; the only template before the decode one,
//   exported alone as int8_decode_attention_rows): one block per (head,
//   batch), 256 threads, keys in tiles of 32, two passes over the tiles so
//   that the probabilities are rounded as the Pallas kernel rounds them:
//   - in both passes each warp loads 4 keys of a tile, one 128-byte row of
//     K (and Kb) a key (4 bytes a lane, all in flight before use), takes
//     the N dot products with the query rows from shared memory and
//     reduces them with shuffles;
//   - pass 1: warp w keeps the running max M and sum L of exp(s - M) of
//     rows w, w + 8, ..., with lane j on key j of the tile (L rescaled as
//     M grows);
//   - pass 2 recomputes the scores, loads the V (and Vb) rows too and
//     writes them to shared memory as fp32, and writes
//     p = bf16((exp(s - M) / L) * vs) (and the same with vbs where cross
//     holds, else 0) to shared memory: the decode template's p;
//   - thread t accumulates column t % 128 of every row over the even
//     (t < 128) or odd (t >= 128) keys of each tile; the halves are added
//     at the end, with no division (p is normalized);
//   - keys past S get probability exactly 0; the running max starts at
//     BIG_NEG, so exponents never see -inf - -inf, and a fully masked row
//     is the uniform average.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"
#include "split_k.cuh"

namespace {

constexpr int D = 128;          // head dim: libra-11b's, the only one built
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
  const uint8_t* flag_q;          // (B, N) bytes, 0/1
  long long fq_b, fq_n;
  const uint8_t* flag_kv;         // (B, S) bytes, 0/1, unit stride in S
  long long fk_b;
  const float* bias;              // (B, N, S), unit stride in S
  long long bias_b, bias_n;
  __nv_bfloat16* out;             // (B, N, H, D) contiguous
  int N, S, H;
  float scale;
};

// Sets the largest dynamic shared memory `kernel` takes, once per device.
template <class F>
cudaError_t open_once(F* kernel, bool (&opened)[16], int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && opened[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 16) opened[dev] = true;
  return e;
}

// ---------------------------------------------------------------------------
// The rows template (any N <= 64)
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BS = 32;          // keys per tile (one a lane in the softmax)
constexpr int KPW = BS / WARPS; // keys per warp per tile: 4

using splitk::warp_sum;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float byte_f32(uint32_t w, int e) {
  return (float)(int8_t)(uint8_t)(w >> (8 * e));
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int NMAX>
constexpr int smem_floats(bool bridge) {
  return NMAX * D                        // query rows; at the end, half sums
         + BS * D * (bridge ? 2 : 1)     // V (+ Vb) tile
         + NMAX * BS * (bridge ? 2 : 1)  // p (+ the bridge's p)
         + NMAX * BS;                    // scores
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
  __shared__ uint8_t fq[NMAX];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int N = a.N;

  for (int i = tid; i < NMAX * D; i += THREADS) {
    const int n = i / D, c = i % D;
    Qs[i] = n < N ? __bfloat162float(a.q[b * a.q_b + n * a.q_n + h * a.q_h + c]) : 0.f;
  }
  if (tid < NMAX) fq[tid] = tid < N ? a.flag_q[b * a.fq_b + tid * a.fq_n] : 0;

  const long long cbase = b * a.c_b + h * a.c_h;
  const long long sbase = b * a.s_b + h * a.s_h;
  const uint8_t* fkv = a.flag_kv + b * a.fk_b;

  // The scores of the tile at s0 into Ss (-inf past the last key); with
  // WITH_V also its V (and Vb) rows into Vs (VBs) as fp32. Warp w takes
  // keys w * KPW .. + KPW - 1.
  auto tile_scores = [&](int s0, auto with_v) {
    constexpr bool WITH_V = decltype(with_v)::value;
    uint32_t kw[KPW], vw[KPW], kbw[KPW], vbw[KPW];
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int sj = s0 + warp * KPW + jj;
      const long long off = cbase + sj * a.c_s + lane * 4;
      const bool ok = sj < a.S;
      kw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.k + off)) : 0u;
      if (WITH_V) vw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.v + off)) : 0u;
      if (BRIDGE) {
        kbw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.kb + off)) : 0u;
        if (WITH_V) vbw[jj] = ok ? __ldg(reinterpret_cast<const uint32_t*>(a.vb + off)) : 0u;
      }
    }
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int j = warp * KPW + jj, sj = s0 + j;
      const bool ok = sj < a.S;
      if (WITH_V) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Vs[j * D + lane * 4 + e] = byte_f32(vw[jj], e);
          if (BRIDGE) VBs[j * D + lane * 4 + e] = byte_f32(vbw[jj], e);
        }
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
  };

  // --- pass 1: each row's max M and sum L of exp(s - M); warp w owns rows
  // w, w + 8, ...; lane j is key j of the tile ---
  constexpr int RPW = NMAX / WARPS > 0 ? NMAX / WARPS : 1;   // softmax rows a warp
  float m_run[RPW], l_run[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = BIG_NEG;
    l_run[i] = 0.f;
  }
  for (int s0 = 0; s0 < a.S; s0 += BS) {
    __syncthreads();   // Q is staged; the previous tile's scores are read
    tile_scores(s0, std::false_type());
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int n = warp + WARPS * i;
      if (n >= N) continue;   // the warp's remaining rows are past N too
      const float x = Ss[n * BS + lane];
      const float m_new = fmaxf(m_run[i], warp_max(x));
      // both exponents finite but x past the last key (exp(-inf) = 0)
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + warp_sum(expf(x - m_new));
      m_run[i] = m_new;
    }
  }

  // --- pass 2: the scores again, p = bf16((exp(s - M) / L) * vs), then
  // the values: column `col` of every row, keys of this thread's half ---
  const int col = tid % D, half = tid / D;
  float acc[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) acc[n] = 0.f;
  for (int s0 = 0; s0 < a.S; s0 += BS) {
    __syncthreads();   // the previous tile's V and p are read
    tile_scores(s0, std::true_type());
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int n = warp + WARPS * i;
      if (n >= N) continue;
      const int sj = s0 + lane;
      const bool ok = sj < a.S;
      const float an = expf(Ss[n * BS + lane] - m_run[i]) / l_run[i];
      Ps[n * BS + lane] = ok ? bf16_rn(an * a.vs[sbase + sj]) : 0.f;
      if (BRIDGE)
        PBs[n * BS + lane] = (ok && fq[n] != fkv[sj]) ? bf16_rn(an * a.vbs[sbase + sj]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        float t = acc[n];
#pragma unroll 4
        for (int j = half; j < BS; j += 2) {
          t = fmaf(Ps[n * BS + j], Vs[j * D + col], t);
          if (BRIDGE) t = fmaf(PBs[n * BS + j], VBs[j * D + col], t);
        }
        acc[n] = t;
      }
    }
  }

  // --- add the two halves, store bf16 ---
  __syncthreads();   // Q and the last tile are no longer read
  float* Hs = Qs;    // odd-key half sums, NMAX x D
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
        const float o = acc[n] + Hs[n * D + col];
        a.out[(((long long)b * N + n) * a.H + h) * D + col] = __float2bfloat16(o);
      }
    }
  }
}

template <int NMAX, bool BRIDGE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_floats<NMAX>(BRIDGE) * sizeof(float);
  auto kernel = decode_attention_kernel<NMAX, BRIDGE>;
  static bool opened[16];
  const cudaError_t err = open_once(kernel, opened, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.H, B), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t launch_n(const Args& a, int B, cudaStream_t stream) {
  return a.kb != nullptr ? launch<NMAX, true>(a, B, stream)
                         : launch<NMAX, false>(a, B, stream);
}

cudaError_t launch_rows(const Args& a, int B, cudaStream_t st) {
  if (a.N <= 8) return launch_n<8>(a, B, st);
  return launch_n<64>(a, B, st);
}

// ---------------------------------------------------------------------------
// The decode template (N <= 8)
// ---------------------------------------------------------------------------

namespace dec {

namespace cg = cooperative_groups;

constexpr int RANKS = 4;               // blocks of a cluster, one run of S each
constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 5;       // at most 102 registers a thread: every cluster at once
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;                // query rows: the mma's n8 tile, N <= 8
constexpr int UNIT = 16;               // keys of a slicing unit: the score mma's m16 tile
constexpr int PASS_UNITS = 3;          // units a stage buffer holds
constexpr int PASS_KEYS = PASS_UNITS * UNIT;
constexpr int ROW_BYTES = D;           // an int8 cache row
constexpr int CHUNKS = ROW_BYTES / 16; // 16-byte chunks of a row
constexpr int OUT_COLS = D / RANKS;    // d columns each rank finishes
// A word w of 4 int8 values (byte e = value e): w ^ SIGN_FLIP holds each
// b + 128 (0..255) as an unsigned byte; __byte_perm(that, MAGIC, SELe) is
// the word 0x4B0000uu with uu the byte of value e, the fp32 2^23 + b + 128;
// minus MAGIC_BIAS = 2^23 + 128 it is b, exact.
constexpr uint32_t SIGN_FLIP = 0x80808080u;
constexpr uint32_t MAGIC = 0x4B000000u;
constexpr uint32_t SEL0 = 0x7440u;
constexpr uint32_t SEL1 = 0x7441u;
constexpr uint32_t SEL2 = 0x7442u;
constexpr uint32_t SEL3 = 0x7443u;
constexpr float MAGIC_BIAS = 8388736.f;
constexpr int SMEM_MAX = 200 * 1024;   // dynamic shared memory the template takes

static_assert(UNIT == 16, "a unit is the m16 tile of the score product");
static_assert(WARPS * 32 == D, "warp w takes the value product's d columns [32 w, 32 w + 32)");
static_assert(OUT_COLS % 4 == 0 && (ROWS * OUT_COLS) % THREADS == 0,
              "a lane sends 4 adjacent columns to one rank; the merge's work splits evenly");

// Shared memory of one block, byte offsets: two stage buffers of (1 or 2)
// x pk rows; the scores, then the probabilities p * vs (ROWS x pstr fp32),
// and p * cross * vbs with the bridge; the scales ks, vs (, kbs, vbs) of
// the block's keys; their flags; the exchanged maxima and sums; the
// receive buffer of the merge. nkr is the most keys a rank takes, pstr a
// row stride of 8 mod 16 floats (conflict-free 8-byte loads of P).
struct Smem {
  int nkr, pk, pstr, buf, ss, pb, meta, fk, mx, sm, recv, total;
};

__host__ __device__ inline Smem layout(int S, bool bridge) {
  Smem m;
  const int U = (S + UNIT - 1) / UNIT;
  const int nb = bridge ? 2 : 1;
  m.nkr = UNIT * ((U + RANKS - 1) / RANKS);
  m.pk = m.nkr < PASS_KEYS ? m.nkr : PASS_KEYS;
  m.pstr = m.nkr + 8;
  m.buf = nb * m.pk * ROW_BYTES;
  m.ss = 2 * m.buf;
  m.pb = m.ss + ROWS * m.pstr * 4;
  m.meta = m.pb + (bridge ? ROWS * m.pstr * 4 : 0);
  m.fk = m.meta + 2 * nb * m.nkr * 4;
  m.mx = m.fk + ((m.nkr + 15) & ~15);
  m.sm = m.mx + RANKS * ROWS * 4;
  m.recv = m.sm + RANKS * ROWS * 4;
  m.total = m.recv + RANKS * ROWS * OUT_COLS * 4;
  return m;
}

// Byte offset of 16-byte chunk c of row r in a stage buffer: K rows are
// swizzled by row % 8 (ldmatrix reads 8 rows of one chunk), V rows by
// 2 ((row / 2) % 4) (a lane reads one word of rows 2t and 2t + 1).
__device__ __forceinline__ uint32_t swz_k(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}
__device__ __forceinline__ uint32_t swz_v(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (((r >> 1) & 3) << 1)) << 4));
}

// 4 bytes from global to shared (zero when !pred; src must stay valid).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// The int8 value that sel picks from u = w ^ SIGN_FLIP, as its exact fp32 bits.
__device__ __forceinline__ uint32_t i8f(uint32_t u, uint32_t sel) {
  return __float_as_uint(__uint_as_float(__byte_perm(u, MAGIC, sel)) - MAGIC_BIAS);
}

__device__ __forceinline__ uint32_t bf16_round(float x) {   // fp32 bits of bf16(x)
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x)) << 16;
}

// d += a b on the tensor cores, tf32 operands, fp32 sums: a m16n8k8 tile,
// A row-major (16 x 8), B column-major (8 x 8). With g = lane / 4,
// t = lane % 4: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2 t), d1 (g, 2 t + 1),
// d2 (g + 8, 2 t), d3 (g + 8, 2 t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Scores of one unit (16 keys from row r0 of a K stage buffer) for the 8
// query rows: in the mma of chunk c and half e, the k slots t and t + 4 of
// lane (g, t) are d = 16 c + 4 t + 2 e and that + 1, the bytes 2 e, 2 e + 1
// of word t of chunk c, which ldmatrix gives the lane for key rows g and
// g + 8; q (held as qf[c][0..3] = q[g][16 c + 4 t + 0..3]) takes the same
// slots. Any assignment of d to k slots gives the same sums when A and B
// agree on it, so no data moves between lanes.
__device__ __forceinline__ void unit_scores(float (&acc)[4], uint32_t buf, int r0,
                                            const uint32_t (&qf)[CHUNKS][4], int lane) {
#pragma unroll
  for (int c2 = 0; c2 < CHUNKS / 2; ++c2) {
    uint32_t w[4];   // chunk 2 c2 of key rows g, g + 8; chunk 2 c2 + 1 of the same
    fmma::ldsm_x4(w, buf + swz_k(r0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 2 * c2 + (lane >> 4)));
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      const int c = 2 * c2 + hc;
      const uint32_t lo = w[2 * hc] ^ SIGN_FLIP, hi = w[2 * hc + 1] ^ SIGN_FLIP;
      mma_tf32(acc, i8f(lo, SEL0), i8f(hi, SEL0), i8f(lo, SEL1), i8f(hi, SEL1), qf[c][0],
               qf[c][1]);
      mma_tf32(acc, i8f(lo, SEL2), i8f(hi, SEL2), i8f(lo, SEL3), i8f(hi, SEL3), qf[c][2],
               qf[c][3]);
    }
  }
}

// One mma of the value product: 8 keys (rows 8 s .. 8 s + 7 of a V stage
// buffer) by warp w's d columns. k slots t and t + 4 of lane (g, t) are the
// rows 8 s + 2 t and 8 s + 2 t + 1; M row g of tile j is d = 32 w + 4 g + 2 j,
// row g + 8 is d = 32 w + 4 g + 2 j + 1: bytes 2 j and 2 j + 1 of word 8 w + g
// of the two rows. P[g][those two keys] is B.
__device__ __forceinline__ void step_values(float (&acc)[2][4], uint32_t buf, int s,
                                            const float* P, int lk, int warp, int g, int t) {
  const int r = 8 * s + 2 * t;
  const uint32_t off = 4 * (g & 3);
  const int c = 2 * warp + (g >> 2);
  uint32_t w0, w1;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w0) : "r"(buf + swz_v(r, c) + off));
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(w1) : "r"(buf + swz_v(r + 1, c) + off));
  const float2 p = *reinterpret_cast<const float2*>(P + lk + 2 * t);
  const uint32_t b0 = __float_as_uint(p.x), b1 = __float_as_uint(p.y);
  w0 ^= SIGN_FLIP;
  w1 ^= SIGN_FLIP;
  mma_tf32(acc[0], i8f(w0, SEL0), i8f(w0, SEL1), i8f(w1, SEL0), i8f(w1, SEL1), b0, b1);
  mma_tf32(acc[1], i8f(w0, SEL2), i8f(w0, SEL3), i8f(w1, SEL2), i8f(w1, SEL3), b0, b1);
}

// Block `rank` of the cluster of (h, b) takes units [ub, ue) of S, keys
// [k0, k0 + nk) with nk <= 16 (ue - ub), in npass passes of up to
// PASS_UNITS units; stage i < npass is K pass i, stage npass + i is V pass
// i, in stage buffer i % 2. Stages 0 and 1 go out first (K, then V where
// one pass holds the run); stage i + 2 goes out once stage i is consumed.
template <bool BRIDGE>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(THREADS, BLOCKS_PER_SM)
    attn_decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ uint8_t fq_s[ROWS];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int N = a.N, S = a.S;
  constexpr int NB = BRIDGE ? 2 : 1;
  const Smem L = layout(S, BRIDGE);
  const int U = (S + UNIT - 1) / UNIT;
  const int ub = U * rank / RANKS, nu = U * (rank + 1) / RANKS - ub;
  const int k0 = UNIT * ub;
  const int nk = nu > 0 ? min(UNIT * nu, S - k0) : 0;  // the block's live keys
  const int npass = (nu + PASS_UNITS - 1) / PASS_UNITS;

  const uint32_t base = fmma::smem_addr(dsm);
  float* Ss = reinterpret_cast<float*>(dsm + L.ss);    // scores, then p * vs
  float* PB = reinterpret_cast<float*>(dsm + L.pb);    // p * cross * vbs
  float* ks_s = reinterpret_cast<float*>(dsm + L.meta);
  float* vs_s = ks_s + L.nkr;
  float* kbs_s = vs_s + L.nkr;
  float* vbs_s = kbs_s + L.nkr;
  uint8_t* fk_s = dsm + L.fk;
  float* mx = reinterpret_cast<float*>(dsm + L.mx);    // [rank][row]
  float* sm = reinterpret_cast<float*>(dsm + L.sm);    // [rank][row]
  float* recv = reinterpret_cast<float*>(dsm + L.recv);   // [rank][row][OUT_COLS]
  // this block has started: the others may write into its shared memory
  // once they have waited on this arrival
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const long long cbase = b * a.c_b + h * a.c_h + k0 * a.c_s;
  auto fetch = [&](int st) {
    if (st < 2 * npass) {
      const bool vst = st >= npass;
      const int p = vst ? st - npass : st;
      const int row0 = PASS_KEYS * p;
      const int nup = min(PASS_UNITS, nu - PASS_UNITS * p);
      const uint32_t dst0 = base + (st & 1) * L.buf;
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const int8_t* src = (vst ? (bi ? a.vb : a.v) : (bi ? a.kb : a.k)) + cbase;
        const uint32_t dst = dst0 + bi * L.pk * ROW_BYTES;
        for (int i = tid; i < UNIT * CHUNKS * nup; i += THREADS) {
          const int r = i / CHUNKS, c = i % CHUNKS, key = row0 + r;
          const bool ok = key < nk;
          fmma::cp_async16(dst + (vst ? swz_v(r, c) : swz_k(r, c)),
                           src + (ok ? key * a.c_s + 16 * c : 0), ok);
        }
      }
    }
    fmma::cp_commit();
  };

  // stage 0 (K) with the scales, bias rows and flags; then stage 1
  {
    const int nr = UNIT * nu;
    const long long sb = b * a.s_b + h * a.s_h + k0;
    for (int i = tid; i < nr; i += THREADS) {
      const bool ok = i < nk;
      const long long o = ok ? sb + i : 0;
      cp_async4(fmma::smem_addr(ks_s + i), a.ks + o, ok);
      cp_async4(fmma::smem_addr(vs_s + i), a.vs + o, ok);
      if (BRIDGE) {
        cp_async4(fmma::smem_addr(kbs_s + i), a.kbs + o, ok);
        cp_async4(fmma::smem_addr(vbs_s + i), a.vbs + o, ok);
      }
    }
    for (int n = 0; n < N; ++n) {
      const float* bs = a.bias + b * a.bias_b + n * a.bias_n + k0;
      for (int i = tid; i < nr; i += THREADS)
        cp_async4(fmma::smem_addr(Ss + n * L.pstr + i), bs + (i < nk ? i : 0), i < nk);
    }
    fetch(0);
    fetch(1);
    for (int i = tid; i < nr; i += THREADS)
      fk_s[i] = BRIDGE && i < nk ? a.flag_kv[b * a.fk_b + k0 + i] : 0;
    if (tid < ROWS) fq_s[tid] = BRIDGE && tid < N ? a.flag_q[b * a.fq_b + tid * a.fq_n] : 0;
  }

  // q row g in registers, qf[c][e] = q[g][16 c + 4 t + e] (0 past N)
  uint32_t qf[CHUNKS][4];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    uint2 u = make_uint2(0u, 0u);
    if (g < N)
      u = __ldg(reinterpret_cast<const uint2*>(a.q + b * a.q_b + g * a.q_n + h * a.q_h +
                                               16 * c + 4 * t));
    qf[c][0] = u.x << 16;
    qf[c][1] = u.x & 0xFFFF0000u;
    qf[c][2] = u.y << 16;
    qf[c][3] = u.y & 0xFFFF0000u;
  }

  // --- scores: warp w takes units w, w + WARPS, ... of each K pass ---
  for (int p = 0; p < npass; ++p) {
    fmma::cp_wait<1>();
    __syncthreads();
    const uint32_t buf = base + (p & 1) * L.buf;
    const int nup = min(PASS_UNITS, nu - PASS_UNITS * p);
    for (int u = warp; u < nup; u += WARPS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, accb[4] = {0.f, 0.f, 0.f, 0.f};
      unit_scores(acc, buf, UNIT * u, qf, lane);
      if (BRIDGE) unit_scores(accb, buf + L.pk * ROW_BYTES, UNIT * u, qf, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * t + (i & 1);
        const int lk = PASS_KEYS * p + UNIT * u + g + 8 * (i >> 1);
        float x = -INFINITY;   // past the last key or row: probability 0
        if (lk < nk && n < N) {
          x = acc[i] * ks_s[lk] * a.scale;
          if (BRIDGE && fq_s[n] != fk_s[lk]) x += accb[i] * kbs_s[lk] * a.scale;
          x = fmaxf(x + Ss[n * L.pstr + lk], BIG_NEG);
        }
        Ss[n * L.pstr + lk] = x;
      }
    }
    __syncthreads();   // the buffer is consumed; the pass's scores are in Ss
    fetch(p + 2);
  }
  if (npass == 0) {
    fmma::cp_wait<0>();
    __syncthreads();
  }

  // --- softmax: warp w takes rows 2 w, 2 w + 1; the cluster exchanges each
  // row's max, then its sums, over distributed shared memory ---
  const int nr = UNIT * nu;
  float m2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * warp + i;
    float m = BIG_NEG;
    if (n < N)
      for (int k = lane; k < nk; k += 32) m = fmaxf(m, Ss[n * L.pstr + k]);
    m2[i] = warp_max(m);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started
  if (lane < RANKS) {
    float* dst = cluster.map_shared_rank(mx, lane);
    dst[rank * ROWS + 2 * warp] = m2[0];
    dst[rank * ROWS + 2 * warp + 1] = m2[1];
  }
  cluster.sync();
  float e2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * warp + i;
    float m = mx[n];
#pragma unroll
    for (int r = 1; r < RANKS; ++r) m = fmaxf(m, mx[r * ROWS + n]);
    m2[i] = m;
    float part = 0.f;
    if (n < N)
      for (int k = lane; k < nk; k += 32) {
        const float e = expf(Ss[n * L.pstr + k] - m);
        Ss[n * L.pstr + k] = e;
        part += e;
      }
    e2[i] = warp_sum(part);
  }
  if (lane < RANKS) {
    float* dst = cluster.map_shared_rank(sm, lane);
    dst[rank * ROWS + 2 * warp] = e2[0];
    dst[rank * ROWS + 2 * warp + 1] = e2[1];
  }
  cluster.sync();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = 2 * warp + i;
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < RANKS; ++r) l += sm[r * ROWS + n];
    for (int k = lane; k < nr; k += 32) {
      float pv = 0.f, pb = 0.f;
      if (n < N && k < nk) {
        const float an = Ss[n * L.pstr + k] / l;
        pv = __uint_as_float(bf16_round(an * vs_s[k]));
        if (BRIDGE && fq_s[n] != fk_s[k]) pb = __uint_as_float(bf16_round(an * vbs_s[k]));
      }
      Ss[n * L.pstr + k] = pv;
      if (BRIDGE) PB[n * L.pstr + k] = pb;
    }
  }

  // --- values: warp w takes d columns [32 w, 32 w + 32) over every key ---
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int p = 0; p < npass; ++p) {
    fmma::cp_wait<1>();
    __syncthreads();   // the pass has landed; the probabilities are written
    const uint32_t buf = base + ((npass + p) & 1) * L.buf;
    const int nup = min(PASS_UNITS, nu - PASS_UNITS * p);
    for (int s = 0; s < 2 * nup; ++s) {
      const int lk = PASS_KEYS * p + 8 * s;
      step_values(acc, buf, s, Ss + g * L.pstr, lk, warp, g, t);
      if (BRIDGE) step_values(acc, buf + L.pk * ROW_BYTES, s, PB + g * L.pstr, lk, warp, g, t);
    }
    __syncthreads();
    fetch(npass + p + 2);
  }

  // --- merge: this lane holds out[2 t][32 w + 4 g + 0..3] and out[2 t + 1][..];
  // rank (32 w + 4 g) / OUT_COLS finishes those columns ---
  {
    float* dst = cluster.map_shared_rank(recv, (32 * warp + 4 * g) / OUT_COLS);
    const int o = (32 * warp + 4 * g) % OUT_COLS;
    if (2 * t < N)
      *reinterpret_cast<float4*>(dst + (rank * ROWS + 2 * t) * OUT_COLS + o) =
          make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
    if (2 * t + 1 < N)
      *reinterpret_cast<float4*>(dst + (rank * ROWS + 2 * t + 1) * OUT_COLS + o) =
          make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);
  }
  cluster.sync();
#pragma unroll
  for (int i = tid; i < ROWS * OUT_COLS; i += THREADS) {
    const int n = i / OUT_COLS, c = i % OUT_COLS;
    if (n < N) {
      float o = 0.f;
#pragma unroll
      for (int r = 0; r < RANKS; ++r) o += recv[(r * ROWS + n) * OUT_COLS + c];
      a.out[(((long long)b * N + n) * a.H + h) * D + OUT_COLS * rank + c] = __float2bfloat16(o);
    }
  }
  // Every remote write precedes the last cluster.sync; after it a block
  // reads only its own shared memory.
}

template <bool BRIDGE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static bool opened[16];
  cudaError_t e = open_once(attn_decode_kernel<BRIDGE>, opened, SMEM_MAX);
  if (e != cudaSuccess) return e;
  attn_decode_kernel<BRIDGE>
      <<<dim3(RANKS, a.H, B), THREADS, layout(a.S, BRIDGE).total, stream>>>(a);
  return cudaGetLastError();
}

template <bool BRIDGE>
cudaError_t clusters(int S, int* n) {
  static bool opened[16];
  cudaError_t e = open_once(attn_decode_kernel<BRIDGE>, opened, SMEM_MAX);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RANKS, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = layout(S, BRIDGE).total;
  return cudaOccupancyMaxActiveClusters(n, (const void*)attn_decode_kernel<BRIDGE>, &cfg);
}

}  // namespace dec

// ---------------------------------------------------------------------------
// The wide template (8 < N <= 64)
// ---------------------------------------------------------------------------

namespace wide {

namespace cg = cooperative_groups;
using dec::i8f;
using dec::SEL0;
using dec::SEL1;
using dec::SEL2;
using dec::SEL3;
using dec::SIGN_FLIP;

constexpr int RANKS = 4;               // blocks of a cluster, one run of S each
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;       // at most 128 registers a thread
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;               // query rows: four m16 tiles, N <= 64
constexpr int ROW_GROUPS = 2;          // warps along the rows
constexpr int WROWS = ROWS / ROW_GROUPS;   // rows a warp: two m16 tiles
constexpr int COL_GROUPS = WARPS / ROW_GROUPS;   // key groups (scores), d groups (values)
constexpr int UNIT = 16;               // keys of a slicing unit
constexpr int PASS_UNITS = 2;          // units a stage buffer holds
constexpr int PASS_KEYS = PASS_UNITS * UNIT;
constexpr int NSTAGE = 2;              // stage buffers of the cp.async ring
constexpr int ROW_BYTES = D;           // an int8 cache row
constexpr int CHUNKS = ROW_BYTES / 16; // 16-byte chunks of a row
constexpr int DCOLS = D / COL_GROUPS;  // d columns of a warp in the values
constexpr int OUT_COLS = D / RANKS;    // d columns each rank finishes
constexpr int SROWS = ROWS / WARPS;    // softmax rows a warp
// Two exact int8 floats (i8f) as one bf16x2 register, the first in the low
// half: the values have at most 8 significant bits, so their high halves
// are their bf16; PRMT by PAIR_HI joins the high half of each.
constexpr uint32_t PAIR_HI = 0x7632u;
constexpr int SMEM_MAX = 220 * 1024;   // dynamic shared memory the template takes

static_assert(PASS_KEYS == 8 * COL_GROUPS, "warp group c takes keys 8 c .. 8 c + 7 of a pass");
static_assert(DCOLS == 32, "a warp's values are 4 n8 tiles over d = 32 c + 4 g + e");
static_assert(OUT_COLS % 8 == 0, "a lane sends 8 adjacent columns to one rank");
static_assert(WROWS == 32 && SROWS == 8, "two m16 tiles a warp; 8 softmax rows a warp");

// Shared memory of one block, byte offsets: NSTAGE stage buffers of (1 or 2)
// x PASS_KEYS rows; the region that holds the bias rows, then the scores,
// then exp(s - M), then the probabilities in place (the value product's A
// operand), then the receive buffer of the merge (ROWS x sstr fp32 or the
// receive buffer, the larger); the scales ks, vs (, kbs, vbs) of the
// block's keys; their flags; the exchanged maxima and sums. nkr is the most
// keys a rank takes; sstr, a row stride of 12 mod 32 floats, puts the 8
// rows of 16 bytes an ldmatrix phase reads of P on distinct banks.
struct Smem {
  int nkr, sstr, buf, ss, meta, fk, mx, sm, total;
};

__host__ __device__ inline Smem layout(int S, bool bridge) {
  Smem m;
  const int U = (S + UNIT - 1) / UNIT;
  const int nb = bridge ? 2 : 1;
  m.nkr = UNIT * ((U + RANKS - 1) / RANKS);
  m.sstr = ((m.nkr + 19) & ~31) + 12;
  m.buf = nb * PASS_KEYS * ROW_BYTES;
  m.ss = NSTAGE * m.buf;
  const int region = ROWS * m.sstr * 4;
  const int recv = RANKS * ROWS * OUT_COLS * 4;
  m.meta = m.ss + (region > recv ? region : recv);
  m.fk = m.meta + 2 * nb * m.nkr * 4;
  m.mx = m.fk + ((m.nkr + 15) & ~15);
  m.sm = m.mx + RANKS * ROWS * 4;
  m.total = m.sm + RANKS * ROWS * 4;
  return m;
}

// Byte offset of 16-byte chunk c of row r in a stage buffer: K rows are
// swizzled by row % 8 (a lane reads chunks 2 t and 2 t + 1 of key row g:
// a quarter warp's 16-byte loads take 8 distinct chunks), V rows by
// 2 ((row >> SH) % 4), SH = 0 with the bridge (lane t reads rows 8 s + t and
// 8 s + 4 + t) and 1 without (rows 16 s + 2 t, + 1, + 8, + 9), so that the
// 4-byte loads of a warp take 32 distinct banks.
__device__ __forceinline__ uint32_t swz_k(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}
template <bool BRIDGE>
__device__ __forceinline__ uint32_t swz_v(int r, int c) {
  constexpr int SH = BRIDGE ? 0 : 1;
  return (uint32_t)(r * ROW_BYTES + ((c ^ (((r >> SH) & 3) << 1)) << 4));
}

// 16 bytes from global to shared, of which the first `bytes` are read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Scores of key row kr of a K stage buffer (at byte offset kbuf of dsm) for
// the warp's two m16 tiles of query rows (the second only where `two`): in
// k step kc the lane's k slots 2 t, 2 t + 1 are d = 32 t + 16 (kc / 4) +
// 4 (kc % 4) + 0, 1 and its slots 2 t + 8, 2 t + 9 that + 2, + 3: word kc % 4
// of chunk 2 t + kc / 4 of the key row, whose 4 values become b0 and b1;
// qa holds q in the same slots.
__device__ __forceinline__ void key_scores(float (&acc)[2][4], const uint32_t (&qa)[2][8][4],
                                           const unsigned char* dsm, uint32_t kbuf, int kr,
                                           int t, bool two) {
  const uint4 lo = *reinterpret_cast<const uint4*>(dsm + kbuf + swz_k(kr, 2 * t));
  const uint4 hi = *reinterpret_cast<const uint4*>(dsm + kbuf + swz_k(kr, 2 * t + 1));
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const uint32_t u = w[kc] ^ SIGN_FLIP;
    const uint32_t b0 = __byte_perm(i8f(u, SEL0), i8f(u, SEL1), PAIR_HI);
    const uint32_t b1 = __byte_perm(i8f(u, SEL2), i8f(u, SEL3), PAIR_HI);
    fmma::mma16816(acc[0], qa[0][kc], b0, b1);
    if (two) fmma::mma16816(acc[1], qa[1][kc], b0, b1);
  }
}

// The B operands of value k step s of a V stage buffer (byte offset vbuf)
// for the warp's d columns 32 c + 4 g + e, n8 tile e: with the bridge the k
// slots 2 t, 2 t + 1 are (V, Vb) of key 8 s + t and slots 2 t + 8, 2 t + 9
// those of key 8 s + 4 + t (P holds (p, p_b) of a key as one word); without,
// slots 2 t, 2 t + 1 are V rows 16 s + 2 t, + 1 and slots 2 t + 8, 2 t + 9
// rows 16 s + 2 t + 8, + 9 (P holds p a key). The lane reads word 8 c + g of
// each row and pairs the same byte of its two rows into one register.
template <bool BRIDGE>
__device__ __forceinline__ void value_operands(uint32_t (&bf)[4][2], const unsigned char* dsm,
                                               uint32_t vbuf, int s, int c, int g, int t) {
  const int chunk = 2 * c + (g >> 2), off = 4 * (g & 3);
  const uint32_t second = BRIDGE ? PASS_KEYS * ROW_BYTES : 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r0 = BRIDGE ? 8 * s + 4 * j + t : 16 * s + 8 * j + 2 * t;
    const int r1 = BRIDGE ? r0 : r0 + 1;
    const uint32_t u0 =
        *reinterpret_cast<const uint32_t*>(dsm + vbuf + swz_v<BRIDGE>(r0, chunk) + off) ^
        SIGN_FLIP;
    const uint32_t u1 = *reinterpret_cast<const uint32_t*>(dsm + vbuf + second +
                                                           swz_v<BRIDGE>(r1, chunk) + off) ^
                        SIGN_FLIP;
    bf[0][j] = __byte_perm(i8f(u0, SEL0), i8f(u1, SEL0), PAIR_HI);
    bf[1][j] = __byte_perm(i8f(u0, SEL1), i8f(u1, SEL1), PAIR_HI);
    bf[2][j] = __byte_perm(i8f(u0, SEL2), i8f(u1, SEL2), PAIR_HI);
    bf[3][j] = __byte_perm(i8f(u0, SEL3), i8f(u1, SEL3), PAIR_HI);
  }
}

// Block `rank` of the cluster of (h, b) takes units [ub, ue) of S, keys
// [k0, k0 + nk), in npass passes of up to PASS_UNITS units; stage i < npass
// is K pass i, stage npass + i is V pass i, in stage buffer i % NSTAGE.
// Stages 0 .. NSTAGE - 1 go out first; stage i + NSTAGE once stage i is
// consumed, so the first V passes land while the softmax is exchanged.
// Warp w takes the query rows 32 (w % 2) .. + 31 (wr), and c = w / 2 is its
// key group of a score pass (keys 8 c .. 8 c + 7) and its d group of the
// values (d = 32 c .. 32 c + 31).
template <bool BRIDGE>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(THREADS, BLOCKS_PER_SM)
    attn_wide_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ uint8_t fq_s[ROWS];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = WROWS * (warp % ROW_GROUPS), c = warp / ROW_GROUPS;
  const int N = a.N, S = a.S;
  constexpr int NB = BRIDGE ? 2 : 1;
  constexpr int KSTEPS = BRIDGE ? PASS_KEYS / 8 : PASS_KEYS / 16;   // value k steps a pass
  const Smem L = layout(S, BRIDGE);
  const int U = (S + UNIT - 1) / UNIT;
  const int ub = U * rank / RANKS, nu = U * (rank + 1) / RANKS - ub;
  const int k0 = UNIT * ub;
  const int nk = nu > 0 ? min(UNIT * nu, S - k0) : 0;  // the block's live keys
  const int nr = UNIT * nu;                              // its staged keys
  const int npass = (nu + PASS_UNITS - 1) / PASS_UNITS;
  const bool live0 = wr < N, live1 = wr + 16 < N;        // the warp's m16 tiles

  const uint32_t base = fmma::smem_addr(dsm);
  float* Ss = reinterpret_cast<float*>(dsm + L.ss);      // bias, scores, e; then P
  uint32_t* Pw = reinterpret_cast<uint32_t*>(Ss);        // P with the bridge: (p, p_b) a key
  uint16_t* Ph = reinterpret_cast<uint16_t*>(Ss);        // P without: p a key
  float* ks_s = reinterpret_cast<float*>(dsm + L.meta);
  float* vs_s = ks_s + L.nkr;
  float* kbs_s = vs_s + L.nkr;
  float* vbs_s = kbs_s + L.nkr;
  uint8_t* fk_s = dsm + L.fk;
  float* mx = reinterpret_cast<float*>(dsm + L.mx);     // [rank][row]
  float* sm = reinterpret_cast<float*>(dsm + L.sm);     // [rank][row]
  float* recv = Ss;                                      // [rank][row][OUT_COLS], last
  // this block has started: the others may write into its shared memory
  // once they have waited on this arrival
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const long long cbase = b * a.c_b + h * a.c_h + k0 * a.c_s;
  auto fetch = [&](int st) {
    if (st < 2 * npass) {
      const bool vst = st >= npass;
      const int p = vst ? st - npass : st;
      const int row0 = PASS_KEYS * p;
      const int nrow = UNIT * min(PASS_UNITS, nu - PASS_UNITS * p);
      const uint32_t dst0 = base + (st % NSTAGE) * L.buf;
#pragma unroll
      for (int bi = 0; bi < NB; ++bi) {
        const int8_t* src = (vst ? (bi ? a.vb : a.v) : (bi ? a.kb : a.k)) + cbase;
        const uint32_t dst = dst0 + bi * PASS_KEYS * ROW_BYTES;
        for (int i = tid; i < nrow * CHUNKS; i += THREADS) {
          const int r = i / CHUNKS, ch = i % CHUNKS, key = row0 + r;
          const bool ok = key < nk;
          fmma::cp_async16(dst + (vst ? swz_v<BRIDGE>(r, ch) : swz_k(r, ch)),
                           src + (ok ? key * a.c_s + 16 * ch : 0), ok);
        }
      }
    }
    fmma::cp_commit();
  };

  // the scales, the live rows' bias (16 bytes a copy where aligned) and
  // stage 0 as one group; then the other first stages
  {
    const long long sb = b * a.s_b + h * a.s_h + k0;
    for (int i = tid; i < nr; i += THREADS) {
      const bool ok = i < nk;
      const long long o = ok ? sb + i : 0;
      dec::cp_async4(fmma::smem_addr(ks_s + i), a.ks + o, ok);
      dec::cp_async4(fmma::smem_addr(vs_s + i), a.vs + o, ok);
      if (BRIDGE) {
        dec::cp_async4(fmma::smem_addr(kbs_s + i), a.kbs + o, ok);
        dec::cp_async4(fmma::smem_addr(vbs_s + i), a.vbs + o, ok);
      }
    }
    const float* bias0 = a.bias + b * a.bias_b + k0;
    if (reinterpret_cast<uintptr_t>(bias0) % 16 == 0 && a.bias_n % 4 == 0) {
      // 2^sh slots a row for its (nk + 3) / 4 copies: a shift and a mask, no
      // division by a count known only at run time (nvcc's takes I2F)
      const int cpr = (nk + 3) / 4;
      const int sh = cpr > 1 ? 32 - __clz(cpr - 1) : 0;
      for (int i = tid; i < (N << sh); i += THREADS) {
        const int n = i >> sh, q4 = 4 * (i & ((1 << sh) - 1));
        if (q4 < nk)
          cp_async16n(fmma::smem_addr(Ss + n * L.sstr + q4), bias0 + n * a.bias_n + q4,
                      4 * min(4, nk - q4));
      }
    } else {
      for (int n = 0; n < N; ++n)
        for (int k = tid; k < nk; k += THREADS)
          dec::cp_async4(fmma::smem_addr(Ss + n * L.sstr + k), bias0 + n * a.bias_n + k, true);
    }
#pragma unroll
    for (int st = 0; st < NSTAGE; ++st) fetch(st);
    for (int i = tid; i < nr; i += THREADS)
      fk_s[i] = BRIDGE && i < nk ? a.flag_kv[b * a.fk_b + k0 + i] : 0;
    if (tid < ROWS) fq_s[tid] = BRIDGE && tid < N ? a.flag_q[b * a.fq_b + tid * a.fq_n] : 0;
  }

  // q in registers as the A operand: qa[mt][kc] holds rows wr + 16 mt + g
  // (a[0], a[2]) and + 8 (a[1], a[3]) at the k slots of key_scores, an 8-byte
  // load each half; 0 past N
  uint32_t qa[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int n = wr + 16 * mt + 8 * hr + g;
#pragma unroll
      for (int kc = 0; kc < 8; ++kc) {
        uint2 u = make_uint2(0u, 0u);
        if (n < N)
          u = __ldg(reinterpret_cast<const uint2*>(a.q + b * a.q_b + n * a.q_n + h * a.q_h +
                                                   32 * t + 16 * (kc / 4) + 4 * (kc % 4)));
        qa[mt][kc][hr] = u.x;
        qa[mt][kc][2 + hr] = u.y;
      }
    }

  // --- scores: warp (wr, c) takes its two m16 tiles by keys 8 c .. 8 c + 7
  // of each K pass ---
  for (int p = 0; p < npass; ++p) {
    fmma::cp_wait<NSTAGE - 1>();
    __syncthreads();
    const uint32_t kbuf = (p % NSTAGE) * L.buf;
    const int nkp = UNIT * min(PASS_UNITS, nu - PASS_UNITS * p);   // keys of the pass
    if (live0 && 8 * c < nkp) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float accb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      key_scores(acc, qa, dsm, kbuf, 8 * c + g, t, live1);
      if (BRIDGE) key_scores(accb, qa, dsm, kbuf + PASS_KEYS * ROW_BYTES, 8 * c + g, t, live1);
      const int lk = PASS_KEYS * p + 8 * c + 2 * t;   // keys lk, lk + 1 of C slots 2 t, 2 t + 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int n = wr + 16 * mt + 8 * hr + g;
          if (mt == 1 && !live1) continue;
          float x[2] = {-INFINITY, -INFINITY};   // past the last key or row: probability 0
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = lk + e;
            if (k < nk && n < N) {
              float v = acc[mt][2 * hr + e] * ks_s[k] * a.scale;
              if (BRIDGE && fq_s[n] != fk_s[k]) v += accb[mt][2 * hr + e] * kbs_s[k] * a.scale;
              x[e] = fmaxf(v + Ss[n * L.sstr + k], BIG_NEG);
            }
          }
          *reinterpret_cast<float2*>(Ss + n * L.sstr + lk) = make_float2(x[0], x[1]);
        }
    }
    __syncthreads();   // the buffer is consumed; the pass's scores are in Ss
    fetch(p + NSTAGE);
  }
  if (npass == 0) {
    fmma::cp_wait<0>();
    __syncthreads();
  }

  // --- softmax: warp w takes rows SROWS w .. + SROWS - 1; the cluster
  // exchanges each row's max, then its sums, over distributed shared memory ---
  float mr[SROWS];
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    const int n = SROWS * warp + i;
    float m = BIG_NEG;
    if (n < N)
      for (int k = lane; k < nk; k += 32) m = fmaxf(m, Ss[n * L.sstr + k]);
    mr[i] = warp_max(m);
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started
  if (lane < RANKS) {
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(mx, lane) + rank * ROWS +
                                            SROWS * warp);
    dst[0] = make_float4(mr[0], mr[1], mr[2], mr[3]);
    dst[1] = make_float4(mr[4], mr[5], mr[6], mr[7]);
  }
  cluster.sync();
  float es[SROWS];
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    const int n = SROWS * warp + i;
    float m = mx[n];
#pragma unroll
    for (int r = 1; r < RANKS; ++r) m = fmaxf(m, mx[r * ROWS + n]);
    float part = 0.f;
    if (n < N)
      for (int k = lane; k < nk; k += 32) {
        const float e = expf(Ss[n * L.sstr + k] - m);
        Ss[n * L.sstr + k] = e;
        part += e;
      }
    es[i] = warp_sum(part);
  }
  if (lane < RANKS) {
    float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(sm, lane) + rank * ROWS +
                                            SROWS * warp);
    dst[0] = make_float4(es[0], es[1], es[2], es[3]);
    dst[1] = make_float4(es[4], es[5], es[6], es[7]);
  }
  cluster.sync();
  // p = bf16((e / L) * vs), p_b = bf16((e / L) * vbs) where cross holds, else
  // 0 (keys past S and rows past N: 0), written over e in place: with the
  // bridge (p, p_b) as the word of the key; without, p as the key's bf16,
  // 32 keys at a time, all read before any is written
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    const int n = SROWS * warp + i;
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < RANKS; ++r) l += sm[r * ROWS + n];
    for (int kk = 0; kk < nr; kk += 32) {
      const int k = kk + lane;
      const bool ok = n < N && k < nk;
      const float an = ok ? Ss[n * L.sstr + k] / l : 0.f;
      if (BRIDGE) {
        const uint32_t pb = ok && fq_s[n] != fk_s[k] ? bf16_bits(an * vbs_s[k]) : 0u;
        if (k < nr) Pw[n * L.sstr + k] = (pb << 16) | (ok ? bf16_bits(an * vs_s[k]) : 0u);
      } else {
        __syncwarp();
        if (k < nr) Ph[2 * n * L.sstr + k] = (uint16_t)(ok ? bf16_bits(an * vs_s[k]) : 0u);
      }
    }
  }

  // --- values: warp (wr, c) takes its rows by d = 32 c .. 32 c + 31 over
  // every key, P by ldmatrix from the rows of the region ---
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][e][i] = 0.f;
  for (int p = 0; p < npass; ++p) {
    fmma::cp_wait<NSTAGE - 1>();
    __syncthreads();   // the pass has landed; the probabilities are written
    const uint32_t vbuf = ((npass + p) % NSTAGE) * L.buf;
    const int nkp = UNIT * min(PASS_UNITS, nu - PASS_UNITS * p);
    const int nks = BRIDGE ? nkp / 8 : nkp / 16;
    if (live0) {
      for (int s = 0; s < nks; ++s) {
        uint32_t bf[4][2];
        value_operands<BRIDGE>(bf, dsm, vbuf, s, c, g, t);
        const uint32_t pa = base + L.ss + 32 * (KSTEPS * p + s) + 16 * (lane >> 4);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt == 1 && !live1) continue;
          uint32_t af[4];
          fmma::ldsm_x4(af, pa + (wr + 16 * mt + (lane & 15)) * L.sstr * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) fmma::mma16816(acc[mt][e], af, bf[e][0], bf[e][1]);
        }
      }
    }
    __syncthreads();
    fetch(npass + p + NSTAGE);
  }

  // --- merge: this lane holds out[row][32 c + 8 t + 0 .. 7] of its rows
  // (acc[mt][e][2 hr] is column 32 c + 8 t + e, acc[mt][e][2 hr + 1] that
  // + 4); rank (32 c + 8 t) / OUT_COLS finishes those columns. The receive
  // buffers lie over P, so every block first finishes its values ---
  cluster.sync();
  {
    const int d0 = DCOLS * c + 8 * t;
    float* dst = cluster.map_shared_rank(recv, d0 / OUT_COLS) + d0 % OUT_COLS;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int n = wr + 16 * mt + 8 * hr + g;
        if (n < N) {
          float4* o = reinterpret_cast<float4*>(dst + (rank * ROWS + n) * OUT_COLS);
          o[0] = make_float4(acc[mt][0][2 * hr], acc[mt][1][2 * hr], acc[mt][2][2 * hr],
                             acc[mt][3][2 * hr]);
          o[1] = make_float4(acc[mt][0][2 * hr + 1], acc[mt][1][2 * hr + 1],
                             acc[mt][2][2 * hr + 1], acc[mt][3][2 * hr + 1]);
        }
      }
  }
  cluster.sync();
  for (int i = tid; i < N * OUT_COLS; i += THREADS) {
    const int n = i / OUT_COLS, col = i % OUT_COLS;
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < RANKS; ++r) o += recv[(r * ROWS + n) * OUT_COLS + col];
    a.out[(((long long)b * N + n) * a.H + h) * D + OUT_COLS * rank + col] = __float2bfloat16(o);
  }
  // Every remote write precedes the last cluster.sync; after it a block
  // reads only its own shared memory.
}

template <bool BRIDGE>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  static bool opened[16];
  cudaError_t e = open_once(attn_wide_kernel<BRIDGE>, opened, SMEM_MAX);
  if (e != cudaSuccess) return e;
  attn_wide_kernel<BRIDGE>
      <<<dim3(RANKS, a.H, B), THREADS, layout(a.S, BRIDGE).total, stream>>>(a);
  return cudaGetLastError();
}

template <bool BRIDGE>
cudaError_t clusters(int S, int* n) {
  static bool opened[16];
  cudaError_t e = open_once(attn_wide_kernel<BRIDGE>, opened, SMEM_MAX);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RANKS, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = layout(S, BRIDGE).total;
  return cudaOccupancyMaxActiveClusters(n, (const void*)attn_wide_kernel<BRIDGE>, &cfg);
}

}  // namespace wide

Args make_args(const void* q, const void* k, const void* v, const void* kb, const void* vb,
               const void* ks, const void* vs, const void* kbs, const void* vbs,
               const void* flag_q, const void* flag_kv, const void* bias, void* out,
               const long long* st, int N, int S, int H, float scale) {
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
  a.q_b = st[0];
  a.q_n = st[1];
  a.q_h = st[2];
  a.c_b = st[3];
  a.c_h = st[4];
  a.c_s = st[5];
  a.s_b = st[6];
  a.s_h = st[7];
  a.bias_b = st[8];
  a.bias_n = st[9];
  a.fq_b = st[10];
  a.fq_n = st[11];
  a.fk_b = st[12];
  a.N = N;
  a.S = S;
  a.H = H;
  a.scale = scale;
  return a;
}

}  // namespace

// The template int8_decode_attention runs for these operands: 1 the decode
// template, 2 the wide one, 0 the rows one. The decode and wide templates
// take 8-byte q loads (q's base, and its b, n and h strides, multiples of 4
// elements), 16-byte cache copies (the cache bases, and the b, h and s
// strides, multiples of 16 bytes), and an S whose shared memory fits; the
// decode template N <= 8 query rows, the wide one 8 < N <= 64.
// strides: as int8_decode_attention's.
extern "C" int int8_decode_attention_template(int N, int S, const long long* strides,
                                              const void* q, const void* k, const void* v,
                                              const void* kb, const void* vb) {
  bool ok = S >= 1 && reinterpret_cast<uintptr_t>(q) % 8 == 0;
  for (int i = 0; i < 3; ++i) ok = ok && strides[i] % 4 == 0;
  for (int i = 3; i < 6; ++i) ok = ok && strides[i] % 16 == 0;
  const void* cache[4] = {k, v, kb, vb};
  for (const void* p : cache) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const bool bridge = kb != nullptr;
  if (ok && N >= 1 && N <= dec::ROWS && dec::layout(S, bridge).total <= dec::SMEM_MAX) return 1;
  if (ok && N > dec::ROWS && N <= wide::ROWS && wide::layout(S, bridge).total <= wide::SMEM_MAX)
    return 2;
  return 0;
}

// The clusters of the decode template that fit on the card at once for a
// cache of S slots, with (bridge = 1) or without the bridge; negative: the
// CUDA error of the query.
extern "C" int int8_decode_attention_clusters(int S, int bridge) {
  int n = 0;
  const cudaError_t e = bridge ? dec::clusters<true>(S, &n) : dec::clusters<false>(S, &n);
  return e == cudaSuccess ? n : -(int)e;
}

// The same for the wide template.
extern "C" int int8_decode_attention_wide_clusters(int S, int bridge) {
  int n = 0;
  const cudaError_t e = bridge ? wide::clusters<true>(S, &n) : wide::clusters<false>(S, &n);
  return e == cudaSuccess ? n : -(int)e;
}

// q (B, N, H, 128) bf16; k/v/kb/vb (B, H, S, 128) int8 with one layout,
// unit stride in the head dim, row stride a multiple of 4 bytes; ks/vs/
// kbs/vbs (B, H, S) fp32 with one layout, unit stride in S; kb/vb/kbs/vbs
// null without the bridge; flag_q (B, N) and flag_kv (B, S) bytes, 0/1,
// flag_kv unit-stride in S; bias (B, N, S) fp32, unit stride in S; out
// (B, N, H, 128) bf16 contiguous; N <= 64.
// strides: 13 element strides, in order
//   q (b, n, h), cache (b, h, s), scales (b, h), bias (b, n),
//   flag_q (b, n), flag_kv (b).
// Launches the template int8_decode_attention_template names. Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int int8_decode_attention(
    const void* q, const void* k, const void* v, const void* kb,
    const void* vb, const void* ks, const void* vs, const void* kbs,
    const void* vbs, const void* flag_q, const void* flag_kv,
    const void* bias, void* out, const long long* strides, int B, int N,
    int S, int H, float scale, void* stream) {
  const Args a = make_args(q, k, v, kb, vb, ks, vs, kbs, vbs, flag_q, flag_kv, bias, out,
                           strides, N, S, H, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bridge = kb != nullptr;
  switch (int8_decode_attention_template(N, S, strides, q, k, v, kb, vb)) {
    case 1:
      return bridge ? (int)dec::launch<true>(a, B, st) : (int)dec::launch<false>(a, B, st);
    case 2:
      return bridge ? (int)wide::launch<true>(a, B, st) : (int)wide::launch<false>(a, B, st);
    default:
      return (int)launch_rows(a, B, st);
  }
}

// The rows template alone, for any N <= 64, with int8_decode_attention's
// arguments.
extern "C" int int8_decode_attention_rows(
    const void* q, const void* k, const void* v, const void* kb,
    const void* vb, const void* ks, const void* vs, const void* kbs,
    const void* vbs, const void* flag_q, const void* flag_kv,
    const void* bias, void* out, const long long* strides, int B, int N,
    int S, int H, float scale, void* stream) {
  const Args a = make_args(q, k, v, kb, vb, ks, vs, kbs, vbs, flag_q, flag_kv, bias, out,
                           strides, N, S, H, scale);
  return (int)launch_rows(a, B, static_cast<cudaStream_t>(stream));
}
