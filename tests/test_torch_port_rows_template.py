"""A CPU rehearsal of the rows template of the int4 and int8 matmul kernels
(``libra_tpu_torch/csrc/rows_mma.cuh`` with the weight modes of
``int4_matmul.cu`` and ``int8_matmul.cu``, namespace ``rows``), in numpy
and torch only.

No CUDA kernel runs here, so the template's steps are emulated with the
constants read from the CUDA sources themselves (the tile, stage, unit and
ring sizes of the header; the sign flip, nibble mask, ``prmt`` selectors,
bf16 128 and offset of the weight-only mode; the transpose selectors, high
nibble flip and magic number of W4A8; B2's decode magic and the pair
selector), the lanes' shared-memory addresses taken from the same
expressions the kernels use (the swizzles are checked against the source
text), and the mma operands assembled by the PTX fragment layouts:

* in each mode the lanes' fragments of a unit cover every (weight row,
  column) of the warp's 32 columns once and every (row of x, k) of its
  n8 tiles once, and their products equal the unit's x w exactly;
* the lanes' shared-memory loads of a phase take distinct banks;
* the W4A8 pre-pass (absmax, IEEE division, rint, the even/odd staging,
  the group sums of xq) is bitwise ``int4_matmul.quantize_rows``, .5
  ties and a zero row included;
* the whole template (the split of K in whole stages over the cluster's
  ranks, the ring's zero-filled rows, columns and k, the group folds, the
  warp then rank order of the sums, the row and column scales) equals
  ``int4_matmul_plain`` (both modes) and ``int8_matmul_plain`` to fp32
  round-off, for M in {9, 16, 33, 128, 160}, a ragged F and small K;
* a Python mirror of the three-way template gates sends the split prompt
  pass's three shapes at M = 128 to "rows", M <= 8 to "decode" and an
  unaligned pitch to "chunked", and the shared-memory layout of every
  mode and split fits the card;
* a change to a constant in the source text fails these checks.

The kernels themselves are held against the plain versions on the card by
``chip_smoke.py`` phase 4.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
# the PTX prmt, bf16 rounding and halves, and the W4A8 transpose and
# nibble masks, shared with the rehearsals of the experiment's template
from test_torch_port_int4_exp_decode_kernel import bf16_bits, halves, prmt  # noqa: E402
from test_torch_port_int4_exp_a8_decode_kernel import byte, nibbles, transpose  # noqa: E402

from libra_tpu_torch.ops import int4_matmul as ti4  # noqa: E402
from libra_tpu_torch.ops import int8_matmul as ti8  # noqa: E402

HEADER = (ti4.SOURCE.parent / "rows_mma.cuh").read_text()
SRC4 = ti4.SOURCE.read_text()
SRC8 = ti8.SOURCE.read_text()
U32, I64, F32 = np.uint32, np.int64, np.float32
MODES = ("int8", "int4", "int4 a8")
WARP = np.arange(8)[:, None]            # (8, 1): warp w
LANE = np.arange(32)[None, :]           # (1, 32): lane 4 g + t
G_, T_ = LANE // 4, LANE % 4
CW, RW = WARP % 4, WARP // 4


def body(text: str, ns: str) -> str:
    return text[text.index(f"namespace {ns} {{"):text.index(f"}}  // namespace {ns}")]


def read_constants(text: str, env: dict = None) -> dict:
    """The ``constexpr`` scalars of text, with the names of env."""
    out = dict(env or {})
    for kind, name, value in re.findall(r"constexpr\s+(int|uint32_t|float)\s+(\w+)\s*=\s*"
                                        r"([-+*/ \w.()]+);", text):
        v = value.strip()
        if re.fullmatch(r"0x[0-9A-Fa-f]+u?", v):
            out[name] = int(v.rstrip("u"), 16)
            continue
        v = re.sub(r"(\d\.?\d*)f\b", r"\1", v)   # a float literal's suffix
        try:   # an expression of the names before it
            out[name] = eval(v, {"__builtins__": {}}, dict(out))   # noqa: S307
        except NameError:
            continue
        if kind == "int":
            out[name] = int(out[name])
    return out


def constants(header=HEADER, src4=SRC4, src8=SRC8) -> dict:
    """Per mode: the header's constants, then the mode's (int8: B2's decode
    magic of namespace dec, then namespace rows)."""
    h = read_constants(body(header, "rowsmma"))
    c4 = read_constants(body(src4, "rows"), h)
    dec = read_constants(body(src8, "dec"))
    magic = {k: dec[k] for k in ("SIGN_FLIP", "MAGIC", "MAGIC_BIAS", "SEL0", "SEL1", "SEL2",
                                 "SEL3")}
    c8 = read_constants(body(src8, "rows"), {**h, **magic})
    return {"int8": c8, "int4": c4, "int4 a8": c4}


C = constants()


# ---------------------------------------------------------------------------
# The kernels' address expressions and the copies' placement
# ---------------------------------------------------------------------------

def swz(c, r, ch, sh):
    return r * c["ROW"] + ((ch ^ (((r >> sh) & 3) << 1)) << 4)


def swz16(c, r, ch):
    return r * c["X16_ROW"] + ((ch ^ ((r & 1) << 2)) << 4)


def w_lane(c, sh):
    """(8 warps, 32 lanes): the lane's first weight word of a stage."""
    return ((((2 * CW + (G_ >> 2)) ^ (T_ << 1))) << 4) + 4 * (G_ & 3) + (T_ << sh) * c["ROW"]


def x_lane(c, mode, u):
    """(8, 32): the lane's x bytes of unit u in n8 tile 0 (bf16 x: 16 bytes
    at k 8 t of the unit; W4A8: 8 bytes, its 4 even then 4 odd k)."""
    if mode == "int4 a8":
        return ((c["WROWS"] * RW + G_) * c["ROW"]
                + (((2 * u + (T_ >> 1)) ^ ((G_ & 3) << 1)) << 4) + 8 * (T_ & 1))
    return (c["WROWS"] * RW + G_) * c["X16_ROW"] + (((4 * u + T_) ^ ((G_ & 1) << 2)) << 4)


SOURCE_EXPRS = [
    (HEADER, "return r * ROW + ((c ^ (((r >> sh) & 3) << 1)) << 4);"),
    (HEADER, "return r * X16_ROW + ((c ^ ((r & 1) << 2)) << 4);"),
    (HEADER, "return w + ((((2 * L.cw + (L.g >> 2)) ^ (L.t << 1))) << 4) + 4 * (L.g & 3) "
             "+ (L.t << SH) * ROW;"),
    (SRC4, "x + (WROWS * L.rw + L.g) * ROW + (((2 * u + (L.t >> 1)) ^ ((L.g & 3) << 1)) << 4) "
           "+ 8 * (L.t & 1);"),
    (SRC4, "x + (WROWS * L.rw + L.g) * X16_ROW + (((4 * u + L.t) ^ ((L.g & 1) << 2)) << 4);"),
    (SRC8, "x + (WROWS * L.rw + L.g) * X16_ROW + (((4 * u + L.t) ^ ((L.g & 1) << 2)) << 4);"),
    (SRC4, "rowsmma::w_lane<2>(w, L)"),
    (SRC8, "rowsmma::w_lane<3>(w, L)"),
    (SRC4, "wl + (16 * u + r) * ROW"),
    (SRC8, "wl + (32 * u + 2 * i) * ROW"),
    (SRC8, "wl + (32 * u + 2 * i + 1) * ROW"),
    (SRC4, "rowsmma::stage_bytes_of<KT / 2, 2>"),
    (SRC8, "rowsmma::stage_bytes_of<KT, 3>"),
    (HEADER, "cp_async16(dst + swz(r, c, SH)"),
    (HEADER, "cp_async16(dst + (X8 ? swz(m, c, 0) : swz16(m, c)),"),
]


def flat(text: str) -> str:
    return re.sub(r"\s+", " ", text)


def place(rows: np.ndarray, offset) -> np.ndarray:
    """The bytes rows (n, R) of a staged region, each 16-byte chunk ch of
    row r at offset(r, ch), as the ring's copies put them."""
    n, R = rows.shape
    out = np.zeros(n * R, np.uint8)
    r, ch = np.meshgrid(np.arange(n), np.arange(R // 16), indexing="ij")
    out[offset(r, ch)[..., None] + np.arange(16)] = rows.reshape(n, R // 16, 16)
    return out


def read(region: np.ndarray, addr: np.ndarray, nwords: int) -> np.ndarray:
    """The little-endian words at addr (...,): (..., nwords)."""
    b = region[addr[..., None] + np.arange(4 * nwords)].astype(U32).reshape(
        addr.shape + (nwords, 4))
    return b[..., 0] | b[..., 1] << U32(8) | b[..., 2] << U32(16) | b[..., 3] << U32(24)


def stage_w(c, mode, w: np.ndarray, kbase: int, f0: int) -> np.ndarray:
    """A stage's weight rows (int4: KT / 2 byte rows; int8: KT k rows) of
    the tile's TILE_F columns, zero past the matrix, swizzled."""
    n = c["KT"] // 2 if mode != "int8" else c["KT"]
    r0 = kbase // 2 if mode != "int8" else kbase
    rows = np.zeros((n, c["TILE_F"]), np.uint8)
    part = w[r0:r0 + n, f0:f0 + c["TILE_F"]].view(np.uint8)
    rows[:part.shape[0], :part.shape[1]] = part
    return place(rows, lambda r, ch: swz(c, r, ch, 2 if mode != "int8" else 3))


def stage_x(c, mode, xs: np.ndarray, m0: int, kbase: int) -> np.ndarray:
    """A stage's x (bf16 codes, or W4A8's staged int8 bytes) for the tile's
    TILE_M rows, zero past M and K, swizzled."""
    TM, KT = c["TILE_M"], c["KT"]
    if mode == "int4 a8":
        rows = np.zeros((TM, KT), np.uint8)
        part = xs[m0:m0 + TM, kbase:kbase + KT].astype(np.int8).view(np.uint8)
        rows[:part.shape[0], :part.shape[1]] = part
        return place(rows, lambda r, ch: swz(c, r, ch, 0))
    rows = np.zeros((TM, KT), np.uint16)
    part = xs[m0:m0 + TM, kbase:kbase + KT]
    rows[:part.shape[0], :part.shape[1]] = part
    return place(rows.view(np.uint8), lambda r, ch: swz16(c, r, ch))


# ---------------------------------------------------------------------------
# Weight conversions, fragments, products
# ---------------------------------------------------------------------------

def bf16x2_fma(a, b, d) -> np.ndarray:
    """PTX fma.rn.bf16x2 on words of two bf16."""
    (a0, a1), (b0, b1), (d0, d1) = halves(a), halves(b), halves(np.broadcast_to(U32(d), a.shape))
    lo = (a0.astype(np.float64) * b0 + d0).astype(F32)
    hi = (a1.astype(np.float64) * b1 + d1).astype(F32)
    return bf16_bits(lo) | (bf16_bits(hi) << U32(16))


def int4_pairs(c, wv: np.ndarray) -> np.ndarray:
    """Weight-only: (..., 4 byte rows) words -> (..., 4 rows, 4 columns)
    bf16 pairs {q0, q1}: XOR, masks, PRMT, OR and one bf16x2 fma a byte."""
    uw = wv ^ U32(c["SIGN_FLIP"])
    lo, hi = uw & U32(c["NIB_MASK"]), (uw >> U32(4)) & U32(c["NIB_MASK"])
    one = np.broadcast_to(U32(c["BF16_ONE"]), uw.shape)
    return np.stack([bf16x2_fma(prmt(lo, hi, c[f"SEL{k}"]) | U32(c["BF16_128"]), one,
                                c["OFFSET"]) for k in range(4)], -1)


def int8_weight(c, v, sel) -> np.ndarray:
    """B2's decode magic: the exact fp32 of the byte sel picks, as bits."""
    f = prmt(v, U32(c["MAGIC"]), sel).view(F32) - F32(c["MAGIC_BIAS"])
    return np.ascontiguousarray(f, F32).view(U32)


def int8_pairs(c, even: np.ndarray, odd: np.ndarray) -> np.ndarray:
    """(...,) words of k rows 2 i and 2 i + 1 -> (..., 4 columns) bf16
    pairs: the exact floats' high halves joined by PAIR_HI."""
    v0, v1 = even ^ U32(c["SIGN_FLIP"]), odd ^ U32(c["SIGN_FLIP"])
    return np.stack([prmt(int8_weight(c, v0, c[f"SEL{k}"]), int8_weight(c, v1, c[f"SEL{k}"]),
                          c["PAIR_HI"]) for k in range(4)], -1)


def frag_a16(regs):
    """A (16 x 16) of m16n8k16 from the lanes' (..., 32, 4) bf16x2 words."""
    A = np.zeros(regs.shape[:-2] + (16, 16))
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for reg, (r0, k0) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = halves(regs[..., reg])
        A[..., g + r0, k0 + 2 * t] = lo
        A[..., g + r0, k0 + 2 * t + 1] = hi
    return A


def frag_b16(regs):
    """B (16 x 8) of m16n8k16 from the lanes' (..., 32, 2) words."""
    B = np.zeros(regs.shape[:-2] + (16, 8))
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for reg, k0 in enumerate((0, 8)):
        lo, hi = halves(regs[..., reg])
        B[..., k0 + 2 * t, g] = lo
        B[..., k0 + 2 * t + 1, g] = hi
    return B


def frag_a8(regs):
    """A (16 x 32) u8 of m16n8k32 from the lanes' (..., 32, 4) words."""
    A = np.zeros(regs.shape[:-2] + (16, 32), I64)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for reg, (r0, k0) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
        for i in range(4):
            A[..., g + r0, k0 + 4 * t + i] = byte(regs[..., reg], i)
    return A


def frag_b8(regs):
    """B (32 x 8) s8 of m16n8k32 from the lanes' (..., 32, 2) words."""
    B = np.zeros(regs.shape[:-2] + (32, 8), I64)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for reg, k0 in enumerate((0, 16)):
        for i in range(4):
            B[..., k0 + 4 * t + i, g] = byte(regs[..., reg], i, signed=True)
    return B


def lanes(D):
    """(..., 16, 8) -> each lane's C fragment (..., 32, 4)."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    return np.stack([D[..., g, 2 * t], D[..., g, 2 * t + 1], D[..., g + 8, 2 * t],
                     D[..., g + 8, 2 * t + 1]], -1)


def unit_products(c, mode, w_st, x_st, u: int) -> list:
    """Unit u of a stage, every warp: the mma products as each lane's C
    fragments, (8 warps, 32 lanes, 2 column pairs, NJ, 4), one array per
    mma into the same sums (h = 0, 1; W4A8 one)."""
    NJ, jrow = c["NJ"], 8 * np.arange(c["NJ"])
    if mode == "int8":
        wl = w_lane(c, 3)
        pr = np.stack([int8_pairs(c, read(w_st, wl + (32 * u + 2 * i) * c["ROW"], 1)[..., 0],
                                  read(w_st, wl + (32 * u + 2 * i + 1) * c["ROW"], 1)[..., 0])
                       for i in range(4)], -2)                     # (8, 32, 4 i, 4 c)
    else:
        wv = read(w_st, w_lane(c, 2)[..., None] + (16 * u + np.arange(4)) * c["ROW"], 1)[..., 0]
        if mode == "int4":
            pr = int4_pairs(c, wv)                                 # (8, 32, 4 r, 4 c)
        else:
            lo, hi = nibbles(c, transpose(c, wv))                  # (8, 32, 4 c)
            A = frag_a8(np.stack([np.stack([lo[..., 2 * p], lo[..., 2 * p + 1], hi[..., 2 * p],
                                            hi[..., 2 * p + 1]], -1) for p in range(2)], 1))
            xv = read(x_st, x_lane(c, mode, u)[..., None] + jrow * c["ROW"], 2)   # (8, 32, NJ, 2)
            B = frag_b8(np.moveaxis(xv, 2, 1))                                   # (8, NJ, 32, 8)
            return [lanes(np.einsum("wpik,wjkn->wpjin", A, B)).transpose(0, 3, 1, 2, 4)]
    xv = read(x_st, x_lane(c, mode, u)[..., None] + jrow * c["X16_ROW"], 4)      # (8, 32, NJ, 4)
    out = []
    for h in range(2):
        A = frag_a16(np.stack([np.stack([pr[..., 2 * h, 2 * p], pr[..., 2 * h, 2 * p + 1],
                                         pr[..., 2 * h + 1, 2 * p], pr[..., 2 * h + 1, 2 * p + 1]],
                                        -1) for p in range(2)], 1))             # (8, 2, 16, 16)
        B = frag_b16(np.moveaxis(xv[..., 2 * h:2 * h + 2], 2, 1))               # (8, NJ, 16, 8)
        out.append(lanes(np.einsum("wpik,wjkn->wpjin", A, B)).transpose(0, 3, 1, 2, 4))
    return out


def positions(c):
    """(8, 32, 2, NJ, 4): each C element's row of x and column in a tile."""
    p = np.arange(2)[None, None, :, None, None]
    j = np.arange(c["NJ"])[None, None, None, :, None]
    e = np.arange(4)[None, None, None, None, :]
    g, t = G_[..., None, None, None], T_[..., None, None, None]
    row = c["WROWS"] * RW[..., None, None, None] + 8 * j + 2 * t + e % 2
    col = 32 * CW[..., None, None, None] + 4 * g + 2 * p + e // 2
    return np.broadcast_arrays(row, col)


# ---------------------------------------------------------------------------
# The W4A8 pre-pass and the whole template
# ---------------------------------------------------------------------------

def prepass(x: np.ndarray, G: int) -> tuple:
    """The pre-pass on x (M, K) fp32 holding bf16 values: (staged xq (M, K)
    int8 values, group sums (K / G, M), sx (M,), xq (M, K))."""
    M, K = x.shape
    amax = np.abs(x).max(axis=1).astype(F32)
    s = (np.where(amax > 0, amax, F32(1)).astype(F32) / F32(127)).astype(F32)
    q = np.rint((x / s[:, None]).astype(F32)).astype(I64)
    b = q & 255
    even = sum(b[:, 2 * i::8] << (8 * i) for i in range(4)).astype(U32)   # per 8 k: k 2 i
    odd = sum(b[:, 2 * i + 1::8] << (8 * i) for i in range(4)).astype(U32)
    st = np.ascontiguousarray(np.stack([even, odd], -1)).view(np.int8).reshape(M, K)
    return st.astype(I64), q.reshape(M, K // G, G).sum(-1).T, s, q


def magic(c, n) -> np.ndarray:
    bits = ((np.asarray(n, I64) + c["MAGIC_I"]) & 0xFFFFFFFF).astype(U32)
    return np.ascontiguousarray(bits).view(F32) - F32(c["MAGIC_F"])


def emulate(c, mode, x, w, s, G: int, KS: int) -> np.ndarray:
    """The rows template step by step: every lane of every warp of every
    rank and tile. x (M, K) fp32 bf16 values; w: int8 q (K, F) or int4
    packed (K / 2, F); s: int8 scale (F,), int4 scales (K / G, F). The (M,
    F) fp32 result before its bf16 rounding."""
    M, K = x.shape
    F = w.shape[1]
    KT, UK, TF, TM, NJ = c["KT"], c["UNIT_K"], c["TILE_F"], c["TILE_M"], c["NJ"]
    a8, int4 = mode == "int4 a8", mode != "int8"
    if a8:
        xs, gsum, sx, _ = prepass(x, G)
    else:
        xs = bf16_bits(x).astype(np.uint16)
    S = -(-K // KT)
    nft = -(-F // TF)
    row_in, col_in = positions(c)
    j_idx = np.arange(NJ)[None, None, None, :, None]
    out = np.zeros((M, F), F32)
    for tile in range(nft * -(-M // TM)):
        f0, m0 = tile % nft * TF, tile // nft * TM
        live = M - m0 - c["WROWS"] * RW + 7
        nj = np.maximum(0, np.minimum(NJ, np.trunc(live / 8).astype(int)))   # C division
        jlive = j_idx < nj[..., None, None, None]
        sums = []
        for rank in range(KS):
            s0, ns = S * rank // KS, S * (rank + 1) // KS - S * rank // KS
            kend = min(K, KT * (s0 + ns))
            acc = np.zeros((8, 32, 2, NJ, 4), F32)
            part = np.zeros_like(acc, I64 if a8 else F32)
            for ks in range(ns):
                kbase = KT * (s0 + ks)
                w_st, x_st = stage_w(c, mode, w, kbase, f0), stage_x(c, mode, xs, m0, kbase)
                if int4:   # the aux rows: the groups' scales (W4A8: and group sums of xq)
                    gs_n = c["GSLOTS"]
                    sc = np.zeros((gs_n, TF), F32)
                    gsm = np.zeros((gs_n, TM), I64)
                    for sl in range(gs_n):
                        g = kbase // G + sl
                        if g * G < min(kbase + KT, K):
                            cols = s[g, f0:f0 + TF]
                            sc[sl, :cols.shape[0]] = cols
                            if a8:
                                rows = gsum[g, m0:m0 + TM]
                                gsm[sl, :rows.shape[0]] = rows
                for u in range(c["UNITS"]):
                    kk = kbase + UK * u
                    if kk >= kend:
                        break
                    for d in unit_products(c, mode, w_st, x_st, u):   # past M: zero rows
                        if mode == "int8":
                            acc = (acc + d).astype(F32)
                        elif a8:
                            part = part + d.astype(I64)
                        else:
                            part = (part + d).astype(F32)
                    if int4 and (kk + UK) % G == 0:   # fold the group
                        sl = kk // G - kbase // G
                        scale = sc[sl][(32 * CW + 4 * G_)[..., None] + np.arange(4)]  # (8, 32, 4)
                        # C element e of column pair p: column 4 g + 2 p + e // 2
                        s_pe = np.stack([scale[..., [2 * p, 2 * p, 2 * p + 1, 2 * p + 1]]
                                         for p in range(2)], 2)[:, :, :, None, :]
                        if a8:   # and x row 2 t + e % 2
                            rows = (c["WROWS"] * RW[..., None] + 8 * np.arange(NJ)
                                    + 2 * T_[..., None])                             # (8, 32, NJ)
                            gs = gsm[sl][rows[..., None] + np.array([0, 1, 0, 1])]
                            f = magic(c, part - 8 * gs[:, :, None]).astype(np.float64)
                        else:
                            f = part.astype(np.float64)
                        acc = np.where(jlive, (f * s_pe + acc).astype(F32), acc)
                        part = np.zeros_like(part)
            sums.append(acc)
        tot = np.zeros_like(sums[0])
        for acc in sums:   # rank order
            tot = (tot + acc).astype(F32)
        row, col = row_in + m0, col_in + f0
        ok = jlive & (row < M) & (col < F)
        rs = sx[np.minimum(row, M - 1)] if a8 else F32(1)
        cs = s[np.minimum(col, F - 1)] if mode == "int8" else F32(1)
        val = ((tot * rs).astype(F32) * cs).astype(F32)
        out[row[ok], col[ok]] = val[ok]
    return out


def inputs(mode, M, K, F, G, seed):
    """bf16 x (a zero row; a row whose x / sx hits .5 ties), weights over
    the whole byte range, scales; as the plain version's tensors."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(F32)).bfloat16()
    x[3] = 0
    x[0] = torch.from_numpy(rs.randint(-254, 255, size=K) / 2.0).bfloat16()
    x[0, 0] = 127
    if mode == "int8":
        w = torch.from_numpy(rs.randint(-127, 128, size=(K, F)).astype(np.int8))
        s = torch.from_numpy((rs.rand(1, F) * 2e-3).astype(F32))
    else:
        w = torch.from_numpy(rs.randint(-128, 128, size=(K // 2, F)).astype(np.int8))
        s = torch.from_numpy((rs.rand(K // G, F) * 2e-2).astype(F32))
    return x, w, s


def plain(mode, x, w, s, G):
    if mode == "int8":
        return ti8.int8_matmul_plain(x.float(), w, s).numpy()
    return ti4.int4_matmul_plain(x.float(), w, s, G, a8=mode == "int4 a8").numpy()


def check_template(c, mode, M, K, F, G, KS, seed) -> None:
    """The emulation against the plain version: exact products (integer in
    W4A8), fp32 sums in another order; within 1e-5 of max|ref|. The zero
    row of x is exactly 0."""
    x, w, s = inputs(mode, M, K, F, G, seed)
    want = plain(mode, x, w, s, G)
    got = emulate(c, mode, x.float().numpy(), w.numpy(), s.numpy()[0] if mode == "int8"
                  else s.numpy(), G, KS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not got[3].any()


def check_unit(c, mode, seed) -> None:
    """One stage of random weights and x (small integers, so every sum is
    exact): each warp's unit products equal its 32 columns x its rows of
    x w over the unit's k, exactly."""
    rs = np.random.RandomState(seed)
    KT, NJ = c["KT"], c["NJ"]
    x = rs.randint(-8, 9, size=(c["TILE_M"], KT)).astype(F32)
    if mode == "int8":
        w = rs.randint(-128, 128, size=(KT, c["TILE_F"])).astype(np.int8)
        wk = w.astype(I64)
    else:
        w = rs.randint(-128, 128, size=(KT // 2, c["TILE_F"])).astype(np.int8)
        wk = np.empty((KT, c["TILE_F"]), I64)
        wk[0::2], wk[1::2] = (w.astype(I64) & 15) - 8, w.astype(I64) >> 4
        if mode == "int4 a8":
            wk = wk + 8                                   # the u8 nibbles, q + 8
    if mode == "int4 a8":
        xs = prepass(np.where(np.arange(c["TILE_M"])[:, None] == 0, 127, x).astype(F32), KT)[0]
        xk = xs.reshape(-1, KT // 8, 2, 4).transpose(0, 1, 3, 2).reshape(-1, KT)   # unstaged
    else:
        xs, xk = bf16_bits(x).astype(np.uint16), x.astype(I64)
    w_st, x_st = stage_w(c, mode, w, 0, 0), stage_x(c, mode, xs, 0, 0)
    row, col = positions(c)
    for u in range(c["UNITS"]):
        got = sum(d.astype(np.float64) for d in unit_products(c, mode, w_st, x_st, u))
        k = slice(c["UNIT_K"] * u, c["UNIT_K"] * (u + 1))
        want = (xk[:, k].astype(np.float64) @ wk[k].astype(np.float64))[row, col]
        np.testing.assert_array_equal(got, want)
    assert NJ * 8 == c["WROWS"]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_constants_read_from_the_sources():
    h = C["int4"]
    assert (h["KT"], h["UNIT_K"], h["UNITS"], h["TILE_F"], h["TILE_M"], h["NJ"], h["NS"]) == \
        (128, 32, 4, 128, 128, 8, 3)
    assert {"SEL_LO", "SEL_HI", "SEL_W0", "SEL_W1", "NIB_MASK", "HI_FLIP", "MAGIC_I", "MAGIC_F",
            "SIGN_FLIP", "SEL0", "SEL3", "BF16_128", "BF16_ONE", "OFFSET", "GSLOTS",
            "W_BYTES", "S_BYTES"} <= set(h)
    assert {"PAIR_HI", "SIGN_FLIP", "MAGIC", "MAGIC_BIAS", "SEL0", "W_BYTES"} <= set(C["int8"])
    assert np.array([h["MAGIC_I"]], U32).view(F32)[0] == h["MAGIC_F"] == 1.5 * 2 ** 23
    assert "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32" in HEADER
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in HEADER
    assert '#include "rows_mma.cuh"' in SRC4 and '#include "rows_mma.cuh"' in SRC8


@pytest.mark.parametrize("i", range(len(SOURCE_EXPRS)))
def test_address_expressions_are_the_sources(i):
    """The swizzles, lane addresses and copies this rehearsal mirrors are
    the ones in the CUDA text."""
    text, expr = SOURCE_EXPRS[i]
    assert flat(expr) in flat(text)


@pytest.mark.parametrize("mode", MODES)
def test_fragments_cover_each_weight_and_x_once(mode):
    """Labels in place of data: each staged word holds its own (row, word)
    id. Over a unit a warp's weight loads take every word of the unit's
    rows in its 32 columns once, and its x loads in n8 tile j every (row
    of the tile, k) of the unit once."""
    c = C[mode]
    KT, UK, ROW = c["KT"], c["UNIT_K"], c["ROW"]
    if mode == "int8":   # the lane's k rows 32 u + 8 t + i, i < 8
        nrows, sh, rpu, offs = KT, 3, UK, lambda u: 32 * u + np.arange(8)
    else:                # its byte rows 16 u + 4 t + r, r < 4
        nrows, sh, rpu, offs = KT // 2, 2, UK // 2, lambda u: 16 * u + np.arange(4)
    ids = np.arange(nrows * 32, dtype=U32).reshape(nrows, 32)             # (row, word)
    w_st = place(ids.view(np.uint8).reshape(nrows, ROW), lambda r, ch: swz(c, r, ch, sh))
    x8 = mode == "int4 a8"
    # words of x: a staged row, a unit's k, a lane's load
    xw, kw, nw = (KT // 4, UK // 4, 2) if x8 else (KT // 2, UK // 2, 4)
    xid = np.arange(c["TILE_M"] * xw, dtype=U32).reshape(c["TILE_M"], xw)
    x_st = place(xid.view(np.uint8), (lambda r, ch: swz(c, r, ch, 0)) if x8
                 else (lambda r, ch: swz16(c, r, ch)))
    for u in range(c["UNITS"]):
        got = read(w_st, w_lane(c, sh)[..., None] + offs(u) * ROW, 1)[..., 0]   # (8, 32, rows)
        for w in range(8):
            want = ids[rpu * u:rpu * (u + 1), 8 * (w % 4):8 * (w % 4) + 8].ravel()
            assert sorted(got[w].ravel().tolist()) == sorted(want.tolist()), (mode, u, w)
        for j in range(c["NJ"]):
            got = read(x_st, x_lane(c, mode, u) + 8 * j * (ROW if x8 else c["X16_ROW"]), nw)
            for w in range(8):
                r0 = c["WROWS"] * (w // 4) + 8 * j
                want = xid[r0:r0 + 8, kw * u:kw * (u + 1)].ravel()
                assert sorted(got[w].ravel().tolist()) == sorted(want.tolist()), (mode, u, j, w)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("mode", MODES)
def test_unit_products_pair_each_weight_with_its_x(mode, seed):
    check_unit(C[mode], mode, seed)


def _banks_distinct(addr: np.ndarray, nbytes: int, phase: int) -> bool:
    """Lanes' loads of nbytes at addr (32,): each phase of `phase` lanes
    touches each bank through one word only."""
    for p0 in range(0, 32, phase):
        seen = {}
        for a in addr[p0:p0 + phase]:
            for wd in range(a // 4, (a + nbytes) // 4):
                if seen.setdefault(wd % 32, wd) != wd:
                    return False
    return True


@pytest.mark.parametrize("mode", MODES)
def test_shared_loads_take_distinct_banks(mode):
    """Weight words (4 bytes, one phase a warp), bf16 x (16 bytes, 8 lanes
    a phase) and W4A8 x (8 bytes, 16 lanes a phase), every warp, unit and
    n8 tile."""
    c = C[mode]
    sh = 3 if mode == "int8" else 2
    rows = [32 * u + i for u in range(4) for i in range(8)] if mode == "int8" \
        else [16 * u + r for u in range(4) for r in range(4)]
    x8 = mode == "int4 a8"
    for w in range(8):
        for r in rows:
            assert _banks_distinct((w_lane(c, sh) + r * c["ROW"])[w], 4, 32)
        for u in range(c["UNITS"]):
            for j in range(c["NJ"]):
                a = x_lane(c, mode, u)[w] + 8 * j * (c["ROW"] if x8 else c["X16_ROW"])
                assert _banks_distinct(a, 8 if x8 else 16, 16 if x8 else 8), (w, u, j)


def _ties_row():
    r = np.resize(np.array([127, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 3.5], F32), 256)
    return torch.from_numpy(r).bfloat16().float().numpy()


@pytest.mark.parametrize("case", ["ties", "zero-row", "random", "tiny-and-huge"])
def test_prepass_is_the_plain_quantization(case):
    """The pre-pass's sx and xq (unstaged from its even/odd order) are
    bitwise ``quantize_rows``'s, and its group sums are the sums of xq."""
    rs = np.random.RandomState(3)
    x = {"ties": lambda: np.stack([_ties_row(), -_ties_row()]),
         "zero-row": lambda: np.stack([np.zeros(256, F32), rs.randn(256).astype(F32)]),
         "random": lambda: rs.randn(9, 4096).astype(F32),
         "tiny-and-huge": lambda: np.stack([rs.randn(256).astype(F32) * 1e-30,
                                            rs.randn(256).astype(F32) * 3e30])}[case]()
    x = torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float().numpy()
    if case == "ties":
        assert (np.abs(x[0, 1:]) % 1 == 0.5).sum() > 8
    st, gsum, s, q = prepass(x, 128)
    want, want_s = ti4.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(s, want_s[:, 0].numpy())
    np.testing.assert_array_equal(q, want.numpy().astype(I64))
    M, K = x.shape
    unstaged = st.reshape(M, K // 8, 2, 4).transpose(0, 1, 3, 2).reshape(M, K)
    np.testing.assert_array_equal(unstaged, q)
    np.testing.assert_array_equal(gsum, q.reshape(M, K // 128, 128).sum(-1).T)


def test_prepass_packing_is_the_sources():
    """The pre-pass stores k 8 c + 2 i in byte i of the even word and k 8 c
    + 2 i + 1 in byte i of the odd word, and sums each group of xq."""
    text = flat(body(SRC4, "rows"))
    for expr in ("const int q0 = (int)rintf(__fdiv_rn(dec::bf_lo(h[i]), s));",
                 "const int q1 = (int)rintf(__fdiv_rn(dec::bf_hi(h[i]), s));",
                 "even |= ((uint32_t)q0 & 255u) << (8 * i);",
                 "odd |= ((uint32_t)q1 & 255u) << (8 * i);",
                 "make_uint2(even, odd)", "atomicAdd(&gs[8 * c / a.G], sum);",
                 "__fdiv_rn(amax > 0.f ? amax : 1.f, 127.f)"):
        assert flat(expr) in text, expr


@pytest.mark.parametrize("M", [9, 16, 33, 128, 160])
@pytest.mark.parametrize("mode", MODES)
def test_emulated_template_matches_plain(mode, M):
    """K = 640 (5 stages: ranks of 2 and 3 at KS = 2), G = 128, F = 176
    (the second tile's last 80 columns past F); M = 160 takes a second row
    tile with one live n8 warp row."""
    check_template(C[mode], mode, M, 640, 176, 128, 2, seed=M)


@pytest.mark.parametrize("mode,M,K,G,KS", [
    ("int8", 33, 352, 128, 2),          # a partial last stage (96 k)
    ("int8", 160, 640, 128, 4),
    ("int4", 128, 352, 32, 2),          # four groups a stage
    ("int4 a8", 128, 352, 32, 2),
    ("int4", 16, 384, 64, 2),
    ("int4 a8", 9, 384, 64, 2),
    ("int4 a8", 128, 1024, 128, 8),     # a stage a rank
    ("int4", 33, 1024, 128, 8),
])
def test_emulated_template_splits_and_groups(mode, M, K, G, KS):
    check_template(C[mode], mode, M, K, 176, G, KS, seed=K + M)


# ---------------------------------------------------------------------------
# The gates, the layout, the workspace, chip_smoke's rules
# ---------------------------------------------------------------------------

def dec4_smem(K: int, a8: bool) -> int:
    """int4_matmul.cu's dec::smem_bytes(8, a8, K), from its constants."""
    d = read_constants(body(SRC4, "dec"))
    ks = d["UNIT_K"] * ((K // d["UNIT_K"] + d["KSPLIT"] - 1) // d["KSPLIT"])
    MT = 8
    sums = MT * ks if a8 else MT * ks * 4
    recv = MT * ks * 5 if a8 and MT * ks * 4 > d["WARPS"] * MT * d["TILE"] * 4 \
        else sums + d["WARPS"] * MT * d["TILE"] * 4
    return recv + 2 * d["KSPLIT"] * MT * d["CPR"] * 4


def gate4(M, K, F, G, ldx, ldp, lds, xa=0, pa=0, sa=0) -> str:
    """A mirror of int4_matmul_template."""
    d = read_constants(body(SRC4, "dec"))
    a16 = xa % 16 == 0 and sa % 16 == 0
    if (1 <= M <= 8 and K % 16 == 0 and G % 4 == 0 and F % 4 == 0 and ldx % 8 == 0
            and ldp % 4 == 0 and lds % 4 == 0 and a16 and pa % 4 == 0
            and dec4_smem(K, False) <= d["SMEM_MAX"] and dec4_smem(K, True) <= d["SMEM_MAX"]):
        return "decode"
    c = C["int4"]
    if (M > 8 and K % c["UNIT_K"] == 0 and K >= 2 * c["KT"] and G > 0 and G % c["UNIT_K"] == 0
            and c["KT"] % G == 0 and K % G == 0 and K // G <= c["MAX_GROUPS"] and F % 16 == 0
            and ldx % 8 == 0 and ldp % 16 == 0 and lds % 4 == 0 and a16 and pa % 16 == 0):
        return "rows"
    return "chunked"


def gate8(M, K, F, ldx, ldq, xa=0, qa=0) -> str:
    """A mirror of int8_matmul_template."""
    d = read_constants(body(SRC8, "dec"))
    kst = d["UNIT_K"] * ((K // d["UNIT_K"] + d["KSPLIT"] - 1) // d["KSPLIT"])
    smem = 8 * kst * 4 + d["KWARPS"] * 8 * d["TILE"] * 4 + 2 * d["KSPLIT"] * 8 * d["CPR"] * 4
    if (1 <= M <= 8 and K % 16 == 0 and F % 4 == 0 and ldx % 8 == 0 and ldq % 4 == 0
            and xa % 16 == 0 and qa % 4 == 0 and smem <= d["SMEM_MAX"]):
        return "decode"
    c = C["int8"]
    if (M > 8 and K % c["UNIT_K"] == 0 and K >= 2 * c["KT"] and F % 16 == 0 and ldx % 8 == 0
            and ldq % 16 == 0 and xa % 16 == 0 and qa % 16 == 0):
        return "rows"
    return "chunked"


GATE4_TEXT = [
    "M > 8 && K % rowsmma::UNIT_K == 0 && K >= 2 * rowsmma::KT && G > 0 &&",
    "G % rowsmma::UNIT_K == 0 && rowsmma::KT % G == 0 && K % G == 0 &&",
    "K / G <= rows::MAX_GROUPS && F % 16 == 0 && ldx % 8 == 0 && ldp % 16 == 0 &&",
    "lds % 4 == 0 && aligned16 && reinterpret_cast<uintptr_t>(packed) % 16 == 0)",
    "return 2;",
]
GATE8_TEXT = [
    "M > 8 && K % rowsmma::UNIT_K == 0 && K >= 2 * rowsmma::KT && F % 16 == 0 &&",
    "ldx % 8 == 0 && ldq % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&",
    "reinterpret_cast<uintptr_t>(q) % 16 == 0)",
    "return 2;",
]


def test_template_gates_send_each_call_where_it_belongs():
    """The C gates hold the mirrored conditions; the split prompt pass's
    three shapes at M = 128 (and libra-11b's other K and F) go to "rows",
    M <= 8 to "decode", an odd x pitch, a misaligned base or a group that
    does not divide a stage to "chunked"."""
    g4 = flat(SRC4[SRC4.index('extern "C" int int4_matmul_template'):])
    g8 = flat(SRC8[SRC8.index('extern "C" int int8_matmul_template'):])
    for cond in GATE4_TEXT:
        assert flat(cond) in g4[:g4.index("return 0;")]
    for cond in GATE8_TEXT:
        assert flat(cond) in g8[:g8.index("return 0;")]
    for K, F in [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 2752), (4096, 32000),
                 (2816, 11008)]:
        for M in (9, 128, 160):
            assert gate4(M, K, F, 128, K, F, F) == "rows", (M, K, F)
            assert gate8(M, K, F, K, F) == "rows", (M, K, F)
        for M in (1, 4, 8):
            assert gate4(M, K, F, 128, K, F, F) == "decode", (M, K, F)
            assert gate8(M, K, F, K, F) == "decode", (M, K, F)
        assert gate4(128, K, F, 128, K + 1, F, F) == "chunked"
        assert gate8(128, K, F, K + 1, F) == "chunked"
        assert gate4(128, K, F, 128, K, F, F, xa=2) == "chunked"
        assert gate8(128, K, F, K, F, qa=4) == "chunked"
        assert gate4(128, K, F, 256, K, F, F) == "chunked"   # a group over two stages
    assert gate8(128, 128, 4096, 128, 4096) == "chunked"       # one stage: no split
    assert gate4(128, 4096, 4104, 128, 4096, 4104, 4104) == "chunked"   # F % 16


def test_shared_memory_fits_at_every_mode_and_split():
    """Stage slots and receive buffers 16-byte aligned, within the card's
    227 KB a block, at KS = 2, 4 and 8."""
    for mode in MODES:
        c = C[mode]
        x_bytes = c["TILE_M"] * c["KT"] * (1 if mode == "int4 a8" else 2)
        aux = 0 if mode == "int8" else c["S_BYTES"] + (
            c["GSLOTS"] * c["TILE_M"] * 4 if mode == "int4 a8" else 0)
        stage = c["W_BYTES"] + x_bytes + aux
        assert c["W_BYTES"] % 16 == 0 and x_bytes % 16 == 0 and stage % 16 == 0
        assert c["W_BYTES"] == (c["KT"] // 2 if mode != "int8" else c["KT"]) * c["ROW"]
        for ks in (2, 4, 8):
            recv = c["WARPS"] // ks * (ks - 1) * c["REGION"]
            assert c["NS"] * stage + recv <= 232448, (mode, ks)
    assert C["int4"]["REGION"] == 2 * C["int4"]["NJ"] * 32 * 16
    assert "constexpr int AUX_BYTES = S_BYTES + (A8 ? GSLOTS * TILE_M * 4 : 0);" in SRC4


def test_workspace_layout():
    """The W4A8 workspace's parts (xq, the group sums, sx) start 16-byte
    aligned and do not overlap, for every M the rows template takes."""
    text = flat(body(SRC4, "rows"))
    for expr in ("return (M + 3) & ~3;", "return (long long)M * K;",
                 "return gsum_offset(M, K) + 4LL * pad4(M) * (K / G);",
                 "return sx_offset(M, K, G) + 4LL * pad4(M);"):
        assert flat(expr) in text
    for M in range(9, 161):
        for K, G in ((4096, 128), (11008, 128), (2816, 32), (352, 32)):
            mp = (M + 3) & ~3
            gs, sx = M * K, M * K + 4 * mp * (K // G)
            assert gs % 16 == 0 and sx % 16 == 0 and sx + 4 * mp > sx


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions; the int4 one
    passes its workspace argument through the C interface's types."""
    x, w, s = inputs("int4 a8", 12, 256, 64, 128, 0)
    np.testing.assert_array_equal(ti4.int4_matmul(x, w, s, a8=True).float().numpy(),
                                  ti4.int4_matmul_plain(x, w, s, a8=True).float().numpy())
    x8, q, sc = inputs("int8", 12, 256, 64, 128, 0)
    np.testing.assert_array_equal(ti8.int8_matmul(x8, q, sc).float().numpy(),
                                  ti8.int8_matmul_plain(x8, q, sc).float().numpy())
    assert len(ti4._ARGTYPES) == 16 and len(ti4._WS_ARGTYPES) == 4


def test_chip_smoke_names_three_templates():
    """Phase 4 requires decode at M <= 8 and rows above, reads the gates'
    return values as the three names, and asks IMMA of the W4A8 rows
    kernels and HMMA of the others."""
    assert chip_smoke.TEMPLATES == {0: "chunked", 1: "decode", 2: "rows"}
    assert [chip_smoke.matmul_template(m) for m in (1, 8, 9, 128, 160)] == \
        ["decode"] * 2 + ["rows"] * 3
    base = "_ZN7rowsmma11rows_kernelIN47_GLOBAL__N__e7acb9a8_14_int4_matmul_cu_91401cd04rows4Mode"
    assert chip_smoke.mma_op(base + "ILb1EEELi4EEEvNT_4ArgsE") == "IMMA"
    assert chip_smoke.mma_op(base + "ILb0EEELi4EEEvNT_4ArgsE") == "HMMA"
    assert chip_smoke.mma_op(
        "_ZN7rowsmma11rows_kernelIN47_GLOBAL__N__edb62b6f_14_int8_matmul_cu_045874814rows4Mode"
        "ELi8EEEvNT_4ArgsE") == "HMMA"
    assert chip_smoke.M_SPLIT in chip_smoke.QUANT_M and 160 in chip_smoke.QUANT_M


MUTATIONS = [
    ("int4 a8", "src4", "SEL_LO = 0x5140u", "SEL_LO = 0x5410u"),
    ("int4 a8", "src4", "SEL_W1 = 0x7632u", "SEL_W1 = 0x3276u"),
    ("int4 a8", "src4", "HI_FLIP = 0x08080808u", "HI_FLIP = 0x08080800u"),
    ("int4 a8", "src4", "MAGIC_I = 0x4B400000u", "MAGIC_I = 0x4B000000u"),
    ("int4 a8", "src4", "NIB_MASK = 0x0F0F0F0Fu", "NIB_MASK = 0x0F0F0F07u"),
    ("int4", "src4", "SEL1 = 0xD591u", "SEL1 = 0xD519u"),
    ("int4", "src4", "OFFSET = 0xC308C308u", "OFFSET = 0xC300C308u"),
    ("int4", "src4", "SIGN_FLIP = 0x80808080u", "SIGN_FLIP = 0x80808000u"),
    ("int4", "src4", "BF16_128 = 0x43004300u", "BF16_128 = 0x43804300u"),
    ("int8", "src8", "PAIR_HI = 0x7632u", "PAIR_HI = 0x3276u"),
    ("int8", "header", "UNIT_K = 32;", "UNIT_K = 16;"),
]


@pytest.mark.parametrize("mode,where,old,new", MUTATIONS,
                         ids=["sel-lo", "sel-w1", "hi-flip", "magic", "mask", "sel1", "offset",
                              "sign-flip", "bf16-128", "pair-hi", "unit-k"])
def test_source_mutation_fails_the_checks(mode, where, old, new):
    """Each change to a constant of the source text, applied to a copy,
    breaks at least one of the checks above."""
    texts = {"header": HEADER, "src4": SRC4, "src8": SRC8}
    text = texts[where]
    ns = "rowsmma" if where == "header" else "rows"
    b = body(text, ns)
    assert b.count(old) == 1
    texts[where] = text.replace(b, b.replace(old, new, 1))
    c = constants(texts["header"], texts["src4"], texts["src8"])[mode]
    assert c != C[mode]
    with pytest.raises((AssertionError, IndexError, ValueError)):
        check_unit(c, mode, 0)
        check_template(c, mode, 33, 640, 176, 128, 2, seed=4)
