"""A CPU rehearsal of the int8 decode-attention kernel's wide template
(``libra_tpu_torch/csrc/decode_attention.cu``, namespace ``wide``: 8 < N <= 64
query rows, a chat turn's text delta), in numpy and torch only.

No CUDA kernel runs here, so the template's steps are emulated with the
constants and the shared-memory layout read from the CUDA source itself
(the wide namespace's, and the int8 conversion it takes from the decode
template's namespace):

* the XOR, PRMT and FADD of each int8 value and the PRMT by PAIR_HI of two
  floats' high halves give every byte's exact bf16;
* the rank -> unit slicing, the passes of each rank, the stage ring and the
  value k steps cover every key once;
* the score product Q K^T (q as A from the lanes' 8-byte loads, the
  converted key words as B) and the value product P V (P as A by the
  ldmatrix addresses of the kernel, the converted V (and Vb) bytes as B),
  both assembled by the PTX fragment layouts of m16n8k16 bf16, give the
  exact products;
* the whole template (scores and their epilogue, the cluster's max and sum
  exchange, bf16 probabilities written in place, values, the rank-order
  merge) matches libra_tpu's Pallas kernel in interpret mode at N = 16 and
  64, bridge on and off, with a chat delta's causal bias, a left-padded
  row and a fully masked row;
* the three-way template gate, mirrored here, and the shared memory at
  S = 1024 and 2048 with the bridge;
* a changed constant, selector or stride in the source fails these checks.

The kernel itself is held against ``int8_decode_attention_plain`` on the
card by ``chip_smoke.py`` phase 5.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu.ops.pallas import decode_attention as jda
from libra_tpu_torch.ops import decode_attention as tda
from tests.test_torch_port_decode_attention_kernel import (BIG_NEG, D, U32, bf16, byte_perm,
                                                           case, exact_values, warp_sum)
from tests.test_torch_port_decode_attention_kernel import constants as dec_constants
from tests.test_torch_port_int4_exp_a8_decode_kernel import c_eval

SOURCE = tda.SOURCE.read_text()
CONVERSION = ("SIGN_FLIP", "MAGIC", "SEL0", "SEL1", "SEL2", "SEL3", "MAGIC_BIAS")


def namespace(text: str, name: str) -> str:
    return text[text.index(f"namespace {name} {{"):text.index(f"}}  // namespace {name}")]


def constants(text: str) -> dict:
    """The ``constexpr`` scalars of the wide namespace, with the int8
    conversion's constants it takes from the decode namespace."""
    dec = dec_constants(text)
    out = {k: dec[k] for k in ("D",) + CONVERSION}
    for kind, name, value in re.findall(r"constexpr\s+(int|uint32_t|float)\s+(\w+)\s*=\s*"
                                        r"([-+*/ \w.()]+);", namespace(text, "wide")):
        v = value.strip()
        if re.fullmatch(r"0x[0-9A-Fa-f]+u?", v):
            out[name] = int(v.rstrip("u"), 16)
        else:
            out[name] = int(eval(v, {"__builtins__": {}}, dict(out)))   # noqa: S307
    return out


def layout_of(text: str, ns: str, c: dict):
    """The namespace's ``layout(S, bridge)``, evaluated statement by
    statement from the source: a function returning its Smem fields."""
    body = namespace(text, ns)
    fn = body[body.index("inline Smem layout(int S, bool bridge) {"):]
    stmts = re.findall(r"(?:const int (\w+)|m\.(\w+)) = ([^;]+);", fn[:fn.index("\n}\n")])

    def layout(S: int, bridge: bool) -> dict:
        env, m = dict(c, S=S, bridge=int(bridge)), {}
        for local, field, expr in stmts:
            v = c_eval(expr.replace("m.", "m_"), {**env, **{f"m_{k}": x for k, x in m.items()}})
            if local:
                env[local] = v
            else:
                m[field] = v
        return m
    return layout


C = constants(SOURCE)
DEC = dec_constants(SOURCE)
LAYOUT = layout_of(SOURCE, "wide", C)
DEC_LAYOUT = layout_of(SOURCE, "dec", DEC)
SM_BYTES = 228 * 1024     # shared memory of an H100 SM; 1 KB of it reserved a block


# ---------------------------------------------------------------------------
# Registers: bf16 bits, the pair conversion, the m16n8k16 fragment layouts
# ---------------------------------------------------------------------------

def bits16(x) -> np.ndarray:
    """fp32 values exact in bf16 -> their bf16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16()
    return t.view(torch.int16).numpy().view(np.uint16)


def word(lo, hi) -> np.ndarray:
    """Two bf16 bit arrays as one register, lo in the low half."""
    return np.asarray(lo).astype(U32) | (np.asarray(hi).astype(U32) << U32(16))


def unpack(w) -> tuple:
    """A register -> its (low, high) bf16 halves as fp32."""
    w = np.asarray(w, U32)
    return ((w & U32(0xFFFF)) << U32(16)).view(np.float32), (w & U32(0xFFFF0000)).view(np.float32)


def pair(c: dict, lo, hi) -> np.ndarray:
    """``__byte_perm(lo, hi, PAIR_HI)`` of two exact floats' bits."""
    return byte_perm(np.asarray(lo, np.float32).view(U32), np.asarray(hi, np.float32).view(U32),
                     c["PAIR_HI"])


def frag_a(a) -> np.ndarray:
    """A (16 x 16) of m16n8k16 from its 4 registers, each (..., 8 g, 4 t):
    a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)."""
    out = np.zeros(np.shape(a[0])[:-2] + (16, 16), np.float32)
    for reg, (r0, c0) in zip(a, ((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = unpack(reg)
        out[..., r0:r0 + 8, c0:c0 + 8:2] = lo
        out[..., r0:r0 + 8, c0 + 1:c0 + 8:2] = hi
    return out


def frag_b(b0, b1) -> np.ndarray:
    """B (16 k x 8 n) from b0 (k 2t..2t+1, n g) and b1 (k 2t + 8.., n g),
    each (..., 8 g, 4 t)."""
    out = np.zeros(np.shape(b0)[:-2] + (16, 8), np.float32)
    for reg, k0 in ((b0, 0), (b1, 8)):
        lo, hi = unpack(reg)
        out[..., k0:k0 + 8:2, :] = np.swapaxes(lo, -1, -2)
        out[..., k0 + 1:k0 + 8:2, :] = np.swapaxes(hi, -1, -2)
    return out


def mma(acc, a, b) -> np.ndarray:
    """``mma.sync.m16n8k16`` bf16 with fp32 sums: the operands' products
    are exact; their sum and the accumulator are modeled as rounded to fp32
    once (the order inside one mma is the hardware's)."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
            ).astype(np.float32)


G, T = np.arange(8)[:, None], np.arange(4)[None, :]       # a lane is (g, t), lane = 4 g + t


# ---------------------------------------------------------------------------
# The template's operands, lane by lane
# ---------------------------------------------------------------------------

def q_operands(q: np.ndarray) -> np.ndarray:
    """The A fragments of the scores: q (..., 64, 128) fp32 (bf16 values,
    rows past N zero) -> (..., 2 row groups, 2 m16 tiles, 8 k steps, 16, 16).
    qa[mt][kc][hr] and [2 + hr] of lane (g, t) are the 8-byte load of row
    wr + 16 mt + 8 hr + g at d0 = 32 t + 16 (kc / 4) + 4 (kc % 4)."""
    qb = bits16(q)
    out = np.zeros(q.shape[:-2] + (2, 2, 8, 16, 16), np.float32)
    for rg in range(2):
        for mt in range(2):
            for kc in range(8):
                d0 = 32 * T + 16 * (kc // 4) + 4 * (kc % 4)
                regs = [None] * 4
                for hr in range(2):
                    rows = qb[..., 32 * rg + 16 * mt + 8 * hr + G[:, 0], :]   # (..., 8 g, 128)
                    at = lambda off: np.take_along_axis(   # noqa: E731
                        rows, np.broadcast_to(d0 + off, rows.shape[:-1] + (4,)), -1)
                    regs[hr], regs[2 + hr] = word(at(0), at(1)), word(at(2), at(3))
                out[..., rg, mt, kc, :, :] = frag_a(regs)
    return out


def key_operands(c: dict, kw: np.ndarray, kc: int) -> np.ndarray:
    """The B fragment of k step kc for each key group: kw (..., 32 keys of a
    pass, 32 words). Warp c's lane (g, t) holds word kc % 4 of chunk
    2 t + kc / 4 of key row 8 c + g; its 4 values give b0 = pair(v0, v1),
    b1 = pair(v2, v3). Returns (..., COL_GROUPS, 16, 8)."""
    out = []
    for cg in range(c["COL_GROUPS"]):
        w = kw[..., 8 * cg + G[:, 0], :][..., 4 * (2 * T[0] + kc // 4) + kc % 4]   # (..., 8, 4)
        v = exact_values(c, w)
        out.append(frag_b(pair(c, v[..., 0], v[..., 1]), pair(c, v[..., 2], v[..., 3])))
    return np.stack(out, -3)


def value_operands(c: dict, vw: np.ndarray, vbw, s: int) -> np.ndarray:
    """The B fragments of value k step s: vw (and vbw with the bridge)
    (..., 32 keys of a pass, 32 words). Lane (g, t) of warp group c reads
    word 8 c + g of rows r0 and r1 and pairs byte e of the one with byte e of
    the other for n8 tile e: with the bridge r0 = 8 s + 4 j + t of V and of
    Vb, without r0 = 16 s + 8 j + 2 t and r0 + 1 of V (j = 0 for b0, 1 for
    b1). Returns (..., COL_GROUPS, 4 n8 tiles, 16, 8)."""
    tiles = []
    for cg in range(c["COL_GROUPS"]):
        regs = []
        for j in range(2):
            if vbw is not None:
                r0 = 8 * s + 4 * j + T[0]
                u0, u1 = vw[..., r0, :], vbw[..., r0, :]
            else:
                r0 = 16 * s + 8 * j + 2 * T[0]
                u0, u1 = vw[..., r0, :], vw[..., r0 + 1, :]
            # (..., 4 t, 32 words) -> word 8 c + g -> (..., 8 g, 4 t)
            f0 = exact_values(c, np.swapaxes(u0[..., 8 * cg + G[:, 0]], -1, -2))
            f1 = exact_values(c, np.swapaxes(u1[..., 8 * cg + G[:, 0]], -1, -2))
            regs.append([pair(c, f0[..., e], f1[..., e]) for e in range(4)])
        tiles.append(np.stack([frag_b(regs[0][e], regs[1][e]) for e in range(4)], -3))
    return np.stack(tiles, -4)


def ldsm_a(rows16: np.ndarray, row0: int, elem0: int) -> np.ndarray:
    """``ldmatrix .x4`` as the kernel addresses it for the A tile of rows
    row0 .. + 15 and bf16 elements elem0 .. + 15 of rows16 (..., 64, W):
    lane L gives the address of row row0 + (L & 15) at element elem0 +
    8 (L >> 4); matrix j is lanes 8 j .. 8 j + 7, and lane (g, t) receives
    elements 2 t, 2 t + 1 of row g of each matrix. Returns (..., 16, 16)."""
    lanes = np.arange(32)
    rows, cols = row0 + (lanes & 15), elem0 + 8 * (lanes >> 4)
    regs = []
    for j in range(4):
        m = rows16[..., rows[8 * j:8 * j + 8], :]                     # (..., 8 rows, W)
        idx = cols[8 * j:8 * j + 8, None] + np.arange(8)[None, :]     # (8, 8)
        m = np.take_along_axis(m, np.broadcast_to(idx, m.shape[:-1] + (8,)), -1)
        regs.append(word(m[..., :, 0::2], m[..., :, 1::2]))           # (..., 8 g, 4 t)
    return frag_a(regs)


def words(rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rows).view(U32)


# ---------------------------------------------------------------------------
# Slicing, passes, the ring
# ---------------------------------------------------------------------------

def rank_units(c: dict, S: int, rank: int):
    U = -(-S // c["UNIT"])
    ub = U * rank // c["RANKS"]
    return ub, U * (rank + 1) // c["RANKS"] - ub


def check_slicing(c: dict, lay, S: int, bridge: bool) -> None:
    """Every key of S lies in exactly one rank's run, one pass of it, one
    score key group and one value k step; each rank's keys fit the rows
    the layout stages; each stage buffer is refilled only once the stage
    before it in that buffer is consumed."""
    uk, pu, pk = c["UNIT"], c["PASS_UNITS"], c["PASS_KEYS"]
    assert uk == 16 and pk == pu * uk == 8 * c["COL_GROUPS"]
    U = -(-S // uk)
    nkr = lay(S, bridge)["nkr"]
    seen = np.zeros(U * uk, np.int32)
    vseen = np.zeros(U * uk, np.int32)
    end = 0
    for r in range(c["RANKS"]):
        ub, nu = rank_units(c, S, r)
        assert ub == end and uk * nu <= nkr
        end = ub + nu
        npass = -(-nu // pu)
        for p in range(npass):
            nkp = uk * min(pu, nu - pu * p)
            k0 = uk * ub + pk * p
            for cg in range(c["COL_GROUPS"]):
                if 8 * cg < nkp:
                    seen[k0 + 8 * cg:k0 + 8 * cg + 8] += 1
            for s in range(nkp // 8 if bridge else nkp // 16):
                keys = (8 * s + np.r_[T[0], 4 + T[0]] if bridge
                        else 16 * s + np.r_[2 * T[0], 2 * T[0] + 1, 8 + 2 * T[0], 9 + 2 * T[0]])
                vseen[k0 + keys] += 1
        # the ring: stage i in buffer i % NSTAGE, issued at start (i < NSTAGE)
        # or once stage i - NSTAGE is consumed; consumed in order
        held, issued = {}, 0
        for i in range(min(c["NSTAGE"], 2 * npass)):
            held[i % c["NSTAGE"]], issued = i, i + 1
        for i in range(2 * npass):
            assert held[i % c["NSTAGE"]] == i, "a stage was overwritten before it was read"
            if issued < 2 * npass:
                held[issued % c["NSTAGE"]], issued = issued, issued + 1
    assert end == U
    np.testing.assert_array_equal(seen, 1)
    np.testing.assert_array_equal(vseen, 1)


# ---------------------------------------------------------------------------
# The whole template
# ---------------------------------------------------------------------------

def emulate(c: dict, lay, q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias) -> np.ndarray:
    """The wide template (constants c, layout lay) for every (b, h) at
    once: (B, N, H, 128) fp32, the output before its bf16 rounding. q
    (B, N, H, 128) bf16 values as fp32; caches int8 (B, H, S, 128); scales
    fp32 (B, H, S); fq (B, N), fk (B, S) bool; bias (B, N, S) fp32."""
    B, N, H, _ = q.shape
    S = kq.shape[2]
    R, uk, pu, pk = c["RANKS"], c["UNIT"], c["PASS_UNITS"], c["PASS_KEYS"]
    assert c["ROWS"] == 64 and c["WROWS"] == 32 and c["ROW_GROUPS"] == 2 and N <= 64
    assert c["DCOLS"] == 32 and c["COL_GROUPS"] * c["DCOLS"] == D and pk == 8 * c["COL_GROUPS"]
    assert c["OUT_COLS"] * R == D and c["OUT_COLS"] % 8 == 0
    bridge = kbq is not None
    m = lay(S, bridge)
    sstr = m["sstr"]
    scale = np.float32(1.0 / D ** 0.5)
    rows = np.arange(64)
    qf = np.zeros((B, H, 64, D), np.float32)
    qf[:, :, :N] = q.transpose(0, 2, 1, 3)
    qa = q_operands(qf)                                               # (B, H, 2, 2, 8, 16, 16)
    cross = np.zeros((B, 64, S), bool)
    cross[:, :N] = fq[:, :, None] != fk[:, None, :]
    biasf = np.zeros((B, 64, S), np.float32)
    biasf[:, :N] = bias
    runs = []
    for r in range(R):
        ub, nu = rank_units(c, S, r)
        k0, nr = uk * ub, uk * nu
        nk = max(0, min(nr, S - k0))
        assert nr <= m["nkr"] <= sstr

        # --- scores: per pass and key group, the m16n8k16 products ---
        x = np.full((B, H, 64, nr), -np.inf, np.float32)
        kw, kbw = staged(kq, k0, nk, nr), staged(kbq, k0, nk, nr) if bridge else None
        for p in range(-(-nu // pu)):
            nkp = uk * min(pu, nu - pu * p)
            sl = slice(pk * p, pk * p + pk)
            raw = []
            for buf in (kw, kbw) if bridge else (kw,):
                stage = np.zeros((B, H, pk, 32), U32)
                stage[:, :, :nkp] = buf[:, :, sl][:, :, :nkp]
                acc = np.zeros((B, H, 2, 2, c["COL_GROUPS"], 16, 8), np.float32)
                for kc in range(8):
                    acc = mma(acc, qa[:, :, :, :, kc, None],
                              key_operands(c, stage, kc)[:, :, None, None])
                # C row i of tile (rg, mt), col j of group cg -> row 32 rg + 16 mt + i,
                # key 8 cg + j
                raw.append(acc.transpose(0, 1, 2, 3, 5, 4, 6).reshape(B, H, 64, pk)[..., :nkp])
            lk = np.arange(pk * p, pk * p + nkp)
            j = np.minimum(k0 + lk, S - 1)
            v = (raw[0] * ks[:, :, None, j]).astype(np.float32) * scale
            if bridge:
                vb = (raw[1] * kbs[:, :, None, j]).astype(np.float32) * scale
                v = np.where(cross[:, None, :, j], (v + vb).astype(np.float32), v)
            v = np.maximum((v + biasf[:, None, :, j]).astype(np.float32), BIG_NEG)
            live = (lk[None, :] < nk) & (rows[:, None] < N)
            x[..., lk] = np.where(live, v, -np.inf)
        runs.append((k0, nu, nk, nr, x))
    # --- softmax: each rank's max, the cluster's max; each rank's sum of
    # exp(s - M) (lane-strided, then the xor tree), added in rank order ---
    loc = [np.where(nk > 0, x[..., :nk].max(-1, initial=BIG_NEG), BIG_NEG)
           for _, _, nk, _, x in runs]
    M = np.max(np.stack(loc), 0).astype(np.float32)                  # (B, H, 64)
    sums = []
    for _, _, nk, nr, x in runs:
        e = np.exp(x - M[..., None]).astype(np.float32)
        e[..., nk:] = 0
        e[:, :, N:] = 0
        lanes = np.zeros(e.shape[:-1] + (32,), np.float32)
        for k in range(nk):
            lanes[..., k % 32] = (lanes[..., k % 32] + e[..., k]).astype(np.float32)
        sums.append((e, warp_sum(lanes)))
    Lsum = np.zeros_like(M)
    for _, s in sums:
        Lsum = (Lsum + s).astype(np.float32)
    # --- P in place, values by warp, the rank-order merge ---
    out = np.zeros((B, H, 64, D), np.float32)
    for (k0, nu, nk, nr, _), (e, _) in zip(runs, sums):
        ok = (np.arange(nr)[None, :] < nk) & (rows[:, None] < N)
        with np.errstate(invalid="ignore", divide="ignore"):
            an = np.where(ok, e / Lsum[..., None], 0).astype(np.float32)
        j = np.minimum(k0 + np.arange(nr), S - 1)
        p16 = bits16(np.where(ok, bf16(an * vs[:, :, None, j]), 0))
        P = np.zeros((B, H, 64, 2 * sstr), np.uint16)                 # the region's rows
        if bridge:
            pb = np.where(ok & cross[:, None, :, j], bf16(an * vbs[:, :, None, j]), 0)
            P[..., 0:2 * nr:2], P[..., 1:2 * nr:2] = p16, bits16(pb)
        else:
            P[..., :nr] = p16
        vw, vbw = staged(vq, k0, nk, nr), staged(vbq, k0, nk, nr) if bridge else None
        acc = np.zeros((B, H, 2, 2, c["COL_GROUPS"], 4, 16, 8), np.float32)
        ksteps = pk // 8 if bridge else pk // 16
        for p in range(-(-nu // pu)):
            nkp = uk * min(pu, nu - pu * p)
            sl = slice(pk * p, pk * p + pk)

            def stage(w):
                st = np.zeros((B, H, pk, 32), U32)
                st[:, :, :nkp] = w[:, :, sl][:, :, :nkp]
                return st

            sv, svb = stage(vw), stage(vbw) if bridge else None
            for s in range(nkp // 8 if bridge else nkp // 16):
                bop = value_operands(c, sv, svb, s)                  # (B, H, 4 cg, 4 e, 16, 8)
                for rg in range(2):
                    for mt in range(2):
                        a = ldsm_a(P, 32 * rg + 16 * mt, 16 * (ksteps * p + s))
                        acc[:, :, rg, mt] = mma(acc[:, :, rg, mt], a[:, :, None, None], bop)
        # C row i of (rg, mt), col j of tile e of group cg -> d = 32 cg + 4 j + e
        part = acc.transpose(0, 1, 2, 3, 6, 4, 7, 5).reshape(B, H, 64, D)
        out = (out + part).astype(np.float32)                        # rank order
    return out[:, :, :N].transpose(0, 2, 1, 3)


def staged(buf, k0: int, nk: int, nr: int) -> np.ndarray:
    """A rank's nr staged rows of buf (B, H, S, 128) from key k0 as words,
    zero past its nk live keys (the copies' zero fill)."""
    out = np.zeros(buf.shape[:2] + (nr, D), np.int8)
    out[:, :, :nk] = buf[:, :, k0:k0 + nk]
    return words(out)


def delta_case(N: int, S: int, bridge: bool, seed: int):
    """`case`'s inputs with a chat delta's bias: the N query rows at slots
    at = S - N - 40 onward, keys past each query masked (unwritten slots, to S), turn
    1's pad (slots 0 .. 3) masked, batch 1's delta left-padded by 9 (its
    first 9 delta slots masked for every query), batch 0's last query row
    fully masked."""
    q, kw, fq, fk, _ = case(N, S, bridge, seed)
    at = S - N - 40
    slots = np.arange(S)
    keep = slots[None, None, :] <= (at + np.arange(N))[None, :, None]
    keep = np.repeat(keep, 2, 0)
    keep[:, :, :4] = False
    keep[1, :, at:at + 9] = False
    keep[0, N - 1] = False
    return q, kw, fq, fk, np.where(keep, 0.0, BIG_NEG).astype(np.float32)


def run_emulation(c: dict, lay, inputs) -> np.ndarray:
    q, kw, fq, fk, bias = inputs
    return emulate(c, lay, q, kw["kq"], kw["ks"], kw["vq"], kw["vs"], kw.get("kbq"), kw.get("kbs"),
                   kw.get("vbq"), kw.get("vbs"), fq, fk, bias)


def check_vs_plain(c: dict, lay, N: int, S: int, bridge: bool, seed: int) -> None:
    """The emulation against the plain version before its output rounding
    (bf16 q, its probabilities rounded to bf16 too): the same exact
    products, fp32 sums in another order; within 2^-14 of max|V|, as the
    decode template's rehearsal holds it (a lost bridge term, a wrong scale
    or mask, or an operand off by a slot moves outputs by 2^-9 of max|V| or
    more)."""
    q, kw, fq, fk, bias = inputs = delta_case(N, S, bridge, seed)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    want = tda.int8_decode_attention_plain(
        torch.from_numpy(q).bfloat16(), t["kq"], t["ks"], t["vq"], t["vs"], t.get("kbq"),
        t.get("kbs"), t.get("vbq"), t.get("vbs"), torch.from_numpy(fq), torch.from_numpy(fk),
        torch.from_numpy(bias), out_dtype=torch.float32).numpy()
    got = run_emulation(c, lay, inputs)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -14 * 128 * kw["vs"].max())


def check_vs_pallas(N: int, bridge: bool) -> None:
    """The emulation, rounded to bf16, against the Pallas kernel in
    interpret mode on the same bf16 q, with the rows template's check (its
    S = 128, the Pallas kernel's 128-slot tiling, and its tolerance): the
    same probabilities rounded at the same place, sums in another order,
    exp in another library, so a probability's or an output's bf16
    rounding may flip where the two land on either side of a tie: at most
    0.1% of outputs differ, each by at most 2^-12 of max|V| or one bf16 ulp
    of itself. (A flip's chance grows with the keys a row sums: at S = 256
    one flipped probability of N = 16 with the bridge moves 0.33% of the
    outputs by an output ulp, and the plain version differs from the Pallas
    kernel at 0.05%; multi-pass ranks are held to the plain version.)"""
    q, kw, fq, fk, bias = inputs = delta_case(N, 128, bridge, seed=N + bridge)
    want = np.asarray(jda.int8_decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16), **{n: jnp.asarray(a) for n, a in kw.items()},
        flag_q=jnp.asarray(fq), kv_flag=jnp.asarray(fk), bias=jnp.asarray(bias),
        interpret=True), np.float32)
    got = bf16(run_emulation(C, LAYOUT, inputs))
    vmax = 128 * kw["vs"].max()
    diff = np.abs(got - want)
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16      # bf16's, for normal values
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} of outputs differ"
    assert (diff <= np.maximum(2.0 ** -12 * vmax, ulp)).all(), diff.max() / vmax


# ---------------------------------------------------------------------------
# The gate and the shared memory
# ---------------------------------------------------------------------------

ALIGNED = dict(q=0, strides=(4096 * 4, 4096, 128, 32 * 1024 * 128, 1024 * 128, 128),
               cache=(0, 0, 0, 0))


def template(N: int, S: int, bridge: bool, q: int = 0, strides=ALIGNED["strides"],
             cache=ALIGNED["cache"]) -> str:
    """``int8_decode_attention_template`` mirrored: both tensor-core
    templates need 8-byte q loads (q's base and b, n, h strides in 4
    elements) and 16-byte cache copies (bases and b, h, s strides); the
    decode template N <= 8 rows, the wide one 8 < N <= 64, each an S whose
    shared memory fits."""
    ok = S >= 1 and q % 8 == 0 and all(s % 4 == 0 for s in strides[:3]) \
        and all(s % 16 == 0 for s in strides[3:6]) and all(p % 16 == 0 for p in cache)
    if ok and 1 <= N <= DEC["ROWS"] and DEC_LAYOUT(S, bridge)["total"] <= DEC["SMEM_MAX"]:
        return "decode"
    if ok and DEC["ROWS"] < N <= C["ROWS"] and LAYOUT(S, bridge)["total"] <= C["SMEM_MAX"]:
        return "wide"
    return "rows"


def check_layout(c: dict, lay, S: int, bridge: bool) -> None:
    """The wide template's regions at S: 16-byte aligned; the score rows
    hold a rank's keys at a stride of 12 mod 32 floats (so that the 8 rows
    of 16 bytes an ldmatrix phase reads of P take distinct banks) and P in
    place ((p, p_b) words or p halves); the region holds the merge's
    receive buffers; the stage buffers their passes."""
    m = lay(S, bridge)
    nb = 2 if bridge else 1
    for k in ("buf", "ss", "meta", "fk", "mx", "sm", "total"):
        assert m[k] % 16 == 0, (S, bridge, k, m)
    assert m["sstr"] >= m["nkr"] and m["sstr"] % 32 == 12
    assert len({(g * m["sstr"] + w) % 32 for g in range(8) for w in range(4)}) == 32
    assert m["buf"] == nb * c["PASS_KEYS"] * c["ROW_BYTES"] and m["ss"] == c["NSTAGE"] * m["buf"]
    region = m["meta"] - m["ss"]
    assert region >= c["ROWS"] * m["sstr"] * 4
    assert region >= c["RANKS"] * c["ROWS"] * c["OUT_COLS"] * 4
    assert m["fk"] - m["meta"] >= 2 * nb * m["nkr"] * 4 and m["mx"] - m["fk"] >= m["nkr"]
    assert m["sm"] - m["mx"] == m["total"] - m["sm"] == c["RANKS"] * c["ROWS"] * 4


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_constants_read_from_the_source():
    assert {"RANKS", "THREADS", "BLOCKS_PER_SM", "WARPS", "ROWS", "ROW_GROUPS", "WROWS",
            "COL_GROUPS", "UNIT", "PASS_UNITS", "PASS_KEYS", "NSTAGE", "ROW_BYTES", "CHUNKS",
            "DCOLS", "OUT_COLS", "SROWS", "PAIR_HI", "SMEM_MAX"} | set(CONVERSION) <= set(C)
    assert C["WARPS"] * 32 == C["THREADS"] and C["ROW_GROUPS"] * C["COL_GROUPS"] == C["WARPS"]
    assert C["ROWS"] == 64 and C["CHUNKS"] == 8 and C["SROWS"] * C["WARPS"] == C["ROWS"]
    assert C["MAGIC_BIAS"] == 2.0 ** 23 + 128 and DEC["ROWS"] == 8


@pytest.mark.parametrize("pos", range(4))
def test_every_int8_value_becomes_its_exact_bf16(pos):
    """Byte `pos` of a word runs over all 256 values, its neighbours random:
    each value's float is exact, and joined with any other byte's float by
    PAIR_HI it is that register's exact bf16 half, bit for bit."""
    rs = np.random.RandomState(pos)
    b = np.arange(-128, 128, dtype=np.int32)
    w = rs.randint(0, 2 ** 32, size=256, dtype=np.uint64).astype(U32)
    w = (w & ~U32(255 << (8 * pos))) | ((b.astype(U32) & U32(255)) << U32(8 * pos))
    f = exact_values(C, w)
    np.testing.assert_array_equal(f[:, pos], b.astype(np.float32))
    want = bits16(b.astype(np.float32))
    other = exact_values(C, w[::-1])[:, (pos + 1) % 4]
    for lo, hi, half in ((f[:, pos], other, 0), (other, f[:, pos], 1)):
        reg = pair(C, lo, hi)
        np.testing.assert_array_equal((reg >> U32(16 * half)) & U32(0xFFFF), want)
        np.testing.assert_array_equal(unpack(reg)[half], b.astype(np.float32))


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("S", [128, 673, 674, 1024])
def test_slicing_and_passes_cover_every_key_once(S, bridge):
    """S = 128: one pass a rank; 673 and 674 (610 + 64): a ragged last unit
    and a rank with an odd count of units (a 16-key last pass); 1024: a
    chat session's cache."""
    check_slicing(C, LAYOUT, S, bridge)


@pytest.mark.parametrize("which", ["scores", "values", "values-bridge"])
def test_fragment_mappings_give_exact_products(which):
    """Integer-valued operands (exact in bf16), so every sum is exact: the
    score product of one pass is Q K^T, and the value product of one pass
    is P V (+ P_b Vb), each element in place."""
    rs = np.random.RandomState(5)
    pk = C["PASS_KEYS"]
    k = rs.randint(-128, 128, size=(pk, D)).astype(np.int8)
    if which == "scores":
        q = rs.randint(-64, 65, size=(64, D)).astype(np.float32)
        qa = q_operands(q)
        acc = np.zeros((2, 2, C["COL_GROUPS"], 16, 8), np.float32)
        for kc in range(8):
            acc = mma(acc, qa[:, :, kc, None], key_operands(C, words(k), kc)[None, None])
        got = acc.transpose(0, 1, 3, 2, 4).reshape(64, pk)
        np.testing.assert_array_equal(got, q.astype(np.float64) @ k.T.astype(np.float64))
        return
    bridge = which == "values-bridge"
    kb = rs.randint(-128, 128, size=(pk, D)).astype(np.int8)
    p = rs.randint(-32, 33, size=(64, pk)).astype(np.float32)
    pb = rs.randint(-32, 33, size=(64, pk)).astype(np.float32)
    sstr = LAYOUT(1024, bridge)["sstr"]
    P = np.zeros((64, 2 * sstr), np.uint16)
    if bridge:
        P[:, 0:2 * pk:2], P[:, 1:2 * pk:2] = bits16(p), bits16(pb)
        want = p.astype(np.float64) @ k.astype(np.float64) + pb @ kb.astype(np.float64)
    else:
        P[:, :pk] = bits16(p)
        want = p.astype(np.float64) @ k.astype(np.float64)
    acc = np.zeros((2, 2, C["COL_GROUPS"], 4, 16, 8), np.float32)
    steps = pk // 8 if bridge else pk // 16
    for s in range(steps):
        bop = value_operands(C, words(k), words(kb) if bridge else None, s)
        for rg in range(2):
            for mt in range(2):
                acc[rg, mt] = mma(acc[rg, mt], ldsm_a(P, 32 * rg + 16 * mt, 16 * s)[None, None],
                                  bop)
    got = acc.transpose(0, 1, 4, 2, 5, 3).reshape(64, D)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("N", [16, 64])
def test_emulated_wide_template_matches_pallas(N, bridge):
    """N = 16 (only the first row group's first m16 tile live) and 64 (a chat
    delta's bucket), the chat delta's causal bias (queries at S - N - 40
    onward, the later slots unwritten), batch 1's delta left-padded, batch
    0's last query row fully masked (the uniform average of V)."""
    check_vs_pallas(N, bridge)


@pytest.mark.parametrize("N,S,bridge", [(64, 674, True), (24, 673, False), (16, 128, True)])
def test_emulated_wide_template_matches_plain(N, S, bridge):
    """Against the plain version at lengths the Pallas kernel does not take:
    674 = 610 + 64 (ranks of 10 and 11 units, a 16-key last pass), 673 (a
    ragged last unit), 128 (one pass a rank); N = 24 (a half-live m16
    tile)."""
    check_vs_plain(C, LAYOUT, N, S, bridge, seed=N + S)


def test_gate_takes_the_template_each_call_needs():
    """N = 64 with aligned operands goes to the wide template, N <= 8 to the
    decode one; an unaligned q, stride or cache base, or an S whose shared
    memory does not fit, to the old rows template. The source's gate holds
    the mirrored conditions."""
    for bridge in (True, False):
        assert template(64, 1024, bridge) == "wide"
        assert template(16, 674, bridge) == template(9, 2048, bridge) == "wide"
        assert template(1, 1024, bridge) == template(8, 674, bridge) == "decode"
        assert template(64, 1024, bridge, q=4) == "rows"
        assert template(64, 1024, bridge, strides=(4096 * 4, 4096, 130) + (128,) * 3) == "rows"
        assert template(64, 1024, bridge, strides=(4096,) * 3 + (128, 128, 136)) == "rows"
        assert template(64, 1024, bridge, cache=(0, 8, 0, 0)) == "rows"
        assert template(64, 16384, bridge) == "rows"
    gate = SOURCE[SOURCE.index('extern "C" int int8_decode_attention_template'):]
    gate = gate[:gate.index("\n}\n")]
    for cond in ("reinterpret_cast<uintptr_t>(q) % 8 == 0", "strides[i] % 4 == 0",
                 "strides[i] % 16 == 0", "reinterpret_cast<uintptr_t>(p) % 16 == 0",
                 "N >= 1 && N <= dec::ROWS && dec::layout(S, bridge).total <= dec::SMEM_MAX) "
                 "return 1;",
                 "N > dec::ROWS && N <= wide::ROWS && wide::layout(S, bridge).total <= "
                 "wide::SMEM_MAX)\n    return 2;", "return 0;"):
        assert cond in gate, cond
    dispatch = SOURCE[SOURCE.index('extern "C" int int8_decode_attention('):]
    assert "case 2:\n      return bridge ? (int)wide::launch<true>" in dispatch
    # chip_smoke names the codes so, and wants the wide kernel's SASS on HMMA
    import chip_smoke
    assert chip_smoke.DECODE_TEMPLATES == {0: "rows", 1: "decode", 2: "wide"}
    assert chip_smoke.mma_op("_ZN4wide16attn_wide_kernelILb1EEEvNS_4ArgsE") == "HMMA"


@pytest.mark.parametrize("S", [1024, 2048])
def test_shared_memory_fits_with_the_bridge(S):
    """At S = 1024 (a chat session) two blocks an SM fit, as the template's
    BLOCKS_PER_SM asks; at 2048 one; both under SMEM_MAX, and every region
    in place at these and other lengths."""
    m = LAYOUT(S, True)
    assert m["total"] <= C["SMEM_MAX"] and C["SMEM_MAX"] + C["ROWS"] <= 227 * 1024
    per_block = m["total"] + C["ROWS"] + 1024       # + the static flags, + the reserve
    assert (SM_BYTES // per_block >= C["BLOCKS_PER_SM"]) == (S == 1024)
    for s in (1, 17, 128, 673, 674, S):
        for bridge in (True, False):
            check_layout(C, LAYOUT, s, bridge)


@pytest.mark.parametrize("old,new", [
    ("PAIR_HI = 0x7632u;", "PAIR_HI = 0x5410u;"),
    ("SEL1 = 0x7441u", "SEL1 = 0x7442u"),
    ("MAGIC_BIAS = 8388736.f", "MAGIC_BIAS = 8388608.f"),
    ("constexpr int UNIT = 16;               // keys of a slicing unit\nconstexpr int PASS_UNITS",
     "constexpr int UNIT = 8;               // keys of a slicing unit\nconstexpr int PASS_UNITS"),
    ("constexpr int PASS_UNITS = 2;          // units a stage buffer holds",
     "constexpr int PASS_UNITS = 3;          // units a stage buffer holds"),
    ("constexpr int RANKS = 4;               // blocks of a cluster, one run of S each\n"
     "constexpr int THREADS = 256;",
     "constexpr int RANKS = 6;               // blocks of a cluster, one run of S each\n"
     "constexpr int THREADS = 256;"),
    ("m.sstr = ((m.nkr + 19) & ~31) + 12;", "m.sstr = ((m.nkr + 19) & ~31) + 8;"),
], ids=["pair-low-halves", "sel1", "magic-bias", "unit8", "pass3", "ranks6", "stride"])
def test_source_mutation_fails_the_checks(old, new):
    """Each change to the source text, applied to a copy, breaks at least one
    of the checks above: the conversion (low halves are no bf16, a selector
    or the bias off), the slicing (a unit is the m16 tile's 16 keys, a pass
    the 4 key groups' 32), the merge's column split, the row stride's
    banks."""
    assert SOURCE.count(old) == 1, old
    text = SOURCE.replace(old, new, 1)
    c = constants(text)
    lay = layout_of(text, "wide", c)
    with pytest.raises(AssertionError):
        for pos in range(4):
            rs = np.random.RandomState(pos)
            b = np.arange(-128, 128, dtype=np.int32)
            w = (rs.randint(0, 2 ** 32, size=256, dtype=np.uint64).astype(U32)
                 & ~U32(255 << (8 * pos))) | ((b.astype(U32) & U32(255)) << U32(8 * pos))
            f = exact_values(c, w)
            np.testing.assert_array_equal(unpack(pair(c, f[:, pos], f[:, pos]))[0],
                                          b.astype(np.float32))
        for S in (128, 674):
            check_layout(c, lay, S, True)
            check_slicing(c, lay, S, True)
        check_vs_plain(c, lay, 16, 128, True, seed=3)


@pytest.mark.parametrize("name", ["kept", "w8", "w3", "kept+wtrace"])
def test_wide_variant_sources_apply(name, tmp_path, monkeypatch):
    """``tools/decode_attention_variants`` edits only the wide namespace for
    its wide variants: clusters of 8, a third stage buffer, the phase
    stamps (10 a block, every anchor found); the decode template's
    constants stay as they are."""
    from libra_tpu_torch.tools import decode_attention_variants as V
    monkeypatch.setattr(V, "OUT", tmp_path)
    text = V.source(name).read_text()
    c = constants(text)
    want = {"kept": (4, 2), "w8": (8, 2), "w3": (4, 3), "kept+wtrace": (4, 2)}[name]
    assert (c["RANKS"], c["NSTAGE"]) == want
    assert dec_constants(text) == DEC
    check_layout(c, layout_of(text, "wide", c), 1024, True)
    assert V.templates(name) == (["decode", "wide"] if name == "kept" else ["wide"])
    stamps = namespace(text, "wide").count("TS(")
    assert stamps == (len(V.WIDE_PHASES) + 1 if "wtrace" in name else 0)
