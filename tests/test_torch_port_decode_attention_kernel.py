"""A CPU rehearsal of the int8 decode-attention kernel's decode template
(``libra_tpu_torch/csrc/decode_attention.cu``, namespace ``dec``), in numpy
and torch only.

No CUDA kernel runs here, so the template's steps are emulated with the
constants read from the CUDA source itself (the sign flip, the
``__byte_perm`` selectors, the magic float and its bias, the cluster's
ranks, the 16-key unit, the pass length):

* one XOR a word, one selector a byte and the magic bias turn every int8
  value, in every byte of a word, into its exact fp32, bit for bit;
* the rank -> unit split, and each rank's passes, cover every key once;
* the score product S^T = K Q^T and the value product out^T = V^T P^T,
  their mma operands taken from the lanes' registers by the PTX fragment
  layouts of m16n8k8 tf32 (the K words as ldmatrix gives them, the V
  words as a lane reads them), give the exact products;
* the whole template (scores and their epilogue, the cluster's max and
  sum exchange, bf16 probabilities, values, the rank-order merge) equals
  ``int8_decode_attention_plain`` before its output rounding, to fp32
  round-off;
* a change to a selector, the magic bias or the unit in the source text
  fails these checks.

The rows template (the fallback for operands the decode and wide
templates do not take; the wide template has its own rehearsal,
``test_torch_port_decode_attention_wide.py``) is emulated too: its two
passes over the key tiles (each row's max and sum of exponentials first, then the
normalized probabilities rounded to bf16 with their V scales, then the
values), held against libra_tpu's Pallas kernel in interpret mode on
bf16 q; the one-pass order with fp32 probabilities, which it replaced,
fails the same check. The emulation proves the order, not the kernel:
the rows kernel's source is held to that order (two loops over the key
tiles, bf16 probabilities from exp(s - M) / L, no division after the
loops), and edits back toward the one-pass order fail that check.

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

SOURCE = tda.SOURCE.read_text()
U32 = np.uint32
BIG_NEG = np.float32(-2.0 ** 30)
D = 128


def constants(text: str) -> dict:
    """The ``constexpr`` scalars of the decode template's namespace (with
    the file's head dim D, which they use)."""
    out = {"D": int(re.search(r"constexpr int D = (\d+);", text).group(1))}
    body = text[text.index("namespace dec {"):text.index("}  // namespace dec")]
    for kind, name, value in re.findall(r"constexpr\s+(int|uint32_t|float)\s+(\w+)\s*=\s*"
                                        r"([-+*/ \w.()]+);", body):
        v = value.strip()
        if re.fullmatch(r"0x[0-9A-Fa-f]+u?", v):
            out[name] = int(v.rstrip("u"), 16)
        elif re.fullmatch(r"[0-9.]+f", v):
            out[name] = float(v[:-1])
        else:   # an expression of the names before it
            try:
                out[name] = eval(v, {"__builtins__": {}}, dict(out))   # noqa: S307
            except NameError:
                continue
            if kind == "int":
                out[name] = int(out[name])
    return out


C = constants(SOURCE)


def byte_perm(x, y, s: int):
    """``__byte_perm(x, y, s)`` (PTX ``prmt``, default mode): byte n of the
    result is byte (s >> 4n) & 7 of the 8 bytes (x0..x3, y0..y3), or that
    byte's sign replicated where bit 3 of the nibble is set."""
    x = np.asarray(x, U32)
    y = np.broadcast_to(np.asarray(y, U32), x.shape)
    src = [(v >> U32(8 * i)) & U32(255) for v in (x, y) for i in range(4)]
    out = np.zeros(x.shape, U32)
    for n in range(4):
        nib = (s >> (4 * n)) & 15
        b = src[nib & 7]
        if nib & 8:
            b = np.where(b & U32(128), U32(255), U32(0))
        out |= b << U32(8 * n)
    return out


def exact_values(c: dict, w) -> np.ndarray:
    """(...,) uint32 words -> (..., 4) fp32 values, byte e last: the
    kernel's XOR, one selector a byte, the magic bias."""
    u = np.asarray(w, U32) ^ U32(c["SIGN_FLIP"])
    vals = [byte_perm(u, c["MAGIC"], c[f"SEL{i}"]).view(np.float32)
            - np.float32(c["MAGIC_BIAS"]) for i in range(4)]
    return np.stack(vals, -1).astype(np.float32)


def rank_units(c: dict, S: int, rank: int):
    """The kernel's split: (first unit, units) of block `rank`."""
    U = -(-S // c["UNIT"])
    ub = U * rank // c["RANKS"]
    return ub, U * (rank + 1) // c["RANKS"] - ub


def check_every_byte(c: dict, pos: int) -> None:
    """Byte `pos` of a word runs over all 256 values, its neighbours random
    (a selector must not take them): each value comes out exactly."""
    rs = np.random.RandomState(pos)
    b = np.arange(-128, 128, dtype=np.int32)
    w = rs.randint(0, 2 ** 32, size=256, dtype=np.uint64).astype(U32)
    w = (w & ~U32(255 << (8 * pos))) | ((b.astype(U32) & U32(255)) << U32(8 * pos))
    got = exact_values(c, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, pos], b.astype(np.float32))
    np.testing.assert_array_equal(got, np.ascontiguousarray(w).view(np.int8)
                                  .reshape(-1, 4).astype(np.float32))


def check_slicing(c: dict, S: int) -> None:
    """Every key of S lies in exactly one rank's run of units and in one
    pass of that rank; a unit is the score mma's 16 keys (and two of the
    value mma's 8-key steps); a rank's keys fit its staged rows."""
    uk, pu = c["UNIT"], c["PASS_UNITS"]
    assert uk == 16, "a unit is the m16 tile of the score product"
    assert c["PASS_KEYS"] == pu * uk
    U = -(-S // uk)
    nkr = uk * -(-U // c["RANKS"])
    seen = np.zeros(U * uk, np.int32)
    end = 0
    for r in range(c["RANKS"]):
        ub, nu = rank_units(c, S, r)
        assert ub == end and uk * nu <= nkr
        end = ub + nu
        for p in range(-(-nu // pu)):
            nup = min(pu, nu - pu * p)
            k = uk * (ub + pu * p)
            seen[k:k + uk * nup] += 1
    assert end == U
    np.testing.assert_array_equal(seen, 1)


def mma_tf32(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``mma.sync.m16n8k8`` tf32 on whole tiles (..., 16, 8) @ (..., 8, 8):
    the operands here are exact in tf32, the 8 products of an element
    exact; their sum and the accumulator are modeled as rounded to fp32
    once (the order inside one mma is the hardware's)."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
            ).astype(np.float32)


# PTX fragment layouts of m16n8k8 tf32, lane = 4 g + t; a lane array has
# the shape (..., 8 g, 4 t).
def frag_a(a0, a1, a2, a3) -> np.ndarray:
    """A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)."""
    out = np.zeros(a0.shape[:-2] + (16, 8), np.float32)
    out[..., :8, :4], out[..., 8:, :4] = a0, a1
    out[..., :8, 4:], out[..., 8:, 4:] = a2, a3
    return out


def frag_b(b0, b1) -> np.ndarray:
    """B (8 x 8, k by n): b0 (k t, n g), b1 (k t + 4, n g)."""
    return np.concatenate([np.swapaxes(b0, -1, -2), np.swapaxes(b1, -1, -2)], -2)


def frag_c(acc: np.ndarray):
    """C (16 x 8) -> c0 (g, 2 t), c1 (g, 2 t + 1), c2 (g + 8, 2 t),
    c3 (g + 8, 2 t + 1)."""
    return (acc[..., :8, 0::2], acc[..., :8, 1::2], acc[..., 8:, 0::2], acc[..., 8:, 1::2])


def words(rows: np.ndarray) -> np.ndarray:
    """int8 rows (..., 128) -> their 32 little-endian words (..., 32)."""
    return np.ascontiguousarray(rows).view(U32)


def unit_scores(c: dict, kw: np.ndarray, qf: np.ndarray) -> np.ndarray:
    """The kernel's unit_scores: kw (..., 16 keys, 32 words) of one unit,
    qf (..., 8 rows, 128) q as fp32 (rows past N zero). In the mma of
    chunk cc and half e, lane (g, t) holds word t of chunk cc of key rows g
    and g + 8 (what ldmatrix gives it), and its k slots t, t + 4 are
    d = 16 cc + 4 t + 2 e and that + 1, in A and in B alike. Returns the
    C fragments (c0, c1, c2, c3), each (..., 8 g, 4 t)."""
    acc = np.zeros(kw.shape[:-2] + (16, 8), np.float32)
    t = np.arange(4)
    for cc in range(C_CHUNKS):
        lo = exact_values(c, kw[..., :8, 4 * cc:4 * cc + 4])      # (..., g, t, byte)
        hi = exact_values(c, kw[..., 8:, 4 * cc:4 * cc + 4])
        for e in range(2):
            d0 = 16 * cc + 4 * t + 2 * e                           # slot t; slot t + 4 is d0 + 1
            a = frag_a(lo[..., 2 * e], hi[..., 2 * e], lo[..., 2 * e + 1], hi[..., 2 * e + 1])
            b = frag_b(qf[..., :, d0], qf[..., :, d0 + 1])         # (..., g, t) each
            acc = mma_tf32(acc, a, b)
    return frag_c(acc)


def step_values(c: dict, vw: np.ndarray, p: np.ndarray, warp: int, acc: list) -> None:
    """The kernel's step_values for 8 keys: vw (..., 8 keys, 32 words),
    p (..., 8 rows, 8 keys) the probabilities; warp `warp`'s two d tiles
    accumulate into acc[0], acc[1] (..., 16, 8). Lane (g, t) reads word
    8 warp + g of key rows 2 t and 2 t + 1 (k slots t and t + 4); M row g
    of tile j is d = 32 warp + 4 g + 2 j, row g + 8 that + 1."""
    t = np.arange(4)
    w0 = exact_values(c, np.swapaxes(vw[..., 2 * t, 8 * warp:8 * warp + 8], -1, -2))
    w1 = exact_values(c, np.swapaxes(vw[..., 2 * t + 1, 8 * warp:8 * warp + 8], -1, -2))
    b = frag_b(p[..., :, 2 * t], p[..., :, 2 * t + 1])              # b0 = P[g][2 t]
    for j in range(2):
        a = frag_a(w0[..., 2 * j], w0[..., 2 * j + 1], w1[..., 2 * j], w1[..., 2 * j + 1])
        acc[j] = mma_tf32(acc[j], a, b)


def bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def warp_sum(x: np.ndarray) -> np.ndarray:
    """(..., 32 lanes) -> the xor-shuffle tree's sum (every lane ends with
    the same value: fp32 addition commutes)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[..., lanes ^ o]).astype(np.float32)
    return x[..., 0]


def emulate(c: dict, q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias) -> np.ndarray:
    """The decode template step by step for every (b, h) at once, in fp32:
    the output (B, N, H, 128) before its bf16 rounding. q (B, N, H, 128)
    bf16 values as fp32; caches int8 (B, H, S, 128); scales fp32 (B, H,
    S); fq (B, N), fk (B, S) bool; bias (B, N, S) fp32."""
    B, N, H, _ = q.shape
    S = kq.shape[2]
    assert c["UNIT"] == 16 and c["ROWS"] == 8 and N <= c["ROWS"]
    assert c["WARPS"] * 32 == D and c["OUT_COLS"] * c["RANKS"] == D
    bridge = kbq is not None
    scale = np.float32(1.0 / D ** 0.5)
    R, uk = c["RANKS"], c["UNIT"]
    qf = np.zeros((B, H, 8, D), np.float32)
    qf[:, :, :N] = q.transpose(0, 2, 1, 3)
    cross = fq[:, :, None] != fk[:, None, :]                         # (B, N, S)
    runs, loc = [], []
    # --- scores, per rank over its units; the epilogue by C fragment ---
    for r in range(R):
        ub, nu = rank_units(c, S, r)
        k0, nr = uk * ub, uk * nu
        nk = max(0, min(nr, S - k0))
        x = np.full((B, H, 8, nr), -np.inf, np.float32)

        def rows(buf):   # the staged rows, zero past the live keys
            out = np.zeros((B, H, nr, D), np.int8)
            out[:, :, :nk] = buf[:, :, k0:k0 + nk]
            return out

        kw = words(rows(kq))
        kbw = words(rows(kbq)) if bridge else None
        for u in range(nu):
            sl = slice(uk * u, uk * u + uk)
            cs = unit_scores(c, kw[:, :, sl], qf)
            cbs = unit_scores(c, kbw[:, :, sl], qf) if bridge else None
            for i in range(4):
                for g in range(8):
                    for t in range(4):
                        n, lk = 2 * t + (i & 1), uk * u + g + 8 * (i >> 1)
                        if lk >= nk or n >= N:
                            continue
                        j = k0 + lk
                        v = cs[i][:, :, g, t] * ks[:, :, j] * scale
                        if bridge:
                            vb = cbs[i][:, :, g, t] * kbs[:, :, j] * scale
                            v = np.where(cross[:, None, n, j], v + vb, v)
                        x[:, :, n, lk] = np.maximum(v + bias[:, None, n, j], BIG_NEG)
        runs.append((k0, nk, nr, x))
    # --- softmax: each rank's max, the cluster's max; each rank's sum of
    # exp(s - M) (lane-strided, then the xor tree), added in rank order ---
    loc = [np.where(nk > 0, x[..., :nk].max(-1, initial=BIG_NEG), BIG_NEG)
           for _, nk, _, x in runs]
    M = np.max(np.stack(loc), 0).astype(np.float32)                  # (B, H, 8)
    sums = []
    for k0, nk, nr, x in runs:
        e = np.exp(x - M[..., None]).astype(np.float32)
        e[..., nk:] = 0
        lanes = np.zeros(e.shape[:-1] + (32,), np.float32)
        for k in range(nk):
            lanes[..., k % 32] = (lanes[..., k % 32] + e[..., k]).astype(np.float32)
        sums.append((e, warp_sum(lanes)))
    L = np.zeros_like(M)
    for _, s in sums:
        L = (L + s).astype(np.float32)
    # --- probabilities, values by warp, the rank-order merge ---
    out = np.zeros((B, H, 8, D), np.float32)
    for (k0, nk, nr, _), (e, _) in zip(runs, sums):
        with np.errstate(invalid="ignore"):   # rows past N: 0 / 0, never used
            a = (e / L[..., None]).astype(np.float32)
        live = np.arange(nr) < nk
        j = np.minimum(k0 + np.arange(nr), S - 1)
        pv = np.where(live, bf16(a * vs[:, :, None, j]), 0).astype(np.float32)
        pv[:, :, N:] = 0
        if bridge:
            cr = np.zeros((B, 1, 8, nr), bool)
            cr[:, 0, :N] = cross[:, :, j] & live
            pb = np.where(cr, bf16(a * vbs[:, :, None, j]), 0).astype(np.float32)
        part = np.zeros((B, H, 8, D), np.float32)

        def rows(buf):
            out_ = np.zeros((B, H, nr, D), np.int8)
            out_[:, :, :nk] = buf[:, :, k0:k0 + nk]
            return out_

        vw = words(rows(vq))
        vbw = words(rows(vbq)) if bridge else None
        for w in range(c["WARPS"]):
            acc = [np.zeros((B, H, 16, 8), np.float32) for _ in range(2)]
            for s in range(nr // 8):
                ks_ = slice(8 * s, 8 * s + 8)
                step_values(c, vw[:, :, ks_], pv[..., ks_], w, acc)
                if bridge:
                    step_values(c, vbw[:, :, ks_], pb[..., ks_], w, acc)
            for jt in range(2):     # C row g: d = 32 w + 4 g + 2 jt, row g + 8: that + 1
                c0, c1, c2, c3 = frag_c(acc[jt])
                g = np.arange(8)
                for cv, n_off, d_off in ((c0, 0, 0), (c1, 1, 0), (c2, 0, 1), (c3, 1, 1)):
                    for t in range(4):
                        part[:, :, 2 * t + n_off, 32 * w + 4 * g + 2 * jt + d_off] = cv[..., t]
        out = (out + part).astype(np.float32)                       # rank order
    return out[:, :, :N].transpose(0, 2, 1, 3)


C_CHUNKS = D // 16


def case(N: int, S: int, bridge: bool, seed: int):
    """bf16 q; int8 caches over the whole range with fp32 scales; random
    flags; a causal bias up to the query slots, batch 1 left-padded by 3;
    batch 0's last query row fully masked."""
    rs = np.random.RandomState(seed)
    B, H = 2, 2
    q = bf16(rs.randn(B, N, H, D).astype(np.float32))
    names = ["kq", "ks", "vq", "vs", "kbq", "kbs", "vbq", "vbs"][:8 if bridge else 4]
    kw = {}
    for i in range(0, len(names), 2):
        kw[names[i]] = rs.randint(-128, 128, size=(B, H, S, D)).astype(np.int8)
        kw[names[i + 1]] = (rs.rand(B, H, S) * 0.03 + 1e-3).astype(np.float32)
    fq = rs.rand(B, N) < 0.5
    fk = rs.rand(B, S) < 0.4
    pos = S - N + np.arange(N)
    keep = np.arange(S)[None, None, :] <= pos[None, :, None]
    keep = np.repeat(keep, B, 0)
    keep[1, :, :3] = False
    keep[0, N - 1] = False
    bias = np.where(keep, 0.0, BIG_NEG).astype(np.float32)
    return q, kw, fq, fk, bias


def check_template(c: dict, N: int, S: int, bridge: bool, seed: int) -> None:
    """The emulation against the plain version before its output rounding
    (bf16 q, so its probabilities are rounded to bf16 too): the same exact
    products, fp32 sums in another order; a probability's bf16 rounding
    may flip where the two land on either side of a tie. Within 2^-14 of
    max|V| (a lost bridge term, a wrong scale or mask, or probabilities
    kept in fp32 move outputs by 2^-9 of max|V| or more)."""
    q, kw, fq, fk, bias = case(N, S, bridge, seed)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    want = tda.int8_decode_attention_plain(
        torch.from_numpy(q).bfloat16(), t["kq"], t["ks"], t["vq"], t["vs"], t.get("kbq"),
        t.get("kbs"), t.get("vbq"), t.get("vbs"), torch.from_numpy(fq), torch.from_numpy(fk),
        torch.from_numpy(bias), out_dtype=torch.float32).numpy()
    got = emulate(c, q, kw["kq"], kw["ks"], kw["vq"], kw["vs"], kw.get("kbq"), kw.get("kbs"),
                  kw.get("vbq"), kw.get("vbs"), fq, fk, bias)
    vmax = 128 * kw["vs"].max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -14 * vmax)


def test_constants_read_from_the_source():
    assert {"SIGN_FLIP", "MAGIC", "SEL0", "SEL1", "SEL2", "SEL3", "MAGIC_BIAS", "RANKS",
            "THREADS", "WARPS", "ROWS", "UNIT", "PASS_UNITS", "PASS_KEYS", "ROW_BYTES",
            "CHUNKS", "OUT_COLS"} <= set(C)
    assert C["WARPS"] * 32 == C["THREADS"] and C["ROWS"] * C["OUT_COLS"] % C["THREADS"] == 0
    assert C["CHUNKS"] == C_CHUNKS and C["ROW_BYTES"] == D
    assert C["MAGIC_BIAS"] == 2.0 ** 23 + 128


@pytest.mark.parametrize("pos", range(4))
def test_every_int8_value_exact(pos):
    check_every_byte(C, pos)


@pytest.mark.parametrize("S", [1, 15, 16, 17, 128, 673, 674, 2048])
def test_slicing_covers_every_key_once(S):
    """Tiny S, where ranks get no unit; a ragged last unit (673, 674 =
    610 + 64, the decode shape); S = 2048 in many passes a rank."""
    check_slicing(C, S)


@pytest.mark.parametrize("which", ["scores", "values"])
def test_fragment_mappings_give_exact_products(which):
    """Integer-valued operands, so every sum is exact: the score product
    of one unit is K Q^T and the value product of 8 keys is V^T P^T, each
    element in place."""
    rs = np.random.RandomState(3)
    k = rs.randint(-128, 128, size=(16, D)).astype(np.int8)
    if which == "scores":
        qf = rs.randint(-64, 65, size=(8, D)).astype(np.float32)
        c = unit_scores(C, words(k), qf)
        want = k.astype(np.float64) @ qf.T.astype(np.float64)        # (16 keys, 8 rows)
        got = np.zeros((16, 8))
        for i, cv in enumerate(c):
            for g in range(8):
                for t in range(4):
                    got[g + 8 * (i >> 1), 2 * t + (i & 1)] = cv[g, t]
        np.testing.assert_array_equal(got, want)
    else:
        p = rs.randint(-64, 65, size=(8, 8)).astype(np.float32)      # (rows, keys)
        want = k[:8].astype(np.float64).T @ p.T.astype(np.float64)    # (d, rows)
        got = np.zeros((D, 8))
        for w in range(C["WARPS"]):
            acc = [np.zeros((16, 8), np.float32) for _ in range(2)]
            step_values(C, words(k[:8]), p, w, acc)
            for j in range(2):
                for i, cv in enumerate(frag_c(acc[j])):
                    for g in range(8):
                        for t in range(4):
                            got[32 * w + 4 * g + 2 * j + (i >> 1), 2 * t + (i & 1)] = cv[g, t]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("N", [1, 2, 7, 8])
def test_emulated_template_matches_plain(N, bridge):
    """S = 674 (610 + 64: the decode step's cache; ranks of 10 and 11
    units in passes, the last unit ragged), a fully masked row and a
    left-padded one."""
    check_template(C, N, 674, bridge, seed=N)


@pytest.mark.parametrize("S", [17, 2048])
def test_emulated_template_at_other_lengths(S):
    """S = 17: ranks with no unit; S = 2048: a long run of passes."""
    check_template(C, 8, S, True, seed=S)


@pytest.mark.parametrize("old,new", [
    ("MAGIC_BIAS = 8388736.f", "MAGIC_BIAS = 8388608.f"),
    ("SEL0 = 0x7440u", "SEL0 = 0x7448u"),
    ("SEL1 = 0x7441u", "SEL1 = 0x7442u"),
    ("SEL3 = 0x7443u", "SEL3 = 0x7043u"),
    ("SIGN_FLIP = 0x80808080u", "SIGN_FLIP = 0x80808000u"),
    ("MAGIC = 0x4B000000u", "MAGIC = 0x4A000000u"),
    ("UNIT = 16", "UNIT = 8"),
    ("UNIT = 16", "UNIT = 32"),
], ids=["bias", "sel0-sign", "sel1", "sel3", "flip", "magic", "unit8", "unit32"])
def test_source_mutation_fails_the_checks(old, new):
    """Each change to the source text, applied to a copy, breaks at least
    one of the checks above (a unit is the score mma's 16 keys, so it
    cannot be 8 or 32)."""
    assert old in SOURCE
    c = constants(SOURCE.replace(old, new, 1))
    assert c != C
    with pytest.raises(AssertionError):
        for pos in range(4):
            check_every_byte(c, pos)
        for S in (17, 674):
            check_slicing(c, S)
        check_template(c, 2, 128, True, seed=2)


@pytest.mark.parametrize("name", ["kept", "first", "r4", "p3", "vlate", "r4p3", "kept+trace",
                                  "r4p3+trace"])
def test_variant_sources_apply(name, tmp_path, monkeypatch):
    """``tools/decode_attention_variants`` builds each variant by editing the
    source's text: every edit still finds its anchor, and each variant's
    constants are the ones it names (the kept one's are the source's)."""
    from libra_tpu_torch.tools import decode_attention_variants as V
    monkeypatch.setattr(V, "OUT", tmp_path)
    path = V.source(name)
    text = path.read_text()
    # every header it includes is beside it (split_k.cuh was missing once)
    assert all((path.parent / h).exists() for h in ("flash_mma.cuh", "split_k.cuh"))
    c = constants(text)
    base = name.split("+")[0]
    want = {"kept": (C["RANKS"], C["PASS_UNITS"], C["BLOCKS_PER_SM"]), "first": (8, 6, 1),
            "r4": (4, 6, 1), "p3": (8, 3, 1), "vlate": (8, 6, 1), "r4p3": (4, 3, 1)}[base]
    assert (c["RANKS"], c["PASS_UNITS"], c["BLOCKS_PER_SM"]) == want
    assert text.count("TS(") == (10 if "trace" in name else 0)
    assert ("cp_wait<1>" in text) == (base != "vlate")


# ---------------------------------------------------------------------------
# The rows template (any N <= 64: the fallback for unaligned operands)
# ---------------------------------------------------------------------------

ROWS_BS = int(re.search(r"constexpr int BS = (\d+);", SOURCE).group(1))   # keys a tile


def fma32(a, b, c) -> np.ndarray:
    """fmaf: the exact product plus c, rounded to fp32 once."""
    return f32(np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64))


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


def rows_scores(q, kq, ks, kbq, kbs, cross, bias) -> np.ndarray:
    """The rows template's scores (B, H, N, S): lane l's fmaf chain over d =
    4 l .. 4 l + 3, the xor tree over the 32 lanes, the K scales, the
    bridge term where cross holds, the bias and the BIG_NEG clamp."""
    scale = np.float32(1.0 / D ** 0.5)
    qf = q.transpose(0, 2, 1, 3)[:, :, :, None].reshape(q.shape[0], q.shape[2], q.shape[1],
                                                        1, 32, 4)

    def dots(k):
        kf = k.astype(np.float32)[:, :, None].reshape(k.shape[0], k.shape[1], 1,
                                                       k.shape[2], 32, 4)
        d = np.zeros(np.broadcast_shapes(qf.shape, kf.shape)[:-1], np.float32)
        for e in range(4):
            d = fma32(qf[..., e], kf[..., e], d)
        return warp_sum(d)

    x = f32(f32(dots(kq) * ks[:, :, None]) * scale)
    if kbq is not None:
        xb = f32(f32(dots(kbq) * kbs[:, :, None]) * scale)
        x = np.where(cross[:, None], f32(x + xb), x)
    return np.maximum(f32(x + bias[:, None]), BIG_NEG)


def emulate_rows(q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias,
                 two_pass: bool = True) -> np.ndarray:
    """The rows template for every (b, h) at once: (B, N, H, 128) as bf16
    values in fp32. `two_pass`: pass 1 keeps each row's max M and sum L of
    exp(s - M) over the tiles of 32 keys (lane j on key j; L rescaled as M
    grows); pass 2 writes p = bf16((exp(s - M) / L) * vs) (and with vbs
    where cross holds); the values add p * v in fmaf chains over the even
    and the odd keys of each tile, the halves added at the end. Otherwise
    the one-pass order it replaced: an online softmax with fp32 p * vs,
    divided by L at the end."""
    B, N, H, _ = q.shape
    S = kq.shape[2]
    cross = fq[:, :, None] != fk[:, None, :]                          # (B, N, S)
    x = rows_scores(q, kq, ks, kbq, kbs, cross, bias)                 # (B, H, N, S)
    nt = -(-S // ROWS_BS)
    xp = np.full(x.shape[:-1] + (nt * ROWS_BS,), -np.inf, np.float32)
    xp[..., :S] = x
    m = np.full(x.shape[:-1], BIG_NEG, np.float32)
    ell = np.zeros_like(m)
    acc = np.zeros((2, B, H, N, D), np.float32)                       # even, odd keys
    vf = vq.astype(np.float32)
    vbf = vbq.astype(np.float32) if vbq is not None else None

    def values(p, pb, s0, alpha=None):
        for hf in range(2):
            if alpha is not None:
                acc[hf] = f32(acc[hf] * alpha[..., None])
            for j in range(hf, ROWS_BS, 2):
                k = s0 + j
                if k >= S:
                    break
                acc[hf] = fma32(p[..., j, None], vf[:, :, None, k], acc[hf])
                if pb is not None:
                    acc[hf] = fma32(pb[..., j, None], vbf[:, :, None, k], acc[hf])

    def probs(e, s0):
        j = np.minimum(s0 + np.arange(ROWS_BS), S - 1)
        live = (s0 + np.arange(ROWS_BS)) < S
        p = np.where(live, e * vs[:, :, None, j], 0)
        pb = None
        if kbq is not None:
            cr = np.zeros((B, 1, N, ROWS_BS), bool)
            cr[:, 0] = cross[:, :, j] & live
            pb = np.where(cr, e * vbs[:, :, None, j], 0)
        return p, pb

    for s0 in range(0, nt * ROWS_BS, ROWS_BS):
        xt = xp[..., s0:s0 + ROWS_BS]
        m_new = np.maximum(m, xt.max(-1))
        alpha = np.exp(f32(m - m_new)).astype(np.float32)
        e = np.exp(f32(xt - m_new[..., None])).astype(np.float32)
        ell = f32(ell * alpha + warp_sum(e))
        m = m_new
        if not two_pass:
            p, pb = probs(e, s0)
            values(f32(p), None if pb is None else f32(pb), s0, alpha)
    if not two_pass:
        return bf16(f32(f32(acc[0] + acc[1]) / ell[..., None])).transpose(0, 2, 1, 3)
    for s0 in range(0, nt * ROWS_BS, ROWS_BS):
        xt = xp[..., s0:s0 + ROWS_BS]
        an = f32(np.exp(f32(xt - m[..., None])).astype(np.float32) / ell[..., None])
        p, pb = probs(an, s0)
        values(bf16(p), None if pb is None else bf16(pb), s0)
    return bf16(f32(acc[0] + acc[1])).transpose(0, 2, 1, 3)


def check_rows(N: int, bridge: bool, two_pass: bool) -> None:
    """The emulation against the Pallas kernel in interpret mode on the
    same bf16 q, bf16 outputs compared (S = 128, the Pallas kernel's
    128-slot tiling): the same probabilities rounded at the same place,
    sums in another order, exp in another library, so a probability's or
    an output's bf16 rounding may flip where the two land on either side
    of a tie: at most 0.1% of outputs differ, each by at most 2^-12 of
    max|V| (a flipped probability) or one bf16 ulp of itself (a flipped
    output rounding; a row with few live keys has outputs near max|V|).
    fp32 probabilities make ~40% of outputs differ."""
    q, kw, fq, fk, bias = case(N, 128, bridge, seed=N + bridge)
    want = np.asarray(jda.int8_decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16), **{n: jnp.asarray(a) for n, a in kw.items()},
        flag_q=jnp.asarray(fq), kv_flag=jnp.asarray(fk), bias=jnp.asarray(bias),
        interpret=True), np.float32)
    got = emulate_rows(q, kw["kq"], kw["ks"], kw["vq"], kw["vs"], kw.get("kbq"),
                       kw.get("kbs"), kw.get("vbq"), kw.get("vbs"), fq, fk, bias, two_pass)
    vmax = 128 * kw["vs"].max()
    diff = np.abs(got - want)
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2.0 ** 16      # bf16's, for normal values
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} of outputs differ"
    assert (diff <= np.maximum(2.0 ** -12 * vmax, ulp)).all(), diff.max() / vmax


def rows_kernel(text: str) -> str:
    """The body of the rows template's kernel in the source text."""
    start = text.index("decode_attention_kernel(const Args a) {")
    return text[start:text.index("cudaError_t launch(", start)]


def check_rows_source(text: str) -> None:
    """The rows kernel in `text` runs the order `emulate_rows` models with
    `two_pass`: two loops over the key tiles; in the second, each live
    key's probability exp(s - M) / L times its V scale (and the bridge's
    V scale) rounded to bf16; after the loops no division by L."""
    body = rows_kernel(text)
    loop = "for (int s0 = 0; s0 < a.S; s0 += BS)"
    assert body.count(loop) == 2, "not two passes over the key tiles"
    second = body[body.rindex(loop):]
    assert re.search(r"an = expf\(Ss\[n \* BS \+ lane\] - m_run\[i\]\) / l_run\[i\];",
                     second), "p is not exp(s - M) / L"
    assert "bf16_rn(an * a.vs[sbase + sj])" in second, "p * vs is not rounded to bf16"
    assert "bf16_rn(an * a.vbs[sbase + sj])" in second, "the bridge's p is not rounded to bf16"
    tail = second[second.index("// --- add the two halves"):]
    assert "/" not in tail.replace("//", ""), "a division after the loops"


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("N", [16, 64])
def test_emulated_rows_template_matches_pallas(N, bridge):
    """N = 16 and 64 (the rows template's merged-prefill windows), batch 0's
    last query row fully masked (the uniform average of V), batch 1
    left-padded, a causal bias. The emulation proves the order; the source
    is held to that order first, so a rows kernel that no longer runs it
    fails here. The kernel itself is held to the plain version on the
    card by ``chip_smoke.py`` phase 5."""
    check_rows_source(SOURCE)
    check_rows(N, bridge, two_pass=True)


@pytest.mark.parametrize("old,new", [
    ("bf16_rn(an * a.vs[sbase + sj])", "an * a.vs[sbase + sj]"),
    ("bf16_rn(an * a.vbs[sbase + sj])", "an * a.vbs[sbase + sj]"),
    ("- m_run[i]) / l_run[i];", "- m_run[i]);"),
    ("const float o = acc[n] + Hs[n * D + col];",
     "const float o = (acc[n] + Hs[n * D + col]) / Al[n];"),
    ("for (int s0 = 0; s0 < a.S; s0 += BS) {\n    __syncthreads();   // Q is staged",
     "for (int s0 = 0; s0 < 0; s0 += BS) {\n    __syncthreads();   // Q is staged"),
])
def test_rows_source_mutation_fails_the_order_check(old, new):
    """Each edit back toward the one-pass order (fp32 probabilities, no
    normalization in the loop, a final division by L, one loop) fails
    `check_rows_source`."""
    assert old in rows_kernel(SOURCE)
    with pytest.raises(AssertionError):
        check_rows_source(SOURCE.replace(old, new, 1))


@pytest.mark.parametrize("bridge", [True, False])
def test_one_pass_rows_order_fails_against_pallas(bridge):
    """The order the rows template had before its repair: fp32
    probabilities, the division by the row sum at the end."""
    with pytest.raises(AssertionError):
        check_rows(16, bridge, two_pass=False)
