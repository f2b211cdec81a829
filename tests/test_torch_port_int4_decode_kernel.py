"""A CPU rehearsal of the int4 matmul kernel's decode template
(``libra_tpu_torch/csrc/int4_matmul.cu``, namespace ``dec``), in numpy and
torch only.

No CUDA kernel runs here, so the template's integer tricks are emulated
bit for bit with the constants read from the CUDA source itself (the
masks, the ``__byte_perm`` selectors, the magic float, the split of K):

* the two masks turn each byte of a packed word into 16 q of its odd and
  of its even weight, and the magic-number floats give each weight exactly;
* the 4x4 byte transpose gives each column's 4 consecutive weights;
* the whole template (K slices over cluster ranks and warps, group
  flushes, ``__dp4a`` or fp32 products, the warp and rank sums) equals
  ``int4_matmul_plain`` to fp32 round-off;
* the (cluster rank, warp) -> byte-row slicing covers every byte row once,
  each pair inside the group its flush bookkeeping gives it.

The kernel itself is held against ``int4_matmul_plain`` on the card by
``chip_smoke.py`` phase 4.
"""

import re

import numpy as np
import pytest
import torch

from libra_tpu_torch.ops import int4_matmul as ti4

SOURCE = ti4.SOURCE.read_text()


def _constants() -> dict:
    """The ``constexpr`` scalars of the decode template's namespace."""
    body = SOURCE[SOURCE.index("namespace dec {"):SOURCE.index("}  // namespace dec")]
    out = {}
    for name, value in re.findall(r"constexpr\s+(?:int|uint32_t|float)\s+(\w+)\s*=\s*"
                                  r"([-+*/ \w.()]+);", body):
        v = value.strip()
        if re.fullmatch(r"0x[0-9A-Fa-f]+u?", v):
            out[name] = int(v.rstrip("u"), 16)
        elif re.fullmatch(r"[0-9.]+f", v):
            out[name] = float(v[:-1])
        else:   # an expression of the names before it (not one of a kernel's)
            try:
                out[name] = eval(v, {"__builtins__": {}}, dict(out))   # noqa: S307
            except NameError:
                pass
    return out


C = _constants()
U32 = np.uint32


def byte_perm(x, y, s: int):
    """``__byte_perm(x, y, s)``: byte n of the result is byte (s >> 4n) & 7
    of the 8 bytes (x0..x3, y0..y3)."""
    src = np.stack([(np.asarray(v, U32) >> U32(8 * i)) & U32(255)
                    for v in (x, y) for i in range(4)])
    out = np.zeros(np.shape(x), U32)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << U32(8 * n)
    return out


def lo16(w):
    return ((np.asarray(w, U32) << U32(4)) ^ U32(C["NIB_FLIP"])) & U32(C["NIB_HI"])


def hi16(w):
    return np.asarray(w, U32) & U32(C["NIB_HI"])


def magic_float(n):
    """The fp32 of the bits MAGIC | n, minus MAGIC_BIAS, in fp32."""
    bits = (U32(C["MAGIC"]) | np.asarray(n, U32)).view(np.float32)
    return bits - np.float32(C["MAGIC_BIAS"])


def lo_f(w, c):
    return magic_float((np.asarray(w, U32) >> U32(8 * c)) & U32(15))


def hi_f(w, c):
    return magic_float(((np.asarray(w, U32) >> U32(8 * c + 4)) & U32(15)) ^ U32(8))


def column_words(w0, w1):
    """Two words of byte rows 2p, 2p+1 -> one word per column c holding
    16 q[4p..4p+3] (the kernel's masks and transpose)."""
    lo0, hi0, lo1, hi1 = lo16(w0), hi16(w0), lo16(w1), hi16(w1)
    t0, t1 = byte_perm(lo0, hi0, C["SEL_LO"]), byte_perm(lo0, hi0, C["SEL_HI"])
    t2, t3 = byte_perm(lo1, hi1, C["SEL_LO"]), byte_perm(lo1, hi1, C["SEL_HI"])
    return [byte_perm(t0, t2, C["SEL_W0"]), byte_perm(t0, t2, C["SEL_W1"]),
            byte_perm(t1, t3, C["SEL_W0"]), byte_perm(t1, t3, C["SEL_W1"])]


def signed_bytes(w):
    """(..., ) uint32 -> (..., 4) int8, byte 0 first."""
    return np.ascontiguousarray(np.asarray(w, U32)).view(np.int8).reshape(np.shape(w) + (4,))


def dp4a(a, b, c):
    """``__dp4a(a, b, c)``: c + the sum of the products of the signed bytes."""
    return c + (signed_bytes(a).astype(np.int32) * signed_bytes(b).astype(np.int32)).sum(-1)


def q_of_byte(b):
    """The weights (q[2r], q[2r+1]) of packed byte values b (int8)."""
    b = np.asarray(b, np.int32)
    return (b & 15) - 8, b >> 4


def warp_slice(K: int, rank: int, warp: int):
    """The kernel's slicing: (first pair, pairs) of a warp, and the first
    unit and k count of its block's x slice."""
    U, ks, w = K // C["UNIT_K"], C["KSPLIT"], C["WARPS"]
    sl = rank * w + warp
    u0 = U * sl // C["SLICES"]
    ub = U * rank // ks
    return 4 * u0, 4 * (U * (sl + 1) // C["SLICES"] - u0), ub, C["UNIT_K"] * (U * (rank + 1) // ks - ub)


def test_constants_read_from_the_source():
    assert {"NIB_HI", "NIB_FLIP", "SEL_LO", "SEL_HI", "SEL_W0", "SEL_W1", "MAGIC",
            "MAGIC_BIAS", "DP4A_SCALE", "KSPLIT", "WARPS", "UNIT_K", "SLICES",
            "TILE"} <= set(C)
    assert C["SLICES"] == C["KSPLIT"] * C["WARPS"] and C["UNIT_K"] % 4 == 0
    assert C["TILE"] == 32 * 4 and C["DP4A_SCALE"] == 1 / 16


@pytest.mark.parametrize("c", range(4))
def test_masks_and_magic_floats_every_byte(c):
    """Byte c of a word runs over all 256 values, its neighbours random
    (a shift must not carry them in): the masks give 16 q of each weight
    as a signed byte, the magic floats each weight exactly."""
    rs = np.random.RandomState(c)
    b = np.arange(-128, 128, dtype=np.int32)
    w = rs.randint(0, 2 ** 32, size=256, dtype=np.uint64).astype(U32)
    w = (w & ~U32(255 << (8 * c))) | ((b.astype(U32) & U32(255)) << U32(8 * c))
    q_even, q_odd = q_of_byte(b)
    np.testing.assert_array_equal(signed_bytes(hi16(w))[:, c], 16 * q_odd)
    np.testing.assert_array_equal(signed_bytes(lo16(w))[:, c], 16 * q_even)
    np.testing.assert_array_equal(lo_f(w, c), q_even.astype(np.float32))
    np.testing.assert_array_equal(hi_f(w, c), q_odd.astype(np.float32))
    assert lo_f(w, c).dtype == np.float32


@pytest.mark.parametrize("seed", range(3))
def test_byte_transpose(seed):
    """The transpose's selectors on four random words give column c the
    bytes (a_c, b_c, c_c, d_c); on two packed byte rows, 16 q[4p..4p+3]."""
    rs = np.random.RandomState(seed)
    a, b, c, d = (rs.randint(0, 2 ** 32, size=64, dtype=np.uint64).astype(U32)
                  for _ in range(4))
    t0, t1 = byte_perm(a, b, C["SEL_LO"]), byte_perm(a, b, C["SEL_HI"])
    t2, t3 = byte_perm(c, d, C["SEL_LO"]), byte_perm(c, d, C["SEL_HI"])
    cols = [byte_perm(t0, t2, C["SEL_W0"]), byte_perm(t0, t2, C["SEL_W1"]),
            byte_perm(t1, t3, C["SEL_W0"]), byte_perm(t1, t3, C["SEL_W1"])]
    for col in range(4):
        want = np.stack([signed_bytes(v)[:, col] for v in (a, b, c, d)], -1)
        np.testing.assert_array_equal(signed_bytes(cols[col]), want)
    rows = rs.randint(-128, 128, size=(2, 64, 4)).astype(np.int8)   # 2 byte rows
    w0, w1 = (np.ascontiguousarray(r).view(U32)[:, 0] for r in rows)
    (e0, o0), (e1, o1) = q_of_byte(rows[0]), q_of_byte(rows[1])
    for col, word in enumerate(column_words(w0, w1)):
        want = 16 * np.stack([e0[:, col], o0[:, col], e1[:, col], o1[:, col]], -1)
        np.testing.assert_array_equal(signed_bytes(word), want)


def emulate(x: np.ndarray, packed: np.ndarray, scales: np.ndarray, G: int,
            a8: bool) -> np.ndarray:
    """The decode template step by step, over all lanes of all tiles at
    once, in fp32 and int32: the result before its bf16 rounding."""
    M, K = x.shape
    F = packed.shape[1]
    MT = next(t for t in (1, 2, 4, 8) if t >= M)
    T = C["TILE"]
    Fp = -(-F // T) * T
    # words[r, lane]: byte row r of columns 4 lane .. 4 lane + 3, 0 past F
    pk = np.zeros((K // 2, Fp), np.int8)
    pk[:, :F] = packed
    words = pk.view(U32)
    sc = np.zeros((K // G, Fp), np.float32)
    sc[:, :F] = scales
    xs = np.zeros((MT, K), np.float32)
    xs[:M] = x
    ranks, warps = C["KSPLIT"], C["WARPS"]
    if a8:
        amax = np.zeros((ranks, MT), np.float32)
        for r in range(ranks):
            _, _, ub, nkb = warp_slice(K, r, 0)
            k0 = C["UNIT_K"] * ub
            amax[r] = np.abs(xs[:, k0:k0 + nkb]).max(-1, initial=0)
        amax = amax.max(0)
        sx = (np.where(amax > 0, amax, np.float32(1)) / np.float32(127)).astype(np.float32)
        xq = np.rint(xs / sx[:, None]).astype(np.int8)                # (MT, K)
        xw = np.ascontiguousarray(xq).view(U32)                        # (MT, K/4)
    PG = G // 4
    tot = np.zeros((ranks, MT, Fp), np.float32)
    for r in range(ranks):
        red = np.zeros((warps, MT, Fp), np.float32)
        for w in range(warps):
            p0, n, _, _ = warp_slice(K, r, w)
            acc = np.zeros((MT, Fp), np.float32)
            part = np.zeros((MT, Fp), np.int32 if a8 else np.float32)
            g = p0 // PG
            pend = (g + 1) * PG
            s = sc[g] if n else np.zeros(Fp, np.float32)

            def flush():
                sg = s * np.float32(C["DP4A_SCALE"]) if a8 else s
                acc[:] = acc + part.astype(np.float32) * sg
                part[:] = 0

            for p in range(p0, p0 + n):
                if p >= pend:
                    flush()
                    g, pend = g + 1, pend + PG
                    s = sc[g]
                w0, w1 = words[2 * p], words[2 * p + 1]
                if a8:
                    cols = column_words(w0, w1)
                    for m in range(MT):
                        for c in range(4):
                            part[m, c::4] = dp4a(cols[c], xw[m, p], part[m, c::4])
                else:
                    for c in range(4):
                        q = [lo_f(w0, c), hi_f(w0, c), lo_f(w1, c), hi_f(w1, c)]
                        for m in range(MT):
                            for kk in range(4):
                                part[m, c::4] += xs[m, 4 * p + kk] * q[kk]
            flush()
            red[w] = acc
        for w in range(warps):
            tot[r] += red[w]
    out = np.zeros((MT, Fp), np.float32)
    for r in range(ranks):
        out += tot[r]
    if a8:
        out *= sx[:, None]
    return out[:M, :F]


@pytest.mark.parametrize("a8", [True, False], ids=["w4a8", "weight-only"])
@pytest.mark.parametrize("G", [64, 128])
@pytest.mark.parametrize("M", [1, 4, 7, 8])
def test_emulated_template_matches_plain(M, G, a8):
    """K = 256, O = 128 (one tile), a zero row of x where M > 1. W4A8: the
    group sums are the same exact integers, the 1/16 is exact, so only the
    fp32 sums over groups, warps and ranks differ in order. Weight-only:
    the template scales the group sum, the plain version each weight, so
    the roundings differ too; both stay within 1e-5 of max|ref|."""
    rs = np.random.RandomState(M * 1000 + G)
    K, O = 256, 128
    packed, scales = ti4.pack_int4(torch.from_numpy(rs.randn(K, O).astype(np.float32)), G)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).bfloat16().float()
    if M > 1:
        x[M // 2] = 0
    want = ti4.int4_matmul_plain(x, packed, scales, G, a8=a8).numpy()
    got = emulate(x.numpy(), packed.numpy(), scales.numpy(), G, a8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if M > 1:
        assert not got[M // 2].any()


@pytest.mark.parametrize("a8", [True, False], ids=["w4a8", "weight-only"])
def test_emulated_template_ragged_tile(a8):
    """F = 192: the second tile's last 64 columns lie past F. K = 512 is
    32 units, 4 a block: half the warps' slices are empty."""
    rs = np.random.RandomState(7)
    K, O, G, M = 512, 192, 64, 4
    packed, scales = ti4.pack_int4(torch.from_numpy(rs.randn(K, O).astype(np.float32)), G)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).bfloat16().float()
    want = ti4.int4_matmul_plain(x, packed, scales, G, a8=a8).numpy()
    got = emulate(x.numpy(), packed.numpy(), scales.numpy(), G, a8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("G", [64, 128])
@pytest.mark.parametrize("K", [256, 4096, 11008])
def test_slicing_covers_every_byte_row_once(K, G):
    """Every byte row in exactly one warp's slice; each block's slice the
    union of its warps', inside the x stride; each pair in the group the
    kernel's flush bookkeeping gives it (K = 11008: 86 groups of 128, not
    a multiple of the 8 ranks)."""
    seen = np.zeros(K // 2, np.int32)
    stride = C["UNIT_K"] * -(-(K // C["UNIT_K"]) // C["KSPLIT"])
    PG = G // 4
    for r in range(C["KSPLIT"]):
        pairs = []
        for w in range(C["WARPS"]):
            p0, n, ub, nkb = warp_slice(K, r, w)
            assert n % 4 == 0 and p0 % 4 == 0
            g, pend = p0 // PG, (p0 // PG + 1) * PG
            for p in range(p0, p0 + n):
                if p >= pend:
                    g, pend = g + 1, pend + PG
                assert (4 * p) // G == g == (4 * p + 3) // G
                seen[2 * p:2 * p + 2] += 1
            pairs += range(p0, p0 + n)
        k0 = C["UNIT_K"] * ub
        assert nkb <= stride
        assert [4 * p for p in pairs] == list(range(k0, k0 + nkb, 4))
    np.testing.assert_array_equal(seen, 1)
