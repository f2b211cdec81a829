"""A CPU rehearsal of the W4A8 mode (E, H and F) of the int4 experiment's
decode template (``libra_tpu_torch/csrc/int4_exp.cu``, namespace ``dec``),
in numpy and torch only.

No CUDA kernel runs here, so the template's steps are emulated with the
constants read from the CUDA source itself (the transpose selectors, the
nibble mask and the high nibble's flip, the staging selector, the magic
number, the group limit, the unit and the split of K):

* the 4x4 byte transpose and the masks give u0 = q0 + 8 and q1 + 8 for
  all 256 byte values in every position of a word;
* the u8 x s8 m16n8k32 fragment layouts of the PTX ISA, with the lanes'
  own words as A and x staged as each lane's 4 even k, then its 4 odd k,
  as B, cover every (byte row, column) of a unit once and pair each nibble
  with its xq;
* the in-kernel xq (IEEE division, the magic-number add as rint) is
  bitwise the plain version's, .5 ties and a zero row included;
* the magic-number conversion of a group sum is exact over their range;
* the whole template (the slices' maxima, the staging and unit sums, each
  warp's m16n8k32 tiles over its units, the -8 sum xq correction and the
  group scales as the warp's rows leave a group, the warp-order then
  rank-order sums, xs) equals ``int4_exp_a8_plain`` to fp32 round-off;
* a change to a constant in the source text fails these checks;
* the wrappers' checks, the template gate and ``chip_smoke.py``'s rules
  for the mode (its SASS opcode, phase 8's cases).

The kernel itself is held against the plain version on the card by
``chip_smoke.py`` phase 8; ``test_torch_port_exp_int4.py`` holds the plain
version to the JAX kernels ``build_e`` and ``_a8_fn`` in interpret mode.
"""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
# the reader of the source's constants and the PTX prmt, shared with the
# rehearsal of the template's D and C modes
from test_torch_port_int4_exp_decode_kernel import constants, prmt  # noqa: E402

from libra_tpu_torch.ops import int4_exp as te  # noqa: E402

SOURCE = te.SOURCE.read_text()
U32 = np.uint32
I64 = np.int64
F32 = np.float32


C = constants(SOURCE)


def byte(w, i: int, signed: bool = False) -> np.ndarray:
    v = ((np.asarray(w, U32) >> U32(8 * i)) & U32(255)).astype(I64)
    return np.where(v >= 128, v - 256, v) if signed else v


def words(b: np.ndarray) -> np.ndarray:
    """(..., 4) bytes -> (...,) little-endian words."""
    b = np.asarray(b, I64) & 255
    return sum((b[..., i] << (8 * i)) for i in range(4)).astype(U32)


def transpose(c: dict, w) -> np.ndarray:
    """(..., 4) words, word r a byte row with byte j its column j -> (...,
    4) words, word j the column with byte r its byte row r: the kernel's 8
    PRMT."""
    w = np.asarray(w, U32)
    t0, t1 = prmt(w[..., 0], w[..., 1], c["SEL_LO"]), prmt(w[..., 0], w[..., 1], c["SEL_HI"])
    t2, t3 = prmt(w[..., 2], w[..., 3], c["SEL_LO"]), prmt(w[..., 2], w[..., 3], c["SEL_HI"])
    return np.stack([prmt(t0, t2, c["SEL_W0"]), prmt(t0, t2, c["SEL_W1"]),
                     prmt(t1, t3, c["SEL_W0"]), prmt(t1, t3, c["SEL_W1"])], -1)


def nibbles(c: dict, col) -> tuple:
    """A column word -> (lo, hi): the mask, and the shift and LOP3."""
    col = np.asarray(col, U32)
    m = U32(c["NIB_MASK"])
    return col & m, ((col >> U32(4)) ^ U32(c["HI_FLIP"])) & m


def quantize(c: dict, x: np.ndarray) -> tuple:
    """The kernel's quantization of the rows of x (R, K) fp32 holding bf16
    values: the absmax on the bf16 bits (per K slice of a rank, then the
    max of the 8 slices), xs = amax / 127 (IEEE fp32) or 1, clip(x / xs),
    the magic-number add. Returns (xs (R,), the added bits (R, K), xq (R,
    K) int64 from the bits)."""
    R, K = x.shape
    bits = (np.ascontiguousarray(x, F32).view(U32) >> U32(16)) & U32(0x7FFF)
    U = K // c["UNIT_K"]
    amax = np.zeros(R, U32)
    for rank in range(c["KSPLIT"]):
        lo = c["UNIT_K"] * (U * rank // c["KSPLIT"])
        hi = c["UNIT_K"] * (U * (rank + 1) // c["KSPLIT"])
        if hi > lo:
            amax = np.maximum(amax, bits[:, lo:hi].max(axis=1))
    amax = (amax << U32(16)).view(F32)
    xs = np.where(amax > 0, amax / F32(127), F32(1)).astype(F32)
    y = np.clip(x / xs[:, None], F32(-127), F32(127)).astype(F32)
    b = np.ascontiguousarray(y + F32(c["MAGIC_F"]), F32).view(U32)
    return xs, b, b.astype(I64) - c["MAGIC_I"]


def stage(c: dict, b: np.ndarray) -> np.ndarray:
    """The added bits (R, K) -> the staged int8 bytes (R, K): each 8 k as
    its 4 even k, then its 4 odd k (two PRMT by XQ_PAIR and one by SEL_W0 a
    word)."""
    R, K = b.shape
    v = b.reshape(R, K // 8, 8)

    def word(i):
        return prmt(prmt(v[..., i], v[..., i + 2], c["XQ_PAIR"]),
                    prmt(v[..., i + 4], v[..., i + 6], c["XQ_PAIR"]), c["SEL_W0"])
    w = np.ascontiguousarray(np.stack([word(0), word(1)], -1))
    return w.view(np.int8).reshape(R, K).astype(I64)


def magic(c: dict, n) -> np.ndarray:
    """The kernel's int -> fp32 of a group sum: the bits MAGIC_I + n as
    fp32, minus MAGIC_F."""
    bits = ((np.asarray(n, I64) + c["MAGIC_I"]) & 0xFFFFFFFF).astype(U32)
    return (np.ascontiguousarray(bits).view(F32) - F32(c["MAGIC_F"])).astype(F32)


def mma_u8s8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``mma.sync.m16n8k32.row.col.s32.u8.s8.s32`` from the lanes'
    registers: a (..., 32 lanes, 4) words, b (32 lanes, 2) words -> D (...,
    16, 8) int64, by the PTX ISA's fragment layouts (lane = 4 g + t; a0 (g,
    4 t .. 4 t + 3), a1 (g + 8, 4 t ..), a2 (g, 16 + 4 t ..), a3 (g + 8, 16 +
    4 t ..), byte i element i, unsigned; b0 (4 t .., g), b1 (16 + 4 t .., g),
    signed; D row r column n is the sum over the 32 k)."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    A = np.zeros(a.shape[:-2] + (16, 32), I64)
    B = np.zeros((32, 8), I64)
    for reg, (row0, k0) in enumerate([(0, 0), (8, 0), (0, 16), (8, 16)]):
        for i in range(4):
            A[..., g + row0, k0 + 4 * t + i] = byte(a[..., reg], i)
    for reg, k0 in enumerate((0, 16)):
        for i in range(4):
            B[k0 + 4 * t + i, g] = byte(b[:, reg], i, signed=True)
    return A @ B


def b_regs(staged_unit: np.ndarray) -> np.ndarray:
    """A unit's staged bytes (8 rows of x, 32) -> each lane's (b0, b1): row
    g's bytes 8 t .. 8 t + 3 and 8 t + 4 .. 8 t + 7 (32, 2)."""
    return words(staged_unit.reshape(8, 4, 2, 4)).reshape(32, 2)


def a_regs(lo: np.ndarray, hi: np.ndarray, p: int) -> np.ndarray:
    """Column pair p's A registers of each lane: the low nibbles of columns
    2 p and 2 p + 1, then their high nibbles."""
    return np.stack([lo[..., 2 * p], lo[..., 2 * p + 1], hi[..., 2 * p], hi[..., 2 * p + 1]], -1)


def check_every_byte(c: dict, pos: int) -> None:
    """Byte `pos` of each of a lane's 4 words runs over all 256 values, its
    neighbours random: after the transpose and masks, byte r of column j's
    words is u0 = q0 + 8 and q1 + 8 of byte j of word r, for every j."""
    rs = np.random.RandomState(pos)
    b = rs.randint(-128, 128, size=(256, 4, 4))            # [case, word r, byte j]
    for r in range(4):
        b[:, r, pos] = (np.arange(256) + 67 * r) % 256 - 128
    lo, hi = nibbles(c, transpose(c, words(b)))            # [case, column j]
    for j in range(4):
        for r in range(4):
            np.testing.assert_array_equal(byte(lo[:, j], r), b[:, r, j] & 15)
            np.testing.assert_array_equal(byte(hi[:, j], r), (b[:, r, j] >> 4) + 8)


def check_fragments(c: dict, seed: int) -> None:
    """Random units (16 byte rows x 32 columns of a column group, 8 rows of
    int8 xq over the unit's 32 k): the two m16n8k32 of the lanes' own
    registers give, in D row i, column 4 (i % 8) + 2 p + i // 8, the sums
    xq . (q + 8) of that column over the unit's 32 k."""
    assert c["UNIT_ROWS"] == 16 and c["UNIT_K"] == 32, "a unit is one m16n8k32"
    rs = np.random.RandomState(seed)
    P = rs.randint(-128, 128, size=(16, 16, 32))            # [case, byte row, column]
    xq = rs.randint(-127, 128, size=(8, 32))
    xq[5] = 0
    q = np.empty((16, 32, 32), I64)                         # [case, k, column]
    q[:, 0::2], q[:, 1::2] = (P & 15) - 8, P >> 4
    want = np.einsum("nk,ckj->cjn", xq, q + 8)               # [case, column, x row]
    lane_words = words(P.reshape(16, 4, 4, 8, 4).transpose(0, 3, 1, 2, 4))  # [case, g, t, r]
    lo, hi = nibbles(c, transpose(c, lane_words.reshape(16, 32, 4)))
    staged = stage(c, xq.astype(I64) + c["MAGIC_I"])
    for p in range(2):
        d = mma_u8s8(a_regs(lo, hi, p), b_regs(staged))
        cols = [4 * (i % 8) + 2 * p + i // 8 for i in range(16)]
        np.testing.assert_array_equal(d, want[:, cols])


def check_quantization(c: dict, x: np.ndarray) -> None:
    """The kernel's xs and xq of x (rows of bf16 values) are bitwise the
    plain version's (``quantize_rows``)."""
    xs, _, xq = quantize(c, x)
    want, want_xs = te.quantize_rows(torch.from_numpy(x), x.shape[0])
    np.testing.assert_array_equal(xs, want_xs[:, 0].numpy())
    np.testing.assert_array_equal(xq, want.numpy().astype(I64))


def check_magic(c: dict) -> None:
    """Every group sum a warp can hold (|n| <= 1016 G, G <= MAX_GROUP_A8)
    converts exactly: the range's ends, the powers of two and a random
    sample."""
    top = 1016 * c["MAX_GROUP_A8"]
    assert top < 2 ** 22
    rs = np.random.RandomState(0)
    n = np.concatenate([np.arange(-4096, 4097), [-top, top, -(2 ** 21), 2 ** 21 - 1],
                        rs.randint(-top, top + 1, size=100_000)]).astype(I64)
    np.testing.assert_array_equal(magic(c, n).astype(I64), n)


def emulate(c: dict, x: np.ndarray, packed: np.ndarray, scales: np.ndarray, G: int,
            bp: int) -> np.ndarray:
    """The W4A8 mode step by step, every lane of every tile at once: the
    (bp, F) fp32 result. Integer sums are exact; each fp32 multiply-add is
    modelled as rounded once."""
    M, K = x.shape
    F = packed.shape[1]
    ur, uk, T, GR = c["UNIT_ROWS"], c["UNIT_K"], c["TILE"], c["GROUPS"]
    assert M <= 8 and G % uk == 0 and K % G == 0 and F % 4 == 0 and G <= c["MAX_GROUP_A8"]
    assert ur == 16 and uk == 32 and c["TILE"] == 2 * c["WCOLS"] == 64 * GR
    MT = next(m for m in (1, 2, 4, 8) if m >= M)
    nt = -(-F // T)
    U, GU = K // uk, G // uk
    pp = np.zeros((K // 2, nt * T), np.int8)
    pp[:, :F] = packed
    sp = np.zeros((K // G, nt * T), F32)
    sp[:, :F] = scales
    lane_words = pp.view(U32).reshape(K // 2, nt, 2, GR, 8)   # [byte row, tile, half, j, g]
    xp = np.zeros((MT, K), F32)
    xp[:M] = x
    xs, bits, xq = quantize(c, xp)
    staged = np.zeros((8, K), I64)
    staged[:MT] = stage(c, bits)                               # lanes g >= MT read 0
    usum = np.zeros((8, U), I64)
    usum[:MT] = xq.reshape(MT, U, uk).sum(-1)
    out = np.zeros((MT, nt * T), F32)
    for rank in range(c["KSPLIT"]):
        red = []
        for kw in range(c["KWARPS"]):
            sl = rank * c["KWARPS"] + kw
            u0 = U * sl // c["SLICES"]
            nb = U * (sl + 1) // c["SLICES"] - u0
            acc = np.zeros((2, nt, 2, GR, 16, 8), F32)
            ipart = np.zeros((2, nt, 2, GR, 16, 8), I64)
            xsum = np.zeros(8, I64)
            for b in range(nb):
                u = u0 + b
                grp = u // GU
                w = lane_words[ur * u:ur * u + ur].reshape(4, 4, nt, 2, GR, 8)    # [t, r, ...]
                w = np.moveaxis(w, (0, 1), (-2, -1)).reshape(nt, 2, GR, 32, 4)  # lane 4 g + t
                lo, hi = nibbles(c, transpose(c, w))
                breg = b_regs(staged[:, uk * u:uk * u + uk])
                xsum += usum[:, u]
                for p in range(2):
                    ipart[p] += mma_u8s8(a_regs(lo, hi, p), breg)
                if u + 1 == (grp + 1) * GU or b + 1 == nb:
                    s4 = sp[grp].reshape(nt, 2, GR, 8, 4)
                    for p in range(2):   # scale of D row i: column 4 (i % 8) + 2 p + i // 8
                        sc = np.concatenate([s4[..., 2 * p], s4[..., 2 * p + 1]], -1)[..., None]
                        f = magic(c, ipart[p] - 8 * xsum)
                        acc[p] = (f.astype(np.float64) * sc + acc[p]).astype(F32)
                        ipart[p] = 0
                    xsum[:] = 0
            w = np.zeros((MT, nt, 2, GR, 8, 4), F32)
            for p in range(2):
                w[..., 2 * p] = np.moveaxis(acc[p][..., :8, :MT], -1, 0)
                w[..., 2 * p + 1] = np.moveaxis(acc[p][..., 8:, :MT], -1, 0)
            red.append(w.reshape(MT, nt * T))
        tot = np.zeros((MT, nt * T), F32)
        for w in red:                            # warp order
            tot = (tot + w).astype(F32)
        out = (out + tot).astype(F32)            # rank order
    res = np.zeros((bp, F), F32)
    res[:M] = (out[:M, :F] * xs[:M, None]).astype(F32)
    return res


def inputs(M: int, K: int, F: int, G: int, seed: int):
    """bf16 x (a zero row where M > 1, a row with .5 ties of x / xs),
    packed bytes over the whole range, fp32 scales, as one layer of a
    stacked (2, ...) buffer."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(F32)).bfloat16()
    if M > 1:
        x[M // 2] = 0
    if M > 2:   # absmax 127: xs = 1, so x / xs hits .5 exactly
        x[0] = torch.from_numpy(rs.randint(-254, 255, size=K) / 2.0).bfloat16()
        x[0, 0] = 127
    packed = torch.from_numpy(rs.randint(-128, 128, size=(2, K // 2, F)).astype(np.int8))
    scales = torch.from_numpy((rs.rand(2, K // G, F) * 2e-2).astype(F32))
    return x, packed, scales


def check_template(c: dict, M: int, K: int, F: int, G: int, bp: int, seed: int) -> None:
    """The emulation against the plain version on layer 1: the same exact
    integer sums, fp32 sums in another order; within 1e-5 of max|ref|. Rows
    >= M and a zero row of x are exactly 0."""
    x, packed, scales = inputs(M, K, F, G, seed)
    want = te.int4_exp_a8_plain(x, packed, scales, 1, G, bp).numpy()
    got = emulate(c, x.float().numpy(), packed[1].numpy(), scales[1].numpy(), G, bp)
    assert got.shape == want.shape == (bp, F)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not got[M:].any()
    if M > 1:
        assert not got[M // 2].any()


def test_constants_read_from_the_source():
    assert {"SEL_LO", "SEL_HI", "SEL_W0", "SEL_W1", "NIB_MASK", "HI_FLIP", "XQ_PAIR",
            "MAGIC_I", "MAGIC_F", "MAX_GROUP_A8", "MODE_A8", "KSPLIT", "KWARPS", "UNIT_ROWS",
            "UNIT_K", "SLICES", "TILE", "WCOLS", "GROUPS"} <= set(C)
    assert np.array([C["MAGIC_I"]], U32).view(F32)[0] == C["MAGIC_F"] == 1.5 * 2 ** 23
    assert "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32" in SOURCE


@pytest.mark.parametrize("pos", range(4))
def test_transpose_and_masks_give_every_byte_its_nibbles(pos):
    check_every_byte(C, pos)


def test_fragment_layouts_cover_each_byte_once():
    """Labels through the real transpose and staging: A slot k of D row i
    holds a nibble of column 4 (i % 8) + 2 p + i // 8 at the logical k (2 *
    byte row + nibble) that B slot k holds of x, and the two mmas of a
    column group take every (byte row, column, nibble) once."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    label = words(np.arange(16).reshape(4, 4))              # word r, byte j: 4 r + j
    tw = transpose(C, label)                                 # word j, byte r: must be 4 r + j
    for j in range(4):
        for r in range(4):
            assert byte(tw[j], r) == 4 * r + j
    staged = stage(C, np.tile(np.arange(32, dtype=I64), (8, 1)) + C["MAGIC_I"])  # value = k
    breg = b_regs(staged)
    seen = np.zeros((16, 32, 2), int)                        # [byte row, column, nibble]
    for p in range(2):
        for reg, (row0, k0) in enumerate([(0, 0), (8, 0), (0, 16), (8, 16)]):
            col = 4 * g + 2 * p + row0 // 8                  # A row g + row0 of pair p
            nib = k0 // 16                                   # a0, a1 the low nibbles
            for i in range(4):
                brow = 4 * t + byte(tw[2 * p + row0 // 8], i) // 4   # byte i of the column word
                k_a = 2 * brow + nib
                k_b = byte(breg[g * 4 + t, k0 // 16], i, signed=True)  # B slot k0 + 4 t + i
                np.testing.assert_array_equal(k_a, k_b)
                np.add.at(seen, (brow, col, np.full(32, nib)), 1)
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("seed", range(3))
def test_fragments_pair_each_nibble_with_its_xq(seed):
    check_fragments(C, seed)


def _ties_row():
    """A row with absmax 127 (xs = 1): x / xs lands on .5 ties of both signs."""
    r = np.resize(np.array([127, 0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 3.5], F32), 64)
    return torch.from_numpy(r).bfloat16().float().numpy()


@pytest.mark.parametrize("case", ["ties", "zero-row", "random", "tiny-and-huge"])
def test_in_kernel_xq_is_the_plain_versions(case):
    rs = np.random.RandomState(3)
    x = {"ties": lambda: np.stack([_ties_row(), -_ties_row()]),
         "zero-row": lambda: np.stack([np.zeros(64, F32), rs.randn(64).astype(F32)]),
         "random": lambda: rs.randn(8, 4096).astype(F32),
         "tiny-and-huge": lambda: np.stack([rs.randn(64).astype(F32) * 1e-30,
                                            rs.randn(64).astype(F32) * 3e30])}[case]()
    x = torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float().numpy()
    if case == "ties":   # the ties are real: rounding them away from zero would differ
        assert (np.abs(x[0, 1:]) % 1 == 0.5).sum() > 8
    check_quantization(C, x)


def test_magic_conversion_is_exact_over_the_group_sums():
    check_magic(C)


@pytest.mark.parametrize("bp", [8, 32])
@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("M", [1, 4, 7, 8])
def test_emulated_template_matches_plain(M, G, bp):
    """K = 1536 (48 units: slices of one and two units, groups of 4 units
    spanning warps at G = 128), F = 196 (the second tile's last 60 columns
    past F); every MT the template has."""
    check_template(C, M, 1536, 196, G, bp, seed=M + G + bp)


@pytest.mark.parametrize("bp", [8, 32])
def test_emulated_template_at_the_experiment_k(bp):
    """K = 4096, G = 128, M = 4 (the experiment's call): one group a warp."""
    check_template(C, 4, 4096, 128, 128, bp, seed=11)


@pytest.mark.parametrize("old,new", [
    ("SEL_LO = 0x5140u", "SEL_LO = 0x5410u"),
    ("SEL_W1 = 0x7632u", "SEL_W1 = 0x3276u"),
    ("HI_FLIP = 0x08080808u", "HI_FLIP = 0x08080800u"),
    ("NIB_MASK = 0x0F0F0F0Fu", "NIB_MASK = 0x0F0F0F07u"),
    ("XQ_PAIR = 0x0040u", "XQ_PAIR = 0x0004u"),
    ("MAGIC_I = 0x4B400000u", "MAGIC_I = 0x4B000000u"),
    ("MAGIC_F = 12582912.0", "MAGIC_F = 8388608.0"),
    ("MAX_GROUP_A8 = 4096", "MAX_GROUP_A8 = 8192"),
    ("UNIT_ROWS = 16", "UNIT_ROWS = 8"),
], ids=["sel-lo", "sel-w1", "hi-flip", "mask", "xq-pair", "magic-bits", "magic-float",
        "group-limit", "unit8"])
def test_source_mutation_fails_the_checks(old, new):
    """Each change to the source text, applied to a copy, breaks at least
    one of the checks above."""
    assert SOURCE.count(old) == 1
    c = constants(SOURCE.replace(old, new, 1))
    assert c != C
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(4, 256).astype(F32)).bfloat16().float().numpy()
    with pytest.raises(AssertionError):
        for pos in range(4):
            check_every_byte(c, pos)
        check_fragments(c, 0)
        check_quantization(c, x)
        check_magic(c)
        check_template(c, 4, 1024, 196, 128, 8, seed=4)


# ---------------------------------------------------------------------------
# The shared-memory layout, evaluated from the source's own functions
# ---------------------------------------------------------------------------

_BINARY = {"||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6, "<": 7, ">": 7,
           "<=": 7, ">=": 7, "+": 8, "-": 8, "*": 9, "/": 9, "%": 9}


def _c_int(op: str, a: int, b: int) -> int:
    if op in ("/", "%"):   # C truncates toward zero
        q = abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)
        return q if op == "/" else a - b * q
    return {"||": lambda: int(bool(a or b)), "&&": lambda: int(bool(a and b)),
            "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
            "==": lambda: int(a == b), "!=": lambda: int(a != b), "<": lambda: int(a < b),
            ">": lambda: int(a > b), "<=": lambda: int(a <= b), ">=": lambda: int(a >= b),
            "+": lambda: a + b, "-": lambda: a - b, "*": lambda: a * b}[op]()


def c_eval(expr: str, env: dict) -> int:
    """An int C expression (names, calls, unary and binary operators, ?:)
    with C's precedence, its names and functions taken from env."""
    toks = re.findall(r"\d+|\w+|==|!=|<=|>=|&&|\|\||[-+*/%&|^~!?:(),<>]", expr)
    assert "".join(toks) == re.sub(r"\s+", "", expr), expr
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take(want=None):
        t = toks[pos[0]]
        assert want is None or t == want, (expr, t, want)
        pos[0] += 1
        return t

    def primary():
        t = take()
        if t == "(":
            v = ternary()
            take(")")
            return v
        if t in ("~", "-", "!"):
            v = primary()
            return {"~": ~v, "-": -v, "!": int(not v)}[t]
        if t.isdigit():
            return int(t)
        if peek() == "(":
            take("(")
            args = []
            while peek() != ")":
                args.append(ternary())
                if peek() == ",":
                    take(",")
            take(")")
            return env[t](*args)
        return env[t]

    def binary(least):
        left = primary()
        while peek() in _BINARY and _BINARY[peek()] >= least:
            op = take()
            left = _c_int(op, left, binary(_BINARY[op] + 1))
        return left

    def ternary():
        cond = binary(1)
        if peek() != "?":
            return cond
        take("?")
        a = ternary()
        take(":")
        b = ternary()
        return a if cond else b

    v = ternary()
    assert peek() is None, expr
    return v


def layout(text: str) -> dict:
    """The decode template's ``constexpr int`` functions of the namespace
    (the K slice, the x stride, the offsets of the dynamic shared memory),
    as Python functions over the source's constants."""
    body = text[text.index("namespace dec {"):text.index("}  // namespace dec")]
    env = dict(constants(text))
    for name, params, expr in re.findall(
            r"constexpr int (\w+)\(([^)]*)\)\s*\{\s*(?://[^\n]*\n)?\s*return ([^;]+);\s*\}",
            body):
        names = [p.split()[-1] for p in params.split(",")]
        env[name] = functools.partial(
            lambda expr, names, *args: c_eval(expr, {**env, **dict(zip(names, args))}),
            expr, names)
    return env


def check_layout(f: dict, K: int) -> None:
    """Every mode and MT at K: each region 16-byte aligned (the warps' sums
    take float2 stores, x and the receive buffers 16-byte ones), each large
    enough for what the kernel puts there, none overlapping the next."""
    units = f["slice_units"](K)
    assert f["k_stride"](K) == units * C["UNIT_K"] and f["k_stride"](K) <= f["x_stride"](K)
    for mode in (C["MODE_D"], C["MODE_C"], C["MODE_A8"]):
        for MT in (1, 2, 4, 8):
            aux, sums = f["aux_offset"](MT, K), f["sums_offset"](MT, mode, K)
            recv, end = f["recv_offset"](MT, mode, K), f["smem_bytes"](MT, mode, K)
            for off in (aux, sums, recv, end):
                assert off % 16 == 0, (K, mode, MT, aux, sums, recv)
            assert aux >= MT * f["x_stride"](K) * 2
            # D: a bf16-rounded fp32 group sum a unit and row; W4A8: the int8
            # slice, then the unit sums of xq (16-byte aligned too)
            need = MT * units * 4 + (MT * f["x_stride"](K) if mode == C["MODE_A8"] else 0)
            assert sums - aux >= need and (aux + MT * f["x_stride"](K)) % 16 == 0
            assert recv - sums == C["KWARPS"] * MT * C["TILE"] * 4
            assert end - recv == 2 * C["KSPLIT"] * MT * C["CPR"] * 4


LAYOUT_K = [C["UNIT_K"] * n for n in range(1, 400)] + [2816, 11008, 4096, 32768]


def test_layout_is_aligned_at_every_k():
    """K = 32 .. 12768 (odd and even counts of units a slice), the FFN's
    11008 and 2816, the experiment's 4096: at every mode and MT."""
    f = layout(SOURCE)
    assert {f["slice_units"](k) % 2 for k in LAYOUT_K} == {0, 1}
    for K in LAYOUT_K:
        check_layout(f, K)


@pytest.mark.parametrize("old,new", [
    ("MT * ((slice_units(K) + 3) & ~3) * 4", "slice_units(K) * MT * 4"),
    ("(mode == MODE_A8 ? MT * x_stride(K) : 0)", "(mode == MODE_D ? MT * x_stride(K) : 0)"),
    ("return k_stride(K) | 32;", "return k_stride(K) | 8;"),
], ids=["unpadded-units", "a8-slice-lost", "x-stride"])
def test_layout_mutation_fails_the_check(old, new):
    """The unpadded unit region (the W4A8 layout's first version: misaligned
    float2 stores at an odd count of units a slice and MT = 1), a lost int8
    slice, an x stride off 16 bytes: each fails the check."""
    assert SOURCE.count(old) == 1
    f = layout(SOURCE.replace(old, new, 1))
    with pytest.raises(AssertionError):
        for K in LAYOUT_K:
            check_layout(f, K)


def test_template_gate_takes_the_experiments_calls():
    """The C gate's conditions, read as the template takes them: G up to
    MAX_GROUP_A8, bp 8 or 32, and the experiment's shapes within the
    shared-memory limit at every MT (the source's own layout: the bf16
    slice, the int8 slice, the unit sums, the warps' sums, the receive
    buffers)."""
    gate = SOURCE[SOURCE.index('extern "C" int int4_exp_a8_template'):]
    gate = gate[:gate.index("}")]
    for cond in ("decode_operands(", "G <= dec::MAX_GROUP_A8", "(bp == 8 || bp == 32)",
                 "dec::smem_bytes(8, dec::MODE_A8, K) <= dec::SMEM_MAX"):
        assert cond in gate
    f = layout(SOURCE)
    for K in (2048, 2816, 4096, 11008):
        for MT in (1, 2, 4, 8):
            assert f["smem_bytes"](MT, C["MODE_A8"], K) <= C["SMEM_MAX"]
    assert 128 <= C["MAX_GROUP_A8"] and 4096 % 128 == 0
    # phase 8's second shapes: an odd count of units a slice, in the gate
    for K in chip_smoke.EXP_ODD_K:
        assert f["slice_units"](K) % 2 == 1 and K % chip_smoke.EXP_G == 0
        assert f["smem_bytes"](8, C["MODE_A8"], K) <= C["SMEM_MAX"]


def test_wrapper_checks_on_the_cpu():
    """What ``int4_exp_a8_template`` refuses before it builds anything,
    with the W4A8 wrappers' own checks."""
    x, packed, scales = inputs(4, 256, 64, 128, seed=0)
    bad = [(dict(bp=16), ValueError),
           (dict(x=torch.zeros((9, 256), dtype=torch.bfloat16)), ValueError),
           (dict(x=x.float()), TypeError),
           (dict(scales=scales[..., :60].contiguous()), ValueError),
           (dict(li=2), ValueError),
           (dict(group=64), ValueError)]
    for kw, exc in bad:
        args = dict(x=x, packed=packed, scales=scales, li=0, group=128, bp=8)
        args.update(kw)
        with pytest.raises(exc):
            te.int4_exp_a8_template(**args)
    with pytest.raises(ValueError, match="bp"):
        te.int4_exp_a8(x, packed, scales, 0, bp=16)


def test_chip_smoke_takes_the_mode_on_its_checks():
    """Phase 2 asks IMMA of the W4A8 instantiations and HMMA of D's and C's;
    phase 8 gives every W4A8 case its template gate and its chunked
    template alone, with the chunked unpack flags of its row."""
    name = "_ZN44_GLOBAL__N__1_11_int4_exp_cu_3dec22int4_exp_decode_kernelILi{}ELi{}EEEvNS_4ArgsE"
    for mt in (1, 2, 4, 8):
        assert chip_smoke.mma_op(name.format(mt, 2)) == "IMMA"
        assert chip_smoke.mma_op(name.format(mt, 0)) == chip_smoke.mma_op(name.format(mt, 1)) \
            == "HMMA"
    assert chip_smoke.mma_op("_ZN3dec18int8_decode_kernelILi4EEEvNS_4ArgsE") == "HMMA"
    assert "IMMA" in chip_smoke.SASS_OPS
    modes = chip_smoke.exp_int4_modes()
    w4a8 = [m for m in modes if m[0] in ("int4_exp_e", "int4_exp_a8")]
    assert len(w4a8) == 6 and len(modes) == 9
    for name_, tag, kernel, plain, bp, template_of, chunked in w4a8:
        assert template_of.func is te.int4_exp_a8_template if isinstance(
            template_of, functools.partial) else template_of is te.int4_exp_a8_template
        assert chunked.func is chip_smoke.int4_exp_a8_chunked and chunked.keywords["bp"] == bp
        assert chunked.keywords["low_only"] == int("body=f" in tag)
        assert chunked.keywords["i8mask"] == int(name_ == "int4_exp_e" or "i8mask=True" in tag)


@pytest.mark.parametrize("name", ["kept", "sm3", "nbuf3", "kept+trace", "sm3+trace",
                                  "nbuf3+trace"])
def test_variant_sources_apply(name, tmp_path, monkeypatch):
    """``tools/int4_exp_variants`` builds each variant by editing the
    source's text: every edit still finds its anchor, each variant's
    constants are the ones it names (the kept one's are the source's), and
    a traced variant stamps each of its phases once, in the W4A8 mode."""
    from libra_tpu_torch.tools import int4_exp_variants as IV
    monkeypatch.setattr(IV, "OUT", tmp_path)
    path = IV.source(name)
    text = path.read_text()
    assert (path.parent / "split_k.cuh").exists()
    c = constants(text)
    base = name.split("+")[0]
    want = {"kept": (C["BLOCKS_PER_SM"], C["NBUF"]), "sm3": (3, C["NBUF"]),
            "nbuf3": (C["BLOCKS_PER_SM"], 3)}[base]
    assert (c["BLOCKS_PER_SM"], c["NBUF"]) == want
    stamps = sorted(re.findall(r"TS\((\d)\);", text))
    assert stamps == ([str(i) for i in range(IV.STAMPS)] if "trace" in name else [])
    assert ("if (A8 && threadIdx.x == 0)" in text) == ("trace" in name)
    with pytest.raises(ValueError):
        IV.source("kept+unknown")
