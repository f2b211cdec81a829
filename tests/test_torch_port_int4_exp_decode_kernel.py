"""A CPU rehearsal of the decode template of the int4 experiment's
weight-only kernels C and D (``libra_tpu_torch/csrc/int4_exp.cu``,
namespace ``dec``), in numpy and torch only.

No CUDA kernel runs here, so the template's steps are emulated with the
constants read from the CUDA source itself (the sign flip, the nibble
mask, the ``prmt`` selectors, the bf16 128 and the two offsets, the unit
and the split of K):

* one XOR, one mask and one shift-and-mask a word, one ``prmt``, one OR
  and one bf16x2 add a byte turn every byte, in every position of a word,
  into its exact pair {u0, q1} (D) or {q0, q1} (C), bit for bit;
* D's one bf16x2 multiply by {bf16(s), bf16(s)} rounds u0 * bf16(s) and
  q1 * bf16(s) once, as the plain version rounds them, ties included;
* the (cluster rank, warp, lane) -> (byte row, column) mapping covers each
  byte of a tile once, and the group index taken by a multiply-high is
  the division;
* the whole template (each warp's m16n8k16 tiles over its units, the mma
  operands taken from the lanes' own registers by the PTX fragment
  layouts; C's group scales on each group's sums, D's bias correction in
  the warp of a group's first unit; the warp-order then rank-order sums)
  equals ``int4_exp_c_plain`` and ``int4_exp_d_plain`` to fp32 round-off;
* a change to a constant in the source text fails these checks.

The kernel itself is held against the plain versions on the card by
``chip_smoke.py`` phase 8.
"""

import math
import re

import numpy as np
import pytest
import torch

from libra_tpu_torch.ops import int4_exp as te

SOURCE = te.SOURCE.read_text()
U32 = np.uint32


def constants(text: str) -> dict:
    """The ``constexpr`` scalars of the decode template's namespace."""
    body = text[text.index("namespace dec {"):text.index("}  // namespace dec")]
    out = {}
    for kind, name, value in re.findall(r"constexpr\s+(int|uint32_t|float)\s+(\w+)\s*=\s*"
                                        r"([-+*/ \w.()]+);", body):
        v = value.strip()
        if re.fullmatch(r"0x[0-9A-Fa-f]+u?", v):
            out[name] = int(v.rstrip("u"), 16)
        else:   # an expression of the names before it (not a macro's)
            try:
                out[name] = eval(v, {"__builtins__": {}}, dict(out))   # noqa: S307
            except NameError:
                continue
            if kind == "int":
                out[name] = int(out[name])
    return out


C = constants(SOURCE)


def prmt(a, b, s: int):
    """PTX ``prmt.b32`` in its default mode: byte n of the result is byte
    (s >> 4n) & 7 of the 8 bytes (a0..a3, b0..b3), or that byte's sign
    replicated where bit 3 of the selector's nibble is set."""
    a = np.asarray(a, U32)
    b = np.broadcast_to(np.asarray(b, U32), a.shape)
    src = [(v >> U32(8 * i)) & U32(255) for v in (a, b) for i in range(4)]
    out = np.zeros(a.shape, U32)
    for n in range(4):
        nib = (s >> (4 * n)) & 15
        byte = src[nib & 7]
        if nib & 8:
            byte = np.where(byte & U32(128), U32(255), U32(0))
        out |= byte << U32(8 * n)
    return out


def bf16_bits(f) -> np.ndarray:
    """fp32 values -> their bf16 (round to nearest even) as 16-bit codes."""
    u = np.asarray(f, np.float32).view(U32)
    return ((u + U32(0x7FFF) + ((u >> U32(16)) & U32(1))) >> U32(16)) & U32(0xFFFF)


def halves(w) -> tuple:
    """A word of two bf16 -> (low half, high half) as fp32."""
    w = np.asarray(w, U32)
    return (((w & U32(0xFFFF)) << U32(16)).view(np.float32),
            (w & U32(0xFFFF0000)).view(np.float32))


def pack(lo, hi) -> np.ndarray:
    return bf16_bits(lo) | (bf16_bits(hi) << U32(16))


def fma_bf16x2(a, b, c) -> np.ndarray:
    """``fma.rn.bf16x2``: per half a * b + c exactly, rounded once to bf16
    (every use here is exact in fp32 before the rounding)."""
    (al, ah), (bl, bh), (cl, ch) = halves(a), halves(b), halves(c)

    def one(x, y, z):
        r = x.astype(np.float64) * y.astype(np.float64) + z.astype(np.float64)
        assert np.array_equal(r.astype(np.float32).astype(np.float64), r)
        return r.astype(np.float32)
    return pack(one(al, bl, cl), one(ah, bh, ch))


def bf16x2_dup(s) -> np.ndarray:
    """``cvt.rn.bf16x2.f32 d, s, s``."""
    b = bf16_bits(s)
    return b | (b << U32(16))


def pairs(c: dict, w, off: str) -> np.ndarray:
    """(...,) uint32 words of 4 packed bytes -> (..., 4) bf16 pairs, byte c
    last: the kernel's XOR, masks, one selector a byte, the OR and the
    add of OFFSET_C or OFFSET_D."""
    u = np.asarray(w, U32) ^ U32(c["SIGN_FLIP"])
    lo = u & U32(c["NIB_MASK"])
    hi = (u >> U32(4)) & U32(c["NIB_MASK"])
    return np.stack([fma_bf16x2(prmt(lo, hi, c[f"SEL{i}"]) | U32(c["BF16_128"]),
                                c["BF16_ONE"], c[off]) for i in range(4)], -1)


def magic(G: int, c: dict) -> int:
    """The host's multiplier for the group of a unit (make_args)."""
    gu = max(G // c["UNIT_K"], 1)
    return ((1 << 32) + gu - 1) // gu


def group_of(u, m: int):
    return (np.asarray(u, np.uint64) * np.uint64(m)) >> np.uint64(32)


def check_every_byte(c: dict, pos: int) -> None:
    """Byte `pos` of a word runs over all 256 values, its neighbours random
    (a selector must not take them): D's pair is {u0, q1}, C's {q0, q1},
    exactly, for every byte of the word."""
    rs = np.random.RandomState(pos)
    b = np.arange(-128, 128, dtype=np.int32)
    w = rs.randint(0, 2 ** 32, size=256, dtype=np.uint64).astype(U32)
    w = (w & ~U32(255 << (8 * pos))) | ((b.astype(U32) & U32(255)) << U32(8 * pos))
    every = np.ascontiguousarray(w).view(np.int8).reshape(-1, 4).astype(np.int32)
    for off, bias in (("OFFSET_D", 0), ("OFFSET_C", 8)):
        lo, hi = halves(pairs(c, w, off))
        np.testing.assert_array_equal(lo, ((every & 15) - bias).astype(np.float32))
        np.testing.assert_array_equal(hi, (every >> 4).astype(np.float32))


def check_mapping(c: dict, K: int) -> None:
    """Every byte (byte row, column) of a tile is loaded by exactly one
    (rank, warp, lane, word, byte) in exactly one batch; a unit is one
    batch, 4 byte rows for each of the 4 threads of an mma group; the
    group a unit's scales come from is the division."""
    ur, T = c["UNIT_ROWS"], c["TILE"]
    assert ur == 16 and c["UNIT_K"] == 2 * ur, "a unit is a batch of 4 x 4 byte rows"
    assert c["WARPS"] == 2 * c["KWARPS"] and c["SLICES"] == c["KSPLIT"] * c["KWARPS"]
    assert c["TILE"] == 2 * c["WCOLS"] == 64 * c["GROUPS"]
    U = K // c["UNIT_K"]
    seen = np.zeros((K // 2, T), np.int32)
    t, r, g, cc = np.meshgrid(range(4), range(4), range(8), range(4), indexing="ij")
    for rank in range(c["KSPLIT"]):
        ub = U * rank // c["KSPLIT"]
        nub = U * (rank + 1) // c["KSPLIT"] - ub
        for kw in range(c["KWARPS"]):
            sl = rank * c["KWARPS"] + kw
            u0 = U * sl // c["SLICES"]
            nb = U * (sl + 1) // c["SLICES"] - u0
            assert ub <= u0 and u0 + nb <= ub + nub        # the warp's x is its block's
            for half in range(2):
                for j in range(c["GROUPS"]):
                    for b in range(nb):
                        rows = ur * (u0 + b) + 4 * t + r
                        cols = c["WCOLS"] * half + 32 * j + 4 * g + cc
                        np.add.at(seen, (rows.ravel(), cols.ravel()), 1)
    np.testing.assert_array_equal(seen, 1)
    for G in (32, 64, 96, 128, 2048):
        if K % G == 0:
            u = np.arange(U)
            np.testing.assert_array_equal(group_of(u, magic(G, c)), u // (G // c["UNIT_K"]))


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float64).astype(np.float32)


def cluster_group_sums(x: np.ndarray, G: int) -> np.ndarray:
    """D's bf16(cg[m, g]) in the kernel's order: lane l adds the even
    columns l, l + 32, ... of the group in fp32, then the xor tree."""
    R, K = x.shape
    xe = x[:, 0::2].reshape(R, K // G, G // 2)
    lanes = np.zeros((R, K // G, 32), np.float32)
    for i in range(G // 2):
        lanes[..., i % 32] = f32(lanes[..., i % 32] + xe[..., i])
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        lanes = f32(lanes + lanes[..., idx ^ o])
    return halves(bf16_bits(lanes[..., 0]) << U32(16))[1]


def emulate(c: dict, x: np.ndarray, packed: np.ndarray, scales: np.ndarray, G: int,
            kind: str) -> np.ndarray:
    """The decode template step by step for kind "c" or "d", every lane of
    every tile at once: the (8, F) fp32 result. The mma operands are
    assembled from the lanes' registers by the PTX fragment layouts of
    m16n8k16 bf16 (lane = 4 g + t; register a0 (g, 2 t .. 2 t + 1), a1
    (g + 8, 2 t ..), a2 (g, 2 t + 8 ..), a3 (g + 8, 2 t + 8 ..), each the
    low half first; b0 (2 t .., g), b1 (2 t + 8 .., g); c0 (g, 2 t), c1 (g,
    2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1)); the sums of an mma
    and its accumulator are modelled as rounded to fp32 once."""
    M, K = x.shape
    F = packed.shape[1]
    ur, uk, T = c["UNIT_ROWS"], c["UNIT_K"], c["TILE"]
    assert M <= 8 and G % uk == 0 and K % G == 0 and F % 4 == 0
    MT = next(m for m in (1, 2, 4, 8) if m >= M)
    nt = -(-F // T)
    U, GU, mg = K // uk, G // uk, magic(G, c)
    pp = np.zeros((K // 2, nt * T), np.int8)
    pp[:, :F] = packed
    sp = np.zeros((K // G, nt * T), np.float32)
    sp[:, :F] = scales
    shape = (K // 2, nt, 2, c["GROUPS"], 8)            # byte row, tile, half, j, g
    words = pp.view(U32).reshape(shape)
    q = pairs(c, words, "OFFSET_C" if kind == "c" else "OFFSET_D")     # (..., 4 columns)
    srow = sp[group_of(np.arange(K // 2) // ur, mg)].reshape(shape + (4,))
    if kind == "d":                                    # bf16(u0 sh), bf16(q1 sh): one rounding
        q = fma_bf16x2(q, bf16x2_dup(srow), c["BF16_NEG_ZERO"])
    xp = np.zeros((8, K), np.float32)
    xp[:MT] = np.pad(x, ((0, MT - M), (0, 0)))          # lanes g >= MT read 0
    xw = pack(xp[:, 0::2], xp[:, 1::2])                 # (8, K / 2): x's words
    cgs = cluster_group_sums(xp, G)                     # (8, K / G)
    out = np.zeros((MT, nt * T), np.float32)
    t = np.arange(4)
    for rank in range(c["KSPLIT"]):
        red = []
        for kw in range(c["KWARPS"]):
            sl = rank * c["KWARPS"] + kw
            u0 = U * sl // c["SLICES"]
            nb = U * (sl + 1) // c["SLICES"] - u0
            acc = np.zeros((2, nt, 2, c["GROUPS"], 16, 8), np.float32)   # [p]: C tiles
            part = np.zeros_like(acc)
            for b in range(nb):
                u = u0 + b
                grp = int(group_of(u, mg))
                qb = q[ur * u:ur * u + ur].reshape((4, 4) + q.shape[1:])   # [t, r, ...]
                xb = xw[:, ur * u:ur * u + ur].reshape(8, 4, 4)          # [g, t, r]
                for p in range(2):
                    for h in range(2):
                        a = np.zeros((nt, 2, c["GROUPS"], 16, 16), np.float32)
                        for reg, (r, cc, row0, k0) in enumerate(
                                [(2 * h, 2 * p, 0, 0), (2 * h, 2 * p + 1, 8, 0),
                                 (2 * h + 1, 2 * p, 0, 8), (2 * h + 1, 2 * p + 1, 8, 8)]):
                            lo, hi = halves(np.moveaxis(qb[:, r, ..., cc], 0, -1))  # (..., g, t)
                            a[..., row0:row0 + 8, k0 + 2 * t] = lo
                            a[..., row0:row0 + 8, k0 + 2 * t + 1] = hi
                        bm = np.zeros((16, 8), np.float32)
                        for reg, r in ((0, 2 * h), (8, 2 * h + 1)):
                            lo, hi = halves(xb[:, :, r].T)                      # (t, g)
                            bm[reg + 2 * t] = lo
                            bm[reg + 2 * t + 1] = hi
                        d = part if kind == "c" else acc
                        d[p] = f32(d[p].astype(np.float64) + a.astype(np.float64) @ bm)
                s4 = sp[grp].reshape(nt, 2, c["GROUPS"], 8, 4)
                for p in range(2):   # scale of C row i: column 4 (i % 8) + 2 p + i // 8
                    sc = np.concatenate([s4[..., 2 * p], s4[..., 2 * p + 1]], -1)[..., None]
                    if kind == "c" and (u + 1 == (grp + 1) * GU or b + 1 == nb):
                        acc[p] = f32(part[p].astype(np.float64) * sc + acc[p])
                        part[p] = 0
                    if kind == "d" and u == grp * GU:
                        sh = halves(bf16_bits(sc) << U32(16))[1]
                        corr = -8.0 * cgs[:, grp].astype(np.float64)          # (8 rows of x,)
                        acc[p] = f32(acc[p] + corr * sh.astype(np.float64))
            # C row i: column 32 j + 4 (i % 8) + 2 p + i // 8; C column n: x row n
            w = np.zeros((MT, nt, 2, c["GROUPS"], 8, 4), np.float32)
            for p in range(2):
                w[..., 2 * p] = np.moveaxis(acc[p][..., :8, :MT], -1, 0)
                w[..., 2 * p + 1] = np.moveaxis(acc[p][..., 8:, :MT], -1, 0)
            red.append(w.reshape(MT, nt * T))
        tot = np.zeros((MT, nt * T), np.float32)
        for w in red:                            # warp order
            tot = f32(tot + w)
        out = f32(out + tot)                     # rank order
    res = np.zeros((8, F), np.float32)
    res[:M] = out[:M, :F]
    return res


def inputs(M: int, K: int, F: int, G: int, seed: int):
    """bf16 x (a zero row where M > 1), packed bytes over the whole range,
    fp32 scales, as one layer of a stacked (2, ...) buffer."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).bfloat16()
    if M > 1:
        x[M // 2] = 0
    packed = torch.from_numpy(rs.randint(-128, 128, size=(2, K // 2, F)).astype(np.int8))
    scales = torch.from_numpy((rs.rand(2, K // G, F) * 2e-2).astype(np.float32))
    return x, packed, scales


def check_template(c: dict, kind: str, M: int, K: int, F: int, G: int, seed: int) -> None:
    """The emulation against the plain version on layer 1: the same exact
    products, fp32 sums in another order (C's +8 bias folded into its
    weights rather than taken off over the group sums); within 1e-5 of
    max|ref|. Rows >= M and a zero row of x are exactly 0."""
    x, packed, scales = inputs(M, K, F, G, seed)
    plain = te.int4_exp_c_plain if kind == "c" else te.int4_exp_d_plain
    want = plain(x, packed, scales, 1, G).numpy()
    got = emulate(c, x.float().numpy(), packed[1].numpy(), scales[1].numpy(), G, kind)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not got[M:].any()
    if M > 1:
        assert not got[M // 2].any()


def test_constants_read_from_the_source():
    assert {"SIGN_FLIP", "NIB_MASK", "SEL0", "SEL1", "SEL2", "SEL3", "BF16_128", "OFFSET_D",
            "OFFSET_C", "BF16_ONE", "BF16_NEG_ZERO", "KSPLIT", "WARPS", "KWARPS", "UNIT_ROWS",
            "UNIT_K", "SLICES", "TILE", "WCOLS", "CPR", "GROUPS"} <= set(C)
    assert C["CPR"] * C["KSPLIT"] == C["TILE"]
    assert C["OFFSET_D"] == (0xC308 << 16 | 0xC300) and C["OFFSET_C"] == 0xC308C308
    assert halves(C["BF16_128"])[0] == 128 and halves(C["OFFSET_D"])[1] == -136
    assert "a.gmagic = ((1ull << 32) + gu - 1) / gu;" in SOURCE


@pytest.mark.parametrize("pos", range(4))
def test_every_byte_converts_exact(pos):
    check_every_byte(C, pos)


def test_d_multiply_rounds_once_as_the_plain_version():
    """All 256 bytes against scales whose products land on bf16 ties (an
    odd multiple of 2^-7 times an odd nibble), scales that are themselves
    ties of their rounding to bf16, negative and random ones: the pair
    times {bf16(s), bf16(s)}, rounded once, is the plain version's
    bf16(u0 * bf16(s)) and bf16(q1 * bf16(s)) bit for bit."""
    rs = np.random.RandomState(0)
    ties = [(1 + k * 2.0 ** -7) * 2.0 ** e for k in (1, 3, 127) for e in (-9, -6, 0)]
    halfway = [1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, 0.0123 * (1 + 2.0 ** -8)]
    s = np.array(ties + halfway + [-0.0173, 0.0] + list(rs.rand(16) * 2e-2), np.float32)
    b = np.arange(-128, 128, dtype=np.int32)
    w = (b.astype(U32) & U32(255)) * U32(0x01010101)                 # the byte in every position
    q = pairs(C, w, "OFFSET_D")                                       # (256, 4)
    got = fma_bf16x2(q[:, None, :], bf16x2_dup(s)[None, :, None], C["BF16_NEG_ZERO"])
    s_hat = torch.from_numpy(s).bfloat16().float()
    u0 = torch.from_numpy((b & 15).astype(np.float32))
    q1 = torch.from_numpy((b >> 4).astype(np.float32))
    lo, hi = halves(got)
    for c in range(4):
        np.testing.assert_array_equal(
            lo[..., c], (u0[:, None] * s_hat[None]).bfloat16().float().numpy())
        np.testing.assert_array_equal(
            hi[..., c], (q1[:, None] * s_hat[None]).bfloat16().float().numpy())
    # the set holds real ties: rounding them up instead would differ
    exact = u0[:, None].double() * s_hat[None].double()
    assert ((exact.float() != exact.float().bfloat16().float())
            & ((exact.float().view(torch.int32) & 0xFFFF) == 0x8000)).any()


@pytest.mark.parametrize("K", [32, 1024, 1536, 4096, 11008 - 11008 % 128])
def test_lane_mapping_covers_every_byte_once(K):
    """Tiny K (most warps empty), K = 1536 (48 units: slices of 1 or 2),
    the experiment's K = 4096 and a K of 342 units."""
    check_mapping(C, K)


@pytest.mark.parametrize("G", [32, 128])
@pytest.mark.parametrize("M", [1, 4, 7, 8])
@pytest.mark.parametrize("kind", ["c", "d"])
def test_emulated_template_matches_plain(kind, M, G):
    """K = 1536 (48 units: slices of one and two units, groups of 4 units
    spanning warps at G = 128), F = 196 (the second tile's last 60 columns
    past F); every MT the template has."""
    check_template(C, kind, M, 1536, 196, G, seed=M + G)


@pytest.mark.parametrize("kind", ["c", "d"])
def test_emulated_template_at_the_experiment_k(kind):
    """K = 4096, G = 128, M = 4 (the experiment's call): one group a warp."""
    check_template(C, kind, 4, 4096, 128, 128, seed=11)


@pytest.mark.parametrize("old,new", [
    ("SEL0 = 0xC480u", "SEL0 = 0x4480u"),
    ("SEL1 = 0xD591u", "SEL1 = 0xD519u"),
    ("SEL3 = 0xF7B3u", "SEL3 = 0xF7B2u"),
    ("OFFSET_D = 0xC308C300u", "OFFSET_D = 0xC300C300u"),
    ("OFFSET_C = 0xC308C308u", "OFFSET_C = 0xC308C300u"),
    ("NIB_MASK = 0x0F0F0F0Fu", "NIB_MASK = 0x0F0F0F07u"),
    ("SIGN_FLIP = 0x80808080u", "SIGN_FLIP = 0x00808080u"),
    ("BF16_128 = 0x43004300u", "BF16_128 = 0x43804380u"),
    ("UNIT_ROWS = 16", "UNIT_ROWS = 8"),
], ids=["sel0-zero", "sel1", "sel3", "offset-d", "offset-c", "mask", "flip", "magic",
        "unit8"])
def test_source_mutation_fails_the_checks(old, new):
    """Each change to the source text, applied to a copy, breaks at least
    one of the checks above."""
    assert old in SOURCE
    c = constants(SOURCE.replace(old, new, 1))
    assert c != C
    with pytest.raises(AssertionError):
        for pos in range(4):
            check_every_byte(c, pos)
        check_mapping(c, 1536)
        for kind in ("c", "d"):
            check_template(c, kind, 4, 1024, 196, 128, seed=4)


def test_template_gate_names_the_decode_template_for_the_experiment():
    """The C function's conditions, read as the template takes them: the
    experiment's shape fits its shared memory at every MT."""
    for MT in (1, 2, 4, 8):
        ks = C["UNIT_K"] * math.ceil(4096 // C["UNIT_K"] / C["KSPLIT"])
        xs = ks | 32
        smem = (MT * xs * 2 + MT * ((ks // C["UNIT_K"] + 3) & ~3) * 4
                + C["KWARPS"] * MT * C["TILE"] * 4 + 2 * C["KSPLIT"] * MT * C["CPR"] * 4)
        assert smem <= C["SMEM_MAX"]
    assert "G % dec::UNIT_K == 0" in SOURCE
