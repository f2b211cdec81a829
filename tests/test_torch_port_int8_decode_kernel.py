"""A CPU rehearsal of the int8 matmul kernel's decode template
(``libra_tpu_torch/csrc/int8_matmul.cu``, namespace ``dec``), in numpy and
torch only.

No CUDA kernel runs here, so the template's steps are emulated with the
constants read from the CUDA source itself (the sign flip, the
``__byte_perm`` selectors, the magic float and its bias, the split of K,
the tile's column groups):

* one XOR a word, one selector a column and the magic bias turn every
  int8 value, in every byte of a word, into its exact fp32, bit for bit;
* the (cluster rank, warp) -> k-row slicing covers every k row once;
* the whole template (x staged per rank in 16-byte loads; each warp's
  tensor-core tiles over its batches of 16 k rows, the mma operands taken
  from the lanes' own registers by the PTX fragment layouts; the
  warp-order then rank-order sums; the column scale last) equals
  ``int8_matmul_plain`` to fp32 round-off;
* a change to the magic bias, a selector or the unit of the K split in
  the source text fails these checks.

The kernel itself is held against ``int8_matmul_plain`` on the card by
``chip_smoke.py`` phase 4.
"""

import re

import numpy as np
import pytest
import torch

from libra_tpu_torch.ops import int8_matmul as ti8

SOURCE = ti8.SOURCE.read_text()
U32 = np.uint32
LIBRA_K = (4096, 11008, 2816)   # the projections' K: hidden, MLP, vision bottleneck (padded)


def constants(text: str) -> dict:
    """The ``constexpr`` scalars of the decode template's namespace."""
    body = text[text.index("namespace dec {"):text.index("}  // namespace dec")]
    out = {}
    for kind, name, value in re.findall(r"constexpr\s+(int|uint32_t|float)\s+(\w+)\s*=\s*"
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


def exact_weights(c: dict, w) -> np.ndarray:
    """(...,) uint32 words -> (..., 4) fp32 weights, byte c first: the
    kernel's XOR, one selector a column, the magic bias."""
    u = np.asarray(w, U32) ^ U32(c["SIGN_FLIP"])
    cols = [byte_perm(u, c["MAGIC"], c[f"SEL{i}"]).view(np.float32)
            - np.float32(c["MAGIC_BIAS"]) for i in range(4)]
    return np.stack(cols, -1).astype(np.float32)


def warp_rows(c: dict, K: int, rank: int, warp: int):
    """The kernel's slicing: (first k row, k rows) of the warps of K slice
    `warp` (a pair: the two halves of the tile), and (first k row, k rows)
    of their block's x slice."""
    U = K // c["UNIT_K"]
    sl = rank * c["KWARPS"] + warp
    u0 = U * sl // c["SLICES"]
    ub = U * rank // c["KSPLIT"]
    uk = c["UNIT_K"]
    return (uk * u0, uk * (U * (sl + 1) // c["SLICES"] - u0),
            uk * ub, uk * (U * (rank + 1) // c["KSPLIT"] - ub))


def check_every_byte(c: dict, pos: int) -> None:
    """Byte `pos` of a word runs over all 256 values, its neighbours random
    (a selector must not take them): each weight comes out exactly."""
    rs = np.random.RandomState(pos)
    b = np.arange(-128, 128, dtype=np.int32)
    w = rs.randint(0, 2 ** 32, size=256, dtype=np.uint64).astype(U32)
    w = (w & ~U32(255 << (8 * pos))) | ((b.astype(U32) & U32(255)) << U32(8 * pos))
    got = exact_weights(c, w)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, pos], b.astype(np.float32))
    np.testing.assert_array_equal(got, np.ascontiguousarray(w).view(np.int8)
                                  .reshape(-1, 4).astype(np.float32))


def check_slicing(c: dict, K: int) -> None:
    """The template takes K (whole units); every k row lies in exactly one
    warp's run; each block's x slice is the union of its warps' runs, fits
    the x stride, and is loaded in whole 16-byte (8-k) loads; a unit is one
    load batch, 4 k rows for each of the 4 threads of an mma group."""
    uk = c["UNIT_K"]
    assert K % uk == 0, f"the decode template does not take K = {K}"
    assert uk == 4 * 4, "a batch is 4 k rows for each thread of an mma group"
    stride = uk * -(-(K // uk) // c["KSPLIT"])
    seen = np.zeros(K, np.int32)
    for r in range(c["KSPLIT"]):
        rows = []
        for w in range(c["KWARPS"]):
            k0, nk, kb, nkb = warp_rows(c, K, r, w)
            seen[k0:k0 + nk] += 1
            rows += range(k0, k0 + nk)
        assert nkb <= stride and nkb % 8 == 0
        assert rows == list(range(kb, kb + nkb))
    np.testing.assert_array_equal(seen, 1)


def mma_tf32(acc: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``mma.sync.m16n8k8`` tf32 on whole tiles (..., 16, 8) @ (8, 8): the
    operands here are exact in tf32, the 8 products of an element exact;
    their sum and the accumulator are modeled as rounded to fp32 once (the
    order inside one mma is the hardware's)."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)
            ).astype(np.float32)


def emulate(c: dict, x: np.ndarray, q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The decode template step by step, every lane's registers of every
    tile at once, in fp32: the result before its bf16 rounding. The mma
    operands are assembled from the lanes' registers by the PTX fragment
    layouts of m16n8k8 tf32 (lane = 4 g + t: a0 (g, t), a1 (g + 8, t), a2
    (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); c0 (g, 2 t),
    c1 (g, 2 t + 1), c2 (g + 8, 2 t), c3 (g + 8, 2 t + 1))."""
    M, K = x.shape
    F = q.shape[1]
    assert K % c["UNIT_K"] == 0 and F % 4 == 0 and M <= 8
    assert c["UNIT_K"] == 16, "a batch is 4 k rows for each thread of an mma group"
    MT = next(t for t in (1, 2, 4, 8) if t >= M)
    T, G = c["TILE"], c["TILE"] // 32    # column groups of the tile: both halves
    assert c["WCOLS"] == 32 * c["GROUPS"] and 2 * c["WCOLS"] == T
    nt = -(-F // T)
    qp = np.zeros((K, nt * T), np.int8)
    qp[:, :F] = q
    # wf[k, tile, j, g, cc]: the word of lane group g in column group j of
    # k row k, byte cc, as the kernel's exact float (0 past F: the loads
    # are predicated off)
    wf = exact_weights(c, qp.view(U32)).reshape(K, nt, G, 8, 4)
    xf = np.zeros((8, K), np.float32)         # x rows g >= MT read as 0
    xf[:M] = x
    nks = c["UNIT_K"] * -(-(K // c["UNIT_K"]) // c["KSPLIT"])
    tot = np.zeros((c["KSPLIT"], MT, nt * T), np.float32)
    for r in range(c["KSPLIT"]):
        _, _, kb, nkb = warp_rows(c, K, r, 0)
        xs = np.zeros((8, nks), np.float32)      # 16-byte loads of 8 k
        nv = nkb // 8
        xs[:MT, :8 * nv] = xf[:MT, kb:kb + 8 * nv]
        red = np.zeros((c["KWARPS"], MT, nt * T), np.float32)
        for w in range(c["KWARPS"]):   # a pair of warps: column groups 0, 1 and 2, 3
            k0, nk, _, _ = warp_rows(c, K, r, w)
            acc = np.zeros((nt, G, 2, 16, 8), np.float32)   # [tile, j, p]: C tiles
            for b in range(nk // 16):
                # lane (g, t): words of k rows 4 t + rr, x row g at the same k
                qb = wf[k0 + 16 * b:k0 + 16 * b + 16].reshape(4, 4, nt, G, 8, 4)
                xb = xs[:, k0 - kb + 16 * b:k0 - kb + 16 * b + 16].reshape(8, 4, 4)
                for j in range(G):
                    for p in range(2):
                        for h in range(2):
                            a = np.zeros((nt, 16, 8), np.float32)
                            for (r0, c0), (rows, cols) in {
                                    (2 * h, 2 * p): (slice(0, 8), slice(0, 4)),
                                    (2 * h, 2 * p + 1): (slice(8, 16), slice(0, 4)),
                                    (2 * h + 1, 2 * p): (slice(0, 8), slice(4, 8)),
                                    (2 * h + 1, 2 * p + 1): (slice(8, 16), slice(4, 8)),
                            }.items():   # a0, a1, a2, a3: (t, tile, g) -> (tile, g, t)
                                a[:, rows, cols] = qb[:, r0, :, j, :, c0].transpose(1, 2, 0)
                            bm = np.concatenate([xb[:, :, 2 * h].T, xb[:, :, 2 * h + 1].T])
                            acc[:, j, p] = mma_tf32(acc[:, j, p], a, bm)
            # C row g: column 32 j + 4 g + 2 p, row g + 8: the next; C column n: x row n
            out = red[w].reshape(MT, nt, G, 8, 2, 2)   # [n, tile, j, g, p, row half]
            for p in range(2):
                out[..., p, 0] = acc[:, :, p, :8, :MT].transpose(3, 0, 1, 2)
                out[..., p, 1] = acc[:, :, p, 8:, :MT].transpose(3, 0, 1, 2)
        t_sum = np.zeros((MT, nt * T), np.float32)
        for w in range(c["KWARPS"]):          # warp order
            t_sum = t_sum + red[w]
        tot[r] = t_sum
    out = np.zeros((MT, nt * T), np.float32)
    for r in range(c["KSPLIT"]):              # rank order
        out = out + tot[r]
    sc = np.zeros(nt * T, np.float32)
    sc[:F] = scale.reshape(-1)
    return (out * sc)[:M, :F]


def inputs(M: int, K: int, F: int, seed: int):
    """bf16-valued x (a zero row where M > 1), int8 q over the whole
    range, fp32 scales."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32)).bfloat16().float()
    if M > 1:
        x[M // 2] = 0
    q = torch.from_numpy(rs.randint(-128, 128, size=(K, F)).astype(np.int8))
    scale = torch.from_numpy((rs.rand(1, F) * 2e-3 + 1e-4).astype(np.float32))
    return x, q, scale


def check_template(c: dict, M: int, K: int, F: int, seed: int) -> None:
    """The emulation against int8_matmul_plain: the same exact products,
    summed in fp32 in another order, the scale on the sum rather than on
    each weight; within 1e-5 of max|ref|. A zero row of x stays 0."""
    x, q, scale = inputs(M, K, F, seed)
    want = ti8.int8_matmul_plain(x, q, scale).numpy()
    got = emulate(c, x.numpy(), q.numpy(), scale.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if M > 1:
        assert not got[M // 2].any()


def test_constants_read_from_the_source():
    assert {"SIGN_FLIP", "MAGIC", "SEL0", "SEL1", "SEL2", "SEL3", "MAGIC_BIAS",
            "KSPLIT", "WARPS", "KWARPS", "UNIT_K", "SLICES", "TILE", "WCOLS", "CPR",
            "GROUPS"} <= set(C)
    assert C["SLICES"] == C["KSPLIT"] * C["KWARPS"] and C["WARPS"] == 2 * C["KWARPS"]
    assert C["TILE"] == 2 * C["WCOLS"] == 64 * C["GROUPS"]
    assert C["CPR"] * C["KSPLIT"] == C["TILE"]
    assert C["MAGIC_BIAS"] == 2.0 ** 23 + 128


@pytest.mark.parametrize("pos", range(4))
def test_every_int8_value_exact(pos):
    check_every_byte(C, pos)


@pytest.mark.parametrize("K", LIBRA_K + (16, 48))
def test_slicing_covers_every_k_row_once(K):
    """libra-11b's K (11008 is 688 units, not a multiple of the 32
    slices), and tiny K where most warps get no rows."""
    check_slicing(C, K)


@pytest.mark.parametrize("M", range(1, 9))
def test_emulated_template_matches_plain(M):
    """K = 304 (19 units: many warps empty, some one unit), F = 196 (the
    second tile's last 60 columns past F), every MT the template has."""
    check_template(C, M, 304, 196, seed=M)


def test_emulated_template_at_a_libra_k():
    """K = 4096, M = 4 (the decode step), one tile of 128 columns."""
    check_template(C, 4, 4096, 128, seed=11)


@pytest.mark.parametrize("old,new", [
    ("MAGIC_BIAS = 8388736.f", "MAGIC_BIAS = 8388608.f"),
    ("SEL0 = 0x7440u", "SEL0 = 0x7448u"),
    ("SEL1 = 0x7441u", "SEL1 = 0x7442u"),
    ("SEL3 = 0x7443u", "SEL3 = 0x7043u"),
    ("SIGN_FLIP = 0x80808080u", "SIGN_FLIP = 0x80808000u"),
    ("MAGIC = 0x4B000000u", "MAGIC = 0x4A000000u"),
    ("UNIT_K = 16", "UNIT_K = 12"),
    ("UNIT_K = 16", "UNIT_K = 32"),
], ids=["bias", "sel0-sign", "sel1", "sel3", "flip", "magic", "unit12", "unit32"])
def test_source_mutation_fails_the_checks(old, new):
    """Each change to the source text, applied to a copy, breaks at least
    one of the checks above (a unit is one batch of the mma fragments'
    16 k rows, so it cannot be 12 or 32)."""
    assert old in SOURCE
    c = constants(SOURCE.replace(old, new, 1))
    assert c != C
    with pytest.raises(AssertionError):
        for pos in range(4):
            check_every_byte(c, pos)
        for K in LIBRA_K:
            check_slicing(c, K)
        check_template(c, 4, 304, 196, seed=4)
