"""The port of the int4 decode-matvec experiment (``tools/exp_int4.py``)
against the JAX script on the CPU: its weight-only kernels D, D16 and C,
its W4A8 kernels E, H8, F8, F32R and FM8, its inputs and its rows.

The JAX kernels are closures inside ``tools.exp_int4.main``, sized by the
script's module constants at call time. The fixture shrinks the script to
K, O, L = 256, 512, 2 in interpret mode, replaces its run_case with one
that keeps each variant's fn and inputs, runs main() on the variants, and
calls each fn on layers 0 and 1 (and on an x with an all-zero row) before
the constants come back.
"""

import inspect
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools import exp_int4 as jexp  # noqa: E402

from libra_tpu_torch.ops import int4_exp as E  # noqa: E402
from libra_tpu_torch.tools import exp_int4 as texp  # noqa: E402

K, O, L = 256, 512, 2
VARIANTS = {"d": "D signed-byte shift+mask i32", "c": "C unrolled groupdot",
            "d16": "D16 signed-byte shift+mask i16", "e": "E w4a8 s8xs8 MXU dots",
            **{row: spec[0] for row, spec in texp.A8_ROWS.items()}}
BUILD = {"d": texp.build_d, "c": texp.build_c,
         "d16": lambda inp: texp.build_d(inp, torch.int16), "e": texp.build_e,
         "h8": texp.build_h, "f8": texp.build_f,
         "f32r": lambda inp: texp.build_f(inp, 32),
         "fm8": lambda inp: texp.build_f(inp, i8mask=True)}
W4A8 = ("e", *texp.A8_ROWS)
# fp32 sums of the same products in another order (measured at this size:
# 3.8e-7 of max|ref| for D, 1.9e-7 for C, 2.9e-7 for the W4A8 rows, whose
# group sums are exact integers)
TOL = 1e-5


def rows_of(variant):
    """The rows of a variant's result: x padded to 8, or to 32 for F32R."""
    return 32 if variant == "f32r" else E.BP


def zero_row_x():
    """Three rows of x, the middle one all zero."""
    x = np.random.RandomState(7).randn(3, K).astype(np.float32)
    x[1] = 0
    return x


@pytest.fixture(scope="module")
def jax_run():
    """{variant: (out at layer 0, out at layer 1, out on zero_row_x() at
    layer 1)} of the JAX kernels, with the x, yref and yscale that main()
    handed run_case."""
    seen = {}

    def run_case(name, build, x, yref, yscale):
        seen[name] = (build(), x, yref, yscale)

    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(K=K, O=O, L=L, INTERPRET=True, INT4_BYTES=K * O // 2).items():
            mp.setattr(jexp, k, v)
        mp.setattr(jexp, "run_case", run_case)
        mp.setattr(jexp, "timed", lambda fn, x: 0.0)
        mp.setattr(sys, "argv", ["exp_int4", *VARIANTS])
        jexp.main()
        out = {}
        xz = jnp.asarray(zero_row_x(), jnp.bfloat16)
        for v, name in VARIANTS.items():
            fn, x, yref, yscale = seen[name]
            out[v] = tuple(np.asarray(fn(xx, jnp.int32(li)), np.float32)
                           for xx, li in ((x, 0), (x, 1), (xz, 1)))
    x, yref, yscale = seen[VARIANTS["d"]][1:]
    return out, np.asarray(x.astype(jnp.float32)), np.asarray(yref), float(yscale)


@pytest.fixture(scope="module")
def inputs():
    return texp.make_inputs(K, O, L, device="cpu")


def test_inputs_match_the_script(jax_run, inputs):
    """RandomState(0): L layers drawn one at a time give the script's
    randn(L, K, O), then the same x; the port's pack on them gives the
    script's layer-0 reference."""
    _, x, yref, yscale = jax_run
    np.testing.assert_array_equal(inputs.x.float().numpy(), x)
    np.testing.assert_allclose(inputs.yref.numpy(), yref, rtol=0, atol=1e-6 * yscale)
    assert inputs.yscale == pytest.approx(yscale, rel=1e-6)


@pytest.mark.parametrize("li", range(L))
@pytest.mark.parametrize("variant", VARIANTS)
def test_port_matches_jax_kernel(jax_run, inputs, variant, li):
    want = jax_run[0][variant][li]
    got = BUILD[variant](inputs)(inputs.x, li).numpy()
    assert got.shape == want.shape == (rows_of(variant), O)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    assert not got[4:].any() and not want[4:].any()


@pytest.mark.parametrize("li", range(L))
def test_d_without_its_bf16_rounding_misses(jax_run, inputs, li):
    """D's weights are bf16(u0 * s_hat), bf16(q1 * s_hat): the same sum
    with the products left in fp32 misses the tolerance (3.3e-3 of max|ref|
    measured), so the rounding contract is what the match above tests."""
    want = jax_run[0]["d"][li]
    xe, xo, cg, u0, q1 = E._prep(inputs.x, inputs.packed[li], texp.GROUP)
    s_hat = E._round_bf16(inputs.scales[li])
    s_rows = torch.repeat_interleave(s_hat, texp.GROUP // 2, dim=0)
    unrounded = xe @ (u0 * s_rows) + xo @ (q1 * s_rows) - 8.0 * (E._round_bf16(cg) @ s_hat)
    err = np.abs(unrounded.numpy() - want).max() / np.abs(want).max()
    assert err > 100 * TOL


@pytest.mark.parametrize("variant", VARIANTS)
def test_a_zero_row_gives_zero(jax_run, inputs, variant):
    """An all-zero row of x inside M (the W4A8 rows' xs = 1 branch) gives
    an exactly zero row, in the port and in the JAX kernel, and the rows
    around it match the JAX kernel's."""
    want = jax_run[0][variant][2]
    got = BUILD[variant](inputs)(torch.from_numpy(zero_row_x()).bfloat16(), 1).numpy()
    assert got.shape == want.shape == (rows_of(variant), O)
    assert not got[1].any() and not want[1].any() and not got[3:].any()
    assert np.abs(got[[0, 2]]).min(axis=1).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_w4a8_rows_compute_one_function(jax_run):
    """The JAX W4A8 rows differ only in their unpack: at this size their
    outputs are bitwise equal (F32R's first 8 rows), as the port's one plain
    version assumes."""
    for li in range(L):
        want = jax_run[0]["e"][li]
        for v in W4A8:
            np.testing.assert_array_equal(jax_run[0][v][li][:E.BP], want)


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rows_past_m_are_zero(inputs, variant, M):
    x = torch.from_numpy(np.random.RandomState(M).randn(M, K).astype(np.float32)).bfloat16()
    y = BUILD[variant](inputs)(x, 1)
    assert y.shape == (rows_of(variant), O) and y.dtype == torch.float32
    assert bool((y[M:] == 0).all()) and bool(y[:M].abs().amax(dim=1).gt(0).all())


@pytest.mark.parametrize("row", texp.ROWS)
def test_each_row_passes_its_numerics(row):
    """Every row at a small size (K = 2048 so that G = 2048 divides it)
    against x @ its own dequantized weights: the script's rel err < 0.05."""
    timings = []
    out = texp.main([row], device="cpu", K=2048, O=512, L=2,
                    timer=lambda fn, x, layers: timings.append(layers) or 1e-3)
    assert list(out) == [row] and timings == [2]
    assert out[row]["err"] < texp.REJECT and out[row]["ms"] == 1.0


def test_select():
    assert texp.select([]) == list(texp.ROWS) and len(texp.ROWS) == 21
    assert texp.select(["D16", "prod8", "c"]) == ["prod8", "c", "d16"]
    assert texp.select(["FM8", "e", "p256", "int8"]) == ["int8", "e", "fm8", "p256"]
    with pytest.raises(ValueError, match="unknown variants"):
        texp.select(["d", "nope"])


def test_run_case_raises_on_a_numerics_rejection(inputs):
    def build():
        return lambda xx, li: torch.zeros((E.BP, O))
    with pytest.raises(AssertionError, match="REJECTED"):
        texp.run_case("zero", build, inputs.x, inputs.yref, inputs.yscale, 1, L,
                      timer=lambda fn, x, layers: 1.0)


@pytest.mark.parametrize("wrapper,kw,plain,plain_kw", [
    (E.int4_exp_d, {}, E.int4_exp_d_plain, {}),
    (E.int4_exp_c, {}, E.int4_exp_c_plain, {}),
    (E.int4_exp_e, {}, E.int4_exp_a8_plain, {}),
    (E.int4_exp_a8, {}, E.int4_exp_a8_plain, {}),
    (E.int4_exp_a8, dict(i8mask=True), E.int4_exp_a8_plain, {}),
    (E.int4_exp_a8, dict(body="f"), E.int4_exp_a8_plain, {}),
    (E.int4_exp_a8, dict(body="f", bp=32), E.int4_exp_a8_plain, dict(bp=32)),
    (E.int4_exp_a8, dict(body="f", i8mask=True), E.int4_exp_a8_plain, {})],
    ids=["d", "c", "e", "h8", "h8-i8mask", "f8", "f32r", "fm8"])
def test_wrappers_take_the_plain_version_on_the_cpu(inputs, wrapper, kw, plain, plain_kw):
    launches = wrapper.launches
    got = wrapper(inputs.x, inputs.packed, inputs.scales, 1, **kw)
    torch.testing.assert_close(got, plain(inputs.x, inputs.packed, inputs.scales, 1,
                                          **plain_kw), rtol=0, atol=0)
    assert wrapper.launches == launches
    meta = [t.to("meta") for t in (inputs.x, inputs.packed, inputs.scales)]
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(*meta, 1, **kw)


def test_a8_options_are_checked(inputs):
    args = (inputs.x, inputs.packed, inputs.scales, 0)
    with pytest.raises(ValueError, match="body"):
        E.int4_exp_a8(*args, body="g")
    with pytest.raises(ValueError, match="bp"):
        E.int4_exp_a8(*args, bp=16)


def test_d16_is_d_and_wdt_is_checked(inputs):
    args = (inputs.x, inputs.packed, inputs.scales, 0)
    assert torch.equal(E.int4_exp_d(*args, wdt=torch.int16), E.int4_exp_d(*args))
    with pytest.raises(ValueError, match="wdt"):
        E.int4_exp_d(*args, wdt=torch.int8)


def test_kernel_checks(inputs):
    """What the CUDA path refuses before it launches."""
    x, p, s = inputs.x, inputs.packed, inputs.scales
    E._check("k", x, p, s, 1, 128)                              # accepted
    E._check("k", x, p, s, 1, 128, bp=32)                       # F32R's rows
    bad = [(torch.zeros((9, K), dtype=torch.bfloat16), p, s, 0, 128, ValueError),
           (x, p[0], s[0], 0, 128, ValueError),                # not stacked
           (x, p, s, 2, 128, ValueError),                      # no layer 2
           (x, p, s, 0, 64, ValueError),                       # scales of G = 128
           (x, p[..., :510], s[..., :510], 0, 128, ValueError),  # O % 4
           (x.float(), p, s, 0, 128, TypeError),
           (x, p, s.double(), 0, 128, TypeError),
           (x, p[..., ::2], s[..., ::2], 0, 128, ValueError),  # not contiguous
           (x, p.flatten()[1:1 + L * K // 2 * (O - 4)].view(L, K // 2, O - 4),
            s[..., :O - 4].contiguous(), 0, 128, ValueError)]    # misaligned
    for xx, pp, ss, li, g, exc in bad:
        with pytest.raises(exc):
            E._check("k", xx, pp, ss, li, g)
    for xx, bp in ((x, 16), (torch.zeros((9, K), dtype=torch.bfloat16), 32)):
        with pytest.raises(ValueError):                         # bp 8 or 32, M <= 8
            E._check("k", xx, p, s, 0, 128, bp=bp)


def test_entry_points_default_to_the_card():
    for fn in (texp.main, texp.make_inputs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
