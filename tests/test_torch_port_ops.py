"""The PyTorch port's ops against libra_tpu's, on the same numpy inputs.

fp32 on the CPU throughout; tolerance 1e-5 (fp32 sums taken in another
order by the two frameworks). The flash-bridge plain version is held
against the Pallas kernel run in interpret mode, as
tests/test_pallas_kernels.py runs it.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import config as jcfg
from libra_tpu.ops import attention as jattn, norm as jnorm, rope as jrope
from libra_tpu.ops import routed as jrouted
from libra_tpu.ops.pallas.flash_bridge import (
    flash_bridged_attention as jflash)
from libra_tpu_torch import config as tcfg
from libra_tpu_torch.ops import attention as tattn, norm as tnorm, rope as trope
from libra_tpu_torch.ops import routed as trouted
from libra_tpu_torch.ops import _build, flash_bridge as tflash
from libra_tpu_torch.params import from_numpy_tree

ATOL = 1e-5


def _rs(seed=0):
    return np.random.RandomState(seed)


def _close(got_t, want_j, atol=ATOL):
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_j),
                               rtol=0, atol=atol)


def test_rms_norm():
    rs = _rs()
    x = rs.randn(2, 5, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32)
    _close(tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_rope_tables_and_apply():
    tc, ts = trope.rope_cos_sin(40, 16, 10000.0)
    jc, js = jrope.rope_cos_sin(40, 16, 10000.0)
    _close(tc, jc)
    _close(ts, js)
    rs = _rs(1)
    x = rs.randn(2, 7, 3, 16).astype(np.float32)
    pos = rs.randint(0, 40, (2, 7))
    _close(trope.apply_rope(torch.from_numpy(x), tc, ts, torch.from_numpy(pos)),
           jrope.apply_rope(jnp.asarray(x), jc, js, jnp.asarray(pos)))


def _routed_inputs(seed=2):
    rs = _rs(seed)
    x = rs.randn(2, 6, 16).astype(np.float32)
    flag = rs.rand(2, 6) < 0.5
    w = rs.randn(16, 12).astype(np.float32) * 0.2
    wa = rs.randn(16, 4).astype(np.float32) * 0.2
    wb = rs.randn(4, 12).astype(np.float32) * 0.2
    wa2 = rs.randn(16, 4).astype(np.float32) * 0.2
    wb2 = rs.randn(4, 12).astype(np.float32) * 0.2
    return x, flag, w, wa, wb, wa2, wb2


def test_select_by_flag_and_low_rank():
    x, flag, w, wa, wb, _, _ = _routed_inputs()
    t = [torch.from_numpy(a) for a in (x, flag, w, wa, wb)]
    j = [jnp.asarray(a) for a in (x, flag, w, wa, wb)]
    _close(trouted.low_rank_linear(t[0], t[3], t[4]),
           jrouted.low_rank_linear(j[0], j[3], j[4]))
    _close(trouted.select_by_flag(t[1], t[0], -t[0]),
           jrouted.select_by_flag(j[1], j[0], -j[0]))


@pytest.mark.parametrize("addition_mode", [False, True])
def test_routed_linear(addition_mode):
    x, flag, w, wa, wb, _, _ = _routed_inputs()
    t = [torch.from_numpy(a) for a in (x, flag, w, wa, wb)]
    j = [jnp.asarray(a) for a in (x, flag, w, wa, wb)]
    _close(trouted.routed_linear(*t, addition_mode=addition_mode),
           jrouted.routed_linear(*j, addition_mode=addition_mode))


def test_routed_low_rank():
    x, flag, _, wa, wb, wa2, wb2 = _routed_inputs(3)
    args = (x, flag, wa, wb, wa2, wb2)
    _close(trouted.routed_low_rank(*[torch.from_numpy(a) for a in args]),
           jrouted.routed_low_rank(*[jnp.asarray(a) for a in args]))


def _attn_case(seed, B=2, nq=13, nk=20, H=2, d=8, use_bridge=True,
               cache_layout=True):
    """Ragged nq < nk. cache_layout: queries occupy key slots [0, nq) of a
    longer cache whose tail is unwritten (the prefill's layout), with row 1
    left-padded by 3 tokens, so its first 3 query rows are fully masked."""
    rs = _rs(seed)
    q = rs.randn(B, nq, H, d).astype(np.float32)
    k, v, kb, vb = (rs.randn(B, nk, H, d).astype(np.float32) for _ in range(4))
    flag_q = rs.rand(B, nq) < 0.5
    flag_kv = np.concatenate([flag_q, rs.rand(B, nk - nq) < 0.5], axis=1)
    mask = np.zeros((B, nk), np.int32)
    mask[:, :nq] = 1
    mask[1, :3] = 0
    if cache_layout:
        keep = (np.arange(nk)[None, :] <= np.arange(nq)[:, None])[None] \
            & mask.astype(bool)[:, None, :]
        bias = np.where(keep, 0.0, jattn.BIG_NEG).astype(np.float32)[:, None]
    else:
        bias = np.asarray(jattn.causal_bias(jnp.asarray(mask), nq, nk))
    if not use_bridge:
        kb = vb = None
    return q, k, v, kb, vb, flag_q, flag_kv, bias


def _to_t(args):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in args]


def _to_j(args):
    return [None if a is None else jnp.asarray(a) for a in args]


@pytest.mark.parametrize("use_bridge", [True, False])
@pytest.mark.parametrize("cache_layout", [True, False])
def test_bridged_attention(use_bridge, cache_layout):
    args = _attn_case(4, use_bridge=use_bridge, cache_layout=cache_layout)
    j = _to_j(args)
    want = jattn.bridged_attention(jattn.AttentionInputs(*j[:5]), *j[5:])
    _close(tattn.bridged_attention(*_to_t(args)), want)


@pytest.mark.parametrize("nq,nk", [(5, 5), (3, 9)])
def test_causal_bias(nq, nk):
    mask = np.ones((2, nk), np.int32)
    mask[0, :2] = 0
    _close(tattn.causal_bias(torch.from_numpy(mask), nq, nk),
           jattn.causal_bias(jnp.asarray(mask), nq, nk), atol=0)


@pytest.mark.parametrize("use_bridge", [True, False])
@pytest.mark.parametrize("nq,nk", [(13, 20), (16, 16)])
def test_flash_plain_matches_pallas_interpret(use_bridge, nq, nk):
    """Ragged Nq, Nk > Nq, left padding and fully masked query rows."""
    args = _attn_case(5, nq=nq, nk=nk, use_bridge=use_bridge,
                      cache_layout=nk > nq)
    want = jflash(*_to_j(args), block_q=nq, interpret=True)
    got = tflash.flash_bridged_attention_plain(*_to_t(args))
    _close(got, want)
    if nk > nq:   # the fully masked rows are the uniform average of V (+Vb)
        assert np.isfinite(got[1, :3].numpy()).all()


@pytest.mark.parametrize("use_bridge", [True, False])
@pytest.mark.parametrize("nq,nk", [(13, 20), (160, 200)])
def test_flash_plain_matches_pallas_interpret_bf16(use_bridge, nq, nk):
    """bf16 operands at the kernel's head dim: the plain forward rounds the
    unnormalised probabilities to bf16 before the value products, as the
    Pallas kernel does, so at most 0.1% of the outputs differ (fp32 sums in
    another order flip a rare rounding), each by at most one bf16 ulp of
    max|ref|. Keeping p in fp32 makes 17-32% of them differ."""
    args = _attn_case(8, nq=nq, nk=nk, d=128, use_bridge=use_bridge)
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in args]
    t[:5] = [None if a is None else a.bfloat16() for a in t[:5]]
    j = [None if a is None else jnp.asarray(a.float().numpy()) for a in t]
    j[:5] = [None if a is None else a.astype(jnp.bfloat16) for a in j[:5]]
    want = np.asarray(jflash(*j, block_q=nq, interpret=True).astype(jnp.float32))
    got = tflash.flash_bridged_attention_plain(*t).float().numpy()
    diff = np.abs(got - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.isfinite(got).all()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    assert diff.max() <= ulp, (diff.max(), ulp)


def test_flash_wrapper_takes_plain_version_on_cpu():
    args = _to_t(_attn_case(6))
    before = tflash.flash_bridged_attention.launches
    got = tflash.flash_bridged_attention(*args)
    assert tflash.flash_bridged_attention.launches == before == 0
    torch.testing.assert_close(got, tflash.flash_bridged_attention_plain(*args),
                               rtol=0, atol=0)


def _kernel_case():
    """A call the CUDA kernel takes: bf16 operands, head dim 128."""
    args = _to_t(_attn_case(7, d=128))
    return [t.bfloat16() if t is not None and t.is_floating_point() and i < 5
            else t for i, t in enumerate(args)]


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "bias_dtype", "grad",
                                 "bridge_half", "flag_shape", "strides",
                                 "alignment"])
def test_flash_checks_reject(bad):
    """The launch-side checks that guard the CUDA kernel."""
    q, k, v, kb, vb, fq, fk, bias = _kernel_case()
    if bad == "dtype":
        q, k, v, kb, vb = (t.float() for t in (q, k, v, kb, vb))
    elif bad == "head_dim":
        q, k, v, kb, vb = (t[..., :64] for t in (q, k, v, kb, vb))
    elif bad == "bias_dtype":
        bias = bias.double()
    elif bad == "grad":
        # the backward kernel's checks: a cotangent in another dtype
        q = q.float().requires_grad_(True).bfloat16()
        out = q.detach().clone()
        with pytest.raises(TypeError):
            tflash._check_bwd(q, k, v, kb, vb, fq, fk, bias, out, out.float(),
                              None, None)
        tflash._check(q, k, v, kb, vb, fq, fk, bias)   # inputs that need grad pass
        return
    elif bad == "bridge_half":
        vb = None
    elif bad == "flag_shape":
        fq = fq[:, :-1]
    elif bad == "strides":
        k = k.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "alignment":
        # a base 2 bytes past a 16-byte boundary, then an h stride of 130
        flat = torch.zeros(v.numel() + 1, dtype=v.dtype)
        v_off = flat[1:].view(v.shape)
        with pytest.raises(ValueError, match="16-byte"):
            tflash._check(q, k, v_off, kb, vb, fq, fk, bias)
        wide = torch.zeros(*k.shape[:3], 130, dtype=k.dtype)
        k = wide[..., :128]
    with pytest.raises((TypeError, ValueError, NotImplementedError)):
        tflash._check(q, k, v, kb, vb, fq, fk, bias)
    tflash._check(*_kernel_case())   # a call the kernel takes passes


def test_build_tag_follows_included_headers(tmp_path):
    """An edit to a header that a source includes (directly or through
    another header) changes the source's build tag; nvcc is not needed."""
    (tmp_path / "a.cu").write_text('#include <cuda_runtime.h>\n#include "x.cuh"\n')
    (tmp_path / "x.cuh").write_text('#pragma once\n#include "y.cuh"\n')
    (tmp_path / "y.cuh").write_text("// v1\n")
    (tmp_path / "b.cu").write_text("// includes nothing\n")
    a0, b0 = _build.tag(tmp_path / "a.cu"), _build.tag(tmp_path / "b.cu")
    assert a0 == _build.tag(tmp_path / "a.cu")
    (tmp_path / "y.cuh").write_text("// v2\n")
    assert _build.tag(tmp_path / "a.cu") != a0
    assert _build.tag(tmp_path / "b.cu") == b0
    # the port's two flash sources include the shared header
    assert "flash_mma.cuh" in tflash.SOURCE.read_text()
    assert "flash_mma.cuh" in tflash.BWD_SOURCE.read_text()


@pytest.mark.parametrize("source,helpers", [
    ("int8_matmul.cu", ("ld_stream", "resident_clusters")),
    ("int4_matmul.cu", ("ld_stream", "resident_clusters")),
    ("int4_exp.cu", ("ld_stream", "prmt", "warp_sum", "resident_clusters")),
    ("decode_attention.cu", ("warp_sum",)),
])
def test_split_k_helpers_have_one_copy(source, helpers):
    """The split-K decode templates take their shared helpers from
    ``split_k.cuh`` (so a source's build tag follows it) and define none
    of them again."""
    text = (_build.CSRC / source).read_text()
    header = (_build.CSRC / "split_k.cuh").read_text()
    assert re.search(r'^#include "split_k\.cuh"$', text, re.MULTILINE)
    for name in helpers:
        assert re.search(rf"\b{name}\(", header), name
        assert not re.search(rf"^\S.*\b{name}\([^;]*\)\s*\{{", text, re.MULTILINE), name


@pytest.mark.parametrize("name", ["LibraConfig", "CLIPVisionConfig",
                                  "VQGANConfig"])
def test_config_fields_and_defaults_match(name):
    jf = dataclasses.fields(getattr(jcfg, name))
    tf = dataclasses.fields(getattr(tcfg, name))
    assert [f.name for f in tf] == [f.name for f in jf]
    j_obj, t_obj = getattr(jcfg, name)(), getattr(tcfg, name)()
    for f in jf:
        jv, tv = getattr(j_obj, f.name), getattr(t_obj, f.name)
        if name == "VQGANConfig" and f.name == "clip":
            jv, tv = dataclasses.asdict(jv), dataclasses.asdict(tv)
        assert jv == tv, f.name


def test_tiny_configs_match():
    assert dataclasses.asdict(tcfg.LibraConfig.tiny()) == \
        dataclasses.asdict(jcfg.LibraConfig.tiny())
    assert dataclasses.asdict(tcfg.VQGANConfig.tiny()) == \
        dataclasses.asdict(jcfg.VQGANConfig.tiny())


def test_from_numpy_tree_bf16_exact():
    x = np.asarray(jnp.asarray(_rs(8).randn(3, 4), jnp.bfloat16))
    assert x.dtype.name == "bfloat16"
    tree = from_numpy_tree({"a": {"w": x}, "l": [np.arange(3)]}, device="cpu")
    assert tree["a"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["a"]["w"].float().numpy(),
                                  x.astype(np.float32))
    assert tree["l"][0].tolist() == [0, 1, 2]
    f32 = from_numpy_tree({"w": x}, device="cpu", dtype=torch.float32)["w"]
    assert f32.dtype == torch.float32
