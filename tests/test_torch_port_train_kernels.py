"""The port's flash-attention backward against libra_tpu's Pallas VJP
(interpret mode) on the CPU, where the port's autograd Function runs the
plain backward, and the port's entry points' device defaults.

Tolerances: rtol/atol 2e-4, as libra_tpu's own backward tests hold the
Pallas VJP against XLA autodiff (fp32 sums in other orders through two
softmax passes); fully masked query rows get exactly zero dq.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu.ops.attention import causal_bias as jcausal_bias
from libra_tpu.ops.pallas.flash_bridge import flash_bridged_attention as jflash
from libra_tpu_torch.models import clip as tclip, libra as TM, vqgan as tvqgan
from libra_tpu_torch.ops import flash_bridge as tflash
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.training.fused import prepare_fused_batch

TOL = dict(rtol=2e-4, atol=2e-4)


def _case(seed, B, nq, nk, H, d, use_bridge, mask_keys=slice(2, 4)):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, nq, H, d).astype(np.float32)
    k, v, kb, vb = (rs.randn(B, nk, H, d).astype(np.float32) for _ in range(4))
    flag_q = rs.rand(B, nq) < 0.5
    flag_kv = (np.concatenate([rs.rand(B, nk - nq) < 0.5, flag_q], axis=1)
               if nk > nq else flag_q)
    mask = np.ones((B, nk), np.int32)
    mask[0, mask_keys] = 0
    bias = np.array(jcausal_bias(jnp.asarray(mask), nq, nk))
    cot = rs.randn(B, nq, H, d).astype(np.float32)
    ops = (q, k, v, kb, vb) if use_bridge else (q, k, v)
    return ops, flag_q, flag_kv, bias, cot


def _jax_grads(ops, flag_q, flag_kv, bias, cot, block_q):
    def f(*o):
        kb, vb = (o[3], o[4]) if len(o) == 5 else (None, None)
        return jflash(o[0], o[1], o[2], kb, vb, jnp.asarray(flag_q),
                      jnp.asarray(flag_kv), jnp.asarray(bias),
                      block_q=block_q, interpret=True)
    _, vjp = jax.vjp(f, *map(jnp.asarray, ops))
    return [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_grads(ops, flag_q, flag_kv, bias, cot):
    t = [torch.from_numpy(o).requires_grad_(True) for o in ops]
    kb, vb = (t[3], t[4]) if len(t) == 5 else (None, None)
    bias_t = torch.from_numpy(bias).requires_grad_(True)
    out = tflash.flash_bridged_attention(
        t[0], t[1], t[2], kb, vb, torch.from_numpy(flag_q),
        torch.from_numpy(flag_kv), bias_t)
    grads = torch.autograd.grad(out, t + [bias_t], torch.from_numpy(cot),
                                allow_unused=True)
    assert grads[-1] is None          # no bias gradient, by contract
    return [g.numpy() for g in grads[:-1]]


@pytest.mark.parametrize("use_bridge", [True, False])
@pytest.mark.parametrize("nq,nk", [(16, 16), (8, 24)])
def test_flash_bwd_matches_pallas_vjp(use_bridge, nq, nk):
    ops, fq, fk, bias, cot = _case(3, 2, nq, nk, 2, 8, use_bridge)
    want = _jax_grads(ops, fq, fk, bias, cot, block_q=8)
    for g, w in zip(_torch_grads(ops, fq, fk, bias, cot), want):
        np.testing.assert_allclose(g, w, **TOL)


def test_flash_bwd_ragged():
    """N = 260, no multiple of 16 (the TPU backward pads it to 384; the
    port's takes it as it is), the bridge on with kb = k, vb = v."""
    ops, fq, fk, bias, cot = _case(11, 1, 260, 260, 1, 8, True,
                                   mask_keys=slice(0, 0))
    ops = (ops[0], ops[1], ops[2], ops[1], ops[2])
    want = _jax_grads(ops, fq, fk, bias, cot, block_q=260)
    got = _torch_grads(ops, fq, fk, bias, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("use_bridge", [True, False])
def test_flash_bwd_fully_masked_rows(use_bridge):
    """Keys 0 and 1 masked: query rows 0 and 1 see nothing. Their dq is
    exactly zero; their uniform average still feeds dv (and dvb)."""
    ops, fq, fk, bias, cot = _case(5, 1, 16, 16, 2, 8, use_bridge,
                                   mask_keys=slice(0, 2))
    want = _jax_grads(ops, fq, fk, bias, cot, block_q=8)
    got = _torch_grads(ops, fq, fk, bias, cot)
    np.testing.assert_array_equal(got[0][:, :2], 0.0)
    assert np.abs(got[2]).max() > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_flash_bwd_gradcheck_fp64():
    """Finite differences in fp64 on rows that all see some key."""
    ops, fq, fk, bias, _ = _case(7, 1, 6, 6, 2, 4, True, mask_keys=slice(2, 3))
    t = tuple(torch.from_numpy(o).double().requires_grad_(True) for o in ops)
    f = lambda *o: tflash.flash_bridged_attention(  # noqa: E731
        *o, torch.from_numpy(fq), torch.from_numpy(fk),
        torch.from_numpy(bias).double())
    assert torch.autograd.gradcheck(f, t, eps=1e-6, atol=1e-6)


def test_flash_bwd_plain_is_the_cpu_path_and_counts_nothing():
    ops, fq, fk, bias, cot = _case(9, 2, 8, 8, 2, 8, True)
    before = (tflash.flash_bridged_attention.launches,
              tflash.flash_bridged_attention_bwd.launches)
    got = _torch_grads(ops, fq, fk, bias, cot)
    t = [torch.from_numpy(o) for o in ops]
    args = t + [torch.from_numpy(fq), torch.from_numpy(fk), torch.from_numpy(bias)]
    out = tflash.flash_bridged_attention_plain(*args)
    want = tflash.flash_bridged_attention_bwd_plain(*args, out, torch.from_numpy(cot))
    for g, w in zip(got, want):
        torch.testing.assert_close(torch.from_numpy(g), w, rtol=0, atol=0)
    assert (tflash.flash_bridged_attention.launches,
            tflash.flash_bridged_attention_bwd.launches) == before == (0, 0)


@pytest.mark.parametrize("fn", [TM.init_params, TM.init_cache, tclip.init_params,
                                tvqgan.init_params, from_numpy_tree,
                                prepare_fused_batch])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
