"""Train-time dropout in the port, at a tiny size in fp32 on the CPU.

The port draws each mask from a generator seeded by a key of integers
(ops/routed.py), so its masks differ from libra_tpu's threefry streams;
these tests hold the semantics of tests/test_dropout.py instead:
inverted scaling, per-modality keep rates, identity at rate 0 and without
a key, determinism per key, a train step that runs and differs from step
to step. At zero rates (or without a key) the forward is bit for bit the
forward without dropout, and that forward agrees with libra_tpu's within
the slice tests' tolerance (atol 1e-5). With every rate on, the
gradients are equal under remat off, "full" and "big_dots" (the
recompute redraws the same masks), and attn_pdrop > 0 takes the plain
attention where the flash kernel would run.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from libra_tpu.models import libra as JM
from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.ops import routed
from libra_tpu_torch.ops.routed import apply_dropout, routed_dropout
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.training import optimizer as topt, trainer as ttrainer

from tests.test_torch_port_slice import _np_params

RATES = dict(resid_pdrop=0.2, attn_pdrop=0.1, embd_pdrop=0.1,
             vision_embd_pdrop=0.3, vision_resid_pdrop=0.3)


def _batch(cfg, B=2, seed=0):
    """tests/test_dropout.py's batch: 4 text tokens around one image block
    at 2, random signal rows, unpadded (numpy)."""
    rng = np.random.RandomState(seed)
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    N = 4 + Mv
    ids = rng.randint(3, cfg.vocab_size, size=(Q, B, N)).astype(np.int64)
    ids[1:] = ids[0]
    ids[:, :, 2:2 + Mv] = (rng.randint(0, cfg.vision_vocab_size - 2, size=(Q, B, Mv))
                           + cfg.vocab_size)
    vi = np.full((B, N), Mv, np.int64)
    vi[:, 2:2 + Mv] = np.arange(Mv)
    mask = np.ones((B, N), np.int64)
    sig = (rng.randn(B, N, cfg.contiguous_signal_size) * 0.02).astype(np.float32)
    return ids, mask, vi, sig


def _forward(cfg, params, batch, key=None, **kw):
    ids, mask, vi, sig = (torch.from_numpy(x) for x in batch)
    return TM.forward(params, cfg, ids, mask, vi, sig, dropout_key=key,
                      **kw).hidden_states


@pytest.fixture(scope="module")
def tree():
    jcfg, p = _np_params()
    return jcfg, p, from_numpy_tree(p, device="cpu")


def test_apply_dropout_scaling_and_identity():
    x = torch.ones((1000, 8))
    assert apply_dropout(None, x, 0.5) is x
    assert apply_dropout((0,), x, 0.0) is x
    y = apply_dropout((0,), x, 0.25).numpy()
    kept = y != 0
    np.testing.assert_allclose(y[kept], 1.0 / 0.75, rtol=1e-6)
    assert abs(kept.mean() - 0.75) < 0.02
    np.testing.assert_array_equal(apply_dropout((0,), x, 0.25).numpy(), y)
    assert not np.array_equal(apply_dropout((1,), x, 0.25).numpy(), y)


def test_routed_dropout_per_modality_rates():
    flag = torch.tensor([[True] * 2000 + [False] * 2000])
    x = torch.ones((1, 4000, 4))
    assert routed_dropout((1,), x, flag, 0.0, 0.0) is x
    assert routed_dropout(None, x, flag, 0.5, 0.1) is x
    y = routed_dropout((1,), x, flag, 0.5, 0.1).numpy()
    assert abs((y[0, :2000] != 0).mean() - 0.5) < 0.05
    assert abs((y[0, 2000:] != 0).mean() - 0.9) < 0.05
    # survivors scaled by the modality's own keep probability
    np.testing.assert_allclose(y[0, :2000][y[0, :2000] != 0], 2.0, rtol=1e-6)
    np.testing.assert_allclose(y[0, 2000:][y[0, 2000:] != 0], 1 / 0.9, rtol=1e-6)


def test_key_streams_are_integers():
    """fold appends; the seed is a pure function of the integers."""
    assert routed.fold(None, 3) is None
    assert routed.fold((7, 2), 1, 4) == (7, 2, 1, 4)
    assert routed.key_seed((7, 2, 1)) == routed.key_seed((7, 2, 1))
    assert len({routed.key_seed((7, 2, i)) for i in range(64)}) == 64
    assert 0 <= routed.key_seed((2 ** 70, -1)) < 2 ** 63


def test_zero_rates_or_no_key_is_the_plain_forward(tree):
    jcfg, p, params = tree
    cfg = LibraConfig.tiny()
    batch = _batch(cfg)
    h0 = _forward(cfg, params, batch)
    # a key at zero rates, and rates without a key: bit for bit
    torch.testing.assert_close(_forward(cfg, params, batch, key=(3, 0)), h0,
                               rtol=0, atol=0)
    torch.testing.assert_close(_forward(cfg.replace(**RATES), params, batch), h0,
                               rtol=0, atol=0)
    # and libra_tpu's forward with a dropout rng at zero rates
    jb = dict(zip(("input_ids", "attention_mask", "vision_indices",
                   "contiguous_signal"), batch))
    want = jax.jit(functools.partial(JM.forward, cfg=jcfg))(
        p, dropout_rng=jax.random.PRNGKey(3), **jb).hidden_states
    np.testing.assert_allclose(h0.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_dropout_active_deterministic_per_key(tree):
    _, _, params = tree
    cfg = LibraConfig.tiny(**RATES)
    batch = _batch(cfg)
    h_eval = _forward(cfg, params, batch)
    ha = _forward(cfg, params, batch, key=(5, 0))
    hb = _forward(cfg, params, batch, key=(5, 0))
    hc = _forward(cfg, params, batch, key=(6, 0))
    assert not torch.allclose(h_eval, ha)
    torch.testing.assert_close(ha, hb, rtol=0, atol=0)
    assert not torch.allclose(ha, hc)


def _train_batch(cfg):
    ids, mask, vi, sig = _batch(cfg)
    Mv = cfg.max_vision_token_length
    # mask the cross-modal boundary labels: BOI and the first text token
    # after the image
    post_img = np.roll(vi == Mv - 1, 1, axis=-1)
    labels = np.where((post_img | (vi == 0))[None], -100, ids)
    return {k: torch.from_numpy(v) for k, v in dict(
        input_ids=ids, attention_mask=mask, vision_indices=vi,
        coninous_signal=sig, labels=labels).items()}


def _state(p, cfg):
    params = from_numpy_tree(p, device="cpu")
    opt = topt.make_optimizer(topt.OptimizerConfig(
        total_steps=10, warmup_ratio=0.0, learning_rate=1e-3), params)
    return ttrainer.init_state(params, opt), opt


def test_train_step_with_dropout_runs_and_differs(tree):
    """The mask is keyed on the step: the same batch and parameters at
    the next step give another loss; the same step and seed the same
    loss; another dropout_seed another."""
    _, p, _ = tree
    cfg = LibraConfig.tiny(resid_pdrop=0.2, embd_pdrop=0.1)
    batch = _train_batch(cfg)
    losses = {}
    for seed, step in ((0, 0), (0, 1), (1, 0), (0, 0)):
        state, opt = _state(p, cfg)
        state = state._replace(step=step)
        _, m = ttrainer.train_step(state, batch, cfg=cfg, opt=opt,
                                   dropout_seed=seed)
        assert np.isfinite(m["loss"].item())
        losses.setdefault((seed, step), []).append(m["loss"].item())
    assert losses[(0, 0)][0] == losses[(0, 0)][1]
    assert losses[(0, 0)][0] != losses[(0, 1)][0]
    assert losses[(0, 0)][0] != losses[(1, 0)][0]


def test_accum_micro_batches_get_their_own_masks(tree):
    """Two identical micro-batches: without dropout the accumulated step
    is the single batch's; with dropout each micro-batch draws its own
    masks (key (seed, step, index)), so the loss moves off it."""
    _, p, _ = tree
    for cfg, equal in ((LibraConfig.tiny(), True),
                       (LibraConfig.tiny(resid_pdrop=0.2), False)):
        batch = _train_batch(cfg)
        stacked = {k: torch.stack([v, v]) for k, v in batch.items()}
        s1, o1 = _state(p, cfg)
        s2, o2 = _state(p, cfg)
        _, single = ttrainer.train_step(s1, batch, cfg=cfg, opt=o1)
        _, acc = ttrainer.accum_train_step(s2, stacked, cfg=cfg, opt=o2)
        close = abs(acc["loss"].item() - single["loss"].item()) < 1e-6
        assert close == equal


def test_gradients_equal_under_every_remat(tree):
    """Every rate on: remat off, "full" and "big_dots" give the same loss
    and gradients, so the recompute drew the forward's masks."""
    _, p, _ = tree
    cfg = LibraConfig.tiny(**RATES)
    batch = _train_batch(cfg)
    params = from_numpy_tree(p, device="cpu")
    out = {}
    for remat in (False, "full", "big_dots"):
        out[remat] = ttrainer.masked_value_and_grad(
            lambda q: ttrainer.loss_fn(q, cfg, batch, remat=remat,
                                       dropout_key=(9, 4)), params)
    loss0, g0 = out[False]
    nodrop, _ = ttrainer.masked_value_and_grad(
        lambda q: ttrainer.loss_fn(q, cfg, batch, remat=False), params)
    assert loss0.item() != nodrop.item()
    for remat in ("full", "big_dots"):
        loss, g = out[remat]
        torch.testing.assert_close(loss, loss0, rtol=1e-6, atol=0)
        for k in g0:
            torch.testing.assert_close(g[k], g0[k], rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("attn_pdrop, key, flash_calls", [
    (0.1, (1, 0), 0),        # attention dropout: the plain attention
    (0.0, (1, 0), 2),        # other rates keep the kernel
    (0.1, None, 2),          # no key: eval, the kernel
])
def test_attention_dropout_takes_the_plain_route(tree, monkeypatch, attn_pdrop,
                                                 key, flash_calls):
    _, _, params = tree
    cfg = LibraConfig.tiny(resid_pdrop=0.1, attn_pdrop=attn_pdrop)
    calls = []
    flash = TM.flash_bridged_attention
    monkeypatch.setattr(TM, "flash_bridged_attention",
                        lambda *a: calls.append(1) or flash(*a))
    h = _forward(cfg, params, _batch(cfg), key=key, attn_impl="flash")
    assert torch.isfinite(h).all()
    assert len(calls) == flash_calls
