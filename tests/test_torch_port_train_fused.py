"""The port's fused pretrain step against libra_tpu's, at a tiny size in
fp32 on the CPU (the plain attention: "auto" resolves to it on the CPU,
as JAX's resolves to XLA): the host batch (exact), the fused loss under
each remat policy (rtol 1e-5; the policies agree with each other to fp32
rounding), and three train steps with frozen_language (loss and
grad_norm rtol 1e-5, params rtol 1e-4 with atol 1e-5, see
tests/test_torch_port_train.py's PARAM_TOL).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu.training import fused as jfused, optimizer as jopt
from libra_tpu.training.trainer import init_state as jinit_state
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.tokenization import SimpleTextTokenizer
from libra_tpu_torch.training import fused as tfused, optimizer as topt
from libra_tpu_torch.training.trainer import (init_state, masked_value_and_grad)

from tests.test_torch_port_slice import _np_params, _np_vq_params
from tests.test_torch_port_train import PARAM_TOL, _assert_trees_close

FIELDS = tfused.FusedBatch._fields


def _samples(Mv, S=28, n=3, seed=0):
    """Pair samples as a LAION collater gives them: one image block each,
    uint8 pixels, label spans (a None start is skipped), one ignored
    signal; captions of different lengths, so rows are right-padded. As
    the data layer does, a span masks the first text token after the
    image, whose label the EOI position (vision) would predict across
    modalities."""
    rs = np.random.RandomState(seed)
    texts = [f"{'a big ' * i}photo {' '.join(['<img_ph>'] * Mv)} of cats {i}"
             for i in range(n)]
    after = [2 + 2 * i + Mv for i in range(n)]     # BOS, 2i words, "photo"
    spans = [[(0, 2)], [(None, None)], [(3, 5)]]
    return {"language": texts,
            "vision": [rs.randint(0, 256, (S, S, 3), np.uint8) for _ in range(n)],
            "label_mask_position_map": [spans[i] + [(after[i], after[i] + 1)]
                                        for i in range(n)],
            "contiguous_ignore_sign": [False, True, False][:n]}


def _batches(cfg, max_length=None):
    jb = jfused.prepare_fused_batch(_samples(cfg.max_vision_token_length),
                                    JSimpleTok(vocab_size=cfg.vocab_size), cfg,
                                    max_length=max_length)
    tb = tfused.prepare_fused_batch(_samples(cfg.max_vision_token_length),
                                    SimpleTextTokenizer(vocab_size=cfg.vocab_size),
                                    cfg, max_length=max_length, device="cpu")
    return jb, tb


@pytest.mark.parametrize("max_length", [None, 13])
def test_prepare_fused_batch_matches(max_length):
    jcfg, _ = _np_params()
    jb, tb = _batches(jcfg, max_length)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)


def _setup():
    jcfg, p = _np_params()
    jvq = JVQGANConfig.tiny()
    return jcfg, p, jvq, _np_vq_params(jvq)


@pytest.mark.parametrize("remat", [False, "full", "big_dots"])
def test_fused_loss_matches(remat):
    jcfg, p, jvq, np_vq = _setup()
    jb, tb = _batches(jcfg)
    want = jax.jit(functools.partial(jfused.fused_loss_fn, cfg=jcfg, vq_cfg=jvq,
                                     remat=remat, attn_impl="xla"))(
        p, np_vq, batch=jb)
    cfg, vq = LibraConfig.tiny(), VQGANConfig.tiny()
    params = from_numpy_tree(p, device="cpu")
    vq_params = from_numpy_tree(np_vq, device="cpu")
    got = tfused.fused_loss_fn(params, vq_params, cfg, vq, tb, remat=remat)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_fused_loss_and_grads_do_not_depend_on_remat():
    _, p, _, np_vq = _setup()
    cfg, vq = LibraConfig.tiny(), VQGANConfig.tiny()
    _, tb = _batches(cfg)
    params = from_numpy_tree(p, device="cpu")
    vq_params = from_numpy_tree(np_vq, device="cpu")
    mask = topt.trainable_mask(params, topt.OptimizerConfig(frozen_language=True))
    runs = {r: masked_value_and_grad(
        lambda q: tfused.fused_loss_fn(q, vq_params, cfg, vq, tb, remat=r),
        params, mask) for r in (False, "full", "big_dots", "dots")}
    loss0, grads0 = runs[False]
    for loss, grads in runs.values():
        assert loss.item() == loss0.item()
        for k, g in grads.items():
            torch.testing.assert_close(g, grads0[k], rtol=1e-5, atol=1e-7)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_named_remat_policies_save_their_matmuls():
    """A names: subset gives the same loss and gradients as no remat, and
    its recompute skips exactly the named regions' matmuls: it runs fewer
    than "full" and more than "big_dots" (which saves all ten regions and
    re-runs only the bridge projections). An unknown name raises."""
    _, p, _, np_vq = _setup()
    cfg, vq = LibraConfig.tiny(), VQGANConfig.tiny()
    _, tb = _batches(cfg)
    params = from_numpy_tree(p, device="cpu")
    vq_params = from_numpy_tree(np_vq, device="cpu")
    mask = topt.trainable_mask(params, topt.OptimizerConfig(frozen_language=True))
    runs, mms = {}, {}
    for r in (False, "full", "names:attn_o,mlp_down", "big_dots"):
        with _CountMatmuls() as count:
            runs[r] = masked_value_and_grad(
                lambda q: tfused.fused_loss_fn(q, vq_params, cfg, vq, tb, remat=r),
                params, mask)
        mms[r] = count.n
    loss0, grads0 = runs[False]
    loss, grads = runs["names:attn_o,mlp_down"]
    assert loss.item() == loss0.item()
    for k, g in grads.items():
        torch.testing.assert_close(g, grads0[k], rtol=1e-5, atol=1e-7)
    assert mms[False] < mms["big_dots"] < mms["names:attn_o,mlp_down"] < mms["full"]
    with pytest.raises(ValueError, match="unknown remat names"):
        tfused.fused_loss_fn(params, vq_params, cfg, vq, tb, remat="names:attn_x")
    # outside a named policy (serving, the other policies) a tag is free
    assert TM.checkpoint_name("attn_q") is TM._UNNAMED


def test_fused_train_steps_match():
    """Three steps of make_fused_train_step against JAX's: step 0 has a
    zero learning rate (warm-up of one step), then the loss falls."""
    jcfg, p, jvq, np_vq = _setup()
    kw = dict(total_steps=10, warmup_ratio=0.0, learning_rate=1e-3,
              frozen_language=True)
    jb, tb = _batches(jcfg)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**kw), p)
    jstep = jfused.make_fused_train_step(
        jcfg, jvq, jo, grad_mask=jopt.trainable_mask(p, jopt.OptimizerConfig(**kw)),
        attn_impl="xla", remat="big_dots")
    jstate = jinit_state(jax.tree_util.tree_map(np.array, p), jo)

    cfg, vq = LibraConfig.tiny(), VQGANConfig.tiny()
    params = from_numpy_tree(p, device="cpu")
    vq_params = from_numpy_tree(np_vq, device="cpu")
    to = topt.make_optimizer(topt.OptimizerConfig(**kw), params)
    tstep = tfused.make_fused_train_step(
        cfg, vq, to, grad_mask=topt.trainable_mask(params, topt.OptimizerConfig(**kw)),
        remat="big_dots")
    state = init_state(params, to)
    losses = []
    for i in range(3):
        jstate, jm = jstep(jstate, np_vq, jb)
        state, m = tstep(state, vq_params, tb)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-5)
        losses.append(m["loss"].item())
        if i == 0:    # a zero learning rate: nothing moves
            _assert_trees_close(state.params, p, rtol=0, atol=0)
    _assert_trees_close(state.params, jstate.params, **PARAM_TOL)
    assert losses[2] < losses[0]
    assert state.step == 3


def test_scatter_block_clamps_like_dynamic_update_slice():
    rows = torch.zeros((2, 6, 2))
    blocks = torch.ones((2, 3, 2)) * torch.tensor([1.0, 2.0])[:, None, None]
    got = tfused._scatter_block(rows, blocks, torch.tensor([1, 5]))
    want = torch.zeros((2, 6, 2))
    want[0, 1:4] = 1.0
    want[1, 3:6] = 2.0     # start 5 clamped to N - M = 3
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert TM.dropout_enabled(LibraConfig.tiny(attn_pdrop=0.1))
    # a nonzero rate trains: the step builds (tests/test_torch_port_dropout.py)
    assert callable(tfused.make_fused_train_step(LibraConfig.tiny(attn_pdrop=0.1),
                                                 VQGANConfig.tiny(), None))
