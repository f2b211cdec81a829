"""The port's training pieces against libra_tpu's, at a tiny size in fp32
on the CPU: the multi-codebook loss (rtol 1e-6), the optimizer's masks,
schedule and three AdamW steps against optax (params rtol 1e-5), the
train and accumulation steps (loss and grad_norm rtol 1e-5, params rtol
1e-4 with atol 1e-5: fp32 sums in other orders through two layers and
the Adam normalisation, see PARAM_TOL), and the training wrapper's batches (ids and labels
exact, signal atol 1e-4).

Both packages start from one parameter tree: JAX's init_params with the
bridge B-weights filled with noise (tests/test_torch_port_slice.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.models import libra as JM
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu.tokenization import LibraTokenizer as JLibraTokenizer
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu.train_wrapper import LibraTrainWrapper as JWrapper
from libra_tpu.train_wrapper import build_labels as jbuild_labels
from libra_tpu.training import optimizer as jopt, trainer as jtrainer
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from libra_tpu_torch.train_wrapper import LibraTrainWrapper, build_labels
from libra_tpu_torch.training import optimizer as topt, trainer as ttrainer

from tests.test_torch_port_slice import _batch, _np_params, _np_vq_params


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _assert_trees_close(got, want, **tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unified", [False, True])
def test_multicodebook_loss_matches(unified):
    cfg = LibraConfig.tiny(unified_head=unified)
    jcfg = _np_params()[0].replace(unified_head=unified)
    rs = np.random.RandomState(0)
    Q, B, N, V, Vv = 2, 2, 12, cfg.vocab_size, cfg.vision_vocab_size
    tl = rs.randn(B, N, V).astype(np.float32) * 3
    vl = rs.randn(Q, B, N, Vv).astype(np.float32) * 3
    flag = np.zeros((B, N), bool)
    flag[:, 3:9] = True
    labels = rs.randint(0, V, (Q, B, N))
    labels[:, :, 4:10] = rs.randint(V, V + Vv, (Q, B, 6))
    labels[:, 0, :2] = -100
    labels[0, 1, 5] = 7               # a text label at a vision position
    want = [np.asarray(x) for x in JM.multicodebook_loss_terms(
        jcfg, *map(jnp.asarray, (tl, vl, flag, labels)), unified=unified)]
    args = (cfg, *map(torch.from_numpy, (tl, vl, flag, labels)))
    got = TM.multicodebook_loss_terms(*args, unified=unified)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(
        TM.multicodebook_loss(*args, unified=unified).item(),
        float(JM.multicodebook_loss(jcfg, *map(jnp.asarray, (tl, vl, flag, labels)),
                                    unified=unified)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

OPT_CONFIGS = [
    dict(frozen_language=True, total_steps=10, warmup_ratio=0.0, learning_rate=1e-3),
    dict(llm_lr_scale=0.1, total_steps=10, warmup_ratio=0.0, learning_rate=1e-3),
    dict(total_steps=10, warmup_ratio=0.3, learning_rate=1e-3, min_lr_ratio=0.1),
]


@pytest.mark.parametrize("kw", OPT_CONFIGS + [dict(freeze_vision_value=True,
                                                   freeze_text_embedding=True,
                                                   freeze_vision_embedding=True)])
def test_masks_match(kw):
    _, p = _np_params()
    assert _flat(topt.trainable_mask(from_numpy_tree(p, device="cpu"),
                                     topt.OptimizerConfig(**kw))) == \
        _flat(jopt.trainable_mask(p, jopt.OptimizerConfig(**kw)))
    assert _flat(topt.decay_mask(from_numpy_tree(p, device="cpu"))) == \
        _flat(jopt.decay_mask(p))


@pytest.mark.parametrize("kw", OPT_CONFIGS)
def test_schedule_matches(kw):
    want = jopt.make_schedule(jopt.OptimizerConfig(**kw))
    got = topt.make_schedule(topt.OptimizerConfig(**kw))
    for n in range(12):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=0)


def _grads(params, seed, vision_scale, language_scale):
    """Random gradients per leaf: vision-side leaves at one scale, language
    leaves at another, so each label group's clip can trigger on its own."""
    rs = np.random.RandomState(seed)
    return {k: (rs.randn(*v.shape) * (vision_scale if topt._is_vision(k)
                                      else language_scale)).astype(np.float32)
            for k, v in _flat(params).items()}


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


@pytest.mark.parametrize("kw", OPT_CONFIGS)
def test_optimizer_steps_match_optax(kw):
    """Three steps: frozen_language (one group), llm_lr_scale 0.1 with every
    leaf trainable (two groups, each clipped by its own norm: the vision
    gradients' norm is above 1, the language ones' below), and warm-up,
    whose first update is exactly zero."""
    _, p = _np_params()
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**kw), p)
    jparams, jstate = p, jo.init(p)
    tparams = from_numpy_tree(p, device="cpu")
    to = topt.make_optimizer(topt.OptimizerConfig(**kw), tparams)
    tstate = to.init(tparams)
    update = jax.jit(jo.update)
    for i in range(3):
        g = _grads(p, i, 1e-2, 1e-4)
        updates, jstate = update(_unflat(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate = to.step(tparams, {k: torch.from_numpy(g[k]) for k in to.trainable},
                         tstate)
        _assert_trees_close(tparams, jparams, rtol=1e-5, atol=1e-8)
        if i == 0 and kw["warmup_ratio"] > 0:
            _assert_trees_close(tparams, p, rtol=0, atol=0)
    assert tstate.count == 3
    if kw.get("frozen_language"):
        frozen = [k for k, t in _flat(topt.trainable_mask(
            tparams, topt.OptimizerConfig(**kw))).items() if not t]
        assert frozen and all(k not in tstate.mu for k in frozen)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

# Adam divides each gradient element by its own running RMS, so an element
# whose gradient is near zero (fp32 noise in both frameworks) moves by up
# to the learning rate either way: atol is 1% of lr = 1e-3.
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _train_batch(cfg, N=14):
    ids, mask, vi, sig = _batch(cfg, N=N)
    Mv = cfg.max_vision_token_length
    labels = np.where(mask[None].astype(bool), ids, -100)
    labels[:, :, 4] = -100                           # BOI
    labels = np.where(np.roll(vi == Mv - 1, 1, axis=-1)[None], -100, labels)
    return {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
            "coninous_signal": sig, "labels": labels}


def _to_torch(batch):
    return {k: None if v is None else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


@pytest.mark.parametrize("frozen", [True, False])
def test_train_step_matches(frozen):
    jcfg, p = _np_params()
    cfg = LibraConfig.tiny()
    kw = dict(frozen_language=frozen, total_steps=10, warmup_ratio=0.0,
              learning_rate=1e-3)
    batch = _train_batch(cfg)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**kw), p)
    gmask = jopt.trainable_mask(p, jopt.OptimizerConfig(**kw)) if frozen else None
    jstep = jax.jit(functools.partial(jtrainer.train_step, cfg=jcfg, opt=jo,
                                      grad_mask=gmask, remat=True))
    jstate = jtrainer.init_state(p, jo)

    tparams = from_numpy_tree(p, device="cpu")
    to = topt.make_optimizer(topt.OptimizerConfig(**kw), tparams)
    tmask = topt.trainable_mask(tparams, topt.OptimizerConfig(**kw)) if frozen else None
    tstate = ttrainer.init_state(tparams, to)
    tb = _to_torch(batch)
    for _ in range(3):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = ttrainer.train_step(tstate, tb, cfg=cfg, opt=to,
                                         grad_mask=tmask, remat=True)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-5)
        assert tm["step"] == int(jm["step"])
    _assert_trees_close(tstate.params, jstate.params, **PARAM_TOL)
    np.testing.assert_allclose(
        ttrainer.eval_step(tstate, tb, cfg=cfg).item(),
        float(jtrainer.eval_step(jstate, batch, cfg=jcfg)), rtol=1e-5)


def test_accum_step_equals_single_batch():
    """Two identical micro-batches: the loss and the update are the single
    batch's (group-total normalisation: 2x nll over 2x valid)."""
    _, p = _np_params()
    cfg = LibraConfig.tiny()
    kw = dict(frozen_language=True, total_steps=10, warmup_ratio=0.0,
              learning_rate=1e-3)
    batch = _train_batch(cfg)
    states = []
    for _ in range(2):
        params = from_numpy_tree(p, device="cpu")
        opt = topt.make_optimizer(topt.OptimizerConfig(**kw), params)
        states.append((ttrainer.init_state(params, opt), opt,
                       topt.trainable_mask(params, topt.OptimizerConfig(**kw))))
    (s1, o1, m1), (s2, o2, m2) = states
    stacked = _to_torch(ttrainer.stack_micro_batches([batch, batch], cfg))
    for _ in range(2):   # the second step's update is nonzero
        s1, single = ttrainer.train_step(s1, _to_torch(batch), cfg=cfg, opt=o1,
                                         grad_mask=m1)
        s2, acc = ttrainer.accum_train_step(s2, stacked, cfg=cfg, opt=o2,
                                            grad_mask=m2)
        np.testing.assert_allclose(acc["loss"].item(), single["loss"].item(),
                                   rtol=1e-6)
        np.testing.assert_allclose(acc["grad_norm"].item(),
                                   single["grad_norm"].item(), rtol=1e-5)
    _assert_trees_close(s2.params, s1.params, rtol=1e-5, atol=1e-8)


def test_batch_padding_helpers_match():
    jcfg, _ = _np_params()
    cfg = LibraConfig.tiny()
    a, b = _train_batch(cfg, N=14), _train_batch(cfg, N=11)
    want = jtrainer.stack_micro_batches([a, b], jcfg)
    got = ttrainer.stack_micro_batches([a, b], cfg)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    right = dict(a, attention_mask=np.ascontiguousarray(
        np.sort(a["attention_mask"], axis=1)[:, ::-1]))
    for mult in (4, 7):
        want = jtrainer.pad_batch_tokens(right, jcfg, mult)
        got = ttrainer.pad_batch_tokens(right, cfg, mult)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert ttrainer._neutral_pad_vals(cfg) == jtrainer._neutral_pad_vals(jcfg)
    with pytest.raises(ValueError):   # row 1 of _batch is left-padded
        ttrainer.pad_batch_tokens(a, cfg, 4)


# ---------------------------------------------------------------------------
# Training wrapper
# ---------------------------------------------------------------------------

def _samples(Mv, S=28, n=2, seed=0):
    rs = np.random.RandomState(seed)
    texts = [f"a photo {' '.join(['<img_ph>'] * Mv)} of a cat number {i}"
             for i in range(n)]
    return {"language": texts,
            "vision": [rs.randn(S, S, 3).astype(np.float32) for _ in range(n)],
            "label_mask_position_map": [[(0, 2)], [(None, None), (9, None)]][:n],
            "contiguous_ignore_sign": [False, True][:n]}


def test_build_labels_matches():
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 40, (2, 3, 10))
    mask = (rs.rand(3, 10) > 0.2).astype(np.int32)
    spans = [[(1, 3)], [(None, None)], [(5, None), (0, 1)]]
    np.testing.assert_array_equal(build_labels(ids, mask, spans, 7, 1),
                                  jbuild_labels(ids, mask, spans, 7, 1))


@pytest.mark.parametrize("max_length", [None, 12])
def test_prepare_batch_matches(max_length):
    jcfg, p = _np_params()
    cfg = LibraConfig.tiny()
    jvq, vq = JVQGANConfig.tiny(), VQGANConfig.tiny()
    np_vq = _np_vq_params(jvq)
    Mv = cfg.max_vision_token_length
    jw = JWrapper(jcfg, JLibraTokenizer(
        JSimpleTok(vocab_size=cfg.vocab_size),
        JImageTokenizer(jvq, np_vq, token_offset=cfg.vocab_size,
                        max_vision_token_length=Mv)))
    tw = LibraTrainWrapper(cfg, LibraTokenizer(
        SimpleTextTokenizer(vocab_size=cfg.vocab_size),
        ImageTokenizer(vq, from_numpy_tree(np_vq, device="cpu"), cfg.vocab_size, Mv)))
    want = jw.prepare_batch({"samples": _samples(Mv)}, max_length=max_length)
    got = tw.prepare_batch({"samples": _samples(Mv)}, max_length=max_length)
    for k in ("input_ids", "attention_mask", "vision_indices", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["coninous_signal"].numpy(),
                               np.asarray(want["coninous_signal"]), atol=1e-4)

    emb = tw.change_pad_token_to_eos(from_numpy_tree(p, device="cpu"))["embed_tokens"]
    np.testing.assert_array_equal(emb.numpy(),
                                  np.asarray(jw.change_pad_token_to_eos(p)["embed_tokens"]))
