"""The port's VQGANTrainer against libra_tpu's, at VQGANConfig.tiny(), 28
x 28 pixels, B = 2, 3 steps, fp32 on the CPU: hinge with disc_start 0,
and vanilla with disc_start 2 (so that steps run on both sides of the
threshold).

One tree for both: the port's noised init_params (its tree equals JAX's:
tests/test_torch_port_t2i.py), the converted reference LPIPS weights,
and JAX's discriminator carried to the port; numpy between them. Each
JAX trainer runs once a module (its two jitted steps compile for ~15 s).
Both sides' optimizers also keep the gradients of each step.

Tolerances: the first step's logs 1e-5 relative, later steps' 1e-4, and
so the first step's logits_fake, the one log of step 1 read after an
update (the discriminator's, on the updated autoencoder's
reconstruction). Every step's gradients, the autoencoder's and the
discriminator's, from JAX's state: within GRAD_RTOL of the leaf's norm
plus GRAD_FLOOR of the tree's; 1e-4 at the first step, 1e-3 after: once
the discriminator has trained, an input of a LeakyReLU within float noise
of 0 can take the other slope in one of the two implementations, which
moves every gradient behind it by about sqrt(1 / n) of its norm for a
layer of n inputs. After the 3 steps every leaf equals
optax.adamw replayed on the port's own gradients (1e-6) and every conv
weight is within 1e-4 relative L2 of JAX's. Biases and norm parameters
are held through their gradients and that replay, not to JAX's after
Adam: Adam's step g / (|g| + 1e-8) * lr lets float noise set the step of
an element whose gradient is near 0, and at the tiny config many are:
every GroupNorm has one channel a group (gcd(32, C) = C), so a conv bias
of the decoder shifts a channel that each GroupNorm downstream takes out
again (up to the zero-padded borders of the convs between), and
BatchNorm takes out the discriminator's conv biases before it exactly.
CLIP and LPIPS bit for bit unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.models import vqgan_train as jvt
from libra_tpu_torch import checkpoint as tckpt
from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import vqgan as tvq, vqgan_train as tvt
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.training.optimizer import leaves_with_paths
from tests.test_torch_port_vqgan_train import _np_tree
from tests.torch_oracle import make_lpips_state_dict

STEPS = 3
LR = 1e-4
# of the leaf's gradient norm (the first step, later ones), and of the tree's
GRAD_RTOL, GRAD_FLOOR = (1e-4, 1e-3), 1e-6
CONFIGS = {"hinge-start0": dict(disc_start=0),
           "vanilla-start2": dict(disc_start=2, disc_loss="vanilla")}
TRAINED = ("decoder", "quant_conv", "post_quant_conv")
_ADAMW = optax.adamw(LR, b1=0.5, b2=0.9)          # libra_tpu's trainer's optimizer
_ADAMW_UPDATE = jax.jit(_ADAMW.update)


def _flat(tree):
    return dict(leaves_with_paths(tree))


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64)))


def _rel(got, want) -> float:
    return _norm(np.asarray(got, np.float64) - want) / max(_norm(want), 1e-30)


def _inputs():
    rs = np.random.RandomState(0)
    cfg = VQGANConfig.tiny()
    tree = _np_tree(tvq.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    tree = jax.tree_util.tree_map(lambda x: (x + rs.normal(0.0, 0.05, x.shape)).astype(x.dtype),
                                  tree)
    lp = _np_tree(tckpt.convert_vgg16_lpips(
        {k: v.numpy() for k, v in make_lpips_state_dict(seed=0).items()}, device="cpu"))
    pixels = rs.randn(2, 28, 28, 3).astype(np.float32)
    targets = np.tanh(pixels)
    return tree, lp, pixels, targets


def _recording(opt):
    """opt, with the gradients of its last update kept in its state:
    (opt's state, the gradients)."""
    def init(params):
        return opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def _record_port(trainer, sink):
    """Have the port trainer's two AdamWs put each step's gradients, by
    path, into sink[-1]["ae"] and sink[-1]["disc"]."""
    for side, opt in (("ae", trainer.ae_opt), ("disc", trainer.disc_opt)):
        def step(leaves, grads, _step=opt.step, _side=side):
            paths = _flat(_trained(trainer)[_side])
            sink[-1][_side] = {p: g.detach().numpy().copy() for p, g in zip(paths, grads)}
            _step(leaves, grads)
        opt.step = step


def _trained(trainer) -> dict:
    """The trees each side's AdamW trains, as JAX's trainer lays them out."""
    return {"ae": {k: trainer.params[k] for k in TRAINED}, "disc": trainer.loss_params["disc"]}


def _port_trainer(tree, lp, disc0, kw):
    t = tvt.VQGANTrainer(VQGANConfig.tiny(), from_numpy_tree(tree, device="cpu"),
                         tvt.VQGANLossConfig(**kw), lr=LR,
                         lpips_params=from_numpy_tree(lp, device="cpu"), device="cpu")
    t.loss_params["disc"] = from_numpy_tree(disc0, device="cpu")
    grads = []
    _record_port(t, grads)
    return t, grads


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    """After STEPS steps each: JAX's logs, gradients, trees and the state
    each step started from; the port's free run (logs, gradients,
    trainer); and the gradients of a port run that starts each step from
    JAX's state, so that they compare with JAX's where the free runs'
    noise (below) has not moved the inputs."""
    kw = CONFIGS[request.param]
    tree, lp, pixels, targets = _inputs()
    jt = jvt.VQGANTrainer(JVQGANConfig.tiny(), jax.tree_util.tree_map(jnp.asarray, tree),
                          jvt.VQGANLossConfig(**kw), lr=LR,
                          lpips_params=jax.tree_util.tree_map(jnp.asarray, lp))
    # the jitted steps read the optimizers when they first trace
    jt.ae_opt, jt.disc_opt = _recording(jt.ae_opt), _recording(jt.disc_opt)
    jt.ae_state = jt.ae_opt.init(jt._ae_params(jt.params))
    jt.disc_state = jt.disc_opt.init(jt.loss_params["disc"])
    disc0 = _np_tree(jt.loss_params["disc"])
    jlogs, jgrads, jstarts = [], [], []
    for _ in range(STEPS):
        jstarts.append({"ae": _flat(_np_tree(jt._ae_params(jt.params))),
                        "disc": _flat(_np_tree(jt.loss_params["disc"]))})
        jlogs.append(jt.train_step(jnp.asarray(pixels), jnp.asarray(targets)))
        jgrads.append({"ae": _flat(_np_tree(jt.ae_state[1])),
                       "disc": _flat(_np_tree(jt.disc_state[1]))})

    tt, tgrads = _port_trainer(tree, lp, disc0, kw)
    tlogs = []
    for _ in range(STEPS):
        tgrads.append({})
        tlogs.append(tt.train_step(pixels, targets))

    ts, sgrads = _port_trainer(tree, lp, disc0, kw)
    for start in jstarts:
        with torch.no_grad():
            for side, leaves in _trained(ts).items():
                for p, t in leaves_with_paths(leaves):
                    t.copy_(torch.from_numpy(start[side][p]))
        sgrads.append({})
        ts.train_step(pixels, targets)
    return dict(name=request.param, jlogs=jlogs, tlogs=tlogs, jgrads=jgrads, tgrads=tgrads,
                sgrads=sgrads, jparams=_np_tree(jt.params),
                jdisc=_np_tree(jt.loss_params["disc"]), trainer=tt, tree=tree, lp=lp,
                disc0=disc0)


def _tree_norm(grads: dict) -> float:
    return _norm([_norm(v) for v in grads.values()])


def test_logs_match_jax(runs):
    for i, (got, want) in enumerate(zip(runs["tlogs"], runs["jlogs"])):
        assert set(got) == set(want)
        for k in want:
            tol = 1e-5 if i == 0 and k != "logits_fake" else 1e-4
            assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1e-3), (i, k, got[k], want[k])
    assert all(np.isfinite(v) for logs in runs["tlogs"] for v in logs.values())
    assert runs["tlogs"][0]["d_weight"] > 0
    if runs["name"] == "vanilla-start2":
        # before disc_start the discriminator's loss is 0, then it is not
        assert [logs["discloss"] == 0.0 for logs in runs["tlogs"]] == [True, True, False]


def test_gradients_match_jax(runs):
    """Every step's gradients, the autoencoder's and the discriminator's,
    leaf by leaf from JAX's state: within GRAD_RTOL of the leaf's norm
    plus GRAD_FLOOR of the tree's (float noise; a leaf whose gradient is
    no more passes either way, and its step is held by the replay in
    test_trained_leaves_match_jax). The discriminator's conv
    biases before a BatchNorm, which it takes out exactly, have gradients
    of float noise wherever the tree's is not 0."""
    for i, (got, want) in enumerate(zip(runs["sgrads"], runs["jgrads"])):
        assert got.keys() == want.keys() == {"ae", "disc"}
        for side in want:
            assert got[side].keys() == want[side].keys(), side
            floor, rtol = GRAD_FLOOR * _tree_norm(want[side]), GRAD_RTOL[min(i, 1)]
            for p, w in want[side].items():
                err = _norm(got[side][p] - w)
                assert err <= rtol * _norm(w) + floor, (i, side, p, err, _norm(w), floor)
        for n in (1, 2, 3):
            assert (_norm(want["disc"][f"layers/{n}/conv/b"])
                    <= GRAD_FLOOR * _tree_norm(want["disc"])), (i, n)
    # the free run's first step started from the same state
    for side, g in runs["tgrads"][0].items():
        for p, v in g.items():
            np.testing.assert_array_equal(v, runs["sgrads"][0][side][p])


def test_trained_leaves_match_jax(runs):
    """The free run's trees after STEPS steps: every leaf equal to
    optax.adamw(lr, 0.5, 0.9) replayed on the port's own gradients (1e-6
    of the leaf's largest value), every conv weight within 1e-4 relative
    L2 of JAX's, and a leaf moved where JAX's moved (the hinge loss's
    head bias has a zero gradient while every logit is inside the
    margin). A bias or norm parameter is held to JAX's through its
    gradients (test_gradients_match_jax) and this replay, not after Adam:
    an element whose gradient is within float noise of Adam's eps (1e-8)
    takes a step g / (|g| + eps) * lr that the noise sets."""
    t = runs["trainer"]
    start = {"ae": _flat({k: runs["tree"][k] for k in TRAINED}), "disc": _flat(runs["disc0"])}
    want = {"ae": _flat({k: runs["jparams"][k] for k in TRAINED}), "disc": _flat(runs["jdisc"])}
    got = {side: _flat(_np_tree(tree)) for side, tree in _trained(t).items()}
    for side in start:
        assert got[side].keys() == want[side].keys() == start[side].keys()
        replay = jax.tree_util.tree_map(jnp.asarray, start[side])
        state = _ADAMW.init(replay)
        for grads in runs["tgrads"]:
            updates, state = _ADAMW_UPDATE(jax.tree_util.tree_map(jnp.asarray, grads[side]), state,
                                    replay)
            replay = optax.apply_updates(replay, updates)
        for p, w in want[side].items():
            assert (np.array_equal(got[side][p], start[side][p])
                    == np.array_equal(w, start[side][p])), (side, p)
            r = np.asarray(replay[p])
            assert np.abs(got[side][p] - r).max() <= 1e-6 * np.abs(r).max(), (side, p)
            if w.ndim > 1:
                assert _rel(got[side][p], w) <= 1e-4, (side, p, _rel(got[side][p], w))
    assert t.step == STEPS


def test_frozen_leaves_unchanged(runs):
    """CLIP (frozen) and the LPIPS weights (a loss's constants)."""
    t = runs["trainer"]
    for a, b in ((t.params["clip"], runs["tree"]["clip"]), (t.loss_params["lpips"], runs["lp"])):
        got, want = _flat(_np_tree(a)), _flat(b)
        assert got.keys() == want.keys()
        for p in want:
            np.testing.assert_array_equal(got[p], want[p])


def test_targets_default_to_pixels():
    """targets=None holds the reconstruction to the pixels themselves (as
    libra_tpu's code does, not its docstring's clip_to_rgb)."""
    tree, lp, pixels, _ = _inputs()
    logs = []
    for targets in (None, pixels):
        t = tvt.VQGANTrainer(VQGANConfig.tiny(), from_numpy_tree(tree, device="cpu"), lr=LR,
                             lpips_params=from_numpy_tree(lp, device="cpu"), device="cpu")
        logs.append(t.train_step(pixels, targets))
    assert logs[0] == logs[1]


def test_random_lpips_and_discriminator_are_seeded():
    """Without lpips_params the LPIPS tree is drawn from the seed, after
    the discriminator, so that a given LPIPS tree leaves the
    discriminator's draw as it is."""
    cfg = VQGANConfig.tiny()
    params = tvq.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    a = tvt.VQGANTrainer(cfg, params, seed=3, device="cpu")
    b = tvt.VQGANTrainer(cfg, params, seed=3, device="cpu")
    c = tvt.VQGANTrainer(cfg, params, seed=3, device="cpu",
                         lpips_params=a.loss_params["lpips"])
    for x, y, z in zip(_flat(a.loss_params).values(), _flat(b.loss_params).values(),
                       _flat(c.loss_params).values()):
        assert torch.equal(x, y) and torch.equal(x, z)
