"""The port's tokenizer-training pieces against libra_tpu, at a tiny size
in fp32 on the CPU: LFQ's training branch (the straight-through output,
indices, the entropy + commitment aux loss and the gradient through
them), encode(training=True), the conv encoder (its init tree and
encoder_forward), VGG16 and LPIPS (also against the reference LPIPS
through torch), the LPIPS converters, the PatchGAN discriminator, the
hinge and vanilla losses, adopt_weight, generator_loss (value and its
gradient on the reconstruction) and discriminator_loss.

One tree for both packages: the port's inits (their trees equal JAX's,
held by jax.eval_shape, which builds JAX's without running it), every
leaf noised so that no swapped pair of leaves could pass, carried to JAX
as numpy. Tolerance 1e-5 unless a test states another.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from libra_tpu import checkpoint as jckpt
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.models import lfq as jlfq, vqgan as jvq, vqgan_train as jvt
from libra_tpu_torch import checkpoint as tckpt
from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import lfq as tlfq, vqgan as tvq, vqgan_train as tvt
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.quantization import QuantizedArray
from libra_tpu_torch.training.optimizer import leaves_with_paths
from tests.torch_oracle import lpips_reference, make_lpips_state_dict

TOL = 1e-5
CPU = "cpu"


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np_tree(tree):
    """A tree of JAX arrays or tensors (dicts, lists, None) as numpy."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) else np.array(tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts, lists and None."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _flat(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree) for p, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _shapes(tree):
    return {p: None if v is None else tuple(v.shape) for p, v in _flat(tree).items()}


def _noised(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + rs.normal(0.0, 0.05, x.shape)).astype(x.dtype), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor)
                                          else got), np.asarray(want), rtol=tol, atol=tol)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# LFQ's training branch
# ---------------------------------------------------------------------------

def _lfq_case(dim):
    jspec = jlfq.LFQSpec(codebook_size=16, num_codebooks=2, dim=dim)
    tspec = tlfq.LFQSpec(codebook_size=16, num_codebooks=2, dim=dim)
    rs = np.random.RandomState(7)
    # small values keep the softmax over the codes soft (inv_temperature 100)
    x = (0.05 * rs.randn(2, 3, 3, dim)).astype(np.float32)
    p = None
    if dim != 8:
        p = {"project_in": {"w": rs.randn(dim, 8).astype(np.float32) * 0.3,
                            "b": rs.randn(8).astype(np.float32) * 0.01},
             "project_out": {"w": rs.randn(8, dim).astype(np.float32),
                             "b": rs.randn(dim).astype(np.float32)}}
    r = rs.randn(2, 3, 3, dim).astype(np.float32)
    return jspec, tspec, x, p, r


@pytest.mark.parametrize("dim", [8, 6], ids=["identity", "projections"])
def test_lfq_training_matches_jax(dim):
    """Quantized output, indices and aux loss; and the gradient on x of
    sum(out * r) + 3 * aux, which pins the straight-through estimator and
    where the stop-gradients sit."""
    jspec, tspec, x, p, r = _lfq_case(dim)
    jp = None if p is None else _j(p)
    tp = None if p is None else from_numpy_tree(p, device=CPU)
    want = jlfq.quantize(jnp.asarray(x), jspec, jp, training=True)
    got = tlfq.quantize(_t(x), tspec, tp, training=True)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _close(got.quantized, want.quantized)
    _close(got.aux_loss, want.aux_loss)
    assert float(want.aux_loss) != 0.0

    def jscalar(xx):
        out = jlfq.quantize(xx, jspec, jp, training=True)
        return jnp.sum(out.quantized * r) + 3.0 * out.aux_loss

    jgrad = jax.grad(jscalar)(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    out = tlfq.quantize(tx, tspec, tp, training=True)
    (torch.sum(out.quantized * _t(r)) + 3.0 * out.aux_loss).backward()
    _close(tx.grad, jgrad)


@pytest.mark.parametrize("dim", [8, 6], ids=["identity", "projections"])
def test_lfq_inference_unchanged(dim):
    """training=False: the signs exactly as before, indices equal to the
    training branch's, a zero fp32 aux loss."""
    _, tspec, x, p, _ = _lfq_case(dim)
    tp = None if p is None else from_numpy_tree(p, device=CPU)
    inf = tlfq.quantize(_t(x), tspec, tp)
    train = tlfq.quantize(_t(x), tspec, tp, training=True)
    np.testing.assert_array_equal(inf.indices.numpy(), train.indices.numpy())
    assert inf.aux_loss.dtype == torch.float32 and float(inf.aux_loss) == 0.0
    assert inf.train_aux is None          # the zero is made only when read
    if p is None:
        assert set(np.unique(inf.quantized.numpy())) <= {-1.0, 1.0}


def test_encode_training_matches_jax():
    """encode(training=True): the straight-through output, aux loss,
    indices and features against JAX's encode on one noised tree."""
    jcfg, tcfg = JVQGANConfig.tiny(), VQGANConfig.tiny()
    tree = _noised(_np_tree(tvq.init_params(_gen(), tcfg, CPU)), 1)
    tree = {k: tree[k] for k in ("clip", "quant_conv")}
    pix = np.random.RandomState(2).randn(2, 28, 28, 3).astype(np.float32)
    jq, jaux, jidx, jfeat = jax.jit(functools.partial(jvq.encode, cfg=jcfg, training=True))(
        _j(tree), pixels=jnp.asarray(pix))
    out = tvq.encode(from_numpy_tree(tree, device=CPU), tcfg, _t(pix), training=True)
    _close(out.feat, jfeat, 1e-4)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(jidx))
    _close(out.quantized, jq, 1e-4)
    _close(out.aux_loss, jaux, 1e-4)


# ---------------------------------------------------------------------------
# The conv encoder
# ---------------------------------------------------------------------------

# tiny: 28 -> 14; attn-odd: 28 -> 14 -> 7 -> 3 (the (0, 1, 0, 1) pad at the
# odd 7), attention at the 7 x 7 level
ENCODERS = {"tiny": {}, "attn-odd": dict(ch_mult=(1, 1, 2, 2), attn_resolutions=(7,))}


@pytest.mark.parametrize("case", ENCODERS, ids=list(ENCODERS))
def test_conv_encoder_matches_jax(case):
    jcfg, tcfg = JVQGANConfig.tiny(**ENCODERS[case]), VQGANConfig.tiny(**ENCODERS[case])
    want_tree = jax.eval_shape(functools.partial(jvq.init_encoder_params, cfg=jcfg),
                               jax.random.PRNGKey(0))
    tree = tvq.init_encoder_params(_gen(), tcfg, device=CPU)
    assert _shapes(tree) == _shapes(want_tree)
    if case == "attn-odd":
        assert len(tree["down"][2]["attn"]) == tcfg.num_res_blocks
    tree = _noised(_np_tree(tree), 3)
    pix = np.random.RandomState(4).randn(2, 28, 28, 3).astype(np.float32)
    want = jax.jit(functools.partial(jvq.encoder_forward, cfg=jcfg))(_j(tree), pixels=jnp.asarray(pix))
    got = tvq.encoder_forward(from_numpy_tree(tree, device=CPU), tcfg, _t(pix))
    assert got.shape == want.shape == (2, 14 if case == "tiny" else 3,
                                       14 if case == "tiny" else 3, tcfg.z_channels)
    _close(got, want)


def test_init_params_draws_no_encoder():
    """init_params keeps its tree and draw order: no conv encoder in it,
    and a seeded tree's encode side is that of a tree without a decoder
    drawn after it."""
    cfg = VQGANConfig.tiny()
    a = tvq.init_params(_gen(5), cfg, CPU)
    assert set(a) == {"clip", "quant_conv", "post_quant_conv", "decoder"}
    from libra_tpu_torch.models import clip as tclip
    g = _gen(5)
    qc = tvq._conv_init(g, 1, 1, cfg.clip_feature_dim, cfg.embed_dim, CPU, torch.float32)
    clip = tclip.init_params(g, cfg.clip, CPU, torch.float32)
    assert torch.equal(a["quant_conv"]["w"], qc["w"])
    for (pa, la), (pb, lb) in zip(_flat(a["clip"]).items(), _flat(clip).items()):
        assert pa == pb and torch.equal(la, lb)


# ---------------------------------------------------------------------------
# VGG16, LPIPS and their converters
# ---------------------------------------------------------------------------

def _lpips_tree(seed=0):
    sd = {k: v.numpy() for k, v in make_lpips_state_dict(seed=seed).items()}
    return sd, _np_tree(tckpt.convert_vgg16_lpips(sd, device=CPU))


def _images(seed, size=32, B=2):
    rs = np.random.RandomState(seed)
    return [np.tanh(rs.randn(B, size, size, 3)).astype(np.float32) for _ in range(2)]


def test_lpips_inits_match_jax_tree():
    want = jax.eval_shape(jvt.init_lpips_params, jax.random.PRNGKey(0))
    got = tvt.init_lpips_params(_gen(), CPU)
    assert _shapes(got) == _shapes(want)
    assert _shapes(tvt.init_vgg16_params(_gen(), CPU)) == _shapes(
        jax.eval_shape(jvt.init_vgg16_params, jax.random.PRNGKey(0)))
    assert all(float(lin["w"].min()) >= 0 for lin in got["lins"])


def test_vgg16_features_and_lpips_match_jax():
    """The five taps (an odd 34 -> 17 -> 8 pool crop included) and the
    distance, on the converted reference weights."""
    _, tree = _lpips_tree()
    x, y = _images(0, size=34)
    jtree = _j(tree)
    want = jax.jit(jvt.vgg16_features)(jtree["vgg"], jnp.asarray(x))
    got = tvt.vgg16_features(from_numpy_tree(tree, device=CPU)["vgg"], _t(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w, 1e-4 * float(np.abs(np.asarray(w)).max()))
    want = jax.jit(jvt.lpips)(jtree, jnp.asarray(x), jnp.asarray(y))
    got = tvt.lpips(from_numpy_tree(tree, device=CPU), _t(x), _t(y))
    _close(got, want)
    assert float(tvt.lpips(from_numpy_tree(tree, device=CPU), _t(x), _t(x))) < 1e-6


def test_lpips_matches_torch_oracle():
    """convert_vgg16_lpips + the port's LPIPS against the reference
    LPIPS.forward on the same named state dict (rtol 2e-4: the reference
    divides by norm + 1e-10, libra_tpu multiplies by rsqrt(sum + 1e-10))."""
    sd, tree = _lpips_tree(1)
    rs = np.random.RandomState(0)
    x = np.tanh(rs.randn(2, 3, 64, 64)).astype(np.float32)
    y = np.tanh(rs.randn(2, 3, 64, 64)).astype(np.float32)
    want = lpips_reference({k: torch.from_numpy(v) for k, v in sd.items()}, x, y)
    got = float(tvt.lpips(from_numpy_tree(tree, device=CPU),
                          _t(x.transpose(0, 2, 3, 1)), _t(y.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_convert_vgg16_lpips_matches_jax_and_both_names():
    """Leaf for leaf JAX's converter; the LPIPS module's slice names give
    the same tree; a missing lin head or conv raises KeyError."""
    sd, tree = _lpips_tree(2)
    want = jckpt.convert_vgg16_lpips(sd)
    for (pg, g), (pw, w) in zip(_flat(tree).items(), _flat(want).items()):
        assert pg == pw
        np.testing.assert_array_equal(g, np.asarray(w))
    renamed = {}
    for k, v in sd.items():
        if k.startswith("features."):
            i = int(k.split(".")[1])
            assert tckpt._lpips_slice_of(i) == jckpt._lpips_slice_of(i)
            k = f"net.slice{tckpt._lpips_slice_of(i)}.{k.split('.', 1)[1]}"
        renamed[k] = v
    for a, b in zip(_flat(tree).values(),
                    _flat(_np_tree(tckpt.convert_vgg16_lpips(renamed, device=CPU))).values()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        tckpt.convert_vgg16_lpips({k: v for k, v in sd.items() if not k.startswith("lin0")},
                                  device=CPU)
    with pytest.raises(KeyError):
        tckpt.convert_vgg16_lpips({k: v for k, v in sd.items()
                                   if not k.startswith("features.28.")}, device=CPU)


def test_load_lpips_params(tmp_path):
    """The two files (torchvision's VGG16 state dict, taming's lin heads)
    load into the converted tree."""
    sd = make_lpips_state_dict(seed=3)
    torch.save({k: v for k, v in sd.items() if k.startswith("features.")}, tmp_path / "vgg16.pth")
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")}, tmp_path / "vgg.pth")
    got = tckpt.load_lpips_params(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"),
                                  device=CPU)
    want = tckpt.convert_vgg16_lpips({k: v.numpy() for k, v in sd.items()}, device=CPU)
    for a, b in zip(_flat(got).values(), _flat(want).values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The discriminator and the losses
# ---------------------------------------------------------------------------

def _disc_tree(seed=4, ndf=8, n_layers=3):
    tree = tvt.init_discriminator_params(_gen(), ndf=ndf, n_layers=n_layers, device=CPU)
    return _noised(_np_tree(tree), seed)


@pytest.mark.parametrize("n_layers", [3, 2])
def test_discriminator_matches_jax(n_layers):
    """The tree (the first layer without BatchNorm) and the logits map:
    pad 1 + VALID, strides 2 then 1, batch-statistics BatchNorm with the
    population variance, LeakyReLU 0.2."""
    want_tree = jax.eval_shape(functools.partial(jvt.init_discriminator_params, ndf=8,
                                                 n_layers=n_layers), jax.random.PRNGKey(0))
    tree = tvt.init_discriminator_params(_gen(), ndf=8, n_layers=n_layers, device=CPU)
    assert _shapes(tree) == _shapes(want_tree)
    assert tree["layers"][0]["bn"] is None
    tree = _disc_tree(5, n_layers=n_layers)
    x = _images(5, size=32)[0] * 3.0
    want = jax.jit(jvt.discriminator_forward)(_j(tree), jnp.asarray(x))
    got = tvt.discriminator_forward(from_numpy_tree(tree, device=CPU), _t(x))
    assert got.shape == want.shape
    _close(got, want)


def test_batch_norm_population_variance():
    x = (np.random.RandomState(6).randn(2, 3, 5, 4) * 2 + 1).astype(np.float32)
    s, b = np.float32([1.0, 2.0, 0.5, -1.0]), np.float32([0.0, 0.1, -0.2, 0.3])
    want = jvt._batch_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _close(tvt._batch_norm(_t(x), _t(s), _t(b)), want)


@pytest.mark.parametrize("fn", ["hinge_d_loss", "vanilla_d_loss"])
def test_d_losses_match_jax(fn):
    rs = np.random.RandomState(7)
    real, fake = (rs.randn(2, 3, 3, 1) * 2).astype(np.float32), rs.randn(2, 3, 3, 1).astype(np.float32)
    _close(getattr(tvt, fn)(_t(real), _t(fake)),
           getattr(jvt, fn)(jnp.asarray(real), jnp.asarray(fake)))
    if fn == "hinge_d_loss":
        two = torch.full((2,), 2.0)
        assert float(tvt.hinge_d_loss(two, -two)) == 0.0
        assert float(tvt.hinge_d_loss(-two, two)) == 3.0


@pytest.mark.parametrize("step", [0, 1, 2, 5])
def test_adopt_weight_matches_jax(step):
    """A host float here, a float32 array there: equal in float32."""
    for kw in ({}, {"value": 0.25}):
        assert np.float32(tvt.adopt_weight(0.7, step, threshold=2, **kw)) == np.asarray(
            jvt.adopt_weight(0.7, step, threshold=2, **kw))


def test_adamw_matches_optax():
    """The trainer's AdamW against libra_tpu's optax.adamw(lr, b1=0.5,
    b2=0.9), at lr 0.1 for 3 steps on a 1-D and a 2-D leaf of large
    weights, fixed gradients (one element 0): weight decay on every leaf,
    the 1-D one too (where the LLM's Optimizer decays only matrices).
    Within 1e-7 of the largest weight; plain Adam's 1-D leaf is over 100
    times that away, so the decay shows."""
    rs = np.random.RandomState(10)
    w0 = {"b": (rs.randn(5) * 40).astype(np.float32), "w": (rs.randn(3, 4) * 40).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in w0.items()} for _ in range(3)]
    grads[0]["b"][2] = 0.0
    want = {}
    for name, opt in (("adamw", optax.adamw(0.1, b1=0.5, b2=0.9)),
                      ("adam", optax.adam(0.1, b1=0.5, b2=0.9))):
        w, state = _j(w0), opt.init(_j(w0))
        for g in grads:
            updates, state = opt.update(_j(g), state, w)
            w = optax.apply_updates(w, updates)
        want[name] = w
    leaves = [_t(w0["b"]).clone(), _t(w0["w"]).clone()]
    adamw = tvt._AdamW(leaves, 0.1)
    for g in grads:
        adamw.step(leaves, [_t(g["b"]), _t(g["w"])])
    for got, k in zip(leaves, ("b", "w")):
        atol = 1e-7 * np.abs(w0[k]).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want["adamw"][k]), rtol=0, atol=atol)
        assert np.abs(got.numpy() - np.asarray(want["adam"][k])).max() > 100 * atol, k


def test_leaves_with_paths_walks_lists_and_skips_none():
    """The trainer's and the LLM optimizer's one tree walker: lists by
    index, None as an empty subtree (the discriminator's first "bn"), a
    QuantizedArray as one leaf; the paths of
    init_discriminator_params' tree as JAX's tree paths name them."""
    q = QuantizedArray(torch.zeros(2, dtype=torch.int8), torch.ones(2))
    tree = {"a": [{"w": 1}, None, {"b": 2}], "c": {"d": q}, "e": None}
    assert list(leaves_with_paths(tree)) == [("a/0/w", 1), ("a/2/b", 2), ("c/d", q)]
    disc = tvt.init_discriminator_params(_gen(), ndf=8, n_layers=2, device=CPU)
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(functools.partial(
        jvt.init_discriminator_params, ndf=8, n_layers=2), jax.random.PRNGKey(0)))[0]
    names = sorted("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
                   for path, _ in want)
    assert sorted(p for p, _ in leaves_with_paths(disc)) == names


def _loss_case(seed=8):
    rs = np.random.RandomState(seed)
    inputs, recons = _images(seed, size=32)
    aux = np.float32(0.37)
    nll_g = rs.randn(3, 3, 8, 3).astype(np.float32)
    g_g = (rs.randn(3, 3, 8, 3) * 0.5).astype(np.float32)
    _, lp = _lpips_tree(seed)
    loss_params = {"lpips": lp, "disc": _disc_tree(seed)}
    return loss_params, inputs, recons, aux, nll_g, g_g


LOSS_CFGS = {"hinge-on": (dict(disc_start=2), 5),
             "hinge-before-start": (dict(disc_start=2), 1),
             "vanilla-weights": (dict(disc_loss="vanilla", disc_weight=0.5, codebook_weight=0.3,
                                      perceptual_weight=0.7, disc_factor=0.8), 0),
             "no-perceptual": (dict(perceptual_weight=0.0), 0)}


@pytest.mark.parametrize("case", LOSS_CFGS, ids=list(LOSS_CFGS))
def test_generator_and_discriminator_loss_match_jax(case):
    """generator_loss (total and logs) and discriminator_loss against
    JAX's on the same inputs; before disc_start the GAN factor is 0."""
    kw, step = LOSS_CFGS[case]
    jcfg, tcfg = jvt.VQGANLossConfig(**kw), tvt.VQGANLossConfig(**kw)
    lp, inputs, recons, aux, nll_g, g_g = _loss_case()
    jargs = (_j(lp), jcfg, jnp.asarray(aux), jnp.asarray(inputs), jnp.asarray(recons),
             step, jnp.asarray(nll_g), jnp.asarray(g_g))
    want, wlogs = jax.jit(jvt.generator_loss, static_argnums=1)(*jargs)
    tlp = from_numpy_tree(lp, device=CPU)
    got, glogs = tvt.generator_loss(tlp, tcfg, _t(aux), _t(inputs), _t(recons), step,
                                    _t(nll_g), _t(g_g))
    _close(got, want)
    assert set(glogs) == set(wlogs)
    for k in wlogs:
        _close(glogs[k], wlogs[k])
    want, wlogs = jax.jit(jvt.discriminator_loss, static_argnums=1)(
        _j(lp), jcfg, jnp.asarray(inputs), jnp.asarray(recons), step)
    got, glogs = tvt.discriminator_loss(tlp, tcfg, _t(inputs), _t(recons), step)
    _close(got, want)
    assert set(glogs) == set(wlogs)
    for k in wlogs:
        _close(glogs[k], wlogs[k])


def test_generator_loss_gradient_matches_jax():
    """The gradient of generator_loss on the reconstruction: back through
    LPIPS's VGG16 (max-pool ties included), the unit normalization and the
    discriminator's batch-statistics BatchNorm."""
    lp, inputs, recons, aux, nll_g, g_g = _loss_case(9)
    jcfg, tcfg = jvt.VQGANLossConfig(), tvt.VQGANLossConfig()

    def jloss(r):
        return jvt.generator_loss(_j(lp), jcfg, jnp.asarray(aux), jnp.asarray(inputs), r, 3,
                                  jnp.asarray(nll_g), jnp.asarray(g_g))[0]

    want = jax.jit(jax.grad(jloss))(jnp.asarray(recons))
    r = _t(recons).requires_grad_(True)
    tvt.generator_loss(from_numpy_tree(lp, device=CPU), tcfg, _t(aux), _t(inputs), r, 3,
                       _t(nll_g), _t(g_g))[0].backward()
    _close(r.grad, want, 1e-5 * float(np.abs(np.asarray(want)).max()) + 1e-7)
