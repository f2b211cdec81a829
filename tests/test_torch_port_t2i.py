"""The port's text-to-image path against libra_tpu, at a tiny size in fp32
on the CPU: ops/conv (conv2d, group_norm, swish, avg_pool2 and
nearest_upsample's source rows), LFQ's code lookup (full_codebook,
indices_to_codes, the project_in / project_out branch), the VQGAN conv
decoder (init_decoder_params' tree, decoder_forward, decode_code), the
tokenizers' decode side, t2i_prompt and LibraPipeline.generate_image in
the plain, int8 and int4 trees (equal block tokens, pixels within 1e-5)
and a sampled call.

One parameter tree for both packages: for the VQGAN, the port's
init_params (its tree equals JAX's, test_init_decoder_params_tree_matches;
JAX's init takes seconds to compile) with every leaf noised, so that no
swapped pair of leaves could pass; for the decoder, JAX's init with the
bridge B-weights filled with N(0, 0.02) noise (quantized by JAX for the
int8 and int4 trees); numpy arrays, carried across with from_numpy_tree.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import pipeline as jpipeline
from libra_tpu import quantization as jq
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.models import lfq as jlfq, libra as JM, vqgan as jvqgan
from libra_tpu.ops import conv as jconv
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu.tokenization import LibraTokenizer as JLibraTokenizer
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTextTokenizer
from libra_tpu_torch import pipeline as tpipeline
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import lfq as tlfq, vqgan as tvqgan
from libra_tpu_torch.ops import conv as tconv
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.tokenization import (IMG_PH, ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)

TOL = 1e-5
BRIDGES = ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis")
# level 1 upsamples 8 -> 28 (a scale of 3.5), level 2 carries attention at
# 4 x 4, and the latent goes through first_norm
FRACTIONAL = dict(initial_resolution=4, ch_mult=(1, 2, 2), attn_resolutions=(4,),
                  norm_first=True, num_res_blocks=1)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np_tree(tree):
    """A tree of JAX arrays or of tensors (dicts and lists) as numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.array(tree)


def _flat_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree.shape)}


def _noised(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (x + rs.normal(0.0, 0.05, x.shape)).astype(x.dtype), tree)


# ---------------------------------------------------------------------------
# ops/conv
# ---------------------------------------------------------------------------

CONV_CASES = {
    "same-3x3": dict(shape=(2, 7, 5, 6), k=3, cout=10, stride=1, padding="SAME"),
    "valid-3x3": dict(shape=(2, 7, 5, 6), k=3, cout=10, stride=1, padding="VALID"),
    "same-stride2": dict(shape=(1, 8, 7, 4), k=3, cout=6, stride=2, padding="SAME"),
    "valid-stride2": dict(shape=(1, 9, 8, 4), k=3, cout=6, stride=2, padding="VALID"),
    "1x1": dict(shape=(2, 4, 3, 6), k=1, cout=5, stride=1, padding="SAME"),
}


@pytest.mark.parametrize("case", CONV_CASES, ids=list(CONV_CASES))
def test_conv2d_matches_jax(case):
    """Non-square inputs and Cin != Cout, so a swapped axis cannot pass."""
    c = CONV_CASES[case]
    rs = np.random.RandomState(0)
    x = rs.randn(*c["shape"]).astype(np.float32)
    w = rs.randn(c["k"], c["k"], c["shape"][-1], c["cout"]).astype(np.float32)
    b = rs.randn(c["cout"]).astype(np.float32)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride=c["stride"], padding=c["padding"])
    got = tconv.conv2d(_t(x), _t(w), _t(b), stride=c["stride"], padding=c["padding"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("channels", [64, 24], ids=["32-groups", "gcd-groups"])
def test_group_norm_matches_jax(channels):
    """32 groups, and gcd(32, 24) = 8 groups; the population variance."""
    rs = np.random.RandomState(1)
    x = (rs.randn(2, 5, 3, channels) * 3 + 1).astype(np.float32)
    scale = rs.randn(channels).astype(np.float32)
    bias = rs.randn(channels).astype(np.float32)
    want = jconv.group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = tconv.group_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_swish_and_avg_pool2_match_jax():
    x = np.random.RandomState(2).randn(2, 6, 4, 3).astype(np.float32)
    np.testing.assert_allclose(tconv.swish(_t(x)).numpy(),
                               np.asarray(jconv.swish(jnp.asarray(x))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tconv.avg_pool2(_t(x)).numpy(),
                               np.asarray(jconv.avg_pool2(jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


def test_nearest_upsample_indices_match_jax_on_the_default_plan():
    """The source rows of every upsampling of the default decoder plan
    (24 -> 48 -> 96 -> 192 -> 336, the last at a scale of 1.75), equal to
    JAX's exactly: JAX's nearest_upsample on an arange gives its rows."""
    levels, _ = tvqgan.decoder_plan(VQGANConfig())
    n, pairs = VQGANConfig().initial_resolution, []
    for lev in levels:
        if lev["up_scale"] is not None:
            pairs.append((n, int(n * lev["up_scale"])))
            n = pairs[-1][1]
    assert pairs == [(24, 48), (48, 96), (96, 192), (192, 336)]
    for n_in, n_out in pairs:
        src = jnp.arange(n_in, dtype=jnp.float32).reshape(1, n_in, 1, 1)
        want = np.asarray(jconv.nearest_upsample(src, n_out / n_in))[0, :, 0, 0]
        got = tconv.upsample_indices(n_in, n_out).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("scale", [2.0, 1.75, 3.5])
def test_nearest_upsample_matches_jax(scale):
    x = np.random.RandomState(3).randn(1, 8, 4, 3).astype(np.float32)
    want = jconv.nearest_upsample(jnp.asarray(x), scale)
    got = tconv.nearest_upsample(_t(x), scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# LFQ
# ---------------------------------------------------------------------------

def _lfq_specs(dim):
    return (jlfq.LFQSpec(codebook_size=16, num_codebooks=2, dim=dim),
            tlfq.LFQSpec(codebook_size=16, num_codebooks=2, dim=dim))


def _projections(dim, seed=4):
    rs = np.random.RandomState(seed)
    return {"project_in": {"w": rs.randn(dim, 8).astype(np.float32),
                           "b": rs.randn(8).astype(np.float32)},
            "project_out": {"w": rs.randn(8, dim).astype(np.float32),
                            "b": rs.randn(dim).astype(np.float32)}}


def test_full_codebook_matches_jax():
    jspec, tspec = _lfq_specs(8)
    np.testing.assert_array_equal(tlfq.full_codebook(tspec).numpy(),
                                  np.asarray(jlfq.full_codebook(jspec)))


@pytest.mark.parametrize("dim", [8, 6], ids=["identity", "projections"])
def test_indices_to_codes_matches_jax(dim):
    jspec, tspec = _lfq_specs(dim)
    idx = np.random.RandomState(5).randint(0, 16, (3, 4, 2))
    p = _projections(dim) if dim != 8 else None
    want = jlfq.indices_to_codes(jnp.asarray(idx), jspec,
                                 None if p is None else jax.tree_util.tree_map(jnp.asarray, p))
    got = tlfq.indices_to_codes(_t(idx), tspec,
                                None if p is None else from_numpy_tree(p, device="cpu"))
    assert got.shape == (3, 4, dim)
    if p is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dim", [8, 6], ids=["identity", "projections"])
def test_quantize_round_trip_matches_jax(dim):
    """quantize -> indices -> codes: the indices equal JAX's, and the
    codes of the indices equal quantize's output."""
    jspec, tspec = _lfq_specs(dim)
    x = np.random.RandomState(6).randn(2, 3, 3, dim).astype(np.float32)
    p = _projections(dim) if dim != 8 else None
    jp = None if p is None else jax.tree_util.tree_map(jnp.asarray, p)
    tp = None if p is None else from_numpy_tree(p, device="cpu")
    want = jlfq.quantize(jnp.asarray(x), jspec, jp)
    got = tlfq.quantize(_t(x), tspec, tp)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tlfq.indices_to_codes(got.indices, tspec, tp).numpy(),
                               got.quantized.numpy(), rtol=TOL, atol=TOL)
    if p is not None:
        with pytest.raises(ValueError, match="project_in"):
            tlfq.quantize(_t(x), tspec)


# ---------------------------------------------------------------------------
# VQGAN decoder
# ---------------------------------------------------------------------------

VQ_CASES = {"tiny": {}, "fractional-attn-norm-first": FRACTIONAL}


@functools.lru_cache(maxsize=None)
def _vq(case):
    """(JAX config, port config, the noised numpy VQGAN tree)."""
    kw = VQ_CASES[case]
    tvq = VQGANConfig.tiny(**kw)
    tree = tvqgan.init_params(torch.Generator().manual_seed(1), tvq, device="cpu")
    return JVQGANConfig.tiny(**kw), tvq, _noised(_np_tree(tree), 7)


@functools.lru_cache(maxsize=None)
def _vq_case(case):
    """The decoder tests' inputs and JAX's outputs, from one compiled
    function: a non-square latent z (h != w) through decoder_forward, and
    square-grid indices through decode_code."""
    jvq, tvq, tree = _vq(case)
    g = jvq.initial_resolution
    rs = np.random.RandomState(8)
    z = rs.randn(2, g, g + 1, jvq.z_channels).astype(np.float32)
    idx = rs.randint(0, jvq.codebook_size, (2, g, g, jvq.num_codebook))
    want = jax.jit(lambda p, z, i: (jvqgan.decoder_forward(p["decoder"], jvq, z),
                                    jvqgan.decode_code(p, jvq, i)))(tree, z, idx)
    return tvq, from_numpy_tree(tree, device="cpu"), z, idx, [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", ["tiny", "fractional-attn-norm-first", "default"])
def test_init_decoder_params_tree_matches(case):
    """Key paths and shapes of init_decoder_params and init_params, the
    default (libra-11b) config's by JAX's eval_shape against the port's
    on the meta device."""
    kw = VQ_CASES.get(case)
    jvq = JVQGANConfig() if kw is None else JVQGANConfig.tiny(**kw)
    tvq = VQGANConfig() if kw is None else VQGANConfig.tiny(**kw)
    want = jax.eval_shape(lambda: jvqgan.init_params(jax.random.PRNGKey(0), jvq))
    if kw is None:
        with torch.device("meta"):
            got = tvqgan.init_decoder_params(None, tvq, device="meta")
        assert _flat_shapes(got) == _flat_shapes(want["decoder"])
        return
    g = torch.Generator().manual_seed(0)
    assert _flat_shapes(tvqgan.init_decoder_params(g, tvq, device="cpu")) == \
        _flat_shapes(want["decoder"])
    assert _flat_shapes(tvqgan.init_params(g, tvq, device="cpu")) == _flat_shapes(want)


@pytest.mark.parametrize("case", list(VQ_CASES))
def test_decoder_forward_matches_jax(case):
    """A non-square latent (h != w)."""
    tvq, tree, z, _, (want, _) = _vq_case(case)
    got = tvqgan.decoder_forward(tree["decoder"], tvq, _t(z))
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("case", list(VQ_CASES))
def test_decode_code_matches_jax(case):
    tvq, tree, _, idx, (_, want) = _vq_case(case)
    got = tvqgan.decode_code(tree, tvq, _t(idx))
    assert got.shape == (2, tvq.resolution, tvq.resolution, tvq.out_ch)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL


# ---------------------------------------------------------------------------
# Tokenizers, decode side
# ---------------------------------------------------------------------------

def _make_tokenizers():
    """(JAX, port) LibraTokenizers on tiny configs sharing the VQGAN tree
    (each text tokenizer numbers words as it first sees them, so a pair
    stays in step only if it sees the same texts)."""
    jcfg = JLibraConfig.tiny()
    jvq, tvq, tree = _vq("tiny")
    Mv = jcfg.max_vision_token_length
    jtok = JLibraTokenizer(JSimpleTextTokenizer(vocab_size=jcfg.vocab_size),
                           JImageTokenizer(jvq, tree, jcfg.vocab_size, Mv))
    ttok = LibraTokenizer(SimpleTextTokenizer(vocab_size=jcfg.vocab_size),
                          ImageTokenizer(tvq, from_numpy_tree(tree, device="cpu"),
                                         jcfg.vocab_size, Mv))
    return jtok, ttok


# one pair for the tokenizer tests, one for every pipeline (which all see
# the one caption, so their pair stays in step)
_tokenizers = functools.lru_cache(maxsize=None)(_make_tokenizers)
_pipeline_tokenizers = functools.lru_cache(maxsize=None)(_make_tokenizers)


def _block(img_tok, seed, framed=True):
    """(Q, Mv) or (Q, Mv - 2) seeded image ids, offset, optionally framed."""
    Q, g2 = img_tok.num_codebook, img_tok.max_vision_token_length - 2
    ids = np.random.RandomState(seed).randint(0, img_tok.cfg.codebook_size, (Q, g2))
    ids = ids + img_tok.offset
    if not framed:
        return ids
    return np.concatenate([np.full((Q, 1), img_tok.boi_token_id), ids,
                           np.full((Q, 1), img_tok.eoi_token_id)], axis=1)


@pytest.mark.parametrize("form", ["lists", "single-QN", "unframed"])
def test_image_tokenizer_decode_matches_jax(form):
    jtok, ttok = _tokenizers()
    img = ttok.image_tokenizer
    blocks = [_block(img, 10, form != "unframed"), _block(img, 11, form != "unframed")]
    ids = blocks[0] if form == "single-QN" else [b.tolist() for b in blocks]
    want = np.asarray(jtok.image_tokenizer.decode(ids))
    got = img.decode(ids)
    assert got.shape == want.shape == ((1 if form == "single-QN" else 2), 28, 28, 3)
    assert _rel(got.numpy(), want) < TOL
    assert img.decode([]) is None and img.decode(None) is None
    with pytest.raises(ValueError, match="square"):
        img.decode(_block(img, 12, False)[:, :-1])


def test_decode_roundtrip_text_and_image_matches_jax():
    """Mirrors test_tokenizer_generation's round trip: tokenize text with
    an image block, then batch_decode; the text and the pixels equal
    JAX's (the last id is dropped, as the reference drops a trailing EOS,
    so the text ends in a sacrificial token)."""
    jtok, ttok = _tokenizers()
    img = np.random.RandomState(2).randn(28, 28, 3).astype(np.float32)
    Mv = ttok.image_tokenizer.max_vision_token_length
    sample = [{"language": [" ".join([IMG_PH] * Mv) + " hello world </s>"],
               "vision": [img]}]
    want = jtok.batch_decode(jtok(sample)["input_ids"])
    got = ttok.batch_decode(ttok(sample)["input_ids"])
    assert len(got) == len(want) == 1
    assert got[0]["language"] == want[0]["language"]
    assert "hello world" in got[0]["language"]
    assert _rel(got[0]["vision"].numpy(), want[0]["vision"]) < TOL
    # a row with no image decodes to text alone
    text_only = ttok.batch_decode(np.asarray(ttok([{"language": ["a b c"]}])["input_ids"]))
    assert text_only[0]["vision"] is None


@pytest.mark.parametrize("bad,match", [("incomplete", "Incomplete images"),
                                       ("eoi-first", "EOI occurs before BOI")])
def test_decode_errors_match_jax(bad, match):
    jtok, ttok = _tokenizers()
    img = ttok.image_tokenizer
    row = np.concatenate([[5, 6], _block(img, 13)[0], [7]])
    if bad == "incomplete":
        row = row[:-3]                      # the EOI cut off
    else:
        b, e = 2, 2 + img.max_vision_token_length - 1
        row[b], row[e] = row[e], row[b]     # EOI before BOI
    ids = np.stack([row] * img.num_codebook)
    for tok in (jtok, ttok):
        with pytest.raises(ValueError, match=match):
            tok.decode(ids)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

def test_t2i_prompt_matches_jax():
    for caption in ("a cat", "  a watercolor fox \n", ""):
        assert tpipeline.t2i_prompt(caption) == jpipeline.t2i_prompt(caption)
    assert tpipeline.t2i_prompt("a cat").endswith("<img_gen>")


@functools.lru_cache(maxsize=None)
def _libra_tree():
    """JAX's tiny decoder tree as numpy, the bridges' B-weights noised."""
    p = _np_tree(jax.jit(functools.partial(JM.init_params, cfg=JLibraConfig.tiny()))(
        jax.random.PRNGKey(0)))
    rs = np.random.RandomState(100)
    for name in BRIDGES:
        wb = p["layers"]["attn"][name]["wb"]
        wb[...] = rs.normal(0.0, 0.02, wb.shape)
    return p


@functools.lru_cache(maxsize=None)
def _pipelines(bits):
    """(JAX, port) LibraPipelines on one tree (quantized by JAX for bits 8
    and 4), each recording its Generator's results."""
    jcfg, p = JLibraConfig.tiny(), _libra_tree()
    if bits:
        p = jq.quantize_params(p, min_elems=64, bits=bits, group=64)
    jtok, ttok = _pipeline_tokenizers()
    want = jpipeline.LibraPipeline(jcfg, p, jtok, image_processor=lambda im: im)
    got = tpipeline.LibraPipeline(LibraConfig.tiny(), from_numpy_tree(p, device="cpu"),
                                  ttok, lambda im: im)
    for pipe in (want, got):
        gen, pipe.results = pipe.generator, []
        pipe.generator = (lambda g, sink: lambda *a, **k: sink.append(g(*a, **k))
                          or sink[-1])(gen, pipe.results)
    return want, got


CAPTION = "a tiny cat"


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["plain", "int8", "int4"])
def test_generate_image_greedy_matches_jax(bits):
    """Mirrors test_pipeline's test_generate_image: equal tokens over the
    whole call (the block and the forced newline after it), pixels within
    1e-5 relative L2."""
    want_p, got_p = _pipelines(bits)
    want = want_p.generate_image(CAPTION, temperature=0.0)
    got = got_p.generate_image(CAPTION, temperature=0.0)
    np.testing.assert_array_equal(got_p.results[-1].sequences.numpy(),
                                  np.asarray(want_p.results[-1].sequences))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == np.asarray(want).shape == (28, 28, 3)
    assert _rel(got, want) < TOL
    cfg = got_p.cfg
    seq = got_p.results[-1].sequences[:, 0]
    Mv, N = cfg.max_vision_token_length, seq.shape[-1] - cfg.max_vision_token_length
    img = got_p.tokenizer.image_tokenizer
    assert bool((seq[:, N - 1] == img.boi_token_id).all())
    assert bool((seq[:, N:N + Mv - 1] >= cfg.vocab_size).all())
    assert bool((seq[:, N + Mv - 1] == cfg.newline_token_id).all())


def test_generate_image_sampled():
    """Top-k sampling: without a generator, seed 0 on the pipeline's
    device, so the same tokens and pixels as a seed-0 torch.Generator's; a
    block of vision ids, pixels of the decoder's shape."""
    _, pipe = _pipelines(0)
    cfg = pipe.cfg
    img = pipe.generate_image(CAPTION, top_k=5)
    seq = pipe.results[-1].sequences
    np.testing.assert_array_equal(
        img, pipe.generate_image(CAPTION, top_k=5, generator=torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(seq.numpy(), pipe.results[-1].sequences.numpy())
    assert img.shape == (28, 28, 3) and np.isfinite(img).all()
    Mv = cfg.max_vision_token_length
    block = seq[:, 0, -Mv:-1]
    assert bool(((block >= cfg.vocab_size)
                 & (block < cfg.vocab_size + cfg.vision_vocab_size)).all())
