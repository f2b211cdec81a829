"""The port's image side against libra_tpu's: CLIP features (atol 1e-4,
fp32 through a few transformer layers), LFQ indices (exact), the image
processors, the joint tokenizer and the prompt templates."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.data import conversation as jconv
from libra_tpu.data.processors import (
    LibraEvalImageProcessor as JEvalProcessor)
from libra_tpu.models import clip as jclip, vqgan as jvqgan
from libra_tpu.ops.conv import conv2d
from libra_tpu.pipeline import process_prompt as jprocess_prompt
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu.tokenization import LibraTokenizer as JLibraTokenizer
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu.training.fused import maybe_normalize_pixels as jnormalize
from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.data import conversation as tconv
from libra_tpu_torch.data.processors import LibraEvalImageProcessor
from libra_tpu_torch.models import vqgan as tvqgan
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.pipeline import process_prompt
from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from libra_tpu_torch.training.fused import maybe_normalize_pixels


def _vq(select_layer):
    kw = dict(select_layer=select_layer)
    return JVQGANConfig.tiny(**kw), VQGANConfig.tiny(**kw)


def _vq_params(jcfg, seed=1):
    """The encode side's tree (CLIP + quant_conv): JAX's CLIP init, numpy
    quant_conv (the conv decoder's eager init would dominate the test)."""
    clip = jax.jit(functools.partial(jclip.init_params, cfg=jcfg.clip))(
        jax.random.PRNGKey(seed))
    cin = jcfg.clip_feature_dim
    w = np.random.RandomState(seed).randn(1, 1, cin, jcfg.embed_dim)
    return {"clip": jax.tree_util.tree_map(np.asarray, clip),
            "quant_conv": {"w": (w * cin ** -0.5).astype(np.float32),
                           "b": np.zeros((jcfg.embed_dim,), np.float32)}}


def _pixels(B=3, S=28, seed=0):
    return np.random.RandomState(seed).randn(B, S, S, 3).astype(np.float32)


@pytest.mark.parametrize("select_layer", [-2, (-2, -1)])
def test_vqgan_encode_matches(select_layer):
    jcfg, tcfg = _vq(select_layer)
    np_params = _vq_params(jcfg)
    pix = _pixels()
    jq, _, jidx, jfeat = jax.jit(functools.partial(jvqgan.encode, cfg=jcfg))(
        np_params, pixels=jnp.asarray(pix))
    # LFQ takes signs: no pre-quant value may sit within rounding of 0
    pre = conv2d(jfeat, **jax.tree_util.tree_map(jnp.asarray,
                                                 np_params["quant_conv"]))
    assert float(jnp.min(jnp.abs(pre))) > 1e-5
    out = tvqgan.encode(from_numpy_tree(np_params, device="cpu"), tcfg, torch.from_numpy(pix))
    np.testing.assert_allclose(out.feat.numpy(), np.asarray(jfeat),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(out.quantized.numpy(), np.asarray(jq))


def test_image_processors_match():
    img = Image.fromarray(np.random.RandomState(2).randint(
        0, 255, (40, 30, 3), np.uint8))
    clip = JVQGANConfig.tiny().clip
    from libra_tpu_torch.config import CLIPVisionConfig
    want = JEvalProcessor(clip)(img)
    got = LibraEvalImageProcessor(CLIPVisionConfig.tiny())(img)
    np.testing.assert_array_equal(got, want)


def test_maybe_normalize_pixels_matches():
    u8 = np.random.RandomState(3).randint(0, 256, (2, 28, 28, 3), np.uint8)
    jcfg, tcfg = _vq(-2)
    want = jnormalize(jcfg, jnp.asarray(u8))
    got = maybe_normalize_pixels(tcfg, torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    f = torch.zeros(2, 3)
    assert maybe_normalize_pixels(tcfg, f) is f


def _tokenizers(jcfg_vq, tcfg_vq, np_params, cfg):
    jtok = JLibraTokenizer(
        JSimpleTok(vocab_size=cfg.vocab_size),
        JImageTokenizer(jcfg_vq, np_params, token_offset=cfg.vocab_size,
                        max_vision_token_length=cfg.max_vision_token_length))
    ttok = LibraTokenizer(
        SimpleTextTokenizer(vocab_size=cfg.vocab_size),
        ImageTokenizer(tcfg_vq, from_numpy_tree(np_params, device="cpu"), cfg.vocab_size,
                       cfg.max_vision_token_length))
    return jtok, ttok


@pytest.mark.parametrize("with_images", [True, False])
def test_libra_tokenizer_matches(with_images):
    cfg = JLibraConfig.tiny()
    jcfg_vq, tcfg_vq = _vq(-2)
    np_params = _vq_params(jcfg_vq)
    jtok, ttok = _tokenizers(jcfg_vq, tcfg_vq, np_params, cfg)
    Mv = cfg.max_vision_token_length
    qs = ["what is this?", "describe the picture in detail please"]
    prompts = [jprocess_prompt(q, Mv, with_image=with_images) for q in qs]
    sample = {"language": prompts}
    if with_images:
        sample["vision"] = list(_pixels(B=2, seed=4))
    for tok in (jtok.text_tokenizer, ttok.text_tokenizer):
        tok.padding_side = "left"
    want = jtok([sample])
    got = ttok([sample])
    for key in ("input_ids", "attention_mask", "vision_indices"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    if with_images:
        np.testing.assert_allclose(got["coninous_signal"].numpy(),
                                   want["coninous_signal"], rtol=0, atol=1e-4)
    else:
        assert got["coninous_signal"] is None and want["coninous_signal"] is None


@pytest.mark.parametrize("template", sorted(jconv.conv_templates))
def test_prompt_templates_match(template):
    for with_image in (True, False):
        hist = [{"role": "user", "content": "and then?"},
                {"role": "assistant", "content": "a cat."}]
        for history in (None, hist):
            assert process_prompt("what?", 6, template, with_image, history) \
                == jprocess_prompt("what?", 6, template, with_image, history)
    tc = tconv.conv_templates[template].copy()
    jc = jconv.conv_templates[template].copy()
    for c in (tc, jc):   # an image-carrying first message (the demo UI form)
        c.append_message(c.roles[0], ("<image>\nhello", None, "pad"))
        c.append_message(c.roles[1], None)
    assert tc.get_prompt() == jc.get_prompt()
