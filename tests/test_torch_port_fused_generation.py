"""The port's fused-pixels Generator against libra_tpu, at a tiny size in
fp32 on the CPU: raw pixels and img_start go through CLIP + LFQ inside
the prompt pass, the language projections run on the text rows only
(split_prefill, on by default), then the cached decode. Held to equal
greedy tokens: against JAX's fused Generator (a plain tree, and int8 /
int4 trees with the int8 cache and the w8a8 prompt pass), against the
port's pre-encoded path, uint8 against pre-normalized pixels, with the
two-tap CLIP signal and with prompt_bucket. Also GenerationConfig's
fields, attn_impl and the logits processors against JAX's.

One parameter tree for both packages: JAX's init_params with the bridge
B-weights filled with N(0, 0.02) noise (quantized by JAX for the int8 and
int4 trees), and the encode side's tree (JAX's CLIP init, a numpy
quant_conv), carried across with from_numpy_tree.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import generation as jgen
from libra_tpu import quantization as jq
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.logits_processors import (no_newline_processor as jno_newline,
                                         valid_image_processor as jvalid_image)
from libra_tpu.models import clip as jclip, libra as JM
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.logits_processors import (no_newline_processor,
                                               valid_image_processor)
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.tokenization import (IMG_PH, ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from libra_tpu_torch.training.fused import resolve_attn_impl

BRIDGES = ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis")
KW128 = dict(hidden_size=256, num_attention_heads=2, intermediate_size=256)
MAX_NEW = 5


@functools.lru_cache(maxsize=None)
def _trees(kw_items, bits):
    """(JAX config, numpy tree with live bridges; quantized by JAX when
    bits is 8 or 4)."""
    jcfg = JLibraConfig.tiny(**dict(kw_items))
    p = jax.tree_util.tree_map(np.array, jax.jit(
        functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(100)
    for name in BRIDGES:
        wb = p["layers"]["attn"][name]["wb"]
        wb[...] = rs.normal(0.0, 0.02, wb.shape)
    if bits:
        p = jq.quantize_params(p, min_elems=64, bits=bits, group=64)
    return jcfg, p


@functools.lru_cache(maxsize=None)
def _vq_tree(select_layer=-2, seed=1):
    """(JAX VQGAN config, the encode side's numpy tree)."""
    jvq = JVQGANConfig.tiny(select_layer=select_layer)
    clip = jax.jit(functools.partial(jclip.init_params, cfg=jvq.clip))(
        jax.random.PRNGKey(seed))
    cin = jvq.clip_feature_dim
    w = np.random.RandomState(seed).randn(1, 1, cin, jvq.embed_dim)
    return jvq, {"clip": jax.tree_util.tree_map(np.asarray, clip),
                 "quant_conv": {"w": (w * cin ** -0.5).astype(np.float32),
                                "b": np.zeros((jvq.embed_dim,), np.float32)}}


def _generators(kw=(), bits=0, select_layer=-2):
    """The JAX and the port fused Generators on one tree."""
    jcfg, tree = _trees(tuple(sorted(dict(kw).items())), bits)
    jvq, vq_tree = _vq_tree(select_layer)
    cfg = LibraConfig.tiny(**dict(kw))
    want = jgen.Generator(tree, jcfg, vq_params=vq_tree, vq_cfg=jvq)
    got = tgen.Generator(from_numpy_tree(tree, device="cpu"), cfg,
                         vq_params=from_numpy_tree(vq_tree, device="cpu"),
                         vq_cfg=VQGANConfig.tiny(select_layer=select_layer))
    return cfg, want, got


def _fused_inputs(cfg, starts=(2, 4), text_len=6, seed=2, uint8=False):
    """Rows of text with one image block at starts[b] (its ids random
    placeholders, overwritten by the encode), row 1 left-padded by one;
    the prompts end in text. Seeded pixels, uint8 or normalized float."""
    Mv = cfg.max_vision_token_length
    B, N = len(starts), text_len + Mv
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, cfg.vocab_size, size=(cfg.vision_codebook_num, B, N))
    vi = np.full((B, N), Mv, np.int64)
    mask = np.ones((B, N), np.int64)
    for b, s in enumerate(starts):
        vi[b, s:s + Mv] = np.arange(Mv)
    mask[1, :1] = 0
    size = VQGANConfig.tiny().clip.image_size
    pixels = (rs.randint(0, 256, (B, size, size, 3)).astype(np.uint8) if uint8
              else rs.randn(B, size, size, 3).astype(np.float32))
    return {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
            "pixels": pixels, "img_start": np.asarray(starts, np.int32)}


def _assert_same(got, want):
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))


GEN_CASES = [
    ((), 0, {}),
    (KW128, 8, dict(kv_quant=True, a8_prefill=True, decode_modality="text")),
    (KW128, 4, dict(kv_quant=True, a8_prefill=True, decode_modality="text")),
]


@pytest.mark.parametrize("kw,bits,gen_kw", GEN_CASES,
                         ids=["plain", "int8-kv8-a8", "int4-kv8-a8"])
def test_fused_generator_matches_jax(kw, bits, gen_kw):
    """Equal greedy tokens, the image ids written by the encode included;
    the int8 cache's tiny config has head dim 128, so its decode steps
    take the decode kernel's branch (its plain version here)."""
    cfg, want_g, got_g = _generators(kw, bits)
    inputs = _fused_inputs(cfg)
    gen = dict(max_new_tokens=MAX_NEW, eos_token_id=-1, **gen_kw)
    want = want_g(inputs, jgen.GenerationConfig(**gen))
    got = got_g(inputs, tgen.GenerationConfig(**gen))
    _assert_same(got, want)
    Mv = cfg.max_vision_token_length
    block = got.sequences[:, 0, 2:2 + Mv]
    assert bool((block >= cfg.vocab_size).all())


def test_fused_matches_preencoded():
    """Raw pixels through the fused prompt pass (split on) give the tokens
    of the same images tokenized ahead by the port's LibraTokenizer."""
    cfg, _, g = _generators()
    Mv = cfg.max_vision_token_length
    rs = np.random.RandomState(0)
    imgs = rs.randn(2, 28, 28, 3).astype(np.float32)
    prompt = " ".join([IMG_PH] * Mv) + " describe:"
    text_tok = SimpleTextTokenizer(vocab_size=cfg.vocab_size)
    joint = LibraTokenizer(text_tok, ImageTokenizer(
        VQGANConfig.tiny(), g.vq_params, cfg.vocab_size, Mv))
    gen = tgen.GenerationConfig(max_new_tokens=MAX_NEW, eos_token_id=-1)
    pre = tgen.Generator(g.params, cfg)(
        joint([{"language": [prompt, prompt], "vision": list(imgs)}]), gen)

    t = text_tok([prompt, prompt])
    ids = np.asarray(t["input_ids"], np.int64)
    pos = int(np.nonzero(ids[0] == text_tok.img_ph_token_id)[0][0])
    vi = np.full(ids.shape, Mv, np.int64)
    vi[:, pos:pos + Mv] = np.arange(Mv)
    fused = g({"input_ids": np.broadcast_to(ids[None], (cfg.vision_codebook_num,)
                                            + ids.shape),
               "attention_mask": np.asarray(t["attention_mask"]),
               "vision_indices": vi, "pixels": imgs,
               "img_start": np.asarray([pos, pos])}, gen)
    np.testing.assert_array_equal(fused.sequences.numpy(), pre.sequences.numpy())


def test_uint8_pixels_match_prenormalized():
    """uint8 pixels are normalized on the device with the host processor's
    fp32 math: the same tokens as pre-normalized float32 pixels, and as
    JAX's fused Generator on the uint8 pixels."""
    cfg, want_g, g = _generators()
    vq = VQGANConfig.tiny()
    inputs = _fused_inputs(cfg, uint8=True)
    mean = np.asarray(vq.clip.image_mean, np.float32)
    std = np.asarray(vq.clip.image_std, np.float32)
    f32 = (inputs["pixels"].astype(np.float32) / 255.0 - mean) / std
    gen = dict(max_new_tokens=MAX_NEW, eos_token_id=-1)
    res_u8 = g(inputs, tgen.GenerationConfig(**gen))
    res_f32 = g(dict(inputs, pixels=f32), tgen.GenerationConfig(**gen))
    np.testing.assert_array_equal(res_u8.sequences.numpy(), res_f32.sequences.numpy())
    _assert_same(res_u8, want_g(inputs, jgen.GenerationConfig(**gen)))


def test_two_tap_clip_signal_matches_jax():
    """The continuous signal as two CLIP taps concatenated (the flagship's
    select_layer=(-2, -1)): equal tokens to JAX's."""
    vq = VQGANConfig.tiny(select_layer=(-2, -1))
    kw = (("contiguous_signal_size", vq.clip_feature_dim),)
    cfg, want_g, got_g = _generators(kw, select_layer=(-2, -1))
    assert cfg.contiguous_signal_size == 2 * vq.clip.hidden_size
    inputs = _fused_inputs(cfg)
    gen = dict(max_new_tokens=MAX_NEW, eos_token_id=-1)
    got = got_g(inputs, tgen.GenerationConfig(**gen))
    _assert_same(got, want_g(inputs, jgen.GenerationConfig(**gen)))
    assert got.sequences.shape[-1] == inputs["input_ids"].shape[-1] + MAX_NEW


def test_prompt_bucket_shifts_img_start():
    """Left padding to a bucket moves the image block: img_start shifts
    with it, so the tokens are JAX's under the same bucket and the
    unbucketed run's behind the pad."""
    cfg, want_g, g = _generators()
    inputs = _fused_inputs(cfg)
    N = inputs["input_ids"].shape[-1]
    gen = dict(max_new_tokens=MAX_NEW, eos_token_id=-1)
    bucket = tgen.GenerationConfig(prompt_bucket=16, **gen)
    got = g(inputs, bucket)
    _assert_same(got, want_g(inputs, jgen.GenerationConfig(prompt_bucket=16, **gen)))
    plain = g(inputs, tgen.GenerationConfig(**gen))
    pad = 16 - N
    np.testing.assert_array_equal(got.sequences[:, :, pad:].numpy(),
                                  plain.sequences.numpy())


def test_pixels_without_vq_params_raise():
    cfg, _, g = _generators()
    with pytest.raises(ValueError, match="vq_params"):
        tgen.Generator(g.params, cfg)(_fused_inputs(cfg), tgen.GenerationConfig(
            max_new_tokens=2))


def test_attn_impl(monkeypatch):
    """"auto" takes the flash wrapper for CUDA inputs and the plain
    attention on the CPU; "plain" and "flash" (its plain version here)
    agree on the CPU; an unknown value raises."""
    assert resolve_attn_impl("auto", torch.device("cuda", 0)) == "flash"
    assert resolve_attn_impl("auto", torch.device("cpu")) == "plain"
    cfg, _, g = _generators()
    inputs = _fused_inputs(cfg)
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    args = (t["input_ids"].long(), t["attention_mask"], t["vision_indices"].long(),
            None, g.vq_params, t["pixels"], t["img_start"].long())
    calls = []
    real = TM.flash_bridged_attention
    monkeypatch.setattr(TM, "flash_bridged_attention",
                        lambda *a: calls.append(1) or real(*a))
    logits = {}
    for impl in ("auto", "plain", "flash"):
        del calls[:]
        with torch.inference_mode():
            logits[impl] = tgen._prefill(
                g.params, *args, cfg=cfg, vq_cfg=g.vq_cfg,
                gen=tgen.GenerationConfig(max_new_tokens=2, attn_impl=impl)).logits
        assert len(calls) == (cfg.num_hidden_layers if impl == "flash" else 0)
    finite = torch.isfinite(logits["plain"])
    torch.testing.assert_close(logits["auto"], logits["plain"], rtol=0, atol=0)
    torch.testing.assert_close(logits["flash"][finite], logits["plain"][finite],
                               rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="attn_impl"):
        g(inputs, tgen.GenerationConfig(max_new_tokens=2, attn_impl="xla"))


def test_generation_config_fields_match_jax():
    """The port's GenerationConfig has JAX's fields in JAX's order with
    JAX's defaults, all of them."""
    want = [(f.name, f.default) for f in dataclasses.fields(jgen.GenerationConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(tgen.GenerationConfig)]
    assert got == want


def test_no_newline_processor_matches_jax():
    cfg = LibraConfig.tiny()
    Q, B, Vc = 2, 3, cfg.combined_vocab_size
    logits = np.random.RandomState(0).randn(Q, B, Vc).astype(np.float32)
    emitted = np.array([True, False, True])
    want = np.asarray(jno_newline(JLibraConfig.tiny(), jnp.asarray(logits),
                                  jnp.asarray(emitted)))
    got = no_newline_processor(cfg, torch.from_numpy(logits),
                               torch.from_numpy(emitted)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(np.argmax(got[0, 0])) == cfg.eos_token_id
    np.testing.assert_array_equal(got[:, 1], logits[:, 1])


def test_valid_image_processor_matches_jax():
    cfg = LibraConfig.tiny()
    Q, B, Vc = 2, 4, cfg.combined_vocab_size
    Mv = cfg.max_vision_token_length
    logits = np.random.RandomState(1).randn(Q, B, Vc).astype(np.float32)
    vi = np.array([1, Mv - 3, Mv, 0])       # mid-image, last cell, text, first
    want = np.asarray(jvalid_image(JLibraConfig.tiny(), jnp.asarray(logits),
                                   jnp.asarray(vi)))
    got = valid_image_processor(cfg, torch.from_numpy(logits),
                                torch.from_numpy(vi)).numpy()
    np.testing.assert_array_equal(got, want)
    V, Vv = cfg.vocab_size, cfg.vision_vocab_size
    assert (got[0, 0, :V] < -1e20).all()
    np.testing.assert_array_equal(got[:, 0, V:V + Vv - 2], logits[:, 0, V:V + Vv - 2])
    assert np.argmax(got[0, 1]) == V + Vv - 1
    np.testing.assert_array_equal(got[:, 2], logits[:, 2])
