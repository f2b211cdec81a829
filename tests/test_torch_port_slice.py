"""The port's bf16-serving slice against libra_tpu end to end, at a tiny
size in fp32 on the CPU: parameter trees, the decoder forward, the
prompt pass's logits (atol 1e-4: fp32 through a few layers), greedy
generation and LibraPipeline.chat (equal tokens and answers).

Both packages run on one parameter tree: JAX's init_params with the
bridge B-weights (zero at init) filled with N(0, 0.02) noise, so the
bridge terms are exercised, handed to the port through numpy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from libra_tpu import generation as jgen
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.data.processors import LibraEvalImageProcessor as JProcessor
from libra_tpu.models import clip as jclip, libra as JM, vqgan as jvqgan
from libra_tpu.pipeline import LibraPipeline as JPipeline
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu.tokenization import LibraTokenizer as JLibraTokenizer
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.config import CLIPVisionConfig, LibraConfig, VQGANConfig
from libra_tpu_torch.data.processors import LibraEvalImageProcessor
from libra_tpu_torch.models import clip as tclip, libra as TM, vqgan as tvqgan
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.pipeline import LibraPipeline
from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)

BRIDGES = ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis")
QUESTIONS = ["describe this", "what color is the thing on the left?"]


VARIANTS = [{}, dict(use_bridge=False, addition_mode=True, concat_signals=False),
            dict(norm_signals=False, use_vision_position_embedding=True)]


@functools.lru_cache(maxsize=None)
def _np_params_cached(kw_items):
    jcfg = JLibraConfig.tiny(**dict(kw_items))
    p = jax.jit(functools.partial(JM.init_params, cfg=jcfg))(
        jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(np.array, p)
    rs = np.random.RandomState(100)
    if jcfg.use_bridge:
        for name in BRIDGES:
            wb = p["layers"]["attn"][name]["wb"]
            wb[...] = rs.normal(0.0, 0.02, wb.shape)
    return jcfg, p


def _np_params(cfg_kw=None):
    """JAX init_params (jitted, once per config) as a numpy tree, bridge
    wb filled. Callers must not modify the tree."""
    return _np_params_cached(tuple(sorted((cfg_kw or {}).items())))


def _np_vq_params(jvq, seed=1):
    clip = jax.jit(functools.partial(jclip.init_params, cfg=jvq.clip))(
        jax.random.PRNGKey(seed))
    cin = jvq.clip_feature_dim
    w = np.random.RandomState(seed).randn(1, 1, cin, jvq.embed_dim)
    return {"clip": jax.tree_util.tree_map(np.asarray, clip),
            "quant_conv": {"w": (w * cin ** -0.5).astype(np.float32),
                           "b": np.zeros((jvq.embed_dim,), np.float32)}}


@pytest.fixture(scope="module")
def slice_setup():
    jcfg, np_params = _np_params()
    cfg = LibraConfig.tiny()
    jvq, vq = JVQGANConfig.tiny(), VQGANConfig.tiny()
    np_vq = _np_vq_params(jvq)
    images = [Image.fromarray(np.random.RandomState(i).randint(
        0, 255, (40, 36, 3), np.uint8)) for i in range(len(QUESTIONS))]

    def jax_pipe():
        tok = JLibraTokenizer(
            JSimpleTok(vocab_size=cfg.vocab_size),
            JImageTokenizer(jvq, np_vq, token_offset=cfg.vocab_size,
                            max_vision_token_length=cfg.max_vision_token_length))
        return JPipeline(jcfg, np_params, tok, image_processor=JProcessor(jvq.clip))

    def torch_pipe(params=None):
        tok = LibraTokenizer(
            SimpleTextTokenizer(vocab_size=cfg.vocab_size),
            ImageTokenizer(vq, from_numpy_tree(np_vq, device="cpu"), cfg.vocab_size,
                           cfg.max_vision_token_length))
        return LibraPipeline(cfg, params or from_numpy_tree(np_params, device="cpu"), tok,
                             LibraEvalImageProcessor(CLIPVisionConfig.tiny()))

    return dict(jcfg=jcfg, cfg=cfg, np_params=np_params, images=images,
                jax_pipe=jax_pipe, torch_pipe=torch_pipe)


def _inputs(setup):
    """Tokenized chat inputs (numpy), from the JAX pipeline's tokenizer."""
    from libra_tpu.pipeline import process_prompt
    pipe = setup["jax_pipe"]()
    Mv = setup["cfg"].max_vision_token_length
    return pipe._tokenize([process_prompt(q, Mv) for q in QUESTIONS],
                          setup["images"])


def _flat_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):      # the VQGAN decoder's levels
        return _flat_shapes(dict(enumerate(tree)), prefix)
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("kw", [{}, dict(use_bridge=False),
                                dict(addition_mode=True, concat_signals=False),
                                dict(norm_signals=False,
                                     use_vision_position_embedding=True)])
def test_init_params_tree_matches(kw):
    jcfg = JLibraConfig.tiny(**kw)
    want = _flat_shapes(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    got = _flat_shapes(TM.init_params(torch.Generator().manual_seed(0),
                                      LibraConfig.tiny(**kw), device="cpu"))
    assert got == want


def test_vision_init_params_tree_matches():
    jvq = JVQGANConfig.tiny(select_layer=(-2, -1))
    full = jax.eval_shape(lambda: jvqgan.init_params(jax.random.PRNGKey(0), jvq))
    # the whole tree: the encode side, post_quant_conv and the conv decoder
    want = _flat_shapes(full)
    got = _flat_shapes(tvqgan.init_params(
        torch.Generator().manual_seed(0), VQGANConfig.tiny(select_layer=(-2, -1)),
        device="cpu"))
    assert got == want
    assert _flat_shapes(tclip.init_params(
        torch.Generator().manual_seed(0), CLIPVisionConfig.tiny(), device="cpu")) == \
        _flat_shapes(full["clip"])


def _batch(cfg, B=2, N=14, seed=3):
    """Text / image block / text rows, row 1 left-padded by 2."""
    rs = np.random.RandomState(seed)
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    ids = rs.randint(3, cfg.vocab_size, (Q, B, N))
    ids[1:] = ids[0]
    ids[:, :, 4:4 + Mv] = rs.randint(0, cfg.vision_vocab_size, (Q, B, Mv)) \
        + cfg.vocab_size
    vi = np.full((B, N), Mv)
    vi[:, 4:4 + Mv] = np.arange(Mv)
    mask = np.ones((B, N), np.int32)
    mask[1, :2] = 0
    sig = rs.randn(B, N, cfg.contiguous_signal_size).astype(np.float32)
    return ids, mask, vi, sig


@pytest.mark.parametrize("kw", VARIANTS)
def test_forward_matches(kw):
    jcfg, np_params = _np_params(kw)
    ids, mask, vi, sig = _batch(jcfg)
    want = jax.jit(lambda p, *a: JM.forward(p, jcfg, *a).hidden_states)(
        np_params, ids, mask, vi, sig)
    got = TM.forward(from_numpy_tree(np_params, device="cpu"), LibraConfig.tiny(**kw),
                     *map(torch.from_numpy, (ids, mask, vi, sig))).hidden_states
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_cached_decode_matches_full_forward():
    """Prompt pass + one cached step == the forward over both, at the
    last position (the port against itself)."""
    jcfg, np_params = _np_params()
    cfg, params = LibraConfig.tiny(), from_numpy_tree(np_params, device="cpu")
    ids, mask, vi, sig = map(torch.from_numpy, _batch(jcfg))
    gen = tgen.GenerationConfig(max_new_tokens=2)
    st = tgen._prefill(params, ids, mask, vi, sig, cfg=cfg, gen=gen)
    tok = torch.argmax(st.logits, dim=-1)
    st.mask_buf[:, ids.shape[-1]] = 1
    logits, *_ = tgen.decode_micro_step(params, cfg, tok, st.mask_buf, st.cache,
                                        st.vi_last, st.last_pos)
    full = TM.forward(params, cfg, torch.cat([ids, tok[:, :, None]], -1),
                      torch.cat([mask, torch.ones_like(mask[:, :1])], -1),
                      torch.cat([vi, vi[:, -1:]], -1),
                      torch.cat([sig, torch.zeros_like(sig[:, :1])], 1))
    want = tgen._last_position_logits(params, cfg, full.hidden_states,
                                      vi[:, -1] < cfg.max_vision_token_length,
                                      vi[:, -1])
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-4)


def _prefill_logits_jax(setup, inputs, gen):
    fn = jax.jit(functools.partial(jgen._prefill, cfg=setup["jcfg"], gen=gen))
    st = fn(setup["np_params"], inputs["input_ids"], inputs["attention_mask"],
            inputs["vision_indices"], inputs["coninous_signal"])
    return np.asarray(st.logits)


def _prefill_logits_torch(setup, inputs, params):
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in inputs.items()}
    st = tgen._prefill(params, t["input_ids"].long(), t["attention_mask"],
                       t["vision_indices"].long(), t["coninous_signal"],
                       cfg=setup["cfg"], gen=tgen.GenerationConfig(max_new_tokens=4))
    return st.logits.numpy()


def test_prefill_logits_match_and_bridge_is_live(slice_setup):
    inputs = _inputs(slice_setup)
    want = _prefill_logits_jax(slice_setup, inputs,
                               jgen.GenerationConfig(max_new_tokens=4))
    params = from_numpy_tree(slice_setup["np_params"], device="cpu")
    got = _prefill_logits_torch(slice_setup, inputs, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for name in BRIDGES:
        params["layers"]["attn"][name]["wb"].zero_()
    no_bridge = _prefill_logits_torch(slice_setup, inputs, params)
    finite = np.isfinite(got)
    assert np.abs(no_bridge[finite] - got[finite]).max() > 1e-3


@pytest.mark.parametrize("bucket", [0, 8])
def test_greedy_tokens_match(slice_setup, bucket):
    inputs = _inputs(slice_setup)
    jres = jgen.Generator(slice_setup["np_params"], slice_setup["jcfg"])(
        inputs, jgen.GenerationConfig(max_new_tokens=6, prompt_bucket=bucket,
                                      eos_token_id=-1))
    tres = tgen.Generator(from_numpy_tree(slice_setup["np_params"], device="cpu"),
                          slice_setup["cfg"])(
        inputs, tgen.GenerationConfig(max_new_tokens=6, prompt_bucket=bucket,
                                      eos_token_id=-1))
    np.testing.assert_array_equal(tres.sequences.numpy(),
                                  np.asarray(jres.sequences))
    np.testing.assert_array_equal(tres.num_generated.numpy(),
                                  np.asarray(jres.num_generated))


def test_chat_matches(slice_setup):
    want = slice_setup["jax_pipe"]().chat(QUESTIONS, images=slice_setup["images"],
                                          max_new_tokens=8)
    got = slice_setup["torch_pipe"]().chat(QUESTIONS, images=slice_setup["images"],
                                           max_new_tokens=8)
    assert got == want
    assert all(isinstance(a, str) and a for a in got)


def test_generation_stops_when_all_rows_finish(slice_setup):
    """EOS on every row ends the loop early; finished rows emit pads."""
    inputs = _inputs(slice_setup)
    gen = tgen.Generator(from_numpy_tree(slice_setup["np_params"], device="cpu"),
                         slice_setup["cfg"])
    first = gen(inputs, tgen.GenerationConfig(max_new_tokens=1, eos_token_id=-1))
    N = np.asarray(inputs["input_ids"]).shape[-1]
    eos = int(first.sequences[0, 0, N])     # row 0's first token as "EOS"
    res = gen(inputs, tgen.GenerationConfig(max_new_tokens=6, eos_token_id=eos))
    jres = jgen.Generator(slice_setup["np_params"], slice_setup["jcfg"])(
        inputs, jgen.GenerationConfig(max_new_tokens=6, eos_token_id=eos))
    np.testing.assert_array_equal(res.sequences.numpy(), np.asarray(jres.sequences))
    assert int(res.num_generated[0]) == 1


@pytest.mark.parametrize("k,p", [(5, 1.0), (0, 0.7), (7, 0.5)])
def test_sampling_filters_match(k, p):
    x = np.random.RandomState(9).randn(2, 3, 40).astype(np.float32) * 3
    tx = torch.from_numpy(x)
    if k:
        np.testing.assert_array_equal(tgen._filter_top_k(tx, k).numpy(),
                                      np.asarray(jgen._filter_top_k(jnp.asarray(x), k)))
    if p < 1.0:
        np.testing.assert_array_equal(tgen._filter_top_p(tx, p).numpy(),
                                      np.asarray(jgen._filter_top_p(jnp.asarray(x), p)))
    gen = tgen.GenerationConfig(do_sample=True, top_k=k, top_p=p, temperature=0.8)
    a = tgen.sample_tokens(tx, gen, torch.Generator().manual_seed(1))
    b = tgen.sample_tokens(tx, gen, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (2, 3)
    kept = torch.isfinite(tgen._filter_top_k(tx, k) if k else tx)
    assert bool(kept.gather(-1, a[..., None]).all())
    greedy = tgen.sample_tokens(tx, tgen.GenerationConfig())
    assert torch.equal(greedy, tx.argmax(-1))
