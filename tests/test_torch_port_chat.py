"""The port's incremental multi-turn chat (chat.ChatSession, LibraPipeline.
start_chat / ChatThread) against libra_tpu, at a tiny size in fp32 on the
CPU. Every case runs the same turns through JAX's ChatSession and the
port's on one parameter tree and holds the tokens, num_generated and the
used slots equal after each turn; the later turns are also held to JAX's
Generator over the concatenated token history (a resident cache continued
by a delta equals a re-prefill). The trees are
tests/test_torch_port_serving.py's: plain, int8 + kv8 (head dim 128) and
int4 + kv8 (head dim 128), so the quantized trees' decode steps and their
deltas of at most 64 rows in multiples of 8 take the int8 decode
attention's branch (its plain version here).

Mirrors tests/test_chat_session.py, its speculative cases included
(spec turns held to JAX's spec session, to the port's plain session and
to JAX's Generator over the history), less its 2D-RoPE case (A10). The
port has no jit cache, so a turn's delta width and decode body are read
from a wrapper on models/libra's forward.
"""

import functools

import numpy as np
import pytest
from PIL import Image

from libra_tpu import generation as jgen
from libra_tpu.chat import ChatSession as JChatSession
from libra_tpu.data.processors import LibraEvalImageProcessor as JProcessor
from libra_tpu.pipeline import LibraPipeline as JPipeline
from libra_tpu.tokenization import (ImageTokenizer as JImageTokenizer,
                                    LibraTokenizer as JLibraTokenizer,
                                    SimpleTextTokenizer as JSimpleTok)
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.chat import ChatSession
from libra_tpu_torch.config import CLIPVisionConfig, VQGANConfig
from libra_tpu_torch.data.processors import LibraEvalImageProcessor
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.pipeline import LibraPipeline
from libra_tpu_torch.tokenization import (IMG_PH, ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from tests.test_chat_session import _concat_history, _text_delta, _turn1_inputs
from tests.test_torch_port_fused_generation import _vq_tree
from tests.test_torch_port_serving import TREES, _jax_generator, _setup

ALL = list(TREES)
KV8 = ["int8", "int4"]


def _gen_kw(tree, eos=-1, spec=0):
    return dict(eos_token_id=eos, spec_decode=spec, **TREES[tree][2])


@functools.lru_cache(maxsize=None)
def _jax_turn_fns(tree, eos, spec, pixels) -> dict:
    """One jitted-turn table for every JAX session of the same tree and
    generation settings: its entries are jax.jit of libra_tpu's module-level
    turn functions over (cfg, gen, vq_cfg), with the params and the session
    state as arguments, so sessions that share them run the same programs
    and each (delta width, batch, cache size) compiles once a module."""
    return {}


def _sessions(tree, B, max_len=128, delta_bucket=4, eos=-1, pixels=False, spec=0):
    """JAX's and the port's ChatSession on one tree (spec > 0: spec turns
    at gamma = spec)."""
    cfg, jcfg, np_tree, params = _setup(tree)
    kw, tkw = {}, {}
    if pixels:
        jvq, vq_tree = _vq_tree()
        kw = dict(vq_params=vq_tree, vq_cfg=jvq)
        tkw = dict(vq_params=from_numpy_tree(vq_tree, device="cpu"),
                   vq_cfg=VQGANConfig.tiny())
    js = JChatSession(np_tree, jcfg, batch=B, max_len=max_len,
                      gen=jgen.GenerationConfig(**_gen_kw(tree, eos, spec)),
                      delta_bucket=delta_bucket, **kw)
    js._fns = _jax_turn_fns(tree, eos, spec, pixels)
    ts = ChatSession(params, cfg, batch=B, max_len=max_len,
                     gen=tgen.GenerationConfig(**_gen_kw(tree, eos, spec)),
                     delta_bucket=delta_bucket, **tkw)
    return js, ts


def _ask(js, ts, inputs, max_new):
    """One turn through both sessions: equal tokens, num_generated and
    used slots. Returns the port's result as numpy (tokens, num)."""
    want = js.ask(inputs, max_new_tokens=max_new)
    got = ts.ask(inputs, max_new_tokens=max_new)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    assert ts.used == js.used
    return got.tokens.numpy(), got.num_generated.numpy()


def _history_tokens(tree, turns, answers, max_new, eos=-1):
    """JAX's Generator over the concatenated token history: the tokens it
    generates after it."""
    jcfg = _setup(tree)[1]
    full = _concat_history(jcfg, turns, answers)
    want = _jax_generator(tree)(
        full, jgen.GenerationConfig(max_new_tokens=max_new, **_gen_kw(tree, eos)))
    return np.asarray(want.sequences)[:, :, full["input_ids"].shape[-1]:]


def _left_pad(cfg, t, bucket):
    """A delta as the session pads it: pad ids, mask 0, vi text, zero
    signal rows."""
    n = t["input_ids"].shape[-1]
    pad = (-n) % bucket
    B = t["input_ids"].shape[1]
    mask = t.get("attention_mask")
    out = {"input_ids": np.pad(t["input_ids"], ((0, 0), (0, 0), (pad, 0))),
           "vision_indices": np.pad(t["vision_indices"], ((0, 0), (pad, 0)),
                                    constant_values=cfg.max_vision_token_length),
           "attention_mask": np.pad(np.ones((B, n), np.int64) if mask is None
                                    else np.asarray(mask, np.int64), ((0, 0), (pad, 0)))}
    if t.get("coninous_signal") is not None:
        out["coninous_signal"] = np.pad(t["coninous_signal"], ((0, 0), (pad, 0), (0, 0)))
    return out


@pytest.fixture
def forwards(monkeypatch):
    """(width, lang_only) of every models/libra forward the port runs."""
    calls = []
    real = TM.forward

    def record(params, cfg, input_ids, *a, **k):
        calls.append((input_ids.shape[-1], k.get("lang_only", False)))
        return real(params, cfg, input_ids, *a, **k)
    monkeypatch.setattr(TM, "forward", record)
    return calls


@pytest.mark.parametrize("tree", ALL)
def test_two_turns_match_jax_and_full_reprefill(tree, forwards):
    cfg, jcfg = _setup(tree)[:2]
    B, max_new = 2, 5
    js, ts = _sessions(tree, B)        # delta_bucket 4 forces delta padding
    t1 = _turn1_inputs(jcfg, B)
    a1 = _ask(js, ts, t1, max_new)
    N1 = t1["input_ids"].shape[-1]
    Nb1 = N1 + (-N1) % 4
    # one delta pass of Nb1 rows, then max_new language-only decode steps
    assert forwards == [(Nb1, False)] + [(1, True)] * max_new
    assert ts.used == Nb1 + max_new
    want1 = _jax_generator(tree)(
        t1, jgen.GenerationConfig(max_new_tokens=max_new, **_gen_kw(tree)))
    np.testing.assert_array_equal(a1[0], np.asarray(want1.sequences)[:, :, N1:])

    forwards.clear()
    t2 = _text_delta(jcfg, B, 5, seed=9)    # pads 5 -> 8 in the bucket
    a2 = _ask(js, ts, t2, max_new)
    assert forwards[0] == (8, False) and set(forwards[1:]) == {(1, True)}
    np.testing.assert_array_equal(
        a2[0], _history_tokens(tree, [t1, _left_pad(cfg, t2, 4)], [a1], max_new))


@pytest.mark.parametrize("tree", ALL)
def test_eos_row_freezes_and_next_turn_matches(tree):
    jcfg = _setup(tree)[1]
    t1 = _turn1_inputs(jcfg, 1, seed=3)
    first = int(np.asarray(_jax_generator(tree)(t1, jgen.GenerationConfig(
        max_new_tokens=1, **_gen_kw(tree))).sequences)[0, 0, -1])
    js, ts = _sessions(tree, 1, delta_bucket=1, eos=first)
    tok1, num1 = _ask(js, ts, t1, 4)
    assert int(num1[0]) == 1 and int(tok1[0, 0, 0]) == first   # stopped at "EOS"
    # the EOS token's forward ran: its K/V is in the cache for turn 2
    assert ts.used == t1["input_ids"].shape[-1] + 1

    t2 = _text_delta(jcfg, 1, 3, seed=11)
    tok2, num2 = _ask(js, ts, t2, 4)
    # the history: the prompt, the one emitted token (visible, as the v1
    # template's answer</s>), the next question
    want = _history_tokens(tree, [t1, t2], [(tok1[:, :, :1], np.ones((1,), np.int32))],
                           4, eos=first)
    n = int(num2[0])
    np.testing.assert_array_equal(tok2[:, :, :n], want[:, :, :n])


@pytest.mark.parametrize("tree", KV8)
def test_session_int8_kv_matches_generator(tree):
    """The int8 cache, deltas unpadded; max_len 96 rounds up to S = 128."""
    jcfg = _setup(tree)[1]
    js, ts = _sessions(tree, 2, max_len=96, delta_bucket=1)
    assert ts.S == js.S == 128
    t1 = _turn1_inputs(jcfg, 2, seed=5)
    a1 = _ask(js, ts, t1, 4)
    want1 = _jax_generator(tree)(t1, jgen.GenerationConfig(
        max_new_tokens=4, **_gen_kw(tree)))
    np.testing.assert_array_equal(
        a1[0], np.asarray(want1.sequences)[:, :, t1["input_ids"].shape[-1]:])
    t2 = _text_delta(jcfg, 2, 4, seed=6)
    a2 = _ask(js, ts, t2, 4)
    np.testing.assert_array_equal(a2[0], _history_tokens(tree, [t1, t2], [a1], 4))


@pytest.mark.parametrize("tree", KV8)
def test_int8_delta_bucket_64_takes_the_decode_attention_branch(tree, monkeypatch):
    """At delta_bucket 64 (start_chat's default) each delta is 64 rows: a
    multiple of 8 up to 64, so the int8 cache's delta pass goes through
    int8_decode_attention at N = 64 (B3's rows template on the card, its
    plain version here), and each decode step at N = 1."""
    cfg, jcfg = _setup(tree)[:2]
    calls = []
    real = TM.int8_decode_attention
    monkeypatch.setattr(TM, "int8_decode_attention",
                        lambda q, *a, **k: calls.append(q.shape[1]) or real(q, *a, **k))
    B, max_new = 2, 4
    js, ts = _sessions(tree, B, max_len=160, delta_bucket=64)
    assert ts.S == 256
    t1 = _turn1_inputs(jcfg, B, seed=7)
    a1 = _ask(js, ts, t1, max_new)
    t2 = _text_delta(jcfg, B, 5, seed=8)
    a2 = _ask(js, ts, t2, max_new)
    L = cfg.num_hidden_layers
    assert calls == ([64] * L + [1] * L * max_new) * 2
    assert ts.used == 2 * (64 + max_new)
    np.testing.assert_array_equal(
        a2[0], _history_tokens(tree, [_left_pad(cfg, t1, 64), _left_pad(cfg, t2, 64)],
                               [a1], max_new))


@pytest.mark.parametrize("tree", ALL)
def test_t2i_turn_decodes_dual_path(tree, forwards):
    """A later turn ending at BOI resolves decode_modality='auto' to the
    dual-path body and continues the image block."""
    cfg, jcfg = _setup(tree)[:2]
    js, ts = _sessions(tree, 1, delta_bucket=1)
    t1 = _text_delta(jcfg, 1, 4, seed=21)
    a1 = _ask(js, ts, t1, 3)
    t2 = _text_delta(jcfg, 1, 3, seed=22)
    t2["input_ids"][:, :, -1] = cfg.vocab_size + cfg.vision_vocab_size - 2
    t2["vision_indices"][:, -1] = 0               # the delta ends at BOI
    forwards.clear()
    new, _ = _ask(js, ts, t2, 4)
    assert forwards == [(3, False)] + [(1, False)] * 4    # dual-path body
    assert (new >= cfg.vocab_size).all()                  # the image continues
    np.testing.assert_array_equal(new, _history_tokens(tree, [t1, t2], [a1], 4))


@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_session_guards(tree):
    cfg, jcfg, _, params = _setup(tree)
    # 2D prediction: the session's own refusal, as libra_tpu's
    with pytest.raises(NotImplementedError, match="1d"):
        ChatSession(params, cfg.replace(vision_prediction_mode="2d"), batch=1, max_len=64)
    with pytest.raises(NotImplementedError, match="A13"):
        ChatSession(params, cfg, batch=1, max_len=64, mesh=object())
    with pytest.raises(ValueError, match="together"):
        ChatSession(params, cfg, batch=1, max_len=64, vq_cfg=VQGANConfig.tiny())
    js, ts = _sessions(tree, 1, max_len=32, delta_bucket=64)
    for s in (js, ts):
        with pytest.raises(ValueError, match="batch"):
            s.ask(_text_delta(jcfg, 2, 3, seed=0))
        with pytest.raises(ValueError, match="slots"):
            # 64 + 65 slots: past 32, and past the int8 cache's 128
            s.ask(_text_delta(jcfg, 1, 3, seed=0), max_new_tokens=65)
    t = _text_delta(jcfg, 1, 3, seed=0)
    t["vision_indices"][:, -1] = 0
    text_only = ChatSession(params, cfg, batch=1, max_len=64, delta_bucket=1,
                            gen=tgen.GenerationConfig(decode_modality="text",
                                                      **_gen_kw(tree)))
    with pytest.raises(ValueError, match="ending in text"):
        text_only.ask(t, max_new_tokens=1)
    # the int8 cache rounds max_len = 96 up to 128 slots in both packages,
    # so a 100-slot prefill-only turn fits there and not in a plain cache
    js, ts = _sessions(tree, 1, max_len=96, delta_bucket=1)
    big = _text_delta(jcfg, 1, 100, seed=1)
    if TREES[tree][2].get("kv_quant"):
        _ask(js, ts, big, 0)
        assert ts.used == 100
    else:
        for s in (js, ts):
            with pytest.raises(ValueError, match="slots"):
                s.ask(big, max_new_tokens=0)


@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_turn_with_pixels_matches_preencoded(tree):
    """A raw-pixels turn (CLIP + LFQ inside the delta pass) emits the tokens
    of JAX's raw-pixels turn and of the same turn pre-encoded on the
    host."""
    cfg, jcfg = _setup(tree)[:2]
    jvq, vq_tree = _vq_tree()
    text_tok = JSimpleTok(vocab_size=cfg.vocab_size)
    joint = JLibraTokenizer(text_tok, JImageTokenizer(
        jvq, vq_tree, token_offset=cfg.vocab_size,
        max_vision_token_length=cfg.max_vision_token_length))
    Mv = cfg.max_vision_token_length
    img = np.random.RandomState(0).randn(28, 28, 3).astype(np.float32)
    prompt = " ".join([IMG_PH] * Mv) + " describe:"
    pre = joint([{"language": [prompt], "vision": [img]}])
    js_pre, _ = _sessions(tree, 1, max_len=96)
    want = js_pre.ask({k: np.asarray(pre[k]) for k in
                       ("input_ids", "vision_indices", "coninous_signal")},
                      max_new_tokens=4)

    ids = np.asarray(text_tok([prompt])["input_ids"], np.int64)
    pos = int(np.nonzero(ids[0] == text_tok.img_ph_token_id)[0][0])
    vi = np.full((1, ids.shape[-1]), Mv, np.int64)
    vi[0, pos:pos + Mv] = np.arange(Mv)
    raw = {"input_ids": np.broadcast_to(ids[None], (cfg.vision_codebook_num,) + ids.shape),
           "vision_indices": vi, "pixels": img[None], "img_start": np.array([pos])}
    js, ts = _sessions(tree, 1, max_len=96, pixels=True)
    got, _ = _ask(js, ts, raw, 4)
    np.testing.assert_array_equal(got, np.asarray(want.tokens))

    plain = ChatSession(_setup(tree)[3], cfg, batch=1, max_len=96)
    with pytest.raises(ValueError, match="vq_params"):
        plain.ask(raw)
    with pytest.raises(ValueError, match="pixels shape"):
        ts.ask(dict(raw, pixels=np.zeros((1, 14, 14, 3), np.float32)))


@pytest.mark.parametrize("tree", ALL)
def test_prefill_only_turn(tree):
    """max_new_tokens=0 injects context and generates nothing; the next
    turn equals a re-prefill of both deltas."""
    _, jcfg = _setup(tree)[:2]
    B = 2
    js, ts = _sessions(tree, B, delta_bucket=1)
    t1 = _turn1_inputs(jcfg, B)
    tok1, num1 = _ask(js, ts, t1, 0)
    assert tok1.shape[-1] == 0 and (num1 == 0).all()
    assert ts.used == t1["input_ids"].shape[-1]
    t2 = _text_delta(jcfg, B, 3, seed=11)
    tok2, _ = _ask(js, ts, t2, 4)
    np.testing.assert_array_equal(tok2, _history_tokens(tree, [t1, t2], [], 4))


@pytest.mark.parametrize("tree", ALL)
def test_spec_session_matches_full_reprefill(tree, forwards):
    """Spec turns (per-row acceptance inside the resident cache): each
    turn's tokens, num_generated and used slots equal JAX's spec session,
    the tokens equal the port's plain session, and turn 2's equal JAX's
    Generator over the token history. Each turn is one delta pass, verify
    passes of gamma + 1 rows and the flush step of one row."""
    cfg, jcfg = _setup(tree)[:2]
    B, max_new, gamma = 2, 6, 3
    js, ts = _sessions(tree, B, spec=gamma)
    plain = _sessions(tree, B)[1]
    assert ts.S == js.S and ts._cap == js._cap
    t1 = _turn1_inputs(jcfg, B)
    a1 = _ask(js, ts, t1, max_new)
    N1 = t1["input_ids"].shape[-1]
    Nb1 = N1 + (-N1) % 4
    assert forwards[0] == (Nb1, False) and forwards[-1] == (1, True)
    assert set(forwards[1:-1]) == {(gamma + 1, True)}
    forwards.clear()
    p1 = plain.ask(t1, max_new_tokens=max_new)
    np.testing.assert_array_equal(a1[0], p1.tokens.numpy())
    np.testing.assert_array_equal(a1[1], p1.num_generated.numpy())

    t2 = _text_delta(jcfg, B, 5, seed=9)
    a2 = _ask(js, ts, t2, max_new)
    np.testing.assert_array_equal(a2[0], plain.ask(t2, max_new_tokens=max_new).tokens.numpy())
    np.testing.assert_array_equal(
        a2[0], _history_tokens(tree, [t1, _left_pad(cfg, t2, 4)], [a1], max_new))


@pytest.mark.parametrize("tree", ALL)
def test_spec_session_eos(tree):
    """A spec row stopping at EOS on its first token freezes as the
    lockstep body does; the EOS stays visible to turn 2, which matches JAX's
    spec session and JAX's Generator over the history (int8 and int4: the
    verify passes at N = 3 through the decode-attention branch)."""
    jcfg = _setup(tree)[1]
    t1 = _turn1_inputs(jcfg, 1, seed=3)
    first = int(np.asarray(_jax_generator(tree)(t1, jgen.GenerationConfig(
        max_new_tokens=1, **_gen_kw(tree))).sequences)[0, 0, -1])
    js, ts = _sessions(tree, 1, delta_bucket=1, eos=first, spec=2)
    tok1, num1 = _ask(js, ts, t1, 4)
    assert int(num1[0]) == 1 and int(tok1[0, 0, 0]) == first
    # the flush step wrote the EOS token's K/V: turn 2 starts after it
    assert ts.used == t1["input_ids"].shape[-1] + 1

    t2 = _text_delta(jcfg, 1, 3, seed=11)
    tok2, num2 = _ask(js, ts, t2, 4)
    want = _history_tokens(tree, [t1, t2], [(tok1[:, :, :1], np.ones((1,), np.int32))],
                           4, eos=first)
    n = int(num2[0])
    np.testing.assert_array_equal(tok2[:, :, :n], want[:, :, :n])


@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_spec_session_guards(tree):
    """Spec sessions are greedy text-only in both packages: sampling and
    an explicit dual decode raise at construction, a turn whose delta ends
    at BOI (resolving to dual) raises at ask(). The margin: gamma + 1
    slots past max_len, an int8 cache's S rounded up to 128 over them."""
    cfg, jcfg, np_tree, params = _setup(tree)
    for kw in (dict(do_sample=True), dict(decode_modality="dual")):
        gkw = dict(_gen_kw(tree, spec=2), **kw)
        with pytest.raises(ValueError, match="greedy" if "do_sample" in kw else "dual"):
            JChatSession(np_tree, jcfg, batch=1, max_len=64,
                         gen=jgen.GenerationConfig(**gkw))
        with pytest.raises(ValueError, match="greedy" if "do_sample" in kw else "dual"):
            ChatSession(params, cfg, batch=1, max_len=64,
                        gen=tgen.GenerationConfig(**gkw))
    js, ts = _sessions(tree, 1, max_len=64, delta_bucket=1, spec=2)
    assert (ts.S, ts._cap) == (js.S, js._cap) == ((128, 125) if TREES[tree][2].get(
        "kv_quant") else (67, 64))
    t = _text_delta(jcfg, 1, 3, seed=0)
    t["input_ids"][:, :, -1] = cfg.vocab_size + 1
    t["vision_indices"][:, -1] = 0                # the delta ends at BOI
    for s in (js, ts):
        with pytest.raises(ValueError, match="dual"):
            s.ask(t, max_new_tokens=2)


@pytest.mark.parametrize("add_bos", [True, False])
def test_simple_tokenizer_add_bos_token(add_bos):
    texts = ["USER: what is it? ASSISTANT:", "hi", "<img_ph> <img_ph>\nwhy"]
    want = JSimpleTok(vocab_size=256)
    want.add_bos_token = add_bos
    got = SimpleTextTokenizer(vocab_size=256)
    got.add_bos_token = add_bos
    for t in texts:
        assert got.encode_one(t) == want.encode_one(t)
    want.padding_side = got.padding_side = "left"
    w, g = want(texts), got(texts)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
    assert (got.encode_one("hi")[0] == got.bos_token_id) == add_bos


@functools.lru_cache(maxsize=None)
def _pipe_trees():
    """One tree and vocabulary for both pipelines (the plain tree)."""
    return _setup("plain"), _vq_tree()


def _pipes():
    """Fresh JAX and port pipelines (fresh tokenizers: word ids are given
    as words first appear)."""
    (cfg, jcfg, np_tree, params), (jvq, vq_tree) = _pipe_trees()
    Mv = cfg.max_vision_token_length
    jtok = JLibraTokenizer(JSimpleTok(vocab_size=cfg.vocab_size), JImageTokenizer(
        jvq, vq_tree, token_offset=cfg.vocab_size, max_vision_token_length=Mv))
    ttok = LibraTokenizer(SimpleTextTokenizer(vocab_size=cfg.vocab_size), ImageTokenizer(
        VQGANConfig.tiny(), from_numpy_tree(vq_tree, device="cpu"), cfg.vocab_size, Mv))
    return (JPipeline(jcfg, np_tree, jtok, image_processor=JProcessor(jvq.clip)),
            LibraPipeline(cfg, params, ttok, LibraEvalImageProcessor(CLIPVisionConfig.tiny())))


def test_chat_thread_matches_jax_start_chat(forwards):
    """Three turns of ChatThread over two conversations: every turn's
    answers equal JAX's; turn 1 equals pipe.chat on the same prompt;
    later turns prefill only their own delta (no BOS)."""
    images = [Image.fromarray(np.random.RandomState(i).randint(0, 255, (40, 36, 3),
                                                               np.uint8)) for i in range(2)]
    turns = [["describe this", "what is in the picture?"],
             ["and the shape?", "which color is it"],
             ["why", "is it large or small?"]]
    jp, tp = _pipes()
    want1 = jp.chat(turns[0], images=images, max_new_tokens=4)
    got1 = tp.chat(turns[0], images=images, max_new_tokens=4)
    assert got1 == want1
    kw = dict(n_parallel=2, max_len=192, max_new_tokens=4, delta_bucket=4)
    jt, tt = jp.start_chat(**kw), tp.start_chat(**kw)
    widths = []
    for i, qs in enumerate(turns):
        want = jt.ask(qs, images=images if i == 0 else None)
        forwards.clear()
        got = tt.ask(qs, images=images if i == 0 else None)
        widths.append(forwards[0][0])
        assert got == want
        if i == 0:
            assert got == got1
        assert tt.session.used == jt.session.used
    assert tt.turn == 3 and tp.tokenizer.text_tokenizer.add_bos_token
    assert widths[1] < widths[0] and widths[2] < widths[0]
    with pytest.raises(ValueError, match="conversations"):
        tt.ask(["one question"])
