"""The port's 2D modes against libra_tpu, at a tiny size in fp32 on the CPU:
2D vision prediction (the (Q, 2D, Vv) heads over a hidden and its up /
left neighbours, the decode's (R - 1)-deep hidden ring) and 2D RoPE (row /
column positions on alternating heads, the carried base counter), through
the model, the Generator, spec decode, ChatSession, the ServingEngine, the
training loss and LibraPipeline.generate_image.

Tokens are held equal to libra_tpu's; logits, hidden states and losses
within 1e-5 (fp32), gradients and train steps at tests/test_torch_port_
train.py's tolerances. One parameter tree for both packages (JAX's
init_params with live bridge B-weights, quantized by JAX for the int8 and
int4 trees; tests/test_torch_port_fused_generation.py's _trees), carried
across with from_numpy_tree. The grid is R = 3 (max_vision_token_length
11) unless a case says otherwise, so that the ring is 2 deep and a row of
the grid has an interior cell.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import chat as jchat, generation as jgen, serving as jserving
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.models import libra as JM
from libra_tpu.ops import rope as jrope
from libra_tpu.training import fused as jfused, optimizer as jopt, trainer as jtrainer
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.chat import ChatSession
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.ops import rope as trope
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.serving import Request, ServingEngine
from libra_tpu_torch.training import fused as tfused, optimizer as topt, trainer as ttrainer

from tests.test_2d_mode import oracle_2d_inputs
from tests.test_chat_session import _concat_history, _text_delta, _turn1_inputs
from tests.test_torch_port_fused_generation import KW128, _trees
from tests.test_torch_port_slice import _batch, _np_vq_params
from tests.test_torch_port_train import PARAM_TOL, _assert_trees_close, _flat, _to_torch
from tests.test_torch_port_train_fused import _batches

TOL = dict(rtol=0, atol=1e-5)
GRID = dict(image_feature_resolution=3, max_vision_token_length=11)
MODES = {"pred": dict(vision_prediction_mode="2d"), "rope": dict(use_2d_rope=True),
         "both": dict(vision_prediction_mode="2d", use_2d_rope=True)}
W256 = dict(hidden_size=256, intermediate_size=256, num_attention_heads=2)
# (config overrides, weight bits, GenerationConfig overrides); the int8
# tree's head dim is 128, so its decode steps take the decode kernel's
# branch (its plain version here)
TREES = {"plain": ({}, 0, {}), "int8": (KW128, 8, dict(kv_quant=True)),
         "int4": (W256, 4, dict(kv_quant=True))}


@functools.lru_cache(maxsize=None)
def _setup(tree: str, mode: str, grid: bool = True):
    """(port config, JAX config, numpy tree, port tree)."""
    kw = {**TREES[tree][0], **MODES[mode], **(GRID if grid else {})}
    jcfg, np_tree = _trees(tuple(sorted(kw.items())), TREES[tree][1])
    return LibraConfig.tiny(**kw), jcfg, np_tree, from_numpy_tree(np_tree, device="cpu")


def _gen_kw(tree: str, **kw):
    return dict(eos_token_id=-1, **TREES[tree][2], **kw)


def _t2i_inputs(cfg):
    """libra_tpu's tests/test_2d_mode.py prompt: [bos, w, w, BOI]."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    boi = cfg.vocab_size + cfg.vision_vocab_size - 2
    return {"input_ids": np.broadcast_to(np.array([[1, 7, 9, boi]]), (Q, 1, 4)).copy(),
            "attention_mask": np.ones((1, 4), np.int64),
            "vision_indices": np.array([[Mv, Mv, Mv, 0]]), "coninous_signal": None}


def _vqa_inputs(cfg, seed=4):
    """Two rows of [text][one image block][text], row 1 left-padded by 2,
    a continuous signal at the image rows; the prompts end in text."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    rs = np.random.RandomState(seed)
    B, N = 2, 6 + Mv
    ids = np.broadcast_to(rs.randint(3, cfg.vocab_size, (1, B, N)), (Q, B, N)).copy()
    vi = np.full((B, N), Mv, np.int64)
    for b in range(B):
        s = 2 + b
        vi[b, s:s + Mv] = np.arange(Mv)
        ids[:, b, s:s + Mv] = cfg.vocab_size + rs.randint(0, cfg.vision_vocab_size - 2,
                                                          (Q, Mv))
    mask = np.ones((B, N), np.int64)
    mask[1, :2] = 0
    sig = (rs.randn(B, N, cfg.contiguous_signal_size) * 0.1).astype(np.float32)
    sig[vi >= Mv] = 0.0
    return {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
            "coninous_signal": sig}


def _run_both(tree, mode, inputs, grid=True, **gen_kw):
    """(JAX's, the port's) Generator results on one tree and prompt."""
    cfg, jcfg, np_tree, params = _setup(tree, mode, grid)
    want = jgen.Generator(np_tree, jcfg)(inputs, jgen.GenerationConfig(**_gen_kw(tree, **gen_kw)))
    got = tgen.Generator(params, cfg)(inputs, tgen.GenerationConfig(**_gen_kw(tree, **gen_kw)))
    return want, got


# ---------------------------------------------------------------------------
# RoPE and positions
# ---------------------------------------------------------------------------

def test_apply_rope_2d_matches_jax():
    rs = np.random.RandomState(0)
    B, N, H, d = 2, 7, 4, 16
    x = rs.randn(B, N, H, d).astype(np.float32)
    pos = rs.randint(0, 40, (B, 2, N))
    cos, sin = jrope.rope_cos_sin(64, d)
    want = jrope.apply_rope_2d(jnp.asarray(x), cos, sin, jnp.asarray(pos))
    tcos, tsin = trope.rope_cos_sin(64, d)
    got = trope.apply_rope_2d(torch.from_numpy(x), tcos, tsin, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # equal row and column positions: every head takes the 1D rotation
    same = torch.from_numpy(np.repeat(pos[:, :1], 2, axis=1))
    torch.testing.assert_close(trope.apply_rope_2d(torch.from_numpy(x), tcos, tsin, same),
                               trope.apply_rope(torch.from_numpy(x), tcos, tsin, same[:, 0]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("R", [2, 3])
def test_make_2d_pos_offset_matches_jax(R):
    kw = dict(image_feature_resolution=R, max_vision_token_length=R * R + 2)
    got = TM.make_2d_pos_offset(LibraConfig.tiny(**kw))
    want = JM.make_2d_pos_offset(JM.LibraConfig.tiny(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_get_2d_position_ids_matches_jax(masked):
    """Text, BOI, the grid, EOI, text, a second image; with a mask, row 1
    left-padded by 2 and a masked EOI (which keeps its R + 1 step)."""
    cfg = LibraConfig.tiny(**GRID)
    R, Mv = cfg.image_feature_resolution, cfg.max_vision_token_length
    vi = np.full((2, 3 + Mv + 2 + Mv), Mv, np.int64)
    vi[:, 3:3 + Mv] = np.arange(Mv)
    vi[:, 5 + Mv:5 + 2 * Mv] = np.arange(Mv)
    mask = np.ones(vi.shape, np.int64)
    if masked:
        mask[1, :2] = 0
        mask[0, 3 + Mv - 1] = 0                      # an EOI
    jcfg = JM.LibraConfig.tiny(**GRID)
    want = np.asarray(JM.get_2d_position_ids(jcfg, jnp.asarray(vi),
                                             jnp.asarray(mask) if masked else None))
    got = TM.get_2d_position_ids(cfg, torch.from_numpy(vi),
                                 torch.from_numpy(mask) if masked else None).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 2, vi.shape[1])
    # row 1 (no masked EOI): text steps by 1, the grid stays on BOI's base
    # with 1-indexed (row, col), EOI steps by R + 1
    r = got[1] if not masked else got[1] - got[1, :, 2:3] + 1
    base = r[0, 3]                                   # BOI
    np.testing.assert_array_equal(r[:, 4:4 + R * R] - base,
                                  np.stack(np.divmod(np.arange(R * R), R)) + 1)
    assert r[0, 3 + Mv - 1] == base + R + 1 and r[0, 3 + Mv] == base + R + 2


def test_rope_positions_text_rows_are_the_base():
    """The decode's and the verify window's positions: a text token's
    offset is (0, 0), so its row and column ids are both the base."""
    cfg = LibraConfig.tiny(use_2d_rope=True, **GRID)
    Mv = cfg.max_vision_token_length
    base = torch.tensor([[5, 6, 7]])
    vi = torch.tensor([[Mv, 0, 1]])
    got = TM.rope_positions(cfg, base, vi)
    assert got.tolist() == [[[5, 6, 8], [5, 6, 8]]]
    assert TM.rope_positions(LibraConfig.tiny(), base, vi) is base


# ---------------------------------------------------------------------------
# The 2D head
# ---------------------------------------------------------------------------

def test_compute_vision_logits_2d_matches_oracle_and_jax():
    """Mirrors libra_tpu's test_2d_inputs_match_oracle (two image blocks a
    row); also equal to JAX's function everywhere, and with h_up given as
    the ring supplies it (the hidden R - 1 steps back) equal to the
    shifted form."""
    kw = dict(vision_prediction_mode="2d", **GRID)
    cfg, jcfg, np_tree, params = _setup("plain", "pred")
    R, Mv, D = cfg.image_feature_resolution, cfg.max_vision_token_length, cfg.hidden_size
    B, N = 2, 3 + Mv + 2 + Mv
    h = np.random.RandomState(1).randn(B, N, D).astype(np.float32)
    vi = np.full((B, N), Mv, np.int64)
    vi[:, 3:3 + Mv] = np.arange(Mv)
    vi[:, 5 + Mv:] = np.arange(Mv)
    got = TM.compute_vision_logits_2d(params, cfg, torch.from_numpy(h), torch.from_numpy(vi))
    want = JM.compute_vision_logits_2d(jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg,
                                       jnp.asarray(h), jnp.asarray(vi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = np.einsum("bnd,qdv->qbnv",
                       oracle_2d_inputs(LibraConfig.tiny(**kw), h, vi,
                                        np_tree["vision_hidden_placeholder"]),
                       np_tree["vision_lm_head"])
    flag = vi < Mv
    np.testing.assert_allclose(got.numpy()[:, flag], oracle[:, flag], rtol=1e-4, atol=1e-4)
    up = np.concatenate([np.zeros((B, R - 1, D), np.float32), h[:, :-(R - 1)]], axis=1)
    ring = TM.compute_vision_logits_2d(params, cfg, torch.from_numpy(h), torch.from_numpy(vi),
                                       h_up=torch.from_numpy(up))
    torch.testing.assert_close(ring, got, rtol=0, atol=0)


def test_forward_2d_hidden_states_match_jax():
    """Both modes on, with the defaults' 2D positions (a left-padded row)."""
    cfg, jcfg, np_tree, params = _setup("plain", "both")
    ids, mask, vi, sig = _batch(cfg, N=18)
    want = jax.jit(lambda p, *a: JM.forward(p, jcfg, *a).hidden_states)(
        np_tree, ids, mask, vi, sig)
    got = TM.forward(params, cfg, *map(torch.from_numpy, (ids, mask, vi, sig))).hidden_states
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree,mode", [("plain", "pred"), ("plain", "rope"),
                                       ("plain", "both"), ("int8", "both"),
                                       ("int4", "both")])
def test_2d_t2i_generation_matches_jax(tree, mode):
    """libra_tpu's test_2d_generation_runs / test_2d_rope_generation_
    consistency prompt: a whole image block through the dual-path decode
    (the ring, the carried base), the forced newline, then text; tokens
    equal to JAX's."""
    cfg = _setup(tree, mode)[0]
    Mv = cfg.max_vision_token_length
    want, got = _run_both(tree, mode, _t2i_inputs(cfg), max_new_tokens=Mv + 2)
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    new = got.sequences[:, :, 4:]
    assert bool((new[:, :, :Mv - 1] >= cfg.vocab_size).all())
    assert bool((new[:, :, Mv - 1] == cfg.newline_token_id).all())


@pytest.mark.parametrize("mode", list(MODES))
def test_2d_decode_logits_match_full_sequence(mode):
    """The decode's logits at every step of the block equal the teacher-
    forced full-sequence logits of the same tokens (the ring's up-neighbour
    and the carried positions are consistent with the full-sequence form),
    within 1e-5; libra_tpu's tests check the argmax."""
    cfg, _, _, params = _setup("plain", mode)
    Mv, N = cfg.max_vision_token_length, 4
    inputs = _t2i_inputs(cfg)
    steps = []
    sample = tgen.sample_tokens

    def record(logits, gen, generator=None):
        steps.append(logits)
        return sample(logits, gen, generator)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen, "sample_tokens", record)
        res = tgen.Generator(params, cfg)(inputs, tgen.GenerationConfig(
            max_new_tokens=Mv, eos_token_id=-1))
    seq = res.sequences
    full_vi = torch.from_numpy(np.concatenate([inputs["vision_indices"],
                                               np.arange(1, Mv)[None]], 1))
    full = seq[:, :, :N + Mv - 1]
    out = TM.forward(params, cfg, full, torch.ones_like(full_vi), full_vi)
    h = out.hidden_states
    vl = (TM.compute_vision_logits_2d(params, cfg, h, full_vi)
          if cfg.vision_prediction_mode == "2d" else TM.compute_vision_logits(params, h))
    logits = TM.assemble_logits(cfg, TM.compute_text_logits(params, h), vl, full_vi < Mv)
    # the steps that predict the block's Mv - 1 tokens (the step after
    # EOI is the forced newline)
    want = logits[:, 0, N - 1:N + Mv - 2]                           # (Q, Mv - 1, Vc)
    got = torch.stack([s[:, 0] for s in steps[:Mv - 1]], dim=1)
    V = cfg.vocab_size
    np.testing.assert_allclose(got[..., V:].numpy(), want[..., V:].numpy(), **TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), seq[:, 0, N:N + Mv - 1].numpy())


@pytest.mark.parametrize("tree", list(TREES))
def test_2d_rope_vqa_generation_matches_jax(tree):
    """A 2D-RoPE prompt with an image ending in text, one row left-padded:
    the carried base through a text decode; tokens equal to JAX's."""
    cfg = _setup(tree, "both")[0]
    want, got = _run_both(tree, "both", _vqa_inputs(cfg), max_new_tokens=6)
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))


@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_spec_matches_2d_rope(tree):
    """libra_tpu's test_spec_matches_2d_rope: the spec Generator's tokens
    equal the standard Generator's (JAX's) under 2D RoPE."""
    cfg, jcfg, np_tree, params = _setup(tree, "rope")
    inputs = _vqa_inputs(cfg, seed=5)
    base = dict(max_new_tokens=8, decode_modality="text")
    want = jgen.Generator(np_tree, jcfg)(inputs, jgen.GenerationConfig(**_gen_kw(tree, **base)))
    got = tgen.Generator(params, cfg)(inputs, tgen.GenerationConfig(
        **_gen_kw(tree, spec_decode=3, **base)))
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    assert int(got.iterations) <= 8


# ---------------------------------------------------------------------------
# Chat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_session_2d_rope(tree):
    """libra_tpu's test_session_2d_rope: two turns equal to JAX's
    ChatSession; in the plain tree (libra_tpu's case) each also to JAX's
    Generator over the history."""
    cfg, jcfg, np_tree, params = _setup(tree, "rope")
    kw = dict(batch=1, max_len=128, delta_bucket=1)
    js = jchat.ChatSession(np_tree, jcfg, gen=jgen.GenerationConfig(**_gen_kw(tree)), **kw)
    ts = ChatSession(params, cfg, gen=tgen.GenerationConfig(**_gen_kw(tree)), **kw)
    t1 = _turn1_inputs(jcfg, 1, seed=7)
    t2 = _text_delta(jcfg, 1, 3, seed=8)
    answers = []
    for turn in (t1, t2):
        got = ts.ask(turn, max_new_tokens=4)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(js.ask(turn, max_new_tokens=4).tokens))
        answers.append((got.tokens.numpy(), got.num_generated.numpy()))
    if tree != "plain":
        return
    g = jgen.Generator(np_tree, jcfg)
    for i in range(2):
        full = _concat_history(jcfg, [t1, t2][:i + 1], answers[:i])
        want = g(full, jgen.GenerationConfig(max_new_tokens=4, **_gen_kw(tree)))
        np.testing.assert_array_equal(answers[i][0], np.asarray(want.sequences)[:, :, -4:])


def test_spec_session_2d_rope():
    """A spec session under 2D RoPE (the verify window's positions and the
    flush step's) emits the standard session's tokens over two turns, two
    rows with different deltas."""
    cfg, jcfg, _, params = _setup("plain", "rope")
    sessions = [ChatSession(params, cfg, batch=2, max_len=128, delta_bucket=4,
                            gen=tgen.GenerationConfig(**_gen_kw("plain", spec_decode=s)))
                for s in (0, 3)]
    t1 = _turn1_inputs(jcfg, 2, seed=9)
    t2 = _text_delta(jcfg, 2, 5, seed=10)
    for turn in (t1, t2):
        std, spec = (s.ask(turn, max_new_tokens=6) for s in sessions)
        np.testing.assert_array_equal(spec.tokens.numpy(), std.tokens.numpy())


def test_session_refuses_2d_prediction():
    """ChatSession refuses 2D prediction with libra_tpu's message."""
    cfg, jcfg, np_tree, params = _setup("plain", "pred")
    with pytest.raises(NotImplementedError) as want:
        jchat.ChatSession(np_tree, jcfg, batch=1, max_len=64)
    with pytest.raises(NotImplementedError) as got:
        ChatSession(params, cfg, batch=1, max_len=64)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Serving engine
# ---------------------------------------------------------------------------

def _requests(cfg, lengths=(3, 3, 3), max_new=(5, 4, 6)):
    """libra_tpu's test_serving requests: [t text][one image block][2 text],
    unpadded, a continuous signal."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    reqs = []
    for i, t in enumerate(lengths):
        rs = np.random.RandomState(i)
        N = t + Mv + 2
        ids = np.broadcast_to(rs.randint(3, cfg.vocab_size, (1, N)), (Q, N)).copy()
        ids[:, t:t + Mv] = cfg.vocab_size + rs.randint(0, cfg.vision_vocab_size - 2, (Q, Mv))
        vi = np.full((N,), Mv, np.int64)
        vi[t:t + Mv] = np.arange(Mv)
        sig = (rs.randn(N, cfg.contiguous_signal_size) * 0.1).astype(np.float32)
        reqs.append(Request(i, ids, vi, sig, max_new_tokens=max_new[i]))
    return reqs


def _engine_parity(tree, mode, reqs, grid=True, **kw):
    """The port's engine tokens equal JAX's Generator on each request alone
    (each reference run at the longest budget and sliced: greedy with no
    EOS, its first tokens are those of a shorter run)."""
    cfg, jcfg, np_tree, params = _setup(tree, mode, grid)
    eng = ServingEngine(params, cfg, gen=tgen.GenerationConfig(**_gen_kw(tree)), **kw)
    results = eng.run(reqs)
    g = jgen.Generator(np_tree, jcfg)
    longest = max(r.max_new_tokens for r in reqs)
    for res, req in zip(results, reqs):
        N = req.input_ids.shape[-1]
        sig = None if req.contiguous_signal is None else req.contiguous_signal[None]
        want = g({"input_ids": req.input_ids[:, None], "attention_mask": np.ones((1, N)),
                  "vision_indices": req.vision_indices[None], "coninous_signal": sig},
                 jgen.GenerationConfig(max_new_tokens=longest, **_gen_kw(tree)))
        np.testing.assert_array_equal(
            res.tokens, np.asarray(want.sequences)[:, 0, N:N + req.max_new_tokens],
            err_msg=f"request {res.request_id}")
    return eng


@pytest.mark.parametrize("tree,mode", [("plain", "pred"), ("plain", "rope"),
                                       ("int8", "both"), ("int4", "both")])
def test_engine_2d_modes(tree, mode):
    """libra_tpu's test_engine_2d_mode and test_engine_2d_rope: the per-slot
    ring (installed at the prompt pass, advanced by the decode chunk,
    frozen for idle slots) and the per-slot base counter reproduce the
    Generator's tokens, a slot recycled; merged prefill resolves off."""
    cfg = _setup(tree, mode)[0]
    eng = _engine_parity(tree, mode, _requests(cfg), max_batch=2, max_len=64)
    assert not eng._merged_on and eng.stats["merged_installs"] == 0


def test_engine_2d_short_prompt_ring():
    """libra_tpu's test_engine_2d_short_prompt_ring: a 2-token prompt under
    R - 1 = 3, its ring left-padded with zeros."""
    kw = dict(image_feature_resolution=4, max_vision_token_length=18, vision_vocab_size=20)
    jcfg, np_tree = _trees(tuple(sorted({**MODES["pred"], **kw}.items())), 0)
    cfg = LibraConfig.tiny(**MODES["pred"], **kw)
    ids = np.random.RandomState(0).randint(3, cfg.vocab_size, (cfg.vision_codebook_num, 2))
    vi = np.full((2,), cfg.max_vision_token_length, np.int64)
    eng = ServingEngine(from_numpy_tree(np_tree, device="cpu"), cfg, max_batch=1, max_len=64,
                        gen=tgen.GenerationConfig(eos_token_id=-1))
    res = eng.run([Request(0, ids, vi, max_new_tokens=4)])[0]
    want = jgen.Generator(np_tree, jcfg)(
        {"input_ids": ids[:, None], "attention_mask": np.ones((1, 2)),
         "vision_indices": vi[None]}, jgen.GenerationConfig(max_new_tokens=4, eos_token_id=-1))
    assert res.tokens.shape == (cfg.vision_codebook_num, 4)
    np.testing.assert_array_equal(res.tokens, np.asarray(want.sequences)[:, 0, 2:])


@pytest.mark.parametrize("mode", ["pred", "rope"])
def test_engine_2d_merged_prefill_resolves_off(mode):
    """merged_prefill=None resolves off in either 2D mode, where libra_tpu's
    does (a pool long enough for it in 1D); True raises."""
    cfg, jcfg, np_tree, params = _setup("plain", mode)
    kw = dict(max_batch=2, max_len=256, merged_chunk=8)
    assert not ServingEngine(params, cfg, **kw)._merged_on
    assert not jserving.ServingEngine(np_tree, jcfg, **kw)._merged_on
    assert ServingEngine(params, LibraConfig.tiny(**GRID), **kw)._merged_on
    with pytest.raises(ValueError, match="merged_prefill"):
        ServingEngine(params, cfg, merged_prefill=True, **kw)


def test_spec_engine_2d_rope():
    """The engine's spec chunk under 2D RoPE (its verify window's
    positions): the standard engine's tokens."""
    cfg, _, _, params = _setup("plain", "rope")
    reqs = _requests(cfg, lengths=(3, 5, 7), max_new=(7, 5, 6))
    out = []
    for s in (0, 3):
        eng = ServingEngine(params, cfg, max_batch=2, max_len=64,
                            gen=tgen.GenerationConfig(eos_token_id=-1, spec_decode=s))
        out.append(eng.run(reqs))
    for std, spec in zip(*out):
        np.testing.assert_array_equal(spec.tokens, std.tokens)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _train_batch(cfg, N=18):
    ids, mask, vi, sig = _batch(cfg, N=N)
    Mv = cfg.max_vision_token_length
    labels = np.where(mask[None].astype(bool), ids, -100)
    labels[:, :, 4] = -100                           # BOI
    labels = np.where(np.roll(vi == Mv - 1, 1, axis=-1)[None], -100, labels)
    return {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
            "coninous_signal": sig, "labels": labels}


@pytest.mark.parametrize("mode", ["pred", "both"])
def test_2d_loss_and_grads_match_jax(mode):
    """loss_fn in each 2D mode (the 2D head's logits, 2D RoPE's default
    positions): the loss (rtol 1e-5), every gradient (the placeholder's
    and the 2 * D-row heads' included) within PARAM_TOL, and their
    global norm (rtol 1e-5)."""
    cfg, jcfg, np_tree, params = _setup("plain", mode)
    batch = _train_batch(cfg)
    want_loss, want_g = jax.jit(jax.value_and_grad(functools.partial(
        jtrainer.loss_fn, cfg=jcfg, remat=False)))(np_tree, batch=batch)
    loss, grads = ttrainer.masked_value_and_grad(
        lambda p: ttrainer.loss_fn(p, cfg, _to_torch(batch), remat=False), params)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_flat = _flat(want_g)
    got = {k: g.numpy() for k, g in grads.items()}
    assert got.keys() == want_flat.keys()
    for k in want_flat:
        np.testing.assert_allclose(got[k], want_flat[k], err_msg=k, **PARAM_TOL)
    if cfg.vision_prediction_mode == "2d":
        assert np.abs(got["vision_hidden_placeholder"]).max() > 0
    norm = lambda t: np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())  # noqa: E731
                                 for v in t.values()))
    np.testing.assert_allclose(norm(got), norm(want_flat), rtol=1e-5)


def test_2d_train_steps_match_jax():
    """Three frozen-language AdamW steps with both 2D modes on: loss and
    grad_norm rtol 1e-5 each step, params within PARAM_TOL (as
    test_torch_port_train's test_train_step_matches)."""
    cfg, jcfg, p, _ = _setup("plain", "both")
    kw = dict(frozen_language=True, total_steps=10, warmup_ratio=0.0, learning_rate=1e-3)
    batch = _train_batch(cfg)
    jo = jopt.make_optimizer(jopt.OptimizerConfig(**kw), p)
    jstep = jax.jit(functools.partial(jtrainer.train_step, cfg=jcfg, opt=jo,
                                      grad_mask=jopt.trainable_mask(p, jopt.OptimizerConfig(**kw)),
                                      remat=True))
    jstate = jtrainer.init_state(p, jo)
    tparams = from_numpy_tree(p, device="cpu")
    to = topt.make_optimizer(topt.OptimizerConfig(**kw), tparams)
    tstate = ttrainer.init_state(tparams, to)
    tmask = topt.trainable_mask(tparams, topt.OptimizerConfig(**kw))
    for _ in range(3):
        jstate, jm = jstep(jstate, batch)
        tstate, tm = ttrainer.train_step(tstate, _to_torch(batch), cfg=cfg, opt=to,
                                         grad_mask=tmask, remat=True)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    _assert_trees_close(tstate.params, jstate.params, **PARAM_TOL)


def test_2d_fused_loss_matches_jax():
    """The fused pretrain loss (CLIP + LFQ inside, as training/fused.py:126
    in libra_tpu) with both 2D modes on, the tiny grid: rtol 1e-5."""
    cfg, jcfg, p, params = _setup("plain", "both", grid=False)
    jvq = JVQGANConfig.tiny()
    np_vq = _np_vq_params(jvq)
    jb, tb = _batches(jcfg)
    want = jax.jit(functools.partial(jfused.fused_loss_fn, cfg=jcfg, vq_cfg=jvq,
                                     remat=False, attn_impl="xla"))(p, np_vq, batch=jb)
    got = tfused.fused_loss_fn(params, from_numpy_tree(np_vq, device="cpu"), cfg,
                               VQGANConfig.tiny(), tb, remat=False)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _digest(tree) -> str:
    h = hashlib.sha256()
    for path, leaf in sorted(_flat_tensors(tree)):
        h.update(path.encode())
        h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tensors(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# sha256 of init_params' 1D trees (torch.Generator seeded 0, CPU) as the
# port drew them before the 2D modes: the new draws come after all of them
DIGESTS_1D = {
    (): "10397d45f48bbdbb5c8e11db201142737b4466d744d503a09231c2e545913712",
    (("concat_signals", False), ("use_vision_position_embedding", True)):
        "772b7a49ba18d8126c75929670fa65d128a64dc90955f6dba7f378529c2e5d6f",
    (("dtype", "bfloat16"), ("param_dtype", "bfloat16")):
        "9d561ed44ff1538d5e728ef9457ceecdff046812492a45be9cfb947bf9724a3b",
}


def test_init_params_1d_tree_unchanged_and_2d_tree_matches_jax():
    for kw, digest in DIGESTS_1D.items():
        cfg = LibraConfig.tiny(**dict(kw))
        assert _digest(TM.init_params(torch.Generator().manual_seed(0), cfg, "cpu")) == digest
    one = TM.init_params(torch.Generator().manual_seed(0), LibraConfig.tiny(), "cpu")
    for mode, kw in MODES.items():
        two = TM.init_params(torch.Generator().manual_seed(0), LibraConfig.tiny(**kw), "cpu")
        want = jax.eval_shape(functools.partial(JM.init_params, cfg=JM.LibraConfig.tiny(**kw)),
                              jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in _flat_tensors(two)} == \
            {k: tuple(v.shape) for k, v in _flat_tensors(want)}, mode
        # every leaf drawn before the vision heads is the 1D tree's
        for name in ("embed_tokens", "vision_embed_tokens", "lm_head"):
            assert torch.equal(two[name], one[name])
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(_flat_tensors(two["layers"]), _flat_tensors(one["layers"])))


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["both"])
def test_generate_image_2d_matches_jax(mode):
    """LibraPipeline.generate_image on a 2D config (the tiny grid): equal
    tokens to JAX's pipeline over the whole call."""
    from libra_tpu import pipeline as jpipeline
    from tests.test_torch_port_t2i import CAPTION, _make_tokenizers
    from libra_tpu_torch import pipeline as tpipeline
    cfg, jcfg, p, params = _setup("plain", mode, grid=False)
    jtok, ttok = _make_tokenizers()
    pipes = (jpipeline.LibraPipeline(jcfg, p, jtok, image_processor=lambda im: im),
             tpipeline.LibraPipeline(cfg, params, ttok, lambda im: im))
    seqs = []
    for pipe in pipes:
        generate = pipe.generator
        pipe.generator = lambda *a, g=generate, **k: seqs.append(g(*a, **k)) or seqs[-1]
        assert pipe.generate_image(CAPTION, temperature=0.0).shape == (28, 28, 3)
    np.testing.assert_array_equal(seqs[1].sequences.numpy(), np.asarray(seqs[0].sequences))
