"""The port's prompt-lookup speculative decoding (libra_tpu_torch/
spec_decode.py and the Generator's spec path) against libra_tpu, at a
tiny size in fp32 on the CPU. Mirrors tests/test_spec_decode.py.

The drafter and the window write are held equal to JAX's on seeded
histories. The spec Generator's sequences, num_generated and iterations
are held equal to JAX's spec Generator on one parameter tree, and its
tokens to the port's standard Generator: the plain tree (gamma 3, an EOS
that desyncs the rows at gamma 4, the int8 cache at gamma 2) and the int8
and int4 trees with the int8 cache on the head-dim-128 tiny config, whose
verify passes take the decode-attention branch at N = gamma + 1 (its
plain version here; JAX runs its Pallas kernel in interpret mode). The
trees are tests/test_torch_port_serving.py's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import generation as jgen
from libra_tpu import spec_decode as jspec
from libra_tpu.ops.pallas import decode_attention as JDA
from libra_tpu_torch import generation as tgen
from libra_tpu_torch import spec_decode as tspec
from libra_tpu_torch.models import libra as TM
from tests.test_torch_port_serving import TREES, _setup


def _prompt_with_image(cfg, B, text_len, seed=0):
    """tests/test_spec_decode.py's prompts: random text with one image
    block at 1 + b in row b, a continuous signal on it; ends in text."""
    Mv = cfg.max_vision_token_length
    N = text_len + Mv
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, cfg.vocab_size,
                     size=(cfg.vision_codebook_num, B, N)).astype(np.int64)
    vi = np.full((B, N), Mv, np.int64)
    for b in range(B):
        s = 1 + b
        vi[b, s:s + Mv] = np.arange(Mv)
        ids[:, b, s:s + Mv] = rs.randint(
            cfg.vocab_size, cfg.vocab_size + cfg.vision_vocab_size, size=Mv)
    sig = rs.randn(B, N, cfg.contiguous_signal_size).astype(np.float32)
    sig[vi >= Mv] = 0.0
    return {"input_ids": ids, "attention_mask": np.ones((B, N), np.int64),
            "vision_indices": vi, "coninous_signal": sig}


# -- the drafter and the window write ------------------------------------


def _jax_drafts(hist, valid, P, pending, gamma):
    return np.asarray(jspec._bigram_drafts(jnp.asarray(hist), jnp.asarray(valid),
                                           jnp.asarray(P), jnp.asarray(pending), gamma))


def _port_drafts(hist, valid, P, pending, gamma):
    return tspec._bigram_drafts(torch.from_numpy(hist), torch.from_numpy(valid),
                                torch.from_numpy(P), torch.from_numpy(pending),
                                gamma).numpy()


def test_bigram_drafts_handcrafted():
    """tests/test_spec_decode.py's two histories: no match (the bigram's
    only occurrence is the pending pair itself), then a match at j = 0
    whose continuation is proposed; and a match at the end of the history,
    whose continuation runs into the gamma padding (the clamp path)."""
    hist = np.asarray([[5, 6, 7, 8, 9, 5, 6, 6, 0, 0, 0, 0]])
    valid = np.asarray([[True] * 8 + [False] * 4])
    args = (hist, valid, np.asarray([7]), np.asarray([6]), 3)
    np.testing.assert_array_equal(_port_drafts(*args), _jax_drafts(*args))
    hist2 = np.asarray([[5, 6, 7, 8, 9, 5, 6, 0, 0, 0, 0, 0]])
    valid2 = np.asarray([[True] * 7 + [False] * 5])
    args = (hist2, valid2, np.asarray([6]), np.asarray([6]), 3)
    got = _port_drafts(*args)
    np.testing.assert_array_equal(got[0], [7, 8, 9])
    np.testing.assert_array_equal(got, _jax_drafts(*args))
    # (4, 5) at j = 8 of St = 10: src = 10 is clamped to 9, and the
    # drafts read hist[9] then the zero padding
    hist3 = np.asarray([[1, 2, 3, 4, 5, 1, 2, 3, 4, 5]])
    args = (hist3, np.ones_like(hist3, bool), np.asarray([10]), np.asarray([5]), 4)
    np.testing.assert_array_equal(_port_drafts(*args), _jax_drafts(*args))


@pytest.mark.parametrize("B,St,gamma", [(1, 8, 1), (2, 16, 3), (3, 24, 4),
                                        (4, 40, 7), (2, 9, 8)])
@pytest.mark.parametrize("seed", [0, 1])
def test_bigram_drafts_match_jax(B, St, gamma, seed):
    """Seeded histories over a 4-token vocab (so bigrams repeat), random
    valid spans with stale tails, P anywhere from 0 to St - 1."""
    rs = np.random.RandomState(seed * 100 + St)
    hist = rs.randint(0, 4, (B, St)).astype(np.int64)
    P = rs.randint(0, St, (B,)).astype(np.int64)
    pending = rs.randint(0, 4, (B,)).astype(np.int64)
    valid = np.arange(St)[None] < P[:, None]
    valid &= rs.rand(B, St) > 0.1
    args = (hist, valid, P, pending, gamma)
    np.testing.assert_array_equal(_port_drafts(*args), _jax_drafts(*args))


@pytest.mark.parametrize("K,S", [(1, 8), (3, 12), (4, 10), (8, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_window_matches_jax(K, S, seed):
    """Per-row windows of K at starts past S - K too (clamped as XLA's
    dynamic_update_slice clamps), with per-row write masks and with the
    same segment and mask for every row."""
    rs = np.random.RandomState(seed + 10 * K)
    B = 4
    buf = rs.randint(0, 50, (B, S)).astype(np.int64)
    seg = rs.randint(50, 99, (B, K)).astype(np.int64)
    start = np.asarray([0, S - K, S - 1, S + 3][:B], np.int64)
    write = rs.rand(B, K) > 0.4
    want = np.asarray(jax_vmap_update(buf, seg, start, write))
    got = tspec._update_window(torch.from_numpy(buf.copy()), torch.from_numpy(seg),
                               torch.from_numpy(start), torch.from_numpy(write))
    np.testing.assert_array_equal(got.numpy(), want)
    # one segment for every row, written everywhere (the verify pass's mask)
    ones = np.ones((K,), np.int64)
    want = np.asarray(jax_vmap_update(buf, ones, start, np.ones((K,), bool),
                                      in_axes=(0, None, 0, None)))
    got = tspec._update_window(torch.from_numpy(buf.copy()), torch.from_numpy(ones),
                               torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), want)


def jax_vmap_update(buf, seg, start, write, in_axes=(0, 0, 0, 0)):
    import jax
    return jax.vmap(jspec._update_window, in_axes=in_axes)(
        jnp.asarray(buf), jnp.asarray(seg), jnp.asarray(start), jnp.asarray(write))


# -- the spec Generator against libra_tpu and the standard Generator ------


def _generators(tree):
    cfg, jcfg, np_tree, params = _setup(tree)
    return cfg, jgen.Generator(np_tree, jcfg), tgen.Generator(params, cfg)


def _assert_parity(spec, ref, N):
    """Equal num_generated, and sequences equal on the prompt and each
    row's generated span (past a row's EOS both loops leave artefacts)."""
    ng_s, ng_r = np.asarray(spec.num_generated), np.asarray(ref.num_generated)
    np.testing.assert_array_equal(ng_s, ng_r)
    seq_s, seq_r = np.asarray(spec.sequences), np.asarray(ref.sequences)
    assert seq_s.shape == seq_r.shape
    for b in range(seq_r.shape[1]):
        end = N + ng_r[b]
        np.testing.assert_array_equal(seq_s[:, b, :end], seq_r[:, b, :end])


# (tree, gamma, B, text_len, seed, max_new, eos step or None, extra gen keywords)
SPEC_CASES = {
    "plain_gamma3": ("plain", 3, 2, 5, 1, 12, None, {}),
    "plain_eos_desync_gamma4": ("plain", 4, 3, 4, 2, 10, 4, {}),
    "plain_kv8_gamma2": ("plain", 2, 2, 5, 3, 9, None, dict(kv_quant=True)),
    "int8_kv8_gamma3": ("int8", 3, 2, 4, 7, 8, None, dict(a8_prefill=True)),
    "int4_kv8_gamma3": ("int4", 3, 2, 4, 7, 8, None, dict(a8_prefill=True)),
    "int8_kv8_gamma7": ("int8", 7, 2, 4, 8, 10, None, {}),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_generator_matches_jax_and_standard(case, monkeypatch):
    """The port's spec Generator: sequences, num_generated and iterations
    equal to JAX's spec Generator; tokens and num_generated equal to the
    port's standard Generator. The quantized trees' verify passes take
    the decode-attention branch at N = gamma + 1 (JAX's Pallas kernel in
    interpret mode)."""
    tree, gamma, B, text_len, seed, max_new, eos_at, kw = SPEC_CASES[case]
    monkeypatch.setattr(JDA, "INTERPRET", True)
    cfg, jg, tg = _generators(tree)
    inp = _prompt_with_image(cfg, B, text_len, seed)
    N = inp["vision_indices"].shape[1]
    base = dict(max_new_tokens=max_new, eos_token_id=-1, decode_modality="text",
                **TREES[tree][2], **kw)
    if eos_at is not None:
        # an EOS that occurs mid-stream, so rows finish at different
        # iterations (per-row indices, truncation)
        probe = tg(inp, tgen.GenerationConfig(**base))
        base["eos_token_id"] = int(probe.sequences[0, 0, N + eos_at])
    calls = []
    real = TM.int8_decode_attention

    def count(q, *a, **k):
        calls.append(q.shape[1])
        return real(q, *a, **k)
    monkeypatch.setattr(TM, "int8_decode_attention", count)
    ref = tg(inp, tgen.GenerationConfig(**base))
    spec = tg(inp, tgen.GenerationConfig(**base, spec_decode=gamma))
    want = jg(inp, jgen.GenerationConfig(**base, spec_decode=gamma))
    np.testing.assert_array_equal(spec.sequences.numpy(), np.asarray(want.sequences))
    np.testing.assert_array_equal(spec.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    assert int(spec.iterations) == int(want.iterations)
    assert ref.iterations is None
    _assert_parity(spec, ref, N)
    if eos_at is None:
        assert (spec.num_generated.numpy() == max_new).all()
    else:
        assert len(set(spec.num_generated.tolist())) > 1 or (
            spec.num_generated.numpy() < max_new).any()
    if TREES[tree][2].get("kv_quant") and cfg.head_dim == 128:
        # the standard steps at N = 1, then the verify passes at gamma + 1
        L = cfg.num_hidden_layers
        n_std = int(ref.num_generated.max()) - 1
        assert calls == [1] * (n_std * L) + [gamma + 1] * (int(spec.iterations) * L)
    else:
        assert calls == []


def test_spec_generator_max_new_zero_and_one():
    """max_new_tokens = 0 returns the prompt alone; at 1 the loop still
    runs one verify iteration, which keeps nothing (libra_tpu's loop
    tests only the budget and EOS before it)."""
    cfg, jg, tg = _generators("plain")
    inp = _prompt_with_image(cfg, 2, 3, seed=4)
    for n in (0, 1):
        gen = dict(max_new_tokens=n, eos_token_id=-1, decode_modality="text",
                   spec_decode=3)
        got = tg(inp, tgen.GenerationConfig(**gen))
        want = jg(inp, jgen.GenerationConfig(**gen))
        np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
        np.testing.assert_array_equal(got.num_generated.numpy(),
                                      np.asarray(want.num_generated))
        if n:
            assert int(got.iterations) == int(want.iterations) == 1
            assert (got.num_generated.numpy() == 1).all()


def test_spec_prefill_extra_cache():
    """_prefill(extra_cache=k) holds k more cache and mask slots, the same
    tokens and positions, and the same logits and prompt K/V up to fp32
    summation order (the masked extra keys add exact zeros to sums of
    another length); extra_cache=0 is the standard pass."""
    cfg, _, _, params = _setup("plain")
    inp = _prompt_with_image(cfg, 2, 3, seed=5)
    args = [torch.as_tensor(inp[k]) for k in ("input_ids", "attention_mask",
                                              "vision_indices", "coninous_signal")]
    gen = tgen.GenerationConfig(max_new_tokens=4, eos_token_id=-1)
    with torch.inference_mode():
        a = tgen._prefill(params, *args, cfg=cfg, gen=gen)
        b = tgen._prefill(params, *args, cfg=cfg, gen=gen, extra_cache=3)
    N = args[0].shape[-1]
    assert a.mask_buf.shape == (2, N + 4) and b.mask_buf.shape == (2, N + 7)
    assert a.cache.k.shape[2] == N + 4 and b.cache.k.shape[2] == N + 7
    assert a.tokens.shape == b.tokens.shape == (cfg.vision_codebook_num, 2, N + 4)
    assert torch.equal(b.tokens, a.tokens)
    torch.testing.assert_close(b.logits, a.logits, rtol=0, atol=1e-5)
    torch.testing.assert_close(b.cache.k[:, :, :N], a.cache.k[:, :, :N], rtol=0, atol=1e-5)
    assert torch.equal(b.last_pos, a.last_pos)


def test_spec_rejects_sampling_dual_and_t2i():
    """Spec decode is greedy text-mode only, as in libra_tpu: sampling, an
    explicit dual decode and a t2i prompt (ends at BOI, resolves to dual)
    raise ValueError in both packages."""
    cfg, jg, tg = _generators("plain")
    inp = _prompt_with_image(cfg, 1, 3, seed=5)
    Mv = cfg.max_vision_token_length
    ids = np.random.RandomState(6).randint(3, cfg.vocab_size,
                                           size=(cfg.vision_codebook_num, 1, 5))
    ids[:, :, -1] = cfg.vocab_size + cfg.vision_vocab_size - 2
    vi = np.full((1, 5), Mv, np.int64)
    vi[:, -1] = 0
    t2i = {"input_ids": ids, "attention_mask": np.ones((1, 5), np.int64),
           "vision_indices": vi,
           "coninous_signal": np.zeros((1, 5, cfg.contiguous_signal_size), np.float32)}
    cases = [(inp, dict(do_sample=True, decode_modality="text")),
             (inp, dict(decode_modality="dual")),
             (t2i, dict(eos_token_id=-1))]
    for inputs, kw in cases:
        for g, G in ((jg, jgen), (tg, tgen)):
            with pytest.raises(ValueError):
                g(inputs, G.GenerationConfig(max_new_tokens=4, spec_decode=3, **kw))


def test_generation_config_spec_field_default():
    """spec_decode sits where JAX's does, with JAX's default."""
    names = [f.name for f in dataclasses.fields(tgen.GenerationConfig)]
    assert names.index("spec_decode") == names.index("split_prefill") + 1
    assert names.index("decode_modality") == names.index("spec_decode") + 1
    assert tgen.GenerationConfig().spec_decode == jgen.GenerationConfig().spec_decode == 0
