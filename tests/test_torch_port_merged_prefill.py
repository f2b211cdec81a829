"""Merged chunked prefill in the port's ServingEngine against libra_tpu, at
a tiny size in fp32 on the CPU: the chunk segment's cache writes
(_write_cache_row), the prompt installs, one merged chunk with a parked
iteration, and the engine cases of tests/test_serving.py's merged block.
Each engine case holds the port's greedy tokens equal to JAX's Generator
on each request alone AND to JAX's ServingEngine(merged_prefill=True) on
the same stream, and the engine stats (installs, merged chunks, dedicated
prefills) equal to JAX's: the scheduler is the same.

The trees are tests/test_torch_port_serving.py's (JAX's init_params with
live bridge B-weights; int8 and int4 quantized by JAX). The int8 cache's
engines run at max_len 128: libra_tpu rounds an int8 pool up to a
multiple of 128, the port does not, and equal pools schedule alike.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import generation as jgen
from libra_tpu import serving as jserving
from libra_tpu.models import libra as JM
from libra_tpu.quantization import QuantizedArray as JQuantizedArray
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.quantization import QuantizedArray
from libra_tpu_torch.serving import PromptBuffers, Request, ServingEngine, SlotState
from tests.test_torch_port_serving import (_check_parity, _engine, _gen, _host_read,
                                           _jax_tree, _requests, _setup, _vq_tree,
                                           _want)

# tests/test_serving.py's merged engines: C = 8 against prompts bucketed to 8
MERGED = dict(max_batch=2, prompt_bucket=8, merged_prefill=True, merged_chunk=8)
STATS = ("merged_installs", "merged_chunks", "dedicated_prefills")


def _jax_engine(tree: str, pixels: bool = False, gen=None, **kw):
    _, jcfg, np_tree, _ = _setup(tree)
    if pixels:
        jvq, vq_tree = _vq_tree()
        kw.update(vq_params=vq_tree, vq_cfg=jvq)
    return jserving.ServingEngine(np_tree, jcfg,
                                  gen=jgen.GenerationConfig(**(gen or _gen(tree))), **kw)


def _check_jax_engine(tree, eng, results, reqs, pixels=False, gen=None, **kw):
    """Equal tokens, finish reasons and engine stats to JAX's merged engine
    on the same stream."""
    jeng = _jax_engine(tree, pixels, gen, **kw)
    want = jeng.run(reqs)
    assert [r.request_id for r in results] == [r.request_id for r in want]
    for got, w in zip(results, want):
        np.testing.assert_array_equal(got.tokens, np.asarray(w.tokens),
                                      err_msg=f"request {got.request_id}")
        assert got.finish_reason == w.finish_reason
    assert {k: eng.stats[k] for k in STATS} == {k: jeng.stats[k] for k in STATS}


# -- the chunk segment's cache writes --------------------------------------


@pytest.mark.parametrize("write,offset", [(None, 3), (True, 9), (False, 5), (True, 11),
                                          (False, 12)],
                         ids=["always", "at-S-minus-C", "masked", "clamped",
                              "masked-clamped"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_write_cache_row_matches_jax(quantized, write, offset):
    """_write_cache_row against JAX's on the sequence-major and the
    head-major int8 buffers: a (1, C, H, d) block at [layer, row, offset];
    write=False leaves the buffer as it was; an offset past S - C clamps to
    S - C (XLA's dynamic_update_slice), 12 even past S."""
    L, B, S, H, d, C = 3, 3, 12, 2, 8, 3
    rs = np.random.RandomState(7)
    new = rs.randn(1, C, H, d).astype(np.float32)
    if quantized:
        q0 = rs.randint(-127, 128, (L, B, H, S, d)).astype(np.int8)
        s0 = rs.rand(L, B, H, S).astype(np.float32)
        jbuf = JQuantizedArray(jnp.asarray(q0), jnp.asarray(s0))
        tbuf = QuantizedArray(torch.from_numpy(q0.copy()), torch.from_numpy(s0.copy()))
    else:
        b0 = rs.randn(L, B, S, H, d).astype(np.float32)
        jbuf, tbuf = jnp.asarray(b0), torch.from_numpy(b0.copy())
    jw = None if write is None else jnp.asarray(write)
    tw = None if write is None else torch.tensor(write)
    want = JM._write_cache_row(jbuf, jnp.asarray(new), 1, jnp.int32(2), jnp.int32(offset),
                               write=jw)
    got = TM._write_cache_row(tbuf, torch.from_numpy(new), 1, torch.tensor([2]),
                              torch.tensor([offset]), write=tw)
    if quantized:
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
        changed = not np.array_equal(got.q.numpy(), q0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        changed = not np.array_equal(got.numpy(), b0)
    assert changed == (write is not False)


# -- installs and one merged chunk against JAX's ----------------------------


@functools.lru_cache(maxsize=None)
def _engines(tree: str, S: int):
    """The port's and JAX's engines of one merged chunk's test: B = 2,
    C = 8, no bucket, so each chunk runs decode_chunk = 3 iterations."""
    kw = dict(max_batch=2, max_len=S, decode_chunk=3, merged_prefill=True,
              merged_chunk=8)
    return _engine(tree, **kw), _jax_engine(tree, **kw)


def _slot1_prompt(cfg, Nb: int, rs):
    """A staged request of Nb positions: 3 left pads, an image block at 5,
    a signal; the positions as the engine stages them."""
    Q, Mv, V = cfg.vision_codebook_num, cfg.max_vision_token_length, cfg.vocab_size
    pm = np.ones((Nb,), np.int64)
    pm[:3] = 0
    ids = np.broadcast_to(rs.randint(3, V, (1, Nb)), (Q, Nb)).copy()
    ids[:, 5:5 + Mv] = V + rs.randint(0, cfg.vision_vocab_size, (Q, Mv))
    vi = np.full((Nb,), Mv, np.int64)
    vi[5:5 + Mv] = np.arange(Mv)
    pos = np.where(pm == 0, 1, np.cumsum(pm) - 1)
    sig = (rs.randn(Nb, cfg.contiguous_signal_size) * 0.1).astype(np.float32)
    return {"ids": ids, "vi": vi, "pm": pm, "pos": pos, "sig": sig}


def _pool(cfg, B, S, quantized, rs):
    """A filled pool's cache (numpy): random K/V and flags, per-row index."""
    L, H, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim

    def buf():
        if quantized:
            return (rs.randint(-127, 128, (L, B, H, S, d)).astype(np.int8),
                    (rs.rand(L, B, H, S) * 0.02 + 0.001).astype(np.float32))
        return (rs.randn(L, B, S, H, d) * 0.5).astype(np.float32)
    return {name: buf() for name in ("k", "v", "kb", "vb")}, rs.rand(B, S) > 0.7


def _caches(bufs, flag, index):
    """The same pool as a JAX and a port KVCache."""
    def j(x):
        return JQuantizedArray(*map(jnp.asarray, x)) if isinstance(x, tuple) else jnp.asarray(x)

    def t(x):
        if isinstance(x, tuple):
            return QuantizedArray(*(torch.from_numpy(a.copy()) for a in x))
        return torch.from_numpy(x.copy())
    jc = JM.KVCache(**{n: j(b) for n, b in bufs.items()}, flag=jnp.asarray(flag),
                    index=jnp.asarray(index, jnp.int32))
    tc = TM.KVCache(**{n: t(b) for n, b in bufs.items()}, flag=torch.from_numpy(flag.copy()),
                    index=torch.from_numpy(np.asarray(index, np.int64)))
    return jc, tc


def _assert_cache_close(got, want, atol):
    for name in ("k", "v", "kb", "vb"):
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, QuantizedArray):
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=name)
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale), rtol=1e-5,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol,
                                       err_msg=name)
    np.testing.assert_array_equal(got.flag.numpy(), np.asarray(want.flag))
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))


def test_install_matches_jax():
    """_install against JAX's: the slot's mask row zeroed, its cache index
    reset, the staged request at [0, Nb) of its prompt-buffer rows (the
    rest as it was); every buffer equal."""
    cfg = _setup("plain")[0]
    eng, jeng = _engines("plain", 64)
    B, Np, Q, Mv = 2, eng._Np, cfg.vision_codebook_num, cfg.max_vision_token_length
    assert Np == jeng._Np == 56
    rs = np.random.RandomState(11)
    bufs, flag = _pool(cfg, B, 64, False, rs)
    jc, tc = _caches(bufs, flag, [10, 33])
    mask = (rs.rand(B, 64) > 0.3).astype(np.int64)
    pbuf = dict(ids=rs.randint(0, 200, (Q, B, Np)), vi=rs.randint(0, Mv + 1, (B, Np)),
                pm=rs.randint(0, 2, (B, Np)), pos=rs.randint(0, 50, (B, Np)),
                sig=rs.randn(B, Np, cfg.contiguous_signal_size).astype(np.float32))
    req = _slot1_prompt(cfg, 16, rs)
    want = jeng._install(16)(jc, jnp.asarray(mask, jnp.int32),
                             *(jnp.asarray(pbuf[k]) for k in ("ids", "vi", "pm", "pos",
                                                              "sig")),
                             {k: jnp.asarray(v) for k, v in req.items()}, jnp.int32(1))
    state = SlotState(tc, torch.from_numpy(mask.copy()), None, None, None)
    prompts = PromptBuffers(**{k: torch.from_numpy(np.array(v)) for k, v in pbuf.items()})
    eng._install(state, prompts, {k: torch.from_numpy(v) for k, v in req.items()}, 1)
    _assert_cache_close(state.cache, want[0], 0)
    np.testing.assert_array_equal(state.mask.numpy(), np.asarray(want[1]))
    for got, w in zip(prompts, want[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert state.cache.index.tolist() == [10, 0] and not state.mask[1].any()


@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_merged_chunk_matches_jax(tree):
    """One merged chunk against JAX's, from the same carried state: slot 0
    decodes, slot 1 holds an installed 16-token prompt (3 left pads, an
    image block). Iterations 1-2 take its two chunks of C = 8 (the second
    hands its budget over), iteration 3 parks the chunk at the prompt end
    while both slots decode. Tokens and active flags equal; the cache, mask
    and logits within 1e-5 (the int8 cache's values equal)."""
    cfg = _setup(tree)[0]
    quant = tree == "int8"
    S = 128 if quant else 64
    eng, jeng = _engines(tree, S)
    B, Np, Q, Mv = 2, eng._Np, cfg.vision_codebook_num, cfg.max_vision_token_length
    assert eng._Km == jeng._Km == 3 and Np == jeng._Np
    rs = np.random.RandomState(12)
    bufs, flag = _pool(cfg, B, S, quant, rs)
    index = [10, 5]
    mask = np.zeros((B, S), np.int64)
    mask[0, 2:10] = 1
    logits = rs.randn(Q, B, cfg.combined_vocab_size).astype(np.float32)
    vi_last = np.asarray([Mv, Mv])
    pos_last = np.asarray([7, 0])
    req = _slot1_prompt(cfg, 16, rs)
    pbuf = {"ids": rs.randint(3, cfg.vocab_size, (Q, B, Np)), "vi": np.full((B, Np), Mv),
            "pm": np.zeros((B, Np), np.int64), "pos": np.ones((B, Np), np.int64),
            "sig": np.zeros((B, Np, cfg.contiguous_signal_size), np.float32)}
    pbuf["ids"][:, 1, :16] = req["ids"]
    for k in ("vi", "pm", "pos", "sig"):
        pbuf[k][1, :16] = req[k]
    flags = np.asarray([[1, 0], [6, 0], [0, 1], [0, 0], [0, 16], [0, 4]])

    jc, tc = _caches(bufs, flag, index)
    i32 = functools.partial(jnp.asarray, dtype=jnp.int32)
    want = jeng._merged()(
        _jax_tree(tree), jc, i32(mask), jnp.asarray(logits), i32(vi_last), i32(pos_last),
        *(i32(pbuf[k]) for k in ("ids", "vi", "pm", "pos")), jnp.asarray(pbuf["sig"]),
        jnp.asarray(flags[0], bool), i32(flags[1]), jnp.asarray(flags[2], bool),
        i32(flags[3]), i32(flags[4]), i32(flags[5]), jax.random.PRNGKey(0))
    w_toks, w_acts, w_cache, w_mask, w_logits, w_vi, w_pos = want
    state = SlotState(tc, torch.from_numpy(mask), torch.from_numpy(logits),
                      torch.from_numpy(vi_last), torch.from_numpy(pos_last))
    prompts = PromptBuffers(**{k: torch.from_numpy(v) for k, v in pbuf.items()})
    with torch.inference_mode():
        out, got = eng._merged(state, prompts, torch.from_numpy(flags), None)
    np.testing.assert_array_equal(out[:, :Q].numpy(), np.asarray(w_toks))
    np.testing.assert_array_equal(out[:, Q].numpy(), np.asarray(w_acts))
    assert out[:, Q].tolist() == [[1, 0], [1, 0], [1, 1]]   # slot 1 decodes after 2
    _assert_cache_close(got.cache, w_cache, 1e-5)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(w_mask))
    finite = np.isfinite(np.asarray(w_logits))
    np.testing.assert_array_equal(np.isfinite(got.logits.numpy()), finite)
    np.testing.assert_allclose(got.logits.numpy()[finite], np.asarray(w_logits)[finite],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.vi_last.numpy(), np.asarray(w_vi))
    np.testing.assert_array_equal(got.pos_last.numpy(), np.asarray(w_pos))


def test_merged_chunk_reads_nothing_on_the_host(monkeypatch):
    """A merged chunk (the int8 tree: the decode segment takes the decode
    kernel's branch) reads no device value on the host: every
    tensor-to-host conversion raises while it runs. On the card,
    chip_smoke.py runs one under torch.cuda.set_sync_debug_mode("error")."""
    cfg = _setup("int8")[0]
    reqs = _requests(cfg, 4)
    eng = _engine("int8", max_len=128, decode_chunk=3, **MERGED)
    merged, chunks = eng._merged, []

    def guarded(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                         "__float__", "__index__"):
                m.setattr(torch.Tensor, name, _host_read(name))
            out = merged(*args, **kwargs)
        chunks.append(out[0].shape)
        return out

    eng._merged = guarded
    results = eng.run(reqs)
    assert eng.stats["merged_installs"] > 0
    # bucket 8 = C: an install takes one iteration, so each chunk runs one
    assert eng._Km == 1
    assert chunks and all(s == (1, cfg.vision_codebook_num + 1, 2) for s in chunks)
    _check_parity("int8", results, reqs)


# -- the engine against libra_tpu (tests/test_serving.py's merged cases) ----


def test_engine_merged_prefill_matches_generator():
    """Refills installed into the merged chunks (C prompt tokens an
    iteration beside the decode tokens) instead of prompt passes; staggered
    budgets keep the pool busy whenever a slot frees."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 6)
    kw = dict(MERGED, max_len=64, decode_chunk=3)
    eng = _engine("plain", **kw)
    results = eng.run(reqs)
    assert eng.stats["merged_installs"] > 0, eng.stats
    assert eng.stats["merged_chunks"] > 0, eng.stats
    assert eng.stats["dedicated_prefills"] > 0, eng.stats      # the cold start
    assert all(r.ttft_s is not None for r in results)
    rs = eng.last_run_stats
    assert rs["n_install"] == eng.stats["merged_installs"]
    assert rs["n_merged"] == eng.stats["merged_chunks"]
    # bucket 8 = C: a merged chunk runs one iteration, a decode chunk three
    assert rs["iters"] == 3 * rs["n_decode"] + eng._Km * rs["n_merged"]
    assert rs["tokens"] == sum(r.tokens.shape[-1] for r in results)
    _check_parity("plain", results, reqs)
    _check_jax_engine("plain", eng, results, reqs, **kw)


def test_engine_warmup_runs_every_program():
    """warmup(example) with merged_prefill resolving on (None, max_len 64 >=
    2 C): the staggered burst reaches the merged installs and chunks, the
    idle-pool runs every smaller group size; a later run stays exact."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4)
    kw = dict(max_batch=4, max_len=64, prompt_bucket=8, decode_chunk=3, merged_chunk=8)
    eng = _engine("plain", **kw)
    assert eng._merged_on
    eng.warmup(reqs[0])
    assert eng.stats["dedicated_prefills"] >= len(eng._group_sizes)
    assert eng.stats["merged_installs"] > 0, eng.stats
    assert {k for _, _, k in eng._prefill_shapes} >= set(eng._group_sizes)
    results = eng.run(reqs)
    _check_parity("plain", results, reqs)
    jeng = _jax_engine("plain", **kw)
    jeng.warmup(reqs[0])
    want = jeng.run(reqs)
    for got, w in zip(results, want):
        np.testing.assert_array_equal(got.tokens, np.asarray(w.tokens))
    assert eng.stats == jeng.stats


@pytest.mark.parametrize("tree", ["int8", "int4"], ids=["int8_kv", "int4_weights"])
def test_engine_merged_prefill_quantized(tree):
    """Merged installs over the int8 cache (the chunk segment writes int8
    K/V at its row's window as the prompt pass would), with the int8 and
    the int4 weight trees."""
    cfg = _setup(tree)[0]
    reqs = _requests(cfg, 5)
    kw = dict(MERGED, max_len=128)
    eng = _engine(tree, **kw)
    results = eng.run(reqs)
    assert eng.stats["merged_installs"] > 0, eng.stats
    if tree == "int4":
        assert type(eng.params["layers"]["attn"]["q_proj"]).__name__ == "Quantized4Array"
    _check_parity(tree, results, reqs)
    _check_jax_engine(tree, eng, results, reqs, **kw)


def test_engine_merged_prefill_dual_decode():
    """Merged mode with dual-modality decode: the decode rows run the full
    dual-path body the chunk rows need."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 5)
    gen = _gen("plain", decode_modality="dual")
    kw = dict(MERGED, max_len=64)
    eng = _engine("plain", gen=gen, **kw)
    results = eng.run(reqs)
    assert eng.stats["merged_installs"] > 0, eng.stats
    _check_parity("plain", results, reqs)
    _check_jax_engine("plain", eng, results, reqs, gen=gen, **kw)


def test_engine_merged_prefill_eos_and_streaming():
    """EOS emitted by a merged-installed request finishes it mid-chunk; the
    on_token stream reports every token in order with one final event."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4)
    eos = int(_want("plain", reqs[2])[0, 1])
    gen = dict(_gen("plain"), eos_token_id=eos)
    kw = dict(MERGED, max_len=64)
    events = []
    eng = _engine("plain", gen=gen, **kw)
    results = eng.run(reqs, on_token=lambda rid, tok, fin: events.append(
        (rid, None if tok is None else np.asarray(tok).copy(), fin)))
    assert eng.stats["merged_installs"] > 0, eng.stats
    for res in results:
        ev = [e for e in events if e[0] == res.request_id]
        assert len(ev) == max(res.tokens.shape[-1], 1)
        finals = [e for e in ev if e[2] is not None]
        assert len(finals) == 1 and finals[0] is ev[-1]
        assert finals[0][2] == res.finish_reason
        np.testing.assert_array_equal(np.stack([e[1] for e in ev], -1), res.tokens)
        want = _want("plain", reqs[res.request_id])
        np.testing.assert_array_equal(res.tokens, want[:, :res.tokens.shape[-1]])
    assert any(r.finish_reason == "eos" for r in results)
    _check_jax_engine("plain", eng, results, reqs, gen=gen, **kw)


def test_engine_merged_fallback_when_bucket_incompatible():
    """Requests whose bucket is not a multiple of C keep the dedicated
    prefill (bucket 4, C = 8: Nb in {12, 16, 20}, only 16 is eligible).
    As in libra_tpu's case, merged_prefill=True with spec decode raises
    ValueError in both packages (and None resolves off there).
    test_engine_unported_options_raise holds the margin's."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4)
    kw = dict(MERGED, max_len=64, prompt_bucket=4)
    eng = _engine("plain", **kw)
    results = eng.run(reqs)
    assert eng.stats["dedicated_prefills"] > 1, eng.stats
    _check_parity("plain", results, reqs)
    _check_jax_engine("plain", eng, results, reqs, **kw)
    _, jcfg, np_tree, params = _setup("plain")
    with pytest.raises(ValueError):
        jserving.ServingEngine(np_tree, jcfg, max_batch=2, max_len=64,
                               gen=jgen.GenerationConfig(eos_token_id=-1, spec_decode=2),
                               merged_prefill=True)
    with pytest.raises(ValueError, match="spec_decode == 0"):
        ServingEngine(params, cfg, max_batch=2, max_len=64,
                      gen=tgen.GenerationConfig(eos_token_id=-1, spec_decode=2),
                      merged_prefill=True)
    spec = ServingEngine(params, cfg, max_batch=2, max_len=64, merged_chunk=8,
                         gen=tgen.GenerationConfig(eos_token_id=-1, spec_decode=2))
    assert not spec._merged_on


def test_engine_merged_mixed_with_pixels_fallback():
    """Raw-pixels requests (dedicated prefill only) share the pool with
    merged-installed text requests, exact for both."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 5)
    base = reqs[2]
    start = int(np.nonzero(base.vision_indices == 0)[0][0])
    side = VQGANConfig.tiny().clip.image_size
    img = np.random.RandomState(3).randn(side, side, 3).astype(np.float32)
    reqs[2] = Request(2, base.input_ids, base.vision_indices,
                      max_new_tokens=base.max_new_tokens, pixels=img, img_start=start)
    kw = dict(MERGED, max_len=64)
    eng = _engine("plain", pixels=True, **kw)
    results = eng.run(reqs)
    assert eng.stats["merged_installs"] > 0, eng.stats
    assert eng.stats["dedicated_prefills"] > 1, eng.stats      # the pixels refill
    assert any(has_px for _, has_px, _ in eng._prefill_shapes)
    _check_parity("plain", results, reqs)
    _check_jax_engine("plain", eng, results, reqs, pixels=True, **kw)


def test_engine_merged_sampling_budgets():
    """Sampling through merged installs: every request emits its budget
    with "length" (the sampled tokens cannot match JAX's PRNG), and two
    runs of one engine are equal (a seed-0 generator per run)."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 5)
    eng = _engine("plain", gen=_gen("plain", do_sample=True, top_k=5), max_len=64,
                  **MERGED)
    first = eng.run(reqs)
    assert eng.stats["merged_installs"] > 0, eng.stats
    assert [r.tokens.shape[-1] for r in first] == [r.max_new_tokens for r in reqs]
    assert {r.finish_reason for r in first} == {"length"}
    second = eng.run(reqs)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.tokens, b.tokens)

