"""The port's continuous-batching ServingEngine against libra_tpu, at a
tiny size in fp32 on the CPU: per-slot cache timelines (a (B,) cache
index), grouped refills (raw pixels included), decode chunks with one
host readback each. Every case holds the engine's greedy tokens equal to
JAX's Generator on each request alone, on the same tree; the plain, int8
+ kv8 and pixels cases also to JAX's own ServingEngine(merged_prefill=
False). Also the per-row cache writes, the per-row forward and
decode_micro_step(active=) against JAX's, streaming and the run stats.

One parameter tree for both packages (tests/test_torch_port_fused_
generation.py's: JAX's init_params with live bridge B-weights, quantized
by JAX for the int8 and int4 trees), carried across with from_numpy_tree.
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
from libra_tpu_torch import serving as tserving
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.quantization import QuantizedArray
from libra_tpu_torch.serving import Request, ServingEngine
from libra_tpu_torch.tokenization import (IMG_PH, ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from tests.test_torch_port_fused_generation import KW128, _trees, _vq_tree

W256 = dict(hidden_size=256, intermediate_size=256, num_attention_heads=2)
# (config overrides, weight bits, GenerationConfig overrides) of each tree;
# the int8 tree's head dim is 128, so its decode steps take the decode
# kernel's branch (its plain version here)
TREES = {
    "plain": ((), 0, {}),
    "int8": (tuple(sorted(KW128.items())), 8, dict(kv_quant=True)),
    "int4": (tuple(sorted(W256.items())), 4, dict(kv_quant=True)),
}
REF_NEW = 8      # the reference runs' length; every request asks for <= 8


@functools.lru_cache(maxsize=None)
def _setup(tree: str):
    """(port config, JAX config, numpy tree, port tree) of a TREES entry."""
    kw, bits, _ = TREES[tree]
    jcfg, np_tree = _trees(kw, bits)
    return (LibraConfig.tiny(**dict(kw)), jcfg, np_tree,
            from_numpy_tree(np_tree, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_tree(tree: str):
    """The tree as jax arrays, for eager calls of JAX's model functions."""
    return jax.tree_util.tree_map(jnp.asarray, _setup(tree)[2])


@functools.lru_cache(maxsize=None)
def _jax_generator(tree: str, pixels: bool = False):
    _, jcfg, np_tree, _ = _setup(tree)
    if not pixels:
        return jgen.Generator(np_tree, jcfg)
    jvq, vq_tree = _vq_tree()
    return jgen.Generator(np_tree, jcfg, vq_params=vq_tree, vq_cfg=jvq)


def _gen(tree: str, **kw):
    return dict(eos_token_id=-1, **TREES[tree][2], **kw)


def _engine(tree: str, pixels: bool = False, gen=None, **kw):
    cfg, _, _, params = _setup(tree)
    if pixels:
        jvq, vq_tree = _vq_tree()
        kw.update(vq_params=from_numpy_tree(vq_tree, device="cpu"),
                  vq_cfg=VQGANConfig.tiny())
    return ServingEngine(params, cfg, gen=tgen.GenerationConfig(**(gen or _gen(tree))),
                         **kw)


def _jax_engine(tree: str, pixels: bool = False, **kw):
    _, jcfg, np_tree, _ = _setup(tree)
    if pixels:
        jvq, vq_tree = _vq_tree()
        kw.update(vq_params=vq_tree, vq_cfg=jvq)
    return jserving.ServingEngine(np_tree, jcfg,
                                  gen=jgen.GenerationConfig(**_gen(tree)),
                                  merged_prefill=False, **kw)


def _requests(cfg, n, seed=0, max_new=None, arrivals=None):
    """libra_tpu's test_serving requests: [3 + 2 (i % 4) text][one image
    block][2 text], unpadded, a continuous signal; max_new 4 + i % 5."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    reqs = []
    for i in range(n):
        rs = np.random.RandomState(seed + i)
        t = 3 + 2 * (i % 4)
        N = t + Mv + 2
        ids = np.broadcast_to(rs.randint(3, cfg.vocab_size, (1, N)), (Q, N)).copy()
        ids[:, t:t + Mv] = cfg.vocab_size + rs.randint(0, cfg.vision_vocab_size - 2,
                                                       (Q, Mv))
        ids[:, t] = cfg.vocab_size + cfg.vision_vocab_size - 2          # BOI
        ids[:, t + Mv - 1] = cfg.vocab_size + cfg.vision_vocab_size - 1  # EOI
        vi = np.full((N,), Mv, np.int64)
        vi[t:t + Mv] = np.arange(Mv)
        sig = (rs.randn(N, cfg.contiguous_signal_size) * 0.1).astype(np.float32)
        reqs.append(Request(i, ids, vi, sig, max_new_tokens=max_new or 4 + i % 5,
                            arrival_s=None if arrivals is None else arrivals[i]))
    return reqs


def _pixel_requests(cfg, n, seed=5, max_new=5):
    """Raw-pixels requests: 6 text ids with one image block at 2 or 4 (its
    ids placeholders), seeded float pixels."""
    Mv, Q = cfg.max_vision_token_length, cfg.vision_codebook_num
    side = VQGANConfig.tiny().clip.image_size
    reqs = []
    for i in range(n):
        rs = np.random.RandomState(seed + i)
        start, N = 2 + 2 * (i % 2), 6 + Mv
        ids = np.broadcast_to(rs.randint(3, cfg.vocab_size, (1, N)), (Q, N)).copy()
        vi = np.full((N,), Mv, np.int64)
        vi[start:start + Mv] = np.arange(Mv)
        reqs.append(Request(i, ids, vi, max_new_tokens=max_new - i % 2,
                            pixels=rs.randn(side, side, 3).astype(np.float32),
                            img_start=start))
    return reqs


def _reference(tree: str, req: Request) -> np.ndarray:
    """JAX's Generator on one request alone, REF_NEW greedy tokens."""
    ids, vi = np.asarray(req.input_ids), np.asarray(req.vision_indices)
    N = ids.shape[-1]
    inputs = {"input_ids": ids[:, None], "attention_mask": np.ones((1, N), np.int32),
              "vision_indices": vi[None]}
    if req.pixels is None:
        inputs["coninous_signal"] = np.asarray(req.contiguous_signal)[None]
    else:
        inputs.update(pixels=req.pixels[None],
                      img_start=np.asarray([req.img_start], np.int32))
    gen = jgen.GenerationConfig(max_new_tokens=REF_NEW, **_gen(tree))
    out = _jax_generator(tree, req.pixels is not None)(inputs, gen)
    return np.asarray(out.sequences)[:, 0, N:]


_REFS = {}


def _want(tree: str, req: Request) -> np.ndarray:
    """The reference tokens of `req`: greedy, so those at any
    max_new_tokens <= REF_NEW are a prefix of one REF_NEW run (one JAX
    compile per prompt shape and tree)."""
    assert req.max_new_tokens <= REF_NEW
    key = (tree, req.input_ids.tobytes(), req.vision_indices.tobytes(),
           None if req.contiguous_signal is None else req.contiguous_signal.tobytes(),
           None if req.pixels is None else req.pixels.tobytes(), req.img_start)
    if key not in _REFS:
        _REFS[key] = _reference(tree, req)
    return _REFS[key][:, :req.max_new_tokens]


def _check_parity(tree, results, reqs):
    """Each result's tokens equal JAX's Generator on its request alone."""
    by_id = {r.request_id: r for r in reqs}
    for res in results:
        np.testing.assert_array_equal(res.tokens, _want(tree, by_id[res.request_id]),
                                      err_msg=f"request {res.request_id}")


def _check_jax_engine(tree, results, reqs, pixels=False, **kw):
    """Equal tokens and finish reasons to JAX's engine on the same stream."""
    want = _jax_engine(tree, pixels, **kw).run(reqs)
    assert [r.request_id for r in results] == [r.request_id for r in want]
    for got, w in zip(results, want):
        np.testing.assert_array_equal(got.tokens, np.asarray(w.tokens))
        assert got.finish_reason == w.finish_reason


# -- the cache's per-row mode --------------------------------------------


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
@pytest.mark.parametrize("starts", [(0, 3, 7), (9, 2, 14)],
                         ids=["inside", "past-S-minus-N"])
def test_per_row_cache_writes_match_jax(quantized, starts):
    """_write_cache and _write_seq at a (B,) index against JAX's, the
    sequence-major and the head-major int8 layout; a start past S - N
    clamps to S - N (XLA's dynamic_update_slice), 14 even past S."""
    L, B, S, H, d, N = 3, 3, 12, 2, 8, 3
    rs = np.random.RandomState(0)
    new = rs.randn(B, N, H, d).astype(np.float32)
    idx = np.asarray(starts)
    if quantized:
        q0 = rs.randint(-127, 128, (L, B, H, S, d)).astype(np.int8)
        s0 = rs.rand(L, B, H, S).astype(np.float32)
        jbuf = JQuantizedArray(jnp.asarray(q0), jnp.asarray(s0))
        tbuf = QuantizedArray(torch.from_numpy(q0.copy()), torch.from_numpy(s0.copy()))
    else:
        b0 = rs.randn(L, B, S, H, d).astype(np.float32)
        jbuf, tbuf = jnp.asarray(b0), torch.from_numpy(b0.copy())
    want = JM._write_cache(jbuf, jnp.asarray(new), 1, jnp.asarray(idx, jnp.int32))
    got = TM._write_cache(tbuf, torch.from_numpy(new), 1, torch.from_numpy(idx))
    if quantized:
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flags = rs.rand(B, S) > 0.5
    new_f = rs.rand(B, N) > 0.5
    want_f = JM._write_seq(jnp.asarray(flags), jnp.asarray(new_f),
                           jnp.asarray(idx, jnp.int32))
    got_f = TM._write_seq(torch.from_numpy(flags.copy()), torch.from_numpy(new_f),
                          torch.from_numpy(idx))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


@pytest.mark.parametrize("tree", ["plain", "int8"])
def test_forward_per_row_index_matches_jax(tree):
    """A one-token cached forward over a pool whose rows sit at different
    offsets (a (B,) index, one row past the end): the hidden states to
    1e-5 and the cache writes equal to JAX's (int8: the head-major
    buffers)."""
    cfg, jcfg, np_tree, params = _setup(tree)
    kv = tree != "plain"
    B, S = 3, 16
    Q, Mv = cfg.vision_codebook_num, cfg.max_vision_token_length
    rs = np.random.RandomState(3)
    ids = rs.randint(3, cfg.vocab_size, (Q, B, 1))
    vi = np.full((B, 1), Mv, np.int64)
    vi[1, 0] = 2
    index = np.asarray([5, 0, 17])
    mask = (np.arange(S)[None] <= np.minimum(index, S - 1)[:, None]).astype(np.int64)
    pos = index[:, None].copy()
    jcache = JM.init_cache(jcfg, B, S, quantized=kv)
    jcache = jcache._replace(index=jnp.asarray(index, jnp.int32))
    want = JM.forward(_jax_tree(tree), jcfg, jnp.asarray(ids), jnp.asarray(mask),
                      jnp.asarray(vi), None, position_ids=jnp.asarray(pos),
                      cache=jcache)
    tcache = TM.init_cache(cfg, B, S, device="cpu", quantized=kv)
    tcache = tcache._replace(index=torch.from_numpy(index))
    with torch.inference_mode():
        got = TM.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
                         torch.from_numpy(vi), None, position_ids=torch.from_numpy(pos),
                         cache=tcache)
    np.testing.assert_allclose(got.hidden_states.numpy(), np.asarray(want.hidden_states),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.cache.index.numpy(), index + 1)
    np.testing.assert_array_equal(got.cache.flag.numpy(), np.asarray(want.cache.flag))
    wk, gk = want.cache.k, got.cache.k
    if kv:
        np.testing.assert_array_equal(gk.q.numpy(), np.asarray(wk.q))
        np.testing.assert_allclose(gk.scale.numpy(), np.asarray(wk.scale), rtol=1e-6)
    else:
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0, atol=1e-6)


def test_decode_micro_step_active_matches_jax():
    """decode_micro_step(active=): inactive rows keep their vision index
    and position; logits, vi and pos as JAX's."""
    cfg, jcfg, np_tree, params = _setup("plain")
    B, S = 3, 20
    Q, Mv = cfg.vision_codebook_num, cfg.max_vision_token_length
    rs = np.random.RandomState(4)
    tok = rs.randint(3, cfg.vocab_size, (Q, B))
    vi = np.asarray([Mv, 2, Mv - 1])
    pos = np.asarray([7, 3, 11])
    index = np.asarray([8, 4, 12])
    active = np.asarray([True, True, False])
    mask = (np.arange(S)[None] <= index[:, None]).astype(np.int64)
    jcache = JM.init_cache(jcfg, B, S)._replace(index=jnp.asarray(index, jnp.int32))
    wl, _, wvi, wpos, _ = jgen.decode_micro_step(
        _jax_tree("plain"), jcfg, jnp.asarray(tok), jnp.asarray(mask), jcache, jnp.asarray(vi),
        jnp.asarray(pos), active=jnp.asarray(active))
    tcache = TM.init_cache(cfg, B, S, device="cpu")._replace(index=torch.from_numpy(index))
    with torch.inference_mode():
        gl, _, gvi, gpos = tgen.decode_micro_step(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(mask), tcache,
            torch.from_numpy(vi), torch.from_numpy(pos), active=torch.from_numpy(active))
    np.testing.assert_array_equal(gvi.numpy(), np.asarray(wvi))
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    np.testing.assert_array_equal(gvi.numpy(), [Mv, 3, Mv - 1])
    finite = np.isfinite(np.asarray(wl))
    np.testing.assert_array_equal(np.isfinite(gl.numpy()), finite)
    np.testing.assert_allclose(gl.numpy()[finite], np.asarray(wl)[finite],
                               rtol=0, atol=1e-4)


# -- the engine against libra_tpu ------------------------------------------


@pytest.mark.parametrize("tree", list(TREES),
                         ids=["matches_generator", "int8_weights_and_kv",
                              "int4_weights"])
def test_engine_matches_jax(tree):
    """Three requests through two slots (one recycles), the int8 / int4
    trees with the int8 cache: the Generator's tokens on each request
    alone; the plain and int8 trees also JAX's engine's."""
    cfg = _setup(tree)[0]
    reqs = _requests(cfg, 3)
    eng = _engine(tree, max_batch=2, max_len=64)
    results = eng.run(reqs)
    assert [r.request_id for r in results] == [0, 1, 2]
    assert all(r.finish_reason == "length" for r in results)
    assert eng.last_run_stats["tokens"] == sum(r.tokens.shape[-1] for r in results)
    if tree == "int4":
        assert type(eng.params["layers"]["attn"]["q_proj"]).__name__ == "Quantized4Array"
    _check_parity(tree, results, reqs)
    if tree != "int4":
        _check_jax_engine(tree, results, reqs, max_batch=2, max_len=64)


def test_engine_slots_recycle_far_past_max_len():
    """Slots recycle without end: ten requests through two slots of 32
    positions, the generated tokens far past one timeline; idle slots keep
    decoding past the end of their row, which the writes clamp."""
    max_len = 32
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 10, max_new=6)
    eng = _engine("plain", max_batch=2, max_len=max_len)
    results = eng.run(reqs)
    assert len(results) == 10
    total_prompt = sum(r.input_ids.shape[-1] for r in reqs)
    total_generated = sum(r.tokens.shape[-1] for r in results)
    assert total_generated == 60 == eng.last_run_stats["tokens"]
    assert total_prompt + total_generated > 3 * max_len
    _check_parity("plain", results, reqs)


def test_engine_eos_and_capacity():
    """EOS finishes a request; prompt + max_new over a slot is rejected
    with zero tokens ("capacity"), per request."""
    cfg = _setup("plain")[0]
    req = _requests(cfg, 1)[0]
    first = int(_want("plain", req)[0, 0])
    eng = _engine("plain", gen=dict(eos_token_id=first), max_batch=1, max_len=64)
    res = eng.run([req])[0]
    assert res.finish_reason == "eos"
    assert res.tokens.shape[-1] == 1 and res.tokens[0, 0] == first

    n = req.input_ids.shape[-1]
    eng2 = _engine("plain", max_batch=1, max_len=n + 3)
    fits = Request(1, req.input_ids, req.vision_indices, req.contiguous_signal, 3)
    too_big = Request(2, req.input_ids, req.vision_indices, req.contiguous_signal, 4)
    out = eng2.run([fits, too_big])
    assert out[0].finish_reason == "length" and out[0].tokens.shape[-1] == 3
    assert out[1].finish_reason == "capacity" and out[1].tokens.shape[-1] == 0
    _check_parity("plain", out[:1], [fits])


def test_engine_prompt_bucketing():
    """prompt_bucket bounds the prompt-pass shapes (one per bucket, not per
    length) with exact tokens: the left padding is masked."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4)
    eng = _engine("plain", max_batch=2, max_len=64, prompt_bucket=8)
    results = eng.run(reqs)
    assert all(n % 8 == 0 for n, _, _ in eng._prefill_shapes)
    lengths = {r.input_ids.shape[-1] for r in reqs}
    assert len({n for n, _, _ in eng._prefill_shapes}) < len(lengths)
    _check_parity("plain", results, reqs)


def test_engine_pixels_request_matches_preencoded():
    """Raw-pixels requests (CLIP + LFQ inside the grouped prompt pass, the
    split on) give the tokens of JAX's fused Generator and of JAX's engine,
    and of the same image tokenized ahead by the port's LibraTokenizer."""
    cfg = _setup("plain")[0]
    reqs = _pixel_requests(cfg, 3)
    eng = _engine("plain", pixels=True, max_batch=2, max_len=64)
    results = eng.run(reqs)
    assert (12, True, 2) in eng._prefill_shapes
    Mv = cfg.max_vision_token_length
    _check_parity("plain", results, reqs)
    _check_jax_engine("plain", results, reqs, pixels=True, max_batch=2, max_len=64)

    text_tok = SimpleTextTokenizer(vocab_size=cfg.vocab_size)
    joint = LibraTokenizer(text_tok, ImageTokenizer(
        VQGANConfig.tiny(), eng.vq_params, cfg.vocab_size, Mv))
    img = np.random.RandomState(0).randn(28, 28, 3).astype(np.float32)
    prompt = " ".join([IMG_PH] * Mv) + " describe:"
    pre = joint([{"language": [prompt], "vision": [img]}])
    req_a = Request(0, np.asarray(pre["input_ids"])[:, 0],
                    np.asarray(pre["vision_indices"])[0],
                    np.asarray(pre["coninous_signal"])[0], max_new_tokens=5)
    t = text_tok([prompt])
    ids = np.asarray(t["input_ids"], np.int64)
    pos = int(np.nonzero(ids[0] == text_tok.img_ph_token_id)[0][0])
    vi = np.full(ids.shape[-1], Mv, np.int64)
    vi[pos:pos + Mv] = np.arange(Mv)
    req_b = Request(0, np.broadcast_to(ids, (cfg.vision_codebook_num, ids.shape[-1])),
                    vi, max_new_tokens=5, pixels=img, img_start=pos)
    res_a = _engine("plain", max_batch=1, max_len=64).run([req_a])[0]
    res_b = _engine("plain", pixels=True, max_batch=1, max_len=64).run([req_b])[0]
    np.testing.assert_array_equal(res_b.tokens, res_a.tokens)
    _check_parity("plain", [res_b], [req_b])


def test_engine_chunked_decode_and_ttft():
    """Chunk boundaries (decode_chunk=3) keep exact tokens across mid-chunk
    finishes and refills; every request reports a TTFT."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 6)
    eng = _engine("plain", max_batch=2, max_len=64, decode_chunk=3)
    results = eng.run(reqs)
    assert len(results) == 6
    assert all(r.ttft_s is not None and r.ttft_s >= 0 for r in results)
    assert eng.last_run_stats["iters"] == 3 * eng.last_run_stats["n_decode"]
    _check_parity("plain", results, reqs)


def test_engine_poisson_arrivals():
    """Open-loop load: each request is admitted after its arrival, tokens
    stay exact, TTFT is measured from arrival."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 6, max_new=4, arrivals=[0.03 * i for i in range(6)])
    eng = _engine("plain", max_batch=2, max_len=128)
    results = eng.run(reqs)
    assert [r.request_id for r in results] == list(range(6))
    assert all(r.ttft_s is not None and r.ttft_s >= 0 for r in results)
    _check_parity("plain", results, reqs)


def test_engine_idle_gap_arrival(monkeypatch):
    """A request arriving after the pool drains: the scheduler sleeps
    through the gap and admits it on arrival, with exact tokens, and its
    TTFT excludes its arrival offset. On a clock that only sleeps move, so
    that the gap does not depend on how fast the first request runs."""
    clock = _SleepClock()
    monkeypatch.setattr(tserving, "time", clock)
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 2, max_new=3, arrivals=[None, 5.0])
    eng = _engine("plain", max_batch=2, max_len=128)
    results = eng.run(reqs)
    assert [r.request_id for r in results] == [0, 1]
    assert clock.slept == [5.0] and eng.last_run_stats["t_sleep"] == 5.0
    assert results[0].ttft_s == 0.0 and results[1].ttft_s == 0.0
    _check_parity("plain", results, reqs)


class _SleepClock:
    """time.perf_counter and time.sleep on a clock that stands still but
    for sleeps."""

    def __init__(self):
        self.now, self.slept = 0.0, []

    def perf_counter(self):
        return self.now

    def sleep(self, seconds):
        self.slept.append(seconds)
        self.now += seconds


def test_engine_pixels_without_vq_params_rejected_up_front():
    """A pixels request to an engine without vq_params is rejected at
    run() entry, before any prompt pass, even behind a valid request."""
    cfg = _setup("plain")[0]
    ok = _requests(cfg, 1)[0]
    px = Request(9, ok.input_ids, ok.vision_indices, max_new_tokens=2,
                 pixels=np.zeros((3, 8, 8), np.float32), img_start=1)
    eng = _engine("plain", max_batch=1, max_len=64)
    with pytest.raises(ValueError, match="vq_params"):
        eng.run([ok, px])
    assert eng._prefill_shapes == set()


def test_engine_pixels_shape_validated_up_front():
    """Pixels of the wrong shape are rejected before any work; vq_params
    without vq_cfg is an error at construction."""
    cfg, _, _, params = _setup("plain")
    _, vq_tree = _vq_tree()
    with pytest.raises(ValueError, match="together"):
        ServingEngine(params, cfg, max_batch=1, max_len=64,
                      vq_params=from_numpy_tree(vq_tree, device="cpu"))
    eng = _engine("plain", pixels=True, max_batch=1, max_len=64)
    Mv = cfg.max_vision_token_length
    N = Mv + 2
    bad = Request(0, np.ones((cfg.vision_codebook_num, N), np.int64),
                  np.full((N,), Mv, np.int64), max_new_tokens=2,
                  pixels=np.zeros((20, 20, 3), np.float32), img_start=0)
    with pytest.raises(ValueError, match="pixels shape"):
        eng.run([bad])
    assert eng._prefill_shapes == set()


def test_engine_prefill_group_cap():
    """max_prefill_group bounds the grouped refill's k, with exact tokens
    (one bucket for every prompt, so four free slots would take k = 4)."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 6, max_new=4)
    eng = _engine("plain", max_batch=4, max_len=64, max_prefill_group=2,
                  prompt_bucket=32)
    assert eng._group_sizes == [1, 2]
    results = eng.run(reqs)
    assert all(k <= 2 for _, _, k in eng._prefill_shapes)
    assert max(eng.last_run_stats["group_sizes"]) == 2
    _check_parity("plain", results, reqs)


def test_engine_warmup():
    """warmup(example) runs the k = B grouped prefill, every smaller group
    size and the decode chunk; a later run stays exact."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4)
    eng = _engine("plain", max_batch=4, max_len=64, prompt_bucket=8, decode_chunk=3)
    eng.warmup(reqs[0])
    assert eng.stats["dedicated_prefills"] >= len(eng._group_sizes)
    assert {k for _, _, k in eng._prefill_shapes} >= set(eng._group_sizes)
    # max_len 64 leaves no margin for the default merged_chunk 64 (Np = 0 <
    # C), so merged_prefill=None resolves to off, as in libra_tpu
    assert not eng._merged_on
    assert eng.stats["merged_installs"] == 0
    results = eng.run(reqs)
    _check_parity("plain", results, reqs)


def test_engine_streaming_replays_results():
    """on_token's events replay each Result: its tokens in order, one final
    event with its finish reason, a capacity rejection as one None event;
    last_run_stats["tokens"] counts the emitted tokens (libra_tpu leaves
    it 0)."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4)
    eos = int(_want("plain", reqs[2])[0, 1])
    big = Request(9, reqs[0].input_ids, reqs[0].vision_indices,
                  reqs[0].contiguous_signal, max_new_tokens=64)
    events = []
    eng = _engine("plain", gen=dict(eos_token_id=eos), max_batch=2, max_len=64,
                  decode_chunk=3)
    results = eng.run(reqs + [big], on_token=lambda rid, tok, fin: events.append(
        (rid, None if tok is None else np.asarray(tok).copy(), fin)))
    for res in results:
        ev = [e for e in events if e[0] == res.request_id]
        finals = [e for e in ev if e[2] is not None]
        assert len(finals) == 1 and finals[0] is ev[-1]
        assert finals[0][2] == res.finish_reason
        if res.finish_reason == "capacity":
            assert len(ev) == 1 and ev[0][1] is None
            continue
        np.testing.assert_array_equal(np.stack([e[1] for e in ev], -1), res.tokens)
    assert {r.finish_reason for r in results} == {"eos", "length", "capacity"}
    assert eng.last_run_stats["tokens"] == sum(r.tokens.shape[-1] for r in results)
    for res, req in zip(results, reqs):
        want = _want("plain", req)
        n = res.tokens.shape[-1]
        np.testing.assert_array_equal(res.tokens, want[:, :n])


def test_engine_unported_options_raise():
    """A mesh (ROADMAP A13) raises NotImplementedError. merged_prefill=None
    resolves as libra_tpu's rule: on where the pool holds a merged_chunk
    margin (Np = (S - C) // C * C >= C), off elsewhere; True raises
    ValueError where it is off. At max_len 64 and the default C = 64,
    Np = 0 < C: None and False both run dedicated prefill."""
    with pytest.raises(NotImplementedError, match="A13"):
        _engine("plain", mesh=object())
    _, jcfg, np_tree, _ = _setup("plain")
    for max_len, chunk in ((64, 64), (127, 64), (128, 64), (64, 32), (63, 32), (16, 8)):
        jeng = jserving.ServingEngine(np_tree, jcfg, max_batch=2, max_len=max_len,
                                      merged_chunk=chunk)
        eng = _engine("plain", max_batch=2, max_len=max_len, merged_chunk=chunk)
        assert eng._merged_on == jeng._merged_on == (max_len >= 2 * chunk), (max_len, chunk)
        if not eng._merged_on:
            with pytest.raises(ValueError, match="2 \\* merged_chunk"):
                _engine("plain", max_batch=2, max_len=max_len, merged_chunk=chunk,
                        merged_prefill=True)
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 2)
    for flag in (None, False):
        eng = _engine("plain", merged_prefill=flag, max_batch=2, max_len=64)
        assert not eng._merged_on and eng._Np == 0
        _check_parity("plain", eng.run(reqs), reqs)
        assert eng.stats["merged_installs"] == 0
        assert eng.stats["dedicated_prefills"] == eng.last_run_stats["n_prefill"]


def test_decode_chunk_reads_nothing_on_the_host(monkeypatch):
    """A decode chunk (the int8 tree: the decode kernel's branch) reads no
    device value on the host: every tensor-to-host conversion raises while
    it runs. On the card, chip_smoke.py runs a chunk under
    torch.cuda.set_sync_debug_mode("error")."""
    cfg = _setup("int8")[0]
    reqs = _requests(cfg, 2, max_new=6)
    eng = _engine("int8", max_batch=2, max_len=64, decode_chunk=4)
    decode, chunks = eng._decode, []

    def guarded(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                         "__float__", "__index__"):
                m.setattr(torch.Tensor, name, _host_read(name))
            out = decode(*args, **kwargs)
        chunks.append(out[0].shape)
        return out

    eng._decode = guarded
    results = eng.run(reqs)
    assert chunks and all(s == (4, cfg.vision_codebook_num + 1, 2) for s in chunks)
    _check_parity("int8", results, reqs)


def _host_read(name):
    def read(self, *args, **kwargs):
        raise AssertionError(f"Tensor.{name} inside a decode chunk")
    return read


# -- speculative decode -----------------------------------------------------


def _spec_engines(tree, gamma, eos=-1, **kw):
    """The port's standard and spec engines and JAX's spec engine on one
    tree (text decode), with each spec chunk's counts recorded: the
    port's from its (K, B, gamma + 2) readback, JAX's from its cnts."""
    _, jcfg, np_tree, _ = _setup(tree)
    gkw = dict(_gen(tree), eos_token_id=eos, decode_modality="text")
    std = _engine(tree, gen=gkw, **kw)
    spec = _engine(tree, gen=dict(gkw, spec_decode=gamma), **kw)
    jspec_eng = jserving.ServingEngine(np_tree, jcfg,
                                       gen=jgen.GenerationConfig(**gkw, spec_decode=gamma),
                                       merged_prefill=False, **kw)
    counts = {"port": [], "jax": []}
    port_chunk = spec._spec_decode

    def port_record(*a, **k):
        out, state = port_chunk(*a, **k)
        counts["port"].append(out[..., gamma + 1].clone())
        return out, state
    spec._spec_decode = port_record
    jax_fn = jspec_eng._spec_decode()

    def jax_record(*a, **k):
        out = jax_fn(*a, **k)
        counts["jax"].append(np.asarray(out[1]))
        return out
    jspec_eng._spec_decode = lambda: jax_record
    return std, spec, jspec_eng, counts


def _check_spec_run(std, spec, jspec_eng, counts, reqs):
    """The spec engine's tokens and finish reasons equal the standard
    engine's and JAX's spec engine's; every chunk's counts and the run
    stats equal JAX's."""
    r_std, r_spec, want = std.run(reqs), spec.run(reqs), jspec_eng.run(reqs)
    assert [r.request_id for r in r_spec] == [r.request_id for r in reqs]
    for a, b, w in zip(r_std, r_spec, want):
        np.testing.assert_array_equal(b.tokens, a.tokens, err_msg=f"request {a.request_id}")
        np.testing.assert_array_equal(b.tokens, np.asarray(w.tokens))
        assert b.finish_reason == a.finish_reason == w.finish_reason
    assert len(counts["port"]) == len(counts["jax"]) > 0
    for got, w in zip(counts["port"], counts["jax"]):
        np.testing.assert_array_equal(got.numpy(), w)
    rs, jrs = spec.last_run_stats, jspec_eng.last_run_stats
    for key in ("n_spec", "n_decode", "n_prefill", "iters", "active_iters"):
        assert rs[key] == jrs[key], (key, rs[key], jrs[key])
    assert rs["n_spec"] > 0 and rs["n_decode"] == 0
    assert rs["tokens"] == sum(r.tokens.shape[-1] for r in r_spec)
    return r_spec


@pytest.mark.parametrize("tree", list(TREES))
def test_engine_spec_decode_matches_standard(tree):
    """gen.spec_decode = 2 turns the decode chunk into draft+verify
    iterations: through slot refills (the slots' token-history rows are
    rewritten at each refill) the tokens equal the standard engine's,
    JAX's spec engine's and JAX's Generator's on each request alone; the
    chunks' counts equal JAX's. The int8 and int4 trees' verify passes
    take the decode-attention branch at N = 3 (its plain version here)."""
    cfg = _setup(tree)[0]
    reqs = _requests(cfg, 4, max_new=6)
    engines = _spec_engines(tree, 2, max_batch=2, max_len=128)
    results = _check_spec_run(*engines, reqs)
    _check_parity(tree, results, reqs)


def test_engine_spec_decode_eos():
    """EOS inside an accepted block truncates exactly where the standard
    engine stops (the device's count truncation equals the host's
    replay), at gamma 3."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 2, max_new=8)
    eos = int(_want("plain", reqs[0])[0, 3])      # a token the model emits
    engines = _spec_engines("plain", 3, eos=eos, max_batch=2, max_len=128)
    results = _check_spec_run(*engines, reqs)
    assert results[0].finish_reason == "eos" and results[0].tokens.shape[-1] == 4


def test_engine_spec_decode_int8_kv():
    """Spec decode over the int8 head-major cache on the plain tree's
    config (head dim 32: the dequantized-cache branch), per-slot quantized
    K/V written at vector indices, gamma 2."""
    cfg = _setup("plain")[0]
    reqs = _requests(cfg, 4, max_new=5)
    _, jcfg, np_tree, params = _setup("plain")
    gkw = dict(eos_token_id=-1, decode_modality="text", kv_quant=True)
    kw = dict(max_batch=2, max_len=128)
    std = ServingEngine(params, cfg, gen=tgen.GenerationConfig(**gkw), **kw)
    spec = ServingEngine(params, cfg, gen=tgen.GenerationConfig(**gkw, spec_decode=2), **kw)
    want = jserving.ServingEngine(np_tree, jcfg, gen=jgen.GenerationConfig(
        **gkw, spec_decode=2), **kw).run(reqs)
    for a, b, w in zip(std.run(reqs), spec.run(reqs), want):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_array_equal(b.tokens, np.asarray(w.tokens))


def test_engine_spec_decode_rejects_non_text():
    """Greedy text-mode only, as in libra_tpu: sampling and a dual decode
    raise at construction; an 'auto' stream ending inside an image block
    raises up front. The capacity margin: a request fits only if bucket +
    max_new_tokens + gamma <= max_len."""
    cfg = _setup("plain")[0]
    Mv = cfg.max_vision_token_length
    base = dict(eos_token_id=-1, spec_decode=2)
    with pytest.raises(ValueError, match="greedy"):
        _engine("plain", gen=dict(base, do_sample=True, temperature=1.0),
                max_batch=1, max_len=64)
    with pytest.raises(ValueError, match="text-mode"):
        _engine("plain", gen=dict(base, decode_modality="dual"), max_batch=1, max_len=64)
    with pytest.raises(ValueError, match="spec_decode == 0"):
        _engine("plain", gen=base, max_batch=1, max_len=128, merged_prefill=True)
    eng = _engine("plain", gen=base, max_batch=1, max_len=128)
    assert not eng._merged_on
    N = 5
    ids = np.ones((cfg.vision_codebook_num, N), np.int64)
    vi = np.full((N,), Mv, np.int64)
    vi[-1] = 2                        # ends inside an image block
    with pytest.raises(ValueError, match="text-mode"):
        eng.run([Request(0, ids, vi, max_new_tokens=2)])
    req = _requests(cfg, 1)[0]
    n = req.input_ids.shape[-1]
    for max_new, reason in ((128 - n - 2, "length"), (128 - n - 1, "capacity")):
        req.max_new_tokens = max_new
        res = eng.run([req])[0]
        assert res.finish_reason == reason
        assert res.tokens.shape[-1] == (max_new if reason == "length" else 0)


def test_spec_chunk_reads_nothing_on_the_host(monkeypatch):
    """A spec chunk (the int8 tree: verify passes through the decode
    kernel's branch) reads no device value on the host: every
    tensor-to-host conversion raises while it runs. On the card,
    chip_smoke.py runs one under torch.cuda.set_sync_debug_mode("error")."""
    cfg = _setup("int8")[0]
    reqs = _requests(cfg, 2, max_new=6)
    eng = _engine("int8", gen=_gen("int8", spec_decode=3, decode_modality="text"),
                  max_batch=2, max_len=64, decode_chunk=2)
    chunk, shapes = eng._spec_decode, []

    def guarded(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                         "__float__", "__index__"):
                m.setattr(torch.Tensor, name, _host_read(name))
            out = chunk(*args, **kwargs)
        shapes.append(out[0].shape)
        return out

    eng._spec_decode = guarded
    results = eng.run(reqs)
    assert shapes and all(s == (2, 2, 5) for s in shapes)
    _check_parity("int8", results, reqs)
