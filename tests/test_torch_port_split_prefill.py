"""The port's modality-split prompt pass against libra_tpu, at a tiny size
in fp32 on the CPU: text_span_maps, gather_rows and split_merge (equal),
routed_linear with a text span and the decoder forward with text_span
against JAX's split forward and the port's dense forward (JAX's own
tolerance for the split, 2e-4), for a plain tree and for an int8 tree
under a8_enabled; and the Generator's split on and off (equal tokens).

Both packages run on one parameter tree: JAX's init_params with the
bridge B-weights (zero at init) filled with N(0, 0.02) noise, handed to
the port through numpy (quantized by JAX for the int8 tree).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import quantization as jq
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.models import libra as JM
from libra_tpu.ops import routed as jrouted
from libra_tpu.ops.qlinear import a8_enabled as ja8_enabled
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.ops import routed as trouted
from libra_tpu_torch.ops.qlinear import a8_enabled
from libra_tpu_torch.params import from_numpy_tree

BRIDGES = ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis")
TOL = 2e-4      # tests/test_split_prefill.py's tolerance for the split forward


@functools.lru_cache(maxsize=None)
def _trees(bits):
    """(JAX tiny config, numpy tree with live bridges, int8-quantized by
    JAX when bits == 8)."""
    jcfg = JLibraConfig.tiny()
    p = jax.tree_util.tree_map(np.array, jax.jit(
        functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(100)
    for name in BRIDGES:
        wb = p["layers"]["attn"][name]["wb"]
        wb[...] = rs.normal(0.0, 0.02, wb.shape)
    if bits:
        p = jq.quantize_params(p, min_elems=64, bits=bits)
    return jcfg, p


def _image_inputs(cfg, img_starts, text_len, seed=0):
    """Rows each carrying one full Mv image block at img_starts[b], row b
    left-padded by b positions (the pad inside [0, img_start))."""
    Mv = cfg.max_vision_token_length
    B = len(img_starts)
    N = text_len + Mv
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, cfg.vocab_size, size=(cfg.vision_codebook_num, B, N))
    vi = np.full((B, N), Mv, np.int64)
    mask = np.ones((B, N), np.int64)
    for b, s in enumerate(img_starts):
        vi[b, s:s + Mv] = np.arange(Mv)
        ids[:, b, s:s + Mv] = rs.randint(
            cfg.vocab_size, cfg.vocab_size + cfg.vision_vocab_size, size=Mv)
        mask[b, :b] = 0
    sig = rs.randn(B, N, cfg.contiguous_signal_size).astype(np.float32)
    sig[vi >= Mv] = 0.0
    return ids, mask, vi, sig, N


@pytest.mark.parametrize("starts,text_len", [
    ([0, 3, 7], 7),          # a block at 0 and one flush with the end
    ([5, 9, 12], 12),        # starts shifted by a left pad of 5 (prompt_bucket)
    ([1, 0], 1),             # one text row: before the block or after it
])
def test_text_span_maps_match_jax(starts, text_len):
    cfg = LibraConfig.tiny()
    Mv = cfg.max_vision_token_length
    N = Mv + text_len
    want = JM.text_span_maps(JLibraConfig.tiny(), jnp.asarray(starts, jnp.int32), N)
    got = TM.text_span_maps(cfg, torch.tensor(starts), N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    src, inv = (t.numpy() for t in got)
    for b, s in enumerate(starts):
        expect = [j for j in range(N) if not (s <= j < s + Mv)]
        assert src[b].tolist() == expect
        assert all(inv[b, n] == j for j, n in enumerate(expect))
    assert TM.text_span_maps(cfg, torch.tensor(starts), Mv) is None
    assert JM.text_span_maps(JLibraConfig.tiny(), jnp.asarray(starts), Mv) is None


def test_text_span_maps_stay_on_the_device_of_img_start():
    """No host read: the maps are tensors on img_start's device, built from
    a tensor (a meta tensor here, which has no values to read)."""
    cfg = LibraConfig.tiny()
    src, inv = TM.text_span_maps(cfg, torch.zeros(3, dtype=torch.long,
                                                  device="meta"), 20)
    assert src.device.type == inv.device.type == "meta"
    assert tuple(src.shape) == (3, 20 - cfg.max_vision_token_length)
    assert tuple(inv.shape) == (3, 20)


def _blocks_of(Mv):
    """What text_span_maps reads of a config: the image block's length."""
    return types.SimpleNamespace(max_vision_token_length=Mv)


@pytest.mark.parametrize("trail", [(), (5,), (2, 3)])
def test_gather_rows_and_split_merge_match_jax(trail):
    rs = np.random.RandomState(1)
    B, N, T = 3, 11, 4
    starts = [0, 2, 7]
    src, inv = (np.array(m) for m in JM.text_span_maps(
        _blocks_of(N - T), jnp.asarray(starts), N))
    x = rs.randn(B, N, *trail).astype(np.float32)
    rows = rs.randn(B, T, *trail).astype(np.float32)
    flag = rs.rand(B, N) < 0.5
    got = trouted.gather_rows(torch.from_numpy(x), torch.from_numpy(src).long())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrouted.gather_rows(x, src)))
    got = trouted.split_merge(torch.from_numpy(flag), torch.from_numpy(x),
                              torch.from_numpy(rows), torch.from_numpy(inv).long())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrouted.split_merge(flag, x, rows, inv)))


@pytest.mark.parametrize("addition_mode", [False, True])
def test_routed_linear_text_span_matches_jax(addition_mode):
    """The language dot on the text rows only; in addition_mode the span
    is ignored (the language path is needed at every position)."""
    rs = np.random.RandomState(2)
    B, N, T, D, F, R = 2, 9, 3, 8, 6, 2
    span = JM.text_span_maps(_blocks_of(N - T), jnp.asarray([1, 3]), N)
    x = rs.randn(B, N, D).astype(np.float32)
    flag = np.zeros((B, N), bool)
    flag[0, 1:7] = flag[1, 3:9] = True
    w, wa, wb = (rs.randn(*s).astype(np.float32) for s in ((D, F), (D, R), (R, F)))
    want = jrouted.routed_linear(x, flag, w, wa, wb, addition_mode,
                                 text_span=span)
    t = [torch.from_numpy(a) for a in (x, flag, w, wa, wb)]
    tspan = tuple(torch.from_numpy(np.asarray(m)).long() for m in span)
    got = trouted.routed_linear(*t, addition_mode, text_span=tspan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    dense = trouted.routed_linear(*t, addition_mode)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [0, 8], ids=["plain", "int8-a8"])
def test_forward_split_matches_jax_and_dense(bits, monkeypatch):
    """The port's split forward against JAX's split forward and against
    the port's dense forward, and the language projections really ran on
    B * T rows: 4 routed ones (q, k, v, o) and 3 MLP ones a layer."""
    jcfg, tree = _trees(bits)
    cfg = LibraConfig.tiny()
    starts = [0, 2, 4]
    ids, mask, vi, sig, N = _image_inputs(cfg, starts, text_len=6)
    jspan = JM.text_span_maps(jcfg, jnp.asarray(starts, jnp.int32), N)
    with ja8_enabled(bool(bits)):
        want = jax.jit(lambda p: JM.forward(
            p, jcfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(vi),
            jnp.asarray(sig), text_span=jspan).hidden_states)(tree)

    params = from_numpy_tree(tree, device="cpu")
    args = [torch.from_numpy(a) for a in (ids, mask, vi, sig)]
    span = TM.text_span_maps(cfg, torch.tensor(starts), N)
    rows = []
    for mod in (trouted, TM):
        real = mod.qdot
        monkeypatch.setattr(mod, "qdot", lambda x, w, real=real: rows.append(
            int(np.prod(x.shape[:-1]))) or real(x, w))
    with a8_enabled(bool(bits)):
        got = TM.forward(params, cfg, *args, text_span=span).hidden_states
        dense = TM.forward(params, cfg, *args).hidden_states
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=TOL, atol=TOL)
    B, T = len(starts), N - cfg.max_vision_token_length
    n_split = sum(1 for r in rows[:len(rows) // 2] if r == B * T)
    assert n_split == 7 * cfg.num_hidden_layers
    assert B * T not in rows[len(rows) // 2:]


def _pixel_inputs(cfg, starts, text_len, seed=2, size=28):
    Mv = cfg.max_vision_token_length
    B, N = len(starts), text_len + Mv
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, cfg.vocab_size, size=(cfg.vision_codebook_num, B, N))
    vi = np.full((B, N), Mv, np.int64)
    for b, s in enumerate(starts):
        vi[b, s:s + Mv] = np.arange(Mv)
    return {"input_ids": ids, "attention_mask": np.ones((B, N), np.int64),
            "vision_indices": vi,
            "pixels": rs.randn(B, size, size, 3).astype(np.float32),
            "img_start": np.asarray(starts, np.int32)}


def test_generator_split_toggle_same_tokens():
    """Raw-pixels generation: split_prefill on and off give the same greedy
    tokens (the split changes which rows the language matmuls run on,
    never their values)."""
    from libra_tpu_torch.models import vqgan as tvqgan
    cfg, vq_cfg = LibraConfig.tiny(), VQGANConfig.tiny()
    _, tree = _trees(0)
    params = from_numpy_tree(tree, device="cpu")
    with torch.no_grad():
        vq_params = tvqgan.init_params(torch.Generator().manual_seed(1), vq_cfg,
                                       "cpu")
    g = tgen.Generator(params, cfg, vq_params=vq_params, vq_cfg=vq_cfg)
    inputs = _pixel_inputs(cfg, [2, 4], text_len=6)
    on, off = (g(inputs, tgen.GenerationConfig(max_new_tokens=5, eos_token_id=-1,
                                               split_prefill=s)) for s in (True, False))
    np.testing.assert_array_equal(on.sequences.numpy(), off.sequences.numpy())
