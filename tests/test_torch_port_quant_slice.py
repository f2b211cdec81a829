"""The port's quantized serving slice against libra_tpu end to end, at a
tiny size in fp32 on the CPU: int8 and int4 weight trees, the int8 KV
cache and the w8a8 prompt pass through Generator (equal greedy tokens)
and the prompt pass's logits (atol 1e-4: fp32 through a few layers).

The config has head dim 128, so the port's decode steps take the int8
decode-attention branch (its plain version on the CPU), while JAX on the
CPU reads the dequantized cache: the two paths are held against each
other. JAX rounds an int8 cache's length up to 128 and the port does
not; that changes only masked slots and the outputs of fully masked pad
rows, which no logit reads. One parameter tree for both packages: JAX's
init_params with the bridge B-weights filled with noise, quantized by
JAX and carried across with from_numpy_tree.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from libra_tpu import generation as jgen
from libra_tpu import quantization as jq
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.models import libra as JM
from libra_tpu_torch import generation as tgen
from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.ops import decode_attention as tda
from libra_tpu_torch.params import from_numpy_tree

BRIDGES = ("k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis")
KW128 = dict(hidden_size=256, num_attention_heads=2, intermediate_size=256)
MAX_NEW = 6


@functools.lru_cache(maxsize=None)
def _trees(kw_items, bits):
    """(JAX config, JAX-quantized numpy tree) for a tiny config."""
    jcfg = JLibraConfig.tiny(**dict(kw_items))
    p = jax.tree_util.tree_map(np.array, jax.jit(
        functools.partial(JM.init_params, cfg=jcfg))(jax.random.PRNGKey(0)))
    rs = np.random.RandomState(100)
    for name in BRIDGES:
        wb = p["layers"]["attn"][name]["wb"]
        wb[...] = rs.normal(0.0, 0.02, wb.shape)
    return jcfg, jq.quantize_params(p, min_elems=64, bits=bits, group=64)


def _inputs(cfg, B=2, N=14, seed=3):
    """Text / image block / text rows, row 1 left-padded by 2; the
    prompts end in text."""
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
    return {"input_ids": ids, "attention_mask": mask, "vision_indices": vi,
            "coninous_signal": sig}


CASES = [
    # (config kwargs, weight bits, GenerationConfig kwargs)
    (KW128, 8, dict(kv_quant=True, decode_modality="text")),
    (KW128, 8, dict(kv_quant=True, a8_prefill=True, decode_modality="text")),
    (KW128, 4, dict(kv_quant=True, a8_prefill=True, decode_modality="text")),
    (KW128, 8, dict(kv_quant=True, decode_modality="dual")),
    ({}, 8, dict(kv_quant=True, a8_prefill=True)),   # head dim 16: no kernel
]
IDS = ["int8-kv8", "int8-kv8-a8", "int4-kv8-a8", "int8-kv8-dual",
       "int8-kv8-a8-hd16"]


@pytest.mark.parametrize("kw,bits,gen_kw", CASES, ids=IDS)
def test_quantized_generation_matches_jax(kw, bits, gen_kw, monkeypatch):
    """Equal greedy tokens, and the decode steps go through the decode
    kernel's branch exactly when the head dim allows it."""
    jcfg, jtree = _trees(tuple(sorted(kw.items())), bits)
    cfg = LibraConfig.tiny(**kw)
    inputs = _inputs(cfg)
    calls = []
    real = TM.int8_decode_attention
    monkeypatch.setattr(TM, "int8_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gen = dict(max_new_tokens=MAX_NEW, eos_token_id=-1, **gen_kw)
    want = jgen.Generator(jtree, jcfg)(inputs, jgen.GenerationConfig(**gen))
    got = tgen.Generator(from_numpy_tree(jtree, device="cpu"), cfg)(
        inputs, tgen.GenerationConfig(**gen))
    np.testing.assert_array_equal(got.sequences.numpy(), np.asarray(want.sequences))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    steps = MAX_NEW - 1
    expected = cfg.num_hidden_layers * steps if cfg.head_dim == tda.HEAD_DIM else 0
    assert len(calls) == expected


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_prefill_logits_match_jax(bits, a8):
    """The prompt pass over an int8 cache (its flash attention reads the
    dequantized cache) and, with a8, the w8a8 matmuls: last-position
    logits equal to JAX's within atol 1e-4."""
    jcfg, jtree = _trees(tuple(sorted(KW128.items())), bits)
    cfg = LibraConfig.tiny(**KW128)
    inputs = _inputs(cfg)
    jg = jgen.GenerationConfig(max_new_tokens=4, kv_quant=True, a8_prefill=a8)
    st = jax.jit(functools.partial(jgen._prefill, cfg=jcfg, gen=jg))(
        jtree, *(inputs[k] for k in ("input_ids", "attention_mask",
                                      "vision_indices", "coninous_signal")))
    t = {k: torch.as_tensor(v) for k, v in inputs.items()}
    got = tgen._prefill(from_numpy_tree(jtree, device="cpu"), t["input_ids"].long(),
                        t["attention_mask"], t["vision_indices"].long(),
                        t["coninous_signal"], cfg=cfg,
                        gen=tgen.GenerationConfig(max_new_tokens=4,
                                                  kv_quant=True, a8_prefill=a8))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(st.logits),
                               rtol=0, atol=1e-4)
    assert isinstance(got.cache.k, type(got.cache.v)) and got.cache.index == 14
    assert got.cache.k.q.dtype == torch.int8


def test_a8_prefill_changes_only_the_prompt_pass():
    """a8_prefill moves the prompt-pass logits (w8a8 is not exact) and
    leaves the context switched off for the decode steps."""
    jcfg, jtree = _trees(tuple(sorted(KW128.items())), 8)
    cfg = LibraConfig.tiny(**KW128)
    t = {k: torch.as_tensor(v) for k, v in _inputs(cfg).items()}
    params = from_numpy_tree(jtree, device="cpu")
    args = (t["input_ids"].long(), t["attention_mask"], t["vision_indices"].long(),
            t["coninous_signal"])
    logits = [tgen._prefill(params, *args, cfg=cfg, gen=tgen.GenerationConfig(
        max_new_tokens=2, kv_quant=True, a8_prefill=a8)).logits for a8 in (False, True)]
    finite = torch.isfinite(logits[0])
    diff = (logits[0][finite] - logits[1][finite]).abs().max().item()
    assert 0 < diff < 0.05 * logits[0][finite].abs().max().item()
    from libra_tpu_torch.ops import qlinear
    assert not qlinear._A8_ENABLED.get()
