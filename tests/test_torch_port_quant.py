"""The port's quantization, int8/int4 matmuls, qdot dispatch, int8 KV
cache and int8 decode attention against libra_tpu's, on the same numpy
inputs, fp32 on the CPU.

Each kernel's plain version is held against the Pallas kernel run in
interpret mode, as tests/test_pallas_kernels.py runs it. The Pallas
kernels round x (and the decode kernel its probabilities) to bf16 before
their dots; the inputs here are bf16-representable, so the matmuls differ
only in the order of fp32 sums, and each test states its slack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import quantization as jq
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.models import libra as JM
from libra_tpu.ops import qlinear as jql
from libra_tpu.ops.pallas import decode_attention as jda
from libra_tpu.ops.pallas import int4_matmul as ji4
from libra_tpu.ops.pallas import int8_matmul as ji8
from libra_tpu_torch import quantization as tq
from libra_tpu_torch.models import libra as TM
from libra_tpu_torch.ops import decode_attention as tda
from libra_tpu_torch.ops import int4_matmul as ti4
from libra_tpu_torch.ops import int8_matmul as ti8
from libra_tpu_torch.ops import qlinear as tql
from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.params import from_numpy_tree


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round to bf16 values, kept as fp32."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_names(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


# Tree configs: a vision-MLP bottleneck of 160 (padded to 256 for int8 and
# for int4 at group 128); head dim 128 with K = 256 leaves for int4.
TREES = [
    (dict(intermediate_size=640), 8, 128),
    (dict(hidden_size=256, num_attention_heads=2, intermediate_size=256), 4, 64),
    (dict(hidden_size=256, num_attention_heads=2, intermediate_size=640), 4, 128),
]


@pytest.mark.parametrize("kw,bits,group", TREES)
def test_quantize_params_matches_jax(kw, bits, group):
    """Same tree, same leaf kinds and the same bytes: int8 q and scales
    bitwise equal; int4 packed and scales equal on the unpadded columns;
    bridges, norms and vision_lm_head kept; the bottleneck padded."""
    jcfg = JLibraConfig.tiny(**kw)
    params = _np_tree(jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    want = jq.quantize_params(params, min_elems=64, bits=bits, group=group)
    got = tq.quantize_params(from_numpy_tree(params, device="cpu"), min_elems=64, bits=bits,
                             group=group)
    got_leaves = dict(_leaves_with_names(got))
    want_leaves = dict(_leaves_with_names(want))
    assert got_leaves.keys() == want_leaves.keys()
    kinds = set()
    for name, w in want_leaves.items():
        g = got_leaves[name]
        if isinstance(w, jq.Quantized4Array):
            assert isinstance(g, tq.Quantized4Array), name
            O = w.shape[-1]
            np.testing.assert_array_equal(g.packed.numpy(),
                                          np.asarray(w.packed)[..., :O])
            np.testing.assert_array_equal(g.scale.numpy(),
                                          np.asarray(w.scale)[..., :O])
            assert (g.group, g.a8) == (w.group, w.a8)
            kinds.add("int4")
        elif isinstance(w, jq.QuantizedArray):
            assert type(g) is tq.QuantizedArray, name
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
            kinds.add("int8")
        else:
            assert torch.is_tensor(g), name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert kinds == ({"int8"} if bits == 8 else {"int8", "int4"})
    attn, mlp = got["layers"]["attn"], got["layers"]["mlp"]
    assert torch.is_tensor(attn["k_bridge_lang"]["wa"])        # rank 4 < 128
    assert torch.is_tensor(got["vision_lm_head"])
    assert torch.is_tensor(got["layers"]["input_layernorm"])
    Ib = jcfg.intermediate_size // jcfg.vision_down_ratio
    mult = 2 * group if bits == 4 else 128
    inner = Ib if Ib < 128 else -(-Ib // mult) * mult        # < 128: kept
    assert mlp["vision_gate"]["wa"].shape[-1] == inner
    assert mlp["vision_gate"]["wb"].shape[-2] == inner
    assert tq.quantization_error(from_numpy_tree(params, device="cpu"), got) < (
        0.01 if bits == 8 else 0.15)


def _padded_int4(rs, K=256, O=192, pad=64, group=64, L=2):
    """A JAX Quantized4Array whose O is zero-padded (as JAX pads for its
    TPU block width), with out_features set."""
    w = rs.randn(L, K, O).astype(np.float32)
    wp = np.concatenate([w, np.zeros((L, K, pad), np.float32)], -1)
    packed, scale = ji4.pack_int4(wp, group=group)
    return jq.Quantized4Array(np.asarray(packed), np.asarray(scale), group,
                              out_features=O, a8=True)


@pytest.mark.parametrize("bits", [8, 4])
def test_from_numpy_tree_carries_quantized_tree(bits):
    jcfg = JLibraConfig.tiny(hidden_size=256, num_attention_heads=2,
                             intermediate_size=256)
    params = _np_tree(jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(1)))
    jtree = jq.quantize_params(params, min_elems=64, bits=bits, group=64)
    jtree["padded"] = _padded_int4(np.random.RandomState(0))
    ttree = from_numpy_tree(_np_tree(jtree), device="cpu")
    assert isinstance(ttree["padded"], tq.Quantized4Array)
    assert ttree["padded"].out_features == 192
    assert ttree["padded"].shape == (2, 256, 192)
    want = dict(_leaves_with_names(jq.dequantize_params(jtree, jnp.float32)))
    got = dict(_leaves_with_names(tq.dequantize_params(ttree, torch.float32)))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)


def test_pack_and_dequant_int4_match_jax():
    rs = np.random.RandomState(2)
    w = rs.randn(3, 256, 96).astype(np.float32)
    w[0, :64] = 0.0                                    # an all-zero group
    jp, js = ji4.pack_int4(w, group=64)
    tp, ts = ti4.pack_int4(torch.from_numpy(w), group=64)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        ti4.dequant_int4(tp, ts, 64).numpy(),
        np.asarray(ji4.dequant_int4(jnp.asarray(jp), jnp.asarray(js), 64)))


@pytest.mark.parametrize("M", [1, 4, 7, 8, 33])
def test_int8_matmul_plain_matches_pallas(M):
    """Plain and stacked (layer idx) forms; the layer view q[l] of the
    stacked buffer is what the port hands its kernel. M = 7 and 8 are the
    edges of the kernel's decode template (M <= 8), 33 takes the chunked
    one. Slack: fp32 sums in another order, 1e-5 of max|out|."""
    rs = np.random.RandomState(M)
    L, K, F = 3, 256, 384
    qa = jq.quantize_array(rs.randn(L, K, F).astype(np.float32) * 0.1, axis=-2)
    x = _bf16(rs.randn(M, K).astype(np.float32))
    tqa = from_numpy_tree(qa, device="cpu")
    for li in range(L):
        want = np.asarray(ji8.int8_matmul(jnp.asarray(x), jnp.asarray(qa.q),
                                          jnp.asarray(qa.scale),
                                          idx=jnp.int32(li), interpret=True))
        got = ti8.int8_matmul(torch.from_numpy(x), tqa.q[li], tqa.scale[li])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    want = np.asarray(ji8.int8_matmul(jnp.asarray(x), jnp.asarray(qa.q[1]),
                                      jnp.asarray(qa.scale[1]), interpret=True))
    got = ti8.int8_matmul_plain(torch.from_numpy(x), tqa.q[1], tqa.scale[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("a8", [False, True])
def test_int4_matmul_plain_matches_pallas(a8):
    """Weight-only and W4A8, plain and stacked. The W4A8 group sums are
    exact integers on both sides; the Pallas kernel takes the +8 bias off
    after scaling (acc - 8 * corr), a cancellation in fp32, so the slack
    is 1e-5 of max|out|."""
    rs = np.random.RandomState(5)
    L, K, O, G, M = 2, 512, 256, 128, 4
    packed, scale = ji4.pack_int4(rs.randn(L, K, O).astype(np.float32), group=G)
    x = _bf16(rs.randn(M, K).astype(np.float32))
    tp, ts = torch.from_numpy(np.asarray(packed)), torch.from_numpy(np.asarray(scale))
    for li in range(L):
        want = np.asarray(ji4.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                          jnp.asarray(scale), group=G,
                                          idx=jnp.int32(li), a8=a8,
                                          interpret=True))
        got = ti4.int4_matmul(torch.from_numpy(x), tp[li], ts[li], G, a8=a8)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert ti4.supports(torch.from_numpy(x), tp[0], ts[0], G)


def _qcache(rs, B, H, S, d):
    x = rs.randn(B, H, S, d).astype(np.float32)
    a = np.abs(x).max(-1, keepdims=True)
    scale = np.where(a > 0, a, 1.0) / 127.0
    return (np.clip(np.round(x / scale), -127, 127).astype(np.int8),
            scale[..., 0].astype(np.float32))


def _decode_attention_case(N: int, bridge: bool):
    """The decode-attention inputs of the tests below: B=2, H=4, S=128,
    d=128, left-padded rows, a masked tail and, for N = 8, a per-query
    causal bias; q bf16-valued fp32. Returns (q, buffers by keyword name,
    flags and bias, max|V| dequantized)."""
    rs = np.random.RandomState(10 + N)
    B, H, S, d = 2, 4, 128, 128
    bufs = [_qcache(rs, B, H, S, d) for _ in range(4 if bridge else 2)]
    q = _bf16(rs.randn(B, N, H, d).astype(np.float32))
    flag_q = rs.rand(B, N) < 0.5
    kv_flag = rs.rand(B, S) < 0.4
    keep = np.zeros((B, N, S), bool)
    for i in range(N):
        keep[:, i, :100 + i + 1] = True
    keep[0, :, :3] = False
    bias = np.where(keep, 0.0, -2.0 ** 30).astype(np.float32)
    if N == 1:
        bias, flag_q = bias[:, 0], flag_q[:, 0]
    names = ["kq", "ks", "vq", "vs", "kbq", "kbs", "vbq", "vbs"]
    kw = {n: a for n, a in zip(names, [t for pair in bufs for t in pair])}
    vmax = np.abs(bufs[1][0] * bufs[1][1][..., None]).max()
    return q, kw, dict(flag_q=flag_q, kv_flag=kv_flag, bias=bias), vmax


def _pallas_decode_attention(q, kw, masks) -> np.ndarray:
    return np.asarray(jda.int8_decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16),
        **{n: jnp.asarray(a) for n, a in kw.items()},
        **{n: jnp.asarray(a) for n, a in masks.items()}, interpret=True), np.float32)


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("N", [1, 8])
def test_int8_decode_attention_plain_matches_pallas(bridge, N):
    """Left-padded rows, a masked tail and, for N = 8, a per-query causal
    bias. The Pallas kernel rounds the scaled probabilities (a * v_scale)
    to bf16 before its value dots: a relative 2^-9 on each term, so the
    slack is 2^-8 of max|V|, the largest an output can be."""
    q, kw, masks, vmax = _decode_attention_case(N, bridge)
    want = _pallas_decode_attention(q, kw, masks)
    got = tda.int8_decode_attention(
        torch.from_numpy(q), **{n: torch.from_numpy(a) for n, a in kw.items()},
        **{n: torch.from_numpy(a) for n, a in masks.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -8 * vmax)


@pytest.mark.parametrize("bridge", [True, False])
@pytest.mark.parametrize("N", [1, 8])
def test_int8_decode_attention_plain_matches_pallas_bf16(bridge, N):
    """The same inputs with bf16 q on both sides, bf16 outputs compared:
    the plain version rounds a * v_scale and a * cross * vb_scale to q's
    dtype before the value products, as the Pallas kernel's _weighted_v
    does, so the two differ only in the order of fp32 sums. A rounding of
    a probability may flip where the sums land on either side of a bf16
    tie, and an output's rounding to bf16 with it: at most 0.1% of
    outputs differ, by at most 2^-12 of max|V|. Keeping the probabilities
    in fp32 makes ~40% of outputs differ, by up to ~1e-3 of max|V|."""
    q, kw, masks, vmax = _decode_attention_case(N, bridge)
    want = _pallas_decode_attention(q, kw, masks)
    got = tda.int8_decode_attention(
        torch.from_numpy(q).bfloat16(), **{n: torch.from_numpy(a) for n, a in kw.items()},
        **{n: torch.from_numpy(a) for n, a in masks.items()})
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} of outputs differ"
    assert diff.max() <= 2.0 ** -12 * vmax, diff.max() / vmax


def test_decode_kernel_gate():
    cfg = LibraConfig.tiny(hidden_size=256, num_attention_heads=2,
                           intermediate_size=256)
    cache = TM.init_cache(cfg, 2, 40, quantized=True, device="cpu")
    ok = [n for n in range(1, 80)
          if tda.decode_kernel_applicable(cache.k[0], n, cfg.head_dim)]
    assert ok == [1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 48, 56, 64]
    assert not tda.decode_kernel_applicable(cache.k[0], 1, 64)
    plain = TM.init_cache(cfg, 2, 40, device="cpu")
    assert not tda.decode_kernel_applicable(plain.k[0], 1, cfg.head_dim)


def test_matmul_gates():
    x = torch.zeros(160, 256)
    qa = tq.quantize_array(torch.randn(3, 256, 40), axis=-2)
    assert ti8.supports(x, qa.q[0], qa.scale[0])          # any K, F
    assert not ti8.supports(torch.zeros(161, 256), qa.q[0], qa.scale[0])
    assert not ti8.supports(x, qa.q, qa.scale)            # stacked: not 2-D
    q4 = tq.quantize_array_int4(torch.randn(2, 256, 40), group=64)
    assert ti4.supports(x, q4.packed[1], q4.scale[1], 64)
    assert not ti4.supports(torch.zeros(2, 81, 256), q4.packed[1], q4.scale[1], 64)
    assert not ti4.supports(x, q4.packed, q4.scale, 64)


def _qdot_cases(rs):
    """(name, JAX weight, port weight) for every kind qdot takes."""
    K, F = 256, 384
    w = rs.randn(K, F).astype(np.float32) * 0.1
    w3 = rs.randn(3, K, F).astype(np.float32) * 0.1
    qa, qa3 = jq.quantize_array(w, axis=-2), jq.quantize_array(w3, axis=-2)
    p4, s4 = ji4.pack_int4(w3, group=64)
    q4 = jq.Quantized4Array(np.asarray(p4), np.asarray(s4), 64, a8=True)
    pad4 = _padded_int4(rs, K=K, O=F - 64, pad=64)
    jview = lambda a: jq.LayerView(jax.tree_util.tree_map(jnp.asarray, a),  # noqa: E731
                                   jnp.int32(1))
    return [
        ("plain", jnp.asarray(w), torch.from_numpy(w)),
        ("int8", qa, from_numpy_tree(qa, device="cpu")),
        ("int8 layer view", jview(qa3), from_numpy_tree(qa3, device="cpu")[1]),
        ("int4 layer view", jview(q4), from_numpy_tree(q4, device="cpu")[1]),
        ("int4 padded O", jview(pad4), from_numpy_tree(pad4, device="cpu")[1]),
    ]


@pytest.mark.parametrize("a8", [False, True])
def test_qdot_matches_jax(a8):
    """Port qdot against JAX qdot on the CPU for every weight kind, with
    and without a8_enabled (int8 weights then take _a8_dot, whose integer
    sums are exact). fp32 sums in another order: tolerance 1e-5 of
    max|out|."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 256).astype(np.float32)
    for name, jw, tw in _qdot_cases(rs):
        with jql.a8_enabled(a8):
            want = np.asarray(jql.qdot(jnp.asarray(x), jw))
        with tql.a8_enabled(a8):
            got = tql.qdot(torch.from_numpy(x), tw)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert not tql._A8_ENABLED.get()


def test_a8_dot_is_w8a8():
    """_a8_dot against its definition: per-row int8 activations, exact
    integer sums, both scales in fp32 (bitwise), and within the w8a8
    budget of the weight-only product."""
    rs = np.random.RandomState(8)
    qa = tq.quantize_array(torch.from_numpy(rs.randn(256, 128).astype(np.float32)), -2)
    x = torch.from_numpy(rs.randn(40, 256).astype(np.float32))
    sx = x.abs().amax(-1, keepdim=True) / 127.0
    xq = torch.round(x / sx)
    want = (xq.double() @ qa.q.double()).float() * sx * qa.scale[0]
    got = tql._a8_dot(x, qa.q, qa.scale)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    exact = x @ qa.to(torch.float32)
    assert ((got - exact).norm() / exact.norm()).item() < 1e-2


def test_quantized_write_cache_matches_jax():
    """A prompt write then one decode write into layer 1 of a quantized
    cache: int8 values and scales bitwise equal to JAX's."""
    cfg = LibraConfig.tiny()
    jcfg = JLibraConfig.tiny()
    B, S, N = 2, 12, 7
    H, d = cfg.num_attention_heads, cfg.head_dim
    rs = np.random.RandomState(9)
    prompt = rs.randn(B, N, H, d).astype(np.float32)
    prompt[0, 2] = 0.0                                # an all-zero token
    step = rs.randn(B, 1, H, d).astype(np.float32) * 3
    jbuf = JM.init_cache(jcfg, B, S, quantized=True).k
    tbuf = TM.init_cache(cfg, B, S, quantized=True, device="cpu").k
    for new, idx in ((prompt, 0), (step, N)):
        jbuf = JM._write_cache(jbuf, jnp.asarray(new), 1, idx)
        TM._write_cache(tbuf, torch.from_numpy(new), 1, idx)
        np.testing.assert_array_equal(tbuf.q.numpy(), np.asarray(jbuf.q))
        np.testing.assert_array_equal(tbuf.scale.numpy(), np.asarray(jbuf.scale))
    deq = TM._read_cache(tbuf[1], torch.float32)
    np.testing.assert_allclose(deq[:, :N + 1].numpy(),
                               np.concatenate([prompt, step], 1),
                               rtol=0, atol=np.abs(step).max() / 254 + 1e-6)


def test_quantized_gathers_match_jax():
    """Row gathers of quantized leaves as embed_inputs takes them: a
    per-row table (embed_tokens), one codebook of a per-row stack
    (vision_embed_tokens[c][ids]) and a per-column leaf
    (vision_position_embedding, whose one scale row JAX's clamped gather
    repeats). Dequantized values bitwise equal."""
    rs = np.random.RandomState(11)
    ids = rs.randint(0, 6, (2, 5))
    leaves = [(rs.randn(40, 16), -1, None), (rs.randn(6, 16), -2, None),
              (rs.randn(2, 18, 8), -1, 1)]
    for w, axis, codebook in leaves:
        jqa = jax.tree_util.tree_map(
            jnp.asarray, jq.quantize_array(w.astype(np.float32), axis))
        tqa = from_numpy_tree(_np_tree(jqa), device="cpu")
        if codebook is not None:
            jqa, tqa = jqa[codebook], tqa[codebook]
        want = np.asarray(jqa[jnp.asarray(ids)].astype(jnp.float32))
        got = tqa[torch.from_numpy(ids)].to(torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
