"""The port's text-only LLaMA family (libra_tpu_torch.models.llama) and its
converters against libra_tpu's, on the CPU in fp32 at a tiny size
(vocab 128, hidden 32, 4 heads, 2 layers), mirroring
tests/test_llama_family.py and tests/test_meta_converter.py:

* forward's logits and sequence_classification_logits against
  libra_tpu.models.llama on one tree carried across, right- and
  left-padded rows (fully masked query rows included): rtol 1e-5;
* the gradient of one LM loss under remat=True against jax.grad of the
  same loss with remat=True: every leaf within 1e-4 of its largest entry;
* logits parity with transformers' LlamaForCausalLM and
  LlamaForSequenceClassification (rtol 3e-4, as the JAX cases; skipped
  without transformers);
* convert_hf_llama_state_dict and convert_meta_llama_state_dict equal to
  libra_tpu's, leaf for leaf, and to each other;
* init_params' key paths and shapes equal to libra_tpu's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libra_tpu import checkpoint as jckpt
from libra_tpu.config import LibraConfig as JConfig
from libra_tpu.models import llama as JL
from libra_tpu_torch import checkpoint as tckpt
from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.models import llama as TL
from libra_tpu_torch.params import from_numpy_tree

DIMS = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)
B, N, LABELS = 3, 9, 5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree.detach().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


@functools.lru_cache(maxsize=None)
def _trees():
    """(JAX tree, numpy tree) from libra_tpu's init with a 'score' head."""
    jcfg = JConfig.tiny(**DIMS)
    jp = JL.init_params(jax.random.PRNGKey(0), jcfg)
    jp["score"] = 0.02 * jax.random.normal(jax.random.PRNGKey(1),
                                           (DIMS["hidden_size"], LABELS))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _port(np_tree):
    return from_numpy_tree(np_tree, device="cpu")


def _inputs():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, DIMS["vocab_size"], (B, N))
    mask = np.ones((B, N), np.int32)
    mask[0, 6:] = 0           # right-padded
    mask[1, :3] = 0           # left-padded: fully masked query rows
    return ids, mask


@functools.lru_cache(maxsize=None)
def _jax_outputs():
    jp, _ = _trees()
    jcfg = JConfig.tiny(**DIMS)
    ids, mask = _inputs()
    fwd = jax.jit(lambda p, i, m: JL.forward(p, jcfg, i, m))
    cls = jax.jit(lambda p, i, m: JL.sequence_classification_logits(p, jcfg, i, m))
    return (np.asarray(fwd(jp, ids, mask)), np.asarray(cls(jp, ids, mask)),
            np.asarray(cls(jp, ids, None)))


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_forward_and_classifier_match_jax(attn_impl):
    """"auto" takes the plain attention on the CPU; "flash" the flash
    wrapper, whose CPU tensors take its plain version."""
    _, np_tree = _trees()
    params = _port(np_tree)
    cfg = LibraConfig.tiny(**DIMS)
    ids, mask = _inputs()
    want_logits, want_cls, want_cls_nomask = _jax_outputs()
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        got = TL.forward(params, cfg, ti, tm, attn_impl=attn_impl)
        cls = TL.sequence_classification_logits(params, cfg, ti, tm,
                                                attn_impl=attn_impl)
        cls_nomask = TL.sequence_classification_logits(params, cfg, ti,
                                                       attn_impl=attn_impl)
    np.testing.assert_allclose(got.numpy(), want_logits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cls.numpy(), want_cls, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cls_nomask.numpy(), want_cls_nomask,
                               rtol=1e-5, atol=1e-5)


def test_remat_gradient_matches_jax():
    """One LM loss (mean next-token cross entropy over live targets) under
    remat=True: the port's autograd against jax.grad, every leaf within
    1e-4 of its largest entry."""
    jp, np_tree = _trees()
    jp = {k: v for k, v in jp.items() if k != "score"}
    jcfg = JConfig.tiny(**DIMS)
    ids, mask = _inputs()
    live = (mask[:, 1:] * mask[:, :-1]).astype(np.float32)

    def jloss(p):
        logits = JL.forward(p, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                            remat=True)
        lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(lp, jnp.asarray(ids)[:, 1:, None], -1)[..., 0]
        return (nll * live).sum() / live.sum()

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jp)

    params = _port({k: v for k, v in np_tree.items() if k != "score"})
    leaves = _flat_tensors(params)
    for t in leaves.values():
        t.requires_grad_(True)
    cfg = LibraConfig.tiny(**DIMS)
    ti = torch.from_numpy(ids)
    logits = TL.forward(params, cfg, ti, torch.from_numpy(mask), remat=True)
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -lp.gather(-1, ti[:, 1:, None])[..., 0]
    tlive = torch.from_numpy(live)
    loss = (nll * tlive).sum() / tlive.sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    want = _flat(want)
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        err = np.abs(g.numpy() - want[k]).max() / np.abs(want[k]).max()
        assert err < 1e-4, (k, err)


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _hf_config(transformers, **kw):
    return transformers.LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rope_theta=10000.0,
        attn_implementation="eager", **kw)


def test_llama_parity_vs_hf():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(_hf_config(transformers)).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    if "lm_head.weight" not in sd:  # tied embeddings
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    cfg = LibraConfig.tiny(**DIMS)
    params = TL.convert_hf_llama_state_dict(sd, cfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (2, 9)))
    with torch.no_grad():
        want = model(ids).logits.numpy()
        got = TL.forward(params, cfg, ids).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_llama_sequence_classification_vs_hf():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    model = transformers.LlamaForSequenceClassification(
        _hf_config(transformers, num_labels=5, pad_token_id=0)).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd["lm_head.weight"] = np.zeros((128, 32), np.float32)  # unused head
    cfg = LibraConfig.tiny(**DIMS)
    params = TL.convert_hf_llama_state_dict(sd, cfg, device="cpu")
    params["score"] = torch.from_numpy(sd["score.weight"].T.copy())
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 128, (3, 9))
    ids[0, 6:] = 0                      # right padding (pad_token_id=0)
    mask = (ids != 0).astype(np.int64)
    with torch.no_grad():
        want = model(torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)).logits.numpy()
        got = TL.sequence_classification_logits(
            params, cfg, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def _inverse_permute(w, H, hd, D):
    # inverse of (H, hd//2, 2, D).transpose(0,2,1,3): halves -> interleaved
    return (np.asarray(w).reshape(H, 2, hd // 2, D)
            .transpose(0, 2, 1, 3).reshape(D, D))


def _state_dicts():
    """tests/test_meta_converter.py's pair: a seeded HF state dict and the
    same weights in Meta's layout (wq / wk rows interleaved)."""
    cfg = JConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=48,
                       num_hidden_layers=2, num_attention_heads=4)
    D, H, I = cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size
    hd = D // H
    rng = np.random.RandomState(0)
    hf_sd, meta_sd = {}, {}
    for i in range(cfg.num_hidden_layers):
        for hf_name, meta_name, shape, permuted in [
                ("self_attn.q_proj", "attention.wq", (D, D), True),
                ("self_attn.k_proj", "attention.wk", (D, D), True),
                ("self_attn.v_proj", "attention.wv", (D, D), False),
                ("self_attn.o_proj", "attention.wo", (D, D), False),
                ("mlp.gate_proj", "feed_forward.w1", (I, D), False),
                ("mlp.up_proj", "feed_forward.w3", (I, D), False),
                ("mlp.down_proj", "feed_forward.w2", (D, I), False),
                ("input_layernorm", "attention_norm", (D,), False),
                ("post_attention_layernorm", "ffn_norm", (D,), False)]:
            w = rng.randn(*shape).astype(np.float32)
            hf_sd[f"model.layers.{i}.{hf_name}.weight"] = w
            meta_sd[f"layers.{i}.{meta_name}.weight"] = (
                _inverse_permute(w, H, hd, D) if permuted else w)
    emb = rng.randn(cfg.vocab_size, D).astype(np.float32)
    out_w = rng.randn(cfg.vocab_size, D).astype(np.float32)
    norm = rng.randn(D).astype(np.float32)
    hf_sd |= {"model.embed_tokens.weight": emb, "model.norm.weight": norm,
              "lm_head.weight": out_w}
    meta_sd |= {"tok_embeddings.weight": emb, "norm.weight": norm,
                "output.weight": out_w}
    return cfg, hf_sd, meta_sd


@pytest.mark.parametrize("fmt", ["hf", "meta"])
def test_converters_match_jax(fmt):
    jcfg, hf_sd, meta_sd = _state_dicts()
    cfg = LibraConfig.tiny(vocab_size=64, hidden_size=32, intermediate_size=48,
                           num_hidden_layers=2, num_attention_heads=4)
    if fmt == "hf":
        want = JL.convert_hf_llama_state_dict(hf_sd, jcfg)
        got = TL.convert_hf_llama_state_dict(hf_sd, cfg, device="cpu")
    else:
        want = jckpt.convert_meta_llama_state_dict(meta_sd, jcfg)
        got = tckpt.convert_meta_llama_state_dict(meta_sd, cfg, device="cpu")
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # and the Meta tree equals the HF one (the de-interleave is exact)
    if fmt == "meta":
        hf = _flat(TL.convert_hf_llama_state_dict(hf_sd, cfg, device="cpu"))
        for k in hf:
            np.testing.assert_array_equal(g[k], hf[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_paths_and_shapes_match_jax(dtype):
    jcfg = JConfig.tiny(**DIMS, param_dtype=dtype)
    shapes = jax.eval_shape(lambda: JL.init_params(jax.random.PRNGKey(0), jcfg))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    params = TL.init_params(torch.Generator().manual_seed(0),
                            LibraConfig.tiny(**DIMS, param_dtype=dtype), "cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat_tensors(params).items()}
    assert got == want
    assert all(torch.equal(params["layers"][n], torch.ones_like(params["layers"][n]))
               for n in TL.NORMS)


def test_parse_trace_on_a_cpu_forward(tmp_path, capsys):
    """tools.profiling.trace over a 2-layer CPU forward writes a chrome
    trace; parse_trace lists its host operators (a CPU trace has no device
    kernels), the matmuls among them, largest first."""
    from libra_tpu_torch.tools import parse_trace, profiling
    _, np_tree = _trees()
    params = _port(np_tree)
    cfg = LibraConfig.tiny(**DIMS)
    ids, mask = _inputs()
    with torch.no_grad():
        path = profiling.trace(
            lambda: TL.forward(params, cfg, torch.from_numpy(ids),
                               torch.from_numpy(mask)),
            tmp_path / "traces", "llama_forward", "cpu")
    assert path.exists()
    cat, total, rows = parse_trace.summarize(path)
    assert cat == "cpu_op" and total > 0 and 0 < len(rows) <= 40
    names = [r[0] for r in rows]
    assert any("matmul" in n or "mm" in n for n in names)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    parse_trace.main([str(tmp_path / "traces")])
    out = capsys.readouterr().out
    assert "llama_forward.json: host operators" in out
