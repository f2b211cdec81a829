"""Synthetic checkpoints in the reference layout, and tree helpers, for
the port's checkpoint and serving tests.

A checkpoint dir here holds what a Libra checkpoint holds, at a tiny size:

    <ckpt>/
      config.json                              (LibraConfig.to_dict())
      pytorch_model-0000?-of-00002.bin         (the decoder's reference-
                                                named state dict, two shards)
      tokenizer.json / tokenizer_config.json   (a word-level fast tokenizer
                                                over the whole text vocab)
      vision_tokenizer_config.yaml             (optional)
      vqgan.ckpt                               (Lightning {"state_dict": ...}:
                                                quant convs and the conv
                                                decoder, a loss.* key)
      openai-clip-vit-large-patch14-336/       (nested CLIP dir: a joint
        config.json + pytorch_model.bin         CLIPConfig, HF weights)

The decoder's weights are tests/torch_oracle.make_reference_state_dict's;
the VQGAN's are libra_tpu's init tree with seeded noise on every leaf,
inverted to the reference's names (HWIO -> OIHW); the CLIP tower is the
installed transformers.CLIPVisionModel. The YAML and the shard writer are
tests/test_synthetic_checkpoint.py's.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import jax
import numpy as np
import torch
import yaml

from libra_tpu.config import CLIPVisionConfig as JCLIPVisionConfig
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.models import vqgan as jvqgan
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.quantization import Quantized4Array, QuantizedArray
from tests.test_synthetic_checkpoint import YAML, _write_shards
from tests.torch_oracle import make_reference_state_dict

CLIP_DIR = "openai-clip-vit-large-patch14-336"


def port_tree(jtree):
    """A libra_tpu tree (jax or numpy leaves) as the port's CPU tree."""
    return from_numpy_tree(jax.tree_util.tree_map(np.asarray, jtree), device="cpu")


def assert_trees_equal(got, want, path: str = "") -> int:
    """The same structure (dict keys, list lengths, quantized node types
    and fields) and every tensor leaf equal in dtype, shape and value.
    Returns the number of tensor leaves compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            f"{path}: keys {sorted(got) if isinstance(got, dict) else got!r} != {sorted(want)}"
        return sum(assert_trees_equal(got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        return sum(assert_trees_equal(g, w, f"{path}[{i}]")
                   for i, (g, w) in enumerate(zip(got, want)))
    if isinstance(want, Quantized4Array):
        assert isinstance(got, Quantized4Array), f"{path}: {type(got)}"
        assert (got.group, got.out_features, got.a8) == \
            (want.group, want.out_features, want.a8), path
        return (assert_trees_equal(got.packed, want.packed, f"{path}.packed")
                + assert_trees_equal(got.scale, want.scale, f"{path}.scale"))
    if isinstance(want, QuantizedArray):
        assert isinstance(got, QuantizedArray), f"{path}: {type(got)}"
        return (assert_trees_equal(got.q, want.q, f"{path}.q")
                + assert_trees_equal(got.scale, want.scale, f"{path}.scale"))
    assert isinstance(got, torch.Tensor), f"{path}: {type(got)}"
    assert got.dtype == want.dtype, f"{path}: {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{path}: {tuple(got.shape)} != {tuple(want.shape)}"
    assert torch.equal(got, want), f"{path}: values differ"
    return 1


# ---------------------------------------------------------------------------
# VQGAN trees in the reference's names
# ---------------------------------------------------------------------------

def _noisy(tree, seed: int):
    """A numpy copy of `tree` with N(0, 0.05) noise on every leaf, so no
    bias is zero and no norm scale one."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rs.randn(*np.shape(a)) * 0.05).astype(np.float32),
        tree)


@functools.lru_cache(maxsize=None)
def vq_tree(jvq: JVQGANConfig, seed: int = 3, encoder: bool = False):
    """libra_tpu's VQGAN init tree at `jvq` (clip, quant_conv,
    post_quant_conv, decoder; with `encoder`, the conv encoder too), every
    leaf noised; numpy leaves. Cached: callers must not modify it."""
    key = jax.random.PRNGKey(seed)
    tree = jax.jit(functools.partial(jvqgan.init_params, cfg=jvq))(key)
    if encoder:
        tree["encoder"] = jax.jit(functools.partial(
            jvqgan.init_encoder_params, cfg=jvq))(jax.random.fold_in(key, 1))
    return _noisy(tree, seed)


def vq_tree_to_state_dict(tree, jvq: JVQGANConfig):
    """The VQGAN tree (without its CLIP) under the reference VQModel's
    names, as torch tensors: convs OIHW, group norms weight/bias."""
    sd = {}

    def conv(name, p):
        w = np.asarray(p["w"])
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1) if w.ndim == 4 else w))
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())

    def gn(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p["scale"]).copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p["bias"]).copy())

    def resnet(name, p):
        for n in ("norm1", "norm2"):
            gn(f"{name}.{n}", p[n])
        for n in ("conv1", "conv2", "nin_shortcut"):
            if n in p:
                conv(f"{name}.{n}", p[n])

    def attn(name, p):
        gn(f"{name}.norm", p["norm"])
        for n in ("q", "k", "v", "proj_out"):
            conv(f"{name}.{n}", p[n])

    def trunk(prefix, p):
        conv(f"{prefix}.conv_in", p["conv_in"])
        resnet(f"{prefix}.mid.block_1", p["mid_block_1"])
        attn(f"{prefix}.mid.attn_1", p["mid_attn_1"])
        resnet(f"{prefix}.mid.block_2", p["mid_block_2"])
        gn(f"{prefix}.norm_out", p["norm_out"])
        conv(f"{prefix}.conv_out", p["conv_out"])

    conv("quant_conv", tree["quant_conv"])
    conv("post_quant_conv", tree["post_quant_conv"])
    dec = tree["decoder"]
    trunk("decoder", dec)
    if "first_norm" in dec:
        gn("decoder.first_norm", dec["first_norm"])
    levels, _ = jvqgan.decoder_plan(jvq)
    for lev, entry in zip(levels, dec["up"]):
        i = lev["i_level"]
        for j, blk in enumerate(entry["block"]):
            resnet(f"decoder.up.{i}.block.{j}", blk)
        for j, a in enumerate(entry["attn"]):
            attn(f"decoder.up.{i}.attn.{j}", a)
        if "upsample_conv" in entry:
            conv(f"decoder.up.{i}.upsample.conv", entry["upsample_conv"])
    if "encoder" in tree:
        enc = tree["encoder"]
        trunk("encoder", enc)
        for i, entry in enumerate(enc["down"]):
            for j, blk in enumerate(entry["block"]):
                resnet(f"encoder.down.{i}.block.{j}", blk)
            for j, a in enumerate(entry["attn"]):
                attn(f"encoder.down.{i}.attn.{j}", a)
            if "downsample_conv" in entry:
                conv(f"encoder.down.{i}.downsample.conv", entry["downsample_conv"])
    # tokenizer-training leftovers the loader must ignore
    sd["loss.discriminator.main.0.weight"] = torch.zeros(4, 3, 3, 3)
    return sd


@functools.lru_cache(maxsize=None)
def hf_clip(seed: int = 2):
    """(transformers.CLIPVisionConfig, CLIPVisionModel) at the tiny
    geometry (CLIPVisionConfig.tiny())."""
    import transformers
    hf_cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14)
    torch.manual_seed(seed)
    return hf_cfg, transformers.CLIPVisionModel(hf_cfg).eval()


def numpy_sd(sd):
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# A whole checkpoint dir
# ---------------------------------------------------------------------------

def tokenizer_files(d: Path, vocab_size: int) -> None:
    """A whitespace word-level fast tokenizer with one word per text id
    (<unk> = 0, <s> = 1, </s> = 2, a few English words, then w<i>), so
    that every generated text id decodes to a word; <img_ph> and
    <img_gen> are added tokens past the vocab, as in the reference."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<unk>", "<s>", "</s>", "what", "is", "the", "cat", "a", "dog"]
    vocab = {w: i for i, w in enumerate(words)}
    vocab |= {f"w{i}": i for i in range(len(words), vocab_size)}
    t = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(tokenizer_object=t, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(str(d))


def yaml_vq_config() -> JVQGANConfig:
    """libra_tpu's VQGAN config of YAML with the tiny CLIP (the nested
    dir's)."""
    return dataclasses.replace(JVQGANConfig.from_yaml_dict(yaml.safe_load(YAML)),
                               clip=JCLIPVisionConfig.tiny())


def write_checkpoint(d: Path, jcfg, seed: int = 0) -> dict:
    """Write a checkpoint dir for libra_tpu's LibraConfig `jcfg` (with the
    YAML's vision tokenizer) into `d`. Returns its state dicts."""
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(jcfg.to_dict()))
    sd = make_reference_state_dict(jcfg, seed=seed)
    _write_shards(d, sd, "bin")
    tokenizer_files(d, jcfg.vocab_size)
    (d / "vision_tokenizer_config.yaml").write_text(YAML)
    tree = vq_tree(yaml_vq_config())
    vq_sd = vq_tree_to_state_dict(tree, yaml_vq_config())
    torch.save({"state_dict": vq_sd, "epoch": 3, "global_step": 0},
               str(d / "vqgan.ckpt"))
    hf_cfg, clip = hf_clip()
    cd = d / CLIP_DIR
    cd.mkdir()
    (cd / "config.json").write_text(json.dumps(
        {"model_type": "clip", "vision_config": hf_cfg.to_dict()}))
    torch.save(clip.state_dict(), str(cd / "pytorch_model.bin"))
    return {"decoder": sd, "vqgan": vq_sd}
