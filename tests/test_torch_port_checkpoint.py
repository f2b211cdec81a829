"""The port's checkpoint loading against libra_tpu's, on the CPU at a tiny
size: the raw state-dict loader (.bin, .bin shards, bf16 safetensors
shards), prefix stripping, the decoder, CLIP and VQGAN converters, the
YAML loader, and LibraPipeline.from_pretrained end to end on a synthetic
checkpoint dir in the reference layout (tests/torch_port_ckpt.py): the
port's trees equal to from_numpy_tree of libra_tpu's (plain, int8 and
int4), the text tokenizer's ids equal, and chat answers equal.
"""

import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch
import yaml

from libra_tpu import checkpoint as jckpt
from libra_tpu import config as jconfig
from libra_tpu.data.processors import LibraEvalImageProcessor as JImageProcessor
from libra_tpu.models import vqgan as jvqgan
from libra_tpu.pipeline import LibraPipeline as JPipeline
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu_torch import checkpoint as ckpt
from libra_tpu_torch import config as tconfig
from libra_tpu_torch.models import vqgan as tvqgan
from libra_tpu_torch.pipeline import LibraPipeline
from libra_tpu_torch.tokenization import HFTextTokenizer, ImageTokenizer
from tests import torch_port_ckpt as C
from tests.test_synthetic_checkpoint import YAML, _write_shards
from tests.torch_oracle import make_reference_state_dict

# the end-to-end config: leaves of >= 2^16 elements, so that
# quantize_params' default min_elems quantizes the projections, and
# K = 256 a multiple of int4's group of 128
E2E = dict(hidden_size=256, num_attention_heads=2, intermediate_size=256)
BRIDGE_KEYS = ("vision_k_bridge", "vision_v_bridge")


def _sd_files(tmp_path, fmt):
    """The tiny decoder's reference state dict in bf16, written as one
    .bin, two .bin shards or two round-robin safetensors shards."""
    sd = {k: v.bfloat16() for k, v in
          make_reference_state_dict(jconfig.LibraConfig.tiny()).items()}
    if fmt == "single":
        path = tmp_path / "pytorch_model.bin"
        torch.save(sd, str(path))
        return str(path)
    _write_shards(tmp_path, sd, {"shards": "bin", "safetensors": "safetensors_shuffled"}[fmt])
    return str(tmp_path)


@pytest.mark.parametrize("fmt", ["single", "shards", "safetensors"])
def test_load_torch_state_dict(tmp_path, fmt):
    path = _sd_files(tmp_path, fmt)
    got, want = ckpt.load_torch_state_dict(path), jckpt.load_torch_state_dict(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert want[k].dtype == (np.float32 if fmt != "safetensors" else want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_torch_state_dict_lightning_and_missing(tmp_path):
    """A Lightning {"state_dict": ...} file keeps only its state dict (an
    fp16 and an int leaf keep their dtypes); an empty dir raises."""
    sd = {"a.weight": torch.randn(3, 2).half(), "b.index": torch.arange(4)}
    torch.save({"state_dict": sd, "epoch": 1}, str(tmp_path / "vqgan.ckpt"))
    got = ckpt.load_torch_state_dict(str(tmp_path / "vqgan.ckpt"))
    want = jckpt.load_torch_state_dict(str(tmp_path / "vqgan.ckpt"))
    assert list(got) == list(want) == list(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.load_torch_state_dict(str(tmp_path / "empty"))


@pytest.mark.parametrize("prefix", ["model.model.", "module.model.", "model."])
def test_strip_prefixes(prefix):
    """Wrapped dicts lose their outer prefix (other keys dropped, as in
    libra_tpu); an unwrapped dict passes through."""
    base = {"model.embed_tokens.weight": np.ones(2), "lm_head.weight": np.zeros(3)}
    outer = prefix.split(".")[0] + "."
    sd = {outer + k: v for k, v in base.items()} if prefix != "model." else dict(base)
    sd["other.x"] = np.ones(1)
    got, want = ckpt.strip_prefixes(sd), jckpt.strip_prefixes(sd)
    assert list(got) == list(want)
    if prefix != "model.":
        assert set(got) == set(base)


DECODER_VARIANTS = {
    "bridge": {},
    "no_bridge": dict(use_bridge=False),
    "no_norm_signals": dict(norm_signals=False),
    "additive_signal": dict(concat_signals=False),
    "position_embedding": dict(use_vision_position_embedding=True),
    "bf16_params": dict(param_dtype="bfloat16"),
}


@pytest.mark.parametrize("variant", list(DECODER_VARIANTS))
def test_convert_libra_state_dict(variant):
    kw = DECODER_VARIANTS[variant]
    jcfg = jconfig.LibraConfig.tiny(**kw)
    sd = C.numpy_sd(make_reference_state_dict(jcfg))
    if not jcfg.use_bridge:
        sd = {k: v for k, v in sd.items() if not any(b in k for b in BRIDGE_KEYS)}
    if not jcfg.concat_signals:
        # the additive signal projection is (D, S)
        sd["model.vision_contiguous_signal_processor.weight"] = \
            np.random.RandomState(1).randn(jcfg.hidden_size,
                                           jcfg.contiguous_signal_size).astype(np.float32)
        del sd["model.vision_signal_norm.weight"]
    if jcfg.use_vision_position_embedding:
        sd["model.vision_position_embedding.weight"] = np.random.RandomState(2).randn(
            jcfg.max_vision_token_length, jcfg.hidden_size).astype(np.float32)
    # wrapped as a legacy 'module.model.' dict, which both strip
    sd = {"module." + k: v for k, v in sd.items()}
    got = ckpt.convert_libra_state_dict(sd, tconfig.LibraConfig.tiny(**kw), device="cpu")
    n = C.assert_trees_equal(got, C.port_tree(jckpt.convert_libra_state_dict(sd, jcfg)))
    assert n >= 20
    assert all(x.is_contiguous() for x in jax.tree_util.tree_leaves(got))
    if variant == "bf16_params":
        assert got["lm_head"].dtype == torch.bfloat16


@pytest.mark.parametrize("prefixed", [True, False])
def test_convert_clip_state_dict(prefixed):
    _, model = C.hf_clip()
    sd = C.numpy_sd(model.state_dict())
    if not prefixed:
        sd = {k[len("vision_model."):]: v for k, v in sd.items()}
    got = ckpt.convert_clip_state_dict(sd, tconfig.CLIPVisionConfig.tiny(), device="cpu")
    want = jckpt.convert_clip_state_dict(sd, jconfig.CLIPVisionConfig.tiny())
    assert C.assert_trees_equal(got, C.port_tree(want)) == 23
    assert got["patch_embedding"].dtype == torch.float32


def _vq_case(case):
    """(JAX config, port config, state dict, clip_params kw pair) of a
    VQGAN conversion case."""
    jvq = C.yaml_vq_config()
    if case == "conv_encoder":
        jvq = dataclasses.replace(jvq, encoder_name="conv")
    tree = C.vq_tree(jvq, encoder=case == "conv_encoder")
    sd = C.numpy_sd(C.vq_tree_to_state_dict(tree, jvq))
    clip_sd = {f"encoder.vision_tower.{k}": v
               for k, v in C.numpy_sd(C.hf_clip()[1].state_dict()).items()}
    tvq = tconfig.VQGANConfig.from_yaml_dict(yaml.safe_load(YAML))
    tvq = dataclasses.replace(tvq, clip=tconfig.CLIPVisionConfig.tiny(),
                              encoder_name=jvq.encoder_name)
    clip = None
    if case == "tower":
        sd.update(clip_sd)
    elif case == "clip_params":
        clip = {k[len("encoder.vision_tower."):]: v for k, v in clip_sd.items()}
    return jvq, tvq, sd, clip


@pytest.mark.parametrize("case", ["decoder", "tower", "clip_params", "conv_encoder"])
def test_convert_vqgan_state_dict(case):
    jvq, tvq, sd, clip = _vq_case(case)
    jclip = tclip = None
    if clip is not None:
        jclip = jckpt.convert_clip_state_dict(clip, jvq.clip)
        tclip = ckpt.convert_clip_state_dict(clip, tvq.clip, device="cpu")
    want = jckpt.convert_vqgan_state_dict(sd, jvq, clip_params=jclip)
    got = ckpt.convert_vqgan_state_dict(sd, tvq, clip_params=tclip, device="cpu")
    C.assert_trees_equal(got, C.port_tree(want))
    assert ("clip" in got) == (case in ("tower", "clip_params"))
    assert ("encoder" in got) == (case == "conv_encoder")
    assert "loss" not in str(list(got))
    # the plans the converter walks are libra_tpu's
    assert tvqgan.decoder_plan(tvq) == jvqgan.decoder_plan(jvq)
    assert tvqgan.encoder_plan(tvq) == jvqgan.encoder_plan(jvq)


@pytest.mark.parametrize("with_yaml", [True, False])
def test_load_vision_tokenizer_config(tmp_path, with_yaml):
    if with_yaml:
        (tmp_path / "vision_tokenizer_config.yaml").write_text(YAML)
    got = tconfig.load_vision_tokenizer_config(str(tmp_path))
    want = jconfig.load_vision_tokenizer_config(str(tmp_path))
    assert dataclasses.asdict(got.vq_cfg) == dataclasses.asdict(want.vq_cfg)
    assert got[1:] == tuple(want[1:])
    assert (got.clip_dir is not None) == with_yaml


def test_config_loaders(tmp_path):
    jcfg = jconfig.LibraConfig.tiny(**E2E)
    (tmp_path / "config.json").write_text(json.dumps(
        dict(jcfg.to_dict(), unknown_key=1)))
    assert tconfig.LibraConfig.from_pretrained(str(tmp_path)).to_dict() == \
        jconfig.LibraConfig.from_pretrained(str(tmp_path)).to_dict()
    d = dict(C.hf_clip()[0].to_dict(), image_mean=[0.5, 0.5, 0.5])
    assert dataclasses.asdict(tconfig.CLIPVisionConfig.from_dict(d)) == \
        dataclasses.asdict(jconfig.CLIPVisionConfig.from_dict(d))


def test_image_tokenizer_downsample():
    for name in ("vqgan.ckpt", "tok_f16_x.ckpt", "tok_f8_y.ckpt"):
        assert ImageTokenizer.infer_downsample_ratio(name) == \
            JImageTokenizer.infer_downsample_ratio(name)
    with pytest.raises(ValueError):
        ImageTokenizer.infer_downsample_ratio("a_f16_f8_.ckpt")
    vq = tconfig.VQGANConfig.tiny()
    assert ImageTokenizer(vq, {}, 256, 6).get_token_length(np.zeros((1, 32, 32, 3))) == 6
    tok = ImageTokenizer(vq, {}, 256, 6, downsample_ratio=8)
    assert tok.get_token_length([np.zeros((32, 32, 3))]) == 18
    with pytest.raises(ValueError):
        tok.get_token_length(np.zeros((1, 32, 16, 3)))


# ---------------------------------------------------------------------------
# from_pretrained end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("libra_ckpt")
    C.write_checkpoint(d, jconfig.LibraConfig.tiny(**E2E))
    return d


@functools.lru_cache(maxsize=None)
def _jax_pipe(path: str, bits: int):
    pipe = JPipeline.from_pretrained(path, quantize={0: False, 8: "int8", 4: "int4"}[bits])
    # libra_tpu's default processor is at the default 336 px CLIP; the
    # port's defaults to the loaded CLIP config
    pipe.image_processor = JImageProcessor(pipe.tokenizer.image_tokenizer.cfg.clip)
    return pipe


QUANTIZE = {"plain": (False, 0), "true": (True, 8), "int8": ("int8", 8), "int4": ("int4", 4)}


@pytest.mark.parametrize("quantize", list(QUANTIZE))
def test_from_pretrained_trees(ckpt_dir, quantize):
    q, bits = QUANTIZE[quantize]
    pipe = LibraPipeline.from_pretrained(str(ckpt_dir), quantize=q, device="cpu")
    want = _jax_pipe(str(ckpt_dir), bits)
    assert pipe.cfg.to_dict() == want.cfg.to_dict()
    n = C.assert_trees_equal(pipe.params, C.port_tree(want.params))
    assert n >= 20
    img, jimg = pipe.tokenizer.image_tokenizer, want.tokenizer.image_tokenizer
    C.assert_trees_equal(img.params, C.port_tree(jimg.params))
    assert dataclasses.asdict(img.cfg) == dataclasses.asdict(jimg.cfg)
    assert (img.boi_token_id, img.eoi_token_id, img.max_vision_token_length,
            img.downsample_ratio) == (jimg.boi_token_id, jimg.eoi_token_id,
                                      jimg.max_vision_token_length, jimg.downsample_ratio)
    assert pipe.image_processor.cfg == tconfig.CLIPVisionConfig.from_dict(
        dataclasses.asdict(jimg.cfg.clip))
    if bits == 8:
        assert type(pipe.params["layers"]["attn"]["q_proj"]).__name__ == "QuantizedArray"
    if bits == 4:
        assert type(pipe.params["layers"]["attn"]["q_proj"]).__name__ == "Quantized4Array"


def test_text_tokenizer_ids(ckpt_dir):
    tok = HFTextTokenizer(str(ckpt_dir))
    jtok = _jax_pipe(str(ckpt_dir), 0).tokenizer.text_tokenizer
    texts = ["what is a cat", "the dog <img_ph> <img_ph> is <img_gen>"]
    got, want = tok([texts[0]]), jtok([texts[0]])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for t in texts:
        np.testing.assert_array_equal(tok([t])["input_ids"], jtok([t])["input_ids"])
    assert (tok.img_ph_token_id, tok.img_gen_token_id, tok.pad_token_id) == \
        (jtok.img_ph_token_id, jtok.img_gen_token_id, jtok.pad_token_id)
    assert tok.decode([4, 5, 6]) == jtok.decode([4, 5, 6])


@pytest.mark.parametrize("quantize", ["plain", "int8", "int4"])
def test_from_pretrained_chat(ckpt_dir, quantize):
    from PIL import Image
    q, bits = QUANTIZE[quantize]
    pipe = LibraPipeline.from_pretrained(str(ckpt_dir), quantize=q, device="cpu")
    want = _jax_pipe(str(ckpt_dir), bits)
    qs = ["what is the cat"]
    assert pipe.chat(qs, max_new_tokens=4) == want.chat(qs, max_new_tokens=4)
    img = Image.fromarray(np.random.RandomState(0).randint(0, 255, (40, 30, 3), np.uint8))
    assert pipe.chat(qs, images=[img], max_new_tokens=4) == \
        want.chat(qs, images=[img], max_new_tokens=4)


def test_from_pretrained_refuses_mesh(ckpt_dir):
    with pytest.raises(NotImplementedError):
        LibraPipeline.from_pretrained(str(ckpt_dir), mesh=object(), device="cpu")
