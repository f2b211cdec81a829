"""The port's training entry point on the CPU: RunConfig against
libra_tpu's (overrides, merges, validation errors), the pretrained branch
of build_model_and_tokenizer against libra_tpu's on a synthetic
checkpoint (every leaf equal), the mesh and debug-model branches of
train.run, and two fresh interpreters: one without PyYAML and PIL (the
card's situation) importing every port module and building a RunConfig
from a dict, one running `python -m libra_tpu_torch.train --device cpu`
on tests/test_train_cli.py's tiny config with the mesh at 1 (TensorBoard,
an optional logger whose import costs seconds, kept out of it).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import libra_tpu.data.builders  # noqa: F401  (registrations)
import libra_tpu.train_wrapper  # noqa: F401
import libra_tpu_torch.data.builders  # noqa: F401
import libra_tpu_torch.train_wrapper  # noqa: F401
from libra_tpu import config as jconfig, run_config as jrc
from libra_tpu.train import build_model_and_tokenizer as jbuild
from libra_tpu_torch import run_config as trc, train as ttrain

from tests import torch_port_ckpt as C
from tests.test_data_layer import _make_shard
from tests.test_torch_port_imports import ROOT, SOURCES

CKPT = dict(hidden_size=256, num_attention_heads=2, intermediate_size=256)


def _cli_cfg(tmp_path, steps=3, mesh=None):
    """tests/test_train_cli.py's config, its mesh at 1 unless given."""
    shards = tmp_path / "shards"
    shards.mkdir(exist_ok=True)
    _make_shard(shards / "s-000.tar", n=8, seed=0)
    return {
        "model": {
            "arch": "libra_train_wrapper",
            "config": {
                "vocab_size": 256, "hidden_size": 64,
                "intermediate_size": 128, "num_hidden_layers": 2,
                "num_attention_heads": 4, "vision_vocab_size": 18,
                "vision_codebook_num": 2, "max_vision_token_length": 6,
                "image_feature_resolution": 2, "contiguous_signal_size": 32,
                "bridge_rank": 4, "dtype": "float32",
            },
            "model_kwargs": {"frozen_language": True},
        },
        "datasets": {
            "laion": {
                "vis_processor": {"train": {"name": "libra_image",
                                            "image_size": 28}},
                "text_processor": {"train": {"name": "libra_caption"}},
                "build_info": {"storage": str(shards / "s-*.tar")},
                "kwargs": {"i2t_prob": 0.5, "num_img_tokens": 6},
            },
        },
        "run": {
            "output_dir": str(tmp_path / "out"),
            "max_steps": steps,
            "learning_rate": 1e-3,
            "per_device_train_batch_size": 2,
            "logging_steps": 1,
            "save_steps": 0,
            "model_max_length": 64,
            "mesh": mesh or {"data": 1, "fsdp": 1, "model": 1},
        },
    }


def _outcome(fn):
    """(result, None) or (None, (exception type, message))."""
    try:
        return fn(), None
    except Exception as e:  # noqa: BLE001 -- compared between the packages
        return None, (type(e), str(e))


OPTIONS = [None, ["run.max_steps=7", "run.mesh.fsdp=1", "model.config.dtype=bfloat16",
                  "run.lr_list=[1, 2.5]", "run.flag=true", "run.none=null",
                  "datasets.laion.kwargs.i2t_prob=0.25", "new.section.key=word"],
           ["run.bad"], ["model.arch=no_such_arch"], ["model.pretrained=/no/such/dir"],
           ["datasets.unknown_builder.x=1"]]


@pytest.mark.parametrize("options", OPTIONS, ids=range(len(OPTIONS)))
def test_run_config_matches(tmp_path, options):
    cfg = _cli_cfg(tmp_path)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    got, err = _outcome(lambda: trc.RunConfig(str(path), options))
    want, jerr = _outcome(lambda: jrc.RunConfig(str(path), options))
    assert err == jerr
    if want is not None:
        for k in ("config", "model_cfg", "datasets_cfg", "run_cfg"):
            assert getattr(got, k) == getattr(want, k)
        assert got.pretty() == want.pretty()
        # a dict needs no file: the same config
        assert trc.RunConfig.from_dict(cfg, options).config == want.config
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    over = {"a": {"c": {"d": 5, "f": 6}}, "e": {"g": 1}}
    assert trc.deep_merge(base, over) == jrc.deep_merge(base, over)


def _checkpoint(d: Path) -> None:
    """tests/torch_port_ckpt.write_checkpoint's dir without the nested CLIP
    dir (its transformers model takes seconds to build; the
    checkpoint tests cover that branch of the same loaders): config.json,
    the decoder's two shards, the fast tokenizer, the YAML without an
    encoder path, and vqgan.ckpt from the port's VQGAN init."""
    from libra_tpu.config import VQGANConfig as JVQGANConfig
    from libra_tpu_torch.config import CLIPVisionConfig, VQGANConfig
    from libra_tpu_torch.models import vqgan
    from tests.test_synthetic_checkpoint import YAML, _write_shards
    from tests.torch_oracle import make_reference_state_dict

    jcfg = jconfig.LibraConfig.tiny(**CKPT)
    d.mkdir()
    (d / "config.json").write_text(json.dumps(jcfg.to_dict()))
    _write_shards(d, make_reference_state_dict(jcfg, seed=0), "bin")
    C.tokenizer_files(d, jcfg.vocab_size)
    text = "\n".join(x for x in YAML.splitlines() if "encoder_name" not in x)
    (d / "vision_tokenizer_config.yaml").write_text(text)
    spec = yaml.safe_load(text)
    vq = dataclasses.replace(VQGANConfig.from_yaml_dict(spec), clip=CLIPVisionConfig.tiny())
    tree = vqgan.init_params(torch.Generator().manual_seed(3), vq, "cpu")
    sd = C.vq_tree_to_state_dict(tree, JVQGANConfig.from_yaml_dict(spec))
    torch.save({"state_dict": sd}, str(d / "vqgan.ckpt"))


def test_build_model_and_tokenizer_pretrained(tmp_path):
    d = tmp_path / "ckpt"
    _checkpoint(d)
    cfg, params, tok = ttrain.build_model_and_tokenizer(
        {"pretrained": str(d)}, device="cpu")
    jcfg, jparams, jtok = jbuild({"pretrained": str(d)})
    assert cfg.to_dict() == jcfg.to_dict()
    assert C.assert_trees_equal(params, C.port_tree(jparams)) >= 20
    img, jimg = tok.image_tokenizer, jtok.image_tokenizer
    C.assert_trees_equal(img.params, C.port_tree(jimg.params))
    assert dataclasses.asdict(img.cfg) == dataclasses.asdict(jimg.cfg)
    assert (img.boi_token_id, img.max_vision_token_length, img.downsample_ratio) == \
        (jimg.boi_token_id, jimg.max_vision_token_length, jimg.downsample_ratio)
    text = "a cat <img_ph> <img_ph> on the mat"
    np.testing.assert_array_equal(tok.text_tokenizer([text])["input_ids"],
                                  jtok.text_tokenizer([text])["input_ids"])
    assert tok.text_tokenizer.encode_with_spans(text).char_to_token(7) == \
        jtok.text_tokenizer.encode_with_spans(text).char_to_token(7)


def test_run_refuses_a_mesh(tmp_path):
    cfg = trc.RunConfig.from_dict(_cli_cfg(tmp_path, mesh={"data": 1, "fsdp": 2}))
    with pytest.raises(NotImplementedError, match="A13"):
        ttrain.run(cfg, device="cpu")


def test_debug_model_run(tmp_path, capsys):
    cfg = _cli_cfg(tmp_path, steps=2, mesh={"fsdp": 4})   # the debug model has no mesh
    cfg["model"] = {"arch": "debug_model"}
    assert ttrain.run(trc.RunConfig.from_dict(cfg), device="cpu") == {}
    lines = [eval(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(r["batch"] == 2 and np.isfinite(r["debug_loss"]) for r in lines)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_imports_without_yaml_and_pil(tmp_path):
    """The card has neither PyYAML nor PIL: every port module imports,
    and a RunConfig comes from a dict."""
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for p in SOURCES if p.parent.name != "csrc" and p.name != "chip_smoke.py"]
    cfg = _cli_cfg(tmp_path)
    code = ("import importlib, sys\n"
            "sys.modules['yaml'] = None\n"
            "sys.modules['PIL'] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "from libra_tpu_torch.run_config import RunConfig\n"
            f"cfg = RunConfig.from_dict({cfg!r})\n"
            "assert cfg.run_cfg['max_steps'] == 3\n"
            "try:\n"
            "    RunConfig.from_dict({}, ['run.x=1'])\n"
            "except ImportError:\n"
            "    print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_train_cli_smoke(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(_cli_cfg(tmp_path)))
    argv = ["libra_tpu_torch.train", "--cfg-path", str(path), "--device", "cpu",
            "--options", "run.max_steps=2"]
    code = ("import runpy, sys\n"
            "sys.modules['torch.utils.tensorboard'] = None\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('libra_tpu_torch.train', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    last = eval(out.stdout.strip().splitlines()[-1])
    assert last["step"] == 2 and np.isfinite(last["loss"])
    metrics = (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()
    assert len(metrics) == 2
    assert Path(tmp_path / "out").is_dir()
