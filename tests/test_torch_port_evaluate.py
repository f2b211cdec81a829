"""The port's evaluation entry point (libra_tpu_torch.evaluate) on the CPU:

* generate_captions and generate_vqa_answers through the port's
  LibraPipeline against libra_tpu.evaluate's through libra_tpu's, on one
  tiny fp32 tree carried across (tests/test_torch_port_slice.py's): equal
  predictions;
* score_vqa and metrics.score_captions on those predictions equal to
  libra_tpu's;
* the three CLI modes on tests/test_evaluate_cli.py's synthetic COCO and
  VQA splits, in-process through main(argv) with --device cpu, held to
  what those tests hold (4 captions; 3 answers scored); in the loss mode
  the port's tree for the config carried to libra_tpu, its eval_loss and
  batch count held to libra_tpu.evaluate.main's on the same split (1e-5).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import yaml
from PIL import Image

import jax

from libra_tpu import evaluate as jeval, metrics as jmetrics, train as jtrain
from libra_tpu.config import LibraConfig as JLibraConfig
from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.data.processors import LibraEvalImageProcessor as JProcessor
from libra_tpu.pipeline import LibraPipeline as JPipeline
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu.tokenization import LibraTokenizer as JLibraTokenizer
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu_torch import evaluate as teval, metrics as tmetrics, train as ttrain
from libra_tpu_torch.config import CLIPVisionConfig, LibraConfig, VQGANConfig
from libra_tpu_torch.data.processors import LibraEvalImageProcessor
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.pipeline import LibraPipeline
from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)

from tests.test_evaluate_cli import _cfg
from tests.test_torch_port_slice import _np_params, _np_vq_params


def _split(tmp_path, n, vqa: bool):
    """tests/test_evaluate_cli.py's synthetic split: n 32x40 JPEGs and
    their annotation rows (with questions and human answers for VQA)."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    anns = []
    for i in range(n):
        name = f"img{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8)).save(
            img_dir / name)
        row = {"image": name, "image_id": i, "caption": f"caption number {i}"}
        if vqa:
            row.update(question_id=i, question=f"what is in image {i}?",
                       answers=["a cat"] * 5 + ["a dog"] * 5)
        anns.append(row)
    (tmp_path / "ann.json").write_text(json.dumps(anns))
    return tmp_path, anns


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, the port's) on one tree, each with a fresh
    SimpleTextTokenizer (two agree only when they see the same texts)."""
    jcfg, np_params = _np_params()
    cfg = LibraConfig.tiny()
    jvq, vq = JVQGANConfig.tiny(), VQGANConfig.tiny()
    np_vq = _np_vq_params(jvq)
    jtok = JLibraTokenizer(JSimpleTok(vocab_size=cfg.vocab_size),
                           JImageTokenizer(jvq, np_vq, token_offset=cfg.vocab_size,
                                           max_vision_token_length=cfg.max_vision_token_length))
    ttok = LibraTokenizer(SimpleTextTokenizer(vocab_size=cfg.vocab_size),
                          ImageTokenizer(vq, from_numpy_tree(np_vq, device="cpu"),
                                         cfg.vocab_size, cfg.max_vision_token_length))
    return (JPipeline(jcfg, np_params, jtok, image_processor=JProcessor(jvq.clip)),
            LibraPipeline(cfg, from_numpy_tree(np_params, device="cpu"), ttok,
                          LibraEvalImageProcessor(CLIPVisionConfig.tiny())))


@pytest.mark.parametrize("mode", ["caption", "vqa"])
def test_predictions_and_scores_match_jax(tmp_path, pipes, mode):
    root, anns = _split(tmp_path, 3, vqa=mode == "vqa")
    ds = SimpleNamespace(vis_root=str(root / "images"), annotation=anns)
    jpipe, tpipe = pipes
    kw = dict(max_samples=3, max_new_tokens=4, batch_size=2)
    if mode == "caption":
        want = jeval.generate_captions(jpipe, ds, **kw)
        got = teval.generate_captions(tpipe, ds, **kw)
        score, jscore = (tmetrics.score_captions(got, anns),
                         jmetrics.score_captions(want, anns))
    else:
        want = jeval.generate_vqa_answers(jpipe, ds, **kw)
        got = teval.generate_vqa_answers(tpipe, ds, **kw)
        score, jscore = teval.score_vqa(got, anns), jeval.score_vqa(want, anns)
    assert got == want and len(got) == 3
    assert score == jscore and score["scored"] == 3


def _carry_port_tree(monkeypatch):
    """The port's build_model_and_tokenizer runs as it is (its seeded
    init) and keeps its trees; libra_tpu's then builds its config as its
    own builder does and takes those trees (LM and VQGAN) carried across as
    numpy, with fresh tokenizers of its own. Call the port's first."""
    built = {}
    tbuild = ttrain.build_model_and_tokenizer

    def port_side(model_cfg, device="cuda"):
        cfg, params, tok = tbuild(model_cfg, device)
        built.update(params=params, vq=tok.image_tokenizer.params)
        return cfg, params, tok

    def jax_side(model_cfg):
        cfg = JLibraConfig.from_dict(model_cfg.get("config", {}) | {
            k: v for k, v in model_cfg.items() if k not in ("arch", "config", "vqgan")})
        np_tree = lambda t: jax.tree_util.tree_map(    # noqa: E731
            lambda x: x.detach().cpu().numpy(), t)
        img = JImageTokenizer(JVQGANConfig.tiny(), np_tree(built["vq"]),
                              token_offset=cfg.vocab_size,
                              max_vision_token_length=cfg.max_vision_token_length)
        tok = JLibraTokenizer(JSimpleTok(vocab_size=cfg.vocab_size), img)
        return cfg, np_tree(built["params"]), tok

    monkeypatch.setattr(ttrain, "build_model_and_tokenizer", port_side)
    monkeypatch.setattr(jtrain, "build_model_and_tokenizer", jax_side)


@pytest.mark.parametrize("mode", ["loss", "caption", "vqa"])
def test_cli_modes(tmp_path, capsys, monkeypatch, mode):
    root, _ = _split(tmp_path, 6 if mode != "vqa" else 4, vqa=mode == "vqa")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg(root)))
    out_path = root / "preds.json"
    n = {"loss": 4, "caption": 4, "vqa": 3}[mode]
    argv = ["--cfg-path", str(cfg_path), "--mode", mode, "--max-samples", str(n),
            "--output", str(out_path)]
    if mode == "loss":
        _carry_port_tree(monkeypatch)
    teval.main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if mode == "loss":
        jeval.main(argv)
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(out["eval_loss"]) and out["batches"] == want["batches"] == 2
        assert out["eval_loss"] == pytest.approx(want["eval_loss"], rel=1e-5)
        return
    preds = json.loads(out_path.read_text())
    assert out["predictions"] == len(preds) == n
    field = "caption" if mode == "caption" else "answer"
    assert all(field in p and isinstance(p[field], str) for p in preds)
    if mode == "vqa":
        assert out["scored"] == 3 and 0.0 <= out["vqa_accuracy"] <= 1.0
    else:
        assert out["scored"] == 4 and out["cider_d"] >= 0.0
