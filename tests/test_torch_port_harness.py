"""The port's Trainer, TrainHarness, checkpoints and EMA, at a tiny size in
fp32 on the CPU.

libra_tpu's TrainHarness (over its Trainer on a one-device mesh) and the
port's run 3 steps of 2 accumulated micro-batches of 2 samples on one
tree and one map-style dataset, without dropout: the same samples in the
same order, the logged losses and gradient norms within rtol 1e-5 and the
final parameters within rtol 1e-4, atol 1e-5 (the train step tests'
tolerances, tests/test_torch_port_train.py), the eval loss within 1e-5.
Then the port alone: 2 steps, a save and a resumed run to 4 equal bit for
bit to 4 straight steps; pruning keeps save_total_limit checkpoints; a
restore against a target of another shape or key set raises. TensorBoard
is kept out of the process (an optional logger; its import costs seconds).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from libra_tpu.config import VQGANConfig as JVQGANConfig
from libra_tpu.data import caption_format as jcf
from libra_tpu.parallel import make_mesh
from libra_tpu.tokenization import ImageTokenizer as JImageTokenizer
from libra_tpu.tokenization import LibraTokenizer as JLibraTokenizer
from libra_tpu.tokenization import SimpleTextTokenizer as JSimpleTok
from libra_tpu.train_wrapper import LibraTrainWrapper as JWrapper
from libra_tpu.training import ema as jema, harness as jharness
from libra_tpu.training import optimizer as jopt
from libra_tpu.training.trainer import Trainer as JTrainer
from libra_tpu_torch import checkpoint as tckpt
from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.data import caption_format as tcf
from libra_tpu_torch.data.pair_samples import pair_collater
from libra_tpu_torch.params import from_numpy_tree
from libra_tpu_torch.tokenization import (ImageTokenizer, LibraTokenizer,
                                          SimpleTextTokenizer)
from libra_tpu_torch.train_wrapper import LibraTrainWrapper
from libra_tpu_torch.training import ema as tema, harness as tharness
from libra_tpu_torch.training import optimizer as topt
from libra_tpu_torch.training.trainer import Trainer

from tests.test_torch_port_slice import _np_params, _np_vq_params
from tests.test_torch_port_train import PARAM_TOL, _assert_trees_close, _flat

OPT = dict(frozen_language=True, total_steps=10, warmup_ratio=0.0,
           learning_rate=1e-3)
WORDS = "a photo of cats dogs red blue small big on the grass".split()


class MapData:
    """A map-style dataset of LAION-format pair samples (i2t for even
    indices, t2i for odd), its spans from the caption module and text
    tokenizer it is given, images already CLIP-normalized arrays. Records
    the order of its reads."""

    def __init__(self, n, cf, tokenizer, Mv, size, offset=0):
        self.n, self.cf, self.tok, self.Mv, self.size = n, cf, tokenizer, Mv, size
        self.offset = offset
        self.reads = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.reads.append(i)
        i += self.offset
        rs = np.random.RandomState(i)
        text = " ".join(WORDS[j] for j in rs.randint(0, len(WORDS), 3 + i % 4))
        ph = " ".join([self.cf.IMG_PH] * self.Mv)
        bg, resp, kind = (ph, text, "background") if i % 2 == 0 else (
            text, ph, "respond")
        caption, ins = self.cf.build_caption(bg, resp, "", kind)
        spans = self.cf.label_mask_spans(self.tok, caption, bg, ins, kind)
        return {"vision": rs.randn(self.size, self.size, 3).astype(np.float32),
                "language": caption, "label_mask_position_map": spans,
                "contiguous_ignore_sign": False}

    def collater(self, samples):
        return pair_collater(samples)


@pytest.fixture(scope="module")
def setup():
    jcfg, p = _np_params()
    jvq = JVQGANConfig.tiny()
    return dict(jcfg=jcfg, p=p, jvq=jvq, np_vq=_np_vq_params(jvq))


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _port_run(setup, out, max_steps, resume=False, save_steps=0, limit=1,
              eval_n=0):
    """A fresh port Trainer + TrainHarness (fresh tokenizer, fresh tree)
    trained to max_steps; returns (harness, train data, eval data)."""
    cfg, Mv = LibraConfig.tiny(), LibraConfig.tiny().max_vision_token_length
    vq = VQGANConfig.tiny()
    text = SimpleTextTokenizer(vocab_size=cfg.vocab_size)
    wrapper = LibraTrainWrapper(cfg, LibraTokenizer(text, ImageTokenizer(
        vq, from_numpy_tree(setup["np_vq"], device="cpu"), cfg.vocab_size, Mv)))
    trainer = Trainer(cfg, from_numpy_tree(setup["p"], device="cpu"),
                      topt.OptimizerConfig(**OPT), remat=True)
    train = MapData(12, tcf, text, Mv, vq.clip.image_size)
    ev = MapData(eval_n, tcf, text, Mv, vq.clip.image_size, offset=100) if eval_n else None
    h = tharness.TrainHarness(trainer, wrapper, tharness.HarnessConfig(
        output_dir=str(out), max_steps=max_steps, per_device_train_batch_size=2,
        gradient_accumulation_steps=2, logging_steps=1, save_steps=save_steps,
        save_total_limit=limit, resume_from_checkpoint=resume, seed=7),
        train, ev)
    h.train()
    return h, train, ev


def _logged(out):
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    return [(r["loss"], r["grad_norm"]) for r in recs if "loss" in r]


def test_harness_matches_libra_tpu(setup, tmp_path):
    jcfg, p, jvq = setup["jcfg"], setup["p"], setup["jvq"]
    Mv = jcfg.max_vision_token_length
    jtext = JSimpleTok(vocab_size=jcfg.vocab_size)
    jw = JWrapper(jcfg, JLibraTokenizer(jtext, JImageTokenizer(
        jvq, setup["np_vq"], token_offset=jcfg.vocab_size,
        max_vision_token_length=Mv)))
    jt = JTrainer(jcfg, p, make_mesh(devices=jax.devices()[:1]),
                  jopt.OptimizerConfig(**OPT), remat=True)
    jtrain = MapData(12, jcf, jtext, Mv, jvq.clip.image_size)
    jev = MapData(3, jcf, jtext, Mv, jvq.clip.image_size, offset=100)
    jh = jharness.TrainHarness(jt, jw, jharness.HarnessConfig(
        output_dir=str(tmp_path / "jax"), max_steps=3, per_device_train_batch_size=2,
        gradient_accumulation_steps=2, logging_steps=1, save_steps=0, seed=7),
        jtrain, jev)
    jh.train()
    want_eval = jh.evaluate()

    h, train, ev = _port_run(setup, tmp_path / "port", 3, eval_n=3)
    used = 3 * 2 * 2
    assert train.reads[:used] == jtrain.reads[:used]
    got, want = _logged(tmp_path / "port"), _logged(tmp_path / "jax")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_trees_close(h.trainer.state.params, jt.state.params, **PARAM_TOL)
    assert h.trainer.state.step == int(jt.state.step) == 3
    np.testing.assert_allclose(h.evaluate(), want_eval, rtol=1e-5)
    assert ev.reads == jev.reads
    h.close()


def test_resume_is_bitwise_and_prunes(setup, tmp_path):
    straight, _, _ = _port_run(setup, tmp_path / "straight", 4)
    first, _, _ = _port_run(setup, tmp_path / "run", 2, save_steps=1, limit=1)
    assert [d.name for d in (tmp_path / "run").glob("step_*")] == ["step_2"]
    resumed, _, _ = _port_run(setup, tmp_path / "run", 4, resume=True,
                              save_steps=1, limit=2)
    assert sorted(d.name for d in (tmp_path / "run").glob("step_*")) == [
        "step_3", "step_4"]
    assert _logged(tmp_path / "run") == _logged(tmp_path / "straight")
    for a, b in ((straight.trainer.state.params, resumed.trainer.state.params),
                 (straight.trainer.state.opt_state.mu, resumed.trainer.state.opt_state.mu),
                 (straight.trainer.state.opt_state.nu, resumed.trainer.state.opt_state.nu)):
        _assert_trees_close(b, a, rtol=0, atol=0)
    assert resumed.trainer.state.step == 4
    assert resumed.trainer.state.opt_state.count == 4
    for h in (straight, first, resumed):
        h.close()

    # a restore against a mismatched target raises
    state = resumed.trainer.state
    params = dict(state.params, lm_head=state.params["lm_head"][:, :-1].clone())
    with pytest.raises(ValueError, match="lm_head"):
        tckpt.restore_checkpoint(str(tmp_path / "run"), state._replace(params=params),
                                 step=4)
    params = {k: v for k, v in state.params.items() if k != "norm"}
    with pytest.raises(ValueError, match="keys"):
        tckpt.restore_checkpoint(str(tmp_path / "run"), state._replace(params=params),
                                 step=4)


def test_trainer_refuses_a_mesh_and_offload(setup):
    params = from_numpy_tree(setup["p"], device="cpu")
    cfg = LibraConfig.tiny()
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(cfg, params, mesh={"data": 1, "fsdp": 2})
    with pytest.raises(NotImplementedError, match="A13"):
        Trainer(cfg, params, offload_opt_state=True)
    assert Trainer(cfg, params, mesh={"data": 1, "fsdp": 1}).grad_mask is None


def test_map_style_epochs_order_matches():
    ds = list(range(5))
    a = tharness.map_style_epochs(ds, 2, 3)
    b = jharness.map_style_epochs(ds, 2, 3)
    assert [next(a) for _ in range(12)] == [next(b) for _ in range(12)]


def test_ema_update_math():
    """tests/test_misc_utils.py::test_ema_update_math on the port, and the
    port's EMA against libra_tpu's over three warm-up updates."""
    params = {"w": torch.ones((4,)), "b": torch.zeros((2,))}
    state = tema.init_ema(params)
    assert state.count == 0
    new = {"w": torch.full((4,), 3.0), "b": torch.ones((2,))}
    state = tema.update_ema(state, new, decay=0.9, warmup=False)
    np.testing.assert_allclose(state.ema["w"].numpy(), 0.9 * 1.0 + 0.1 * 3.0, rtol=1e-6)
    np.testing.assert_allclose(state.ema["b"].numpy(), 0.1, rtol=1e-6)
    assert state.count == 1
    assert params["w"][0].item() == 1.0          # the EMA holds copies
    s2 = tema.update_ema(tema.init_ema(params), new, decay=0.999)
    d = 2.0 / 11.0
    np.testing.assert_allclose(s2.ema["w"].numpy(), d + (1 - d) * 3.0, rtol=1e-5)

    rs = np.random.RandomState(0)
    trees = [{"a": rs.randn(3, 2).astype(np.float32),
              "n": {"b": rs.randn(5).astype(np.float32)}} for _ in range(4)]
    js = jema.init_ema(jax.tree_util.tree_map(jax.numpy.asarray, trees[0]))
    ts = tema.init_ema(from_numpy_tree(trees[0], device="cpu"))
    for t in trees[1:]:
        js = jema.update_ema(js, t, decay=0.99)
        ts = tema.update_ema(ts, from_numpy_tree(t, device="cpu"), decay=0.99)
    assert ts.count == int(js.count) == 3
    assert _flat(ts.ema).keys() == _flat(js.ema).keys()
    for k, v in _flat(js.ema).items():
        np.testing.assert_allclose(_flat(ts.ema)[k], v, rtol=1e-6, err_msg=k)
