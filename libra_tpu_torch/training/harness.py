"""Training harness: the reference's HF-Trainer loop on one device.

The PyTorch counterpart of ``libra_tpu/training/harness.py``: the run
section of libra_pretrain.yaml / libra_instruction.yaml (max_steps,
gradient accumulation through ``Trainer.step_accum``, eval every
eval_steps (loss only), checkpoint save, resume and pruning, rank-0
logging to metrics.jsonl and, where the tensorboard package is
installed, TensorBoard, per-step timing, and a torch.profiler trace
between two steps (a Chrome trace under output_dir/trace).

The loop reads the loss and the gradient norm on the host only on
logging steps: the steps between run without a host read of their own.
A resumed run restores the latest step_* checkpoint and skips the
batches its steps consumed, so that it continues the uninterrupted run's
stream (libra_tpu's restarts the stream).
"""

from __future__ import annotations

import json
import logging
import queue
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from libra_tpu_torch import checkpoint as ckpt
from libra_tpu_torch.training.trainer import Trainer

logger = logging.getLogger("libra_tpu_torch.train")


@dataclass
class HarnessConfig:
    output_dir: str = "output"
    max_steps: int = 1000
    per_device_train_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    logging_steps: int = 10
    eval_steps: int = 0            # 0 = no eval
    save_steps: int = 1000
    save_total_limit: int = 1
    resume_from_checkpoint: bool = False
    profile_steps: tuple = ()      # e.g. (10, 20): trace between these steps
    seed: int = 42

    @classmethod
    def from_run_cfg(cls, run: Dict[str, Any]) -> "HarnessConfig":
        known = {f: run[f] for f in (
            "output_dir", "max_steps", "per_device_train_batch_size",
            "gradient_accumulation_steps", "logging_steps", "eval_steps",
            "save_steps", "save_total_limit", "seed",
            "resume_from_checkpoint") if f in run}
        return cls(**known)


class Prefetcher:
    """Background-thread sample prefetch (the reference's DataLoader
    workers): the host prepares the next samples while the device runs
    the current step."""

    def __init__(self, it: Iterable, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _run(self, it: Iterator):
        try:
            for x in it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            x = self._q.get()
            if x is self._done:
                return
            yield x


def batched(sample_iter: Iterable, batch_size: int,
            collater: Callable) -> Iterator:
    buf = []
    for s in sample_iter:
        if s is None:
            continue
        buf.append(s)
        if len(buf) == batch_size:
            yield collater(buf)
            buf = []


def map_style_epochs(dataset, batch_size: int, seed: int) -> Iterator:
    """Shuffled epoch iterator over a map-style dataset, repeated forever
    (numpy's RandomState(seed) permutations, libra_tpu's order)."""
    rng = np.random.RandomState(seed)
    while True:
        for i in rng.permutation(len(dataset)):
            yield dataset[int(i)]


def _rank() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _steps(d: Path):
    """The step_* checkpoint dirs under d, by step."""
    return sorted(d.glob("step_*"), key=lambda p: int(p.name.split("_")[1]))


class TrainHarness:
    def __init__(self, trainer: Trainer, wrapper, harness_cfg: HarnessConfig,
                 train_data, eval_data=None, max_length: Optional[int] = None):
        self.trainer = trainer
        self.wrapper = wrapper
        self.cfg = harness_cfg
        self.train_data = train_data
        self.eval_data = eval_data
        self.max_length = max_length
        self.out = Path(harness_cfg.output_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self._metrics_file = open(self.out / "metrics.jsonl", "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:      # the tensorboard package is optional
            pass
        else:
            self._tb = SummaryWriter(log_dir=str(self.out / "tb"))

    def close(self) -> None:
        self._metrics_file.close()
        if self._tb is not None:
            self._tb.close()

    def _log(self, record: Dict[str, Any]):
        if _rank() == 0:
            logger.info("%s", record)
            self._metrics_file.write(json.dumps(record) + "\n")
            self._metrics_file.flush()
            if self._tb is not None and "step" in record:
                for k, v in record.items():
                    if k != "step" and isinstance(v, (int, float)):
                        self._tb.add_scalar(k, v, record["step"])

    def _batch_iter(self) -> Iterator:
        bs = self.cfg.per_device_train_batch_size
        ds = self.train_data
        if getattr(ds, "is_streaming", False):
            samples = Prefetcher(ds)
        else:
            samples = Prefetcher(map_style_epochs(ds, bs, self.cfg.seed))
        return batched(samples, bs, ds.collater)

    def train(self) -> Dict[str, Any]:
        step0 = 0
        if self.cfg.resume_from_checkpoint:
            latest = _steps(self.out)
            if latest:
                self.trainer.state = ckpt.restore_checkpoint(
                    str(self.out), self.trainer.state,
                    step=int(latest[-1].name.split("_")[1]))
                step0 = int(self.trainer.state.step)
                self._log({"event": "resume", "step": step0})

        batches = self._batch_iter()
        # a resumed run skips the batches the saved steps consumed, so that
        # it trains on what the uninterrupted run would (libra_tpu's replays
        # its stream from the start); the skipped ones are collated, never
        # prepared
        for _ in range(step0 * self.cfg.gradient_accumulation_steps):
            next(batches)
        t_last = time.perf_counter()
        last_metrics: Dict[str, Any] = {}
        prof = None
        for step in range(step0, self.cfg.max_steps):
            if self.cfg.profile_steps and step == self.cfg.profile_steps[0]:
                prof = torch.profiler.profile(activities=_activities())
                prof.start()
            micros = [self.wrapper.prepare_batch(next(batches), self.max_length)
                      for _ in range(self.cfg.gradient_accumulation_steps)]
            metrics = self.trainer.step_accum(micros)

            if prof is not None and step == self.cfg.profile_steps[-1]:
                prof.stop()
                trace = self.out / "trace"
                trace.mkdir(exist_ok=True)
                prof.export_chrome_trace(str(trace / f"steps_{step0}_{step}.json"))
                prof = None

            if (step + 1) % self.cfg.logging_steps == 0:
                now = time.perf_counter()
                last_metrics = {
                    "step": step + 1,
                    "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"]),
                    "steps_per_sec": self.cfg.logging_steps / (now - t_last),
                }
                self._log(last_metrics)
                t_last = now

            if self.cfg.eval_steps and (step + 1) % self.cfg.eval_steps == 0 \
                    and self.eval_data is not None:
                self._log({"step": step + 1, "eval_loss": self.evaluate()})

            if self.cfg.save_steps and (step + 1) % self.cfg.save_steps == 0:
                ckpt.save_checkpoint(str(self.out), self.trainer.state,
                                     step=step + 1)
                self._prune_checkpoints()
        if prof is not None:
            prof.stop()
        return last_metrics

    def evaluate(self, max_batches: int = 16) -> float:
        bs = self.cfg.per_device_train_batch_size
        losses = []
        it = (self.eval_data[i] for i in range(len(self.eval_data)))
        for batch in batched(it, bs, self.eval_data.collater):
            arrays = self.wrapper.prepare_batch(batch, self.max_length)
            losses.append(float(self.trainer.eval_step(arrays)))
            if len(losses) >= max_batches:
                break
        return sum(losses) / max(1, len(losses))

    def _prune_checkpoints(self):
        for p in _steps(self.out)[:-self.cfg.save_total_limit]:
            shutil.rmtree(p, ignore_errors=True)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts
