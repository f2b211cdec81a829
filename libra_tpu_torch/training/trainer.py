"""Training on one device: loss, masked gradients, AdamW update, gradient
accumulation, train-time dropout, the batch padding helpers and the
``Trainer`` the harness drives.

The PyTorch counterpart of ``libra_tpu/training/trainer.py``. Its
``Trainer`` runs on one device: a mesh over more devices and
ZeRO-Offload are ROADMAP A13. JAX's ``masked_value_and_grad`` closes
frozen leaves over as constants so that their weight-gradient matmuls
are never built; here the trainable leaves alone get ``requires_grad``
for the step, which has the same effect on autograd. A step updates the
parameters in place.

Dropout: where any rate of the config is nonzero, a step's forward takes
the dropout key (dropout_seed, step), and an accumulated micro-batch's
(dropout_seed, step, index), as JAX folds its keys; the key is made of
host integers (state.step is one), so deriving it reads nothing from the
device.

Batches are dicts of tensors on the parameters' device: input_ids
(Q, B, N), attention_mask (B, N), vision_indices (B, N), coninous_signal
(B, N, C) or None, labels (Q, B, N) with -100 where ignored.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.ops.flash_bridge import resolve_attn_impl
from libra_tpu_torch.ops.routed import DropoutKey
from libra_tpu_torch.training.optimizer import (OptState, Optimizer,
                                                OptimizerConfig, global_norm,
                                                leaves_with_paths, make_optimizer,
                                                trainable_mask)


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int


def init_state(params: Any, opt: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def step_key(cfg: LibraConfig, dropout_seed: int, step: int,
             *micro: int) -> Optional[DropoutKey]:
    """The forward's dropout key for a step (and a micro-batch index), or
    None when every rate of the config is 0."""
    return (dropout_seed, step) + micro if M.dropout_enabled(cfg) else None


def _logits_loss(params: Any, cfg: LibraConfig, hidden: torch.Tensor,
                 vision_indices: torch.Tensor, labels: torch.Tensor,
                 terms: bool = False):
    flag = vision_indices < cfg.max_vision_token_length
    tl = M.compute_text_logits(params, hidden)
    if cfg.vision_prediction_mode == "2d":
        vl = M.compute_vision_logits_2d(params, cfg, hidden, vision_indices)
    else:
        vl = M.compute_vision_logits(params, hidden)
    fn = M.multicodebook_loss_terms if terms else M.multicodebook_loss
    return fn(cfg, tl, vl, flag, labels, unified=cfg.unified_head)


def _forward(params, cfg: LibraConfig, batch: Dict[str, Any], remat,
             dropout_key: Optional[DropoutKey]):
    """The decoder forward of a batch: the flash kernels on CUDA tensors,
    the plain attention on the CPU (libra_tpu's loss takes its plain
    attention everywhere)."""
    ids = batch["input_ids"]
    return M.forward(params, cfg, ids, batch["attention_mask"],
                     batch["vision_indices"], batch.get("coninous_signal"),
                     remat=remat, dropout_key=dropout_key,
                     attn_impl=resolve_attn_impl("auto", ids.device))


def loss_fn(params: Any, cfg: LibraConfig, batch: Dict[str, Any],
            remat=True, dropout_key: Optional[DropoutKey] = None) -> torch.Tensor:
    """Per-codebook shifted CE averaged over the codebooks."""
    out = _forward(params, cfg, batch, remat, dropout_key)
    return _logits_loss(params, cfg, out.hidden_states,
                        batch["vision_indices"], batch["labels"])


def masked_value_and_grad(loss_of_params: Callable[[Any], torch.Tensor],
                          params: Any, grad_mask: Any = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {path: gradient}) over the leaves grad_mask marks True (every
    leaf when it is None). Only those leaves require grad during the call,
    so autograd builds no weight-gradient matmul for a frozen leaf and
    allocates no gradient for it."""
    leaves = list(leaves_with_paths(params))
    mask = (dict(leaves_with_paths(grad_mask)) if grad_mask is not None
            else {p: True for p, _ in leaves})
    trainable = [(p, t) for p, t in leaves if mask[p]]
    for _, t in trainable:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_of_params(params)
            # a leaf the loss does not read gets a zero gradient, as in JAX
            grads = torch.autograd.grad(loss, [t for _, t in trainable],
                                        allow_unused=True, materialize_grads=True)
    finally:
        for _, t in trainable:
            t.requires_grad_(False)
    return loss.detach(), {p: g for (p, _), g in zip(trainable, grads)}


def _finish_step(state: TrainState, loss: torch.Tensor,
                 grads: Dict[str, torch.Tensor], *, opt: Optimizer
                 ) -> Tuple[TrainState, Dict[str, Any]]:
    """The optimizer update (in place) and the step's metrics: loss,
    grad_norm over the trainable gradients, and the step's index."""
    metrics = {"loss": loss, "grad_norm": global_norm(list(grads.values())),
               "step": state.step}
    opt_state = opt.step(state.params, grads, state.opt_state)
    return TrainState(state.params, opt_state, state.step + 1), metrics


def train_step(state: TrainState, batch: Dict[str, Any], *,
               cfg: LibraConfig, opt: Optimizer, dropout_seed: int = 0,
               grad_mask: Any = None, remat=True
               ) -> Tuple[TrainState, Dict[str, Any]]:
    key = step_key(cfg, dropout_seed, state.step)
    loss, grads = masked_value_and_grad(
        lambda p: loss_fn(p, cfg, batch, remat=remat, dropout_key=key),
        state.params, grad_mask)
    return _finish_step(state, loss, grads, opt=opt)


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, Any], *,
              cfg: LibraConfig) -> torch.Tensor:
    return loss_fn(state.params, cfg, batch, remat=False)


def _group_loss_fn(params: Any, cfg: LibraConfig, batch: Dict[str, Any],
                   denom: torch.Tensor, remat=True,
                   dropout_key: Optional[DropoutKey] = None) -> torch.Tensor:
    """Micro-batch loss normalised by the accumulation group's
    per-codebook valid-label counts `denom` (Q,): summed over the group's
    micro-batches it is the concatenated batch's loss."""
    out = _forward(params, cfg, batch, remat, dropout_key)
    nll, _ = _logits_loss(params, cfg, out.hidden_states,
                          batch["vision_indices"], batch["labels"], terms=True)
    return (nll / denom).mean()


def accum_train_step(state: TrainState, batch: Dict[str, Any], *,
                     cfg: LibraConfig, opt: Optimizer, dropout_seed: int = 0,
                     grad_mask: Any = None, remat=True
                     ) -> Tuple[TrainState, Dict[str, Any]]:
    """Gradient accumulation: every batch leaf carries a leading micro axis
    (A, ...); one forward and backward per micro-batch, gradients summed,
    losses normalised by the group's valid-label totals, so the result is
    the concatenated batch's step while activation memory stays at one
    micro-batch's."""
    labels = batch["labels"]                      # (A, Q, B, N)
    denom = (labels[..., 1:] != -100).sum(dim=(0, 2, 3)).clamp_min(1).float()
    loss_sum, grad_sum = None, None
    for a in range(labels.shape[0]):
        mb = {k: None if v is None else v[a] for k, v in batch.items()}
        key = step_key(cfg, dropout_seed, state.step, a)
        loss, grads = masked_value_and_grad(
            lambda p: _group_loss_fn(p, cfg, mb, denom, remat=remat,
                                     dropout_key=key),
            state.params, grad_mask)
        if grad_sum is None:
            loss_sum, grad_sum = loss, grads
        else:
            loss_sum = loss_sum + loss
            grad_sum = {p: grad_sum[p] + g for p, g in grads.items()}
    return _finish_step(state, loss_sum, grad_sum, opt=opt)


# Batch arrays keyed by name: codebook-major leaves are (Q, B, N).
_CODEBOOK_MAJOR = ("input_ids", "labels")


def _neutral_pad_vals(cfg: LibraConfig) -> Dict[str, Any]:
    """Loss- and attention-neutral token-pad values: mask 0, labels -100,
    vision_indices = text."""
    return {"input_ids": cfg.pad_token_id, "attention_mask": 0,
            "vision_indices": cfg.max_vision_token_length,
            "labels": -100, "coninous_signal": 0.0}


def stack_micro_batches(micro_batches, cfg: LibraConfig) -> Dict[str, Any]:
    """Right-pad each prepared micro-batch to the group's longest sequence
    and stack them on a new leading micro axis (A, ...): numpy leaves on
    the host, tensor leaves on their device (no host copy)."""
    pad_val = _neutral_pad_vals(cfg)
    N = max(mb["attention_mask"].shape[-1] for mb in micro_batches)

    def pad_one(k, v):
        seq_axis = 2 if k in _CODEBOOK_MAJOR else 1
        extra = N - v.shape[seq_axis]
        if extra == 0:
            return v
        if isinstance(v, torch.Tensor):
            width = [0, 0] * (v.dim() - 1 - seq_axis) + [0, extra]
            return torch.nn.functional.pad(v, width, value=pad_val.get(k, 0))
        width = [(0, 0)] * v.ndim
        width[seq_axis] = (0, extra)
        return np.pad(v, width, constant_values=pad_val.get(k, 0))

    out: Dict[str, Any] = {}
    for k in micro_batches[0]:
        if micro_batches[0][k] is None:
            out[k] = None
            continue
        vs = [v if isinstance(v, torch.Tensor) else np.asarray(v)
              for v in (mb[k] for mb in micro_batches)]
        padded = [pad_one(k, v) for v in vs]
        out[k] = (torch.stack(padded) if isinstance(padded[0], torch.Tensor)
                  else np.stack(padded))
    return out


def pad_batch_tokens(batch: Dict[str, Any], cfg: LibraConfig,
                     multiple: int) -> Dict[str, Any]:
    """Neutral right-pad of the token axis N (numpy) to a multiple.

    Needs right-padded rows (each row's attention_mask non-increasing):
    appended keys are then masked out of every real query row and the
    appended query rows carry -100 labels. A left-padded row's fully masked
    query rows attend uniformly over every key, the appended ones
    included, so padding would move the loss: that raises."""
    N = batch["attention_mask"].shape[-1]
    extra = (-N) % multiple
    if extra == 0:
        return batch
    am = np.asarray(batch["attention_mask"])
    if (np.diff(am.astype(np.int8), axis=-1) > 0).any():
        raise ValueError(
            "pad_batch_tokens needs right-padded rows (attention_mask "
            "non-increasing per row); left-padded rows make seq-axis "
            "padding non-loss-neutral (see docstring)")
    pad_val = _neutral_pad_vals(cfg)
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        v = np.asarray(v)
        seq_axis = v.ndim - 2 if k == "coninous_signal" else v.ndim - 1
        width = [(0, 0)] * v.ndim
        width[seq_axis] = (0, extra)
        out[k] = np.pad(v, width, constant_values=pad_val.get(k, 0))
    return out


class Trainer:
    """One device's trainer: the state (parameters, AdamW moments, step),
    the train step with the trainable-only gradient mask, gradient
    accumulation and the eval loss. Batches are dicts of numpy arrays or
    tensors; they go to the parameters' device.

    remat: the layer rematerialisation policy (models.libra.forward:
    True / "full", "dots", "big_dots", "names:..."). device: where the
    parameters go (their own device when None). mesh and
    offload_opt_state, libra_tpu's GSPMD mesh and ZeRO-Offload, are
    ROADMAP A13: a mesh ({axis: size}, a run config's run.mesh) over more
    than one device, or offloading, raises."""

    def __init__(self, cfg: LibraConfig, params: Any,
                 opt_cfg: Optional[OptimizerConfig] = None, remat=True,
                 device=None, mesh=None, offload_opt_state: bool = False):
        if mesh is not None and math.prod(int(v) for v in mesh.values()) > 1:
            raise NotImplementedError(
                f"Trainer(mesh={mesh!r}): a mesh over more than one device is "
                "ROADMAP A13; the port trains on one device (every mesh axis 1)")
        if offload_opt_state:
            raise NotImplementedError(
                "Trainer(offload_opt_state=True): ZeRO-Offload is ROADMAP A13")
        self.cfg = cfg
        self.remat = remat
        self.opt_cfg = opt_cfg or OptimizerConfig()
        if device is not None:
            params = _to_device(params, torch.device(device))
        self.device = next(t for _, t in leaves_with_paths(params)).device
        self.opt = make_optimizer(self.opt_cfg, params)
        self.state = init_state(params, self.opt)
        gmask = trainable_mask(params, self.opt_cfg)
        self.grad_mask = (None if all(m for _, m in leaves_with_paths(gmask))
                          else gmask)

    def to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's leaves as tensors on the parameters' device."""
        return {k: None if v is None else torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One optimizer step; metrics' loss and grad_norm stay on the
        device."""
        self.state, metrics = train_step(
            self.state, self.to_device(batch), cfg=self.cfg, opt=self.opt,
            grad_mask=self.grad_mask, remat=self.remat)
        return metrics

    def step_accum(self, micro_batches) -> Dict[str, Any]:
        """One optimizer step accumulating over a list of prepared
        micro-batches (activation memory of one micro-batch)."""
        if len(micro_batches) == 1:
            return self.step(micro_batches[0])
        stacked = stack_micro_batches(
            [self.to_device(mb) for mb in micro_batches], self.cfg)
        self.state, metrics = accum_train_step(
            self.state, stacked, cfg=self.cfg, opt=self.opt,
            grad_mask=self.grad_mask, remat=self.remat)
        return metrics

    def eval_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The batch's loss under the current parameters (no dropout, no
        remat), on the device."""
        return eval_step(self.state, self.to_device(batch), cfg=self.cfg)

    def evaluate(self, batches) -> float:
        losses = [float(self.eval_step(b)) for b in batches]
        return sum(losses) / max(len(losses), 1)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
