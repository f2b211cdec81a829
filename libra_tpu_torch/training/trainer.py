"""Training steps on one device: loss, masked gradients, AdamW update,
gradient accumulation and the host-side batch padding helpers.

The PyTorch counterpart of ``libra_tpu/training/trainer.py`` without its
mesh-aware ``Trainer`` (GSPMD shardings, ZeRO-Offload; ROADMAP A13).
JAX's ``masked_value_and_grad`` closes frozen leaves over as constants so
that their weight-gradient matmuls are never built; here the trainable
leaves alone get ``requires_grad`` for the step, which has the same
effect on autograd. A step updates the parameters in place.

Batches are dicts of tensors on the parameters' device: input_ids
(Q, B, N), attention_mask (B, N), vision_indices (B, N), coninous_signal
(B, N, C) or None, labels (Q, B, N) with -100 where ignored.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.training.optimizer import (OptState, Optimizer, global_norm,
                                                leaves_with_paths)


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState
    step: int


def init_state(params: Any, opt: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=opt.init(params), step=0)


def require_no_dropout(cfg: LibraConfig) -> None:
    if M.dropout_enabled(cfg):
        raise NotImplementedError("the port has no dropout yet (ROADMAP A11): "
                                  "set every pdrop of the config to 0")


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


def loss_fn(params: Any, cfg: LibraConfig, batch: Dict[str, Any],
            remat=True) -> torch.Tensor:
    """Per-codebook shifted CE averaged over the codebooks, with the plain
    attention (JAX's default for this function)."""
    require_no_dropout(cfg)
    out = M.forward(params, cfg, batch["input_ids"], batch["attention_mask"],
                    batch["vision_indices"], batch.get("coninous_signal"),
                    remat=remat)
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
               cfg: LibraConfig, opt: Optimizer, grad_mask: Any = None,
               remat=True) -> Tuple[TrainState, Dict[str, Any]]:
    loss, grads = masked_value_and_grad(
        lambda p: loss_fn(p, cfg, batch, remat=remat), state.params, grad_mask)
    return _finish_step(state, loss, grads, opt=opt)


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, Any], *,
              cfg: LibraConfig) -> torch.Tensor:
    return loss_fn(state.params, cfg, batch, remat=False)


def _group_loss_fn(params: Any, cfg: LibraConfig, batch: Dict[str, Any],
                   denom: torch.Tensor, remat=True) -> torch.Tensor:
    """Micro-batch loss normalised by the accumulation group's
    per-codebook valid-label counts `denom` (Q,): summed over the group's
    micro-batches it is the concatenated batch's loss."""
    require_no_dropout(cfg)
    out = M.forward(params, cfg, batch["input_ids"], batch["attention_mask"],
                    batch["vision_indices"], batch.get("coninous_signal"),
                    remat=remat)
    nll, _ = _logits_loss(params, cfg, out.hidden_states,
                          batch["vision_indices"], batch["labels"], terms=True)
    return (nll / denom).mean()


def accum_train_step(state: TrainState, batch: Dict[str, Any], *,
                     cfg: LibraConfig, opt: Optimizer, grad_mask: Any = None,
                     remat=True) -> Tuple[TrainState, Dict[str, Any]]:
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
        loss, grads = masked_value_and_grad(
            lambda p: _group_loss_fn(p, cfg, mb, denom, remat=remat),
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
    """Right-pad each prepared micro-batch (numpy) to the group's longest
    sequence and stack them on a new leading micro axis (A, ...)."""
    pad_val = _neutral_pad_vals(cfg)
    N = max(mb["attention_mask"].shape[-1] for mb in micro_batches)

    def pad_one(k, v):
        v = np.asarray(v)
        seq_axis = 2 if k in _CODEBOOK_MAJOR else 1
        extra = N - v.shape[seq_axis]
        if extra == 0:
            return v
        width = [(0, 0)] * v.ndim
        width[seq_axis] = (0, extra)
        return np.pad(v, width, constant_values=pad_val.get(k, 0))

    out: Dict[str, Any] = {}
    for k in micro_batches[0]:
        if micro_batches[0][k] is None:
            out[k] = None
            continue
        out[k] = np.stack([pad_one(k, mb[k]) for mb in micro_batches])
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
