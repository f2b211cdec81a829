"""Optimizer: AdamW(0.9, 0.99) + cosine schedule with linear warm-up +
global-norm clipping + selective freezing.

The PyTorch counterpart of ``libra_tpu/training/optimizer.py``, written
as plain tensor code that computes what its optax chain computes, step
for step:

    multi_transform({"vision": chain(1.0), "language": chain(llm_lr_scale),
                     "frozen": set_to_zero()})
    chain(s) = clip_by_global_norm(max_grad_norm) -> scale_by_adam(b1, b2)
               -> add_decayed_weights(wd, ndim >= 2) -> lr = schedule * s

(one chain over every leaf when all are trainable and llm_lr_scale is 1).
What that implies, and torch.optim.AdamW with a LambdaLR would not do:

* each label group is clipped by the norm of its own gradients;
* the schedule is read at the count before the increment, so with
  warm-up (init value 0) the first update is exactly zero;
* eps is added outside the square root, bias correction uses the
  incremented count, decay is added after Adam and before the learning
  rate;
* the moments live in each leaf's dtype, as optax keeps them.

Frozen leaves are never touched and get no moments. Parameters and
moments are updated in place (JAX returns new arrays).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-4
    warmup_ratio: float = 0.05
    total_steps: int = 40_000
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.99
    max_grad_norm: float = 1.0
    min_lr_ratio: float = 0.0
    # language-side LR scaling (reference: lr_scale param groups)
    llm_lr_scale: float = 1.0
    # freeze policies (reference: LibraTrainWrapper)
    frozen_language: bool = False
    freeze_vision_value: bool = False
    freeze_text_embedding: bool = False
    freeze_vision_embedding: bool = False


ADAM_EPS = 1e-8    # optax.scale_by_adam's default
_VISION_EXTRA = {"signal_proj", "signal_norm", "vision_position_embedding"}


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of nested dicts and lists, paths joined by "/" as
    JAX's tree paths are in libra_tpu.training.optimizer (a list's items
    by index); None is an empty subtree, as in JAX."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif tree is not None:
        yield prefix, tree


def _map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def _is_vision(path: str) -> bool:
    """Vision-side leaves: bridges and the signal fusion included."""
    return ("vision" in path or "bridge" in path
            or bool(set(path.split("/")) & _VISION_EXTRA))


def trainable_mask(params: Any, cfg: OptimizerConfig) -> Any:
    """True = trainable; the reference's substring rules over the tree's
    names."""
    def visit(path, leaf):
        parts = set(path.split("/"))
        if cfg.frozen_language and not _is_vision(path):
            return False
        if cfg.freeze_vision_value and "vision_v" in path and "bridge" not in path:
            return False
        if cfg.freeze_text_embedding and "embed_tokens" in parts:
            return False
        if cfg.freeze_vision_embedding and "vision_embed_tokens" in parts:
            return False
        return True
    return _map_with_path(visit, params)


def decay_mask(params: Any) -> Any:
    """Weight decay on matrices only, not on norm scales or 1-D leaves."""
    return _map_with_path(lambda path, p: p.dim() >= 2, params)


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, lr *
    min_lr_ratio) in its float32 arithmetic: the value at update count n."""
    f32 = np.float32
    warmup = max(1, int(cfg.total_steps * cfg.warmup_ratio))
    peak, end = cfg.learning_rate, cfg.learning_rate * cfg.min_lr_ratio
    decay_steps = cfg.total_steps - warmup
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup steps "
                         f"({cfg.total_steps} <= {warmup})")
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:           # linear from 0 to peak
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float((f32(0.0) - f32(peak)) * frac + f32(peak))
        t = f32(min(count - warmup, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay_steps)))
        return float(f32(peak) * ((f32(1) - f32(alpha)) * cosine + f32(alpha)))
    return schedule


class OptState(NamedTuple):
    count: int                       # updates applied so far
    mu: Dict[str, torch.Tensor]      # first moments of the trainable leaves
    nu: Dict[str, torch.Tensor]      # second moments


def _as(x: float, dtype: torch.dtype) -> float:
    """A host scalar rounded to `dtype`, as JAX casts a step size to the
    update's dtype before the multiply."""
    return torch.tensor(x, dtype=dtype).item()


class Optimizer:
    """The optax chain above over a parameter tree's trainable leaves.

    `init(params)` makes the state; `step(params, grads, state)` applies
    one update in place to the parameters (and the moments) and returns
    the next state. `grads` maps each trainable leaf's path to its
    gradient (frozen leaves have none)."""

    def __init__(self, cfg: OptimizerConfig, params: Any):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        train = dict(leaves_with_paths(trainable_mask(params, cfg)))
        decay = dict(leaves_with_paths(decay_mask(params)))
        self.decay = {p for p, d in decay.items() if d}
        if cfg.llm_lr_scale == 1.0 and all(train.values()):
            self.groups: List[Tuple[float, List[str]]] = [(1.0, list(train))]
        else:
            vision = [p for p, t in train.items() if t and _is_vision(p)]
            language = [p for p, t in train.items() if t and not _is_vision(p)]
            self.groups = [(s, g) for s, g in ((1.0, vision),
                                              (cfg.llm_lr_scale, language)) if g]
        self.trainable = [p for _, g in self.groups for p in g]

    def init(self, params: Any) -> OptState:
        leaves = dict(leaves_with_paths(params))
        zeros = lambda: {p: torch.zeros_like(leaves[p]) for p in self.trainable}  # noqa: E731
        return OptState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def step(self, params: Any, grads: Dict[str, torch.Tensor],
             state: OptState) -> OptState:
        cfg = self.cfg
        f32 = np.float32
        leaves = dict(leaves_with_paths(params))
        n = state.count + 1                       # scale_by_adam's count_inc
        c = bias_corrections(cfg.beta1, cfg.beta2, n)
        for lr_scale, paths in self.groups:
            step_size = -float(f32(self.schedule(state.count)) * f32(lr_scale))
            norm = global_norm([grads[p] for p in paths])
            keep = norm < cfg.max_grad_norm
            for p in paths:
                g = grads[p]
                g = torch.where(keep, g, g / norm.to(g.dtype) * cfg.max_grad_norm)
                adam_leaf_update(leaves[p], g, state.mu[p], state.nu[p], cfg.beta1,
                                 cfg.beta2, c, step_size,
                                 cfg.weight_decay if p in self.decay else None)
        return OptState(count=n, mu=state.mu, nu=state.nu)


def bias_corrections(beta1: float, beta2: float, n: int) -> Tuple[float, float]:
    """scale_by_adam's 1 - beta ** n for both moments at update count n,
    in float32."""
    f32 = np.float32
    return (float(f32(1) - f32(beta1) ** f32(n)),
            float(f32(1) - f32(beta2) ** f32(n)))


def adam_leaf_update(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     beta1: float, beta2: float, corrections: Tuple[float, float],
                     step_size: float, weight_decay: Optional[float]) -> None:
    """One leaf of scale_by_adam -> add_decayed_weights (when weight_decay
    is not None) -> scale(step_size), in optax's order; w, mu and nu are
    updated in place."""
    c1, c2 = corrections
    mu.copy_((1 - beta1) * g + beta1 * mu)
    nu.copy_((1 - beta2) * (g * g) + beta2 * nu)
    u = (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)
    if weight_decay is not None:
        u = u + weight_decay * w
    w.add_(_as(step_size, u.dtype) * u)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as a float32 0-dim
    tensor on the tensors' device (optax.global_norm, summed in fp32)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def make_optimizer(cfg: OptimizerConfig, params: Any) -> Optimizer:
    return Optimizer(cfg, params)
