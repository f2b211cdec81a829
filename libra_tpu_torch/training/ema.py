"""Exponential moving average of the parameters.

The PyTorch counterpart of ``libra_tpu/training/ema.py``: the average is
a tree of copies of the leaves on their devices, updated in place with
the bias-correcting warm-up d_t = min(decay, (1 + t) / (10 + t)).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class EMAState(NamedTuple):
    ema: Any
    count: int


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def init_ema(params: Any) -> EMAState:
    return EMAState(ema=_map(lambda p: p.detach().clone(), params), count=0)


@torch.no_grad()
def update_ema(state: EMAState, params: Any, decay: float = 0.999,
               warmup: bool = True) -> EMAState:
    """ema <- d * ema + (1 - d) * params, in place. The decay is computed
    on the host in fp32 from the host count, as JAX computes it."""
    count = state.count + 1
    d = min(decay, (1.0 + count) / (10.0 + count)) if warmup else decay
    d = torch.tensor(d, dtype=torch.float32).item()

    def upd(e, p):
        e.copy_(e * d + p.to(e.dtype) * (1.0 - d))
        return e
    return EMAState(ema=_map(upd, state.ema, params), count=count)
