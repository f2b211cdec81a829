"""Weight consumption: one entry point for every ``x @ W`` in the model.

Plain weights only. Quantized weight trees (int8, int4) and their
kernels land with the int8 serving path (ROADMAP A7).
"""

from __future__ import annotations

import torch


def qdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, F) -> (..., F), in x's dtype."""
    return x @ w.to(x.dtype)
