"""RMSNorm with fp32 statistics (LlamaRMSNorm semantics)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance in float32, scaled by `weight`, cast back to x's dtype."""
    xf = x.float()
    variance = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(variance + eps)
    return (weight * xf).to(x.dtype)
