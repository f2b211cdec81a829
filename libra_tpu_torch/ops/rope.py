"""Rotary position embeddings (GPT-NeoX layout, as in LLaMA).

The cos/sin tables are fp32; positions are gathered per token and the
gathered rows cast to the activation dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(max_len: int, dim: int, base: float = 10000.0,
                 device=None):
    """The (max_len, dim) fp32 cos/sin tables: inv_freq over even indices,
    emb = concat(freqs, freqs)."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                  # (max_len, dim//2)
    emb = torch.cat([freqs, freqs], dim=-1)           # (max_len, dim)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               position_ids: torch.Tensor) -> torch.Tensor:
    """x: (B, N, H, d); position_ids: (B, N) int positions."""
    c = cos[position_ids].to(x.dtype)[:, :, None, :]   # (B, N, 1, d)
    s = sin[position_ids].to(x.dtype)[:, :, None, :]
    return x * c + _rotate_half(x) * s
