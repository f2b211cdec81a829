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


def apply_rope_2d(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  position_ids_2d: torch.Tensor) -> torch.Tensor:
    """2D RoPE: x (B, N, H, d); position_ids_2d (B, 2, N) row and column
    positions. The gathered (B, 2, N, d) rows are tiled over the heads, so
    heads alternate row, col, row, col (the reference repeats the 2-entry
    axis H // 2 times); the tiling is a broadcast over x viewed as
    (B, N, H // 2, 2, d), with no (B, N, H, d) table built."""
    B, N, H, d = x.shape
    c = cos[position_ids_2d].to(x.dtype).permute(0, 2, 1, 3)[:, :, None]  # (B, N, 1, 2, d)
    s = sin[position_ids_2d].to(x.dtype).permute(0, 2, 1, 3)[:, :, None]
    out = (x.reshape(B, N, H // 2, 2, d) * c
           + _rotate_half(x).reshape(B, N, H // 2, 2, d) * s)
    return out.reshape(B, N, H, d)
