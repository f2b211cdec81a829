"""Bridged routed attention, plain PyTorch.

The bridge adds rank-8 K/V corrections so each modality's queries see the
other modality's keys and values corrected. It reduces to one
cross-modality mask ``cross[q, k] = flag_q != flag_k``:

    S   = (Q K^T) * scale + cross * (Q Kb^T) * scale + bias
    A   = softmax(max(S, BIG_NEG))       # fp32
    out = A V + (A * cross) Vb

The cached decode step and ``training.trainer.loss_fn`` use this
function; the prompt pass and the fused train step on the card use the
kernels in ``ops/flash_bridge.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

BIG_NEG = -2.0 ** 30  # additive mask value; scores are min-clamped to it


def bridged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kb: Optional[torch.Tensor], vb: Optional[torch.Tensor],
                      flag_q: torch.Tensor, flag_kv: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """q (B, Nq, H, d); k/v/kb/vb (B, Nk, H, d), kb/vb None without the
    bridge; flag_q (B, Nq) and flag_kv (B, Nk) bool; bias (B, 1, Nq, Nk)
    additive fp32. Returns (B, Nq, H, d) in q's dtype. The probabilities
    are cast to q's dtype before the value products, as in the JAX path."""
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    use_bridge = kb is not None
    if use_bridge:
        cross = flag_q[:, None, :, None] ^ flag_kv[:, None, None, :]   # (B,1,Nq,Nk)
        sb = torch.einsum("bqhd,bkhd->bhqk", q, kb) * scale
        s = s + torch.where(cross, sb, torch.zeros_like(sb))
    s = s + bias.to(s.dtype)
    # Under autograd torch.maximum, not clamp_min: at a tie (a masked score
    # rounds to exactly BIG_NEG) it splits the gradient in half, as JAX's
    # jnp.maximum does; clamp_min would pass all of it. The bound is filled
    # on the device: a host scalar would be copied to the card, and that
    # copy waits for the stream in every layer of a decode step.
    if s.requires_grad:
        s = torch.maximum(s, torch.full((), BIG_NEG, dtype=s.dtype, device=s.device))
    else:
        s = torch.clamp_min(s, BIG_NEG)
    a = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", a, v)
    if use_bridge:
        ab = torch.where(cross, a, torch.zeros_like(a))
        out = out + torch.einsum("bhqk,bkhd->bqhd", ab, vb)
    return out


def causal_bias(attention_mask: torch.Tensor, nq: int, nk: int) -> torch.Tensor:
    """The additive (B, 1, Nq, Nk) fp32 mask from a (B, Nk) padding mask:
    causality (queries occupy the LAST nq key slots) and padding."""
    device = attention_mask.device
    q_pos = torch.arange(nq, device=device) + (nk - nq)
    k_pos = torch.arange(nk, device=device)
    causal = k_pos[None, :] <= q_pos[:, None]                # (Nq, Nk)
    pad = attention_mask.bool()[:, None, None, :]            # (B,1,1,Nk)
    keep = causal[None, None] & pad
    return torch.where(keep, 0.0, BIG_NEG).float()
