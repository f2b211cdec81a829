"""Modality-routed dual-path projections.

Both paths run densely for every token and `torch.where` on the vision
flag picks each output row: each row comes from exactly one path, so the
result equals the reference's gather/scatter routing.
"""

from __future__ import annotations

import torch

from libra_tpu_torch.ops.qlinear import qdot


def select_by_flag(flag: torch.Tensor, vision: torch.Tensor,
                   language: torch.Tensor) -> torch.Tensor:
    """out[t] = vision[t] if flag[t] else language[t], broadcasting flag
    over the trailing feature dims."""
    f = flag.reshape(flag.shape + (1,) * (vision.dim() - flag.dim()))
    return torch.where(f, vision, language)


def low_rank_linear(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Factored linear y = (x @ wa) @ wb; wa (in, bottleneck), wb (bottleneck, out)."""
    return qdot(qdot(x, wa), wb)


def routed_linear(x: torch.Tensor, flag: torch.Tensor, w_lang: torch.Tensor,
                  wa_vis: torch.Tensor, wb_vis: torch.Tensor,
                  addition_mode: bool = False) -> torch.Tensor:
    """Language path: full-rank x @ w_lang. Vision path: low-rank
    (x @ wa) @ wb. addition_mode adds the vision output on top of the
    language output at vision positions instead of replacing it."""
    lang = qdot(x, w_lang)
    vis = low_rank_linear(x, wa_vis, wb_vis)
    if addition_mode:
        return lang + select_by_flag(flag, vis, torch.zeros_like(vis))
    return select_by_flag(flag, vis, lang)


def routed_low_rank(x: torch.Tensor, flag: torch.Tensor,
                    wa_lang: torch.Tensor, wb_lang: torch.Tensor,
                    wa_vis: torch.Tensor, wb_vis: torch.Tensor) -> torch.Tensor:
    """Routed projection where both paths are low-rank (the K/V bridges)."""
    lang = low_rank_linear(x, wa_lang, wb_lang)
    vis = low_rank_linear(x, wa_vis, wb_vis)
    return select_by_flag(flag, vis, lang)
