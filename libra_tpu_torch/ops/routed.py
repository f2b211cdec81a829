"""Modality-routed dual-path projections.

Both paths run densely for every token and `torch.where` on the vision
flag picks each output row: each row comes from exactly one path, so the
result equals the reference's gather/scatter routing. The one exception
is the modality-split prompt pass (`text_span`): there the full-rank
language path runs only on the gathered text rows.
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


def gather_rows(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...), src (B, T) int -> (B, T, ...): a per-row gather."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(src.shape + x.shape[2:]))


def split_merge(flag: torch.Tensor, vis: torch.Tensor, lang_rows: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """Merge a dense vision output (B, N, F) with language outputs computed
    only on the T gathered text rows (B, T, F): the inverse row map `inv`
    (B, N; clipped junk at vision positions) brings the text rows back to
    full width, and the flag selects. A row gather, not a scatter."""
    return select_by_flag(flag, vis, gather_rows(lang_rows, inv))


def low_rank_linear(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Factored linear y = (x @ wa) @ wb; wa (in, bottleneck), wb (bottleneck, out)."""
    return qdot(qdot(x, wa), wb)


def routed_linear(x: torch.Tensor, flag: torch.Tensor, w_lang: torch.Tensor,
                  wa_vis: torch.Tensor, wb_vis: torch.Tensor,
                  addition_mode: bool = False,
                  text_span=None) -> torch.Tensor:
    """Language path: full-rank x @ w_lang. Vision path: low-rank
    (x @ wa) @ wb. addition_mode adds the vision output on top of the
    language output at vision positions instead of replacing it.

    text_span: optional (src (B, T), inv (B, N)) row maps of the
    modality-split prompt pass (models/libra.py::text_span_maps). When
    given and addition_mode is off, the full-rank language matmul runs
    only on the T gathered text rows instead of all N: exact, since the
    merge discards the language outputs at vision positions. With one
    578-token image in a 610-token prompt this removes 95% of the language
    path's prompt-pass work."""
    if text_span is not None and not addition_mode:
        src, inv = text_span
        vis = low_rank_linear(x, wa_vis, wb_vis)
        return split_merge(flag, vis, qdot(gather_rows(x, src), w_lang), inv)
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
