"""Modality-routed dual-path projections.

Both paths run densely for every token and `torch.where` on the vision
flag picks each output row: each row comes from exactly one path, so the
result equals the reference's gather/scatter routing. The one exception
is the modality-split prompt pass (`text_span`): there the full-rank
language path runs only on the gathered text rows.

Train-time dropout draws its masks from a dropout key: a tuple of Python
ints (the run's seed, the step, the micro-batch, then the layer and the
site, appended by `fold`). Each draw seeds a fresh generator on the
tensor's device from a hash of its key, so the mask is a function of
those integers alone, as JAX's counter-based keys make it: the recompute
of a layer under remat (which restores only the default generators)
redraws the same mask, a resumed run needs no saved generator state, and
nothing is read back from the device. JAX's threefry streams are not
reproduced: the masks differ from libra_tpu's, the semantics do not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from libra_tpu_torch.ops.qlinear import qdot

DropoutKey = Tuple[int, ...]
_M64 = (1 << 64) - 1


def fold(key: Optional[DropoutKey], *ints: int) -> Optional[DropoutKey]:
    """The key of a sub-stream (jax.random.fold_in / split); None stays
    None."""
    return None if key is None else tuple(key) + tuple(int(i) for i in ints)


def key_seed(key: DropoutKey) -> int:
    """A 63-bit generator seed from a key: splitmix64 folded over its
    integers."""
    h = 0x9E3779B97F4A7C15
    for v in key:
        h = (h ^ (int(v) & _M64)) & _M64
        h = (h + 0x9E3779B97F4A7C15) & _M64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 31
    return h >> 1


def uniform(key: DropoutKey, x: torch.Tensor) -> torch.Tensor:
    """fp32 uniforms in [0, 1) of x's shape on x's device, drawn from a
    generator seeded by the key."""
    g = torch.Generator(device=x.device)
    g.manual_seed(key_seed(key))
    return torch.rand(x.shape, generator=g, device=x.device, dtype=torch.float32)


def apply_dropout(key: Optional[DropoutKey], x: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Inverted dropout (torch nn.Dropout's semantics): survivors scaled
    by 1 / (1 - rate). Identity when rate == 0 or key is None (eval)."""
    if key is None or rate == 0.0:
        return x
    keep = uniform(key, x) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def routed_dropout(key: Optional[DropoutKey], x: torch.Tensor, flag: torch.Tensor,
                   rate_vis: float, rate_lang: float) -> torch.Tensor:
    """Per-position modality-routed dropout: vision positions drop at
    rate_vis, language positions at rate_lang, each survivor divided by
    its keep probability cast to x's dtype."""
    if key is None or (rate_vis == 0.0 and rate_lang == 0.0):
        return x
    f = flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))
    keep_p = torch.where(f, 1.0 - rate_vis, 1.0 - rate_lang)      # fp32
    keep = uniform(key, x) < keep_p
    return torch.where(keep, x / keep_p.to(x.dtype), torch.zeros_like(x))


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
                  dropout: Optional[tuple] = None,
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
    path's prompt-pass work.

    dropout: optional (key, rate_lang, rate_vis), applied to each path
    before the merge with its own mask (in addition_mode the two summed
    terms drop independently, as the reference's per-path module lists
    do). Active dropout turns text_span off."""
    active = dropout is not None and dropout[0] is not None and (
        dropout[1] > 0.0 or dropout[2] > 0.0)
    if text_span is not None and not addition_mode and not active:
        src, inv = text_span
        vis = low_rank_linear(x, wa_vis, wb_vis)
        return split_merge(flag, vis, qdot(gather_rows(x, src), w_lang), inv)
    lang = qdot(x, w_lang)
    vis = low_rank_linear(x, wa_vis, wb_vis)
    if active:
        key, rate_lang, rate_vis = dropout
        lang = apply_dropout(fold(key, 0), lang, rate_lang)
        vis = apply_dropout(fold(key, 1), vis, rate_vis)
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
