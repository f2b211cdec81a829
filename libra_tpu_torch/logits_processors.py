"""Constrained-decoding logits processors.

The PyTorch counterpart of ``libra_tpu/logits_processors.py``: the
reference's processors as plain functions on tensors, (logits (Q, B, Vc),
state) -> logits. Like JAX's, the decode loop does not call them; a
caller composes them with the logits it samples from.

* no_newline: once a newline has been emitted, force EOS;
* valid_image: inside an image block restrict sampling to the image
  code ids, and force <EOI> at the block's last slot.
"""

from __future__ import annotations

import torch

from libra_tpu_torch.config import LibraConfig

NEG = -1e30


def no_newline_processor(cfg: LibraConfig, logits: torch.Tensor,
                         emitted_newline: torch.Tensor) -> torch.Tensor:
    """emitted_newline: (B,) bool; once true, only EOS is allowed."""
    forced = torch.full_like(logits, NEG)
    forced[..., cfg.eos_token_id] = 0.0
    return torch.where(emitted_newline[None, :, None], forced, logits)


def valid_image_processor(cfg: LibraConfig, logits: torch.Tensor,
                          vision_indices: torch.Tensor) -> torch.Tensor:
    """vision_indices: (B,) index of the position being predicted from.
    Inside an image (index in [0, Mv - 3)) only the code ids stay; at
    index Mv - 3 (the last grid cell) <EOI> is forced."""
    Vc = logits.shape[-1]
    V, Mv = cfg.vocab_size, cfg.max_vision_token_length
    code_lo, code_hi = V, V + cfg.vision_vocab_size - 2
    eoi_id = V + cfg.vision_vocab_size - 1

    ids = torch.arange(Vc, device=logits.device)
    in_code_range = (ids >= code_lo) & (ids < code_hi)
    codes_only = torch.where(in_code_range[None, None, :], logits, NEG)
    force_eoi = torch.full_like(logits, NEG)
    force_eoi[..., eoi_id] = 0.0

    vi = vision_indices
    mid_image = (vi >= 0) & (vi < Mv - 3)
    last_cell = vi == Mv - 3
    out = torch.where(mid_image[None, :, None], codes_only, logits)
    return torch.where(last_cell[None, :, None], force_eoi, out)
