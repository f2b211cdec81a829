"""Image-text pair sample construction shared by the LAION stream and the
COCO caption dataset.

The PyTorch port's copy of ``libra_tpu/data/pair_samples.py``, after the
duplicated post_process/__getitem__ logic in the
reference (laion_dataset.py:112-176, caption_datasets.py:133-196): a coin
flip chooses i2t (image as background, caption as respond) vs t2i (caption
as background, image placeholders as respond); extreme aspect ratios force
i2t with square padding; t2i samples usually zero out the continuous CLIP
signal (contiguous_ignore_sign).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from libra_tpu_torch.data.caption_format import (I2T_INSTRUCTION_LIST,
                                           T2I_INSTRUCTION_LIST,
                                           build_caption, label_mask_spans)
from libra_tpu_torch.data.processors import expand2square


class PairSampleBuilder:
    """Mixin turning a (PIL image, clean caption) pair into a training
    sample dict. Host requires: self.tokenizer, self.vis_processor,
    self.num_img_tokens, self.i2t_prob, self.use_instruction,
    self.pad_to_square_i2t, self.add_newline_sep, self.label_mask_strategy,
    self.shape_ratio_threshold, self.continuous_prob_t2i,
    self.min_image_size."""

    min_image_size = 0

    def shape_check(self, image) -> bool:
        w, h = image.size
        if max(w, h) < self.min_image_size:
            raise ValueError("Too small image size.")
        if w == 0 or h == 0:
            raise ValueError("Invalid image: zero width/height.")
        t = self.shape_ratio_threshold
        if t is None:
            return True
        lo, hi = min(t, 1 / t), max(t, 1 / t)
        return lo < w / h < hi

    def _background_color(self):
        if hasattr(self.vis_processor, "image_mean"):
            return tuple(int(x * 255) for x in self.vis_processor.image_mean)
        return (0, 0, 0)

    def build_pair_sample(self, image, caption_: str,
                          rng: Optional[random.Random] = None
                          ) -> Dict[str, Any]:
        rng = rng or random
        acceptable = self.shape_check(image)
        p = 0.0 if not acceptable else rng.random()
        ph = (" <img_ph>" * self.num_img_tokens).strip()

        if p < self.i2t_prob:
            if self.pad_to_square_i2t or not acceptable:
                image = expand2square(image, self._background_color())
            pixels = self.vis_processor(image)
            background, respond, img_type = ph, caption_, "background"
            instruction = (rng.choice(I2T_INSTRUCTION_LIST)
                           if self.use_instruction else "")
            contiguous_ignore_sign = False
        else:
            pixels = self.vis_processor(image)
            background, respond, img_type = caption_, ph, "respond"
            instruction = (rng.choice(T2I_INSTRUCTION_LIST)
                           if self.use_instruction else "")
            contiguous_ignore_sign = rng.random() >= self.continuous_prob_t2i

        caption, instruction_ = build_caption(
            background, respond, instruction, img_type,
            add_newline_sep=self.add_newline_sep)
        spans = label_mask_spans(self.tokenizer, caption, background.strip(),
                                 instruction_, img_type,
                                 self.label_mask_strategy)
        return {
            "vision": pixels,
            "language": caption,
            "label_mask_position_map": spans,
            "contiguous_ignore_sign": contiguous_ignore_sign,
        }


def pair_collater(samples, with_return_loss: bool = False):
    """Dict-of-lists collation (reference: laion_dataset.py:244-256)."""
    samples = [s for s in samples if s is not None]
    keys = samples[0].keys()
    out: Dict[str, list] = {k: [] for k in keys}
    for s in samples:
        for k, v in s.items():
            if k in ("vision", "contiguous_ignore_sign") and v is None:
                continue
            out[k].append(v)
    out.pop("return_loss", None)
    batch = {"samples": out}
    if with_return_loss:
        batch["return_loss"] = True
    return batch
