"""COCO (Karpathy-split) caption dataset.

The PyTorch port's copy of ``libra_tpu/data/caption.py`` (the
reference's CaptionDataset / CaptionEvalDataset,
caption_datasets.py:78-264): map-style over karpathy json annotations,
same i2t/t2i pair-sample construction as LAION, `sample_n` truncation for
eval."""

from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

from libra_tpu_torch.data.base import BaseDataset
from libra_tpu_torch.data.pair_samples import PairSampleBuilder, pair_collater


class CaptionDataset(BaseDataset, PairSampleBuilder):
    def __init__(self, vis_processor, text_processor, vis_root, ann_paths,
                 tokenizer=None, i2t_prob: float = 1.0,
                 num_img_tokens: int = 578, pad_to_square_i2t: bool = False,
                 add_newline_sep: bool = False,
                 label_mask_strategy: str = "prompt",
                 use_instruction: bool = False,
                 shape_ratio_threshold: Optional[float] = None,
                 continuous_prob_t2i: float = 0.0,
                 sample_n: Optional[int] = None, seed: int = 0, **kwargs):
        super().__init__(vis_processor, text_processor, vis_root, ann_paths)
        if sample_n is not None:
            self.annotation = self.annotation[:sample_n]
        self.tokenizer = tokenizer
        self.i2t_prob = i2t_prob
        self.num_img_tokens = num_img_tokens
        self.pad_to_square_i2t = pad_to_square_i2t
        self.add_newline_sep = add_newline_sep
        self.label_mask_strategy = label_mask_strategy
        self.use_instruction = use_instruction
        self.shape_ratio_threshold = shape_ratio_threshold
        self.continuous_prob_t2i = continuous_prob_t2i
        self._rng = random.Random(seed)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        from PIL import Image
        ann = self.annotation[index]
        image = Image.open(
            os.path.join(self.vis_root, ann["image"])).convert("RGB")
        caption_ = self.text_processor(ann["caption"])
        return self.build_pair_sample(image, caption_, rng=self._rng)

    def collater(self, samples):
        return pair_collater(samples)


class CaptionEvalDataset(CaptionDataset):
    """Eval split: deterministic i2t with loss-only evaluation
    (prediction_loss_only in the reference run configs)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("i2t_prob", 1.1)  # always i2t
        super().__init__(*args, **kwargs)

    def collater(self, samples):
        return pair_collater(samples, with_return_loss=True)
