"""LAION webdataset pretraining pipeline.

The PyTorch port's copy of ``libra_tpu/data/laion.py`` (the reference's
LaionDataset, laion_dataset.py:52-256): streaming tar shards of (jpg,
json{caption}) pairs, i2t/t2i coin flip, instruction sampling,
label-mask spans, skip-and-continue robustness. The shards are read by
the native C++ reader (``runtime.NativeShardStream``) when it builds and
``native_reader`` is on (the default), else by the Python
``webdata.ShardStream``, as in libra_tpu.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterator, Optional

from libra_tpu_torch.data.pair_samples import PairSampleBuilder, pair_collater
from libra_tpu_torch.data.webdata import (ShardStream, fold_process_seed,
                                          resolve_process)


class LaionDataset(PairSampleBuilder):
    is_streaming = True

    def __init__(self, vis_processor, text_processor, location,
                 tokenizer=None, i2t_prob: float = 0.5,
                 num_img_tokens: int = 578, deterministic: bool = True,
                 pad_to_square_i2t: bool = False,
                 add_newline_sep: bool = False,
                 label_mask_strategy: str = "prompt",
                 use_instruction: bool = False,
                 shape_ratio_threshold: Optional[float] = None,
                 continuous_prob_t2i: float = 0.0,
                 min_image_size: int = 0, large_init: bool = False,
                 seed: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, **kwargs):
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.tokenizer = tokenizer
        self.i2t_prob = i2t_prob
        self.num_img_tokens = num_img_tokens
        self.pad_to_square_i2t = pad_to_square_i2t
        self.add_newline_sep = add_newline_sep
        self.label_mask_strategy = label_mask_strategy
        self.use_instruction = use_instruction
        self.shape_ratio_threshold = shape_ratio_threshold
        self.continuous_prob_t2i = continuous_prob_t2i
        self.min_image_size = min_image_size
        # per-process sample rng: the i2t/t2i coin flips must differ across
        # processes too, not just the shard streams (the reference's
        # per-rank DataLoader workers)
        pi, pc = resolve_process(process_index, process_count)
        self._rng = random.Random(fold_process_seed(seed, pi))

        bufsize, initial = (20000, 5000) if large_init else (5000, 1000)
        stream_cls = ShardStream
        if kwargs.get("native_reader", True):
            from libra_tpu_torch import runtime
            if runtime.native_available():
                stream_cls = runtime.NativeShardStream
        self.stream = stream_cls(
            location, shuffle_bufsize=bufsize, shuffle_initial=initial,
            seed=seed, deterministic=deterministic,
            map_fn=self.post_process,
            process_index=pi, process_count=pc)

    def post_process(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        caption_ = self.text_processor(sample["json"]["caption"])
        return self.build_pair_sample(sample["jpg"], caption_, rng=self._rng)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return iter(self.stream)

    def collater(self, samples):
        return pair_collater(samples, with_return_loss=True)
