"""Training wrapper: raw data-layer samples -> decoder-ready batches.

The PyTorch counterpart of ``libra_tpu/train_wrapper.py``: joint
tokenization of the batch, labels from the label_mask_position_map spans
(pad, BOI, BOS and each sample's spans -> -100), and the pad-embedding
rewrite. The freeze policies live in ``training/optimizer.py``. Both
classes register under libra_tpu's model names, which run configs' arch
field names.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.registry import registry
from libra_tpu_torch.tokenization import LibraTokenizer

IGNORE_INDEX = -100


def build_labels(input_ids: np.ndarray, attention_mask: np.ndarray,
                 label_mask_position_map: List[List],
                 boi_token_id: int, bos_token_id: int) -> np.ndarray:
    """(Q, B, N) labels with -100 at pad, BOI, BOS and the masked spans. A
    span end of None masks to the end of the sequence (Python slices)."""
    labels = np.array(input_ids, np.int64)
    labels[:, np.asarray(attention_mask) == 0] = IGNORE_INDEX
    labels[labels == boi_token_id] = IGNORE_INDEX
    labels[labels == bos_token_id] = IGNORE_INDEX
    for b, spans in enumerate(label_mask_position_map):
        for start, end in spans:
            if start is None:
                continue
            labels[:, b, slice(start, end)] = IGNORE_INDEX
    return labels


@registry.register_model("debug_model")
class DebugModel:
    """Stub model that exercises the data pipeline and the loop without
    the 11B model (the reference's build_model(no_model=True)): a fixed
    (100, 200) weight and a random input per batch, both seeded."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        g = torch.Generator(device=self.device).manual_seed(0)
        self.w = torch.randn((100, 200), generator=g, device=self.device) * 0.01

    def forward(self, batch: Dict[str, Any]) -> float:
        n = len(batch["samples"]["language"])
        g = torch.Generator(device=self.device).manual_seed(n)
        x = torch.randn((max(n, 1), 100), generator=g, device=self.device)
        return float(((x @ self.w) ** 2).mean())


@registry.register_model("libra_train_wrapper")
class LibraTrainWrapper:
    """Host-side batch preparation around the functional model."""

    def __init__(self, cfg: LibraConfig, tokenizer: LibraTokenizer):
        self.cfg = cfg
        self.tokenizer = tokenizer

    def change_pad_token_to_eos(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """A copy of `params` whose PAD embedding row is the EOS row, so
        padding does not live at another scale."""
        emb = params["embed_tokens"].clone()
        pad = self.tokenizer.text_tokenizer.pad_token_id
        eos = self.tokenizer.text_tokenizer.eos_token_id
        emb[pad] = emb[eos]
        return dict(params, embed_tokens=emb)

    def prepare_batch(self, batch: Dict[str, Any],
                      max_length: Optional[int] = None) -> Dict[str, Any]:
        """batch: {"samples": dict of lists} from a data-layer collater ->
        tensors for training.trainer.train_step, on the image tokenizer's
        device."""
        samples = batch["samples"]
        inputs = self.tokenizer([samples], truncation=True, max_length=max_length)
        ids = inputs["input_ids"]
        labels = build_labels(
            ids.cpu().numpy(), inputs["attention_mask"].cpu().numpy(),
            samples["label_mask_position_map"],
            boi_token_id=self.tokenizer.image_tokenizer.boi_token_id,
            bos_token_id=self.tokenizer.text_tokenizer.bos_token_id)
        return {
            "input_ids": ids,
            "attention_mask": inputs["attention_mask"],
            "vision_indices": inputs["vision_indices"],
            "coninous_signal": inputs["coninous_signal"],
            "labels": torch.as_tensor(labels, device=ids.device),
        }
