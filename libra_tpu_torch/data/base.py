"""Map-style base dataset + concat utilities.

The PyTorch port's copy of ``libra_tpu/data/base.py``: json-annotation
datasets with instance ids, concat of map-style datasets, chain of
streaming ones, and split reorganisation.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional


class BaseDataset:
    def __init__(self, vis_processor=None, text_processor=None,
                 vis_root: Optional[str] = None,
                 ann_paths: Iterable[str] = ()):
        self.vis_root = vis_root
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.annotation: List[Dict[str, Any]] = []
        for p in ann_paths:
            with open(p) as f:
                data = json.load(f)
            self.annotation.extend(
                data if isinstance(data, list) else data["annotations"])
        self._add_instance_ids()

    def __len__(self) -> int:
        return len(self.annotation)

    def _add_instance_ids(self, key: str = "instance_id"):
        for i, ann in enumerate(self.annotation):
            ann[key] = str(i)

    def collater(self, samples):
        from libra_tpu_torch.data.pair_samples import pair_collater
        return pair_collater(samples)


class ConcatDataset:
    """Concat of map-style datasets sharing a collater."""

    def __init__(self, datasets: List[Any]):
        self.datasets = datasets
        self._offsets = []
        total = 0
        for d in datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, idx):
        for d, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if idx >= off:
                return d[idx - off]
        raise IndexError(idx)

    def collater(self, samples):
        return self.datasets[0].collater(samples)


class ChainDataset:
    """Round-robin chain of streaming datasets."""

    def __init__(self, datasets: List[Any]):
        self.datasets = datasets

    def __iter__(self):
        iters = [iter(d) for d in self.datasets]
        while iters:
            for it in list(iters):
                try:
                    yield next(it)
                except StopIteration:
                    iters.remove(it)

    def collater(self, samples):
        return self.datasets[0].collater(samples)


def reorg_datasets_by_split(datasets: Dict[str, Dict[str, Any]]
                            ) -> Dict[str, List[Any]]:
    """{dataset_name: {split: ds}} -> {split: [ds, ...]}
    (reference: data/utils.py:85-108)."""
    out: Dict[str, List[Any]] = {}
    for _, split_map in datasets.items():
        for split, ds in split_map.items():
            out.setdefault(split, []).append(ds)
    return out


def concat_datasets(by_split: Dict[str, List[Any]]) -> Dict[str, Any]:
    """Merge per-split lists: map-style -> ConcatDataset, streaming ->
    ChainDataset; a mix keeps the streaming chain (reference:
    data/utils.py:111-188 keeps wds pipelines separate)."""
    out: Dict[str, Any] = {}
    for split, sets in by_split.items():
        streaming = [d for d in sets if getattr(d, "is_streaming", False)]
        mapstyle = [d for d in sets if not getattr(d, "is_streaming", False)]
        merged: List[Any] = []
        if mapstyle:
            merged.append(mapstyle[0] if len(mapstyle) == 1
                          else ConcatDataset(mapstyle))
        if streaming:
            merged.append(streaming[0] if len(streaming) == 1
                          else ChainDataset(streaming))
        out[split] = merged[0] if len(merged) == 1 else tuple(merged)
    return out
