"""Registry-driven dataset builders.

The PyTorch port's copy of ``libra_tpu/data/builders.py`` (the
reference's builders, libra/data/builders.py:21-221):
a builder reads its `build_info` config section, instantiates vis/text
processors from the `vis_processor`/`text_processor` config names, and
returns {split: dataset}.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from libra_tpu_torch.data.caption import CaptionDataset, CaptionEvalDataset
from libra_tpu_torch.data.instruction import InstructionDataset
from libra_tpu_torch.data.laion import LaionDataset
from libra_tpu_torch.registry import registry


def _build_processor(cfg: Optional[Dict]) -> Any:
    if cfg is None:
        return None
    name = cfg.get("name")
    cls = registry.get_processor_class(name)
    return cls.from_config(cfg)


class BaseDatasetBuilder:
    train_dataset_cls = None
    eval_dataset_cls = None

    def __init__(self, cfg: Dict[str, Any], tokenizer=None):
        self.config = cfg
        self.tokenizer = tokenizer
        self.vis_processors: Dict[str, Any] = {}
        self.text_processors: Dict[str, Any] = {}

    def build_processors(self):
        for kind, store in (("vis_processor", self.vis_processors),
                            ("text_processor", self.text_processors)):
            spec = self.config.get(kind, {})
            for split, pcfg in spec.items():
                store[split] = _build_processor(pcfg)

    def build_datasets(self) -> Dict[str, Any]:
        self.build_processors()
        return self.build()

    def build(self) -> Dict[str, Any]:
        raise NotImplementedError


@registry.register_builder("laion")
class LaionBuilder(BaseDatasetBuilder):
    train_dataset_cls = LaionDataset

    def build(self):
        info = self.config.get("build_info", {})
        kwargs = dict(self.config.get("kwargs", {}))
        ds = LaionDataset(
            vis_processor=self.vis_processors.get("train"),
            text_processor=self.text_processors.get("train"),
            location=info.get("storage"),
            tokenizer=self.tokenizer,
            **kwargs,
        )
        return {"train": ds}


@registry.register_builder("coco_caption")
class COCOCapBuilder(BaseDatasetBuilder):
    train_dataset_cls = CaptionDataset
    eval_dataset_cls = CaptionEvalDataset

    def build(self):
        info = self.config.get("build_info", {})
        anns = info.get("annotations", {})
        images_root = info.get("images", {}).get("storage")
        kwargs = dict(self.config.get("kwargs", {}))
        out: Dict[str, Any] = {}
        for split, spec in anns.items():
            cls = (CaptionDataset if split == "train" else CaptionEvalDataset)
            paths = spec.get("storage")
            if isinstance(paths, str):
                paths = [paths]
            out[split] = cls(
                vis_processor=self.vis_processors.get(
                    split, self.vis_processors.get("train")),
                text_processor=self.text_processors.get(
                    split, self.text_processors.get("train")),
                vis_root=images_root,
                ann_paths=paths,
                tokenizer=self.tokenizer,
                **kwargs,
            )
        return out


@registry.register_builder("instruction")
class InstructionBuilder(BaseDatasetBuilder):
    train_dataset_cls = InstructionDataset

    def build(self):
        info = self.config.get("build_info", {})
        kwargs = dict(self.config.get("kwargs", {}))
        ds = InstructionDataset(
            ann_path=info.get("annotations"),
            vis_processor=self.vis_processors.get("train"),
            version=kwargs.pop("version", "v1"),
            tokenizer=self.tokenizer,
            num_img_tokens=kwargs.pop("num_img_tokens", 578),
            vis_root=info.get("images"),
            enable_t2i=kwargs.pop("enable_t2i", False),
            image_size=kwargs.pop("image_size", 336),
            **kwargs,
        )
        return {"train": ds}
