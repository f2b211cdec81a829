"""Host-side data processors.

The PyTorch port's copy of ``libra_tpu/data/processors.py``: CLIP image
preprocessing (resize the shortest edge to the CLIP size, bicubic, with
the long edge truncated as HF's processor does; center crop; rescale by
1/255; normalize), optional pad-to-square with the CLIP-mean background,
and the caption cleaner (HTML stripped, punctuation squashed, whitespace
collapsed, at most max_words words). Images come back as (S, S, 3)
float32 numpy arrays, CLIP-normalized, equal to libra_tpu's.

PIL is imported only by the functions that resize or pad an image, so
the module imports without it (the card has none): there the port takes
uint8 pixels through ``training.fused.maybe_normalize_pixels``, or
samples whose images are already arrays.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np

from libra_tpu_torch.config import CLIPVisionConfig
from libra_tpu_torch.registry import registry


def expand2square(img: "Image.Image", background_color=(0, 0, 0)) -> "Image.Image":  # noqa: F821
    """Pad to a square, centering the image."""
    from PIL import Image
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), background_color)
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


class LibraImageProcessor:
    """CLIP preprocessing of PIL images (or HWC uint8 arrays) -> (S, S, 3)
    float32 normalized, optionally padded to a square first."""

    name = "libra_image"

    def __init__(self, clip_cfg: Optional[CLIPVisionConfig] = None,
                 pad_to_square: bool = False):
        self.cfg = clip_cfg or CLIPVisionConfig()
        self.pad_to_square = pad_to_square

    @property
    def image_mean(self):
        return self.cfg.image_mean

    @property
    def image_std(self):
        return self.cfg.image_std

    @property
    def background_color(self) -> Tuple[int, int, int]:
        return tuple(int(x * 255) for x in self.cfg.image_mean)

    def __call__(self, img) -> np.ndarray:
        from PIL import Image
        S = self.cfg.image_size
        if isinstance(img, np.ndarray):
            if img.ndim == 3 and img.shape[-1] == 3 and img.shape[0] != 3:
                img = Image.fromarray(img.astype(np.uint8))
            else:
                raise ValueError("expected HWC uint8 array or PIL image")
        if self.pad_to_square:
            img = expand2square(img, self.background_color)
        w, h = img.size
        # HF get_resize_output_image_size: the long edge is TRUNCATED
        # (round() would shift the whole resample grid by a pixel)
        short, long = (w, h) if w <= h else (h, w)
        new_long = int(S * long / short)
        nw, nh = (S, new_long) if w <= h else (new_long, S)
        img = img.resize((nw, nh), Image.BICUBIC)
        left, top = (nw - S) // 2, (nh - S) // 2
        img = img.crop((left, top, left + S, top + S))
        x = np.asarray(img.convert("RGB"), np.float32) / 255.0
        mean = np.asarray(self.cfg.image_mean, np.float32)
        std = np.asarray(self.cfg.image_std, np.float32)
        return (x - mean) / std

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        clip_cfg = None
        if "image_size" in cfg:
            clip_cfg = dataclasses.replace(CLIPVisionConfig(),
                                           image_size=cfg["image_size"])
        return cls(clip_cfg=clip_cfg,
                   pad_to_square=cfg.get("pad_to_square", False))


class LibraEvalImageProcessor(LibraImageProcessor):
    """Eval-time variant: always padded to a square with the CLIP-mean
    background."""

    name = "libra_image_eval"

    def __init__(self, clip_cfg: Optional[CLIPVisionConfig] = None):
        super().__init__(clip_cfg, pad_to_square=True)

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


_HTML_RE = re.compile(r"<[^>]+>")


class LibraCaptionProcessor:
    """Caption cleanup."""

    name = "libra_caption"

    def __init__(self, prompt: str = "", max_words: int = 256,
                 lowercase: bool = False, remove_html: bool = True):
        self.prompt = prompt
        self.max_words = max_words
        self.lowercase = lowercase
        self.remove_html = remove_html

    def __call__(self, caption: str) -> str:
        c = caption
        if self.remove_html:
            c = _HTML_RE.sub(" ", c)
        c = re.sub(r"([*#~])", " ", c)
        c = re.sub(r"\s{2,}", " ", c).strip()
        if self.lowercase:
            c = c.lower()
        words = c.split(" ")
        if len(words) > self.max_words:
            c = " ".join(words[:self.max_words])
        return self.prompt + c

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(prompt=cfg.get("prompt", ""),
                   max_words=cfg.get("max_words", 256),
                   lowercase=cfg.get("lowercase", False),
                   remove_html=cfg.get("remove_html", True))


registry.register_processor("libra_image")(LibraImageProcessor)
registry.register_processor("libra_image_eval")(LibraEvalImageProcessor)
registry.register_processor("libra_caption")(LibraCaptionProcessor)
