"""Host-side CLIP image preprocessing (PIL images -> normalized NHWC).

Pad to a square with the CLIP-mean background, resize the shortest edge
to the CLIP size (bicubic), center-crop, rescale by 1/255 and normalize
(the eval processor; the training-time variant lands with A11). Returns float32 numpy arrays of shape (S, S, 3),
equal to ``libra_tpu/data/processors.py``'s. PIL is optional: without it
the port takes uint8 pixels through ``training.fused.maybe_normalize_pixels``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from libra_tpu_torch.config import CLIPVisionConfig

try:
    from PIL import Image
    HAS_PIL = True
except ImportError:  # pragma: no cover
    HAS_PIL = False


def expand2square(img: "Image.Image", background_color=(0, 0, 0)) -> "Image.Image":
    """Pad to a square, centering the image."""
    w, h = img.size
    if w == h:
        return img
    side = max(w, h)
    out = Image.new(img.mode, (side, side), background_color)
    out.paste(img, ((side - w) // 2, (side - h) // 2))
    return out


class LibraEvalImageProcessor:
    """Eval-time CLIP preprocessing on PIL images (or HWC uint8 arrays) ->
    (S, S, 3) float32 normalized, padding to a square with the CLIP-mean
    background first."""

    def __init__(self, clip_cfg: Optional[CLIPVisionConfig] = None):
        if not HAS_PIL:
            raise ImportError("LibraEvalImageProcessor needs PIL")
        self.cfg = clip_cfg or CLIPVisionConfig()

    @property
    def background_color(self) -> Tuple[int, int, int]:
        return tuple(int(x * 255) for x in self.cfg.image_mean)

    def __call__(self, img) -> np.ndarray:
        S = self.cfg.image_size
        if isinstance(img, np.ndarray):
            if img.ndim == 3 and img.shape[-1] == 3 and img.shape[0] != 3:
                img = Image.fromarray(img.astype(np.uint8))
            else:
                raise ValueError("expected HWC uint8 array or PIL image")
        img = expand2square(img, self.background_color)
        w, h = img.size
        # HF get_resize_output_image_size: the long edge is TRUNCATED
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
