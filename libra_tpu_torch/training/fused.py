"""On-device pixel normalization (the rest of the fused train step lands
with training, ROADMAP A11)."""

from __future__ import annotations

import torch

from libra_tpu_torch.config import VQGANConfig


def maybe_normalize_pixels(vq_cfg: VQGANConfig, pixels: torch.Tensor) -> torch.Tensor:
    """uint8 (already resized and cropped) pixels -> CLIP-normalized
    float32 on their own device, with the host processor's f32 math.
    Float inputs are already normalized and pass through unchanged."""
    if pixels.dtype != torch.uint8:
        return pixels
    mean = torch.tensor(vq_cfg.clip.image_mean, dtype=torch.float32,
                        device=pixels.device)
    std = torch.tensor(vq_cfg.clip.image_std, dtype=torch.float32,
                       device=pixels.device)
    return (pixels.float() / 255.0 - mean) / std
