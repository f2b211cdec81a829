"""VQGAN vision tokenizer, encode side: CLIP feature tap -> 1x1 quant conv
-> LFQ. The conv decoder and the post-quant conv wait for text-to-image
(ROADMAP A10)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import clip as clip_model
from libra_tpu_torch.models import lfq

Params = Dict[str, Any]


def lfq_spec(cfg: VQGANConfig) -> lfq.LFQSpec:
    return lfq.LFQSpec(codebook_size=cfg.codebook_size,
                       num_codebooks=cfg.num_codebook, dim=cfg.embed_dim)


def init_params(gen: torch.Generator, cfg: VQGANConfig, device="cuda",
                dtype=torch.float32) -> Params:
    """The encode side's tree (`clip`, `quant_conv`) with the JAX tree's
    key paths and shapes. quant_conv keeps its HWIO (1, 1, Cin, Cout)
    shape. `gen` must live on `device`."""
    cin = cfg.clip_feature_dim
    w = torch.randn((1, 1, cin, cfg.embed_dim), generator=gen,
                    dtype=torch.float32, device=device) * cin ** -0.5
    return {
        "clip": clip_model.init_params(gen, cfg.clip, device, dtype),
        "quant_conv": {"w": w.to(dtype),
                       "b": torch.zeros((cfg.embed_dim,), dtype=dtype,
                                        device=device)},
    }


class EncodeOutput(NamedTuple):
    quantized: torch.Tensor   # (B, g, g, embed_dim) in {-1, +1}
    indices: torch.Tensor     # (B, g, g, Q)
    feat: torch.Tensor        # (B, g, g, C) tapped CLIP features


def encode(params: Params, cfg: VQGANConfig, pixels: torch.Tensor) -> EncodeOutput:
    """pixels (B, S, S, 3) CLIP-normalized, in the params' dtype."""
    feat = clip_model.forward_features(params["clip"], cfg.clip, pixels,
                                       select_layer=cfg.select_layer)
    qc = params["quant_conv"]
    h = feat @ qc["w"][0, 0].to(feat.dtype) + qc["b"].to(feat.dtype)   # 1x1 conv
    out = lfq.quantize(h, lfq_spec(cfg))
    return EncodeOutput(out.quantized, out.indices, feat)
