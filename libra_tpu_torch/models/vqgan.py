"""VQGAN vision tokenizer, encode side: CLIP feature tap -> 1x1 quant conv
-> LFQ. The conv decoder's and the conv encoder's forward passes wait for
text-to-image (ROADMAP A10); their static plans (decoder_plan,
encoder_plan) are here, for the checkpoint converter."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

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


def decoder_plan(cfg: VQGANConfig):
    """Static structure of the taming Decoder's upsampling stack: per
    level (top-down construction order, bottom-up execution), channels and
    whether attention and upsampling apply. Returns (levels, the last
    level's channels)."""
    n_lev = len(cfg.ch_mult)
    block_in = cfg.ch * cfg.ch_mult[-1]
    curr_res = cfg.initial_resolution
    levels = []
    for i_level in reversed(range(n_lev)):
        block_out = cfg.ch * cfg.ch_mult[i_level]
        has_attn = curr_res in cfg.attn_resolutions
        if i_level > 1:
            up_scale: Optional[float] = 2.0
            curr_res *= 2
        elif i_level == 1:
            up_scale = cfg.resolution / curr_res
        else:
            up_scale = None
        levels.append(dict(i_level=i_level, block_in=block_in,
                           block_out=block_out, has_attn=has_attn,
                           up_scale=up_scale))
        block_in = block_out
    return levels, block_in


def encoder_plan(cfg: VQGANConfig):
    """Static structure of the taming Encoder's downsampling stack (the
    conv-encoder variant). Returns (levels, the last level's channels)."""
    n_lev = len(cfg.ch_mult)
    in_ch_mult = (1,) + tuple(cfg.ch_mult)
    curr_res = cfg.resolution
    levels = []
    for i_level in range(n_lev):
        has_attn = curr_res in cfg.attn_resolutions
        has_down = i_level != n_lev - 1
        if has_down:
            curr_res //= 2
        levels.append(dict(block_in=cfg.ch * in_ch_mult[i_level],
                           block_out=cfg.ch * cfg.ch_mult[i_level],
                           has_attn=has_attn, has_down=has_down))
    return levels, cfg.ch * cfg.ch_mult[-1]


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
