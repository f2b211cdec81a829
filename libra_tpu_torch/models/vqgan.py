"""VQGAN vision tokenizer: CLIP feature tap -> 1x1 quant conv -> LFQ
(encode), and LFQ's code lookup -> 1x1 post-quant conv -> the taming conv
decoder (decode_code, text-to-image). Activations are NHWC and conv
weights HWIO, as in ``libra_tpu/models/vqgan.py``; the decoder runs in the
codes' fp32 whatever the params' dtype. The taming conv encoder
(``encoder_name: conv``: init_encoder_params, encoder_forward) serves
tokenizer training (``models/vqgan_train.py``) and the checkpoint
converter; the tokenizer itself encodes through CLIP."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import clip as clip_model
from libra_tpu_torch.models import lfq
from libra_tpu_torch.ops.conv import conv2d, group_norm, nearest_upsample, swish

Params = Dict[str, Any]


def lfq_spec(cfg: VQGANConfig) -> lfq.LFQSpec:
    return lfq.LFQSpec(codebook_size=cfg.codebook_size,
                       num_codebooks=cfg.num_codebook, dim=cfg.embed_dim)


def _conv_init(gen, kh, kw, cin, cout, device, dtype) -> Params:
    w = torch.randn((kh, kw, cin, cout), generator=gen, dtype=torch.float32,
                    device=device) * (kh * kw * cin) ** -0.5
    return {"w": w.to(dtype), "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _gn_init(c, device, dtype) -> Params:
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _block_inits(gen, device, dtype):
    """(conv, gn, resnet, attn) initializers of the conv stacks' blocks:
    convs N(0, 1 / fan_in) with zero biases, GroupNorms unit scale and
    zero bias."""
    def conv(k, cin, cout):
        return _conv_init(gen, k, k, cin, cout, device, dtype)

    def gn(c):
        return _gn_init(c, device, dtype)

    def resnet(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(3, cin, cout),
             "norm2": gn(cout), "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def attn(c):
        return {"norm": gn(c), **{n: conv(1, c, c) for n in ("q", "k", "v", "proj_out")}}

    return conv, gn, resnet, attn


def init_params(gen: torch.Generator, cfg: VQGANConfig, device="cuda",
                dtype=torch.float32) -> Params:
    """The whole tree (`clip`, `quant_conv`, `post_quant_conv`, `decoder`)
    with the JAX tree's key paths and shapes; convs keep their HWIO
    shapes. `gen` must live on `device`."""
    # quant_conv is drawn before the CLIP tower, the decode side after
    # both: a seeded encode side keeps the values it had without a decoder
    quant_conv = _conv_init(gen, 1, 1, cfg.clip_feature_dim, cfg.embed_dim, device, dtype)
    return {
        "clip": clip_model.init_params(gen, cfg.clip, device, dtype),
        "quant_conv": quant_conv,
        "post_quant_conv": _conv_init(gen, 1, 1, cfg.embed_dim, cfg.z_channels,
                                      device, dtype),
        "decoder": init_decoder_params(gen, cfg, device, dtype),
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


def init_decoder_params(gen: torch.Generator, cfg: VQGANConfig, device="cuda",
                        dtype=torch.float32) -> Params:
    """The taming decoder's tree with the JAX tree's key paths and shapes
    (_block_inits' values). `gen` must live on `device`."""
    conv, gn, resnet, attn = _block_inits(gen, device, dtype)
    levels, final_ch = decoder_plan(cfg)
    mid_ch = cfg.ch * cfg.ch_mult[-1]
    p: Params = {
        "conv_in": conv(3, cfg.z_channels, mid_ch),
        "mid_block_1": resnet(mid_ch, mid_ch),
        "mid_attn_1": attn(mid_ch),
        "mid_block_2": resnet(mid_ch, mid_ch),
        "norm_out": gn(final_ch),
        "conv_out": conv(3, final_ch, cfg.out_ch),
        "up": [],
    }
    if cfg.norm_first:
        p["first_norm"] = gn(cfg.z_channels)
    for lev in levels:
        cin, blocks, attns = lev["block_in"], [], []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(resnet(cin, lev["block_out"]))
            cin = lev["block_out"]
            if lev["has_attn"]:
                attns.append(attn(cin))
        entry: Params = {"block": blocks, "attn": attns}
        if lev["up_scale"] is not None:
            entry["upsample_conv"] = conv(3, cin, cin)
        p["up"].append(entry)
    return p


def _resnet_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(swish(group_norm(x, **p["norm1"])), **p["conv1"])
    h = conv2d(swish(group_norm(h, **p["norm2"])), **p["conv2"])
    if "nin_shortcut" in p:
        x = conv2d(x, **p["nin_shortcut"])
    return x + h


def _attn_block(p: Params, x: torch.Tensor, num_heads: int = 1) -> torch.Tensor:
    """Self-attention over the h * w positions, softmax in fp32."""
    B, H, W, C = x.shape
    d = C // num_heads
    hn = group_norm(x, **p["norm"])
    q, k, v = (conv2d(hn, **p[n]).reshape(B, H * W, num_heads, d).transpose(1, 2)
               for n in ("q", "k", "v"))
    s = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    a = torch.softmax(s.float(), dim=-1).to(x.dtype)
    o = torch.matmul(a, v).transpose(1, 2).reshape(B, H, W, C)
    return x + conv2d(o, **p["proj_out"])


def decoder_forward(params: Params, cfg: VQGANConfig, z: torch.Tensor) -> torch.Tensor:
    """z (B, h, w, z_channels) -> pixels (B, resolution, resolution,
    out_ch): the mid block, then the levels bottom-up, each upsampled
    (fractionally at level 1, to reach the resolution)."""
    levels, _ = decoder_plan(cfg)
    if cfg.norm_first:
        z = group_norm(z, **params["first_norm"])
    h = conv2d(z, **params["conv_in"])
    h = _resnet_block(params["mid_block_1"], h)
    h = _attn_block(params["mid_attn_1"], h, cfg.attn_num_heads)
    h = _resnet_block(params["mid_block_2"], h)
    for entry, lev in zip(params["up"], levels):
        for i_block in range(cfg.num_res_blocks + 1):
            h = _resnet_block(entry["block"][i_block], h)
            if lev["has_attn"]:
                h = _attn_block(entry["attn"][i_block], h, cfg.attn_num_heads)
        if lev["up_scale"] is not None:
            h = conv2d(nearest_upsample(h, lev["up_scale"]), **entry["upsample_conv"])
    h = swish(group_norm(h, **params["norm_out"]))
    return conv2d(h, **params["conv_out"])


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


def init_encoder_params(gen: torch.Generator, cfg: VQGANConfig, in_channels: int = 3,
                        device="cuda", dtype=torch.float32) -> Params:
    """The taming conv encoder's tree with the JAX tree's key paths and
    shapes (_block_inits' values). `gen` must live on `device`."""
    conv, gn, resnet, attn = _block_inits(gen, device, dtype)
    levels, final_ch = encoder_plan(cfg)
    p: Params = {
        "conv_in": conv(3, in_channels, cfg.ch),
        "down": [],
        "mid_block_1": resnet(final_ch, final_ch),
        "mid_attn_1": attn(final_ch),
        "mid_block_2": resnet(final_ch, final_ch),
        "norm_out": gn(final_ch),
        "conv_out": conv(3, final_ch, cfg.z_channels),
    }
    for lev in levels:
        cin, blocks, attns = lev["block_in"], [], []
        for _ in range(cfg.num_res_blocks):
            blocks.append(resnet(cin, lev["block_out"]))
            cin = lev["block_out"]
            if lev["has_attn"]:
                attns.append(attn(cin))
        entry: Params = {"block": blocks, "attn": attns}
        if lev["has_down"]:
            entry["downsample_conv"] = conv(3, cin, cin)
        p["down"].append(entry)
    return p


def encoder_forward(params: Params, cfg: VQGANConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, S, S, C) -> latents (B, s, s, z_channels): the levels
    top-down, each but the last downsampled as torch's Downsample does (a
    (0, 1, 0, 1) pad, then a stride-2 VALID conv), then the mid block."""
    levels, _ = encoder_plan(cfg)
    h = conv2d(pixels, **params["conv_in"])
    for entry, lev in zip(params["down"], levels):
        for i_block in range(cfg.num_res_blocks):
            h = _resnet_block(entry["block"][i_block], h)
            if lev["has_attn"]:
                h = _attn_block(entry["attn"][i_block], h, cfg.attn_num_heads)
        if lev["has_down"]:
            h = conv2d(F.pad(h, (0, 0, 0, 1, 0, 1)), **entry["downsample_conv"],
                       stride=2, padding="VALID")
    h = _resnet_block(params["mid_block_1"], h)
    h = _attn_block(params["mid_attn_1"], h, cfg.attn_num_heads)
    h = _resnet_block(params["mid_block_2"], h)
    h = swish(group_norm(h, **params["norm_out"]))
    return conv2d(h, **params["conv_out"])


class EncodeOutput(NamedTuple):
    quantized: torch.Tensor   # (B, g, g, embed_dim): {-1, +1} (straight-through when training)
    indices: torch.Tensor     # (B, g, g, Q)
    feat: torch.Tensor        # (B, g, g, C) tapped CLIP features
    train_aux: Optional[torch.Tensor] = None    # LFQ's; None when not training

    @property
    def aux_loss(self) -> torch.Tensor:
        """fp32 scalar: LFQ's entropy + commitment loss, 0 when not training."""
        return lfq.aux_or_zero(self.train_aux, self.quantized)


def quantize_features(params: Params, cfg: VQGANConfig, feat: torch.Tensor,
                      training: bool = False) -> lfq.LFQOutput:
    """Tapped CLIP features (B, g, g, C) -> the 1x1 quant conv -> LFQ."""
    qc = params["quant_conv"]
    h = feat @ qc["w"][0, 0].to(feat.dtype) + qc["b"].to(feat.dtype)   # 1x1 conv
    return lfq.quantize(h, lfq_spec(cfg), training=training)


def encode(params: Params, cfg: VQGANConfig, pixels: torch.Tensor,
           training: bool = False) -> EncodeOutput:
    """pixels (B, S, S, 3) CLIP-normalized, in the params' dtype."""
    feat = clip_model.forward_features(params["clip"], cfg.clip, pixels,
                                       select_layer=cfg.select_layer)
    out = quantize_features(params, cfg, feat, training)
    return EncodeOutput(out.quantized, out.indices, feat, out.train_aux)


def decode_code(params: Params, cfg: VQGANConfig, indices: torch.Tensor) -> torch.Tensor:
    """indices (B, h, w, Q) codebook ids -> pixels (B, S, S, out_ch) in
    fp32: LFQ's codes, the 1x1 post-quant conv, the conv decoder."""
    codes = lfq.indices_to_codes(indices, lfq_spec(cfg))
    quant = conv2d(codes, **params["post_quant_conv"])
    return decoder_forward(params["decoder"], cfg, quant)
