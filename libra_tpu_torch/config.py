"""Typed configuration of the PyTorch port.

The same frozen dataclasses, fields and defaults as ``libra_tpu.config``
(a test holds the two equal), with a torch dtype table in place of the
JAX one, and the same loaders of a checkpoint's ``config.json`` and
``vision_tokenizer_config.yaml``. The port cannot import the JAX module:
it imports ``jax.numpy`` for its dtype table.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class LibraConfig:
    """Configuration of the Libra decoder. Defaults are libra-11b:
    LLaMA-2-7B language backbone plus low-rank vision twins."""

    # --- language part (LLaMA-2-7B) ---
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    initializer_range: float = 0.02

    # --- vision part ---
    vision_down_ratio: int = 4
    vision_vocab_size: int = 514
    vision_codebook_num: int = 2
    max_vision_token_length: int = 578
    newline_token_id: int = 13
    contiguous_signal_size: int = 2048
    image_feature_resolution: int = 24
    vision_prediction_mode: str = "1d"
    use_bridge: bool = True
    bridge_rank: int = 8
    concat_signals: bool = True
    norm_signals: bool = True
    addition_mode: bool = False
    use_vision_position_embedding: bool = False
    unified_head: bool = False
    use_2d_rope: bool = False

    # --- dropout (training only; not ported yet: the port's train steps
    # raise on a nonzero rate) ---
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    embd_pdrop: float = 0.0
    vision_embd_pdrop: float = 0.0
    vision_resid_pdrop: float = 0.0

    # --- numerics ---
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"   # parameter storage dtype

    def __post_init__(self):
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError("hidden_size must divide num_attention_heads")
        if self.hidden_size % self.vision_codebook_num != 0:
            raise ValueError("hidden_size must be divisible by vision_codebook_num")
        if self.image_feature_resolution ** 2 + 2 != self.max_vision_token_length:
            raise ValueError("max_vision_token_length must equal "
                             "image_feature_resolution**2 + 2")
        if self.vision_prediction_mode not in ("1d", "2d"):
            raise ValueError("vision_prediction_mode must be '1d' or '2d'")
        if self.hidden_size % self.vision_down_ratio != 0:
            raise ValueError("hidden_size must be divisible by vision_down_ratio")
        resolve_dtype(self.dtype)
        resolve_dtype(self.param_dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def combined_vocab_size(self) -> int:
        """Text vocab + vision vocab: logits live in this combined space."""
        return self.vocab_size + self.vision_vocab_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)

    def replace(self, **kw) -> "LibraConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LibraConfig":
        """A CPU-testable miniature with the same structural invariants."""
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            max_position_embeddings=512,
            vision_vocab_size=18,
            vision_codebook_num=2,
            max_vision_token_length=6,   # 2x2 + BOI + EOI
            image_feature_resolution=2,
            contiguous_signal_size=32,
            bridge_rank=4,
            dtype="float32",
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LibraConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_pretrained(cls, path: str) -> "LibraConfig":
        """Load from an HF-style checkpoint dir containing config.json."""
        with open(Path(path) / "config.json") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT vision encoder config. Defaults: ViT-L/14-336."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    image_mean: Tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    dtype: str = "float32"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw) -> "CLIPVisionConfig":
        base = dict(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=3,
            num_attention_heads=4,
            image_size=28,
            patch_size=14,
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CLIPVisionConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        for k in ("image_mean", "image_std"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class VQGANConfig:
    """Vision tokenizer: CLIP encoder tap + 1x1 quant conv + LFQ, and the
    conv decoder that turns codes back into pixels (models/vqgan.
    decode_code); the decoder fields shape its tree (decoder_plan)."""

    embed_dim: int = 18                 # LFQ input dim = num_codebooks * log2(codebook)
    codebook_size: int = 512
    num_codebook: int = 2
    z_channels: int = 18
    resolution: int = 336
    initial_resolution: int = 24
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (24,)
    out_ch: int = 3
    dropout: float = 0.0
    norm_first: bool = False
    attn_num_heads: int = 1
    encoder_name: str = "clip"
    # int or tuple of ints; a tuple channel-concatenates several hidden states
    select_layer: Any = -2
    clip: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    dtype: str = "float32"

    @property
    def select_layers(self) -> Tuple[int, ...]:
        s = self.select_layer
        return (s,) if isinstance(s, int) else tuple(s)

    @property
    def clip_feature_dim(self) -> int:
        """Channel dim of the tapped CLIP features (the continuous signal)."""
        return self.clip.hidden_size * len(self.select_layers)

    @property
    def codebook_dim(self) -> int:
        d = int(math.log2(self.codebook_size))
        if (1 << d) != self.codebook_size:
            raise ValueError("codebook_size must be a power of two (LFQ)")
        return d

    @classmethod
    def tiny(cls, **kw) -> "VQGANConfig":
        base = dict(
            embed_dim=8,
            codebook_size=16,
            num_codebook=2,
            z_channels=8,
            resolution=28,
            initial_resolution=2,
            ch=8,
            ch_mult=(1, 2),
            num_res_blocks=1,
            attn_resolutions=(),
            clip=CLIPVisionConfig.tiny(),
        )
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_yaml_dict(cls, d: Dict[str, Any]) -> "VQGANConfig":
        """Build from a parsed ``vision_tokenizer_config.yaml`` dict:
        top-level ``{ckpt_path, max_vision_token_length, freeze, params:
        {embed_dim, codebook_size, num_codebook, ckpt_path, ddconfig:
        {encoder_name, select_layer, z_channels, resolution,
        initial_resolution, ch, ch_mult, num_res_blocks, attn_resolutions,
        out_ch, dropout, norm_first, num_attn_head}}}``."""
        params = dict(d.get("params", {}))
        dd = dict(params.get("ddconfig", {}))
        kw: Dict[str, Any] = {k: params[k] for k in
                              ("embed_dim", "codebook_size", "num_codebook")
                              if k in params}
        for k in ("z_channels", "resolution", "initial_resolution", "ch",
                  "num_res_blocks", "out_ch", "dropout", "norm_first",
                  "select_layer"):
            if k in dd and dd[k] is not None:
                kw[k] = dd[k]
        if isinstance(kw.get("select_layer"), list):
            kw["select_layer"] = tuple(kw["select_layer"])
        if "ch_mult" in dd:
            kw["ch_mult"] = tuple(dd["ch_mult"])
        if "attn_resolutions" in dd:
            kw["attn_resolutions"] = tuple(dd["attn_resolutions"])
        if "num_attn_head" in dd:
            kw["attn_num_heads"] = dd["num_attn_head"]
        if "encoder_name" in dd and dd["encoder_name"] is not None:
            # the reference stores a path or an HF id; only the "clip"
            # substring matters
            kw["encoder_name"] = ("clip" if "clip" in str(dd["encoder_name"])
                                  else "conv")
        return cls(**kw)


class VisionTokenizerSpec(NamedTuple):
    """Parsed ``vision_tokenizer_config.yaml``: the VQGAN config, the
    resolved weight path, the optional max_vision_token_length override,
    and the resolved nested CLIP checkpoint dir (None when the encoder is
    the conv variant or the YAML names no path)."""
    vq_cfg: VQGANConfig
    ckpt_path: str
    max_vision_token_length: Optional[int]
    clip_dir: Optional[str]


def load_vision_tokenizer_config(checkpoint_dir: str) -> VisionTokenizerSpec:
    """Parse ``<ckpt>/vision_tokenizer_config.yaml`` into a
    VisionTokenizerSpec. Relative ``ckpt_path`` entries resolve against
    the checkpoint dir, and so does ``ddconfig.encoder_name``, the nested
    CLIP dir's path. Without the YAML: the default VQGANConfig and
    ``<ckpt>/vqgan.ckpt``."""
    root = Path(checkpoint_dir)
    yaml_path = root / "vision_tokenizer_config.yaml"
    if not yaml_path.exists():
        return VisionTokenizerSpec(VQGANConfig(), str(root / "vqgan.ckpt"),
                                   None, None)
    import yaml
    with open(yaml_path) as f:
        d = yaml.safe_load(f) or {}
    cfg = VQGANConfig.from_yaml_dict(d)
    rel = d.get("ckpt_path") or (d.get("params") or {}).get("ckpt_path") \
        or "vqgan.ckpt"
    ckpt_path = rel if Path(rel).is_absolute() else str(root / rel)
    clip_dir = None
    enc = ((d.get("params") or {}).get("ddconfig") or {}).get("encoder_name")
    if enc and "clip" in str(enc):
        p = Path(enc)
        clip_dir = str(p if p.is_absolute() else root / p)
    return VisionTokenizerSpec(cfg, ckpt_path,
                               d.get("max_vision_token_length"), clip_dir)
