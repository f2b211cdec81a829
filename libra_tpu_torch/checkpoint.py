"""Checkpoint loading: reference PyTorch/HF weights -> the port's trees.

The reference checkpoint layout: HF-format decoder weights (config.json +
pytorch_model*.bin or *.safetensors), a ``vqgan.ckpt`` Lightning
state_dict, ``vision_tokenizer_config.yaml`` and a nested CLIP dir. This
module maps those tensors onto the port's parameter trees, which are
``libra_tpu``'s trees (``params.py``):

* torch Linear weights are (out, in) -> transposed to x @ W orientation;
* LibraLinear factors weight_A (bottleneck, in) / weight_B (out,
  bottleneck) -> wa (in, bottleneck) / wb (bottleneck, out);
* torch Conv2d (out, in, kh, kw) -> HWIO (kh, kw, in, out);
* per-layer modules are stacked along a leading axis.

Dtypes are libra_tpu's: the decoder tree takes the config's params dtype,
the CLIP and VQGAN trees are fp32. Each state-dict tensor goes to the
device as it is read (``params.from_numpy_tree``: cast on the torch side,
since numpy has no bf16, with the round-to-nearest-even of JAX's cast),
and the stacking and transposes run there; so beside the state dict the
host holds one tensor at a time. Casting commutes with stacking and
transposing, so the leaves equal libra_tpu's bit for bit.

Training state is saved and restored with ``save_checkpoint`` /
``restore_checkpoint`` (libra_tpu's Orbax pair, in torch's file format).

Not ported here: the Meta-format LLaMA converter (its target, the
``models/llama`` tree, comes with ROADMAP A12), and the LPIPS converters
(ROADMAP A11b).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from libra_tpu_torch.config import CLIPVisionConfig, LibraConfig, VQGANConfig
from libra_tpu_torch.params import from_numpy_tree

Put = Callable[[np.ndarray], torch.Tensor]


# ---------------------------------------------------------------------------
# Raw state-dict loading
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load all torch/safetensors weight files in an HF checkpoint dir (or a
    single file) into a flat name -> np.ndarray dict. bf16 tensors of a
    .bin are widened to float32 (exactly), other dtypes kept; a
    .safetensors file loads through safetensors.numpy where numpy knows
    its dtypes (bf16 only where ml_dtypes registered it), else as a .bin."""
    p = Path(path)
    files: List[Path] = [p]
    if p.is_dir():
        files = sorted(p.glob("*.safetensors")) or sorted(p.glob("pytorch_model*.bin"))
        if not files:
            raise FileNotFoundError(f"no weight files in {p}")

    out: Dict[str, np.ndarray] = {}
    for f in files:
        if f.suffix == ".safetensors":
            try:
                from safetensors.numpy import load_file as load_np
                out.update(load_np(str(f)))
                continue
            except (TypeError, ValueError):
                from safetensors.torch import load_file
                sd = load_file(str(f))
        else:
            sd = torch.load(str(f), map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
        for k, v in sd.items():
            out[k] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return out


def strip_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Strip a legacy wrapper prefix: 'model.model.' / 'module.model.'
    wrapped state dicts lose their outer 'model.' / 'module.'."""
    keys = list(sd.keys())
    for prefix in ("model.model.", "module.model."):
        if any(k.startswith(prefix) for k in keys):
            outer = prefix.split(".")[0] + "."
            return {k[len(outer):]: v for k, v in sd.items()
                    if k.startswith(outer)}
    return sd


def _putter(device, dtype: torch.dtype) -> Put:
    """numpy -> a tensor of `dtype` (floating leaves) on `device`."""
    return lambda a: from_numpy_tree(a, device, dtype)


def _t(x: torch.Tensor) -> torch.Tensor:
    """(..., out, in) -> contiguous (..., in, out): x @ W orientation."""
    return x.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# Libra decoder conversion
# ---------------------------------------------------------------------------

def convert_libra_state_dict(sd: Dict[str, np.ndarray], cfg: LibraConfig,
                             device="cuda") -> Dict[str, Any]:
    """Reference LibraForCausalLM state dict -> the decoder tree on
    `device`, in cfg.params_dtype."""
    sd = strip_prefixes(sd)
    L = cfg.num_hidden_layers
    Q = cfg.vision_codebook_num
    put = _putter(device, cfg.params_dtype)

    def stacked(key: str, transpose: bool = True) -> torch.Tensor:
        """`key` ({i} the layer) of every layer, stacked on axis 0."""
        x = torch.stack([put(sd[key.format(i=i)]) for i in range(L)])
        return _t(x) if transpose else x

    def low_rank(key: str) -> Dict[str, torch.Tensor]:
        return {"wa": stacked(f"{key}.weight_A"), "wb": stacked(f"{key}.weight_B")}

    a = "model.layers.{i}.self_attn"
    attn = {n: stacked(f"{a}.{n}.weight")
            for n in ("q_proj", "k_proj", "v_proj", "o_proj")}
    for n in "qkvo":
        attn[f"vision_{n}"] = low_rank(f"{a}.vision_{n}_proj")
    if cfg.use_bridge:
        for n in "kv":
            attn[f"{n}_bridge_lang"] = low_rank(f"{a}.vision_{n}_bridge_on_language")
            attn[f"{n}_bridge_vis"] = low_rank(f"{a}.vision_{n}_bridge_on_vision")
    m = "model.layers.{i}.mlp"
    mlp = {n: stacked(f"{m}.{n}.weight") for n in ("gate_proj", "up_proj", "down_proj")}
    for n in ("gate", "up", "down"):
        mlp[f"vision_{n}"] = low_rank(f"{m}.vision_{n}_proj")
    layers = {"attn": attn, "mlp": mlp}
    for n in ("input_layernorm", "post_attention_layernorm",
              "vision_input_layernorm", "vision_post_attention_layernorm"):
        layers[n] = stacked(f"model.layers.{{i}}.{n}.weight", transpose=False)

    params: Dict[str, Any] = {
        "embed_tokens": put(sd["model.embed_tokens.weight"]),
        "vision_embed_tokens": torch.stack(
            [put(sd[f"model.vision_embed_tokens.{q}.weight"]) for q in range(Q)]),
        "layers": layers,
        "norm": put(sd["model.norm.weight"]),
        "vision_norm": put(sd["model.vision_norm.weight"]),
        "lm_head": _t(put(sd["lm_head.weight"])),
        "vision_lm_head": _t(torch.stack(
            [put(sd[f"vision_lm_head.heads.{q}.weight"]) for q in range(Q)])),
        "signal_proj": _t(put(sd["model.vision_contiguous_signal_processor.weight"])),
    }
    if cfg.concat_signals and cfg.norm_signals:
        params["signal_norm"] = put(sd["model.vision_signal_norm.weight"])
    if cfg.use_vision_position_embedding:
        params["vision_position_embedding"] = put(
            sd["model.vision_position_embedding.weight"])
    if cfg.vision_prediction_mode == "2d":
        params["vision_hidden_placeholder"] = put(sd["vision_hidden_placeholder"])
    return params


# ---------------------------------------------------------------------------
# CLIP conversion
# ---------------------------------------------------------------------------

def convert_clip_state_dict(sd: Dict[str, np.ndarray], cfg: CLIPVisionConfig,
                            device="cuda") -> Dict[str, Any]:
    """HF CLIPVisionModel state dict (keys with or without 'vision_model.')
    -> the CLIP tree on `device`, fp32."""
    pre = "vision_model."
    if not any(k.startswith(pre) for k in sd):
        pre = ""
    P = cfg.patch_size
    L = cfg.num_hidden_layers
    put = _putter(device, torch.float32)

    def stacked(key: str, transpose: bool = False) -> torch.Tensor:
        x = torch.stack([put(sd[f"{pre}encoder.layers.{i}.{key}"]) for i in range(L)])
        return _t(x) if transpose else x

    def dense(name):
        return {"w": stacked(f"{name}.weight", True), "b": stacked(f"{name}.bias")}

    def ln(name):
        return {"scale": stacked(f"{name}.weight"), "bias": stacked(f"{name}.bias")}

    layers = {"ln1": ln("layer_norm1"), "ln2": ln("layer_norm2"),
              "q": dense("self_attn.q_proj"), "k": dense("self_attn.k_proj"),
              "v": dense("self_attn.v_proj"), "o": dense("self_attn.out_proj"),
              "fc1": dense("mlp.fc1"), "fc2": dense("mlp.fc2")}

    # torch conv (out, in, kh, kw) -> flattened (kh * kw * in, out), the
    # (ph, pw, c) order in which embed_patches flattens a patch
    pw = put(sd[f"{pre}embeddings.patch_embedding.weight"])
    patch = pw.permute(2, 3, 1, 0).reshape(P * P * pw.shape[1], pw.shape[0]).contiguous()

    def top_ln(name):
        return {"scale": put(sd[f"{pre}{name}.weight"]),
                "bias": put(sd[f"{pre}{name}.bias"])}

    return {
        "class_embedding": put(sd[f"{pre}embeddings.class_embedding"]),
        "patch_embedding": patch,
        "position_embedding": put(sd[f"{pre}embeddings.position_embedding.weight"]),
        # HF misspells this attribute as pre_layrnorm
        "pre_layernorm": top_ln("pre_layrnorm"),
        "post_layernorm": top_ln("post_layernorm"),
        "layers": layers,
    }


def load_nested_clip(clip_dir: str, vq_cfg: VQGANConfig, device="cuda"):
    """Load the reference layout's nested CLIP checkpoint dir (named by the
    YAML's ddconfig.encoder_name). Returns (vq_cfg with its `clip`
    sub-config replaced by the dir's config.json, the CLIP tree). The
    config may be a full CLIPConfig (vision half under "vision_config")
    or a bare CLIPVisionConfig; text_model.* weights are ignored."""
    with open(Path(clip_dir) / "config.json") as f:
        d = json.load(f)
    clip_cfg = CLIPVisionConfig.from_dict(d.get("vision_config", d))
    vq_cfg = dataclasses.replace(vq_cfg, clip=clip_cfg)
    sd = load_torch_state_dict(clip_dir)
    return vq_cfg, convert_clip_state_dict(sd, clip_cfg, device)


# ---------------------------------------------------------------------------
# VQGAN conversion
# ---------------------------------------------------------------------------

def _conv(sd, name, put: Put):
    w = put(sd[f"{name}.weight"])
    if w.ndim == 4:
        w = w.permute(2, 3, 1, 0).contiguous()     # OIHW -> HWIO
    return {"w": w, "b": put(sd[f"{name}.bias"])}


def _gn(sd, name, put: Put):
    return {"scale": put(sd[f"{name}.weight"]), "bias": put(sd[f"{name}.bias"])}


def _resnet(sd, name, put: Put):
    p = {"norm1": _gn(sd, f"{name}.norm1", put), "conv1": _conv(sd, f"{name}.conv1", put),
         "norm2": _gn(sd, f"{name}.norm2", put), "conv2": _conv(sd, f"{name}.conv2", put)}
    if f"{name}.nin_shortcut.weight" in sd:
        p["nin_shortcut"] = _conv(sd, f"{name}.nin_shortcut", put)
    return p


def _attn(sd, name, put: Put):
    return {"norm": _gn(sd, f"{name}.norm", put),
            **{n: _conv(sd, f"{name}.{n}", put) for n in ("q", "k", "v", "proj_out")}}


def convert_vqgan_encoder(sd: Dict[str, np.ndarray], cfg: VQGANConfig,
                          device="cuda") -> Dict[str, Any]:
    """taming conv Encoder state dict (keys under 'encoder.') -> the conv
    encoder tree on `device`, fp32."""
    from libra_tpu_torch.models.vqgan import encoder_plan

    put = _putter(device, torch.float32)
    levels, _ = encoder_plan(cfg)
    enc: Dict[str, Any] = {
        "conv_in": _conv(sd, "encoder.conv_in", put),
        "mid_block_1": _resnet(sd, "encoder.mid.block_1", put),
        "mid_attn_1": _attn(sd, "encoder.mid.attn_1", put),
        "mid_block_2": _resnet(sd, "encoder.mid.block_2", put),
        "norm_out": _gn(sd, "encoder.norm_out", put),
        "conv_out": _conv(sd, "encoder.conv_out", put),
        "down": [],
    }
    for i, lev in enumerate(levels):
        entry: Dict[str, Any] = {"block": [], "attn": []}
        for j in range(cfg.num_res_blocks):
            entry["block"].append(_resnet(sd, f"encoder.down.{i}.block.{j}", put))
            if lev["has_attn"]:
                entry["attn"].append(_attn(sd, f"encoder.down.{i}.attn.{j}", put))
        if lev["has_down"]:
            entry["downsample_conv"] = _conv(sd, f"encoder.down.{i}.downsample.conv", put)
        enc["down"].append(entry)
    return enc


def convert_vqgan_state_dict(sd: Dict[str, np.ndarray], cfg: VQGANConfig,
                             clip_params: Optional[Any] = None,
                             device="cuda") -> Dict[str, Any]:
    """Reference VQModel state dict (vqgan.ckpt's 'state_dict'; loss.*
    keys are ignored) -> the whole VQGAN tree on `device`, fp32: quant and
    post-quant convs, the conv decoder, the conv encoder where the dict
    has one, and the CLIP tower, from encoder.vision_tower.* or given as
    clip_params (a tree already on the device)."""
    from libra_tpu_torch.models.vqgan import decoder_plan

    put = _putter(device, torch.float32)
    levels, _ = decoder_plan(cfg)
    dec: Dict[str, Any] = {
        "conv_in": _conv(sd, "decoder.conv_in", put),
        "mid_block_1": _resnet(sd, "decoder.mid.block_1", put),
        "mid_attn_1": _attn(sd, "decoder.mid.attn_1", put),
        "mid_block_2": _resnet(sd, "decoder.mid.block_2", put),
        "norm_out": _gn(sd, "decoder.norm_out", put),
        "conv_out": _conv(sd, "decoder.conv_out", put),
        "up": [],
    }
    if cfg.norm_first and "decoder.first_norm.weight" in sd:
        dec["first_norm"] = _gn(sd, "decoder.first_norm", put)
    # up[] is in execution order: torch's up[n-1], up[n-2], ..., up[0]
    for lev in levels:
        i = lev["i_level"]
        entry: Dict[str, Any] = {"block": [], "attn": []}
        for j in range(cfg.num_res_blocks + 1):
            entry["block"].append(_resnet(sd, f"decoder.up.{i}.block.{j}", put))
            if lev["has_attn"]:
                entry["attn"].append(_attn(sd, f"decoder.up.{i}.attn.{j}", put))
        if lev["up_scale"] is not None:
            entry["upsample_conv"] = _conv(sd, f"decoder.up.{i}.upsample.conv", put)
        dec["up"].append(entry)

    params: Dict[str, Any] = {
        "quant_conv": _conv(sd, "quant_conv", put),
        "post_quant_conv": _conv(sd, "post_quant_conv", put),
        "decoder": dec,
    }
    if "encoder.conv_in.weight" in sd:   # the conv-encoder tokenizer variant
        params["encoder"] = convert_vqgan_encoder(sd, cfg, device)
    if clip_params is None:
        tower = "encoder.vision_tower."
        clip_sd = {k[len(tower):]: v for k, v in sd.items() if k.startswith(tower)}
        if clip_sd:
            clip_params = convert_clip_state_dict(clip_sd, cfg.clip, device)
    if clip_params is not None:
        params["clip"] = clip_params
    return params


# ---------------------------------------------------------------------------
# Training state: save and restore
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def _plain(x: Any) -> Any:
    """A state (NamedTuples, dicts, lists of tensors and numbers) as
    dicts, lists, tensors and numbers: what torch.load(weights_only=True)
    reads back."""
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach()
    return x


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> Path:
    """Write `state` (a TrainState, an EMAState or any tree of tensors and
    numbers) to path/step_{step}/state.pt (path/state/ without a step) in
    torch's format: the parameters, the optimizer's moments and counts,
    and the step. The directory is written under a temporary name and
    renamed, so a crash never leaves a partial step_* behind."""
    root = Path(path).absolute()
    root.mkdir(parents=True, exist_ok=True)
    final = root / (f"step_{step}" if step is not None else "state")
    tmp = root / f".{final.name}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(_plain(state), tmp / STATE_FILE)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _restore(saved: Any, target: Any, where: str) -> Any:
    if isinstance(target, tuple) and hasattr(target, "_asdict"):
        fields = target._asdict()
        if not isinstance(saved, dict) or set(saved) != set(fields):
            raise ValueError(f"checkpoint {where or '/'}: fields "
                             f"{sorted(saved) if isinstance(saved, dict) else saved!r}"
                             f", target {sorted(fields)}")
        return type(target)(**{k: _restore(saved[k], v, f"{where}/{k}")
                               for k, v in fields.items()})
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            got = sorted(saved) if isinstance(saved, dict) else type(saved).__name__
            raise ValueError(f"checkpoint {where or '/'}: keys {got}, target "
                             f"{sorted(target)}")
        return {k: _restore(saved[k], v, f"{where}/{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise ValueError(f"checkpoint {where}: a list of another length")
        return type(target)(_restore(s, t, f"{where}/{i}")
                            for i, (s, t) in enumerate(zip(saved, target)))
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else saved
            raise ValueError(f"checkpoint {where}: shape {got}, target "
                             f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(saved, torch.Tensor) or (target is None) != (saved is None):
        raise ValueError(f"checkpoint {where}: {type(saved).__name__}, target "
                         f"{type(target).__name__}")
    return saved


def restore_checkpoint(path: str, target: Any, step: Optional[int] = None) -> Any:
    """The state saved under path/step_{step} (path/state without a step),
    read into `target`'s structure: every tensor is copied into the
    target's tensor (its device and dtype; no second copy on the device),
    numbers (the step, the optimizer's count) come from the file. Raises
    ValueError where a key path or a shape differs from the target's, as
    Orbax's restore against a target does."""
    d = Path(path).absolute() / (f"step_{step}" if step is not None else "state")
    saved = torch.load(d / STATE_FILE, map_location="cpu", weights_only=True,
                       mmap=True)
    return _restore(saved, target, "")
