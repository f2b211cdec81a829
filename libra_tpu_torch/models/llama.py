"""Text-only LLaMA decoder family.

The PyTorch counterpart of ``libra_tpu/models/llama.py``: a standard
pre-norm decoder with RoPE attention and a SwiGLU MLP, built from the
same pieces as the Libra decoder (``ops/norm``, ``ops/rope``,
``ops/attention``) over the same kind of tree (layer leaves stacked on
axis 0, weights stored for ``x @ W``). Used for text-only LM serving and
as the import target for plain LLaMA (HF) and Meta checkpoints
(``convert_hf_llama_state_dict``, ``checkpoint.convert_meta_llama_state_dict``).

Attention: ``attn_impl="auto"`` takes the flash-bridge kernels on CUDA
tensors, with no bridge and every modality flag False (the forward
kernel, and under autograd the backward kernel through ``_FlashBridge``),
and the plain ``bridged_attention`` on the CPU, as the training loss
resolves it (``ops.flash_bridge.resolve_attn_impl``). A CUDA tensor the
kernel refuses (a dtype other than bf16, a head dim other than 128) makes
the call raise; there is no fallback.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.ops.attention import bridged_attention, causal_bias
from libra_tpu_torch.ops.flash_bridge import (flash_bridged_attention,
                                              resolve_attn_impl)
from libra_tpu_torch.ops.norm import rms_norm
from libra_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from libra_tpu_torch.params import from_numpy_tree

Params = Dict[str, Any]

PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")
NORMS = ("input_layernorm", "post_attention_layernorm")


def init_params(gen: torch.Generator, cfg: LibraConfig, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random-init tree with libra_tpu's key paths and shapes: normal
    (std initializer_range) weights drawn in fp32 from `gen` (which must
    live on `device`) and cast to `dtype` (cfg.params_dtype when None);
    the norms are ones."""
    D, I, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_hidden_layers)
    dtype = dtype or cfg.params_dtype

    def w(*shape):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (x * cfg.initializer_range).to(dtype)

    shapes = {"q_proj": (D, D), "k_proj": (D, D), "v_proj": (D, D),
              "o_proj": (D, D), "gate_proj": (D, I), "up_proj": (D, I),
              "down_proj": (I, D)}
    embed = w(V, D)
    layers = {name: w(L, *shapes[name]) for name in PROJECTIONS}
    layers.update({name: torch.ones((L, D), dtype=dtype, device=device)
                   for name in NORMS})
    return {"embed_tokens": embed, "layers": layers,
            "norm": torch.ones((D,), dtype=dtype, device=device),
            "lm_head": w(D, V)}


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, h, D // h)


def _layer(p: Params, cfg: LibraConfig, h, cos, sin, position_ids, bias,
           attn_impl: str) -> torch.Tensor:
    eps, H = cfg.rms_norm_eps, cfg.num_attention_heads
    cd = h.dtype
    hn = rms_norm(h, p["input_layernorm"], eps)
    q = apply_rope(_heads(hn @ p["q_proj"].to(cd), H), cos, sin, position_ids)
    k = apply_rope(_heads(hn @ p["k_proj"].to(cd), H), cos, sin, position_ids)
    v = _heads(hn @ p["v_proj"].to(cd), H)
    flag = torch.zeros(hn.shape[:2], dtype=torch.bool, device=h.device)
    attend = flash_bridged_attention if attn_impl == "flash" else bridged_attention
    out = attend(q, k, v, None, None, flag, flag, bias)
    h = h + out.reshape(h.shape) @ p["o_proj"].to(cd)
    hn = rms_norm(h, p["post_attention_layernorm"], eps)
    mlp = (F.silu(hn @ p["gate_proj"].to(cd))
           * (hn @ p["up_proj"].to(cd))) @ p["down_proj"].to(cd)
    return h + mlp


def forward_hidden(params: Params, cfg: LibraConfig, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None,
                   position_ids: Optional[torch.Tensor] = None,
                   remat: bool = False, attn_impl: str = "auto") -> torch.Tensor:
    """input_ids: (B, N) -> final-norm hidden states (B, N, D).

    attention_mask None means all ones; position_ids None means
    cumsum(mask) - 1 with padded positions at 1. remat: each layer under
    torch.utils.checkpoint (non-reentrant), its backward re-running the
    layer from its input (the forward kernel twice a layer)."""
    B, N = input_ids.shape
    device = input_ids.device
    if attention_mask is None:
        attention_mask = torch.ones((B, N), dtype=torch.int32, device=device)
    if position_ids is None:
        pos = torch.cumsum(attention_mask.long(), dim=-1) - 1
        position_ids = torch.where(attention_mask == 0, torch.ones_like(pos), pos)
    impl = resolve_attn_impl(attn_impl, device)
    cos, sin = rope_cos_sin(max(cfg.max_position_embeddings, N), cfg.head_dim,
                            cfg.rope_theta, device=device)
    bias = causal_bias(attention_mask, N, N)
    h = params["embed_tokens"][input_ids].to(cfg.compute_dtype)
    # one unbind a leaf: its backward stacks the L layer gradients once,
    # where w[i] a layer would give each layer's gradient a zero-filled
    # (L, ...) tensor and add it into the leaf's (L times the leaf's bytes)
    layers = {k: w.unbind(0) for k, w in params["layers"].items()}
    for i in range(cfg.num_hidden_layers):
        p = {k: w[i] for k, w in layers.items()}
        if remat:
            h = checkpoint(_layer, p, cfg, h, cos, sin, position_ids, bias, impl,
                           use_reentrant=False)
        else:
            h = _layer(p, cfg, h, cos, sin, position_ids, bias, impl)
    return rms_norm(h, params["norm"], cfg.rms_norm_eps)


def forward(params: Params, cfg: LibraConfig, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None,
            position_ids: Optional[torch.Tensor] = None,
            remat: bool = False, attn_impl: str = "auto") -> torch.Tensor:
    """input_ids: (B, N) -> logits (B, N, V) in the compute dtype."""
    h = forward_hidden(params, cfg, input_ids, attention_mask, position_ids,
                       remat, attn_impl)
    return torch.einsum("bnd,dv->bnv", h, params["lm_head"].to(h.dtype))


def sequence_classification_logits(
        params: Params, cfg: LibraConfig, input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        attn_impl: str = "auto") -> torch.Tensor:
    """(B, num_labels) pooled at index sum(attention_mask) - 1 of each row
    (its last non-pad token when the row is right-padded; N - 1 without a
    mask), as libra_tpu pools. params need an extra 'score' head of shape
    (D, num_labels) (the reference's LlamaForSequenceClassification)."""
    h = forward_hidden(params, cfg, input_ids, attention_mask,
                       attn_impl=attn_impl)
    logits = torch.einsum("bnd,dc->bnc", h, params["score"].to(h.dtype))
    B, N = input_ids.shape
    if attention_mask is None:
        last = torch.full((B,), N - 1, dtype=torch.long, device=h.device)
    else:
        last = (attention_mask.long().sum(dim=-1) - 1).clamp_min(0)
    return logits[torch.arange(B, device=h.device), last]


def convert_hf_llama_state_dict(sd: Dict[str, np.ndarray], cfg: LibraConfig,
                                device="cuda") -> Params:
    """HF LlamaForCausalLM state dict (numpy) -> this tree on `device` in
    cfg.params_dtype: each tensor goes to the device as it is read, and
    the per-layer stacking and the (out, in) -> (in, out) transposes run
    there."""
    L = cfg.num_hidden_layers

    def put(a) -> torch.Tensor:
        return from_numpy_tree(a, device, cfg.params_dtype)

    def stacked(name: str, transpose: bool = True) -> torch.Tensor:
        x = torch.stack([put(sd[name.format(i=i)]) for i in range(L)])
        return x.transpose(-1, -2).contiguous() if transpose else x

    a, m = "model.layers.{i}.self_attn", "model.layers.{i}.mlp"
    layers = {n: stacked(f"{a}.{n}.weight") for n in PROJECTIONS[:4]}
    layers.update({n: stacked(f"{m}.{n}.weight") for n in PROJECTIONS[4:]})
    layers.update({n: stacked(f"model.layers.{{i}}.{n}.weight", transpose=False)
                   for n in NORMS})
    return {"embed_tokens": put(sd["model.embed_tokens.weight"]),
            "layers": layers,
            "norm": put(sd["model.norm.weight"]),
            "lm_head": put(sd["lm_head.weight"]).transpose(0, 1).contiguous()}
