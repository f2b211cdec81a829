"""CLIP ViT vision encoder (ViT-L/14-336 for Libra), plain PyTorch.

The stride-14 patch conv is a reshape plus one matmul; only the layers
needed for the feature tap run; the CLS token is dropped and the features
reshaped to a (g, g) square. CLIP's attention is plain torch, as XLA runs
it in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from libra_tpu_torch.config import CLIPVisionConfig

Params = Dict[str, Any]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _layer_norm(x: torch.Tensor, p: Params, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def init_params(gen: torch.Generator, cfg: CLIPVisionConfig,
                device="cuda", dtype=torch.float32) -> Params:
    """Random-init tree with the JAX tree's key paths and shapes; layer
    leaves stacked on axis 0. `gen` must live on `device`."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    P = cfg.patch_size

    def randn(shape, std):
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (x * std).to(dtype)

    def dense(d_in, d_out):
        return {"w": randn((L, d_in, d_out), d_in ** -0.5),
                "b": torch.zeros((L, d_out), dtype=dtype, device=device)}

    def ln(*lead):
        return {"scale": torch.ones(lead + (D,), dtype=dtype, device=device),
                "bias": torch.zeros(lead + (D,), dtype=dtype, device=device)}

    layers = {"ln1": ln(L), "ln2": ln(L),
              "q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
              "o": dense(D, D), "fc1": dense(D, I), "fc2": dense(I, D)}
    return {
        "class_embedding": randn((D,), 0.02),
        # patch embedding stored flattened: (P*P*3, D), matmul form
        "patch_embedding": randn((P * P * 3, D), 0.02),
        "position_embedding": randn((cfg.num_patches + 1, D), 0.02),
        "pre_layernorm": ln(),
        "post_layernorm": ln(),
        "layers": layers,
    }


def embed_patches(params: Params, cfg: CLIPVisionConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, H, W, 3) NHWC normalized -> (B, 1 + N, D) with CLS + pos."""
    B, H, W, C = pixels.shape
    P = cfg.patch_size
    gh, gw = H // P, W // P
    x = pixels.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, P * P * C)
    emb = x @ params["patch_embedding"].to(x.dtype)               # (B, N, D)
    cls = params["class_embedding"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    h = torch.cat([cls, emb], dim=1)
    return h + params["position_embedding"].to(x.dtype)


def _encoder_layer(p: Params, cfg: CLIPVisionConfig, h: torch.Tensor) -> torch.Tensor:
    Hn, d = cfg.num_attention_heads, cfg.head_dim
    B, N, D = h.shape
    eps = cfg.layer_norm_eps

    def dense(x, name):
        return x @ p[name]["w"] + p[name]["b"]

    x = _layer_norm(h, p["ln1"], eps)
    q = dense(x, "q").reshape(B, N, Hn, d)
    k = dense(x, "k").reshape(B, N, Hn, d)
    v = dense(x, "v").reshape(B, N, Hn, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d ** -0.5)
    a = torch.softmax(s.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, N, D)
    h = h + dense(o, "o")
    x = quick_gelu(dense(_layer_norm(h, p["ln2"], eps), "fc1"))
    return h + dense(x, "fc2")


def forward_features(params: Params, cfg: CLIPVisionConfig,
                     pixels: torch.Tensor, select_layer=-2,
                     square_output: bool = True) -> torch.Tensor:
    """Run the tower up to the tapped hidden state(s). HF's hidden_states
    tuple has num_layers + 1 entries (embeddings first), so index s < 0
    taps the output of layer num_layers + s + 1. An iterable of indices
    channel-concatenates the taps. CLS dropped; optionally reshaped to a
    (B, g, g, C) square."""
    L = cfg.num_hidden_layers
    sel = (select_layer,) if isinstance(select_layer, int) else tuple(select_layer)
    taps = []
    for s in sel:
        n = L + s + 1 if s < 0 else s
        if not 0 < n <= L:
            raise ValueError(f"select_layer {s} out of range")
        taps.append(n)

    h = embed_patches(params, cfg, pixels)
    h = _layer_norm(h, params["pre_layernorm"], cfg.layer_norm_eps)
    outs = {}
    for i in range(max(taps)):
        layer = {name: {k: t[i] for k, t in leaf.items()}
                 for name, leaf in params["layers"].items()}
        h = _encoder_layer(layer, cfg, h)
        if i + 1 in taps:
            outs[i + 1] = h
    feats = torch.cat([outs[n] for n in taps], dim=-1)[:, 1:]   # drop CLS
    if square_output:
        B, N, D = feats.shape
        g = int(N ** 0.5)
        if g * g != N:
            raise ValueError(f"{N} patches do not form a square")
        feats = feats.reshape(B, g, g, D)
    return feats
