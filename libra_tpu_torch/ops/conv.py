"""Convolution and norm primitives of the VQGAN conv stack, NHWC at the
interface (activations (B, H, W, C), weights HWIO (kh, kw, Cin, Cout)),
as in ``libra_tpu/ops/conv.py``.

``conv2d`` hands F.conv2d channels-last views of both operands (no copy),
so the convolution runs on NHWC data and its output permutes back to a
contiguous NHWC tensor.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _same_pads(n: int, k: int, stride: int):
    """XLA's SAME padding along one axis: (low, high), the odd one high."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: int = 1, padding="SAME") -> torch.Tensor:
    """x (B, H, W, Cin), w (kh, kw, Cin, Cout) -> (B, H', W', Cout) in x's
    dtype; padding "SAME" (XLA's: the odd pad at the high end) or
    "VALID"."""
    kh, kw = w.shape[:2]
    xc = x.permute(0, 3, 1, 2)
    pad = (0, 0)
    if padding == "SAME":
        (ht, hb), (wl, wr) = (_same_pads(x.shape[1], kh, stride),
                              _same_pads(x.shape[2], kw, stride))
        if ht == hb and wl == wr:
            pad = (ht, wl)
        else:
            xc = F.pad(xc, (wl, wr, ht, hb))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).to(x.dtype),
                 None if b is None else b.to(x.dtype), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NHWC with fp32 statistics and the population
    variance (taming's Normalize: 32 groups, eps 1e-6); a channel count
    that 32 does not divide (the tiny test configs) takes gcd(32, C)
    groups."""
    B, H, W, C = x.shape
    if C % groups:
        groups = math.gcd(groups, C)
    xf = x.float().reshape(B, H, W, groups, C // groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    centred = xf - mean
    var = (centred * centred).mean(dim=(1, 2, 4), keepdim=True)
    xf = (centred * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    return (xf * scale + bias).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def upsample_indices(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source rows of a nearest upsampling from n_in to n_out:
    floor(arange(n_out) * (n_in / n_out)) in float32, as JAX computes it.
    F.interpolate's nearest mode takes another route to the same floor
    and can land one row lower at a fractional scale."""
    ratio = torch.tensor(n_in / n_out, dtype=torch.float32, device=device)
    return torch.floor(torch.arange(n_out, dtype=torch.float32, device=device)
                       * ratio).long()


def nearest_upsample(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Nearest upsampling of NHWC x by scale_factor (fractional scales
    too: the decoder's level 1 reaches 336 from 192)."""
    B, H, W, C = x.shape
    idx_h = upsample_indices(H, int(H * scale_factor), x.device)
    idx_w = upsample_indices(W, int(W * scale_factor), x.device)
    return x[:, idx_h][:, :, idx_w]


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))
