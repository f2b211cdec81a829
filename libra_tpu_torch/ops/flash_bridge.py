"""Bridged flash attention forward: the prompt pass's attention.

Computes what the Pallas TPU kernel
``libra_tpu/ops/pallas/flash_bridge.py::_fwd_impl`` computes:

    S   = (Q K^T) * scale + cross * (Q Kb^T) * scale + bias
    A   = softmax(max(S, BIG_NEG))                  (fp32)
    out = A V + (A * cross) Vb,   cross[q, k] = flag_q != flag_kv

On a CUDA tensor `flash_bridged_attention` launches the hand-written
Hopper kernel in ``csrc/flash_bridge.cu`` (built with nvcc into a shared
library at first use, bound with ctypes) or raises. On a CPU tensor it
runs `flash_bridged_attention_plain`, the same function in plain torch.
Forward only: the backward lands with training (ROADMAP A11, kernel B4).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops.attention import BIG_NEG

SOURCE = _build.CSRC / "flash_bridge.cu"
HEAD_DIM = 128     # libra-11b's; the kernel is built for it alone


def flash_bridged_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kb: Optional[torch.Tensor],
                                  vb: Optional[torch.Tensor],
                                  flag_q: torch.Tensor, flag_kv: torch.Tensor,
                                  bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: scores, softmax and value
    products in fp32 from the given inputs; output in q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
    if kb is not None:
        cross = (flag_q[:, None, :, None] != flag_kv[:, None, None, :]).float()
        s = s + cross * (torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale)
    s = torch.clamp_min(s + bias.float(), BIG_NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)                      # (B, H, Nq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    if kb is not None:
        o = o + torch.einsum("bhqk,bkhd->bqhd", p * cross, vb.float())
    return (o / denom.permute(0, 2, 1, 3)).to(q.dtype)


_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.POINTER(ctypes.c_longlong),)
             + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p))


def _check(q, k, v, kb, vb, flag_q, flag_kv, bias):
    tensors = [t for t in (q, k, v, kb, vb, flag_q, flag_kv, bias)
               if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_bridged_attention: all inputs must be on one device")
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash_bridged_attention has no backward yet (ROADMAP A11, B4)")
    if (kb is None) != (vb is None):
        raise ValueError("kb and vb must both be given or both be None")
    B, Nq, H, d = q.shape
    Nk = k.shape[1]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_bridged_attention: the kernel takes bfloat16, "
                        f"not {q.dtype}")
    if d != HEAD_DIM:
        raise ValueError(f"flash_bridged_attention: the kernel takes head dim "
                         f"{HEAD_DIM}, not {d}")
    for t in (k, v, kb, vb):
        if t is None:
            continue
        if t.shape != (B, Nk, H, d) or t.dtype != q.dtype:
            raise ValueError("k/v/kb/vb must be (B, Nk, H, d) in q's dtype")
    for t in (q, k, v, kb, vb, bias):
        if t is not None and t.stride(-1) != 1:
            raise ValueError("the last dim of every operand must be unit-stride")
    if Nk < 1 or flag_q.shape != (B, Nq) or flag_kv.shape != (B, Nk):
        raise ValueError("flag_q must be (B, Nq) and flag_kv (B, Nk), Nk >= 1")
    if bias.shape != (B, 1, Nq, Nk) or bias.dtype != torch.float32:
        raise ValueError("bias must be a (B, 1, Nq, Nk) float32 tensor")


def flash_bridged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kb: Optional[torch.Tensor],
                            vb: Optional[torch.Tensor],
                            flag_q: torch.Tensor, flag_kv: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """q (B, Nq, H, d); k/v/kb/vb (B, Nk, H, d), kb/vb None without the
    bridge; flag_q (B, Nq), flag_kv (B, Nk) bool; bias (B, 1, Nq, Nk)
    additive fp32. Returns (B, Nq, H, d) in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bfloat16, d == HEAD_DIM, any strides with a unit-stride last dim)
    and add one to `flash_bridged_attention.launches`."""
    if q.device.type == "cpu":
        return flash_bridged_attention_plain(q, k, v, kb, vb, flag_q,
                                             flag_kv, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bridged_attention: no kernel for {q.device}")
    _check(q, k, v, kb, vb, flag_q, flag_kv, bias)
    B, Nq, H, d = q.shape
    Nk = k.shape[1]
    fq = flag_q.to(torch.uint8).contiguous()
    fk = flag_kv.to(torch.uint8).contiguous()
    out = torch.empty((B, Nq, H, d), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, kb, vb):
        strides += [0, 0, 0] if t is None else [t.stride(0), t.stride(1), t.stride(2)]
    strides += [bias.stride(0), bias.stride(2)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = _build.function(SOURCE, "flash_bridge_fwd", _ARGTYPES)(
        ptr(q), ptr(k), ptr(v), ptr(kb), ptr(vb), ptr(fq), ptr(fk),
        ptr(bias), ptr(out), (ctypes.c_longlong * 17)(*strides),
        B, Nq, Nk, H, 1.0 / (d ** 0.5), _build.stream(q))
    _build.check_launch(status, "flash_bridge_fwd")
    flash_bridged_attention.launches += 1
    return out


flash_bridged_attention.launches = 0
