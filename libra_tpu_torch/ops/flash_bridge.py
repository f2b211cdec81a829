"""Bridged flash attention: the prompt pass's and the training step's
attention, forward and backward.

Computes what the Pallas TPU kernels
``libra_tpu/ops/pallas/flash_bridge.py::_fwd_impl`` and ``::_bwd_impl``
compute:

    S   = (Q K^T) * scale + cross * (Q Kb^T) * scale + bias
    A   = softmax(max(S, BIG_NEG))                  (fp32)
    out = A V + (A * cross) Vb,   cross[q, k] = flag_q != flag_kv

and its gradients in q, k, v, kb and vb. The bias gradient is zero by
contract (the bias derives from the integer attention mask everywhere),
the flags have none, and a fully masked query row (every score clamped to
BIG_NEG) gets a zero score gradient, as in the TPU kernel.

On a CUDA tensor `flash_bridged_attention` launches the hand-written
Hopper kernels (``csrc/flash_bridge.cu`` forward, ``csrc/flash_bridge_bwd.cu``
backward; built with nvcc into shared libraries at first use, bound with
ctypes) or raises. On a CPU tensor it runs the plain versions,
`flash_bridged_attention_plain` and `flash_bridged_attention_bwd_plain`.
When an input requires grad, the call goes through `_FlashBridge`, an
autograd Function whose forward also keeps each row's softmax max and
denominator for the backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops.attention import BIG_NEG

SOURCE = _build.CSRC / "flash_bridge.cu"
BWD_SOURCE = _build.CSRC / "flash_bridge_bwd.cu"
HEAD_DIM = 128     # libra-11b's; the kernels are built for it alone


def _f(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, the kernels' arithmetic (fp64 stays fp64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _cross(flag_q: torch.Tensor, flag_kv: torch.Tensor, like: torch.Tensor):
    """(B, 1, Nq, Nk) cross-modality mask in {0, 1}, in like's dtype."""
    return (flag_q[:, None, :, None] != flag_kv[:, None, None, :]).to(like.dtype)


def _probs(q, k, kb, flag_q, flag_kv, bias):
    """Unnormalised probabilities exp(s - m), the row max m of the scores
    s (clamped to BIG_NEG) and the row sums, from fp32 copies of the
    inputs (the kernels' math)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = _f(q)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, _f(k)) * scale
    if kb is not None:
        s = s + _cross(flag_q, flag_kv, s) * (
            torch.einsum("bqhd,bkhd->bhqk", qf, _f(kb)) * scale)
    s = torch.clamp_min(s + _f(bias), BIG_NEG)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e, m, e.sum(dim=-1, keepdim=True)


def flash_bridged_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kb: Optional[torch.Tensor],
                                  vb: Optional[torch.Tensor],
                                  flag_q: torch.Tensor, flag_kv: torch.Tensor,
                                  bias: torch.Tensor) -> torch.Tensor:
    """The forward kernel's function in plain torch: scores, softmax and
    value products in fp32 from the given inputs, with the unnormalised
    probabilities p and p * cross rounded to v's and vb's dtype before the
    value products, as the TPU kernel does (flash_bridge.py:100-107); the
    denominator sums the unrounded p. Output in q's dtype."""
    p, _, denom = _probs(q, k, kb, flag_q, flag_kv, bias)   # denom (B, H, Nq, 1)
    o = torch.einsum("bhqk,bkhd->bqhd", _f(p.to(v.dtype)), _f(v))
    if kb is not None:
        px = p * _cross(flag_q, flag_kv, p)
        o = o + torch.einsum("bhqk,bkhd->bqhd", _f(px.to(vb.dtype)), _f(vb))
    return (o / denom.permute(0, 2, 1, 3)).to(q.dtype)


def flash_bridged_attention_bwd_plain(q, k, v, kb, vb, flag_q, flag_kv, bias,
                                      out, do) -> Tuple:
    """The TPU backward kernel's math (flash_bridge.py:187-251) in plain
    torch: the probabilities recomputed in fp32, ds = p (dp - rowsum(do o)),
    zero on fully masked rows; ds and p rounded to q's dtype before the
    gradient products, which sum in fp32. Returns (dq, dk, dv, dkb, dvb):
    dq in q's dtype, the rest in k's; dkb, dvb None without the bridge."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    e, m, denom = _probs(q, k, kb, flag_q, flag_kv, bias)
    p = e / denom                                             # (B, H, Nq, Nk)
    dof = _f(do)
    rowsum = (dof * _f(out)).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, _f(v))
    if kb is not None:
        cross = _cross(flag_q, flag_kv, p)
        dp = dp + cross * torch.einsum("bqhd,bkhd->bhqk", dof, _f(vb))
    ds = p * (dp - rowsum) * (m > BIG_NEG).to(p.dtype)

    def rnd(x):           # the kernel's cast to the operand dtype
        return _f(x.to(q.dtype))

    qf = _f(q)
    ds_b, p_b = rnd(ds), rnd(p)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_b, _f(k)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_b, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_b, dof)
    dkb = dvb = None
    if kb is not None:
        dsx_b, px_b = rnd(ds * cross), rnd(p * cross)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", dsx_b, _f(kb)) * scale
        dkb = (torch.einsum("bhqk,bqhd->bkhd", dsx_b, qf) * scale).to(kb.dtype)
        dvb = torch.einsum("bhqk,bqhd->bkhd", px_b, dof).to(vb.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dkb, dvb


_FWD_ARGTYPES = ((ctypes.c_void_p,) * 11 + (ctypes.POINTER(ctypes.c_longlong),)
                 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p))
_BWD_ARGTYPES = ((ctypes.c_void_p,) * 18 + (ctypes.POINTER(ctypes.c_longlong),)
                 + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p))


def _check(q, k, v, kb, vb, flag_q, flag_kv, bias):
    tensors = [t for t in (q, k, v, kb, vb, flag_q, flag_kv, bias)
               if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_bridged_attention: all inputs must be on one device")
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
    _check_aligned(q, k, v, kb, vb)
    if Nk < 1 or flag_q.shape != (B, Nq) or flag_kv.shape != (B, Nk):
        raise ValueError("flag_q must be (B, Nq) and flag_kv (B, Nk), Nk >= 1")
    if bias.shape != (B, 1, Nq, Nk) or bias.dtype != torch.float32:
        raise ValueError("bias must be a (B, 1, Nq, Nk) float32 tensor")


def _check_aligned(*tensors):
    """The kernels copy operand rows in 16-byte pieces (cp.async): each
    base must be 16-byte aligned and its b, n and h strides multiples of
    8 elements."""
    for t in tensors:
        if t is not None and (t.data_ptr() % 16
                              or any(st % 8 for st in t.stride()[:3])):
            raise ValueError("flash_bridged_attention: the kernels take operands "
                             "whose base is 16-byte aligned and whose b, n and h "
                             "strides are multiples of 8 elements; pass a "
                             "contiguous tensor")


def _check_bwd(q, k, v, kb, vb, flag_q, flag_kv, bias, out, do, m, l):
    _check(q, k, v, kb, vb, flag_q, flag_kv, bias)
    for t in (out, do):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise TypeError("out and do must be (B, Nq, H, d) in q's dtype")
        if t.stride(-1) != 1:
            raise ValueError("the last dim of out and do must be unit-stride")
    _check_aligned(out, do)
    B, Nq, H, _ = q.shape
    for t in (m, l):
        if (t is None or t.shape != (B, H, Nq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("the backward kernel takes the forward's row max "
                             "and denominator, contiguous fp32 (B, H, Nq)")


def _strides(*tensors):
    out = []
    for t in tensors:
        out += [0, 0, 0] if t is None else [t.stride(0), t.stride(1), t.stride(2)]
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, kb, vb, flag_q, flag_kv, bias, stats: bool):
    """The forward kernel; with stats also each row's fp32 max and softmax
    denominator, (B, H, Nq) each. Returns (out, (m, l) or ())."""
    _check(q, k, v, kb, vb, flag_q, flag_kv, bias)
    B, Nq, H, d = q.shape
    Nk = k.shape[1]
    fq = flag_q.to(torch.uint8).contiguous()
    fk = flag_kv.to(torch.uint8).contiguous()
    out = torch.empty((B, Nq, H, d), dtype=q.dtype, device=q.device)
    m = l = None
    if stats:
        m = torch.empty((B, H, Nq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    strides = _strides(q, k, v, kb, vb) + [bias.stride(0), bias.stride(2)]
    status = _build.function(SOURCE, "flash_bridge_fwd", _FWD_ARGTYPES)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(kb), _ptr(vb), _ptr(fq), _ptr(fk),
        _ptr(bias), _ptr(out), _ptr(m), _ptr(l),
        (ctypes.c_longlong * 17)(*strides),
        B, Nq, Nk, H, 1.0 / (d ** 0.5), _build.stream(q))
    _build.check_launch(status, "flash_bridge_fwd")
    flash_bridged_attention.launches += 1
    return out, ((m, l) if stats else ())


def _forward(q, k, v, kb, vb, flag_q, flag_kv, bias, stats: bool):
    """Dispatch on q's device: (out, softmax stats for the backward; empty
    on the CPU, whose plain backward recomputes them)."""
    if q.device.type == "cpu":
        return flash_bridged_attention_plain(q, k, v, kb, vb, flag_q, flag_kv,
                                             bias), ()
    if q.device.type != "cuda":
        raise ValueError(f"flash_bridged_attention: no kernel for {q.device}")
    return _launch_fwd(q, k, v, kb, vb, flag_q, flag_kv, bias, stats)


def flash_bridged_attention_bwd(q, k, v, kb, vb, flag_q, flag_kv, bias, out,
                                do, m=None, l=None) -> Tuple:
    """(dq, dk, dv, dkb, dvb) of the forward at these inputs for the output
    cotangent `do`. CPU tensors take the plain version. CUDA tensors launch
    the backward kernel with the forward kernel's row max `m` and
    denominator `l` and add one to `flash_bridged_attention_bwd.launches`."""
    if q.device.type == "cpu":
        return flash_bridged_attention_bwd_plain(q, k, v, kb, vb, flag_q,
                                                 flag_kv, bias, out, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bridged_attention_bwd: no kernel for {q.device}")
    do = do.contiguous()
    _check_bwd(q, k, v, kb, vb, flag_q, flag_kv, bias, out, do, m, l)
    B, Nq, H, d = q.shape
    Nk = k.shape[1]
    fq = flag_q.to(torch.uint8).contiguous()
    fk = flag_kv.to(torch.uint8).contiguous()
    delta = torch.empty_like(m)
    dq = torch.empty((B, Nq, H, d), dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((B, Nk, H, d), dtype=k.dtype, device=q.device)
              for _ in range(2))
    dkb = dvb = None
    if kb is not None:
        dkb, dvb = torch.empty_like(dk), torch.empty_like(dk)
    strides = (_strides(q, k, v, kb, vb, out, do)
               + [bias.stride(0), bias.stride(2)])
    status = _build.function(BWD_SOURCE, "flash_bridge_bwd", _BWD_ARGTYPES)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(kb), _ptr(vb), _ptr(out), _ptr(do),
        _ptr(fq), _ptr(fk), _ptr(bias), _ptr(m), _ptr(l), _ptr(delta),
        _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dkb), _ptr(dvb),
        (ctypes.c_longlong * 23)(*strides),
        B, Nq, Nk, H, 1.0 / (d ** 0.5), _build.stream(q))
    _build.check_launch(status, "flash_bridge_bwd")
    flash_bridged_attention_bwd.launches += 1
    return dq, dk, dv, dkb, dvb


class _FlashBridge(torch.autograd.Function):
    """Differentiable in q, k, v, kb, vb; no gradient for the flags and a
    zero (None) one for the bias, by contract."""

    @staticmethod
    def forward(ctx, q, k, v, kb, vb, flag_q, flag_kv, bias):
        out, stats = _forward(q, k, v, kb, vb, flag_q, flag_kv, bias, stats=True)
        ctx.save_for_backward(q, k, v, kb, vb, flag_q, flag_kv, bias, out, *stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kb, vb, flag_q, flag_kv, bias, out, *stats = ctx.saved_tensors
        grads = flash_bridged_attention_bwd(q, k, v, kb, vb, flag_q, flag_kv,
                                            bias, out, do, *stats)
        return (*grads, None, None, None)


def flash_bridged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kb: Optional[torch.Tensor],
                            vb: Optional[torch.Tensor],
                            flag_q: torch.Tensor, flag_kv: torch.Tensor,
                            bias: torch.Tensor) -> torch.Tensor:
    """q (B, Nq, H, d); k/v/kb/vb (B, Nk, H, d), kb/vb None without the
    bridge; flag_q (B, Nq), flag_kv (B, Nk) bool; bias (B, 1, Nq, Nk)
    additive fp32. Returns (B, Nq, H, d) in q's dtype.

    CPU tensors take the plain versions. CUDA tensors launch the kernels
    (bfloat16, d == HEAD_DIM, a unit-stride last dim, 16-byte aligned
    bases and b/n/h strides that are multiples of 8 elements);
    each forward launch adds one to `flash_bridged_attention.launches`.
    Differentiable in q, k, v, kb and vb when grad is enabled."""
    operands = (q, k, v, kb, vb)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in operands):
        return _FlashBridge.apply(q, k, v, kb, vb, flag_q, flag_kv, bias)
    return _forward(q, k, v, kb, vb, flag_q, flag_kv, bias, stats=False)[0]


def resolve_attn_impl(attn_impl: str, device: torch.device) -> str:
    """"auto" -> the flash kernel (differentiable: forward and backward
    kernels) on CUDA tensors and the plain attention on the CPU."""
    if attn_impl == "auto":
        return "flash" if torch.device(device).type == "cuda" else "plain"
    if attn_impl not in ("flash", "plain"):
        raise ValueError(f"attn_impl must be 'auto', 'flash' or 'plain', "
                         f"not {attn_impl!r}")
    return attn_impl


flash_bridged_attention.launches = 0
flash_bridged_attention_bwd.launches = 0
