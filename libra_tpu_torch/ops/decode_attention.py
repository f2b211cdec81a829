"""Bridged decode attention over the head-major int8 KV cache.

Computes what the Pallas TPU kernel
``libra_tpu/ops/pallas/decode_attention.py::int8_decode_attention``
computes, for a few query rows over the whole quantized cache of one
layer:

    s    = (q . k_int) * k_scale / sqrt(d)
         + cross * (q . kb_int) * kb_scale / sqrt(d)
    a    = softmax(max(s + bias, BIG_NEG))                       (fp32)
    out  = (a * v_scale) . v_int + (a * cross * vb_scale) . vb_int

with ``cross[n, s] = flag_q[b, n] != kv_flag[b, s]``. The cache is the
layout of ``models/libra.init_cache(quantized=True)``: int8 (B, H, S, d)
layer views with (B, H, S) fp32 scales.

On a CUDA tensor `int8_decode_attention` launches the hand-written Hopper
kernel in ``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
`int8_decode_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops.flash_bridge import flash_bridged_attention_plain
from libra_tpu_torch.quantization import QuantizedArray

SOURCE = _build.CSRC / "decode_attention.cu"
HEAD_DIM = 128      # libra-11b's; the kernel is built for it alone
_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.POINTER(ctypes.c_longlong),)
             + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p))


def decode_kernel_applicable(cache_k, q_len: int, head_dim: int) -> bool:
    """The kernel takes this step: a quantized cache, q_len <= 8 (decode,
    spec-decode verify) or a multiple of 8 up to 64 (merged-prefill
    windows), and the head dim it is built for."""
    return (isinstance(cache_k, QuantizedArray) and head_dim == HEAD_DIM
            and (1 <= q_len <= 8 or (q_len <= 64 and q_len % 8 == 0)))


def _flags_bias(q, S, flag_q, kv_flag, bias):
    """flag_q (B,) or (B, N) -> (B, N); kv_flag (B, S); bias (B, S) or
    (B, N, S) -> (B, N, S), as broadcast views. Without the bridge the
    flags may be None: all-zero flags stand in (cross is never read)."""
    B, N = q.shape[:2]
    if flag_q is None:
        flag_q = torch.zeros((B,), dtype=torch.bool, device=q.device)
        kv_flag = torch.zeros((B, S), dtype=torch.bool, device=q.device)
    fq = flag_q[:, None] if flag_q.dim() == 1 else flag_q
    bias = bias[:, None, :] if bias.dim() == 2 else bias
    return fq.expand(B, N), kv_flag, bias.expand(B, N, S)


def int8_decode_attention_plain(q, kq, ks, vq, vs, kbq=None, kbs=None,
                                vbq=None, vbs=None, flag_q=None, kv_flag=None,
                                bias=None) -> torch.Tensor:
    """The kernel's function in plain torch: dequantize the cache to fp32,
    then the fp32 bridged softmax of `flash_bridged_attention_plain`."""
    def deq(qv, s):       # head-major (B, H, S, d) -> (B, S, H, d) fp32
        return None if qv is None else \
            (qv.float() * s.float()[..., None]).transpose(1, 2)

    fq, kv_flag, bias = _flags_bias(q, kq.shape[2], flag_q, kv_flag, bias)
    return flash_bridged_attention_plain(
        q, deq(kq, ks), deq(vq, vs), deq(kbq, kbs), deq(vbq, vbs),
        fq, kv_flag, bias.float()[:, None])


def _launch(fn, q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias, out,
            stream) -> int:
    B, N, H, d = q.shape
    S = kq.shape[2]
    strides = [q.stride(0), q.stride(1), q.stride(2),
               kq.stride(0), kq.stride(1), kq.stride(2),
               ks.stride(0), ks.stride(1), bias.stride(0), bias.stride(1)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return fn(ptr(q), ptr(kq), ptr(vq), ptr(kbq), ptr(vbq), ptr(ks), ptr(vs),
              ptr(kbs), ptr(vbs), ptr(fq), ptr(fk), ptr(bias), ptr(out),
              (ctypes.c_longlong * 10)(*strides), B, N, S, H,
              1.0 / (d ** 0.5), stream)


def _check(q, kq, ks, vq, vs, kbq, kbs, vbq, vbs):
    B, N, H, d = q.shape
    if q.dtype != torch.bfloat16 or d != HEAD_DIM or q.stride(-1) != 1:
        raise ValueError(f"int8_decode_attention: the kernel takes bfloat16 q "
                         f"with head dim {HEAD_DIM}, unit-stride, not {q.dtype} "
                         f"{tuple(q.shape)}")
    if not 1 <= N <= 64:
        raise ValueError(f"int8_decode_attention: N={N} query rows; the kernel "
                         f"takes 1 to 64")
    bridge = [kbq, kbs, vbq, vbs]
    if any(t is None for t in bridge) and any(t is not None for t in bridge):
        raise ValueError("the bridge buffers must all be given or all be None")
    caches = [t for t in (kq, vq, kbq, vbq) if t is not None]
    scales = [t for t in (ks, vs, kbs, vbs) if t is not None]
    S = kq.shape[2]
    for t in caches:
        if t.dtype != torch.int8 or t.shape != (B, H, S, d) \
                or t.stride() != kq.stride() or t.device != q.device:
            raise ValueError("k/v/kb/vb must be int8 (B, H, S, d) views of one "
                             "layout on q's device")
    if kq.stride(3) != 1 or kq.stride(2) % 4 or any(t.data_ptr() % 4 for t in caches):
        raise ValueError("the cache rows must be unit-stride and 4-byte aligned")
    for t in scales:
        if t.dtype != torch.float32 or t.shape != (B, H, S) \
                or t.stride() != ks.stride() or t.stride(2) != 1:
            raise ValueError("the scales must be float32 (B, H, S) views of one "
                             "layout, unit-stride in S")


def int8_decode_attention(q, kq, ks, vq, vs, kbq=None, kbs=None, vbq=None,
                          vbs=None, flag_q=None, kv_flag=None,
                          bias=None) -> torch.Tensor:
    """q (B, N, H, d); kq/vq (and kbq/vbq with the bridge) int8 (B, H, S, d)
    with (B, H, S) fp32 scales; flag_q (B,) or (B, N) and kv_flag (B, S)
    bool (only read with the bridge); bias (B, S) or (B, N, S) additive
    fp32. Returns (B, N, H, d) in q's dtype.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (bfloat16 q, d == HEAD_DIM, N <= 64) and add one to
    `int8_decode_attention.launches`."""
    if q.device.type == "cpu":
        return int8_decode_attention_plain(q, kq, ks, vq, vs, kbq, kbs, vbq,
                                           vbs, flag_q, kv_flag, bias)
    if q.device.type != "cuda":
        raise ValueError(f"int8_decode_attention: no kernel for {q.device}")
    _check(q, kq, ks, vq, vs, kbq, kbs, vbq, vbs)
    fq, kv_flag, bias = _flags_bias(q, kq.shape[2], flag_q, kv_flag, bias)
    fq = fq.to(torch.uint8).contiguous()
    fk = kv_flag.to(torch.uint8).contiguous()
    if bias.dtype != torch.float32 or bias.stride(2) != 1:
        raise ValueError("bias must be float32 with a unit-stride last dim")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    status = _launch(
        _build.function(SOURCE, "int8_decode_attention", _ARGTYPES),
        q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias, out,
        _build.stream(q))
    _build.check_launch(status, "int8_decode_attention")
    int8_decode_attention.launches += 1
    return out


int8_decode_attention.launches = 0
