"""Bridged decode attention over the head-major int8 KV cache.

Computes what the Pallas TPU kernel
``libra_tpu/ops/pallas/decode_attention.py::int8_decode_attention``
computes, for a few query rows over the whole quantized cache of one
layer:

    s    = (q . k_int) * k_scale / sqrt(d)
         + cross * (q . kb_int) * kb_scale / sqrt(d)
    a    = softmax(max(s + bias, BIG_NEG))                       (fp32)
    out  = bf16(a * v_scale) . v_int + bf16(a * cross * vb_scale) . vb_int

with ``cross[n, s] = flag_q[b, n] != kv_flag[b, s]`` and the probabilities
rounded to q's dtype (bf16 on the card) before the value products, as the
Pallas kernel's ``_weighted_v`` rounds them: each of the kernel's three
templates rounds the normalized softmax so. The cache is the layout of
``models/libra.init_cache(quantized=True)``: int8 (B, H, S, d) layer views
with (B, H, S) fp32 scales.

On a CUDA tensor `int8_decode_attention` launches the hand-written Hopper
kernel in ``csrc/decode_attention.cu`` or raises; on a CPU tensor it runs
`int8_decode_attention_plain`. The kernel's C gate picks the template per
call: the decode template for N <= 8 query rows (a decode step, a
spec-decode verify pass), the wide one for 8 < N <= 64 (a chat turn's
64-row text delta), both on the tensor cores and needing 8-byte q loads
and 16-byte cache rows; the rows template (CUDA cores) for the rest.
"""

from __future__ import annotations

import ctypes

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops.attention import BIG_NEG
from libra_tpu_torch.quantization import QuantizedArray

SOURCE = _build.CSRC / "decode_attention.cu"
HEAD_DIM = 128      # libra-11b's; the kernel is built for it alone
_ARGTYPES = ((ctypes.c_void_p,) * 13 + (ctypes.POINTER(ctypes.c_longlong),)
             + (ctypes.c_int,) * 4 + (ctypes.c_float, ctypes.c_void_p))
N_STRIDES = 13


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
                                bias=None, out_dtype=None) -> torch.Tensor:
    """The kernel's function in plain torch, as the Pallas kernel computes
    it: fp32 scores from the raw int8 keys, scaled by the K scales; the
    fp32 softmax a; a * v_scale and a * cross * vb_scale rounded to q's
    dtype (``_weighted_v``), then multiplied by the raw int8 values with
    fp32 sums. Output in `out_dtype` (default q's dtype)."""
    d = q.shape[-1]
    fq, kv_flag, bias = _flags_bias(q, kq.shape[2], flag_q, kv_flag, bias)
    qf = q.float()

    def scores(k, s):                                     # (B, H, N, S)
        raw = torch.einsum("bnhd,bhsd->bhns", qf, k.float())
        return raw * s.float()[:, :, None, :] * (1.0 / d ** 0.5)

    s = scores(kq, ks)
    cross = None
    if kbq is not None:
        cross = (fq[:, :, None] != kv_flag[:, None, :])[:, None]   # (B, 1, N, S)
        s = s + torch.where(cross, scores(kbq, kbs), 0.0)
    s = torch.clamp_min(s + bias.float()[:, None], BIG_NEG)
    a = torch.softmax(s, dim=-1)

    def weighted(p, v):   # p rounded to q's dtype, as the kernels round it
        return torch.einsum("bhns,bhsd->bnhd", p.to(q.dtype).float(), v.float())

    out = weighted(a * vs.float()[:, :, None, :], vq)
    if kbq is not None:
        out = out + weighted(torch.where(cross, a * vbs.float()[:, :, None, :], 0.0),
                             vbq)
    return out.to(q.dtype if out_dtype is None else out_dtype)


def _strides(q, kq, ks, bias, fq, fk) -> list:
    """The C functions' 13 element strides: q (b, n, h), cache (b, h, s),
    scales (b, h), bias (b, n), flag_q (b, n), flag_kv (b)."""
    return [q.stride(0), q.stride(1), q.stride(2),
            kq.stride(0), kq.stride(1), kq.stride(2),
            ks.stride(0), ks.stride(1), bias.stride(0), bias.stride(1),
            fq.stride(0), fq.stride(1), fk.stride(0)]


def _launch(fn, q, kq, ks, vq, vs, kbq, kbs, vbq, vbs, fq, fk, bias, out,
            stream) -> int:
    B, N, H, d = q.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return fn(ptr(q), ptr(kq), ptr(vq), ptr(kbq), ptr(vbq), ptr(ks), ptr(vs),
              ptr(kbs), ptr(vbs), ptr(fq), ptr(fk), ptr(bias), ptr(out),
              (ctypes.c_longlong * N_STRIDES)(*_strides(q, kq, ks, bias, fq, fk)),
              B, N, kq.shape[2], H, 1.0 / (d ** 0.5), stream)


def _flag_bytes(t: torch.Tensor) -> torch.Tensor:
    """A bool or uint8 flag tensor as it is (its storage is the 0/1 bytes
    the kernel reads); any other dtype converted to uint8."""
    return t if t.dtype in (torch.bool, torch.uint8) else t.to(torch.uint8)


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
    (bfloat16 q, d == HEAD_DIM, N <= 64; with aligned operands the C
    function picks its decode template for N <= 8 and its wide template
    for 8 < N <= 64, else its rows template) and add one to
    `int8_decode_attention.launches`."""
    if q.device.type == "cpu":
        return int8_decode_attention_plain(q, kq, ks, vq, vs, kbq, kbs, vbq,
                                           vbs, flag_q, kv_flag, bias)
    if q.device.type != "cuda":
        raise ValueError(f"int8_decode_attention: no kernel for {q.device}")
    _check(q, kq, ks, vq, vs, kbq, kbs, vbq, vbs)
    fq, kv_flag, bias = _flags_bias(q, kq.shape[2], flag_q, kv_flag, bias)
    fq, fk = _flag_bytes(fq), _flag_bytes(kv_flag)
    if fk.stride(1) != 1:
        fk = fk.contiguous()
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
