"""Group-int4-weight matmul: x @ dequant_int4(packed, scales).

Computes what the Pallas TPU kernel
``libra_tpu/ops/pallas/int4_matmul.py::int4_matmul`` computes, the
projections of an int4 tree, in its two modes:

* weight-only: fp32 sums of x and the int4 weights, the group scale on
  each group's sum;
* W4A8 (``a8=True``): each row of x quantized to int8 (absmax / 127,
  round to nearest even), exact int32 group sums, the group scale in fp32,
  the row scale at the end.

Packing (``pack_int4``) is the JAX package's byte layout: two weights a
signed byte along K, ``byte = (q[2r+1] << 4) | (q[2r] + 8)``, with one
fp32 scale per (group of K, output column).

On a CUDA tensor `int4_matmul` launches the hand-written Hopper kernel in
``csrc/int4_matmul.cu`` or raises; on a CPU tensor it runs
`int4_matmul_plain`. The kernel has three templates, and the C function
``int4_matmul_template`` decides between them from the operands: the
decode template (split-K clusters, ``__dp4a`` for W4A8) for M <= 8 rows
with aligned operands, every decode step of an int4 tree; the rows
template (``csrc/rows_mma.cuh``: ``mma.sync`` on the tensor cores, bf16
m16n8k16 weight-only, s8 m16n8k32 W4A8 after a pre-pass that quantizes x
into a workspace this wrapper allocates) for 8 < M <= MAX_M rows with
aligned operands, the split prompt pass's text rows; the chunked template
for the rest (unaligned operands), which is also exported alone as
``int4_matmul_chunked``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from libra_tpu_torch.ops import _build

SOURCE = _build.CSRC / "int4_matmul.cu"
MAX_M = 160     # the JAX gate, as for the int8 kernel
_ARGTYPES = ((ctypes.c_void_p, ctypes.c_longlong) * 3
             + (ctypes.c_void_p, ctypes.c_longlong)
             + (ctypes.c_int,) * 5
             + (ctypes.c_void_p, ctypes.c_longlong)      # the workspace, its bytes
             + (ctypes.c_void_p,))
_WS_ARGTYPES = (ctypes.c_int,) * 4


def pack_int4(w: torch.Tensor, group: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (..., K, O) float -> (packed (..., K/2, O) int8, scales
    (..., K/group, O) fp32): symmetric int4 per (group, out column),
    q in [-8, 7], scale = group absmax / 7."""
    K, O = w.shape[-2:]
    if K % group or group % 2:
        raise ValueError(f"K={K} must be divisible by group={group}, "
                         f"and group must be even")
    wg = w.reshape(w.shape[:-2] + (K // group, group, O))
    amax = wg.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax, 1.0).float() / 7.0
    q = (wg / scale).round_().clamp_(-8, 7).to(torch.int16).reshape(w.shape)
    packed = ((q[..., 1::2, :] << 4) | (q[..., 0::2, :] + 8)).to(torch.int8)
    return packed, scale.reshape(w.shape[:-2] + (K // group, O))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K/2, O) int8 -> the int4 weights (..., K, O) as int32."""
    p = packed.to(torch.int32)           # sign-extends the byte
    w = torch.stack([(p & 15) - 8, p >> 4], dim=-2)
    return w.reshape(packed.shape[:-2] + (2 * packed.shape[-2], packed.shape[-1]))


def dequant_int4(packed: torch.Tensor, scales: torch.Tensor, group: int = 128,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The weights as `dtype` (products taken in fp32, as in JAX)."""
    s = torch.repeat_interleave(scales, group, dim=-2)
    return (unpack_int4(packed) * s).to(dtype)


def quantize_rows(xf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """W4A8's activations: each row of xf (M, K) fp32 as xq = round(x /
    sx), ties to even, with sx = absmax / 127 (1 / 127 for a zero row).
    Returns (xq (M, K) fp32 integers, sx (M, 1))."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    sx = torch.where(amax > 0, amax, 1.0) / 127.0
    return torch.round(xf / sx), sx


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, group: int = 128,
                      a8: bool = False) -> torch.Tensor:
    """The kernel's function in plain torch, the result in x's dtype.
    Weight-only: dequantize, then an fp32 matmul. W4A8: x quantized per
    row, group sums of the integer products (exact in fp32: each is at
    most 127 * 8 * group < 2^24), times the group scale, summed, times the
    row scale."""
    K = x.shape[-1]
    xf = x.reshape(-1, K).float()
    if not a8:
        out = xf @ dequant_int4(packed, scales, group)
    else:
        xq, sx = quantize_rows(xf)                                  # (M, K), (M, 1)
        G = K // group
        w = unpack_int4(packed).float().reshape(G, group, -1)       # (G, g, O)
        sums = torch.bmm(xq.reshape(-1, G, group).transpose(0, 1), w)  # (G, M, O)
        out = (sums * scales.float()[:, None, :]).sum(dim=0) * sx
    return out.to(x.dtype).reshape(x.shape[:-1] + (packed.shape[-1],))


def supports(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
             group: int) -> bool:
    """A 2-D packed weight (a layer view of a stacked one is 2-D) with its
    (K/group, O) scales, an even group dividing K, and at most MAX_M rows
    of x. No TPU alignment."""
    if packed.dim() != 2 or scales.dim() != 2 or group % 2:
        return False
    Kh, O = packed.shape
    K = 2 * Kh
    if K % group or tuple(scales.shape) != (K // group, O) or x.shape[-1] != K:
        return False
    return math.prod(x.shape[:-1]) <= MAX_M


def _check(x, packed, scales, group):
    if not supports(x, packed, scales, group):
        raise ValueError(f"int4_matmul: unsupported shapes x {tuple(x.shape)}, "
                         f"packed {tuple(packed.shape)}, scales "
                         f"{tuple(scales.shape)}, group {group}")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError("int4_matmul: the kernel takes bfloat16 x, int8 packed "
                        f"and float32 scales, not {x.dtype}, {packed.dtype}, "
                        f"{scales.dtype}")
    if packed.device != x.device or scales.device != x.device:
        raise ValueError("int4_matmul: all inputs must be on one device")
    if packed.stride(1) != 1 or scales.stride(1) != 1:
        raise ValueError("int4_matmul: packed and scales need a unit-stride "
                         "last dim")


def workspace(x2: torch.Tensor, group: int, a8: bool):
    """The device workspace the kernel needs for x2's rows (the rows
    template's W4A8 pre-pass: xq, its group sums and the row scales, as
    ``int4_matmul_workspace`` sizes it), or None."""
    M, K = x2.shape
    n = _build.function(SOURCE, "int4_matmul_workspace", _WS_ARGTYPES)(M, K, group, int(a8))
    return torch.empty(n, dtype=torch.uint8, device=x2.device) if n else None


def _launch(fn, x2, packed, scales, out, group, a8, ws, stream) -> int:
    M, K = x2.shape
    return fn(x2.data_ptr(), x2.stride(0), packed.data_ptr(), packed.stride(0),
              scales.data_ptr(), scales.stride(0), out.data_ptr(),
              out.stride(0), M, K, packed.shape[1], group, int(a8),
              None if ws is None else ws.data_ptr(),
              0 if ws is None else ws.numel(), stream)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                group: int = 128, a8: bool = False) -> torch.Tensor:
    """x (..., K) @ dequant_int4(packed (K/2, O), scales (K/group, O))
    -> (..., O) in x's dtype; a8 runs W4A8. CPU tensors take the plain
    version. CUDA tensors launch the kernel (bfloat16 x, at most MAX_M
    rows; the template ``int4_matmul_template`` names, W4A8 on the rows
    template with its pre-pass in the same call) and add one to
    `int4_matmul.launches`."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, group, a8)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: no kernel for {x.device}")
    _check(x, packed, scales, group)
    K, O = x.shape[-1], packed.shape[1]
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty((x2.shape[0], O), dtype=x.dtype, device=x.device)
    status = _launch(_build.function(SOURCE, "int4_matmul", _ARGTYPES),
                     x2, packed, scales, out, group, a8,
                     workspace(x2, group, a8), _build.stream(x))
    _build.check_launch(status, "int4_matmul")
    int4_matmul.launches += 1
    return out.reshape(x.shape[:-1] + (O,))


int4_matmul.launches = 0
