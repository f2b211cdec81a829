"""int8-weight matmul: x @ (q * scale) with per-out-channel scales.

Computes what the Pallas TPU kernel
``libra_tpu/ops/pallas/int8_matmul.py::int8_matmul`` computes, the decode
projections of an int8 tree: fp32 sums, the scale applied on the
accumulator, the result in x's dtype.

On a CUDA tensor `int8_matmul` launches the hand-written Hopper kernel in
``csrc/int8_matmul.cu`` (built with nvcc at first use, bound with ctypes)
or raises; a layer view ``q[l]`` of a stacked (L, K, F) weight is read in
place. On a CPU tensor it runs `int8_matmul_plain`. The kernel has three
templates, and the C function ``int8_matmul_template`` decides between
them from the operands: the decode template (split-K clusters, exact
magic-number floats) for M <= 8 rows with aligned operands, every decode
step of an int8 tree; the rows template (``csrc/rows_mma.cuh``: bf16
``mma.sync`` m16n8k16 on the tensor cores) for 8 < M <= MAX_M rows with
aligned operands, the split prompt pass's text rows; the chunked template
for the rest (unaligned operands), which is also exported alone as
``int8_matmul_chunked``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from libra_tpu_torch.ops import _build

SOURCE = _build.CSRC / "int8_matmul.cu"
MAX_M = 160     # the JAX gate: decode, spec-verify and merged-prefill rows
_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: dequantize, then an fp32
    matmul; the result in x's dtype."""
    w = q.float() * scale.float().reshape(1, -1)
    return (x.float() @ w).to(x.dtype)


def supports(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> bool:
    """The JAX gate's meaning: a 2-D weight (a layer view of a stacked one
    is 2-D), a per-out-channel scale, and at most MAX_M rows of x. Any K
    and F (no TPU alignment)."""
    if q.dim() != 2 or tuple(scale.shape) != (1, q.shape[1]):
        return False
    return x.shape[-1] == q.shape[0] and math.prod(x.shape[:-1]) <= MAX_M


def _check(x, q, scale):
    if not supports(x, q, scale):
        raise ValueError(f"int8_matmul: unsupported shapes x {tuple(x.shape)}, "
                         f"q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 \
            or scale.dtype != torch.float32:
        raise TypeError("int8_matmul: the kernel takes bfloat16 x, int8 q and "
                        f"float32 scale, not {x.dtype}, {q.dtype}, {scale.dtype}")
    if q.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: all inputs must be on one device")
    if q.stride(1) != 1 or scale.stride(-1) != 1:
        raise ValueError("int8_matmul: q and scale need a unit-stride last dim")


def _launch(fn, x2, q, scale, out, stream) -> int:
    (M, K), F = x2.shape, q.shape[1]
    return fn(x2.data_ptr(), x2.stride(0), q.data_ptr(), q.stride(0),
              scale.data_ptr(), out.data_ptr(), out.stride(0), M, K, F, stream)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ (q (K, F) int8 * scale (1, F) fp32) -> (..., F) in x's
    dtype. CPU tensors take the plain version. CUDA tensors launch the
    kernel (bfloat16 x, any K and F, at most MAX_M rows) and add one to
    `int8_matmul.launches`."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no kernel for {x.device}")
    _check(x, q, scale)
    K, F = q.shape
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    out = torch.empty((x2.shape[0], F), dtype=x.dtype, device=x.device)
    status = _launch(_build.function(SOURCE, "int8_matmul", _ARGTYPES),
                     x2, q, scale, out, _build.stream(x))
    _build.check_launch(status, "int8_matmul")
    int8_matmul.launches += 1
    return out.reshape(x.shape[:-1] + (F,))


int8_matmul.launches = 0
