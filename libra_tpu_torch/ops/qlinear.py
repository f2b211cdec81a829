"""Weight consumption: one entry point for every ``x @ W`` in the model.

The PyTorch counterpart of ``libra_tpu/ops/qlinear.py``, with its
dispatch order:

1. a ``Quantized4Array`` weight that ``int4_matmul.supports`` takes, with
   the kernel active: the int4 kernel, sliced back to ``out_features``;
2. a ``QuantizedArray`` weight that ``int8_matmul.supports`` takes, with
   the kernel active: the int8 kernel;
3. under ``a8_enabled(True)``, an int8 weight with per-out-channel scales:
   ``_a8_dot``, an s8 x s8 -> s32 matmul outside any kernel (w8a8);
4. otherwise: the weight dequantized to x's dtype, then a matmul.

"Kernel active" means x lies on a CUDA device (in JAX: a TPU backend).
So on the CPU, as in JAX on the CPU, no kernel is reached: an int4
weight dequantizes and runs weight-only even when its ``a8`` flag is set,
and an int8 weight dequantizes in x's dtype (or takes ``_a8_dot``). The
card takes the kernels, as the TPU does. A layer view ``w[l]`` of a
stacked weight is 2-D and is read in place by the kernels.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

from libra_tpu_torch.ops import int4_matmul as i4
from libra_tpu_torch.ops import int8_matmul as i8
from libra_tpu_torch.quantization import Quantized4Array, QuantizedArray

# w8a8: int8-weight matmuls quantize their activations per row and run an
# integer matmul. On around the prompt pass only (generation.py).
_A8_ENABLED = contextvars.ContextVar("libra_torch_a8", default=False)


@contextlib.contextmanager
def a8_enabled(flag: bool):
    """Within the block, int8-weight matmuls that no kernel takes run as
    w8a8 (`_a8_dot`)."""
    token = _A8_ENABLED.set(flag)
    try:
        yield
    finally:
        _A8_ENABLED.reset(token)


def _a8_dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (..., K) float against int8 q (K, F) with scale (1, F): x is
    quantized per row to int8 (absmax / 127, round to nearest even), the
    int32 products are exact, then y = (x_q @ q) * s_x * s_w in fp32,
    returned in x's dtype. The fp32 steps are JAX's, in its order."""
    K, F = q.shape
    x2 = x.reshape(-1, K)
    amax = torch.linalg.vector_norm(x2, float("inf"), dim=-1, keepdim=True).float()
    sx = torch.where(amax > 0, amax, 1.0) / 127.0
    xq = torch.div(x2, sx).round_().to(torch.int8)
    if x.device.type == "cuda":
        if not (xq.shape[0] > 16 and K % 8 == 0 and F % 8 == 0):
            raise ValueError(f"_a8_dot: torch._int_mm on CUDA needs M > 16 and K, "
                             f"F multiples of 8, not M={xq.shape[0]}, K={K}, F={F}")
        # the CUDA int8 GEMM is fast with B column-major (measured 5.8x at
        # 2440 x 4096 x 4096 on an H100); q is row-major, so one int8 copy
        q = q.t().contiguous().t()
    y = torch._int_mm(xq, q) * sx * scale.float()[0]
    return y.to(x.dtype).reshape(x.shape[:-1] + (F,))


def _kernel_active(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., K) @ w -> (..., F) in x's dtype. w: a plain (K, F) tensor,
    a QuantizedArray with per-out-channel scales (1, F), or a
    Quantized4Array with group scales."""
    if isinstance(w, Quantized4Array):
        if _kernel_active(x) and i4.supports(x, w.packed, w.scale, w.group):
            out = i4.int4_matmul(x, w.packed, w.scale, w.group, a8=w.a8)
            if w.out_features is not None and w.out_features != out.shape[-1]:
                out = out[..., :w.out_features]
            return out
    elif isinstance(w, QuantizedArray):
        if _kernel_active(x) and i8.supports(x, w.q, w.scale):
            return i8.int8_matmul(x, w.q, w.scale)
        # only plain x @ W leaves with per-out-channel scales qualify
        if (_A8_ENABLED.get() and w.q.dim() == 2 and w.scale.dim() == 2
                and w.scale.shape[0] == 1 and x.shape[-1] == w.q.shape[0]):
            return _a8_dot(x, w.q, w.scale)
    return x @ w.to(x.dtype)

