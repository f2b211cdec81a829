"""Carry a JAX parameter tree across to the port.

The port keeps the JAX tree as it is: nested dicts (and lists) of
tensors with the same key names, layer leaves stacked on axis 0 and
weights stored for ``x @ W``. The caller turns each JAX leaf into a numpy
array (``np.asarray``); this module never sees a ``jax.Array``.

Quantized leaves cross by their fields: any object with ``q`` and
``scale`` (JAX's ``QuantizedArray``) becomes a ``QuantizedArray``, and
any object with ``packed``, ``scale``, ``group``, ``out_features`` and
``a8`` (JAX's ``Quantized4Array``) a ``Quantized4Array``. A JAX quantized
tree mapped with ``jax.tree_util.tree_map(np.asarray, tree)`` keeps its
quantized nodes with numpy fields, which is what this module takes.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from libra_tpu_torch.quantization import Quantized4Array, QuantizedArray


def _leaf(arr: np.ndarray, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy refuses; the widening
        # to float32 is exact, and so is the narrowing back below
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.tensor(arr)    # a copy: JAX hands out read-only buffers
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree: Any, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Numpy leaves -> tensors on `device`, keeping the tree's structure.
    dtype: cast every floating leaf to it (None keeps each leaf's dtype);
    quantization scales stay fp32."""
    if hasattr(tree, "packed"):
        return Quantized4Array(_leaf(tree.packed, device, None),
                               _leaf(tree.scale, device, None), int(tree.group),
                               None if tree.out_features is None
                               else int(tree.out_features), bool(tree.a8))
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantizedArray(_leaf(tree.q, device, None),
                              _leaf(tree.scale, device, None))
    if tree is None:          # an empty subtree (the discriminator's first "bn")
        return None
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)
