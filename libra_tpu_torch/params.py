"""Carry a JAX parameter tree across to the port.

The port keeps the JAX tree as it is: nested dicts (and lists) of
tensors with the same key names, layer leaves stacked on axis 0 and
weights stored for ``x @ W``. The caller turns each JAX leaf into a numpy
array (``np.asarray``); this module never sees a ``jax.Array``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


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


def from_numpy_tree(tree: Any, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Numpy leaves -> tensors on `device`, keeping the tree's structure.
    dtype: cast every floating leaf to it (None keeps each leaf's dtype)."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device, dtype) for v in tree)
    return _leaf(tree, device, dtype)
