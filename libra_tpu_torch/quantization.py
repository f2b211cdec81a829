"""Weight-only int8 and group-int4 quantization for serving.

The PyTorch counterpart of ``libra_tpu/quantization.py``: the same
quantized leaf types, rounding, clipping and per-leaf rules, so one
parameter tree quantizes to the same tree (and the same bytes) in both
packages. Every function works on tensors on any device: libra-11b is
quantized on the card.

Every weight in the model is consumed through ``.to(dtype)``, an
embedding gather ``w[ids]`` or a layer view ``w[l]`` (``models/libra.py``)
or through ``ops.qlinear.qdot``; the quantized types implement the first
three. ``w[l]`` is a view of the stacked buffers, so the TPU package's
``LayerView`` has no counterpart here; neither has ``_int4_pad_o``, a
TPU block-width pad of the output width (``out_features`` stays, so a
padded JAX int4 tree carried across slices back correctly).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from libra_tpu_torch.ops.int4_matmul import pack_int4, dequant_int4


class QuantizedArray:
    """int8 ``q`` with a broadcastable fp32 ``scale``: per out-channel
    (``(..., 1, F)``) for ``x @ W`` leaves, per row (``(..., V, 1)``) for
    embedding tables."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape)

    @property
    def ndim(self) -> int:
        return self.q.dim()

    @property
    def device(self) -> torch.device:
        return self.q.device

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        """Dequantize: q and scale each cast to `dtype`, then multiplied
        (the JAX ``astype`` order, which rounds the scale to bf16 first in
        a bf16 model)."""
        return self.q.to(dtype) * self.scale.to(dtype)

    def __getitem__(self, idx) -> "QuantizedArray":
        """A layer view (int index) or a row gather (index tensor) of q,
        with the same index applied to the scale. A scale broadcast along
        axis 0 keeps its one row, as JAX's clamped gather does."""
        sidx = idx
        if self.scale.shape[0] == 1 and self.q.shape[0] != 1:
            sidx = torch.zeros_like(idx) if torch.is_tensor(idx) else 0
        return QuantizedArray(self.q[idx], self.scale[sidx])

    def __repr__(self) -> str:
        return f"QuantizedArray(q={self.shape}, scale={tuple(self.scale.shape)})"


class Quantized4Array:
    """Group-int4 weight: ``packed`` (..., K/2, O) int8 signed-byte nibble
    pairs and ``scale`` (..., K/group, O) fp32 (``ops/int4_matmul.py``).
    out_features: the true output width when O was zero-padded (JAX trees
    pad O on the TPU; the port never pads). a8: run as W4A8 on the card."""

    def __init__(self, packed: torch.Tensor, scale: torch.Tensor,
                 group: int = 128, out_features: Optional[int] = None,
                 a8: bool = False):
        self.packed = packed
        self.scale = scale
        self.group = group
        self.out_features = out_features
        self.a8 = a8

    @property
    def shape(self) -> Tuple[int, ...]:
        s = tuple(self.packed.shape)
        o = self.out_features if self.out_features is not None else s[-1]
        return s[:-2] + (2 * s[-2], o)

    @property
    def ndim(self) -> int:
        return self.packed.dim()

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def to(self, dtype: torch.dtype) -> torch.Tensor:
        w = dequant_int4(self.packed, self.scale, self.group, dtype)
        if self.out_features is not None and self.out_features != w.shape[-1]:
            w = w[..., :self.out_features]
        return w

    def __getitem__(self, idx) -> "Quantized4Array":
        return Quantized4Array(self.packed[idx], self.scale[idx], self.group,
                               self.out_features, self.a8)

    def __repr__(self) -> str:
        return (f"Quantized4Array(packed={tuple(self.packed.shape)}, "
                f"scale={tuple(self.scale.shape)}, group={self.group}, "
                f"out_features={self.out_features}, a8={self.a8})")


QTYPES = (QuantizedArray, Quantized4Array)


def quantize_array(w: torch.Tensor, axis: int) -> QuantizedArray:
    """Symmetric per-channel int8: scale = amax / 127 over `axis`."""
    a = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(a > 0, a, 1.0).float() / 127.0
    q = (w / scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantizedArray(q, scale)


def quantize_array_int4(w: torch.Tensor, group: int = 128,
                        a8: bool = True) -> Quantized4Array:
    """Symmetric group-int4 for an ``x @ W`` leaf (contracting axis -2)."""
    packed, scale = pack_int4(w, group=group)
    return Quantized4Array(packed, scale, group, a8=a8)


# Leaves consumed as row gathers (embeddings): scale per row. Everything
# else is consumed as x @ W: scale per output channel.
_PER_ROW = ("embed_tokens", "vision_embed_tokens")

# Leaves that stay in their dtype: vision_lm_head (Q, D, Vv) is consumed
# per codebook through an einsum and is small.
_NEVER_QUANT = ("vision_lm_head",)


def _leaf_axis(name: str, leaf: torch.Tensor) -> Optional[int]:
    if not leaf.is_floating_point() or leaf.dim() < 2 or name in _NEVER_QUANT:
        return None
    if "norm" in name:       # stacked (L, D) norm gains: vectors, not matrices
        return None
    return -1 if name in _PER_ROW else -2


def _is_low_rank_pair(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"wa", "wb"}


def _pad_axis(w: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    shape = list(w.shape)
    shape[axis] = pad
    return torch.cat([w, w.new_zeros(shape)], dim=axis)


def _int4_ok(leaf, axis: int, group: int) -> bool:
    """The leaves JAX's int4 mode packs: x @ W shapes (axis -2) with
    K % (2 * group) == 0, (K / 2) % 128 == 0 and O % 128 == 0; the rest
    stay int8. Kept as it is so both packages quantize one tree alike."""
    if axis != -2:
        return False
    K, O = leaf.shape[-2], leaf.shape[-1]
    return (K % group == 0 and K % (2 * group) == 0 and (K // 2) % 128 == 0
            and O % 128 == 0)


def quantize_params(params: Any, min_elems: int = 1 << 16, bits: int = 8,
                    group: int = 128) -> Any:
    """Quantize every float matrix leaf with >= min_elems elements.

    bits=8: QuantizedArray leaves. bits=4: the x @ W leaves `_int4_ok`
    accepts become Quantized4Array (W4A8 on the card); embeddings and the
    other shapes stay int8. Norm gains, vision_lm_head and small leaves
    keep their dtype. Stacked (L, in, out) weights get per-(layer, out)
    scales, so the layer view w[l] slices its scales too.

    Low-rank {wa, wb} pairs are one unit: a bottleneck under 128 (the
    rank-8 bridges) stays unquantized; any other bottleneck is zero-padded
    to a multiple of 128 (of 2 * group for int4), wa gaining zero output
    columns and wb matching zero input rows, which is exact (libra-11b's
    vision-MLP 2752 becomes 2816, as in the JAX tree)."""

    def visit_leaf(name, leaf):
        if not torch.is_tensor(leaf) or leaf.numel() < min_elems:
            return leaf
        axis = _leaf_axis(name, leaf)
        if axis is None:
            return leaf
        if bits == 4 and _int4_ok(leaf, axis, group):
            return quantize_array_int4(leaf, group)
        return quantize_array(leaf, axis)

    def visit(name, node):
        if _is_low_rank_pair(node):
            wa, wb = node["wa"], node["wb"]
            inner = wa.shape[-1]
            if wb.shape[-2] != inner:
                raise ValueError(f"low-rank pair {name}: {tuple(wa.shape)} "
                                 f"then {tuple(wb.shape)}")
            if max(wa.numel(), wb.numel()) < min_elems or inner < 128:
                return node
            pad = -inner % (2 * group if bits == 4 else 128)
            if pad:
                wa, wb = _pad_axis(wa, -1, pad), _pad_axis(wb, -2, pad)
            return {"wa": visit_leaf("wa", wa), "wb": visit_leaf("wb", wb)}
        if isinstance(node, dict):
            return {k: visit(k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(visit(f"[{i}]", v) for i, v in enumerate(node))
        return visit_leaf(name, node)

    return visit("", params)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def dequantize_params(params: Any, dtype: torch.dtype = torch.float32) -> Any:
    """A plain tree: every quantized leaf dequantized to `dtype`."""
    return _map_leaves(
        lambda x: x.to(dtype) if isinstance(x, QTYPES) else x, params)


def quantization_error(params: Any, quantized: Any) -> float:
    """Max relative per-tensor dequantization error (diagnostics). Padded
    low-rank pairs compare on the original (unpadded) block."""
    errs = []

    def walk(o, q):
        if isinstance(o, dict):
            for k in o:
                walk(o[k], q[k])
        elif isinstance(o, (list, tuple)):
            for a, b in zip(o, q):
                walk(a, b)
        elif isinstance(q, QTYPES):
            w = o.float()
            d = q.to(torch.float32)[tuple(slice(0, n) for n in w.shape)]
            errs.append(((w - d).abs().max() / (w.abs().max() + 1e-9)).item())

    walk(params, quantized)
    return max(errs) if errs else 0.0
