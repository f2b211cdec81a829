"""Lookup-Free Quantization (LFQ), inference branch.

Each codebook dimension is sign-quantized to {-1, +1}; a code's index is
the bit-pack of its signs, most significant bit first. Libra uses 2
codebooks x 512 codes (9 bits each) on an 18-dim latent, so the input and
output projections are identity; a latent of another width goes through
``project_in`` / ``project_out`` ({"w": (in, out), "b": (out,)}).
``indices_to_codes`` un-packs indices back to codes (the decode side).
The training branch (straight-through estimator, entropy and commitment
losses) lands with training (ROADMAP A11).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch


class LFQSpec(NamedTuple):
    codebook_size: int          # e.g. 512
    num_codebooks: int          # e.g. 2
    dim: int                    # input feature dim (e.g. 18)

    @property
    def codebook_dim(self) -> int:
        d = self.codebook_size.bit_length() - 1
        if (1 << d) != self.codebook_size:
            raise ValueError("codebook_size must be a power of two")
        return d

    @property
    def codebook_dims(self) -> int:
        return self.codebook_dim * self.num_codebooks

    @property
    def has_projections(self) -> bool:
        return self.dim != self.codebook_dims


def bit_mask(spec: LFQSpec, device=None) -> torch.Tensor:
    """2^(d-1), ..., 2, 1: most-significant-bit-first weights."""
    return 2 ** torch.arange(spec.codebook_dim - 1, -1, -1, device=device)


def full_codebook(spec: LFQSpec, device=None) -> torch.Tensor:
    """(codebook_size, codebook_dim) fp32 {-1, +1} codes, row i the code
    of index i."""
    return _unpack(torch.arange(spec.codebook_size, device=device), spec)


def _unpack(indices: torch.Tensor, spec: LFQSpec) -> torch.Tensor:
    """(...) int indices -> (..., codebook_dim) fp32 {-1, +1} codes."""
    bits = (indices[..., None] & bit_mask(spec, indices.device)) != 0
    return bits.float() * 2.0 - 1.0


def _project(x: torch.Tensor, spec: LFQSpec, params: Optional[Dict],
             name: str) -> torch.Tensor:
    """x @ w + b through params[name] ("project_in" / "project_out")."""
    if params is None or name not in params:
        raise ValueError(f"LFQ with dim {spec.dim} != {spec.codebook_dims} "
                         f"codebook dims needs params[{name!r}]")
    p = params[name]
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


class LFQOutput(NamedTuple):
    quantized: torch.Tensor     # same shape as the input (..., dim)
    indices: torch.Tensor       # (..., num_codebooks) int64


def quantize(x: torch.Tensor, spec: LFQSpec,
             params: Optional[Dict] = None) -> LFQOutput:
    """LFQ on channel-last x (..., dim): signs and their bit-packed
    indices; with projections, x goes through project_in first and the
    signs through project_out after."""
    if spec.has_projections:
        x = _project(x, spec, params, "project_in")
    lead = x.shape[:-1]
    x = x.reshape(lead + (spec.num_codebooks, spec.codebook_dim))
    positive = x > 0
    quantized = torch.where(positive, 1.0, -1.0).to(x.dtype)
    indices = (positive.long() * bit_mask(spec, x.device)).sum(dim=-1)
    quantized = quantized.reshape(lead + (spec.codebook_dims,))
    if spec.has_projections:
        quantized = _project(quantized, spec, params, "project_out")
    return LFQOutput(quantized=quantized, indices=indices)


def indices_to_codes(indices: torch.Tensor, spec: LFQSpec,
                     params: Optional[Dict] = None) -> torch.Tensor:
    """indices (..., num_codebooks) -> fp32 codes (..., codebook_dims),
    through project_out (to (..., dim)) where the spec has projections."""
    codes = _unpack(indices, spec).reshape(indices.shape[:-1] + (spec.codebook_dims,))
    if spec.has_projections:
        codes = _project(codes, spec, params, "project_out")
    return codes
