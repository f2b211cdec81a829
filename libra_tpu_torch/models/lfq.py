"""Lookup-Free Quantization (LFQ), inference branch.

Each codebook dimension is sign-quantized to {-1, +1}; a code's index is
the bit-pack of its signs, most significant bit first. Libra uses 2
codebooks x 512 codes (9 bits each) on an 18-dim latent, so the input and
output projections are identity. The training branch (straight-through
estimator, entropy and commitment losses) lands with training (ROADMAP
A11).
"""

from __future__ import annotations

from typing import NamedTuple

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


class LFQOutput(NamedTuple):
    quantized: torch.Tensor     # same shape as the input (..., dim)
    indices: torch.Tensor       # (..., num_codebooks) int64


def quantize(x: torch.Tensor, spec: LFQSpec) -> LFQOutput:
    """LFQ on channel-last x (..., dim): signs and their bit-packed indices."""
    if spec.has_projections:
        raise NotImplementedError("LFQ with input/output projections")
    lead = x.shape[:-1]
    x = x.reshape(lead + (spec.num_codebooks, spec.codebook_dim))
    positive = x > 0
    quantized = torch.where(positive, 1.0, -1.0).to(x.dtype)
    indices = (positive.long() * bit_mask(spec, x.device)).sum(dim=-1)
    return LFQOutput(quantized=quantized.reshape(lead + (spec.codebook_dims,)),
                     indices=indices)
