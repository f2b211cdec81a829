"""Lookup-Free Quantization (LFQ).

Each codebook dimension is sign-quantized to {-1, +1}; a code's index is
the bit-pack of its signs, most significant bit first. Libra uses 2
codebooks x 512 codes (9 bits each) on an 18-dim latent, so the input and
output projections are identity; a latent of another width goes through
``project_in`` / ``project_out`` ({"w": (in, out), "b": (out,)}).
``indices_to_codes`` un-packs indices back to codes (the decode side).
``quantize(training=True)`` is the tokenizer-training branch: the
straight-through estimator and the entropy and commitment aux loss.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

# The training branch's aux loss, as libra_tpu/models/vqgan.py's lfq_spec
# sets it (and LFQSpec's default inverse temperature)
_ENTROPY_LOSS_WEIGHT = 0.1
_COMMITMENT_LOSS_WEIGHT = 1.0
_DIVERSITY_GAMMA = 2.5
_INV_TEMPERATURE = 100.0


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


def aux_or_zero(train_aux: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """The training branch's aux loss, or an fp32 zero on like's device
    (made only when read, so an inference encode launches nothing for it)."""
    if train_aux is not None:
        return train_aux
    return torch.zeros((), dtype=torch.float32, device=like.device)


class LFQOutput(NamedTuple):
    quantized: torch.Tensor     # same shape as the input (..., dim)
    indices: torch.Tensor       # (..., num_codebooks) int64
    train_aux: Optional[torch.Tensor] = None    # fp32 scalar; None when not training

    @property
    def aux_loss(self) -> torch.Tensor:
        """fp32 scalar: the entropy + commitment loss, 0 when not training."""
        return aux_or_zero(self.train_aux, self.quantized)


def quantize(x: torch.Tensor, spec: LFQSpec, params: Optional[Dict] = None,
             training: bool = False) -> LFQOutput:
    """LFQ on channel-last x (..., dim): signs and their bit-packed
    indices; with projections, x goes through project_in first and the
    signs through project_out after. With training, the output is
    x + (signs - x).detach() (the straight-through estimator: the signs'
    value, the identity's gradient), the indices come from its signs, and
    aux_loss is the entropy and commitment loss."""
    if spec.has_projections:
        x = _project(x, spec, params, "project_in")
    lead = x.shape[:-1]
    x = x.reshape(lead + (spec.num_codebooks, spec.codebook_dim))
    positive = x > 0
    quantized = torch.where(positive, 1.0, -1.0).to(x.dtype)
    if training:
        out = x + (quantized - x).detach()
        positive = out > 0
        aux = _aux_loss(x, quantized, spec)
    else:
        out, aux = quantized, None
    indices = (positive.long() * bit_mask(spec, x.device)).sum(dim=-1)
    out = out.reshape(lead + (spec.codebook_dims,))
    if spec.has_projections:
        out = _project(out, spec, params, "project_out")
    return LFQOutput(quantized=out, indices=indices, train_aux=aux)


def _entropy(prob: torch.Tensor) -> torch.Tensor:
    """-p log p summed over the codes, log of p clipped at 1e-5."""
    return (-prob * torch.log(prob.clamp(min=1e-5))).sum(dim=-1)


def _aux_loss(x: torch.Tensor, quantized: torch.Tensor, spec: LFQSpec) -> torch.Tensor:
    """x (..., c, d): the per-sample entropy of the softmax over the codes
    (low: each sample commits to a code) less _DIVERSITY_GAMMA times the
    entropy of the batch's mean distribution (high: the codes are all
    used), plus the commitment MSE to the detached signs; in fp32."""
    xf = x.float()
    # -2 x . code: the squared distance up to a constant
    distance = -2.0 * torch.einsum("...cd,jd->...cj", xf, full_codebook(spec, x.device))
    prob = torch.softmax(-distance * _INV_TEMPERATURE, dim=-1)
    per_sample = _entropy(prob).mean()
    avg_prob = prob.mean(dim=tuple(range(prob.ndim - 2)))          # (c, codes)
    codebook = _entropy(avg_prob).mean()
    commit = ((xf - quantized.float().detach()) ** 2).mean()
    return ((per_sample - _DIVERSITY_GAMMA * codebook) * _ENTROPY_LOSS_WEIGHT
            + commit * _COMMITMENT_LOSS_WEIGHT)


def indices_to_codes(indices: torch.Tensor, spec: LFQSpec,
                     params: Optional[Dict] = None) -> torch.Tensor:
    """indices (..., num_codebooks) -> fp32 codes (..., codebook_dims),
    through project_out (to (..., dim)) where the spec has projections."""
    codes = _unpack(indices, spec).reshape(indices.shape[:-1] + (spec.codebook_dims,))
    if spec.has_projections:
        codes = _project(codes, spec, params, "project_out")
    return codes
