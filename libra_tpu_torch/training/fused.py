"""Fused pretrain step: the image tokenization runs on the device inside
the train step.

The PyTorch counterpart of ``libra_tpu/training/fused.py``: CLIP ViT
encode, LFQ quantize and the id/signal scatter run on the device under
``torch.no_grad`` (the tokenizer is frozen), then the decoder's forward
and backward with remat, then the AdamW update. No token id goes
through the host. Every sample carries exactly one image block of
max_vision_token_length tokens (the LAION pretrain shape).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig, VQGANConfig
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.models import vqgan
from libra_tpu_torch.training.optimizer import Optimizer
from libra_tpu_torch.ops.flash_bridge import resolve_attn_impl
from libra_tpu_torch.ops.routed import DropoutKey
from libra_tpu_torch.training.trainer import (TrainState, _finish_step,
                                              masked_value_and_grad, step_key)


class FusedBatch(NamedTuple):
    """Host-prepared tensors; everything image-dependent is computed on
    the device."""
    pixels: torch.Tensor          # (B, S, S, 3) uint8, or CLIP-normalized float
    text_ids: torch.Tensor        # (B, N) token ids; image slots hold anything
    img_start: torch.Tensor       # (B,) start of the image block
    attention_mask: torch.Tensor  # (B, N)
    vision_indices: torch.Tensor  # (B, N)
    labels_static: torch.Tensor   # (Q, B, N) labels, -100 where masked
    label_copy_mask: torch.Tensor  # (B, N) True where label := encoded image id
    signal_ignore: torch.Tensor   # (B,) True -> zero the continuous signal


def maybe_normalize_pixels(vq_cfg: VQGANConfig, pixels: torch.Tensor) -> torch.Tensor:
    """uint8 (already resized and cropped) pixels -> CLIP-normalized
    float32 on their own device, with the host processor's f32 math.
    Float inputs are already normalized and pass through unchanged."""
    if pixels.dtype != torch.uint8:
        return pixels
    mean = torch.tensor(vq_cfg.clip.image_mean, dtype=torch.float32,
                        device=pixels.device)
    std = torch.tensor(vq_cfg.clip.image_std, dtype=torch.float32,
                       device=pixels.device)
    return (pixels.float() / 255.0 - mean) / std


@torch.no_grad()
def encode_images_to_tokens(vq_params, vq_cfg: VQGANConfig, cfg: LibraConfig,
                            pixels: torch.Tensor):
    """(B, S, S, 3) pixels -> framed ids (Q, B, max_vision_token_length) in
    the combined vocab and continuous-signal rows (B, max_vision_token_length,
    C) with zero BOI/EOI rows. The tower runs in its params' dtype (JAX
    promotes bf16 weights to the fp32 pixels'; here the pixels are cast, as
    the port's ImageTokenizer does)."""
    pixels = maybe_normalize_pixels(vq_cfg, pixels)
    pixels = pixels.to(vq_params["quant_conv"]["w"].dtype)
    out = vqgan.encode(vq_params, vq_cfg, pixels)
    B, g, _, Q = out.indices.shape
    ids = out.indices.permute(3, 0, 1, 2).reshape(Q, B, g * g) + cfg.vocab_size
    boi = cfg.vocab_size + cfg.vision_vocab_size - 2
    frame = torch.full((Q, B, 1), boi, dtype=ids.dtype, device=ids.device)
    ids = torch.cat([frame, ids, frame + 1], dim=-1)
    feat = out.feat.reshape(B, g * g, -1)
    zero = feat.new_zeros((B, 1, feat.shape[-1]))
    return ids, torch.cat([zero, feat, zero], dim=1)


def _scatter_block(rows: torch.Tensor, blocks: torch.Tensor,
                   start: torch.Tensor) -> torch.Tensor:
    """rows (B, N, ...) with blocks (B, M, ...) written at offset start[b]
    of each row, clamped so the block fits (lax.dynamic_update_slice's
    rule); a gather, so the offsets never leave the device."""
    B, N = rows.shape[:2]
    M = blocks.shape[1]
    start = start.long().clamp(0, N - M)
    rel = torch.arange(N, device=rows.device)[None] - start[:, None]   # (B, N)
    inside = (rel >= 0) & (rel < M)
    trail = (1,) * (rows.dim() - 2)
    idx = rel.clamp(0, M - 1).reshape((B, N) + trail).expand(
        (B, N) + tuple(blocks.shape[2:]))
    picked = blocks.to(rows.dtype).gather(1, idx)
    return torch.where(inside.reshape((B, N) + trail), picked, rows)


def fused_loss_fn(params, vq_params, cfg: LibraConfig, vq_cfg: VQGANConfig,
                  batch: FusedBatch, remat=True,
                  dropout_key: Optional[DropoutKey] = None,
                  attn_impl: str = "auto") -> torch.Tensor:
    Q = cfg.vision_codebook_num
    B, N = batch.text_ids.shape

    img_ids, img_sig = encode_images_to_tokens(vq_params, vq_cfg, cfg,
                                               batch.pixels)
    img_sig = torch.where(batch.signal_ignore[:, None, None], 0.0, img_sig)

    ids = batch.text_ids.long()[None].expand(Q, B, N)
    ids = _scatter_block(ids.permute(1, 2, 0), img_ids.permute(1, 2, 0),
                         batch.img_start).permute(2, 0, 1)
    sig = _scatter_block(img_sig.new_zeros((B, N, img_sig.shape[-1])), img_sig,
                         batch.img_start)
    labels = torch.where(batch.label_copy_mask[None], ids, batch.labels_static)

    flag = batch.vision_indices < cfg.max_vision_token_length
    out = M.forward(params, cfg, ids, batch.attention_mask,
                    batch.vision_indices, sig, remat=remat,
                    attn_impl=resolve_attn_impl(attn_impl, ids.device),
                    dropout_key=dropout_key)
    tl = M.compute_text_logits(params, out.hidden_states)
    if cfg.vision_prediction_mode == "2d":
        vl = M.compute_vision_logits_2d(params, cfg, out.hidden_states,
                                        batch.vision_indices)
    else:
        vl = M.compute_vision_logits(params, out.hidden_states)
    return M.multicodebook_loss(cfg, tl, vl, flag, labels,
                                unified=cfg.unified_head)


def make_fused_train_step(cfg: LibraConfig, vq_cfg: VQGANConfig,
                          opt: Optimizer, dropout_seed: int = 0, grad_mask=None,
                          attn_impl: str = "auto", remat=True):
    """The train step: step(state, vq_params, batch) -> (state, {"loss",
    "grad_norm"}), the parameters and moments updated in place.
    grad_mask (training.optimizer.trainable_mask): frozen leaves get no
    gradient and no weight-gradient matmul. remat: as models.libra.forward.
    Where a dropout rate is nonzero, the step's forward takes the key
    (dropout_seed, state.step) (training.trainer.step_key)."""

    def step(state: TrainState, vq_params, batch: FusedBatch):
        key = step_key(cfg, dropout_seed, state.step)
        loss, grads = masked_value_and_grad(
            lambda p: fused_loss_fn(p, vq_params, cfg, vq_cfg, batch,
                                    remat=remat, dropout_key=key,
                                    attn_impl=attn_impl),
            state.params, grad_mask)
        state, metrics = _finish_step(state, loss, grads, opt=opt)
        return state, {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"]}
    return step


# ---------------------------------------------------------------------------
# Host-side batch preparation from data-layer samples
# ---------------------------------------------------------------------------

def prepare_fused_batch(samples: Dict[str, list], text_tokenizer,
                        cfg: LibraConfig, max_length: Optional[int] = None,
                        device="cuda") -> FusedBatch:
    """A collated pair-sample batch ({"vision": [pixels...], "language":
    [caption...], "label_mask_position_map": [...]}) -> a FusedBatch on
    `device`. Every text holds one <img_ph> block of
    max_vision_token_length slots."""
    Mv = cfg.max_vision_token_length
    t = text_tokenizer(samples["language"])
    ids = np.asarray(t["input_ids"], np.int64)
    mask = np.asarray(t["attention_mask"], np.int64)
    B, N = ids.shape

    ph_id = text_tokenizer.img_ph_token_id
    img_start = np.zeros((B,), np.int64)
    vision_indices = np.full((B, N), Mv, np.int64)
    for b in range(B):
        pos = np.nonzero(ids[b] == ph_id)[0]
        if len(pos) != Mv:
            raise ValueError(f"sample {b}: {len(pos)} <img_ph>, want {Mv}")
        img_start[b] = pos[0]
        vision_indices[b, pos[0]:pos[0] + Mv] = np.arange(Mv)

    # static labels: text tokens with pad/BOS/span masks; the image tokens'
    # labels are copied from the on-device encode (label_copy_mask)
    labels = np.broadcast_to(ids[None],
                             (cfg.vision_codebook_num, B, N)).astype(np.int64).copy()
    labels[:, mask == 0] = -100
    labels[labels == text_tokenizer.bos_token_id] = -100
    copy_mask = np.zeros((B, N), bool)
    for b, spans in enumerate(samples["label_mask_position_map"]):
        sl = slice(img_start[b], img_start[b] + Mv)
        copy_mask[b, sl] = True
        copy_mask[b, img_start[b]] = False          # BOI label masked
        labels[:, b, sl] = -100
        for start, end in spans:
            if start is None:
                continue
            labels[:, b, slice(start, end)] = -100
            copy_mask[b, slice(start, end)] = False

    ignore = np.asarray(samples.get("contiguous_ignore_sign", [False] * B), bool)
    pixels = np.stack([np.asarray(v) for v in samples["vision"]])

    if max_length and N > max_length:
        ids, mask = ids[:, :max_length], mask[:, :max_length]
        vision_indices = vision_indices[:, :max_length]
        labels = labels[:, :, :max_length]
        copy_mask = copy_mask[:, :max_length]

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return FusedBatch(pixels=dev(pixels), text_ids=dev(ids),
                      img_start=dev(img_start), attention_mask=dev(mask),
                      vision_indices=dev(vision_indices),
                      labels_static=dev(labels), label_copy_mask=dev(copy_mask),
                      signal_ignore=dev(ignore))
