"""Incremental multi-turn chat: the KV cache stays on the device across turns.

The PyTorch counterpart of ``libra_tpu/chat.py``. A ChatSession keeps B
conversations' cache resident on the device; each ask() prefills only the
turn's new tokens (left-padded to a multiple of delta_bucket) at the
carried cache index, then decodes the answer in a Python loop, so a turn's
time to its first token grows with its delta, not with the history.

Exactness: a session's greedy tokens equal a fresh Generator run over the
same concatenated token history (causal attention makes a continued cache
the same as a re-prefill). The session works on tokens: a generated answer
followed by its EOS id is the v1 template's "answer</s>", and the next
turn's text follows it without BOS.

Batched lockstep: the B conversations advance together. A row that hits
EOS stops; its later pad writes stay masked out of attention, and the
shared host index advances for all rows, so a turn takes max-over-rows
slots. Every emitted token runs its forward, the last one and EOS
included: its K/V must be in the cache for the next turn.

Not ported yet: speculative turns (ROADMAP A8d) and the 2D modes (A10;
LibraConfig refuses them); a tensor-parallel mesh raises (A13).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.generation import (GenerationConfig, _last_position_logits,
                                        decode_micro_step, fuse_pixels,
                                        sample_tokens)
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.ops.qlinear import a8_enabled
from libra_tpu_torch.training.fused import resolve_attn_impl


class TurnResult(NamedTuple):
    tokens: torch.Tensor         # (Q, B, max_new) generated ids (pad-filled)
    num_generated: torch.Tensor  # (B,) tokens generated incl. EOS


def _delta_prefill(params, cache: M.KVCache, mask_buf, ids, vi, sig, pmask,
                   pos_last, vq_params=None, pixels=None, img_start=None, *,
                   cfg: LibraConfig, gen: GenerationConfig, vq_cfg=None):
    """The delta's prompt pass at the cache's host index: its mask written
    into mask_buf (in place); with `pixels`, CLIP + LFQ and the split as in
    generation._prefill; positions carried on from pos_last (they continue
    across turns, so not position_ids_from_mask); the forward under
    a8_enabled(gen.a8_prefill); the last position's logits, weight-only.
    Returns (cache, logits, vi_last, pos_last)."""
    M._write_seq(mask_buf, pmask, cache.index)
    text_span = None
    if pixels is not None:
        ids, sig, text_span = fuse_pixels(cfg, gen, vq_params, vq_cfg, ids,
                                          pixels, img_start)
    pos = pos_last[:, None] + torch.cumsum(pmask, dim=1)
    impl = resolve_attn_impl(gen.attn_impl, ids.device)
    with a8_enabled(gen.a8_prefill):
        out = M.forward(params, cfg, ids, mask_buf, vi, sig, position_ids=pos,
                        cache=cache, attn_impl=impl, text_span=text_span)
    vi_last = vi[:, -1]          # the delta is LEFT-padded: its last column is real
    logits = _last_position_logits(params, cfg, out.hidden_states,
                                   vi_last < cfg.max_vision_token_length, vi_last)
    return out.cache, logits, vi_last, pos[:, -1]


def _turn_impl(params, cache: M.KVCache, mask_buf, ids, vi, sig, pmask,
               pos_last, generator=None, vq_params=None, pixels=None,
               img_start=None, *, cfg: LibraConfig, gen: GenerationConfig,
               lang_only: bool, max_new: int, vq_cfg=None):
    """One turn: the delta prefill, then up to max_new decode steps with
    finished rows frozen (active=). Each step's forward runs after its
    token is emitted, so the cache holds every emitted token; the loop ends
    when every row has finished (read on the host once a step). Returns
    (tokens, num_generated, cache, pos_last); the cache's index is then
    start + Nb + the steps run."""
    Q, B, _ = ids.shape
    cache, logits, vi_last, pos_last = _delta_prefill(
        params, cache, mask_buf, ids, vi, sig, pmask, pos_last, vq_params,
        pixels, img_start, cfg=cfg, gen=gen, vq_cfg=vq_cfg)
    toks = ids.new_full((Q, B, max_new), gen.pad_token_id)
    finished = torch.zeros((B,), dtype=torch.bool, device=ids.device)
    num_gen = torch.zeros((B,), dtype=torch.int64, device=ids.device)
    for t in range(max_new):
        active = ~finished
        tok = sample_tokens(logits, gen, generator)
        tok = torch.where(active[None], tok, gen.pad_token_id)
        num_gen += active.long()
        finished = finished | ((tok == gen.eos_token_id).any(dim=0) & active)
        toks[:, :, t] = tok
        # the emitted token (EOS too: it is the v1 template's </s>) stays
        # visible to later turns; a finished row's pad writes are masked
        M._write_seq(mask_buf, active[:, None], cache.index)
        logits, cache, vi_last, pos_last = decode_micro_step(
            params, cfg, tok, mask_buf, cache, vi_last, pos_last,
            active=active, lang_only=lang_only)
        if bool(finished.all()):
            break
    return toks, num_gen, cache, pos_last


class ChatSession:
    """Batched incremental multi-turn generation over one resident cache.

    params/cfg as for Generator, on the device the session runs on;
    `max_len` is the whole conversation's token capacity (prompt deltas and
    answers of ALL turns). Deltas are left-padded to multiples of
    `delta_bucket`. vq_params/vq_cfg enable raw-pixels turns."""

    def __init__(self, params, cfg: LibraConfig, batch: int, max_len: int,
                 gen: Optional[GenerationConfig] = None, delta_bucket: int = 64,
                 mesh=None, vq_params=None, vq_cfg=None):
        if mesh is not None:
            raise NotImplementedError(
                "ChatSession(mesh=...): tensor-parallel chat is ROADMAP A13; "
                "the port runs on one device")
        if (vq_params is None) != (vq_cfg is None):
            raise ValueError("vq_params and vq_cfg must be given together "
                             "(raw-pixels turns need both)")
        self.cfg = cfg
        self.gen = gen or GenerationConfig()
        self.B = batch
        self.delta_bucket = max(delta_bucket, 1)
        # libra_tpu's length: an int8 cache rounded up to 128 slots (its TPU
        # kernel's gate), so the same turn runs out of slots in both; every
        # slot is the conversation's (spec turns, A8d, reserve a margin)
        self.S = -(-max_len // 128) * 128 if self.gen.kv_quant else max_len
        self.params = params
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        self.device = params["embed_tokens"].device
        self.reset()

    # -- state -------------------------------------------------------------

    def reset(self) -> None:
        """A fresh conversation: zeroed cache and mask, positions at -1."""
        with torch.inference_mode():
            self._cache = M.init_cache(self.cfg, self.B, self.S, device=self.device,
                                       quantized=self.gen.kv_quant)
            self._mask_buf = torch.zeros((self.B, self.S), dtype=torch.int64,
                                         device=self.device)
            self._pos_last = torch.full((self.B,), -1, dtype=torch.int64,
                                        device=self.device)

    @property
    def used(self) -> int:
        """Occupied cache slots: the cache's host index."""
        return self._cache.index

    # -- per-turn ----------------------------------------------------------

    def ask(self, inputs: Dict[str, Any], max_new_tokens: Optional[int] = None,
            generator: Optional[torch.Generator] = None) -> TurnResult:
        """Run one turn. `inputs` is a LibraTokenizer-style dict for the
        DELTA only, as tensors or numpy arrays: input_ids (Q, B, Nd),
        vision_indices (B, Nd), optional attention_mask (left padding) and
        coninous_signal (pre-encoded image turns); or pixels (B, S, S, 3)
        and img_start (B,) for a raw-pixels turn, one image block a row.
        max_new_tokens=0 is a prefill-only turn. generator: the
        torch.Generator to sample from (one seeded with the used slots when
        sampling without one). Returns the turn's tokens; the cache
        advances in place."""
        cfg, gen, dev = self.cfg, self.gen, self.device
        Mv = cfg.max_vision_token_length
        max_new = gen.max_new_tokens if max_new_tokens is None else max_new_tokens
        ids = torch.as_tensor(inputs["input_ids"], device=dev).long()
        vi = torch.as_tensor(inputs["vision_indices"], device=dev).long()
        Q, B, Nd = ids.shape
        if B != self.B:
            raise ValueError(f"session batch is {self.B}, got {B}")
        pm = inputs.get("attention_mask")
        pm = (torch.ones((B, Nd), dtype=torch.int64, device=dev) if pm is None
              else torch.as_tensor(pm, device=dev).long())
        pixels, img_start, sig = inputs.get("pixels"), inputs.get("img_start"), None
        if pixels is not None:
            if self.vq_params is None:
                raise ValueError("pixels turns need vq_params/vq_cfg")
            pixels = torch.as_tensor(pixels, device=dev)
            side = self.vq_cfg.clip.image_size
            if tuple(pixels.shape) != (B, side, side, 3):
                raise ValueError(f"pixels shape {tuple(pixels.shape)} != the "
                                 f"session's CLIP input ({B}, {side}, {side}, 3)")
            # a pixels turn ships no signal: the encode writes its rows
            img_start = torch.as_tensor(img_start, device=dev).long()
        elif inputs.get("coninous_signal") is not None:
            sig = torch.as_tensor(inputs["coninous_signal"], device=dev)

        pad = (-Nd) % self.delta_bucket
        if pad:
            ids = torch.cat([ids.new_full((Q, B, pad), gen.pad_token_id), ids], -1)
            vi = torch.cat([vi.new_full((B, pad), Mv), vi], -1)
            pm = torch.cat([pm.new_zeros((B, pad)), pm], -1)
            if sig is not None:
                sig = torch.cat([sig.new_zeros((B, pad, sig.shape[-1])), sig], 1)
            if img_start is not None:
                img_start = img_start + pad
        Nb = Nd + pad
        if self.used + Nb + max_new > self.S:
            raise ValueError(
                f"turn needs {Nb}+{max_new} slots but only "
                f"{self.S - self.used} of {self.S} remain; raise "
                f"max_len or reset() the session")

        # the language-only decode body when every delta ends in text; a
        # delta ending inside an image block (t2i turn) decodes dual-path
        ends_in_text = bool((vi[:, -1] >= Mv).all())
        if gen.decode_modality == "text" and not ends_in_text:
            raise ValueError("decode_modality='text' needs deltas ending in text")
        lang_only = (ends_in_text if gen.decode_modality == "auto"
                     else gen.decode_modality == "text")
        if gen.do_sample and generator is None:
            generator = torch.Generator(device=dev).manual_seed(self.used)
        with torch.inference_mode():
            toks, num_gen, self._cache, self._pos_last = _turn_impl(
                self.params, self._cache, self._mask_buf, ids, vi, sig, pm,
                self._pos_last, generator, self.vq_params, pixels, img_start,
                cfg=cfg, gen=gen, lang_only=lang_only, max_new=max_new,
                vq_cfg=self.vq_cfg)
        return TurnResult(tokens=toks, num_generated=num_gen)
