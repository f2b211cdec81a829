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

Speculative turns (gen.spec_decode = gamma > 0, greedy text turns only):
the same delta prefill, then spec_decode.spec_decode_loop against the
resident cache at per-row indices, drafting from the conversation's
codebook-0 history (earlier turns included); the final pending token is
flushed into the cache and the index resyncs to the rows' maximum, one
host read a turn. The cache holds gamma + 1 slots past max_len for the
last verify window.

2D RoPE carries its base counter across turns (a delta's tokens step it
by models/libra.rope_inc). 2D prediction is refused, as in libra_tpu: its
hidden ring would need stitching across turns. A tensor-parallel mesh
raises (A13).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.generation import (GenerationConfig, _last_position_logits,
                                        decode_micro_step, fuse_pixels,
                                        sample_tokens)
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.ops.flash_bridge import resolve_attn_impl
from libra_tpu_torch.ops.qlinear import a8_enabled
from libra_tpu_torch.spec_decode import spec_decode_loop


class TurnResult(NamedTuple):
    tokens: torch.Tensor         # (Q, B, max_new) generated ids (pad-filled)
    num_generated: torch.Tensor  # (B,) tokens generated incl. EOS


def _delta_prefill(params, cache: M.KVCache, mask_buf, ids, vi, sig, pmask,
                   pos_last, vq_params=None, pixels=None, img_start=None, *,
                   cfg: LibraConfig, gen: GenerationConfig, vq_cfg=None):
    """The delta's prompt pass at the cache's host index: its mask written
    into mask_buf (in place); with `pixels`, CLIP + LFQ and the split as in
    generation._prefill; positions carried on from pos_last (they continue
    across turns, so not position_ids_from_mask; with 2D RoPE pos_last is
    the base counter, stepped by rope_inc, each token's (row, col) offset
    added); the forward under
    a8_enabled(gen.a8_prefill); the last position's logits, weight-only.
    Returns (cache, logits, vi_last, pos_last)."""
    M._write_seq(mask_buf, pmask, cache.index)
    text_span = None
    if pixels is not None:
        ids, sig, text_span = fuse_pixels(cfg, gen, vq_params, vq_cfg, ids,
                                          pixels, img_start)
    inc = M.rope_inc(cfg, vi) * pmask if cfg.use_2d_rope else pmask
    base = pos_last[:, None] + torch.cumsum(inc, dim=1)
    pos = M.rope_positions(cfg, base, vi)
    impl = resolve_attn_impl(gen.attn_impl, ids.device)
    with a8_enabled(gen.a8_prefill):
        out = M.forward(params, cfg, ids, mask_buf, vi, sig, position_ids=pos,
                        cache=cache, attn_impl=impl, text_span=text_span)
    vi_last = vi[:, -1]          # the delta is LEFT-padded: its last column is real
    logits = _last_position_logits(params, cfg, out.hidden_states,
                                   vi_last < cfg.max_vision_token_length, vi_last)
    return out.cache, logits, vi_last, base[:, -1]


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


def _spec_turn_impl(params, cache: M.KVCache, mask_buf, hist, ids, vi, sig,
                    pmask, pos_last, vq_params=None, pixels=None,
                    img_start=None, *, cfg: LibraConfig, gen: GenerationConfig,
                    max_new: int, vq_cfg=None):
    """A speculative turn: the same delta prefill, then the shared
    draft/verify loop against the resident cache at PER-ROW indices, then
    a lockstep resync.

    `hist` (B, S) is the session's codebook-0 token history, carried
    across turns so the drafter copies from earlier turns too (answers
    quote the question and earlier answers); written in place. Rows
    desync inside the loop; at the turn's end the final pending token's
    K/V is flushed with one per-row step (every emitted token's K/V is in
    the cache, as in the standard body) and the index resyncs to the
    rows' maximum (one host read; the gap slots stay masked). Returns
    (tokens, num_generated, cache, pos_last)."""
    Q, B, Nb = ids.shape
    Mv = cfg.max_vision_token_length
    start = cache.index                                  # host int, lockstep
    cache, logits, vi_last, pos_last = _delta_prefill(
        params, cache, mask_buf, ids, vi, sig, pmask, pos_last, vq_params,
        pixels, img_start, cfg=cfg, gen=gen, vq_cfg=vq_cfg)
    # the delta's codebook-0 ids (its pad slots stay mask-invalid)
    M._write_seq(hist, ids[0], start)
    if max_new == 0:
        return (ids.new_full((Q, B, 0), gen.pad_token_id),
                torch.zeros((B,), dtype=torch.int64, device=ids.device),
                cache, pos_last)

    # text-mode greedy: codebook 0's combined-vocab argmax is the answer
    pending = torch.argmax(logits[0], dim=-1).to(hist.dtype)       # (B,)
    P0 = start + Nb                       # the pending token's slot
    M._write_seq(hist, pending[:, None], P0)
    P = torch.full((B,), P0, dtype=torch.int64, device=ids.device)
    res = spec_decode_loop(params, hist, mask_buf, cache._replace(index=P),
                           pending, pos_last, P, cfg=cfg, gen=gen,
                           max_new=max_new)

    # flush the final pending token (slot res.P, emitted, K/V absent) so
    # that later turns attend to it, the EOS </s> separator included
    xf = res.hist.gather(1, res.P[:, None])                         # (B, 1)
    M._write_seq(res.mask_buf, torch.ones_like(xf), res.P)
    vi_f = torch.full((B, 1), Mv, dtype=torch.int64, device=ids.device)
    outf = M.forward(params, cfg, xf[None].expand(Q, B, 1), res.mask_buf, vi_f,
                     None, position_ids=M.rope_positions(cfg, res.last_pos[:, None] + 1,
                                                         vi_f),
                     cache=res.cache, lang_only=True)
    # the lockstep resync: the turn's one host read
    cache = outf.cache._replace(index=int(res.P.max()) + 1)

    # the turn's tokens: history slots [P0, P0 + max_new), pad past num_gen
    seq = res.hist[:, P0:P0 + max_new]
    seq = torch.where(torch.arange(max_new, device=ids.device)[None]
                      < res.num_gen[:, None], seq, gen.pad_token_id)
    return seq[None].expand(Q, B, max_new), res.num_gen, cache, res.last_pos + 1


class ChatSession:
    """Batched incremental multi-turn generation over one resident cache.

    params/cfg as for Generator, on the device the session runs on;
    `max_len` is the whole conversation's token capacity (prompt deltas and
    answers of ALL turns). Deltas are left-padded to multiples of
    `delta_bucket`. vq_params/vq_cfg enable raw-pixels turns."""

    def __init__(self, params, cfg: LibraConfig, batch: int, max_len: int,
                 gen: Optional[GenerationConfig] = None, delta_bucket: int = 64,
                 mesh=None, vq_params=None, vq_cfg=None):
        if cfg.vision_prediction_mode == "2d":
            raise NotImplementedError(
                "ChatSession supports vision_prediction_mode='1d' only "
                "(the 2d hidden ring would need dynamic stitching across "
                "turns); use Generator/pipeline.chat for 2d checkpoints")
        if mesh is not None:
            raise NotImplementedError(
                "ChatSession(mesh=...): tensor-parallel chat is ROADMAP A13; "
                "the port runs on one device")
        if (vq_params is None) != (vq_cfg is None):
            raise ValueError("vq_params and vq_cfg must be given together "
                             "(raw-pixels turns need both)")
        self.cfg = cfg
        self.gen = gen or GenerationConfig()
        if self.gen.spec_decode:
            if self.gen.do_sample:
                raise ValueError("speculative chat turns are greedy-only "
                                 "(as Generator spec decode)")
            if self.gen.decode_modality == "dual":
                raise ValueError("spec_decode needs text-mode decode; "
                                 "decode_modality='dual' never drafts from history")
        self.B = batch
        self.delta_bucket = max(delta_bucket, 1)
        # spec turns write up to gamma + 1 slots past a row's budget: the
        # cache holds that margin past the conversation's slots. libra_tpu's
        # length: an int8 cache rounded up to 128 slots (its TPU kernel's
        # gate), so the same turn runs out of slots in both
        extra = int(self.gen.spec_decode) + 1 if self.gen.spec_decode else 0
        self.S = (-(-(max_len + extra) // 128) * 128 if self.gen.kv_quant
                  else max_len + extra)
        self._cap = self.S - extra      # the conversation's usable slots
        self.params = params
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        self.device = params["embed_tokens"].device
        self.reset()

    # -- state -------------------------------------------------------------

    def reset(self) -> None:
        """A fresh conversation: zeroed cache and mask, positions at -1; a
        spec session's token history zeroed."""
        with torch.inference_mode():
            self._cache = M.init_cache(self.cfg, self.B, self.S, device=self.device,
                                       quantized=self.gen.kv_quant)
            self._mask_buf = torch.zeros((self.B, self.S), dtype=torch.int64,
                                         device=self.device)
            self._pos_last = torch.full((self.B,), -1, dtype=torch.int64,
                                        device=self.device)
            # spec sessions carry the codebook-0 token history, so that the
            # drafter copies from earlier turns
            self._hist = (torch.zeros((self.B, self.S), dtype=torch.int64,
                                      device=self.device)
                          if self.gen.spec_decode else None)

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
        sampling without one). A spec session (gen.spec_decode) runs the
        turn's decode as draft+verify iterations (_spec_turn_impl); a turn
        whose delta ends inside an image block raises there. Returns the
        turn's tokens; the cache advances in place."""
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
        if self.used + Nb + max_new > self._cap:
            raise ValueError(
                f"turn needs {Nb}+{max_new} slots but only "
                f"{self._cap - self.used} of {self._cap} remain; raise "
                f"max_len or reset() the session")

        # the language-only decode body when every delta ends in text; a
        # delta ending inside an image block (t2i turn) decodes dual-path
        ends_in_text = bool((vi[:, -1] >= Mv).all())
        if gen.decode_modality == "text" and not ends_in_text:
            raise ValueError("decode_modality='text' needs deltas ending in text")
        lang_only = (ends_in_text if gen.decode_modality == "auto"
                     else gen.decode_modality == "text")
        if gen.spec_decode:
            if not lang_only:
                raise ValueError(
                    "a spec_decode session decodes text only; this turn "
                    "resolved decode_modality='dual' (delta ends inside an "
                    "image block): use a non-spec session for t2i turns")
            with torch.inference_mode():
                toks, num_gen, self._cache, self._pos_last = _spec_turn_impl(
                    self.params, self._cache, self._mask_buf, self._hist, ids,
                    vi, sig, pm, self._pos_last, self.vq_params, pixels,
                    img_start, cfg=cfg, gen=gen, max_new=max_new,
                    vq_cfg=self.vq_cfg)
            return TurnResult(tokens=toks, num_generated=num_gen)
        if gen.do_sample and generator is None:
            generator = torch.Generator(device=dev).manual_seed(self.used)
        with torch.inference_mode():
            toks, num_gen, self._cache, self._pos_last = _turn_impl(
                self.params, self._cache, self._mask_buf, ids, vi, sig, pm,
                self._pos_last, generator, self.vq_params, pixels, img_start,
                cfg=cfg, gen=gen, lang_only=lang_only, max_new=max_new,
                vq_cfg=self.vq_cfg)
        return TurnResult(tokens=toks, num_generated=num_gen)
