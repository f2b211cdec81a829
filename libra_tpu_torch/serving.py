"""Continuous-batching serving engine over a recycling slot pool.

The PyTorch counterpart of ``libra_tpu/serving.py``'s ``ServingEngine``,
dedicated and merged chunked prefill, speculative decode and the 2D modes
included (the tensor-parallel mesh is a later slice). A fixed pool of
``max_batch`` slots, each owning an INDEPENDENT timeline of the pooled KV
cache: the cache's index is a (B,) tensor of per-slot write offsets on
the device (``models/libra.KVCache``'s per-row mode). A finished slot is
refilled with the next queued request at position 0 of the SAME row:
stale K/V of the previous occupant is never attended, because every
position is written before a query reaches it. Slots therefore recycle
without end; the only capacity rule is per request: bucketed prompt +
max_new_tokens <= max_len.

Three device phases, driven by a host scheduler:
  * ``_prefill``: a GROUP of k same-bucket requests (k a power of two, up
    to the free slots) runs ONE B = k prompt pass, the Generator's, into a
    fresh cache piece of N slots, then the piece is copied into the k pool
    rows at [0, N)
    and the slots' state rows (mask, logits, vision index, position) are
    updated on the device. Requests may carry raw ``pixels`` + ``img_start``:
    CLIP + LFQ then run inside the prompt pass and the language projections
    run on the text rows only (``split_prefill``), as in the Generator.
    In 2D prediction mode each slot's (R - 1)-deep hidden ring is
    installed from the prompt pass; with 2D RoPE a slot's position is the
    base counter.
  * ``_decode``: ``decode_chunk`` lockstep one-token steps with every
    carried tensor on the device (inactive slots masked, per-slot budgets
    decremented there), and ONE host readback of the chunk's tokens and
    active flags at its end: nothing inside the chunk syncs.
  * ``_spec_decode`` (``gen.spec_decode`` = gamma > 0, greedy text
    streams): in place of ``_decode``, ``decode_chunk`` draft+verify
    iterations, each slot emitting its pending token and the accepted
    prefix of gamma bigram drafts from its own token history (1 to
    gamma + 1 tokens), one (gamma + 1)-token forward an iteration; the
    same single readback, of the emitted tokens and counts.
  * ``_merged`` (merged chunked prefill): when exactly one slot frees while
    the pool is busy, the next request's prompt is not prefilled in a pass
    that stalls every decoding slot. ``_install`` writes it into per-slot
    prompt buffers on the device, and each iteration of the merged chunk
    runs ONE forward over a token-packed axis of T = B + C positions: the
    B decode tokens, then the next C = ``merged_chunk`` prompt tokens of
    the first prefilling slot. The decode segment attends as the decode
    step does; the chunk segment attends its own cache row at C query
    rows. Chunked prefill computes what the wide prompt pass computes
    (equal tokens in fp32; in bf16 the chunk segment's plain attention
    rounds its scores to bf16, as libra_tpu's does, where the flash
    prompt pass keeps them in fp32). Like the decode chunk, it reads back
    once.
    Cold starts, raw-pixels requests and buckets that are not a multiple
    of C (or longer than the prompt buffers) keep the dedicated prefill;
    spec decode and either 2D mode turn merged prefill off.

The scheduler runs at most ONE prefill between decode chunks while any
slot is decoding, so a burst of queued prompts stalls the pool by one
prefill per chunk, not by the whole backlog; it drains freely when the
pool is idle. Requests may carry ``arrival_s`` (open-loop load): each is
admitted once its arrival passes, the scheduler sleeps while the pool is
idle, and TTFT is measured from arrival, at the readback of the chunk that
emitted the first token.

Greedy runs emit the tokens of the Generator on each request alone.
Sampling draws from a ``torch.Generator`` seeded 0 per ``run()`` on the
params' device (JAX's PRNG stream cannot be matched).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.generation import GenerationConfig
from libra_tpu_torch.generation import _prefill as _prompt_pass
from libra_tpu_torch.generation import (_last_position_logits, decode_micro_step,
                                        sample_tokens)
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.ops.attention import BIG_NEG, bridged_attention
from libra_tpu_torch.ops.norm import rms_norm
from libra_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from libra_tpu_torch.ops.routed import routed_linear, routed_low_rank, select_by_flag
from libra_tpu_torch.quantization import QuantizedArray
from libra_tpu_torch.spec_decode import _bigram_drafts, _update_window


@dataclass
class Request:
    request_id: int
    input_ids: np.ndarray        # (Q, N) combined-vocab ids
    vision_indices: np.ndarray   # (N,)
    contiguous_signal: Optional[np.ndarray] = None   # (N, S) or None
    max_new_tokens: int = 128
    # raw-image VQA path: pixels (side, side, 3) + the prompt position of
    # the 578-token image block (ids there are placeholders, overwritten
    # by the encode inside the prompt pass)
    pixels: Optional[np.ndarray] = None
    img_start: int = 0
    # open-loop load: seconds AFTER run() start at which this request
    # becomes visible to the scheduler (None = already queued at start)
    arrival_s: Optional[float] = None


@dataclass
class Result:
    request_id: int
    tokens: np.ndarray           # (Q, num_generated) generated ids
    finish_reason: str = "eos"   # "eos" | "length" | "capacity"
    ttft_s: Optional[float] = None   # arrival -> first-token readback
    #   (arrival = run start when the request carries no arrival_s)


class SlotState(NamedTuple):
    """The pool's device state, one row per slot."""
    cache: M.KVCache          # index: (B,) per-slot write offsets
    mask: torch.Tensor        # (B, S) attention mask of each timeline
    logits: torch.Tensor      # (Q, B, Vc) next-token logits
    vi_last: torch.Tensor     # (B,) vision index of the last token
    pos_last: torch.Tensor    # (B,) position of the last token
    hist: Optional[torch.Tensor] = None   # (B, S) codebook-0 token history
    #   (spec decode's drafting; None without spec decode)
    ring: Optional[torch.Tensor] = None   # (B, R - 1, D) 2D prediction's
    #   hidden ring per slot (None in 1D mode), advanced in place


class PromptBuffers(NamedTuple):
    """Merged chunked prefill's per-slot prompts on the device, Np wide:
    what _install writes and each merged iteration slices C of."""
    ids: torch.Tensor         # (Q, B, Np) combined-vocab ids
    vi: torch.Tensor          # (B, Np) vision indices
    pm: torch.Tensor          # (B, Np) prompt mask (0 on the bucket padding)
    pos: torch.Tensor         # (B, Np) position ids (pads pinned to 1)
    sig: torch.Tensor         # (B, Np, signal) fp32 continuous signal


def _copy_piece(pool, piece, slots: torch.Tensor, N: int) -> None:
    """Copy a B = k cache piece's N positions into pool rows `slots` at
    [0, N): one indexed write per buffer (a QuantizedArray's q and scale
    are head-major, their sequence axis third). It takes the place of
    libra_tpu's gather of the k whole rows before the prompt pass and
    their scatter back after it: keys past N are masked, so only what the
    prompt wrote moves."""
    if pool is None:
        return
    if isinstance(pool, QuantizedArray):
        pool.q[:, slots, :, :N] = piece.q
        pool.scale[:, slots, :, :N] = piece.scale
    else:
        pool[:, slots, :N] = piece


class ServingEngine:
    """Lockstep continuous batching over a recycling slot pool.

    >>> eng = ServingEngine(params, cfg, max_batch=4, max_len=2048)
    >>> results = eng.run([Request(...), ...])     # any number of requests
    """

    def __init__(self, params, cfg: LibraConfig, max_batch: int = 4,
                 max_len: int = 2048,
                 gen: Optional[GenerationConfig] = None, mesh=None,
                 prompt_bucket: int = 0, decode_chunk: int = 8,
                 vq_params=None, vq_cfg=None,
                 merged_prefill: Optional[bool] = None,
                 merged_chunk: int = 64,
                 max_prefill_group: Optional[int] = None):
        """params (and vq_params) live on the device the engine runs on.
        prompt_bucket > 1 rounds prompt lengths up to a multiple (left
        padding inside the slot), so prompt passes come in few shapes.
        decode_chunk: decode steps between two host readbacks.
        vq_params/vq_cfg enable raw-pixels requests (fused encode).
        merged_prefill: None = on where supported (no spec decode, 1d
        prediction, 1d RoPE, and the cache holds a merged_chunk margin:
        max_len >= 2 * merged_chunk), as in libra_tpu; True forces it (raising where
        unsupported); False disables it. merged_chunk: the prompt tokens
        C each merged iteration consumes. max_prefill_group caps the grouped refill's k.
        The pool's length is max_len (libra_tpu rounds an int8 cache's up
        to 128 for its TPU kernel; the port's kernel needs no rounding),
        so merged_prefill=None resolves as libra_tpu's does wherever the
        two pools are as long."""
        if mesh is not None:
            raise NotImplementedError(
                "ServingEngine(mesh=...): tensor-parallel serving is ROADMAP "
                "A13; the port serves on one device")
        if (vq_params is None) != (vq_cfg is None):
            raise ValueError("vq_params and vq_cfg must be given together "
                             "(raw-pixels prefill needs both)")
        self.cfg = cfg
        self.gen = gen or GenerationConfig()
        self.params = params
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        self.device = params["embed_tokens"].device
        self.prompt_bucket = prompt_bucket
        self.decode_chunk = max(1, decode_chunk)
        # the prompt pass's config: a cache of the prompt's N slots only
        self._piece_gen = dataclasses.replace(self.gen, max_new_tokens=0)
        self.B = max_batch
        self.S = max_len
        # the prompt-pass shapes run so far, (N, has_pixels, k)
        self._prefill_shapes: set = set()
        # grouped-refill sizes: powers of two up to max_batch (optionally
        # capped), so prompt passes come in log2(B) + 1 batch sizes
        self._group_sizes = [1]
        cap = min(max_batch, max_prefill_group or max_batch)
        while self._group_sizes[-1] * 2 <= cap:
            self._group_sizes.append(self._group_sizes[-1] * 2)
        # merged chunked prefill. Np: the prompt buffers' width, the
        # largest multiple of C that leaves a C-wide parking margin in S
        self._C = int(merged_chunk)
        self._Np = max(0, (self.S - self._C) // self._C * self._C)
        # iterations a merged chunk runs: where every eligible prompt is one
        # bucket (bucket % C == 0), the largest divisor of bucket / C that
        # fits decode_chunk, so that an install ends at a chunk's end and
        # no iteration parks; else decode_chunk
        if self.prompt_bucket > 1 and self.prompt_bucket % self._C == 0:
            n_iters = self.prompt_bucket // self._C
            self._Km = max(d for d in range(1, min(self.decode_chunk, n_iters) + 1)
                           if n_iters % d == 0)
        else:
            self._Km = self.decode_chunk
        # speculative decoding (gen.spec_decode = gamma > 0): the decode
        # chunk becomes draft+verify iterations emitting up to gamma + 1
        # tokens a slot an iteration, with the Generator's restrictions
        # (greedy, text-resolved streams)
        self._gamma = int(self.gen.spec_decode or 0)
        if self._gamma:
            if self.gen.do_sample:
                raise ValueError("spec_decode requires greedy decoding")
            if self.gen.decode_modality == "dual":
                raise ValueError("spec_decode is text-mode only (decode_modality "
                                 "'text' or 'auto' over an all-text stream)")
        # libra_tpu's rule: no spec decode, no 2D mode, a C-wide margin
        supported = (self._gamma == 0 and cfg.vision_prediction_mode != "2d"
                     and not cfg.use_2d_rope and self._Np >= self._C)
        if merged_prefill and not supported:
            raise ValueError(
                "merged_prefill needs spec_decode == 0, 1d prediction, "
                "1d RoPE and max_len >= 2 * merged_chunk")
        self._merged_on = supported if merged_prefill is None else bool(merged_prefill)
        self.stats = {"merged_installs": 0, "merged_chunks": 0,
                      "dedicated_prefills": 0}
        self.last_run_stats: Dict[str, Any] = {}

    def _init_state(self) -> SlotState:
        """An empty pool: a cache of max_batch rows x S slots with a (B,)
        index on the device, and zeroed slot rows."""
        cfg, B, S, dev = self.cfg, self.B, self.S, self.device
        cache = M.init_cache(cfg, B, S, device=dev, quantized=self.gen.kv_quant)
        cache = cache._replace(index=torch.zeros((B,), dtype=torch.int64,
                                                 device=dev))
        return SlotState(
            cache=cache,
            mask=torch.zeros((B, S), dtype=torch.int64, device=dev),
            logits=torch.zeros((cfg.vision_codebook_num, B,
                                cfg.combined_vocab_size), dtype=torch.float32,
                               device=dev),
            vi_last=torch.full((B,), cfg.max_vision_token_length,
                               dtype=torch.int64, device=dev),
            pos_last=torch.zeros((B,), dtype=torch.int64, device=dev),
            hist=(torch.zeros((B, S), dtype=torch.int64, device=dev)
                  if self._gamma else None),
            ring=(torch.zeros((B, max(cfg.image_feature_resolution - 1, 1),
                               cfg.hidden_size), dtype=cfg.compute_dtype, device=dev)
                  if cfg.vision_prediction_mode == "2d" else None))

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: on the card through pinned
        memory and an asynchronous copy, which does not wait for the
        stream (a pageable copy would)."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(np.shape(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- device phases ------------------------------------------------------

    def _prefill(self, N: int, has_pixels: bool, k: int, state: SlotState,
                 reqs, slots: torch.Tensor) -> SlotState:
        """One prompt pass for a group of k same-bucket requests as a
        B = k batch, written into their k slots' rows at [0, N). `reqs`:
        the k staged requests (padded to N on the device); `slots`: their
        (k,) slot indices on the device. `pm` carries each request's real
        extent (zeros on the left bucket padding). The pass is the
        Generator's own (generation._prefill, raw pixels and the split
        included) with no room for new tokens, so its cache is a piece of
        N slots. The piece and the slot rows update on the device, with no
        host read."""
        self._prefill_shapes.add((N, has_pixels, k))
        ids = torch.stack([r["ids"] for r in reqs], dim=1)     # (Q, k, N)
        vi = torch.stack([r["vi"] for r in reqs])              # (k, N)
        pmask = torch.stack([r["pm"] for r in reqs])           # (k, N)
        sig = pixels = img_start = None
        if has_pixels:
            pixels = torch.stack([r["px"] for r in reqs])
            img_start = torch.stack([r["st"] for r in reqs])
        else:
            sig = torch.stack([r["sig"] for r in reqs])
        st = _prompt_pass(self.params, ids, pmask, vi, sig, self.vq_params,
                          pixels, img_start, cfg=self.cfg, gen=self._piece_gen,
                          vq_cfg=self.vq_cfg)
        pool = state.cache
        for name in ("k", "v", "kb", "vb"):
            _copy_piece(getattr(pool, name), getattr(st.cache, name), slots, N)
        pool.flag[slots, :N] = st.cache.flag
        pool.index[slots] = N
        row = pmask.new_zeros((k, self.S))
        row[:, :N] = pmask
        state.mask[slots] = row
        state.logits[:, slots] = st.logits
        state.vi_last[slots] = st.vi_last
        state.pos_last[slots] = st.last_pos
        if state.ring is not None:
            state.ring[slots] = st.ring.to(state.ring.dtype)
        if state.hist is not None:
            # codebook-0 token history for the drafter (the fused ids with
            # pixels; the bucket's pad slots carry mask 0, never drafted)
            state.hist[slots, :N] = st.tokens[0, :, :N]
        return state

    def _decode(self, state: SlotState, flags: torch.Tensor, lang_only: bool,
                generator: Optional[torch.Generator]):
        """`decode_chunk` lockstep one-token steps. flags: (2, B) int64 on
        the device, the slots' active flags and budgets. Per-slot cache
        indices advance independently; inactive slots compute garbage that
        the host ignores (their rows are rewritten on refill). Budgets
        decrement on the device, so the host replays the active-flag
        transitions from the returned tokens and actives alone. Returns
        (out (K, Q + 1, B) int64 on the device: each step's tokens, then
        its active flags; the new state). Nothing here reads the device on
        the host: the caller's readback of `out` is the chunk's one sync."""
        cfg, gen, params = self.cfg, self.gen, self.params
        cache, mask, logits, vi_last, pos_last, hist, ring = state
        active, budget = flags[0].bool(), flags[1]
        toks, acts = [], []
        for _ in range(self.decode_chunk):
            tok = sample_tokens(logits, gen, generator)               # (Q, B)
            tok = torch.where(active[None], tok, gen.pad_token_id)
            eos_hit = (tok == gen.eos_token_id).any(dim=0) & active
            budget = budget - active.long()
            active_next = active & ~eos_hit & (budget > 0)
            mask = M._write_seq(mask, active[:, None], cache.index)
            logits, cache, vi_last, pos_last = decode_micro_step(
                params, cfg, tok, mask, cache, vi_last, pos_last,
                active=active, lang_only=lang_only, ring=ring)
            toks.append(tok)
            acts.append(active)
            active = active_next
        out = torch.cat([torch.stack(toks), torch.stack(acts)[:, None].long()], 1)
        return out, SlotState(cache, mask, logits, vi_last, pos_last, hist, ring)

    def _spec_decode(self, state: SlotState, flags: torch.Tensor):
        """The speculative decode chunk: `decode_chunk` draft+verify
        iterations. Each iteration, per slot: the PENDING token (the
        argmax of the carried logits: known, its K/V not yet cached) is
        emitted, gamma bigram drafts are taken from the slot's own token
        history (spec_decode._bigram_drafts), and ONE (gamma+1)-token
        cached forward verifies them; the accepted prefix is emitted too,
        so an active slot emits 1 to gamma + 1 tokens an iteration.
        Exactness: every emitted token is the model's own greedy argmax.

        Unlike spec_decode._spec_generate_impl, the bonus token is not
        emitted in the iteration that computes it: it becomes the next
        iteration's pending through the carried logits, so refills need
        no special case. Inactive slots run the verify on garbage confined
        to their own rows (cnt = 0 puts their mask window back to zeros),
        as in the standard chunk. flags: (2, B) int64 on the device, the
        active flags and budgets. Returns (out (K, B, gamma + 2) int64 on
        the device: each iteration's block of pending + drafts, then its
        count of emitted tokens; the new state). Nothing here reads the
        device on the host: the caller's readback of `out` is the chunk's
        one sync."""
        cfg, gen, params = self.cfg, self.gen, self.params
        gamma, K = self._gamma, self._gamma + 1
        Q, Mv = cfg.vision_codebook_num, cfg.max_vision_token_length
        cache, mask, logits, vi_last, pos_last, hist, ring = state
        active, budget = flags[0].bool(), flags[1]
        B, S = mask.shape
        dev = mask.device
        idx, ar = torch.arange(S, device=dev), torch.arange(K, device=dev)[None]
        ones = torch.ones((K,), dtype=mask.dtype, device=dev)
        vi_blk = torch.full((B, K), Mv, dtype=torch.int64, device=dev)
        text_flag = torch.zeros((B,), dtype=torch.bool, device=dev)
        text_vi = torch.full((B,), Mv, dtype=torch.int64, device=dev)
        outs = []
        for _ in range(self.decode_chunk):
            P = cache.index                                           # (B,)
            pending = torch.argmax(logits[0], dim=-1)
            pending = torch.where(active, pending, gen.pad_token_id)
            # pending at slot P, for the bigram matcher
            _update_window(hist, pending[:, None], P, active[:, None])
            valid = (mask > 0) | (idx[None] == P[:, None])
            drafts = _bigram_drafts(hist, valid, P, pending, gamma)
            x = torch.cat([pending[:, None], drafts], dim=1)          # (B, K)

            # one (gamma+1)-token verify forward at per-row windows
            _update_window(mask, ones, P)
            out = M.forward(params, cfg, x[None].expand(Q, B, K), mask, vi_blk,
                            None, position_ids=M.rope_positions(
                                cfg, pos_last[:, None] + 1 + ar, vi_blk),
                            cache=cache, lang_only=True)
            c = torch.argmax(M.compute_text_logits(params, out.hidden_states), dim=-1)

            # the accepted draft prefix; the emitted block is pending + it
            ok = drafts == c[:, :gamma]
            a = torch.cumprod(ok.long(), dim=1).sum(dim=1)
            eos_in = (x == gen.eos_token_id) & (ar <= a[:, None])
            any_eos = eos_in.any(dim=1)
            first_eos = eos_in.long().argmax(dim=1)
            cnt = torch.where(any_eos, first_eos + 1, a + 1)
            cnt = torch.minimum(cnt, budget)
            cnt = torch.where(active, cnt, 0)
            budget = budget - cnt
            active = active & ~(any_eos & (first_eos < cnt)) & (budget > 0)

            # the emitted tokens into the history; exactly cnt cached slots
            keep = ar < cnt[:, None]
            _update_window(hist, x, P, keep)
            _update_window(mask, keep.to(mask.dtype), P)
            cache = out.cache._replace(index=P + cnt)
            pos_last = pos_last + cnt

            # the next pending rides the carried logits: the verify output
            # at the last kept position predicts the token after the
            # accepted prefix (the bonus when nothing truncated)
            h_sel = out.hidden_states.gather(1, (cnt - 1).clamp_min(0)[:, None, None]
                                             .expand(B, 1, out.hidden_states.shape[-1]))
            logits = _last_position_logits(params, cfg, h_sel, text_flag, text_vi,
                                           lang_only=True)
            outs.append(torch.cat([x, cnt[:, None]], dim=1))
        return torch.stack(outs), SlotState(cache, mask, logits, vi_last, pos_last,
                                            hist, ring)

    def _init_prompts(self) -> PromptBuffers:
        cfg, B, Np, dev = self.cfg, self.B, self._Np, self.device
        return PromptBuffers(
            ids=torch.zeros((cfg.vision_codebook_num, B, Np), dtype=torch.int64,
                            device=dev),
            vi=torch.full((B, Np), cfg.max_vision_token_length, dtype=torch.int64,
                          device=dev),
            pm=torch.zeros((B, Np), dtype=torch.int64, device=dev),
            pos=torch.ones((B, Np), dtype=torch.int64, device=dev),
            sig=torch.zeros((B, Np, cfg.contiguous_signal_size), dtype=torch.float32,
                            device=dev))

    def _install(self, state: SlotState, prompts: PromptBuffers, req,
                 slot: int) -> None:
        """Install one staged request (padded to its bucket Nb, on the
        device) into slot `slot`, in place: zero the slot's mask row, reset
        its cache index, and write its ids, vision indices, mask, positions
        and signal at [0, Nb) of the slot's prompt-buffer rows (past Nb
        the rows keep what they held). A handful of small writes instead
        of a prompt pass; the merged chunks then consume the prompt C
        tokens an iteration while the other slots decode."""
        Nb = req["ids"].shape[-1]
        state.mask[slot] = 0
        state.cache.index[slot] = 0
        prompts.ids[:, slot, :Nb] = req["ids"]
        prompts.vi[slot, :Nb] = req["vi"]
        prompts.pm[slot, :Nb] = req["pm"]
        prompts.pos[slot, :Nb] = req["pos"]
        prompts.sig[slot, :Nb] = req["sig"]

    def _packed_layer(self, p, bufs, li: int, h, flag, cos, sin, pos, P_dec,
                      dec_slots, pf_slot, off_w, has_pf, kv_flag, bias_dec, bias_ch):
        """One decoder layer over the packed axis h (1, T, D): tokens [0, B)
        are the slots' decode tokens (column b belongs to cache row b),
        tokens [B, T) the prompt chunk of row `pf_slot` at `off_w`. The
        projections, norms and MLP run on all T rows (models/libra's own
        pieces); the cache writes and the attention split into the two
        segments. The decode segment is the engine's one-token step:
        written at P_dec, attended through the int8 decode kernel on an
        int8 cache, else the plain attention. The chunk segment is written
        with _write_cache_row (value-masked when no slot prefills, the
        chunk then parked) and attends its own row at C query rows through
        the plain attention over the dequantized row, as libra_tpu runs it
        outside any kernel."""
        cfg, B = self.cfg, self.B
        H, eps, am = cfg.num_attention_heads, cfg.rms_norm_eps, cfg.addition_mode
        a = p["attn"]

        def rnorm(x, name):
            return select_by_flag(flag, rms_norm(x, p["vision_" + name], eps),
                                  rms_norm(x, p[name], eps))

        hn = rnorm(h, "input_layernorm")

        def rproj(name):
            vp = a["vision_" + name[0]]
            return M._split_heads(routed_linear(hn, flag, a[name], vp["wa"], vp["wb"],
                                                am), H)

        q = apply_rope(rproj("q_proj"), cos, sin, pos)
        k = apply_rope(rproj("k_proj"), cos, sin, pos)
        new = {"k": k, "v": rproj("v_proj")}
        if cfg.use_bridge:
            new["kb"], new["vb"] = (M._split_heads(routed_low_rank(
                hn, flag, a[f"{x}_bridge_lang"]["wa"], a[f"{x}_bridge_lang"]["wb"],
                a[f"{x}_bridge_vis"]["wa"], a[f"{x}_bridge_vis"]["wb"]), H)
                for x in ("k", "v"))
            new["kb"] = apply_rope(new["kb"], cos, sin, pos)
        for name, x in new.items():
            # the decode tokens first: a parked chunk's window overlaps the
            # just-finished row's decode position, whose write must survive
            M._write_cache(bufs[name], x[0, :B][:, None], li, P_dec, dec_slots)
            M._write_cache_row(bufs[name], x[:, B:], li, pf_slot, off_w, write=has_pf)
        ck, cv = bufs["k"][li], bufs["v"][li]
        ckb, cvb = (bufs["kb"][li], bufs["vb"][li]) if cfg.use_bridge else (None, None)
        q_dec, q_ch = q[0, :B][:, None], q[:, B:]
        flag_dec = flag[0, :B][:, None]

        # decode segment: the engine's one-token step, row b at P_dec[b]
        if M.decode_kernel_applicable(ck, 1, cfg.head_dim):
            bridge = {} if ckb is None else dict(kbq=ckb.q, kbs=ckb.scale,
                                                 vbq=cvb.q, vbs=cvb.scale)
            dec_out = M.int8_decode_attention(q_dec, ck.q, ck.scale, cv.q, cv.scale,
                                              flag_q=flag_dec, kv_flag=kv_flag,
                                              bias=bias_dec, **bridge)
        else:
            rd = lambda view: None if view is None else M._read_cache(view, q.dtype)  # noqa: E731
            dec_out = bridged_attention(q_dec, rd(ck), rd(cv), rd(ckb), rd(cvb),
                                        flag_dec, kv_flag, bias_dec[:, None])

        # chunk segment: C query rows against their own cache row
        def rdrow(view):
            return None if view is None else M._read_cache(view[pf_slot], q.dtype)

        ch_out = bridged_attention(q_ch, rdrow(ck), rdrow(cv), rdrow(ckb), rdrow(cvb),
                                   flag[:, B:], kv_flag[pf_slot], bias_ch)
        attn = torch.cat([dec_out[:, 0][None], ch_out], dim=1).reshape(h.shape)
        vo = a["vision_o"]
        h = h + routed_linear(attn, flag, a["o_proj"], vo["wa"], vo["wb"], am)
        return h + M._mlp(p, cfg, rnorm(h, "post_attention_layernorm"), flag)

    def _merged(self, state: SlotState, prompts: PromptBuffers, flags: torch.Tensor,
                generator: Optional[torch.Generator]):
        """The merged chunked-prefill chunk: _Km iterations, each ONE
        forward over a token-packed axis of T = B + C positions, the B
        decode tokens then the next C prompt tokens of the first
        prefilling slot (FIFO by slot index). flags: (6, B) int64 on the
        device, the slots' active flags, budgets, prefilling flags, prompt
        offsets, prompt lengths and the budgets they take on once their
        prompt is in. Prefilling rows are re-anchored at their prompt
        offset (their index advanced with the others before the install).
        Once the last chunk of a prompt is in, its row carries the
        prompt-end logits and decodes from the next iteration on, its
        budget handed over, all on the device. Iterations with no slot
        prefilling "park" the chunk on the just-finished row at its prompt
        end: the window's K/V, mask and flag writes are value-masked
        no-ops there (the row's own decode writes overwrite that K/V
        before its mask reaches it). Returns (out (K, Q + 1, B) int64 on
        the device: each iteration's tokens, then its active flags; the
        new state). Nothing here reads the device on the host; the
        prompt buffers are only read."""
        cfg, gen, params, B, C, Np = self.cfg, self.gen, self.params, self.B, self._C, self._Np
        Q, Mv = cfg.vision_codebook_num, cfg.max_vision_token_length
        cache, mask, last_logits, vi_last, pos_last, hist, ring = state
        S, T, dev = mask.shape[1], B + C, mask.device
        active, budget = flags[0].bool(), flags[1]
        pf, pf_off, pf_len, pf_budget = flags[2].bool(), flags[3], flags[4], flags[5]
        pf_slot = pf.long().argmax(dim=0, keepdim=True)             # (1,)
        park_off = torch.zeros_like(pf_slot)
        arC, idxS = torch.arange(C, device=dev), torch.arange(S, device=dev)
        cos, sin = rope_cos_sin(max(cfg.max_position_embeddings, S), cfg.head_dim,
                                cfg.rope_theta, device=dev)
        bufs = {"k": cache.k, "v": cache.v}
        if cfg.use_bridge:
            bufs.update({"kb": cache.kb, "vb": cache.vb})
        toks, acts = [], []
        for _ in range(self._Km):
            has_pf = pf.any()
            pf_slot = torch.where(has_pf, pf.long().argmax(dim=0, keepdim=True), pf_slot)
            off, plen = pf_off[pf_slot], pf_len[pf_slot]             # (1,)
            off_w = torch.where(has_pf, off, park_off)
            P_dec = torch.where(pf, pf_off, cache.index)              # (B,)

            tok = sample_tokens(last_logits, gen, generator)          # (Q, B)
            tok = torch.where(active[None], tok, gen.pad_token_id)
            eos_hit = (tok == gen.eos_token_id).any(dim=0) & active
            vi_dec = torch.where(active, torch.clamp_max(vi_last + 1, Mv), vi_last)
            pos_dec = torch.where(active, pos_last + 1, pos_last)

            # the chunk's prompt slices, their start clamped to [0, Np - C]
            # as dynamic_slice clamps it (a parked chunk sits at Np)
            row, cols = pf_slot[:, None], (off_w.clamp(0, Np - C) + arC)[None]
            ch_ids = prompts.ids[:, row, cols][:, 0]                  # (Q, C)
            ch_vi, ch_pm = prompts.vi[row, cols][0], prompts.pm[row, cols][0]
            ch_pos, ch_sig = prompts.pos[row, cols][0], prompts.sig[row, cols][0]
            ids_p = torch.cat([tok, ch_ids], dim=1)[:, None]          # (Q, 1, T)
            vi_p = torch.cat([vi_dec, ch_vi])[None]                   # (1, T)
            pos_p = torch.cat([pos_dec, ch_pos])[None]
            sig_p = torch.cat([ch_sig.new_zeros((B, ch_sig.shape[-1])), ch_sig])[None]
            flag_p = vi_p < Mv

            # mask and flag writes: the decode columns as the decode step
            # writes them; the prompt window value-masked (parked: no-op)
            dec_slots = M.row_slots(P_dec, S, 1)
            mask = M._write_seq(mask, active[:, None], P_dec, dec_slots)
            win = (off_w.clamp(0, S - C) + arC)[None]
            mask[row, win] = torch.where(has_pf, ch_pm[None], mask[row, win])
            kvf = M._write_seq(cache.flag, (vi_dec < Mv)[:, None], P_dec, dec_slots)
            kvf[row, win] = torch.where(has_pf, (ch_vi < Mv)[None], kvf[row, win])

            keep = mask.bool()
            bias_dec = torch.where((idxS[None] <= P_dec[:, None]) & keep, 0.0,
                                   BIG_NEG).float()[:, None]          # (B, 1, S)
            qs_ch = off_w + arC
            bias_ch = torch.where((idxS[None] <= qs_ch[:, None]) & keep[pf_slot], 0.0,
                                  BIG_NEG).float()[None, None]        # (1, 1, C, S)

            h = M.embed_inputs(params, cfg, ids_p, flag_p, sig_p, vi_p)
            for li in range(cfg.num_hidden_layers):
                h = self._packed_layer(M._layer(params["layers"], li), bufs, li, h,
                                       flag_p, cos, sin, pos_p, P_dec, dec_slots,
                                       pf_slot, off_w, has_pf, kvf, bias_dec, bias_ch)
            eps = cfg.rms_norm_eps
            h = select_by_flag(flag_p, rms_norm(h, params["vision_norm"], eps),
                               rms_norm(h, params["norm"], eps))
            logits_dec = _last_position_logits(params, cfg, h[0, :B][:, None],
                                               vi_dec < Mv, vi_dec)
            logits_ch = _last_position_logits(params, cfg, h[:, T - 1:],
                                              ch_vi[-1:] < Mv, ch_vi[-1:])

            # the prefilling row's transitions
            pf_done = has_pf & (off + C >= plen)                      # (1,)
            rowsel = (torch.arange(B, device=dev) == pf_slot) & has_pf
            last_logits = torch.where(active[None, :, None], logits_dec, last_logits)
            last_logits = torch.where(rowsel[None, :, None], logits_ch, last_logits)
            vi_last = torch.where(rowsel, ch_vi[-1], torch.where(active, vi_dec, vi_last))
            pos_last = torch.where(rowsel, ch_pos[-1],
                                   torch.where(active, pos_dec, pos_last))
            index = torch.where(rowsel, off + C, P_dec + active.long())
            cache = cache._replace(flag=kvf, index=index)
            toks.append(tok)
            acts.append(active)
            budget = budget - active.long()
            active_next = active & ~eos_hit & (budget > 0)
            pf_off = torch.where(rowsel, off + C, pf_off)
            budget = torch.where(rowsel & pf_done, pf_budget, budget)
            active = active_next | (rowsel & pf_done)
            pf = pf & ~(rowsel & pf_done)
            park_off = torch.where(pf_done, off + C, park_off)
        out = torch.cat([torch.stack(toks), torch.stack(acts)[:, None].long()], 1)
        return out, SlotState(cache, mask, last_logits, vi_last, pos_last, hist, ring)

    def warmup(self, example: Request, max_new: Optional[int] = None):
        """Run `example`-shaped synthetic requests through run() in the
        patterns the scheduler dispatches, so that first-call costs (kernel
        builds, allocator growth) land here and not on a served request:

          * a 2B-1 staggered burst: the k = B grouped prefill, then, as
            slots free one at a time while the others decode, merged
            installs and merged chunks (or k = 1 refills, where the
            example is not merged-eligible), and the decode chunk;
          * one g-request run on an idle pool per smaller group size g.

        The burst's budgets are decode_chunk * (i % B + 1), whatever
        `max_new` says (as in libra_tpu; `max_new` sizes the idle-pool
        runs). Results are discarded; the slot state resets per run()."""
        B = self.B
        mn = max_new if max_new is not None else self.decode_chunk

        def mk(n, stagger=False):
            reqs = []
            for i in range(n):
                r = copy.copy(example)
                r.request_id = -1 - i
                r.arrival_s = None
                # staggered budgets span several chunks, so slots free at
                # different readbacks
                r.max_new_tokens = self.decode_chunk * (i % B + 1) \
                    if stagger else mn
                reqs.append(r)
            return reqs

        self.run(mk(2 * B - 1, stagger=True))
        for g in self._group_sizes:
            if g != B:
                self.run(mk(g))

    # -- host-side scheduler -------------------------------------------------

    @torch.inference_mode()
    def run(self, requests: List[Request], on_token=None) -> List[Result]:
        """Serve `requests` to completion; results sorted by request_id.

        on_token(request_id, token, finish_reason): streaming callback,
        called from this thread per emitted token. `token` is the (Q,)
        generated ids (None for zero-token capacity rejections);
        `finish_reason` is None mid-stream and "eos"/"length"/"capacity"
        on the request's final event.

        last_run_stats: host wall time per branch (t_decode, t_merged,
        t_spec, t_prefill, t_install, t_sleep; the device time of a prefill
        or an install lands on the next readback), counts (n_decode,
        n_merged and n_spec chunks, n_prefill passes, n_install installs,
        iters = decode, merged and spec iterations, active_iters = active
        slot-iterations (in a spec chunk those that emitted), tokens =
        tokens emitted), and the group size of each prefill
        (group_sizes)."""
        cfg, gen, B, S, gamma = self.cfg, self.gen, self.B, self.S, self._gamma
        Q, Mv = cfg.vision_codebook_num, cfg.max_vision_token_length
        tails_text = [np.asarray(r.vision_indices)[-1] >= Mv for r in requests]
        if gen.decode_modality == "text":
            for r, ok in zip(requests, tails_text):
                if not ok:
                    raise ValueError(
                        "decode_modality='text' needs prompts ending in "
                        "text; request %r ends inside an image block"
                        % (r.request_id,))
        # 'auto': the whole stream is known at entry; if every request ends
        # in text, this run's decode can be the exact lang-only body
        lang_only = (gen.decode_modality == "text"
                     or (gen.decode_modality == "auto" and all(tails_text)))
        if self._gamma and not lang_only:
            raise ValueError("spec_decode is text-mode only: this stream carries "
                             "a request ending inside an image block")
        # validate up front: raising from inside the scheduling loop would
        # discard every already-completed Result
        for r in requests:
            if r.pixels is None:
                continue
            if self.vq_params is None:
                raise ValueError(
                    "request %r carries pixels but the engine was "
                    "built without vq_params/vq_cfg" % (r.request_id,))
            side = self.vq_cfg.clip.image_size
            if tuple(r.pixels.shape) != (side, side, 3):
                raise ValueError(
                    "request %r pixels shape %r != the engine's CLIP "
                    "input (%d, %d, 3)" % (r.request_id, tuple(r.pixels.shape),
                                           side, side))
        # stable sort by arrival: ties (and the all-None burst) keep
        # submission order
        queue = sorted(requests, key=lambda r: r.arrival_s or 0.0)
        results: List[Result] = []
        rs = self.last_run_stats = {
            "t_decode": 0.0, "t_merged": 0.0, "t_spec": 0.0,
            "t_prefill": 0.0, "t_install": 0.0, "t_sleep": 0.0,
            "n_decode": 0, "n_merged": 0, "n_spec": 0, "n_prefill": 0,
            "n_install": 0, "tokens": 0, "active_iters": 0, "iters": 0,
            "group_sizes": []}
        t0 = time.perf_counter()

        def n_arrived():
            """Length of the leading queue prefix visible to the scheduler
            (queue is arrival-sorted, so visibility is a prefix)."""
            now = time.perf_counter() - t0
            n = 0
            for r in queue:
                if r.arrival_s is not None and r.arrival_s > now:
                    break
                n += 1
            return n

        state = self._init_state()
        active = np.zeros((B,), bool)
        budget = np.zeros((B,), np.int64)
        slot_req: List[Optional[Request]] = [None] * B
        slot_toks: List[List[np.ndarray]] = [[] for _ in range(B)]
        slot_ttft: List[Optional[float]] = [None] * B
        generator = (torch.Generator(device=self.device).manual_seed(0)
                     if gen.do_sample else None)
        # merged chunked prefill: the prompt buffers on the device, and host
        # mirrors of the device's prefill state (its transitions are
        # deterministic, so the host replays them from the readback alone)
        mg, C, Np = self._merged_on, self._C, self._Np
        prompts = self._init_prompts() if mg else None
        pf_active = np.zeros((B,), bool)
        pf_rem = np.zeros((B,), np.int64)     # merged iterations left
        pf_off = np.zeros((B,), np.int64)
        pf_len = np.zeros((B,), np.int64)
        pf_budget = np.zeros((B,), np.int64)

        def bucketed(n):
            b = self.prompt_bucket
            return n if b <= 1 else -(-n // b) * b

        def merged_eligible(req) -> bool:
            # Nb <= Np leaves the parking margin Nb + C <= S
            if not mg or req.pixels is not None:
                return False
            Nb = bucketed(req.input_ids.shape[-1])
            return Nb % C == 0 and Nb <= Np

        staged: Dict[int, Any] = {}

        def stage(req):
            """One request's arrays padded to its bucket, on the device."""
            n = req.input_ids.shape[-1]
            pad = bucketed(n) - n
            pm = np.zeros((bucketed(n),), np.int64)
            pm[pad:] = 1
            d = {"ids": np.pad(np.asarray(req.input_ids, np.int64),
                               ((0, 0), (pad, 0)), constant_values=gen.pad_token_id),
                 "vi": np.pad(np.asarray(req.vision_indices, np.int64), ((pad, 0),),
                              constant_values=Mv),
                 "pm": pm}
            if req.pixels is not None:
                d["px"] = np.asarray(req.pixels)
                d["st"] = np.asarray(req.img_start + pad, np.int64)
            else:
                s = req.contiguous_signal
                s = (np.asarray(s, np.float32) if s is not None
                     else np.zeros((n, cfg.contiguous_signal_size), np.float32))
                d["sig"] = np.pad(s, ((pad, 0), (0, 0)))
                if mg:
                    # the merged chunks' position ids, as
                    # position_ids_from_mask gives them (pads pinned to 1)
                    pos = np.cumsum(pm) - 1
                    d["pos"] = np.where(pm == 0, 1, pos)
            return {key: self._to_device(a) for key, a in d.items()}

        def prestage():
            """Stage up to 2B arrived requests ahead of need."""
            n = 0
            for r in queue[:n_arrived()]:
                if n >= 2 * B:
                    break
                if bucketed(r.input_ids.shape[-1]) + r.max_new_tokens + gamma > S:
                    continue    # try_fill rejects it; copy nothing
                if r.request_id not in staged:
                    staged[r.request_id] = stage(r)
                n += 1

        def try_fill(limit: Optional[int] = None):
            """Fill free slots from the queue. A merged-eligible head is
            INSTALLED while the pool is busy and exactly one slot is free,
            so its prompt rides the merged chunks (with two or more free, a
            grouped prefill fills them all in one pass). Otherwise each
            prefill takes a GROUP of up-to-len(free) head-of-queue requests
            sharing a (prompt bucket, pixels?, pixel shape) and runs it as
            one B = k pass (k the largest allowed group size). `limit`
            bounds the prefills (1 while slots are decoding); installs
            stall nothing and are not counted."""
            nonlocal state
            dispatches = 0
            while True:
                na = n_arrived()
                while na:
                    req = queue[0]
                    # spec decode needs a gamma-slot margin: the last verify
                    # window writes K/V at [P, P + gamma + 1)
                    if bucketed(req.input_ids.shape[-1]) + req.max_new_tokens + gamma <= S:
                        break
                    # can never fit a slot: reject up front
                    queue.pop(0)
                    na -= 1
                    staged.pop(req.request_id, None)
                    results.append(Result(req.request_id,
                                          np.zeros((Q, 0), np.int64), "capacity"))
                    emit(req.request_id, None, True, "capacity")
                free = [s for s in range(B) if not active[s] and not pf_active[s]]
                if not na or not free:
                    return
                while (na and len(free) == 1 and (active.any() or pf_active.any())
                       and merged_eligible(queue[0])):
                    req = queue.pop(0)
                    na -= 1
                    slot = free.pop(0)
                    d = staged.pop(req.request_id, None) or stage(req)
                    t_br = time.perf_counter()
                    self._install(state, prompts, d, slot)
                    rs["t_install"] += time.perf_counter() - t_br
                    rs["n_install"] += 1
                    Nb = d["ids"].shape[-1]
                    pf_active[slot] = True
                    pf_rem[slot] = Nb // C
                    pf_off[slot] = 0
                    pf_len[slot] = Nb
                    pf_budget[slot] = req.max_new_tokens
                    active[slot] = False
                    budget[slot] = 0
                    slot_req[slot] = req
                    slot_toks[slot] = []
                    slot_ttft[slot] = None
                    self.stats["merged_installs"] += 1
                if not na or not free:
                    return
                if limit is not None and dispatches >= limit:
                    return
                head = queue[0]
                Nb = bucketed(head.input_ids.shape[-1])
                has_px = head.pixels is not None
                group = [head]
                for r in queue[1:na]:
                    if (len(group) >= len(free)
                            or bucketed(r.input_ids.shape[-1]) != Nb
                            or (r.pixels is not None) != has_px
                            # mixed image resolutions must not share a pass
                            or (has_px and r.pixels.shape != head.pixels.shape)
                            or Nb + r.max_new_tokens + gamma > S):
                        break
                    group.append(r)
                k = max(g for g in self._group_sizes if g <= len(group))
                group, slots = group[:k], free[:k]
                del queue[:k]
                reqs = [staged.pop(r.request_id, None) or stage(r) for r in group]
                t_br = time.perf_counter()
                state = self._prefill(Nb, has_px, k, state, reqs,
                                      self._to_device(np.asarray(slots)))
                rs["t_prefill"] += time.perf_counter() - t_br
                rs["n_prefill"] += 1
                rs["group_sizes"].append(k)
                for i, slot in enumerate(slots):
                    active[slot] = True
                    budget[slot] = group[i].max_new_tokens
                    slot_req[slot] = group[i]
                    slot_toks[slot] = []
                    slot_ttft[slot] = None
                dispatches += 1
                self.stats["dedicated_prefills"] += 1

        def finish(slot, reason):
            req = slot_req[slot]
            toks = (np.stack(slot_toks[slot], axis=-1)
                    if slot_toks[slot] else np.zeros((Q, 0), np.int64))
            results.append(Result(req.request_id, toks, reason,
                                  ttft_s=slot_ttft[slot]))
            active[slot] = False
            budget[slot] = 0
            slot_req[slot] = None

        def emit(rid, tok, done, reason):
            if on_token is not None:
                on_token(rid, tok, reason if done else None)

        def emit_token(slot, tok_q):
            """Append one token to `slot`'s request; finish it on EOS or at
            its budget."""
            req = slot_req[slot]
            slot_toks[slot].append(tok_q)
            rs["tokens"] += 1
            budget[slot] -= 1
            if (tok_q == gen.eos_token_id).any():
                finish(slot, "eos")
                emit(req.request_id, tok_q, True, "eos")
            elif budget[slot] <= 0:
                finish(slot, "length")
                emit(req.request_id, tok_q, True, "length")
            else:
                emit(req.request_id, tok_q, False, None)

        def readback(out, t_br, kind):
            """The chunk's one host read: its tokens (K, Q, B) and active
            flags (K, B); the branch's wall time and counts."""
            out = out.cpu().numpy()
            t_now = time.perf_counter()
            rs["t_" + kind] += t_now - t_br
            rs["n_" + kind] += 1
            rs["iters"] += out.shape[0]
            rs["active_iters"] += int(out[:, Q].sum())
            return out[:, :Q], out[:, Q].astype(bool), t_now

        prestage()
        try_fill()
        while active.any() or pf_active.any() or queue:
            if not active.any() and not pf_active.any():
                # pool idle, work still queued: the head either has not
                # arrived yet (sleep until it does) or just became visible
                wait = t0 + (queue[0].arrival_s or 0.0) - time.perf_counter()
                if wait > 0:
                    rs["t_sleep"] += wait
                    time.sleep(wait)
                prestage()
                try_fill()
                continue
            if pf_active.any():
                t_br = time.perf_counter()
                flags = self._to_device(np.stack(
                    [active, budget, pf_active, pf_off, pf_len, pf_budget]).astype(np.int64))
                out, state = self._merged(state, prompts, flags, generator)
                self.stats["merged_chunks"] += 1
                prestage()
                toks_np, acts_np, t_now = readback(out, t_br, "merged")
                # replay the device's transitions: exactly one prefilling
                # slot advances an iteration (the first by slot index); the
                # others emit what their active flags say
                for k in range(acts_np.shape[0]):
                    pf_idx = np.nonzero(pf_active)[0]
                    first_pf = int(pf_idx[0]) if len(pf_idx) else -1
                    for slot in range(B):
                        if slot == first_pf:
                            pf_rem[slot] -= 1
                            pf_off[slot] += C
                            if pf_rem[slot] <= 0:
                                pf_active[slot] = False
                                active[slot] = True
                                budget[slot] = pf_budget[slot]
                            continue
                        if pf_active[slot] or not acts_np[k, slot] or not active[slot]:
                            continue      # a queued install waits its turn
                        if slot_ttft[slot] is None:
                            slot_ttft[slot] = (t_now - t0
                                               - (slot_req[slot].arrival_s or 0.0))
                        emit_token(slot, toks_np[k, :, slot])
                try_fill(limit=1 if (active.any() or pf_active.any()) else None)
                continue
            if gamma:
                t_br = time.perf_counter()
                flags = self._to_device(np.stack([active, budget]).astype(np.int64))
                out, state = self._spec_decode(state, flags)
                prestage()
                out = out.cpu().numpy()       # (K, B, gamma + 2): the one read
                t_now = time.perf_counter()
                toks_np, cnts_np = out[..., :gamma + 1], out[..., gamma + 1]
                rs["t_spec"] += t_now - t_br
                rs["n_spec"] += 1
                rs["iters"] += cnts_np.shape[0]
                rs["active_iters"] += int((cnts_np > 0).sum())
                for slot in range(B):
                    for k in range(cnts_np.shape[0]):
                        for j in range(int(cnts_np[k, slot]) if active[slot] else 0):
                            if slot_ttft[slot] is None:
                                slot_ttft[slot] = (t_now - t0
                                                   - (slot_req[slot].arrival_s or 0.0))
                            # text tokens are the same on every codebook
                            emit_token(slot, np.full((Q,), toks_np[k, slot, j], np.int64))
                            if not active[slot]:
                                break
                try_fill(limit=1 if active.any() else None)
                continue
            t_br = time.perf_counter()
            flags = self._to_device(np.stack([active, budget]).astype(np.int64))
            out, state = self._decode(state, flags, lang_only, generator)
            # stage upcoming requests while the chunk runs: their copies
            # queue behind it
            prestage()
            toks_np, acts_np, t_now = readback(out, t_br, "decode")
            for slot in range(B):
                if not active[slot]:
                    continue
                req = slot_req[slot]
                for k in range(acts_np.shape[0]):
                    if not acts_np[k, slot]:
                        break
                    if slot_ttft[slot] is None:
                        slot_ttft[slot] = t_now - t0 - (req.arrival_s or 0.0)
                    emit_token(slot, toks_np[k, :, slot])
                    if not active[slot]:
                        break
            # interleave at most ONE prefill while slots are decoding, so a
            # prompt burst cannot stall the pool; drain freely when idle
            try_fill(limit=1 if active.any() else None)

        return sorted(results, key=lambda r: r.request_id)
