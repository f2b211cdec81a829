"""Continuous-batching serving engine over a recycling slot pool.

The PyTorch counterpart of ``libra_tpu/serving.py``'s ``ServingEngine``
with dedicated prefill (merged chunked prefill and speculative decode are
later slices; the tensor-parallel mesh and the 2D modes too). A fixed pool
of ``max_batch`` slots, each owning an INDEPENDENT timeline of the pooled
KV cache: the cache's index is a (B,) tensor of per-slot write offsets on
the device (``models/libra.KVCache``'s per-row mode). A finished slot is
refilled by prefilling the next queued request at position 0 of the SAME
row: stale K/V of the previous occupant is never attended, because every
position is written before a query reaches it. Slots therefore recycle
without end; the only capacity rule is per request: bucketed prompt +
max_new_tokens <= max_len.

Two device phases, driven by a host scheduler:
  * ``_prefill``: a GROUP of k same-bucket requests (k a power of two, up
    to the free slots) runs ONE B = k prompt pass, the Generator's, into a
    fresh cache piece of N slots, then the piece is copied into the k pool
    rows at [0, N)
    and the slots' state rows (mask, logits, vision index, position) are
    updated on the device. Requests may carry raw ``pixels`` + ``img_start``:
    CLIP + LFQ then run inside the prompt pass and the language projections
    run on the text rows only (``split_prefill``), as in the Generator.
  * ``_decode``: ``decode_chunk`` lockstep one-token steps with every
    carried tensor on the device (inactive slots masked, per-slot budgets
    decremented there), and ONE host readback of the chunk's tokens and
    active flags at its end: nothing inside the chunk syncs.

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
from libra_tpu_torch.generation import decode_micro_step, sample_tokens
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.quantization import QuantizedArray


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
        merged_prefill: None resolves to off, False is off; True, or a
        merged_chunk other than its default, raises (merged chunked
        prefill is ROADMAP A8c2). max_prefill_group caps the grouped
        refill's k."""
        if mesh is not None:
            raise NotImplementedError(
                "ServingEngine(mesh=...): tensor-parallel serving is ROADMAP "
                "A13; the port serves on one device")
        if merged_prefill or merged_chunk != 64:
            raise NotImplementedError(
                "merged_prefill=True / merged_chunk: merged chunked prefill is "
                "ROADMAP A8c's second half (A8c2); this engine prefills each "
                "group in a dedicated prompt pass")
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
            pos_last=torch.zeros((B,), dtype=torch.int64, device=dev))

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
        cache, mask, logits, vi_last, pos_last = state
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
                active=active, lang_only=lang_only)
            toks.append(tok)
            acts.append(active)
            active = active_next
        out = torch.cat([torch.stack(toks), torch.stack(acts)[:, None].long()], 1)
        return out, SlotState(cache, mask, logits, vi_last, pos_last)

    def warmup(self, example: Request, max_new: Optional[int] = None):
        """Run `example`-shaped synthetic requests through run() in the
        patterns the scheduler dispatches, so that first-call costs (kernel
        builds, allocator growth) land here and not on a served request:

          * a 2B-1 staggered burst: the k = B grouped prefill, k = 1
            refills while other slots decode, and the decode chunk;
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

        last_run_stats: host wall time per branch (t_decode, t_prefill,
        t_sleep; the device time of a prefill lands on the next readback),
        counts (n_decode chunks, n_prefill passes, iters = decode steps,
        active_iters = active slot-steps, tokens = tokens emitted), the
        group size of each prefill (group_sizes), and libra_tpu's merged
        and spec keys, which stay 0 here."""
        cfg, gen, B, S = self.cfg, self.gen, self.B, self.S
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

        def bucketed(n):
            b = self.prompt_bucket
            return n if b <= 1 else -(-n // b) * b

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
            return {key: self._to_device(a) for key, a in d.items()}

        def prestage():
            """Stage up to 2B arrived requests ahead of need."""
            n = 0
            for r in queue[:n_arrived()]:
                if n >= 2 * B:
                    break
                if bucketed(r.input_ids.shape[-1]) + r.max_new_tokens > S:
                    continue    # try_fill rejects it; copy nothing
                if r.request_id not in staged:
                    staged[r.request_id] = stage(r)
                n += 1

        def try_fill(limit: Optional[int] = None):
            """Fill free slots from the queue: each prefill takes a GROUP of
            up-to-len(free) head-of-queue requests sharing a (prompt bucket,
            pixels?, pixel shape) and runs it as one B = k pass (k the
            largest allowed group size). `limit` bounds the prefills (1
            while slots are decoding)."""
            nonlocal state
            dispatches = 0
            while True:
                na = n_arrived()
                while na:
                    req = queue[0]
                    if bucketed(req.input_ids.shape[-1]) + req.max_new_tokens <= S:
                        break
                    # can never fit a slot: reject up front
                    queue.pop(0)
                    na -= 1
                    staged.pop(req.request_id, None)
                    results.append(Result(req.request_id,
                                          np.zeros((Q, 0), np.int64), "capacity"))
                    emit(req.request_id, None, True, "capacity")
                free = [s for s in range(B) if not active[s]]
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
                            or Nb + r.max_new_tokens > S):
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

        prestage()
        try_fill()
        while active.any() or queue:
            if not active.any():
                # pool idle, work still queued: the head either has not
                # arrived yet (sleep until it does) or just became visible
                wait = t0 + (queue[0].arrival_s or 0.0) - time.perf_counter()
                if wait > 0:
                    rs["t_sleep"] += wait
                    time.sleep(wait)
                prestage()
                try_fill()
                continue
            t_br = time.perf_counter()
            flags = self._to_device(np.stack([active, budget]).astype(np.int64))
            out, state = self._decode(state, flags, lang_only, generator)
            # stage upcoming requests while the chunk runs: their copies
            # queue behind it
            prestage()
            out = out.cpu().numpy()                     # the chunk's readback
            toks_np, acts_np = out[:, :Q], out[:, Q].astype(bool)
            t_now = time.perf_counter()
            rs["t_decode"] += t_now - t_br
            rs["n_decode"] += 1
            rs["iters"] += acts_np.shape[0]
            rs["active_iters"] += int(acts_np.sum())
            for slot in range(B):
                if not active[slot]:
                    continue
                req = slot_req[slot]
                for k in range(acts_np.shape[0]):
                    if not acts_np[k, slot]:
                        break
                    if slot_ttft[slot] is None:
                        slot_ttft[slot] = t_now - t0 - (req.arrival_s or 0.0)
                    tok_q = toks_np[k, :, slot]
                    slot_toks[slot].append(tok_q)
                    rs["tokens"] += 1
                    budget[slot] -= 1
                    if (tok_q == gen.eos_token_id).any():
                        finish(slot, "eos")
                        emit(req.request_id, tok_q, True, "eos")
                        break
                    if budget[slot] <= 0:
                        finish(slot, "length")
                        emit(req.request_id, tok_q, True, "length")
                        break
                    emit(req.request_id, tok_q, False, None)
            # interleave at most ONE prefill while slots are decoding, so a
            # prompt burst cannot stall the pool; drain freely when idle
            try_fill(limit=1 if active.any() else None)

        return sorted(results, key=lambda r: r.request_id)
