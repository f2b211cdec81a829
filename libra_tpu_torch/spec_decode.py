"""N-gram (prompt-lookup) speculative decoding.

The PyTorch counterpart of ``libra_tpu/spec_decode.py``. Decode at a
batch of a few rows is bound by the weights' bytes, so a forward over
gamma + 1 tokens costs about what one token's does: if the next gamma
tokens can be GUESSED cheaply and verified in one pass, every accepted
guess is a free token. The drafts come from a bigram lookup over the
row's own history ("prompt lookup", vLLM's ngram speculator): answers copy
from their prompts (VQA answer spans, code, quoted captions), and the
lookup is O(B * S) integer compares on the device, with no draft model
and no host read.

Exactness: every emitted token is the target model's own greedy argmax.
The verify pass computes, at every position of the drafted block, what
the model would produce given the accepted prefix; the first mismatch
ends acceptance and the model's own token there is emitted instead (the
"bonus"), so each iteration emits >= 1 token and the loop ends within
max_new_tokens iterations. Drafts never change what is emitted, only how
many iterations it takes.

Restrictions (Generator.__call__, ChatSession, ServingEngine enforce
them): greedy only, and text-mode decode only (resolved decode_modality
== "text": image blocks are multi-codebook and never copy from history).
The verify pass is a (gamma + 1)-row cached forward: with the int8 cache,
``ops/decode_attention``'s gate sends N = gamma + 1 <= 8 rows to B3's
decode template and N = 16, 24, ... 64 to its wide template (libra_tpu's
gate, ``libra_tpu/ops/pallas/decode_attention.py:280``, sends the same N
to its one kernel, though its spec_decode docstring speaks of a fallback
above 8 rows); any other N reads the dequantized cache in both. Each
route computes one function; the tests hold the port to libra_tpu at
gamma <= 7.

Rows desync (each accepts its own count), which the model supports: the
cache's index is then a (B,) tensor (the serving engine's per-slot
timelines), its writes clamped as XLA clamps them, and the causal mask
is per row. The loop (`spec_decode_loop`) is shared by the Generator's
path here and by ChatSession's spec turns (chat.py), which run it
against a conversation's resident cache at per-row turn offsets; the
serving engine's chunk (serving.py) reuses the drafter and the window
write. A Python loop replaces ``lax.while_loop``, reading `finished` on
the host once an iteration.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.generation import GenerateResult, GenerationConfig, _prefill
from libra_tpu_torch.models import libra as M


def _update_window(buf: torch.Tensor, seg: torch.Tensor, start: torch.Tensor,
                   write: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per row b, write seg[b, i] (or seg[i]) at buf[b, start_b + i] where
    write[b, i] (everywhere when write is None), keeping the old value
    elsewhere; in place, returns `buf`. Each window's start is clamped to
    [0, S - K] as XLA's dynamic_update_slice clamps it (models/libra.
    row_slots), so a window never runs out of the buffer."""
    K = seg.shape[-1]
    rows, pos = M.row_slots(start, buf.shape[1], K)
    seg = seg.to(buf.dtype)
    if write is not None:
        seg = torch.where(write, seg, buf[rows, pos])
    buf[rows, pos] = seg.expand(rows.shape[0], K)
    return buf


def _bigram_drafts(hist: torch.Tensor, valid: torch.Tensor, P: torch.Tensor,
                   pending: torch.Tensor, gamma: int) -> torch.Tensor:
    """Draft gamma tokens a row by the most recent bigram match.

    hist: (B, St) codebook-0 token history (prompt + generated; position P
    holds `pending`, positions > P are stale). valid: (B, St) bool, the
    positions whose tokens are real. Finds the latest j with (hist[j],
    hist[j+1]) == (hist[P-1], pending) and j + 1 < P, and proposes
    hist[j+2 : j+2+gamma] from the history padded by gamma. No match (or
    a continuation running into unwritten slots) gives junk drafts, which
    the verify pass rejects. All on the device: no host read."""
    B, St = hist.shape
    idx = torch.arange(St - 1, device=hist.device)
    prev = hist.gather(1, (P - 1).clamp_min(0)[:, None])            # (B, 1)
    m = ((hist[:, :-1] == prev) & (hist[:, 1:] == pending[:, None])
         & valid[:, :-1] & valid[:, 1:] & (idx[None] + 1 < P[:, None]))
    j = torch.where(m, idx[None], -1).amax(dim=1)                   # (B,)
    src = (j + 2).clamp(0, St - 1)
    hist_pad = F.pad(hist, (0, gamma))
    return hist_pad.gather(1, src[:, None] + torch.arange(gamma, device=hist.device))


class SpecLoopResult(NamedTuple):
    hist: torch.Tensor        # (B, St) history buffer with emitted tokens
    mask_buf: torch.Tensor    # (B, Sc): 1 exactly on the KV-valid slots
    cache: Any                # per-row index == P (pending's slot, K/V absent)
    last_pos: torch.Tensor    # (B,) position id of slot P - 1
    P: torch.Tensor           # (B,) slot of the final pending token
    finished: torch.Tensor    # (B,)
    num_gen: torch.Tensor     # (B,) emitted tokens INCLUDING the pending one
    iterations: torch.Tensor  # () verify iterations run


def spec_decode_loop(params, hist, mask_buf, cache, pending, last_pos, P, *,
                     cfg: LibraConfig, gen: GenerationConfig,
                     max_new: int) -> SpecLoopResult:
    """The draft/verify loop over PER-ROW cache indices, shared by the
    Generator's spec decode and ChatSession's spec turns.

    Preconditions: hist (B, St) holds the real token history up to and
    including `pending` at slot P (positions > P stale); St >= max(P) +
    max_new + gamma + 1; mask_buf is 1 exactly on the KV-valid slots (slot
    P is not valid yet: pending's K/V lands during its verify pass);
    cache.index is P, a (B,) tensor; last_pos is slot P - 1's position id
    (with 2D RoPE its base counter: text tokens step it by 1).
    num_gen starts at 1 (the pending token is already emitted). hist,
    mask_buf and the cache's buffers are updated in place."""
    assert gen.spec_decode > 0 and not gen.do_sample
    gamma = int(gen.spec_decode)
    K = gamma + 1
    B, St = hist.shape
    Q, Mv = cfg.vision_codebook_num, cfg.max_vision_token_length
    dev = hist.device
    idx = torch.arange(St, device=dev)
    ar = torch.arange(K, device=dev)[None]                          # (1, K)
    ones = torch.ones((K,), dtype=mask_buf.dtype, device=dev)
    vi_blk = torch.full((B, K), Mv, dtype=torch.int64, device=dev)

    finished = pending == gen.eos_token_id
    num_gen = torch.ones((B,), dtype=torch.int64, device=dev)
    it = 0
    # one host read an iteration: whether every row has finished
    while it < max_new and not bool(finished.all()):
        # mask_buf may be longer than the history; validity needs its span
        valid = (mask_buf[:, :St] > 0) | (idx[None] == P[:, None])
        drafts = _bigram_drafts(hist, valid, P, pending, gamma)     # (B, gamma)

        # ---- verify: one (gamma+1)-token cached forward ----
        x = torch.cat([pending[:, None], drafts], dim=1)            # (B, K)
        _update_window(mask_buf, ones, P)
        # text tokens: with 2D RoPE the base counter, offset (0, 0)
        pos_new = M.rope_positions(cfg, last_pos[:, None] + 1 + ar, vi_blk)
        out = M.forward(params, cfg, x[None].expand(Q, B, K), mask_buf, vi_blk,
                        None, position_ids=pos_new, cache=cache, lang_only=True)
        # text-mode argmax over the combined vocab == argmax over the
        # language head alone: assemble_logits -inf's the whole vision
        # slice (after the text slice, so ids coincide), and
        # force_eoi_newline is the identity at vision_index == text
        tl = M.compute_text_logits(params, out.hidden_states)
        c = torch.argmax(tl, dim=-1).to(hist.dtype)                 # (B, K)

        # ---- accept the longest matching draft prefix + the bonus ----
        ok = drafts == c[:, :gamma]                                 # (B, gamma)
        a = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        bonus = c.gather(1, a[:, None])[:, 0]
        dpad = torch.cat([drafts, drafts[:, -1:]], dim=1)
        e = torch.where(ar == a[:, None], bonus[:, None], dpad)     # (B, K)

        # EOS / budget truncation (num_gen already counts the pending token)
        eos_in = (e == gen.eos_token_id) & (ar <= a[:, None])
        any_eos = eos_in.any(dim=1)
        first_eos = eos_in.long().argmax(dim=1)
        cnt = torch.where(any_eos, first_eos + 1, a + 1)
        cnt = torch.minimum(cnt, max_new - num_gen)
        cnt = torch.where(finished, 0, cnt)
        num_gen = num_gen + cnt
        new_finished = finished | (any_eos & (first_eos < cnt)) | (num_gen >= max_new)

        # ---- write back ----
        write = ar < cnt[:, None]                                   # (B, K)
        _update_window(hist, e, P + 1, write)
        # mask 1 only on the cnt kept K/V slots [P, P + cnt); the new
        # pending (bonus) slot P + cnt stays 0 until its verify pass
        _update_window(mask_buf, write.to(mask_buf.dtype), P)
        cache = out.cache._replace(index=P + cnt)
        pending = torch.where(cnt > 0, bonus, pending)
        last_pos = last_pos + cnt
        P = P + cnt
        finished = new_finished
        it += 1
    return SpecLoopResult(hist=hist, mask_buf=mask_buf, cache=cache,
                          last_pos=last_pos, P=P, finished=finished,
                          num_gen=num_gen,
                          iterations=torch.tensor(it, device=dev))


def _spec_generate_impl(params, input_ids, attention_mask, vision_indices,
                        contiguous_signal, generator=None, vq_params=None,
                        pixels=None, img_start=None, *, cfg: LibraConfig,
                        gen: GenerationConfig, vq_cfg=None) -> GenerateResult:
    """generation._generate_impl's stand-in (same signature, same
    GenerateResult, with `iterations`) when gen.spec_decode = gamma > 0."""
    assert gen.spec_decode > 0 and not gen.do_sample and gen.decode_modality == "text"
    K = int(gen.spec_decode) + 1
    Q, B, N = input_ids.shape
    S = N + gen.max_new_tokens
    dev = input_ids.device
    st = _prefill(params, input_ids, attention_mask, vision_indices,
                  contiguous_signal, vq_params, pixels, img_start, cfg=cfg,
                  gen=gen, vq_cfg=vq_cfg, extra_cache=K)
    if gen.max_new_tokens == 0:
        return GenerateResult(sequences=st.tokens,
                              num_generated=torch.zeros((B,), dtype=torch.int64,
                                                        device=dev))
    # verify blocks probe up to K - 1 slots past a row's budget end: the
    # history buffer is padded so that the window writes stay in bounds
    hist = F.pad(st.tokens[0], (0, K))
    # rows accept different counts an iteration: the cache switches to
    # per-row (B,) write indices (the serving engine's per-slot mode)
    P = torch.full((B,), N, dtype=torch.int64, device=dev)
    cache = st.cache._replace(index=P)
    # the pending token: already emitted (written and counted), its K/V
    # not in the cache yet; it is the verify block's first input
    pending = torch.argmax(st.logits[0], dim=-1).to(hist.dtype)     # (B,)
    hist[:, N] = pending
    res = spec_decode_loop(params, hist, st.mask_buf, cache, pending,
                           st.last_pos, P, cfg=cfg, gen=gen,
                           max_new=gen.max_new_tokens)
    # the generated region is the same on every codebook (text decode);
    # the prompt region keeps each codebook's own ids
    sequences = st.tokens
    sequences[:, :, N:] = res.hist[None, :, N:S]
    return GenerateResult(sequences=sequences, num_generated=res.num_gen,
                          iterations=res.iterations)
