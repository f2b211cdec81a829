"""Autoregressive generation: one prefill over the left-padded prompt, then
a cached decode loop.

The PyTorch counterpart of ``libra_tpu/generation.py``'s serving path: the
same multi-codebook argmax or sampling, EOS on any codebook, EOI->newline
forcing and vision-index auto-increment, the int8 KV cache (``kv_quant``)
and the w8a8 prompt pass (``a8_prefill``), with a Python loop in place of
``lax.while_loop``. The loop stops once every row has finished and skips
the forward after the last token it needs. Prompts must be LEFT-padded.
With ``spec_decode`` = gamma > 0 (greedy text decode only) the loop is
``spec_decode.py``'s: bigram drafts verified gamma + 1 tokens a forward.

Given raw ``pixels`` and ``img_start`` (a Generator built with the
tokenizer's ``vq_params``), the prompt pass runs CLIP + LFQ on the device,
writes the image ids and signal rows into the prompt there, and runs the
language projections on the text rows only (``split_prefill``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.models import libra as M
from libra_tpu_torch.ops.flash_bridge import resolve_attn_impl
from libra_tpu_torch.ops.qlinear import a8_enabled
from libra_tpu_torch.training.fused import _scatter_block, encode_images_to_tokens


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0           # 0 = disabled
    top_p: float = 1.0       # 1.0 = disabled
    eos_token_id: int = 2
    pad_token_id: int = 0
    prompt_bucket: int = 0   # 0 = no padding to a bucket boundary
    attn_impl: str = "auto"  # "auto" | "plain" | "flash" (prompt-pass
    #   attention): "auto" takes the flash kernel on the card, the plain
    #   attention on the CPU
    kv_quant: bool = False   # int8 K/V cache (per-token/head scales)
    a8_prefill: bool = False  # w8a8 prompt pass: int8-weight matmuls that
    #   no kernel takes quantize their activations per row and run an
    #   integer matmul; decode stays weight-only. No-op on a plain tree.
    split_prefill: bool = True  # modality-split prompt pass (raw-pixels
    #   path only): the full-rank language projections run on the text
    #   rows, whose count N - 578 is the same in every row, instead of all
    #   N positions. Exact: the routing merge discards the language
    #   outputs at vision positions. Off in addition_mode (the language
    #   path is needed everywhere).
    spec_decode: int = 0  # gamma > 0 enables n-gram (prompt-lookup)
    #   speculative decoding: each decode iteration drafts `gamma` tokens
    #   by bigram lookup over the already-generated history (on the
    #   device), verifies them in ONE (gamma+1)-token cached forward, and
    #   emits the accepted prefix + the model's own next token: >= 1 token
    #   an iteration for about one step's weight traffic. EXACT: every
    #   emitted token is the model's greedy argmax. Requires greedy
    #   (do_sample=False) and a text-mode decode (resolved
    #   decode_modality == "text"); see libra_tpu_torch/spec_decode.py.
    decode_modality: str = "auto"  # "auto" | "text" | "dual": "text"
    #   decodes through the language path only (exact for prompts that end
    #   in text); "auto" resolves per call from the prompts' last tokens


def _filter_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[..., -k][..., None]
    return torch.where(logits < kth, float("-inf"), logits)


def _filter_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Keep the smallest set with cumulative probability > p (always the
    top-1): token i goes iff the cumulative probability before it already
    exceeds p; anything strictly below the least kept logit goes."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    removed = torch.cumsum(probs, dim=-1) - probs > p
    kept = torch.where(removed, float("inf"), sorted_logits)
    threshold = kept.amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, float("-inf"), logits)


def sample_tokens(logits: torch.Tensor, gen: GenerationConfig,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (Q, B, Vc) -> tokens (Q, B): per-codebook argmax, or
    independent multinomial draws from `generator` when sampling."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    x = logits / max(gen.temperature, 1e-6)
    if gen.top_k > 0:
        x = _filter_top_k(x, gen.top_k)
    if gen.top_p < 1.0:
        x = _filter_top_p(x, gen.top_p)
    Q, B, Vc = x.shape
    probs = torch.softmax(x.float().reshape(Q * B, Vc), dim=-1)
    return torch.multinomial(probs, 1, generator=generator).reshape(Q, B)


class GenerateResult(NamedTuple):
    sequences: torch.Tensor      # (Q, B, prompt_len + max_new_tokens)
    num_generated: torch.Tensor  # (B,) tokens generated incl. EOS
    iterations: Optional[torch.Tensor] = None  # decode-loop iterations
    #   (spec decode only: tokens / iteration - 1 is the acceptance rate)


def _last_position_logits(params, cfg: LibraConfig, hidden: torch.Tensor,
                          flag_last: torch.Tensor, vi_last: torch.Tensor,
                          h_up: Optional[torch.Tensor] = None,
                          lang_only: bool = False) -> torch.Tensor:
    """Combined-vocab logits (Q, B, Vc) for the last position of `hidden`
    (B, N, D). h_up: (B, D) the hidden R - 1 steps back (2D prediction
    mode only). lang_only skips the vision heads: the vision slice is -inf
    at text positions whatever its value, so zeros are exact there."""
    h = hidden[:, -1:]
    tl = M.compute_text_logits(params, h)
    if lang_only:
        vl = tl.new_zeros((cfg.vision_codebook_num,) + h.shape[:2]
                          + (cfg.vision_vocab_size,))
    elif cfg.vision_prediction_mode == "2d":
        vl = M.compute_vision_logits_2d(params, cfg, h, vi_last[:, None],
                                        h_up=h_up[:, None])
    else:
        vl = M.compute_vision_logits(params, h)
    logits = M.assemble_logits(cfg, tl, vl, flag_last[:, None])[:, :, 0]
    return M.force_eoi_newline(cfg, logits, vi_last)


def decode_micro_step(params, cfg: LibraConfig, tok: torch.Tensor,
                      mask_buf: torch.Tensor, cache: M.KVCache,
                      vi_last: torch.Tensor, pos_last: torch.Tensor,
                      active: Optional[torch.Tensor] = None,
                      lang_only: bool = False,
                      ring: Optional[torch.Tensor] = None):
    """One decode step, shared by the Generator's loop, the chat turn and
    the serving engine's decode chunk: advance vision_indices
    (auto-increment, clamped at text) and positions, run the cached
    one-token forward, assemble the logits. Positions: +1 a step; with 2D
    RoPE pos is the base counter, advanced by models/libra.rope_inc (+1 on
    text and BOI, R + 1 on EOI, 0 inside an image), the token's (row, col)
    offset added. tok (Q, B) is the step's input token, already masked by
    the caller, and mask_buf already holds the caller's write for its slot.
    active=None: lockstep advance (the Generator: finished rows emit pads
    but vi/pos keep advancing); active (B,) bool: rows with active False
    keep their vi and pos (idle serving slots, finished chat rows).
    ring: 2D prediction's (B, R - 1, D) ring of the last hiddens, oldest
    first: its oldest row is the step's up-neighbour, and the step's
    hidden is pushed into it IN PLACE (rows with active False keep
    theirs). Returns (logits, cache, vi_new, pos_new)."""
    Mv = cfg.max_vision_token_length

    def adv(new, old):
        return new if active is None else torch.where(active, new, old)

    vi_new = adv(torch.clamp_max(vi_last + 1, Mv), vi_last)
    inc = M.rope_inc(cfg, vi_new) if cfg.use_2d_rope else 1
    pos_new = adv(pos_last + inc, pos_last)
    step = M.forward(params, cfg, tok[:, :, None], mask_buf, vi_new[:, None],
                     None, position_ids=M.rope_positions(cfg, pos_new[:, None],
                                                         vi_new[:, None]),
                     cache=cache, lang_only=lang_only)
    h_up = None if ring is None else ring[:, 0]          # R - 1 steps back
    logits = _last_position_logits(params, cfg, step.hidden_states,
                                   vi_new < Mv, vi_new, h_up=h_up,
                                   lang_only=lang_only)
    if ring is not None:
        pushed = torch.cat([ring[:, 1:], step.hidden_states.to(ring.dtype)], dim=1)
        ring.copy_(pushed if active is None
                   else torch.where(active[:, None, None], pushed, ring))
    return logits, step.cache, vi_new, pos_new


def fuse_pixels(cfg: LibraConfig, gen: GenerationConfig, vq_params, vq_cfg,
                input_ids: torch.Tensor, pixels: torch.Tensor,
                img_start: torch.Tensor):
    """A raw-pixels prompt's device side: CLIP + LFQ on `pixels`, the image
    ids and signal rows written into the prompt at img_start; with
    gen.split_prefill (not in addition_mode) also text_span_maps' row maps.
    Returns (input_ids, contiguous_signal, text_span)."""
    Q, B, N = input_ids.shape
    text_span = None
    if gen.split_prefill and not cfg.addition_mode:
        # every row carries one full image block at img_start, so the text
        # width N - Mv is the same for all: the split is exact
        text_span = M.text_span_maps(cfg, img_start, N)
    img_ids, img_sig = encode_images_to_tokens(vq_params, vq_cfg, cfg, pixels)
    input_ids = _scatter_block(input_ids.permute(1, 2, 0),
                               img_ids.permute(1, 2, 0),
                               img_start).permute(2, 0, 1)
    signal = _scatter_block(img_sig.new_zeros((B, N, img_sig.shape[-1])),
                            img_sig, img_start)
    return input_ids, signal, text_span


class PrefillState(NamedTuple):
    tokens: torch.Tensor     # (Q, B, S) prompt written at [:, :, :N]
    mask_buf: torch.Tensor   # (B, S + extra_cache)
    cache: M.KVCache         # index == N
    logits: torch.Tensor     # (Q, B, Vc) last-prompt-position logits
    vi_last: torch.Tensor    # (B,)
    last_pos: torch.Tensor   # (B,) position counter (2D RoPE: the base)
    ring: Optional[torch.Tensor] = None       # (B, R - 1, D) 2D prediction's
    #   ring of the last hiddens, oldest first (None in 1D mode)
    h_up_last: Optional[torch.Tensor] = None  # (B, D) the last prompt
    #   position's up-neighbour (2D prediction)


def prompt_ring(cfg: LibraConfig, hidden: torch.Tensor):
    """2D prediction's decode carry from the prompt pass's hidden (B, N, D):
    (the ring of its last R - 1 hiddens, the last position's up-neighbour
    h[N - 1 - (R - 1)]). A prompt shorter than R - 1 tokens is left-padded
    with zeros, so that the ring stays exactly R - 1 deep; or (None, None)
    in 1D mode."""
    if cfg.vision_prediction_mode != "2d":
        return None, None
    Rb = max(cfg.image_feature_resolution - 1, 1)
    h = hidden
    if h.shape[1] < Rb:
        h = torch.nn.functional.pad(h, (0, 0, Rb - h.shape[1], 0))
    return h[:, -Rb:].clone(), h[:, max(h.shape[1] - 1 - Rb, 0)]


def _prefill(params, input_ids, attention_mask, vision_indices,
             contiguous_signal, vq_params=None, pixels=None, img_start=None,
             *, cfg: LibraConfig, gen: GenerationConfig,
             vq_cfg=None, extra_cache: int = 0) -> PrefillState:
    """The prompt pass: with pixels, the image encode (CLIP + LFQ) and its
    ids and signal rows written at img_start, all on the device; cache
    init (N + max_new_tokens + extra_cache slots, int8 with gen.kv_quant:
    spec decode's verify block may probe up to gamma slots past the
    budget, so it asks for gamma + 1 more); the prompt
    forward (attention by gen.attn_impl, w8a8 with gen.a8_prefill, the
    language projections on the text rows with pixels and
    gen.split_prefill); last-position logits (weight-only); 2D RoPE's
    positions (get_2d_position_ids) and base counter, and 2D prediction's
    hidden ring (prompt_ring). JAX rounds an
    int8 cache's length up to 128 for its TPU kernel; the port does not
    need to, and the extra slots are masked there anyway."""
    Q, B, N = input_ids.shape
    S = N + gen.max_new_tokens
    device = input_ids.device
    impl = resolve_attn_impl(gen.attn_impl, device)
    text_span = None
    if pixels is not None:
        input_ids, contiguous_signal, text_span = fuse_pixels(
            cfg, gen, vq_params, vq_cfg, input_ids, pixels, img_start)
    Sc = S + extra_cache
    cache = M.init_cache(cfg, B, Sc, device=device, quantized=gen.kv_quant)
    mask_buf = torch.zeros((B, Sc), dtype=torch.int64, device=device)
    mask_buf[:, :N] = attention_mask
    vi_last = vision_indices[:, -1]
    if cfg.use_2d_rope:
        pos = M.get_2d_position_ids(cfg, vision_indices, attention_mask)
        Mv = cfg.max_vision_token_length
        last_pos = pos[:, 0, -1] - M.make_2d_pos_offset(cfg, device)[
            vi_last.clamp(0, Mv)][:, 0]
    else:
        pos = M.position_ids_from_mask(attention_mask)
        last_pos = pos[:, -1]
    with a8_enabled(gen.a8_prefill):
        out = M.forward(params, cfg, input_ids, mask_buf, vision_indices,
                        contiguous_signal, position_ids=pos, cache=cache,
                        attn_impl=impl, text_span=text_span)
    ring, h_up_last = prompt_ring(cfg, out.hidden_states)
    logits = _last_position_logits(params, cfg, out.hidden_states,
                                   vi_last < cfg.max_vision_token_length,
                                   vi_last, h_up=h_up_last)
    tokens = torch.zeros((Q, B, S), dtype=input_ids.dtype, device=device)
    tokens[:, :, :N] = input_ids
    return PrefillState(tokens=tokens, mask_buf=mask_buf, cache=out.cache,
                        logits=logits, vi_last=vi_last, last_pos=last_pos,
                        ring=ring, h_up_last=h_up_last)


def _generate_impl(params, input_ids, attention_mask, vision_indices,
                   contiguous_signal, generator=None, vq_params=None,
                   pixels=None, img_start=None, *, cfg: LibraConfig,
                   gen: GenerationConfig, vq_cfg=None) -> GenerateResult:
    Q, B, N = input_ids.shape
    st = _prefill(params, input_ids, attention_mask, vision_indices,
                  contiguous_signal, vq_params, pixels, img_start, cfg=cfg,
                  gen=gen, vq_cfg=vq_cfg)
    tokens, mask_buf, cache, logits = st.tokens, st.mask_buf, st.cache, st.logits
    vi_last, last_pos = st.vi_last, st.last_pos
    lang_only = gen.decode_modality == "text"
    finished = torch.zeros((B,), dtype=torch.bool, device=tokens.device)
    num_gen = torch.zeros((B,), dtype=torch.int64, device=tokens.device)

    for t in range(gen.max_new_tokens):
        next_tok = sample_tokens(logits, gen, generator)              # (Q, B)
        next_tok = torch.where(finished[None, :], gen.pad_token_id, next_tok)
        # EOS on any codebook finishes the row
        num_gen += (~finished).long()
        finished = finished | (next_tok == gen.eos_token_id).any(dim=0)
        tokens[:, :, N + t] = next_tok
        mask_buf[:, N + t] = 1
        # the forward computes the NEXT token's logits: skip it after the
        # last token needed (one host sync per step to read `finished`)
        if t + 1 == gen.max_new_tokens or bool(finished.all()):
            break
        logits, cache, vi_last, last_pos = decode_micro_step(
            params, cfg, next_tok, mask_buf, cache, vi_last, last_pos,
            lang_only=lang_only, ring=st.ring)
    return GenerateResult(sequences=tokens, num_generated=num_gen)


class Generator:
    """Generation front end over a parameter tree on one device.

    With the image tokenizer's params and config (vq_params, vq_cfg),
    inputs may carry raw "pixels" and "img_start" in place of pre-encoded
    image ids: the encode then runs inside the prompt pass, on the
    device."""

    def __init__(self, params, cfg: LibraConfig, vq_params=None, vq_cfg=None):
        self.params = params
        self.cfg = cfg
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        self.device = params["embed_tokens"].device

    def __call__(self, inputs: Dict[str, Any],
                 gen: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None) -> GenerateResult:
        """inputs: LibraTokenizer's dict (input_ids (Q, B, N) LEFT-padded,
        attention_mask, vision_indices, coninous_signal), as tensors or
        numpy arrays; or, for the fused vision path, pixels (B, S, S, 3)
        (uint8, or CLIP-normalized float) and img_start (B,) in place of
        the signal, each row holding one image block at img_start (its
        ids there are overwritten). generator: the torch.Generator to
        sample from (a seed-0 one on the params' device when sampling
        without one)."""
        gen = gen or GenerationConfig()
        dev = self.device
        ids = torch.as_tensor(inputs["input_ids"], device=dev).long()
        mask = torch.as_tensor(inputs["attention_mask"], device=dev).long()
        vi = torch.as_tensor(inputs["vision_indices"], device=dev).long()
        sig = inputs.get("coninous_signal")
        sig = None if sig is None else torch.as_tensor(sig, device=dev)
        Mv = self.cfg.max_vision_token_length
        ends_in_text = bool((vi[:, -1] >= Mv).all())
        if gen.decode_modality == "auto":
            gen = dataclasses.replace(
                gen, decode_modality="text" if ends_in_text else "dual")
        elif gen.decode_modality == "text" and not ends_in_text:
            raise ValueError("decode_modality='text' needs prompts ending in text")
        pixels, img_start = inputs.get("pixels"), inputs.get("img_start")
        if pixels is not None:
            if self.vq_params is None:
                raise ValueError("Generator needs vq_params/vq_cfg for the "
                                 "fused vision path")
            pixels = torch.as_tensor(pixels, device=dev)
            img_start = torch.as_tensor(img_start, device=dev).long()
            sig = None
        if gen.prompt_bucket > 1:
            pad = (-ids.shape[-1]) % gen.prompt_bucket
            if pad:   # left-pad to the bucket boundary
                Q, B, _ = ids.shape
                ids = torch.cat([ids.new_full((Q, B, pad), gen.pad_token_id), ids], -1)
                mask = torch.cat([mask.new_zeros((B, pad)), mask], -1)
                vi = torch.cat([vi.new_full((B, pad), Mv), vi], -1)
                if sig is not None:
                    sig = torch.cat([sig.new_zeros((B, pad, sig.shape[-1])), sig], 1)
                if img_start is not None:
                    img_start = img_start + pad
        impl = _generate_impl
        if gen.spec_decode > 0:
            if gen.do_sample or gen.decode_modality != "text":
                raise ValueError(
                    "spec_decode requires greedy decoding and a text-mode "
                    "decode (resolved decode_modality == 'text'); got "
                    f"do_sample={gen.do_sample!r}, "
                    f"decode_modality={gen.decode_modality!r}")
            from libra_tpu_torch.spec_decode import _spec_generate_impl
            impl = _spec_generate_impl
        if gen.do_sample and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        with torch.inference_mode():
            return impl(self.params, ids, mask, vi, sig, generator,
                                  self.vq_params, pixels, img_start,
                                  cfg=self.cfg, gen=gen, vq_cfg=self.vq_cfg)
