"""High-level inference pipeline: single-image VQA and captioning, and
text-to-image.

    pipe = LibraPipeline.from_pretrained("/path/to/libra-11b-chat",
                                         quantize="int8")
    answers = pipe.chat(["What is in this image?"], images=[image])
    pixels = pipe.generate_image("a watercolor fox")   # (336, 336, 3)

Covers v1 conversation prompt assembly with the 578-token image
placeholder block and left-padded batched generation with the KV cache,
text-to-image (``generate_image``: a prompt ending in BOI, a dual-path
decode of one image block, the VQGAN decoder on its codes),
and incremental multi-turn chat (``start_chat``: a ChatThread over a
chat.ChatSession, whose later turns prefill only their own tokens), and
loading a checkpoint in the reference layout (``from_pretrained``:
checkpoint.py's converters, the checkpoint's fast tokenizer).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.data import conversation as conv_lib
from libra_tpu_torch.generation import GenerationConfig, Generator
from libra_tpu_torch.tokenization import IMG_GEN, IMG_PH, LibraTokenizer


def process_prompt(question: str, num_img_tokens: int = 578,
                   template: str = "v1", with_image: bool = True,
                   history: Optional[List[Dict[str, str]]] = None) -> str:
    """A chat prompt with the image block prepended to the first user turn."""
    conv = conv_lib.conv_templates[template].copy()
    first_user = question
    if with_image:
        first_user = ((" " + IMG_PH) * num_img_tokens).strip() + "\n" + question
    conv.append_message(conv.roles[0], first_user)
    for turn in history or []:
        conv.append_message(conv.roles[0] if turn.get("role") == "user"
                            else conv.roles[1], turn["content"])
    conv.append_message(conv.roles[1], None)   # generation cue "ASSISTANT:"
    return conv.get_prompt()


def t2i_prompt(caption: str) -> str:
    """A text-to-image prompt: the caption, then <img_gen> (tokenized as
    BOI at vision index 0)."""
    return caption.strip() + "\n " + IMG_GEN


@dataclass
class LibraPipeline:
    """image_processor maps one image to a CLIP-normalized (S, S, 3)
    array or tensor: ``data.processors.LibraEvalImageProcessor`` for PIL
    images, or ``training.fused.maybe_normalize_pixels`` (bound to the
    VQGAN config) for uint8 pixels already at the CLIP size."""
    cfg: LibraConfig
    params: Any
    tokenizer: LibraTokenizer
    image_processor: Callable[[Any], Any]
    generator: Generator = field(init=False)

    def __post_init__(self):
        self.generator = Generator(self.params, self.cfg)

    @classmethod
    def from_pretrained(cls, path: str, mesh=None, quantize=False,
                        device="cuda") -> "LibraPipeline":
        """Load a checkpoint dir in the reference layout onto `device`.
        quantize: True or "int8" = weight-only int8 (quantization.
        quantize_params); "int4" = group-int4 projections with embeddings
        and heads int8. Needs `transformers` (the fast tokenizer) and PIL
        (the default image processor, LibraEvalImageProcessor on the
        loaded CLIP config)."""
        if mesh is not None:
            raise NotImplementedError(
                "LibraPipeline.from_pretrained(mesh=...): tensor-parallel "
                "serving is ROADMAP A13; the port loads onto one device")
        from libra_tpu_torch.data.processors import LibraEvalImageProcessor
        cfg, params, tokenizer = _load_pretrained(path, quantize=quantize,
                                                  device=device)
        return cls(cfg, params, tokenizer, LibraEvalImageProcessor(
            tokenizer.image_tokenizer.cfg.clip))

    def _tokenize(self, prompts: Sequence[str], images) -> Dict[str, Any]:
        text_tok = self.tokenizer.text_tokenizer
        old_side = text_tok.padding_side
        text_tok.padding_side = "left"  # batched generation
        try:
            sample: Dict[str, Any] = {"language": list(prompts)}
            if images:
                sample["vision"] = [self.image_processor(im) for im in images]
            return self.tokenizer([sample])
        finally:
            text_tok.padding_side = old_side

    def chat(self, questions, images=None, max_new_tokens: int = 512,
             temperature: float = 0.0, template: str = "v1",
             generator: Optional[torch.Generator] = None) -> List[str]:
        """Batched single-image VQA or captioning; greedy when
        temperature == 0. generator: the torch.Generator to sample from."""
        if isinstance(questions, str):
            questions = [questions]
        prompts = [process_prompt(q, self.cfg.max_vision_token_length,
                                  template, with_image=images is not None)
                   for q in questions]
        with torch.inference_mode():
            inputs = self._tokenize(prompts, images)
        text_tok = self.tokenizer.text_tokenizer
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens,
            do_sample=temperature > 0, temperature=max(temperature, 1e-5),
            eos_token_id=text_tok.eos_token_id,
            pad_token_id=text_tok.pad_token_id)
        res = self.generator(inputs, gen, generator=generator)
        N = inputs["input_ids"].shape[-1]
        return self._answers(res.sequences[:, :, N:], res.num_generated,
                             gen.pad_token_id)

    def _answers(self, tokens, num_generated, pad_token_id: int) -> List[str]:
        """Decode each row's generated codebook-0 ids (tokens (Q, B, T)),
        the first num_generated[b] of them less pads, skipping specials."""
        tokens, num_generated = tokens.cpu(), num_generated.cpu()
        outs = []
        for b in range(tokens.shape[1]):
            ids = tokens[0, b, :int(num_generated[b])]
            ids = ids[ids != pad_token_id]
            outs.append(self.tokenizer.text_tokenizer.decode(
                ids.tolist(), skip_special_tokens=True))
        return outs

    def generate_image(self, caption: str, temperature: float = 1.0,
                       top_k: int = 100,
                       generator: Optional[torch.Generator] = None
                       ) -> Optional[np.ndarray]:
        """Text-to-image: one image block (BOI + max_vision_token_length - 1
        tokens) decoded through both paths every step, then the VQGAN
        decoder; returns the pixels (S, S, 3) as host fp32 numpy, or None.
        Greedy when temperature == 0, else top-k sampling from
        `generator` (a seed-0 one on the pipeline's device when None)."""
        with torch.inference_mode():
            inputs = self._tokenize([t2i_prompt(caption)], images=None)
        Mv = self.cfg.max_vision_token_length
        text_tok = self.tokenizer.text_tokenizer
        gen = GenerationConfig(
            max_new_tokens=Mv, do_sample=temperature > 0,
            temperature=max(temperature, 1e-5), top_k=top_k,
            eos_token_id=text_tok.eos_token_id,
            pad_token_id=text_tok.pad_token_id)
        res = self.generator(inputs, gen, generator=generator)
        N = inputs["input_ids"].shape[-1]
        seq = res.sequences[:, 0]
        # the prompt ends at BOI; the generated vision indices 1..Mv-1
        # complete the block
        block = torch.cat([seq[:, N - 1:N], seq[:, N:N + Mv - 1]], dim=-1)   # (Q, Mv)
        decoded = self.tokenizer.image_tokenizer.decode(block[None])
        return None if decoded is None else decoded[0].cpu().numpy()

    def start_chat(self, n_parallel: int = 1, max_len: int = 2048,
                   template: str = "v1", max_new_tokens: int = 512,
                   temperature: float = 0.0, delta_bucket: int = 64) -> "ChatThread":
        """Open an incremental multi-turn conversation (n_parallel
        independent conversations advance in lockstep). Unlike chat(),
        which re-prefills the whole history every turn, each
        ChatThread.ask() prefills only the new turn's tokens against the
        resident KV cache."""
        from libra_tpu_torch.chat import ChatSession
        text_tok = self.tokenizer.text_tokenizer
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=temperature > 0,
            temperature=max(temperature, 1e-5),
            eos_token_id=text_tok.eos_token_id,
            pad_token_id=text_tok.pad_token_id)
        session = ChatSession(self.params, self.cfg, batch=n_parallel,
                              max_len=max_len, gen=gen, delta_bucket=delta_bucket)
        return ChatThread(self, session, template)


def _load_pretrained(path: str, text_tokenizer=None, quantize=False,
                     device="cuda"):
    """The trees and tokenizers of a checkpoint dir, as from_pretrained
    loads them: (cfg, params, LibraTokenizer). text_tokenizer: None builds
    the dir's HFTextTokenizer."""
    from libra_tpu_torch import checkpoint as ckpt
    from libra_tpu_torch.config import load_vision_tokenizer_config
    from libra_tpu_torch.tokenization import HFTextTokenizer, ImageTokenizer

    cfg = LibraConfig.from_pretrained(path)
    params = ckpt.convert_libra_state_dict(ckpt.load_torch_state_dict(path), cfg,
                                           device)
    if text_tokenizer is None:
        text_tokenizer = HFTextTokenizer(path)
    vq_cfg, vq_ckpt, max_vt, clip_dir = load_vision_tokenizer_config(path)
    clip_params = None
    if vq_cfg.encoder_name == "clip" and clip_dir is not None:
        # the CLIP tower lives in a nested dir of the checkpoint, named by
        # ddconfig.encoder_name, not inside vqgan.ckpt
        vq_cfg, clip_params = ckpt.load_nested_clip(clip_dir, vq_cfg, device)
    vq_params = ckpt.convert_vqgan_state_dict(ckpt.load_torch_state_dict(vq_ckpt),
                                              vq_cfg, clip_params, device)
    img_tok = ImageTokenizer(
        vq_cfg, vq_params, token_offset=cfg.vocab_size,
        max_vision_token_length=max_vt or cfg.max_vision_token_length,
        downsample_ratio=ImageTokenizer.infer_downsample_ratio(vq_ckpt))
    if quantize:
        from libra_tpu_torch.quantization import quantize_params
        params = quantize_params(params, bits=4 if quantize == "int4" else 8)
    return cfg, params, LibraTokenizer(text_tokenizer, img_tok)


class ChatThread:
    """Template and tokenizer front end over an incremental ChatSession.

    Turn 1 renders the full v1 prompt (system + "USER: <image block> q
    ASSISTANT:") with BOS; later turns tokenize only "USER: q ASSISTANT:"
    without BOS: the generated EOS already sits in the cache as the
    template's </s> separator. This continues at the token level, where a
    rebuilt history string could tokenize an answer's boundary
    differently."""

    def __init__(self, pipe: LibraPipeline, session, template: str):
        self.pipe = pipe
        self.session = session
        self.template = template
        self.turn = 0

    def ask(self, questions, images=None,
            max_new_tokens: Optional[int] = None) -> List[str]:
        pipe = self.pipe
        if isinstance(questions, str):
            questions = [questions]
        if len(questions) != self.session.B:
            raise ValueError(f"thread runs {self.session.B} conversations, "
                             f"got {len(questions)} questions")
        Mv = pipe.cfg.max_vision_token_length
        if self.turn == 0:
            prompts = [process_prompt(q, Mv, self.template,
                                      with_image=images is not None)
                       for q in questions]
        else:
            conv = conv_lib.conv_templates[self.template]
            ph = ((" " + IMG_PH) * Mv).strip() + "\n" if images else ""
            prompts = [f"{conv.roles[0]}: {ph}{q}{conv.sep}{conv.roles[1]}:"
                       for q in questions]
        tok = pipe.tokenizer.text_tokenizer
        old_bos = getattr(tok, "add_bos_token", True)
        try:
            tok.add_bos_token = self.turn == 0
            with torch.inference_mode():
                inputs = pipe._tokenize(prompts, images)
        finally:
            tok.add_bos_token = old_bos
        res = self.session.ask(inputs, max_new_tokens=max_new_tokens)
        self.turn += 1
        return pipe._answers(res.tokens, res.num_generated,
                             self.session.gen.pad_token_id)
