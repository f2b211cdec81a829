"""High-level inference pipeline: single-image VQA and captioning.

    pipe = LibraPipeline(cfg, params, tokenizer, image_processor)
    answers = pipe.chat(["What is in this image?"], images=[image])

Covers v1 conversation prompt assembly with the 578-token image
placeholder block and left-padded batched generation with the KV cache.
Loading a checkpoint (``from_pretrained``) waits for the checkpoint
converter's port (ROADMAP A8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.data import conversation as conv_lib
from libra_tpu_torch.generation import GenerationConfig, Generator
from libra_tpu_torch.tokenization import IMG_PH, LibraTokenizer


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
        seqs = res.sequences.cpu()
        outs = []
        for b in range(seqs.shape[1]):
            ids = seqs[0, b, N:N + int(res.num_generated[b])]
            ids = ids[ids != gen.pad_token_id]
            outs.append(text_tok.decode(ids.tolist(), skip_special_tokens=True))
        return outs
