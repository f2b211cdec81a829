"""Caption assembly + label-mask span construction.

The PyTorch port's copy of ``libra_tpu/data/caption_format.py``, shared
by the LAION pretraining pipeline and the plain-template instruction
dataset. It follows the reference's
laion_dataset.py:178-241 (process_caption) and
instruction_dataset.py:384-430 (the instruction variant that also handles
respond-image captions ending in "<img_ph>\\n").

Label-mask spans are (start_token, end_token) pairs later burned to -100
(reference: LibraTrainWrapper.get_labels, modeling_libra.py:1397-1411).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

IMG_PH = "<img_ph>"

I2T_INSTRUCTION_LIST = [
    "Describe the image concisely.",
    "Provide a brief description of the given image.",
    "Offer a succinct explanation of the picture presented.",
    "Summarize the visual content of the image.",
    "Give a short and clear explanation of the image.",
    "Share a concise interpretation of the image provided.",
    "Present a compact description of the photo's key features.",
    "Relay a brief, clear account of the picture shown.",
    "Render a clear and concise summary of the photo.",
    "Write a terse but informative summary of the picture.",
    "Create a compact narrative representing the image presented.",
    "",
]

T2I_INSTRUCTION_LIST = [
    "Generate an image corresponding to the caption.",
    "Create a visual representation of the given description.",
    "Craft an image based on the provided text.",
    "Produce an illustrative depiction of the caption.",
    "Generate an image that reflects the essence of the given text.",
    "Create an accompanying image for the provided description.",
    "Craft a visual interpretation of the given caption.",
    "Generate an image that captures the meaning conveyed in the text.",
    "Create a corresponding image for the given textual context.",
    "",
]

Span = Tuple[Optional[int], Optional[int]]


def image_placeholder(num_img_tokens: int) -> str:
    return (" " + IMG_PH) * num_img_tokens
    # callers .strip() -- kept explicit at call sites for parity


def build_caption(background: str, respond: str, instruction: str,
                  img_type: str, add_newline_sep: bool = False
                  ) -> Tuple[str, str]:
    """Assemble `background + instruction_ + respond` with the reference's
    separator quirks (laion_dataset.py:196-216). Returns (caption,
    instruction_) where instruction_ is the fully-separated middle part."""
    assert img_type in ("background", "respond")
    background = background.strip()
    respond = respond.strip()
    instruction = instruction.strip()

    if instruction:
        instruction_ = ("\n" + instruction + "\n" if img_type == "background"
                        else " " + instruction + "\n ")
    else:
        instruction_ = "\n" if img_type == "background" else "\n "

    if add_newline_sep and img_type == "background":
        respond = respond + "\n"

    return background + instruction_ + respond, instruction_


def label_mask_spans(tokenizer, caption: str, background: str,
                     instruction_: str, img_type: str,
                     label_mask_strategy: str = "prompt",
                     respond_tail: bool = False) -> List[Span]:
    """Token spans to mask out of the loss.

    * "prompt": mask everything up to the respond text;
    * "instruction": mask only the instruction_ part;
    * "none": nothing;
    plus always: the nearest text token after an image (its logits come
    from the vision head, reference: laion_dataset.py:222-236).

    respond_tail=True uses the instruction-dataset variant that accounts
    for a trailing conversation separator after the image placeholders
    (instruction_dataset.py:407-419).
    """
    enc = tokenizer.encode_with_spans(caption)
    spans: List[Span] = []
    if label_mask_strategy == "prompt":
        spans.append((0, enc.char_to_token(len(background + instruction_))))
    elif label_mask_strategy == "instruction":
        spans.append((enc.char_to_token(len(background)),
                      enc.char_to_token(len(background + instruction_))))
    elif label_mask_strategy != "none":
        raise NotImplementedError(label_mask_strategy)

    add_eos = getattr(tokenizer, "add_eos_token", False)
    n = enc.length[0]
    if img_type == "respond":
        if respond_tail and caption.endswith(IMG_PH + "\n"):
            start = (n - 2) if add_eos else (n - 1)
        elif caption.endswith(IMG_PH):
            start = (n - 1) if add_eos else n
        elif not respond_tail:
            start = (n - 1) if add_eos else n
        else:
            raise NotImplementedError(
                "respond caption must end with the image block")
        spans.append((start, start + 1))
    else:  # background: first text token after the image block
        start = enc.char_to_token(len(background))
        spans.append((start, start + 1))
    return spans
