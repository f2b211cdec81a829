"""Joint text + image tokenization, both ways.

    tokenizer([{"language": [...], "vision": [...]}]) ->
        {input_ids (Q, B, N), attention_mask (B, N), vision_indices (B, N),
         coninous_signal (B, N, C) or None}
    tokenizer.batch_decode(ids (Q, B, N)) ->
        [{"language": str, "vision": pixels (n_images, S, S, 3) or None}]

Text runs host-side through a pluggable text tokenizer (SimpleTextTokenizer,
or HFTextTokenizer over a checkpoint's fast tokenizer); images run through
the VQGAN encode on the image tokenizer's device. Vision ids are offset by
the text vocab size; each image becomes <BOI> + g*g tokens + <EOI>,
scattered into the `<img_ph>` positions of the text. `vision_indices` is
each token's index inside its image block, and max_vision_token_length for
text. The misspelled key "coninous_signal" is kept for parity with the
JAX package. Decoding splits each codebook's ids at BOI/EOI pairs; the
text goes to the text tokenizer, each image block through the VQGAN
decoder (models/vqgan.decode_code) on the image tokenizer's device.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from libra_tpu_torch.config import VQGANConfig
from libra_tpu_torch.models import vqgan as vqgan_model

IMG_PH = "<img_ph>"
MAX_TOKEN_LENGTH = 2048   # the reference tokenizer's model_max_length
IMG_GEN = "<img_gen>"

_WORDS = re.compile(r"<img_ph>|<img_gen>|\S+?(?=<img_ph>|<img_gen>)|\S+")


class Encoding:
    """One text's ids with each token's source char span: the char ->
    token map the data layer's label masks read (HF fast tokenizers'
    char_to_token)."""

    def __init__(self, ids: List[int], char_spans: List[Optional[tuple]]):
        self.ids = ids
        self._spans = char_spans  # per token: (start, end), None for specials

    @property
    def length(self) -> List[int]:
        return [len(self.ids)]

    def char_to_token(self, char_index: int) -> Optional[int]:
        for t, span in enumerate(self._spans):
            if span is not None and span[0] <= char_index < span[1]:
                return t
        return None


class SimpleTextTokenizer:
    """Minimal whitespace tokenizer with the LLaMA tokenizer's surface, for
    tests and runs without a real vocabulary: pad = unk = 0, bos = 1
    (prepended while add_bos_token is set), eos = 2. Unseen words get ids
    as they first appear, as in the JAX package, so two tokenizers fed the
    same texts in the same order agree."""

    def __init__(self, vocab_size: int = 256):
        self.base_vocab_size = vocab_size
        self.add_bos_token = True
        self.add_eos_token = False
        self.vocab: Dict[str, int] = {}
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.img_ph_token_id = vocab_size - 2
        self.img_gen_token_id = vocab_size - 1
        self.padding_side = "right"
        self._next_id = 3

    def _word_id(self, w: str) -> int:
        if w == IMG_PH:
            return self.img_ph_token_id
        if w == IMG_GEN:
            return self.img_gen_token_id
        if w not in self.vocab:
            self._next_id += 1
            self.vocab[w] = 3 + self._next_id % (self.base_vocab_size - 8)
        return self.vocab[w]

    def encode_one(self, text: str) -> List[int]:
        return self.encode_with_spans(text).ids

    def encode_with_spans(self, text: str) -> Encoding:
        """Tokenize one text, keeping each token's char span, stretched
        back over the whitespace before it (a whitespace char maps to the
        token after it, as in HF's char_to_token)."""
        ids: List[int] = []
        spans: List[Optional[tuple]] = []
        if self.add_bos_token:
            ids.append(self.bos_token_id)
            spans.append(None)
        for m in _WORDS.finditer(text):
            ids.append(self._word_id(m.group(0)))
            start = spans[-1][1] if spans and spans[-1] is not None else m.start()
            spans.append((start, m.end()))
        if self.add_eos_token:
            ids.append(self.eos_token_id)
            spans.append(None)
        return Encoding(ids, spans)

    def __call__(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        seqs = [self.encode_one(t) for t in texts]
        n = max(len(s) for s in seqs)
        ids = np.full((len(seqs), n), self.pad_token_id, np.int64)
        mask = np.zeros((len(seqs), n), np.int64)
        for i, s in enumerate(seqs):
            sl = slice(n - len(s), n) if self.padding_side == "left" else slice(0, len(s))
            ids[i, sl] = s
            mask[i, sl] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        inv = {v: k for k, v in self.vocab.items()}
        inv[self.img_ph_token_id] = IMG_PH
        special = (self.pad_token_id, self.bos_token_id, self.eos_token_id)
        return " ".join(inv.get(int(i), f"<{int(i)}>") for i in ids
                        if not (skip_special_tokens and int(i) in special))


class HFTextTokenizer:
    """A checkpoint's LLaMA fast tokenizer with Libra's added tokens
    (<img_ph>, <img_gen>; pad = unk). Needs `transformers`, imported when
    one is built."""

    def __init__(self, pretrained_model_path: str, **kwargs):
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(pretrained_model_path,
                                            use_fast=True, **kwargs)
        tok.add_tokens(IMG_PH)
        tok.add_tokens(IMG_GEN)
        tok.pad_token = tok.unk_token
        self.tok = tok
        self.img_ph_token_id = tok.convert_tokens_to_ids(IMG_PH)
        self.img_gen_token_id = tok.convert_tokens_to_ids(IMG_GEN)

    def __getattr__(self, name):
        if name == "tok":       # not set yet (a copy or an unpickle)
            raise AttributeError(name)
        return getattr(self.tok, name)

    def __call__(self, texts, **kw) -> Dict[str, np.ndarray]:
        kw.setdefault("return_length", True)
        out = self.tok(list(texts), **kw)
        return {k: np.asarray(v) for k, v in out.items()}

    def encode_with_spans(self, text: str) -> "_HFEncoding":
        """The fast encoding's char -> token map."""
        return _HFEncoding(self.tok(text))

    def decode(self, ids, **kw) -> str:
        return self.tok.decode(ids, **kw)


class _HFEncoding:
    def __init__(self, enc):
        self._enc = enc
        self.ids = enc["input_ids"]
        self.length = [len(self.ids)]

    def char_to_token(self, char_index: int) -> Optional[int]:
        return self._enc.char_to_token(char_index)


class ImageTokenizer:
    """VQGAN-backed image tokenizer with combined-vocab framing: codes
    occupy [offset, offset + codebook_size); BOI = offset + codebook_size;
    EOI = BOI + 1. downsample_ratio: a conv encoder's (None for the
    fixed-size CLIP tap)."""

    def __init__(self, cfg: VQGANConfig, params: Dict, token_offset: int,
                 max_vision_token_length: int = 578,
                 downsample_ratio: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.offset = token_offset
        self.num_codebook = cfg.num_codebook
        self.vocab_size = cfg.codebook_size + 2
        self.boi_token_id = token_offset + self.vocab_size - 2
        self.eoi_token_id = token_offset + self.vocab_size - 1
        self.max_vision_token_length = max_vision_token_length
        self.downsample_ratio = downsample_ratio

    @staticmethod
    def infer_downsample_ratio(ckpt_path: str) -> Optional[int]:
        """A conv encoder's downsample ratio from the checkpoint's file
        name (`_f16_` / `_f8_`); None for the fixed-size CLIP encoder."""
        name = os.path.basename(str(ckpt_path))
        if "_f16_" in name and "_f8_" in name:
            raise ValueError(f"ambiguous downsample markers in {name!r}")
        if "_f16_" in name:
            return 16
        if "_f8_" in name:
            return 8
        return None

    def get_token_length(self, images=None) -> int:
        """Vision tokens an image occupies (grid**2 + BOI + EOI). With a
        conv encoder the grid follows the (square, NHWC) input's side."""
        if self.downsample_ratio is None or images is None:
            return self.max_vision_token_length
        arr = np.asarray(images[0] if isinstance(images, (list, tuple))
                         else images)
        h, w = arr.shape[-3], arr.shape[-2]
        if h != w:
            raise ValueError("image tokenization requires square images")
        return (h // self.downsample_ratio) ** 2 + 2

    def encode(self, pixels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pixels (B, S, S, 3) CLIP-normalized NHWC -> input_ids
        (Q, B, max_vision_token_length) with BOI/EOI framing and
        encoder_feat (B, g*g, C), on the params' device."""
        w = self.params["quant_conv"]["w"]
        pixels = pixels.to(device=w.device, dtype=w.dtype)
        out = vqgan_model.encode(self.params, self.cfg, pixels)
        B, g, _, Q = out.indices.shape
        ids = out.indices.permute(3, 0, 1, 2).reshape(Q, B, g * g) + self.offset
        boi = torch.full((Q, B, 1), self.boi_token_id, dtype=ids.dtype, device=ids.device)
        eoi = torch.full((Q, B, 1), self.eoi_token_id, dtype=ids.dtype, device=ids.device)
        return {"input_ids": torch.cat([boi, ids, eoi], dim=-1),
                "encoder_feat": out.feat.reshape(B, g * g, -1)}

    def decode(self, token_ids) -> Optional[torch.Tensor]:
        """token_ids: per image, per-codebook id lists (B, Q, N), or one
        image's (Q, N); with or without BOI/EOI framing (stripped when a
        BOI is present). Un-offset to codebook indices and decoded to
        pixels (B, S, S, 3) fp32 on the params' device; None for no
        images."""
        if token_ids is None or len(token_ids) == 0:
            return None
        x = _host_ids(token_ids)
        if x.ndim == 2:      # (Q, N): one image
            x = x[None]
        if (x == self.boi_token_id).any():
            x = x[:, :, 1:-1]
        Bq, Q, N = x.shape
        g = int(round(N ** 0.5))
        if g * g != N:
            raise ValueError("image decode requires square token grids")
        x = x.reshape(Bq, Q, g, g).transpose(0, 2, 3, 1) - self.offset
        device = self.params["post_quant_conv"]["w"].device
        with torch.inference_mode():
            return vqgan_model.decode_code(self.params, self.cfg,
                                           torch.as_tensor(x, device=device))


def _host_ids(ids) -> np.ndarray:
    """Token ids (nested lists, an array or a tensor anywhere) as int64
    numpy on the host."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy().astype(np.int64)
    return np.asarray(ids, np.int64)


class LibraTokenizer:
    """Fuses text and image tokenization into decoder-ready tensors."""

    def __init__(self, text_tokenizer, image_tokenizer: ImageTokenizer):
        self.text_tokenizer = text_tokenizer
        self.image_tokenizer = image_tokenizer
        self.num_codebook = image_tokenizer.num_codebook

    def __call__(self, samples, truncation: bool = False,
                 max_length: Optional[int] = None
                 ) -> Dict[str, Optional[torch.Tensor]]:
        """samples: dicts with "language" (str or list) and optional
        "vision" (images as (S, S, 3) arrays or tensors, CLIP-normalized),
        "contiguous_ignore_sign" (per image: zero its signal rows) and
        "has_image" (per image: False drops a placeholder image).
        truncation cuts every row to max_length (default: the text
        tokenizer's model_max_length, else MAX_TOKEN_LENGTH) after the
        images are placed. The result lies on the image tokenizer's device
        when there are images, else on the CPU."""
        if not isinstance(samples, (list, tuple)):
            samples = [samples]
        texts: List[str] = []
        images: List[Any] = []
        ignore_signs: List[bool] = []
        has_image: List[bool] = []

        def extend(out: list, x):
            out += list(x) if isinstance(x, (list, tuple)) else [x]

        for s in samples:
            for key, out in (("language", texts), ("vision", images),
                             ("contiguous_ignore_sign", ignore_signs),
                             ("has_image", has_image)):
                if s.get(key) is not None:
                    extend(out, s[key])
        if not texts:
            raise ValueError("Empty text inputs")
        max_length = max_length or getattr(self.text_tokenizer,
                                           "model_max_length", MAX_TOKEN_LENGTH)

        t = self.text_tokenizer(texts)
        device = (self.image_tokenizer.params["quant_conv"]["w"].device
                  if images else torch.device("cpu"))
        ids = torch.as_tensor(np.asarray(t["input_ids"], np.int64), device=device)
        mask = torch.as_tensor(np.asarray(t["attention_mask"], np.int64), device=device)
        B, N = ids.shape
        Q = self.num_codebook
        M = self.image_tokenizer.max_vision_token_length

        img_ph_mask = ids == self.text_tokenizer.img_ph_token_id
        img_gen_mask = ids == self.text_tokenizer.img_gen_token_id
        ids[img_gen_mask] = self.image_tokenizer.boi_token_id
        input_ids = ids[None].expand(Q, B, N).clone()
        vision_indices = torch.full((B, N), M, dtype=torch.int64, device=device)
        signal = None

        if images:
            pixels = torch.stack([torch.as_tensor(im) for im in images])
            enc = self.image_tokenizer.encode(pixels)
            img_ids, feat = enc["input_ids"], enc["encoder_feat"]
            if has_image:
                keep = torch.as_tensor(has_image, dtype=torch.bool, device=device)
                img_ids, feat = img_ids[:, keep], feat[keep]
            n_img = img_ids.shape[1]
            n_slots = int(img_ph_mask.sum())
            if n_slots != n_img * M:
                raise ValueError(
                    f"{n_slots} <img_ph> slots but {n_img} images x {M} tokens")
            input_ids[:, img_ph_mask] = img_ids.reshape(Q, -1)
            vision_indices[img_ph_mask] = torch.arange(M, device=device).repeat(n_img)
            zero_row = feat.new_zeros((n_img, 1, feat.shape[-1]))
            framed = torch.cat([zero_row, feat, zero_row], dim=1)
            if ignore_signs:
                ignore = torch.as_tensor(ignore_signs, dtype=torch.bool, device=device)
                framed = torch.where(ignore[:, None, None], 0.0, framed)
            signal = feat.new_zeros((B, N, feat.shape[-1]))
            signal[img_ph_mask] = framed.reshape(-1, feat.shape[-1])
        else:
            vision_indices[img_gen_mask] = 0

        if truncation:
            input_ids = input_ids[:, :, :max_length]
            mask = mask[:, :max_length]
            vision_indices = vision_indices[:, :max_length]
            if signal is not None:
                signal = signal[:, :max_length]
        return {"input_ids": input_ids, "attention_mask": mask,
                "vision_indices": vision_indices, "coninous_signal": signal}

    def batch_decode(self, token_ids, **kw) -> List[Dict[str, Any]]:
        """token_ids (Q, B, N) -> per row {"language": text, "vision":
        pixels or None}; kw goes to the text tokenizer's decode."""
        arr = _host_ids(token_ids)
        return [self.decode(arr[:, b], **kw) for b in range(arr.shape[1])]

    def decode(self, token_ids, **kw) -> Dict[str, Any]:
        """token_ids (Q, N), one row: codebook 0's text (an <img_ph> id
        where each image stood) and the images, each decoded from all
        codebooks' blocks."""
        per_codebook = [self._split_text_image(row) for row in _host_ids(token_ids)]
        text_ids = per_codebook[0][0]
        n_images = len(per_codebook[0][1])
        images = [[per_codebook[q][1][i] for q in range(len(per_codebook))]
                  for i in range(n_images)]
        return {"language": self.text_tokenizer.decode(text_ids, **kw),
                "vision": self.image_tokenizer.decode(images) if n_images else None}

    def _split_text_image(self, ids: np.ndarray):
        """Split one codebook's ids at its BOI/EOI pairs into (text ids,
        image blocks with their framing). The last id is dropped, as the
        reference drops a trailing EOS."""
        boi = np.nonzero(ids == self.image_tokenizer.boi_token_id)[0]
        eoi = np.nonzero(ids == self.image_tokenizer.eoi_token_id)[0]
        if len(boi) != len(eoi):
            raise ValueError("Incomplete images found during decoding")
        if len(boi) == 0:
            return ids.tolist(), []
        text_ids: List[int] = []
        image_ids: List[List[int]] = []
        cur = 0
        for b, e in zip(boi, eoi):
            if e < b:
                raise ValueError("EOI occurs before BOI")
            text_ids += ids[cur:b].tolist()
            text_ids.append(self.text_tokenizer.img_ph_token_id)
            image_ids.append(ids[b:e + 1].tolist())
            cur = e + 1
        text_ids += ids[cur:-1].tolist()
        return text_ids, image_ids
