"""LLaVA-format instruction-tuning dataset.

The PyTorch port's copy of ``libra_tpu/data/instruction.py`` (the
reference's LazySupervisedDataset, instruction_dataset.py:15-446): lazy json map-style dataset, v1
(vicuna-style USER/ASSISTANT) or plain conversation templates, per-round
label masking of user turns via char->token spans, text-only samples with
a zero image + has_image=False, optional t2i mirroring, filename-repair
retry on missing images.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from libra_tpu_torch.data import conversation as conversation_lib
from libra_tpu_torch.data.caption_format import IMG_PH, label_mask_spans
from libra_tpu_torch.data.pair_samples import pair_collater
from libra_tpu_torch.data.processors import expand2square

DEFAULT_IMAGE_TOKEN = "<image>"
IGNORE_INDEX = -100


class InstructionDataset:
    def __init__(self, ann_path: str, vis_processor, version: str,
                 tokenizer, num_img_tokens: int, vis_root: str,
                 enable_t2i: bool = False, image_size: int = 336,
                 **kwargs):
        with open(ann_path) as f:
            self.list_data_dict: List[Dict] = json.load(f)
        self.vis_root = vis_root
        self.vis_processor = vis_processor
        self.tokenizer = tokenizer
        self.num_img_tokens = num_img_tokens
        self.image_size = image_size
        self.version = version
        self.enable_t2i = enable_t2i
        self.data_args = kwargs
        self.modeling_image = kwargs.get("modeling_image", False)

        if version not in conversation_lib.conv_templates:
            raise NotImplementedError(f"unknown conversation version {version}")
        self.conversation = conversation_lib.conv_templates[version]

        if version == "plain":
            for dd in self.list_data_dict:
                conv = dd["conversations"]
                assert len(conv) == 2
                assert DEFAULT_IMAGE_TOKEN in conv[0]["value"]
                conv[0]["value"] = DEFAULT_IMAGE_TOKEN

        if enable_t2i:
            # mirror each (image -> text) pair into a (text -> image) sample
            # (reference: instruction_dataset.py:56-71)
            assert version == "plain"
            mirrored = []
            for dd in copy.deepcopy(self.list_data_dict):
                c = dd["conversations"]
                r0, r1 = c[0]["from"], c[1]["from"]
                dd["conversations"] = [c[1], c[0]]
                dd["conversations"][0]["from"] = r0
                dd["conversations"][1]["from"] = r1
                dd["task"] = "text2image"
                mirrored.append(dd)
            self.list_data_dict = self.list_data_dict + mirrored

    def __len__(self):
        return len(self.list_data_dict)

    # -- image loading with filename repair --------------------------------

    def _load_image(self, image_file: str):
        from PIL import Image
        path = os.path.join(self.vis_root, image_file)
        try:
            return Image.open(path).convert("RGB")
        except FileNotFoundError:
            repaired = os.path.join(os.path.dirname(path),
                                    os.path.basename(path).replace("-", "_"))
            try:
                return Image.open(repaired).convert("RGB")
            except Exception:  # noqa: BLE001
                return None

    def __getitem__(self, i: int) -> Optional[Dict[str, Any]]:
        entry = self.list_data_dict[i]
        source = copy.deepcopy(entry["conversations"])

        if "image" in entry:
            image = self._load_image(entry["image"])
            if image is None:
                return None  # collater filters (reference: ...:430-435)
            task = entry.get("task")
            if (self.data_args.get("image_aspect_ratio") == "pad"
                    and task != "text2image"):
                bg = (tuple(int(x * 255) for x in self.vis_processor.image_mean)
                      if hasattr(self.vis_processor, "image_mean") else (0, 0, 0))
                image = expand2square(image, bg)
            pixels = self.vis_processor(image)
            contiguous_ignore_sign = task == "text2image"
            source = self._preprocess_multimodal(source)
            has_image = True
        else:
            pixels = np.zeros((self.image_size, self.image_size, 3), np.float32)
            source = self._strip_image_tokens(source)
            has_image = False
            contiguous_ignore_sign = None

        conversation, spans = self._preprocess(source)
        return {
            "vision": pixels,
            "language": conversation,
            "label_mask_position_map": spans,
            "has_image": has_image,
            "contiguous_ignore_sign": contiguous_ignore_sign,
        }

    # -- text preprocessing ------------------------------------------------

    def _strip_image_tokens(self, source):
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN, "")
        return source

    def _preprocess_multimodal(self, source):
        """Replace <image> with the num_img_tokens-long placeholder block at
        the start of the turn (reference: instruction_dataset.py:206-225)."""
        has_image = False
        for sentence in source:
            if self.data_args.get("capitalize", False):
                sentence["value"] = sentence["value"].capitalize()
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                if self.version == "v1" and sentence["from"] != "human":
                    raise ValueError("v1 supports images only in user turns")
                v = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                ph = (" " + IMG_PH) * self.num_img_tokens
                sentence["value"] = (ph.strip() + "\n" + v).strip()
                has_image = True
        assert has_image
        return source

    def _preprocess(self, source):
        if self.conversation.sep_style == conversation_lib.SeparatorStyle.PLAIN:
            return self._preprocess_plain(source)
        if self.conversation.version.startswith("v1"):
            return self._preprocess_v1(source)
        raise NotImplementedError(self.conversation.version)

    def _preprocess_plain(self, source):
        """Caption-style 2-turn samples (reference: ...:231-260)."""
        assert len(source) == 2
        img_in_0 = (DEFAULT_IMAGE_TOKEN in source[0]["value"]
                    or IMG_PH in source[0]["value"])
        img_in_1 = (DEFAULT_IMAGE_TOKEN in source[1]["value"]
                    or IMG_PH in source[1]["value"])
        assert img_in_0 != img_in_1
        ph = (" " + IMG_PH) * self.num_img_tokens
        if img_in_0:
            img_type = "background"
            background = ph.strip()
            instruction_ = "\n"
            respond = source[1]["value"] + self.conversation.sep
        else:
            img_type = "respond"
            background = source[0]["value"]
            instruction_ = "\n "
            respond = ph.strip() + self.conversation.sep

        caption = background + instruction_ + respond
        spans = label_mask_spans(self.tokenizer, caption, background,
                                 instruction_, img_type,
                                 label_mask_strategy="prompt",
                                 respond_tail=True)
        return caption, spans

    def _preprocess_v1(self, source):
        """Vicuna-v1 multi-round chat with per-round user-turn masking
        (reference: instruction_dataset.py:262-326)."""
        conv = self.conversation.copy()
        roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
        if roles.get(source[0]["from"]) != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversation = conv.get_prompt()

        enc = self.tokenizer.encode_with_spans(conversation)
        sep = conv.sep + conv.roles[1] + ": "
        spans: List = [(0, 1)]  # mask <s>
        cur_len = 0
        for rou in conversation.split(conv.sep2):
            if rou == "":
                break
            rou += conv.sep2
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            if self.modeling_image and IMG_PH in parts[0]:
                # keep loss on the in-image tokens of the user turn
                # (reference: ...:301-312)
                head = conv.system + " USER: " + IMG_PH + " "
                spans.append((enc.char_to_token(cur_len),
                              enc.char_to_token(cur_len + len(head))))
                ph = (IMG_PH + " ") * self.num_img_tokens
                tail_start = cur_len + len(
                    conv.system + " USER: " + ph.strip())
                spans.append((enc.char_to_token(tail_start),
                              enc.char_to_token(cur_len + len(parts[0]))))
            else:
                spans.append((enc.char_to_token(cur_len),
                              enc.char_to_token(cur_len + len(parts[0]))))
            cur_len += len(rou)
        return conversation, spans

    def collater(self, samples):
        return pair_collater(samples)
