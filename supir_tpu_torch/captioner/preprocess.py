"""Train-time conversation preprocessing (counterpart of
supir_tpu/captioner/preprocess.py, numpy only): llava-format JSON ->
(input_ids, labels) with per-turn IGNORE_INDEX masking, a lazy dataset and
a static-shape collator.

Behavioral contract, as the JAX module states it: `llava/train/train.py:302-775`,
`preprocess_multimodal` (image-token normalization), the per-template
label maskers (`preprocess_v1:407`, `preprocess_mpt:491`,
`preprocess_plain:557`, `preprocess_llama_2:326`, the legacy "###" default
at `preprocess:580`), `LazySupervisedDataset:626` and
`DataCollatorForSupervisedDataset:711`; the image-token splice of
`llava/mm_utils.py:43-63` (`tokenizer_image_token`). The collator pads to a
fixed `max_len`, as the JAX module does. `ByteTokenizer` is a stand-in for
runs without a real tokenizer.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from supir_tpu_torch.captioner.conversation import SeparatorStyle, conv_templates

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"


# --------------------------------------------------------------- tokenizer

class ByteTokenizer:
    """A tokenizer for runs without a real one: one id per UTF-8 byte,
    offset past the special ids (0 pad, 1 bos, 2 eos), so the ids stay below
    259 in any vocabulary at least that large; a leading bos unless `bos` is
    False (MPT's GPT-NeoX tokenizer adds none, and `preprocess_mpt` counts
    on that). It has the `.encode` / `bos_token_id` / `model_max_length`
    surface this module reads."""

    pad_token_id, bos_token_id, eos_token_id = 0, 1, 2
    model_max_length = 1 << 30

    def __init__(self, bos: bool = True):
        self.bos = bos

    def encode(self, text: str) -> List[int]:
        return [self.bos_token_id] * self.bos + [b + 3 for b in text.encode()]

    def decode(self, ids) -> str:
        return bytes(i - 3 for i in ids if i >= 3).decode(errors="replace")


def token_ids(tokenizer, text: str) -> List[int]:
    """ids WITH special tokens (bos), as `tokenizer(text).input_ids` yields
    for HF tokenizers; also accepts any object with `.encode`."""
    if hasattr(tokenizer, "__call__"):
        try:
            out = tokenizer(text)
            ids = getattr(out, "input_ids", None)
            if ids is None and isinstance(out, dict):
                ids = out.get("input_ids")
            if ids is not None:
                return list(ids)
        except TypeError:
            pass
    return list(tokenizer.encode(text))


def tokenize_image_prompt(
    prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
) -> List[int]:
    """Tokenize text containing `<image>` markers: each marker becomes one
    `image_token_index` id; chunk-leading bos tokens (the tokenizer re-adds
    one per chunk) are dropped except the very first
    (mm_utils.py:43-63)."""
    chunks = [token_ids(tokenizer, c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    bos = getattr(tokenizer, "bos_token_id", None)
    ids: List[int] = []
    lead = 0
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        lead = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (lead + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i + 1 < len(chunks):
            merged.append(sep)
    for part in merged:
        ids.extend(part[lead:])
    return ids


def _len_img(prompt: str, tokenizer) -> int:
    return len(tokenize_image_prompt(prompt, tokenizer))


def _max_len(tokenizer) -> int:
    return int(getattr(tokenizer, "model_max_length", 1 << 30))


# ------------------------------------------------------------- multimodal

def normalize_multimodal(sources, mm_use_im_start_end: bool = False,
                         version: str = ""):
    """Move the `<image>` marker to the front of its turn on its own line
    (train.py:302-324). Mutates and returns `sources`."""
    for source in sources:
        for turn in source:
            if DEFAULT_IMAGE_TOKEN in turn["value"]:
                stripped = turn["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                turn["value"] = (DEFAULT_IMAGE_TOKEN + "\n" + stripped).strip()
                if "mmtag" in version:
                    turn["value"] = turn["value"].replace(
                        DEFAULT_IMAGE_TOKEN,
                        "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>")
            if mm_use_im_start_end:
                turn["value"] = turn["value"].replace(
                    DEFAULT_IMAGE_TOKEN,
                    DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                    + DEFAULT_IM_END_TOKEN)
    return sources


# ----------------------------------------------------------- conversation

def _render(template, source) -> str:
    """Apply the conversation template to one llava-format source (list of
    {'from': 'human'|'gpt', 'value': str}); returns the full prompt."""
    conv = template.copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles.get(source[0]["from"]) != conv.roles[0]:
        source = source[1:]
    conv.messages = []
    for j, turn in enumerate(source):
        role = roles[turn["from"]]
        assert role == conv.roles[j % 2], "conversation roles must alternate"
        conv.append_message(role, turn["value"])
    return conv.get_prompt()


def _tokenize_batch(conversations: Sequence[str], tokenizer, has_image: bool):
    if has_image:
        return [tokenize_image_prompt(c, tokenizer) for c in conversations]
    return [token_ids(tokenizer, c)[: _max_len(tokenizer)]
            for c in conversations]


def _count(text: str, tokenizer, has_image: bool) -> int:
    if has_image:
        return _len_img(text, tokenizer)
    return len(token_ids(tokenizer, text))


def _mask_two_style(conversations, inputs, tokenizer, has_image, sep, sep2,
                    skip_offset=2, bos_prefix=1):
    """Shared round-walk masker for TWO (v1) and LLAMA_2 styles
    (train.py:365-400 / 446-481): rounds split on sep2, instruction part
    split on sep, instruction masked minus `skip_offset` (bos + the
    sep-leading-space merge of SP tokenizers)."""
    labels = [np.array(ids, dtype=np.int64) for ids in inputs]
    for conversation, ids, target in zip(conversations, inputs, labels):
        total_len = len(ids)
        rounds = conversation.split(sep2)
        cur = bos_prefix
        target[:cur] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            instruction = parts[0] + sep
            round_len = _count(rou, tokenizer, has_image)
            instr_len = _count(instruction, tokenizer, has_image) - skip_offset
            target[cur: cur + instr_len] = IGNORE_INDEX
            cur += round_len
        target[cur:] = IGNORE_INDEX
        if cur < _max_len(tokenizer) and cur != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur} vs. {total_len}."
                  f" (ignored)")
    return labels


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  template=None) -> Dict[str, list]:
    """vicuna-v1 (SeparatorStyle.TWO) masking (train.py:407-489)."""
    template = template or conv_templates["v1"]
    conversations = [_render(template, s) for s in sources]
    inputs = _tokenize_batch(conversations, tokenizer, has_image)
    sep = template.sep + template.roles[1] + ": "
    labels = _mask_two_style(conversations, inputs, tokenizer, has_image,
                             sep, template.sep2)
    return {"input_ids": inputs, "labels": [t.tolist() for t in labels]}


def preprocess_llama_2(sources, tokenizer, has_image: bool = False,
                       template=None) -> Dict[str, list]:
    """llama-2 ([INST]) masking (train.py:326-405)."""
    template = template or conv_templates["llama_2"]
    conversations = [_render(template, s) for s in sources]
    inputs = _tokenize_batch(conversations, tokenizer, has_image)
    labels = _mask_two_style(conversations, inputs, tokenizer, has_image,
                             "[/INST] ", template.sep2)
    return {"input_ids": inputs, "labels": [t.tolist() for t in labels]}


def preprocess_mpt(sources, tokenizer, template=None) -> Dict[str, list]:
    """MPT (<|im_end|>) masking (train.py:491-554): rounds regrouped as
    [system+user+gpt] then [user+gpt] pairs; round length counts a trailing
    sep; instruction length is exact (no -2: no bos, no SP space merge)."""
    template = template or conv_templates["mpt"]
    conversations = [_render(template, s) for s in sources]
    inputs = [tokenize_image_prompt(c, tokenizer) for c in conversations]
    sep = template.sep + template.roles[1]
    labels = [np.array(ids, dtype=np.int64) for ids in inputs]
    sep_len = _len_img(template.sep, tokenizer)
    for conversation, ids, target in zip(conversations, inputs, labels):
        total_len = len(ids)
        rounds = conversation.split(template.sep)
        grouped = [template.sep.join(rounds[:3])]
        for k in range(3, len(rounds), 2):
            grouped.append(template.sep.join(rounds[k: k + 2]))
        cur = 0
        for rou in grouped:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            instruction = parts[0] + sep
            round_len = _len_img(rou, tokenizer) + sep_len
            instr_len = _len_img(instruction, tokenizer)
            target[cur: cur + instr_len] = IGNORE_INDEX
            cur += round_len
        target[cur:] = IGNORE_INDEX
        if cur < _max_len(tokenizer) and cur != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur} vs. {total_len}."
                  f" (ignored)")
    return {"input_ids": inputs, "labels": [t.tolist() for t in labels]}


def preprocess_plain(sources, tokenizer, template=None) -> Dict[str, list]:
    """Pretraining format (train.py:557-577): `<image>` + answer + sep; the
    image token span is masked."""
    template = template or conv_templates["plain"]
    inputs, labels = [], []
    for source in sources:
        assert len(source) == 2 and DEFAULT_IMAGE_TOKEN in source[0]["value"]
        text = DEFAULT_IMAGE_TOKEN + source[1]["value"] + template.sep
        ids = tokenize_image_prompt(text, tokenizer)
        lab = np.array(ids, dtype=np.int64)
        lab[: _len_img(DEFAULT_IMAGE_TOKEN, tokenizer)] = IGNORE_INDEX
        inputs.append(ids)
        labels.append(lab.tolist())
    return {"input_ids": inputs, "labels": labels}


def preprocess_v0(sources, tokenizer, has_image: bool = False,
                  template=None) -> Dict[str, list]:
    """Legacy '### role:' format (train.py:580-624 + _add_speaker_and_signal
    / _mask_targets at :270-300): each turn wrapped as '### {role}: {text}\\n',
    human turns masked except their two leading signal tokens."""
    template = template or conv_templates["v0"]
    roles = {"human": template.roles[0], "gpt": template.roles[1]}
    inputs, labels = [], []
    for source in sources:
        header = f"{template.system}\n\n"
        wrapped = []
        for turn in source:
            role = roles.get(turn["from"].lower(), "unknown")
            wrapped.append(f"### {role}: {turn['value']}\n")
        conversation = header + "".join(wrapped) + "### "
        ids = (tokenize_image_prompt(conversation, tokenizer) if has_image
               else token_ids(tokenizer, conversation)[: _max_len(tokenizer)])
        lab = np.array(ids, dtype=np.int64)
        lens = [_count(header, tokenizer, has_image)] + [
            _count(w, tokenizer, has_image) for w in wrapped]
        cur = lens[0]
        lab[:cur] = IGNORE_INDEX
        for tlen, turn in zip(lens[1:], source):
            if turn["from"] == "human":
                lab[cur + 2: cur + tlen] = IGNORE_INDEX
            cur += tlen
        inputs.append(ids)
        labels.append(lab.tolist())
    return {"input_ids": inputs, "labels": labels}


def preprocess(sources, tokenizer, has_image: bool = False,
               template_name: str = "v1") -> Dict[str, list]:
    """Dispatch by template family (train.py:580-593)."""
    template = conv_templates[template_name]
    if template.sep_style == SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer, template)
    if template.sep_style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image, template)
    if template.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image, template)
    if template.version == "mpt":
        return preprocess_mpt(sources, tokenizer, template)
    return preprocess_v0(sources, tokenizer, has_image, template)


# ------------------------------------------------------------------ dataset

class LazyCaptionDataset:
    """Lazy llava-format dataset (train.py:626-709): a JSON list of
    {'conversations': [...], 'image': optional path}; tokenization happens
    per __getitem__. `image_loader(path) -> np.ndarray [H,W,3] float` is
    injected so tests run without PIL/files; it returns uint8 HWC, as PIL
    gives (the port's `preprocess_images` takes uint8)."""

    def __init__(self, data_path: str, tokenizer, template_name: str = "v1",
                 image_dir: str = "", image_loader=None,
                 is_multimodal: bool = True,
                 mm_use_im_start_end: bool = False,
                 image_size: int = 336, blank_image_shape=None):
        if isinstance(data_path, str):
            with open(data_path) as f:
                self.records = json.load(f)
        else:
            self.records = list(data_path)  # pre-loaded list, for tests
        self.tokenizer = tokenizer
        self.template_name = template_name
        self.image_dir = image_dir
        self.image_loader = image_loader
        self.is_multimodal = is_multimodal
        self.mm_use_im_start_end = mm_use_im_start_end
        self.image_size = image_size
        self.blank_image_shape = blank_image_shape or (image_size, image_size, 3)

    def __len__(self):
        return len(self.records)

    @property
    def lengths(self) -> List[int]:
        """Approximate token lengths for the length-grouped sampler
        (train.py:646-652): word count + 128 if an image is present."""
        out = []
        for rec in self.records:
            n = sum(len(t["value"].split()) for t in rec["conversations"])
            out.append(n + (128 if "image" in rec else 0))
        return out

    @property
    def modality_lengths(self) -> List[int]:
        """Signed lengths: negative for text-only samples (train.py:654-660),
        so the modality-grouped sampler keeps image/text batches pure."""
        out = []
        for rec in self.records:
            n = sum(len(t["value"].split()) for t in rec["conversations"])
            out.append(n if "image" in rec else -n)
        return out

    def _load_image(self, rel_path: str) -> np.ndarray:
        if self.image_loader is not None:
            img = self.image_loader(os.path.join(self.image_dir, rel_path))
        else:
            from PIL import Image

            img = np.asarray(
                Image.open(os.path.join(self.image_dir, rel_path)).convert("RGB"))
        from supir_tpu_torch.captioner.vision import preprocess_images

        return preprocess_images([img], self.image_size)[0].numpy()

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.records[i]
        has_image = "image" in rec
        sources = [copy.deepcopy(rec["conversations"])]
        if has_image and self.is_multimodal:
            version = conv_templates[self.template_name].version
            sources = normalize_multimodal(
                sources, self.mm_use_im_start_end, version)
        out = preprocess(sources, self.tokenizer, has_image=has_image,
                         template_name=self.template_name)
        item = {
            "input_ids": np.asarray(out["input_ids"][0], np.int64),
            "labels": np.asarray(out["labels"][0], np.int64),
        }
        if has_image:
            item["image"] = self._load_image(rec["image"])
        elif self.is_multimodal:
            item["image"] = np.zeros(self.blank_image_shape, np.float32)
        return item


def collate(instances: Sequence[Dict[str, np.ndarray]], pad_id: int,
            max_len: int) -> Dict[str, np.ndarray]:
    """Pad a list of dataset items to ONE static [B, max_len] shape
    (train.py:711-743; pad-to-fixed instead of pad-to-longest so the jitted
    step compiles once). input_ids pad with pad_id, labels with IGNORE."""
    bsz = len(instances)
    input_ids = np.full((bsz, max_len), pad_id, np.int32)
    labels = np.full((bsz, max_len), IGNORE_INDEX, np.int32)
    for row, inst in enumerate(instances):
        ids = np.asarray(inst["input_ids"])[:max_len]
        lab = np.asarray(inst["labels"])[:max_len]
        input_ids[row, : len(ids)] = ids
        labels[row, : len(lab)] = lab
    batch = {
        "input_ids": input_ids,
        "labels": labels,
        "attention_mask": (input_ids != pad_id).astype(np.int32),
    }
    if instances and "image" in instances[0]:
        batch["images"] = np.stack([inst["image"] for inst in instances])
    return batch
