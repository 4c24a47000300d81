"""Conversation templates and stop-keyword matching for the captioner
(the port's copy of supir_tpu/captioner/conversation.py, the reference's
llava/conversation.py): the prompt formats, `conv_templates`, the chat
UI's image messages (`(text, image, mode)` tuples, `process_image`,
`get_images`), `KeywordStopper` and `build_prompt`. System prompts, roles
and separators are prompt-format contracts with the released checkpoints
and are kept verbatim.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = "single"
    TWO = "two"
    MPT = "mpt"
    PLAIN = "plain"
    LLAMA_2 = "llama_2"


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def get_prompt(self) -> str:
        msgs = [list(m) for m in self.messages]
        # an image message is a (text, image, mode) tuple: the first becomes
        # "<image>\n<text>", or for an mmtag version an image turn of its own
        if msgs and isinstance(msgs[0][1], tuple):
            role0, (txt, *_rest) = msgs[0][0], msgs[0][1]
            txt = txt.replace("<image>", "").strip()
            if "mmtag" in self.version:
                msgs[0] = [role0, txt]
                msgs.insert(0, [self.roles[0], "<Image><image></Image>"])
                msgs.insert(1, [self.roles[1], "Received."])
            else:
                msgs[0] = [role0, "<image>\n" + txt]

        def text_of(m):
            return m[0] if isinstance(m, tuple) else m

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            parts = [self.system + self.sep]
            for role, msg in msgs:
                parts.append(f"{role}: {text_of(msg)}{self.sep}" if msg else f"{role}:")
            return "".join(parts)

        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            parts = [self.system + seps[0]]
            for i, (role, msg) in enumerate(msgs):
                parts.append(f"{role}: {text_of(msg)}{seps[i % 2]}" if msg else f"{role}:")
            return "".join(parts)

        if style == SeparatorStyle.MPT:
            parts = [self.system + self.sep]
            for role, msg in msgs:
                parts.append(f"{role}{text_of(msg)}{self.sep}" if msg else role)
            return "".join(parts)

        if style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, msg) in enumerate(msgs):
                if i == 0 and (not msg or role != self.roles[0]):
                    raise ValueError("the first message must be a non-empty user turn")
                if not msg:
                    continue
                txt = text_of(msg)
                if i == 0:
                    txt = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n" + txt
                if i % 2 == 0:
                    out += f"{self.sep}[INST] {txt} [/INST]"
                else:
                    out += f" {txt} {self.sep2}"
            return out.lstrip(self.sep)

        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = self.system
            for i, (_role, msg) in enumerate(msgs):
                if msg:
                    out += text_of(msg) + seps[i % 2]
            return out

        raise ValueError(f"Invalid style: {style}")

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    @property
    def stop_str(self) -> Optional[str]:
        """The decode stop string: sep, or sep2 for the TWO style."""
        return self.sep if self.sep_style != SeparatorStyle.TWO else self.sep2

    @staticmethod
    def process_image(image, image_process_mode: str):
        """The chat UI's image mode, then the 800/400 downscale rule
        (conversation.py:117-149): Pad squares the image on the CLIP mean
        colour, Resize forces 336x336, Default and Crop pass it through;
        an image whose long edge exceeds the cap its aspect gives is resized."""
        from PIL import Image

        if image_process_mode == "Pad":
            w, h = image.size
            if w != h:
                side = max(w, h)
                bg = Image.new(image.mode, (side, side), (122, 116, 104))
                bg.paste(image, ((side - w) // 2, (side - h) // 2))
                image = bg
        elif image_process_mode == "Resize":
            image = image.resize((336, 336))
        elif image_process_mode not in ("Default", "Crop"):
            raise ValueError(f"Invalid image_process_mode: {image_process_mode}")
        max_hw, min_hw = max(image.size), min(image.size)
        aspect_ratio = max_hw / min_hw
        shortest_edge = int(min(800 / aspect_ratio, 400, min_hw))
        longest_edge = int(shortest_edge * aspect_ratio)
        w, h = image.size
        if longest_edge != max(image.size):
            h, w = (longest_edge, shortest_edge) if h > w else (shortest_edge, longest_edge)
            image = image.resize((w, h))
        return image

    def get_images(self, return_pil: bool = False) -> list:
        """The processed images of the user turns (conversation.py:109-157),
        as PIL images or base64 PNG strings."""
        import base64
        import io

        images = []
        for i, (_role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(msg, tuple):
                _txt, image, mode = (list(msg) + ["Default"])[:3]
                image = self.process_image(image, mode)
                if return_pil:
                    images.append(image)
                else:
                    buf = io.BytesIO()
                    image.save(buf, format="PNG")
                    images.append(base64.b64encode(buf.getvalue()).decode())
        return images

    def copy(self) -> "Conversation":
        return dataclasses.replace(self, messages=[list(m) for m in self.messages])

    def dict(self) -> dict:
        """The state as JSON-ready values, image messages by their text."""
        return {
            "system": self.system,
            "roles": list(self.roles),
            "messages": [[r, m[0] if isinstance(m, tuple) else m] for r, m in self.messages],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


_V0_SEED_Q = "What are the key differences between renewable and non-renewable energy sources?"
_V0_SEED_A = (
    "Renewable energy sources are those that can be replenished naturally in a relatively "
    "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
    "Non-renewable energy sources, on the other hand, are finite and will eventually be "
    "depleted, such as coal, oil, and natural gas. Here are some key differences between "
    "renewable and non-renewable energy sources:\n"
    "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
    "energy sources are finite and will eventually run out.\n"
    "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
    "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
    "and other negative effects.\n"
    "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
    "have lower operational costs than non-renewable sources.\n"
    "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
    "locations than non-renewable sources.\n"
    "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
    "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
    "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
    "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"
)

conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[["Human", _V0_SEED_Q], ["Assistant", _V0_SEED_A]],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
    version="mpt",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v1": conv_llava_v1,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}

default_conversation = conv_vicuna_v1


class KeywordStopper:
    """Multi-token stop-string matching, the reference's
    KeywordsStoppingCriteria (llava/mm_utils.py:76-101). Two checks: a
    token-id suffix match (keywords that are special tokens and vanish when
    decoded) and a decoded-substring match on the tail (keywords whose
    tokenisation depends on context). Stateless: `find_stop(ids, start)`
    scans every end position in (start, len(ids)]."""

    def __init__(self, keywords: Sequence[str], encode_fn, decode_fn,
                 bos_id: Optional[int] = None):
        self.keywords = [k for k in keywords if k]
        self._decode = decode_fn
        self.keyword_ids: List[List[int]] = []
        for kw in self.keywords:
            ids = list(encode_fn(kw))
            # drop the tokenizer's leading BOS (mm_utils.py:82-84)
            if len(ids) > 1 and bos_id is not None and ids[0] == bos_id:
                ids = ids[1:]
            self.keyword_ids.append(ids)
        self.max_len = max((len(i) for i in self.keyword_ids), default=0)

    def find_stop(self, ids: Sequence[int], start: int = 0) -> Optional[int]:
        """The index in `ids` where a stop keyword completing after `start`
        begins; len(ids) if only the decoded-substring check fires (the
        caller trims the text); None if no keyword matched."""
        if not self.keywords:
            return None
        ids = [int(t) for t in ids]
        for e in range(max(start, 0) + 1, len(ids) + 1):
            for kids in self.keyword_ids:
                k = len(kids)
                if k and e >= k and ids[e - k: e] == kids:
                    return e - k
        text = self._decode(ids[max(0, start - self.max_len):])
        if any(kw in text for kw in self.keywords):
            return len(ids)
        return None


def build_prompt(conv_mode: str, question: str, with_image: bool = True) -> str:
    """One-shot prompt for a single question: the user's question (with an
    <image> slot unless `with_image` is False), and an empty assistant turn."""
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], f"<image>\n{question}" if with_image else question)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()
