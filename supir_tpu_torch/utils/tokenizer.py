"""CLIP tokenization on the host (counterpart of supir_tpu/utils/tokenizer.py).

Both SDXL towers use the CLIP BPE vocabulary (49408 tokens, <|startoftext|>
49406, <|endoftext|> 49407, context 77). HF's CLIPTokenizer is used where
its vocabulary files are on the local disk (nothing is downloaded); without
them a deterministic hash of each word stands in, so the pipeline runs
offline and in tests. The fallback carries no meaning: a real deployment
provides the tokenizer files, as the reference needs its CLIP checkpoints.
Both fallbacks give the JAX package's ids.
"""

from __future__ import annotations

import functools
import hashlib
import re
from typing import List

import numpy as np

BOS = 49406
EOS = 49407
VOCAB = 49408
CONTEXT = 77


@functools.lru_cache(maxsize=1)
def _hf_tokenizer():
    """HF's CLIP-L tokenizer from local files only, else None."""
    try:
        from transformers import CLIPTokenizer, CLIPTokenizerFast
    except Exception:
        return None
    for cls in (CLIPTokenizerFast, CLIPTokenizer):
        try:
            return cls.from_pretrained("openai/clip-vit-large-patch14", local_files_only=True)
        except Exception:
            continue
    return None


def _hash_tokenize(text: str) -> List[int]:
    """The fallback: one pseudo-token per word or punctuation mark, stable
    across runs and kept below the special ids."""
    words = re.findall(r"\w+|[^\w\s]", text.lower())
    return [int(hashlib.sha1(w.encode()).hexdigest(), 16) % (VOCAB - 1000) for w in words]


def tokenize(texts: List[str], max_length: int = CONTEXT) -> np.ndarray:
    """Strings -> [B, max_length] int32: BOS, the text cut to fit, EOS, then
    EOS as padding, the convention of both reference towers (argmax(ids)
    finds the pooled position)."""
    tok = _hf_tokenizer()
    if tok is not None:
        ids = tok(texts, truncation=True, max_length=max_length, padding="max_length",
                  return_tensors="np")["input_ids"].astype(np.int32)
        if tok.pad_token_id is not None and tok.pad_token_id != EOS:
            ids[ids == tok.pad_token_id] = EOS
        return ids
    out = np.full((len(texts), max_length), EOS, np.int32)
    for i, t in enumerate(texts):
        body = _hash_tokenize(t)[: max_length - 2]
        out[i, 0] = BOS
        out[i, 1: 1 + len(body)] = body
    return out


def tokenizer_available() -> bool:
    return _hf_tokenizer() is not None
