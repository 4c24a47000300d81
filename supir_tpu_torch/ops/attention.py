"""Attention dispatch: one entry point for every attention site.

Counterpart of `supir_tpu/ops/attention.py:dot_product_attention`, with the
routing of its auto mode (:107-113): self- or cross-attention where both
sequences hold at least `FLASH_MIN_SEQ` tokens and the head dim is 64 or 128
goes to K1 (`ops/flash_attention.py`); everything else - cross-attention to
the 77 text tokens, the VAE mid-block's single 512-wide head - uses the
plain fp32-softmax form. Shapes are [B, S, H, D].
"""

from __future__ import annotations

import torch

from supir_tpu_torch.ops.flash_attention import HEAD_DIMS, attention_plain, flash_attention

FLASH_MIN_SEQ = 1024


def flash_eligible(s: int, t: int, d: int) -> bool:
    return s >= FLASH_MIN_SEQ and t >= FLASH_MIN_SEQ and d in HEAD_DIMS


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] x [B, T, H, D] -> [B, S, H, D], non-causal, no bias."""
    if flash_eligible(q.shape[1], k.shape[1], q.shape[-1]):
        return flash_attention(q, k, v)
    return attention_plain(q, k, v)
