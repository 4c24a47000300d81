"""Captioner training, started (counterpart of supir_tpu/captioner/train.py):
the causal-LM loss. LoRA and the trainer are not ported yet."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from supir_tpu_torch.captioner.preprocess import IGNORE_INDEX

__all__ = ["IGNORE_INDEX", "causal_lm_loss"]


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy with IGNORE_INDEX masked (train.py:84-94):
    logits [B, S, V] predict labels [B, S] shifted by one; the mean over
    the unmasked targets (0 if there are none). The log-softmax is taken in
    fp32 whatever the logits' dtype."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    mask = targets != IGNORE_INDEX
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(mask, targets, 0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)
