"""Attention dispatch: one entry point for every attention site.

Counterpart of `supir_tpu/ops/attention.py:dot_product_attention`, with the
routing of its auto mode (:107-113): self- or cross-attention where both
sequences hold at least `FLASH_MIN_SEQ` tokens and the head dim is 64 or 128
goes to flash attention, causal or not; everything else - cross-attention
to the 77 text tokens, the VAE mid-block's single 512-wide head, a call with
a bias, a causal call whose queries and keys differ in number - uses the
plain fp32-softmax form, which autograd differentiates. Shapes are
[B, S, H, D]. The kernels take bf16: on the card a flash site of another
dtype (an engine with fp32 parameters) raises, where the JAX package runs
its kernel in fp32; K1 has no fp32 instance yet (ROADMAP.md, Queue 2).

Under autograd, a flash site whose q, k or v requires grad (grad mode on)
goes to `FlashAttention` (K3 forward, K4 backward), as JAX differentiates
`flash_attention` through its `custom_vjp`
(`supir_tpu/ops/flash_attention.py:263-267, 305-325`); every other flash
site, where nothing is differentiated, goes to K1 (`flash_attention`).

`alibi_slopes` [H] adds MPT's ALiBi column bias (:79-125): a flash site
takes it into the kernel (K3 ALiBi through `flash_attention`, or
`FlashAttention` under grad); every other site takes the plain route,
which adds the materialised [1, H, 1, T] bias to the logits.
"""

from __future__ import annotations

import torch

from supir_tpu_torch.ops.flash_attention import HEAD_DIMS, FlashAttention, attention_plain, flash_attention
from supir_tpu_torch.ops.grad_guard import needs_grad

FLASH_MIN_SEQ = 1024


def flash_eligible(s: int, t: int, d: int) -> bool:
    return s >= FLASH_MIN_SEQ and t >= FLASH_MIN_SEQ and d in HEAD_DIMS


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              bias: torch.Tensor | None = None, alibi_slopes=None) -> torch.Tensor:
    """[B, S, H, D] x [B, T, H, D] -> [B, S, H, D]. `causal` aligns the last
    query with the last key (attention_plain); `bias` is added to the logits,
    and so is the ALiBi column bias of `alibi_slopes`."""
    s, t = q.shape[1], k.shape[1]
    if bias is None and flash_eligible(s, t, q.shape[-1]) and (not causal or s == t):
        if needs_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, alibi_slopes)
        if q.is_cuda and q.dtype != torch.bfloat16:
            raise TypeError(f"a flash attention site on the card takes bf16, got {q.dtype} (an engine with "
                            "fp32 parameters: --full_params, --diff_dtype fp32); K1 has no fp32 instance "
                            "yet (ROADMAP.md, Queue 2: K1 in fp32)")
        return flash_attention(q, k, v, causal, alibi_slopes)
    return attention_plain(q, k, v, causal=causal, bias=bias, alibi_slopes=alibi_slopes)
