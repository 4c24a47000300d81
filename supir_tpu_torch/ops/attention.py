"""Attention dispatch: one entry point for every attention site.

Counterpart of `supir_tpu/ops/attention.py:dot_product_attention`, with the
routing of its auto mode (:107-113): self- or cross-attention where both
sequences hold at least `FLASH_MIN_SEQ` tokens and the head dim is 64 or 128
goes to flash attention, causal or not; everything else - cross-attention
to the 77 text tokens, the VAE mid-block's single 512-wide head, a call with
a bias, a causal call whose queries and keys differ in number - uses the
plain fp32-softmax form, which autograd differentiates. Shapes are
[B, S, H, D]. A flash site runs in its inputs' dtype, as the JAX package
runs its kernel: q, k and v of mixed dtypes are first promoted to their
common type (as `attention_plain` promotes its weights and v); bf16 goes
to K1, fp32 (an engine with fp32 parameters: `--full_params`,
`--diff_dtype fp32`) to K1 fp32, and fp16 is widened exactly to fp32, runs
on K1 fp32 and is rounded once back to fp16. No site is cast down.

Under autograd, a flash site whose q, k or v requires grad (grad mode on)
goes to `FlashAttention` (K3 forward, K4 backward), as JAX differentiates
`flash_attention` through its `custom_vjp`
(`supir_tpu/ops/flash_attention.py:263-267, 305-325`); every other flash
site, where nothing is differentiated, goes to K1 (`flash_attention`).

`alibi_slopes` [H] adds MPT's ALiBi column bias (:79-125): a flash site
takes it into the kernel (K3 ALiBi through `flash_attention`, or
`FlashAttention` under grad); every other site takes the plain route,
which adds the materialised [1, H, 1, T] bias to the logits.

Inside `sequence_sharding(mesh, axis)` (JAX :29-60, :95-99) a site goes
to `parallel.ring_attention` before any other route when it is
self-attention (as many keys as queries) with no bias and no ALiBi, not
causal, and S is at least `min_seq` and divides by the axis's size.
"""

from __future__ import annotations

import contextlib
import os

import torch

from supir_tpu_torch.ops.flash_attention import HEAD_DIMS, FlashAttention, attention_plain, flash_attention
from supir_tpu_torch.ops.grad_guard import needs_grad

FLASH_MIN_SEQ = 1024

# the active sequence-sharding context: (mesh, axis, min_seq), or None
_SEQ_SHARD: list = [None]


@contextlib.contextmanager
def sequence_sharding(mesh, axis: str = "seq", min_seq: int | None = None):
    """Route eligible attention sites through the ring while active.
    min_seq defaults to SUPIR_RING_MIN_SEQ or 8192: below it one card's
    flash kernel holds the sequence, and the ring's exchanges do not pay."""
    if min_seq is None:
        min_seq = int(os.environ.get("SUPIR_RING_MIN_SEQ", "8192"))
    prev = _SEQ_SHARD[0]
    _SEQ_SHARD[0] = (mesh, axis, min_seq)
    try:
        yield
    finally:
        _SEQ_SHARD[0] = prev


def _ring_eligible(q, k, bias, causal):
    """(mesh, axis) where the active context takes this site, else None."""
    from supir_tpu_torch.parallel.mesh import axis_size

    ctx = _SEQ_SHARD[0]
    if ctx is None or bias is not None or causal:
        return None
    mesh, axis, min_seq = ctx
    s = q.shape[1]
    if s != k.shape[1] or s < min_seq or s % axis_size(mesh, axis):
        return None
    return mesh, axis


def flash_eligible(s: int, t: int, d: int) -> bool:
    return s >= FLASH_MIN_SEQ and t >= FLASH_MIN_SEQ and d in HEAD_DIMS


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
              bias: torch.Tensor | None = None, alibi_slopes=None) -> torch.Tensor:
    """[B, S, H, D] x [B, T, H, D] -> [B, S, H, D]. `causal` aligns the last
    query with the last key (attention_plain); `bias` is added to the logits,
    and so is the ALiBi column bias of `alibi_slopes`."""
    ring = _ring_eligible(q, k, bias, causal) if alibi_slopes is None else None
    if ring is not None:
        from supir_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, ring[0], axis=ring[1])
    s, t = q.shape[1], k.shape[1]
    if bias is None and flash_eligible(s, t, q.shape[-1]) and (not causal or s == t):
        if needs_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, alibi_slopes)
        dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        if dtype == torch.float16:
            return flash_attention(q.float(), k.float(), v.float(), causal, alibi_slopes).to(dtype)
        return flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), causal, alibi_slopes)
    return attention_plain(q, k, v, causal=causal, bias=bias, alibi_slopes=alibi_slopes)
