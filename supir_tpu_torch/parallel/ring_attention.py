"""Ring attention: self-attention with the sequence split over a mesh axis
(counterpart of supir_tpu/parallel/ring_attention.py).

SUPIR's long context is resolution: a 2048^2 untiled network call holds
16384 tokens at the UNet's first attention level. Every rank holds the
replicated [B, S, H, D] q, k and v and takes its S/n slice of each; the
k/v slices rotate n - 1 times around the ring (`mesh.ring_shift`, JAX's
`ppermute` j -> j + 1), and each rank's queries meet every slice once.
The ranks' outputs are all-gathered back to the replicated [B, S, H, D],
as the JAX function's `shard_map` output is used.

Each block is K3 (`flash_attention_fwd_lse`: K3 for bf16, K3 fp32 for
fp32, on the card; its plain version on the CPU), which returns the
block's output and the logsumexp of its rows. The blocks merge by their lse in fp32: with m = max(lse_acc,
lse_i), a = e^(lse_acc - m) and b = e^(lse_i - m),
o <- (o a + o_i b) / (a + b) and lse_acc <- m + log(a + b). In exact
arithmetic this is the JAX function's (o, m, l) online softmax
(:47-58); it lets the kernel do the block where `_local_attn_stats` would
build a [B, H, S/n, S/n] fp32 logit tensor.

The ring runs in its inputs' dtype, as the JAX function does: mixed
dtypes are promoted, and fp16 is widened exactly to fp32, runs on K3 fp32
and is rounded back once (`ops.attention.kernel_dtypes`); nothing is cast
down. No path of either package differentiates the ring: inputs that
require grad under grad mode raise, as the kernel wrappers' do.
"""

from __future__ import annotations

import torch

from supir_tpu_torch.ops.attention import kernel_dtypes
from supir_tpu_torch.ops.flash_attention import flash_attention_fwd_lse
from supir_tpu_torch.ops.grad_guard import refuse_grad
from supir_tpu_torch.parallel.mesh import all_gather, axis_group, ring_shift


def _merge(o: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor, lse_i: torch.Tensor):
    """Two softmax blocks' outputs o, o_i [B, S, H, D] (o fp32) and their
    lse [B, H, S] fp32 -> the output and lse of their union."""
    m = torch.maximum(lse, lse_i)
    a, b = torch.exp(lse - m), torch.exp(lse_i - m)
    a_, b_ = (w.transpose(1, 2)[..., None] for w in (a, b))  # [B, S, H, 1]
    return (o * a_ + o_i.float() * b_) / (a_ + b_), m + torch.log(a + b)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str = "tile") -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over q, k, v [B, S, H, D], the sequence
    split over `axis` of `mesh`; S must divide by the axis size. Every rank
    of the axis calls it with the same q, k and v; each gets the whole
    [B, S, H, D] result."""
    refuse_grad("ring_attention", q, k, v)
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring_attention is self-attention: q, k, v of one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    group, n, r = axis_group(mesh, axis)
    s = q.shape[1]
    if s % n:
        raise ValueError(f"sequence {s} does not divide over the {n} ranks of axis {axis!r}")
    part = s // n
    dtype, work = kernel_dtypes(q, k, v)
    qc, kc, vc = (x[:, r * part:(r + 1) * part].to(work).contiguous() for x in (q, k, v))
    o, lse = None, None
    for i in range(n):
        o_i, lse_i = flash_attention_fwd_lse(qc, kc, vc)
        o, lse = (o_i.float(), lse_i) if o is None else _merge(o, lse, o_i, lse_i)
        if i + 1 < n:
            kv = ring_shift(torch.stack([kc, vc]), group)
            kc, vc = kv[0], kv[1]
    return all_gather(o.to(dtype), group, dim=1)
