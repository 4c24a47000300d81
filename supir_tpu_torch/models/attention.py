"""Transformer attention stack for the diffusion UNet (counterpart of
supir_tpu/models/attention.py). Token tensors are [B, N, C]; the
SpatialTransformer takes and returns NCHW.

GEGLU is exact-erf GELU at every dtype, as the reference's sgm GEGLU is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.models.layers import Dense, FusedLayerNorm, GroupNorm32
from supir_tpu_torch.ops.attention import attention


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None. q/k/v
    projections have no bias; the output projection (`to_out.0`) has one."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = Dense(query_dim, inner, bias=False, **kw)
        self.to_k = Dense(context_dim, inner, bias=False, **kw)
        self.to_v = Dense(context_dim, inner, bias=False, **kw)
        self.to_out = nn.Sequential(Dense(inner, query_dim, **kw), nn.Identity())

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, s, _ = x.shape
        t = context.shape[1]
        q = self.to_q(x).view(b, s, self.heads, self.dim_head)
        k = self.to_k(context).view(b, t, self.heads, self.dim_head)
        v = self.to_v(context).view(b, t, self.heads, self.dim_head)
        out = attention(q, k, v).reshape(b, s, self.heads * self.dim_head)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, device=None, dtype=None):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward, mult=4: keys net.0.proj and net.2."""

    def __init__(self, dim: int, mult: int = 4, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.net = nn.Sequential(GEGLU(dim, dim * mult, **kw), nn.Identity(), Dense(dim * mult, dim, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """LayerNorm -> self-attn -> LayerNorm -> cross-attn -> LayerNorm -> FF,
    each with a residual."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn1 = CrossAttention(dim, None, heads, dim_head, **kw)
        self.ff = FeedForward(dim, **kw)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head, **kw)
        self.norm1 = FusedLayerNorm(dim, eps=1e-5, **kw)
        self.norm2 = FusedLayerNorm(dim, eps=1e-5, **kw)
        self.norm3 = FusedLayerNorm(dim, eps=1e-5, **kw)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GN32 -> linear token projection -> depth x transformer blocks ->
    zero-init output projection -> residual. NCHW in and out."""

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        self.norm = GroupNorm32(in_channels, eps=1e-6, **kw)
        self.proj_in = Dense(in_channels, inner, **kw)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, context_dim, **kw) for _ in range(depth)
        )
        self.proj_out = Dense(inner, in_channels, zero_init=True, **kw)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.norm(x).flatten(2).transpose(1, 2)
        t = self.proj_in(t)
        for block in self.transformer_blocks:
            t = block(t, context)
        t = self.proj_out(t)
        return t.transpose(1, 2).reshape(b, c, h, w).contiguous() + x
