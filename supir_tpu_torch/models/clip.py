"""CLIP transformer blocks (counterpart of supir_tpu/models/clip.py:55-95).

`CLIPBlock` is pre-LN self-attention plus an MLP, with quick-GELU (CLIP
ViT-L) or exact-erf GELU (OpenCLIP bigG). Attention is the plain
fp32-softmax form, as the JAX package passes impl="xla" (:74). Module and
parameter names are HF's CLIP encoder layer (`self_attn.{q,k,v,out}_proj`,
`layer_norm1/2`, `mlp.fc1/fc2`), so a reference checkpoint's keys load as
they are. The captioner's vision tower uses these blocks now; the SDXL text
towers will reuse them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.models.layers import FusedLayerNorm
from supir_tpu_torch.ops.attention import attention_plain


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_length: int = 77
    width: int = 768
    layers: int = 12
    heads: int = 12
    use_quick_gelu: bool = True
    projection_dim: Optional[int] = None  # set for OpenCLIP pooled output


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        self.heads = cfg.heads
        w = cfg.width
        kw = dict(device=device, dtype=dtype)
        self.q_proj = nn.Linear(w, w, **kw)
        self.k_proj = nn.Linear(w, w, **kw)
        self.v_proj = nn.Linear(w, w, **kw)
        self.out_proj = nn.Linear(w, w, **kw)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, c = x.shape
        shape = (b, s, self.heads, c // self.heads)
        q = self.q_proj(x).reshape(shape)
        k = self.k_proj(x).reshape(shape)
        v = self.v_proj(x).reshape(shape)
        out = attention_plain(q, k, v, bias=mask_bias)
        return self.out_proj(out.reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        self.quick = cfg.use_quick_gelu
        self.fc1 = nn.Linear(cfg.width, 4 * cfg.width, device=device, dtype=dtype)
        self.fc2 = nn.Linear(4 * cfg.width, cfg.width, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(quick_gelu(h) if self.quick else F.gelu(h))


class CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = FusedLayerNorm(cfg.width, eps=1e-5, **kw)
        self.self_attn = CLIPAttention(cfg, **kw)
        self.layer_norm2 = FusedLayerNorm(cfg.width, eps=1e-5, **kw)
        self.mlp = CLIPMLP(cfg, **kw)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask_bias)
        return x + self.mlp(self.layer_norm2(x))
