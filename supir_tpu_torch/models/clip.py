"""CLIP transformers (counterpart of supir_tpu/models/clip.py): the blocks
and the SDXL text towers.

`CLIPBlock` is pre-LN self-attention plus an MLP, with quick-GELU (CLIP
ViT-L) or exact-erf GELU (OpenCLIP bigG). Attention is the plain
fp32-softmax form, as the JAX package passes impl="xla" (:74). Module and
parameter names are HF's CLIP encoder layer (`self_attn.{q,k,v,out}_proj`,
`layer_norm1/2`, `mlp.fc1/fc2`), so a reference checkpoint's keys load as
they are; the captioner's vision tower and the CLIP-L text tower use it.

`CLIPTextModel` (:98-147 there) is one tower in one of two key layouts, so
that either reference checkpoint loads strictly:

  "hf"        CLIP ViT-L (FrozenCLIPEmbedder): `embeddings.token_embedding`,
              `embeddings.position_embedding`, `encoder.layers.i` (CLIPBlock),
              `final_layer_norm`
  "openclip"  OpenCLIP ViT-bigG (FrozenOpenCLIPEmbedder2): `token_embedding`,
              a bare `positional_embedding` [77, w], `text_projection`
              [w, proj], `transformer.resblocks.i` (`attn.in_proj_weight`
              [3w, w] and `in_proj_bias` packing q, k, v; `attn.out_proj`,
              `ln_1`, `ln_2`, `mlp.c_fc`, `mlp.c_proj`), `ln_final`

Both compute the same function: token plus position embeddings, pre-LN
blocks under the causal -inf bias, all hidden states kept.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.config import CLIPTextConfig
from supir_tpu_torch.models.layers import FusedLayerNorm
from supir_tpu_torch.ops.attention import attention_plain


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


class OpenCLIPAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters: q, k and v packed in
    `in_proj_weight` [3w, w] and `in_proj_bias` [3w]."""

    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        self.heads = cfg.heads
        w = cfg.width
        self.in_proj_weight = nn.Parameter(torch.empty(3 * w, w, device=device, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * w, device=device, dtype=dtype))
        self.out_proj = nn.Linear(w, w, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, c = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).reshape(b, s, 3, self.heads, -1).unbind(2)
        return self.out_proj(attention_plain(q, k, v, bias=mask_bias).reshape(b, s, c))


class OpenCLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        self.quick = cfg.use_quick_gelu
        self.c_fc = nn.Linear(cfg.width, 4 * cfg.width, device=device, dtype=dtype)
        self.c_proj = nn.Linear(4 * cfg.width, cfg.width, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.c_fc(x)
        return self.c_proj(quick_gelu(h) if self.quick else F.gelu(h))


class OpenCLIPBlock(nn.Module):
    """CLIPBlock under OpenCLIP's names (`ln_1`, `attn`, `ln_2`, `mlp`)."""

    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = FusedLayerNorm(cfg.width, eps=1e-5, **kw)
        self.attn = OpenCLIPAttention(cfg, **kw)
        self.ln_2 = FusedLayerNorm(cfg.width, eps=1e-5, **kw)
        self.mlp = OpenCLIPMLP(cfg, **kw)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask_bias)
        return x + self.mlp(self.ln_2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width, device=device, dtype=dtype)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.width, device=device, dtype=dtype)


class _Layers(nn.Module):
    def __init__(self, blocks: List[nn.Module], name: str):
        super().__init__()
        setattr(self, name, nn.ModuleList(blocks))


class CLIPTextModel(nn.Module):
    """A CLIP text tower. forward(input_ids [B, S]) -> dict:

      hidden: layers + 1 states [B, S, width] (hidden[0] the embeddings)
      final:  ln_final(hidden[-1])
      pooled: final at argmax(ids) (the end-of-text token, the highest id)
              @ text_projection, where projection_dim is set

    in the parameters' dtype. `layout` picks the key names (module
    docstring); OpenCLIP's needs `projection_dim`."""

    def __init__(self, cfg: CLIPTextConfig, layout: str = "hf", device=None, dtype=None):
        super().__init__()
        if layout not in ("hf", "openclip"):
            raise ValueError(f"unknown CLIP text layout {layout!r}")
        self.cfg, self.layout = cfg, layout
        kw = dict(device=device, dtype=dtype)
        if layout == "hf":
            if cfg.projection_dim is not None:
                raise ValueError("the HF CLIP-L layout holds no text_projection")
            self.embeddings = _Embeddings(cfg, **kw)
            self.encoder = _Layers([CLIPBlock(cfg, **kw) for _ in range(cfg.layers)], "layers")
            self.final_layer_norm = FusedLayerNorm(cfg.width, eps=1e-5, **kw)
        else:
            self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width, **kw)
            self.positional_embedding = nn.Parameter(torch.empty(cfg.max_length, cfg.width, **kw))
            self.transformer = _Layers([OpenCLIPBlock(cfg, **kw) for _ in range(cfg.layers)], "resblocks")
            self.ln_final = FusedLayerNorm(cfg.width, eps=1e-5, **kw)
            self.text_projection = nn.Parameter(torch.empty(cfg.width, cfg.projection_dim, **kw))

    def _parts(self):
        if self.layout == "hf":
            e = self.embeddings
            return (e.token_embedding, e.position_embedding.weight, self.encoder.layers,
                    self.final_layer_norm, None)
        return (self.token_embedding, self.positional_embedding, self.transformer.resblocks, self.ln_final,
                self.text_projection)

    def forward(self, input_ids: torch.Tensor) -> Dict[str, object]:
        tok, pos, blocks, ln_final, proj = self._parts()
        b, s = input_ids.shape
        x = tok(input_ids) + pos[:s]
        mask = torch.full((s, s), float("-inf"), device=x.device).triu(1)[None, None]
        hidden = [x]
        for block in blocks:
            x = block(x, mask)
            hidden.append(x)
        final = ln_final(x)
        out = {"hidden": hidden, "final": final}
        if proj is not None:
            eos = input_ids.argmax(-1)
            out["pooled"] = final[torch.arange(b, device=x.device), eos] @ proj
        return out
