"""The SDXL conditioner: two text towers and the sinusoidal size embedders
(counterpart of supir_tpu/models/embedders.py).

`Conditioner` turns token ids into `crossattn` [B, 77, 768 + 1280], CLIP-L's
hidden layer 11 beside bigG's penultimate one, and `vector` [B, 2816], bigG's
pooled output beside 256-wide sinusoids of the original size, the crop and
the target size (reference GeneralConditionerWithControl and
ConcatTimestepEmbedderND). Its towers sit under the reference's keys,
`embedders.0.transformer.text_model.*` (HF CLIP-L) and `embedders.1.model.*`
(OpenCLIP bigG), so `conditioner.*` of an SDXL checkpoint loads strictly.
Tokenization happens on the host (`utils/tokenizer.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from supir_tpu_torch.config import ConditionerConfig
from supir_tpu_torch.models.clip import CLIPTextModel
from supir_tpu_torch.models.layers import Holder, timestep_embedding

# the order in which `ucg_rates` dropout draws its masks: CLIP-L (0), bigG
# (1), bigG's pooled output (5, the same rate as 1, its own draw), then the
# three size embedders (2-4); as the JAX conditioner folds these indices
# into its key (:76-109)
UCG_DRAW_ORDER = (0, 1, 5, 2, 3, 4)


def concat_timestep_embed(values: torch.Tensor, outdim: int = 256) -> torch.Tensor:
    """[B, N] scalars -> [B, N * outdim] fp32 sinusoidal embedding."""
    b, n = values.shape
    return timestep_embedding(values.reshape(-1), outdim).reshape(b, n * outdim)


class Conditioner(nn.Module):
    """forward(tokens_l [B,77], tokens_bigg [B,77], orig_size [B,2],
    crop [B,2], target_size [B,2]) -> {'crossattn', 'vector'} in the
    parameters' dtype."""

    def __init__(self, cfg: ConditionerConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embedders = nn.ModuleList([
            Holder(transformer=Holder(text_model=CLIPTextModel(cfg.clip_l, "hf", **kw))),
            Holder(model=CLIPTextModel(cfg.clip_bigg, "openclip", **kw)),
        ])

    @property
    def clip_l(self) -> CLIPTextModel:
        return self.embedders[0].transformer.text_model

    @property
    def clip_bigg(self) -> CLIPTextModel:
        return self.embedders[1].model

    def forward(self, tokens_l, tokens_bigg, orig_size, crop, target_size,
                ucg_generator: Optional[torch.Generator] = None,
                ucg_rates: Optional[Sequence[float]] = None) -> Dict[str, torch.Tensor]:
        """ucg_rates: optional classifier-free-guidance dropout rates of the
        embedders (clip_l, clip_bigg, orig, crop, target), applied in
        training as per-sample Bernoulli(1 - rate) multipliers drawn from
        `ucg_generator` in UCG_DRAW_ORDER (reference GeneralConditioner.
        forward, encoders/modules.py:152-163). Inference passes neither."""
        c = self.cfg
        b = tokens_l.shape[0]
        keep = {}
        if ucg_generator is not None and ucg_rates is not None:
            for idx in UCG_DRAW_ORDER:
                rate = ucg_rates[1 if idx == 5 else idx]
                if rate > 0.0:
                    p = torch.full((b,), 1.0 - rate, device=tokens_l.device)
                    keep[idx] = torch.bernoulli(p, generator=ucg_generator)

        def ucg(emb, idx):
            if idx not in keep:
                return emb
            return emb * keep[idx].to(emb.dtype).reshape((b,) + (1,) * (emb.dim() - 1))

        out_l = self.clip_l(tokens_l)
        out_g = self.clip_bigg(tokens_bigg)
        # CLIP-L: a hidden layer (no final LN); bigG: the penultimate one
        crossattn = torch.cat([ucg(out_l["hidden"][c.clip_l_hidden_layer], 0),
                               ucg(out_g["hidden"][-2], 1)], dim=-1)
        dtype = crossattn.dtype
        parts = [ucg(out_g["pooled"], 5)]
        for i, v in enumerate((orig_size, crop, target_size)):
            emb = concat_timestep_embed(torch.as_tensor(v, device=tokens_l.device).float(), c.vector_outdim)
            parts.append(ucg(emb.to(dtype), 2 + i))
        return {"crossattn": crossattn, "vector": torch.cat(parts, dim=-1)}
