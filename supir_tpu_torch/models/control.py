"""SUPIR control path (counterpart of supir_tpu/models/control.py), NCHW:
GLVControl, ZeroSFT, ZeroCrossAttn and LightGLVUNet, with the mode tables
of `supir_tpu.config.ControlConfig`.

State-dict keys are the reference's: `model.control_model.*` for
GLVControl and `model.diffusion_model.*` (with `project_modules.{pos}`) for
LightGLVUNet, relative to those prefixes.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from supir_tpu_torch.config import ControlConfig, UNetConfig
from supir_tpu_torch.models.attention import CrossAttention
from supir_tpu_torch.models.layers import Conv, GroupNorm32
from supir_tpu_torch.models.unet import (
    OutputHead,
    ResBlock,
    UNetEncoder,
    Upsample,
    _transformer,
    encoder_feature_channels,
    run_block,
)


class ZeroSFT(nn.Module):
    """Zero-init SFT modulation of a decoder skip feature.

    forward(c, h, h_ori): c = control feature [label_nc], h = skip feature
    [norm_nc], h_ori = decoder stream [concat_channels] or None."""

    def __init__(self, label_nc: int, norm_nc: int, concat_channels: int = 0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        nhidden = 128
        self.concat_channels = concat_channels
        self.param_free_norm = GroupNorm32(norm_nc + concat_channels, **kw)
        self.mlp_shared = nn.Sequential(Conv(label_nc, nhidden, 3, **kw), nn.SiLU())
        self.zero_mul = Conv(nhidden, norm_nc + concat_channels, 3, zero_init=True, **kw)
        self.zero_add = Conv(nhidden, norm_nc + concat_channels, 3, zero_init=True, **kw)
        self.zero_conv = Conv(label_nc, norm_nc, 1, zero_init=True, **kw)

    def forward(self, c, h, h_ori=None, control_scale: float = 1.0):
        pre_concat = h_ori is not None and self.concat_channels != 0
        h_raw = torch.cat([h_ori, h], dim=1) if pre_concat else h
        h = h + self.zero_conv(c)
        if pre_concat:
            h = torch.cat([h_ori, h], dim=1)
        actv = self.mlp_shared(c)
        gamma = self.zero_mul(actv)
        beta = self.zero_add(actv)
        h = self.param_free_norm(h) * (gamma + 1.0) + beta
        if h_ori is not None and not pre_concat:
            h = torch.cat([h_ori, h], dim=1)
        return h * control_scale + h_raw * (1.0 - control_scale)


class ZeroCrossAttn(nn.Module):
    """Cross-attention injector: x attends to the control feature. The
    reference does not zero-init its output projection."""

    def __init__(self, context_dim: int, query_dim: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn = CrossAttention(query_dim, context_dim, heads=query_dim // 64, dim_head=64, **kw)
        self.norm1 = GroupNorm32(query_dim, **kw)
        self.norm2 = GroupNorm32(context_dim, **kw)

    def forward(self, context, x, control_scale: float = 1.0):
        b, c, h, w = x.shape
        q = self.norm1(x).flatten(2).transpose(1, 2)
        ctx = self.norm2(context).flatten(2).transpose(1, 2)
        out = self.attn(q, ctx).transpose(1, 2).reshape(b, c, h, w).contiguous()
        return x + out * control_scale


class GLVControl(UNetEncoder):
    """Control net: UNet encoder clone + zero hint conv; returns the
    10-feature pyramid (9 input-block features + middle)."""

    def __init__(self, cfg: UNetConfig, input_upscale: int = 1, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        if input_upscale != 1:
            raise NotImplementedError("GLVControl input_upscale != 1 is not ported yet")
        self.input_hint_block = nn.Sequential(
            Conv(cfg.in_channels, cfg.model_channels, 3, zero_init=True, device=device, dtype=dtype)
        )

    def forward(self, x, timesteps, xt, context, y) -> List[torch.Tensor]:
        """x: LQ control latent [B,4,H,W]; xt: noisy latent [B,4,H,W]."""
        dtype = self.input_hint_block[0].weight.dtype
        emb = self.embed_time(timesteps, y)
        hint = self.input_hint_block(x.to(dtype))
        hs, h_mid = self.encode(xt.to(dtype), emb, context.to(dtype), hint=hint)
        return hs + [h_mid]


def _build_adapter_specs(ctrl: ControlConfig) -> List[Tuple[str, int]]:
    """project_modules: one ZeroSFT per control feature, with ZeroCrossAttns
    inserted at the mode table's indices; ('sft'|'xattn', i) with i indexing
    the pre-insert tables."""
    specs = [("sft", i) for i in range(len(ctrl.cond_output_channels))]
    for idx in ctrl.cross_attn_insert_idx:
        specs.insert(idx, ("xattn", idx))
    return specs


class LightGLVUNet(UNetEncoder):
    """SDXL UNet whose decoder consumes the control features.
    forward(x, t, context, y, control, control_scale) -> eps prediction."""

    def __init__(self, cfg: UNetConfig, ctrl: ControlConfig, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        ted = cfg.model_channels * 4
        skips = encoder_feature_channels(cfg)
        blocks = []
        ch = cfg.model_channels * cfg.channel_mult[-1]
        ds = 2 ** (cfg.levels - 1)
        for rlevel, mult in enumerate(reversed(cfg.channel_mult)):
            level = cfg.levels - 1 - rlevel
            out_ch = mult * cfg.model_channels
            for i in range(cfg.num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), out_ch, ted, **kw)]
                ch = out_ch
                if ds in cfg.attention_resolutions:
                    layers.append(_transformer(cfg, ch, cfg.transformer_depth[level], kw))
                if level > 0 and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, **kw))
                    ds //= 2
                blocks.append(nn.ModuleList(layers))
        self.output_blocks = nn.ModuleList(blocks)
        self.out = OutputHead(ch, cfg.out_channels, **kw)
        self.project_modules = nn.ModuleList(
            ZeroSFT(ctrl.project_channels[i], ctrl.cond_output_channels[i],
                    ctrl.concat_channels[i], **kw)
            if kind == "sft" else
            ZeroCrossAttn(ctrl.cond_output_channels[i], ctrl.concat_channels[i], **kw)
            for kind, i in _build_adapter_specs(ctrl)
        )

    def forward(self, x, timesteps, context, y, control: Sequence[torch.Tensor],
                control_scale: float = 1.0) -> torch.Tensor:
        dtype = self.out[2].weight.dtype
        x = x.to(dtype)
        context = context.to(dtype)
        control = [c.to(dtype) for c in control]
        # the reference's no_grad region: time embedding and input blocks are
        # frozen, the middle block, adapters and decoder train
        # (supir_tpu/models/control.py:229, unet.py:158-160)
        emb = self.embed_time(timesteps, y).detach()
        hs, h = self.encode(x, emb, context, detach_inputs=True)

        adapter = len(self.project_modules) - 1
        ctrl_idx = len(control) - 1
        # middle-feature SFT (no decoder stream to concatenate)
        h = self.project_modules[adapter](control[ctrl_idx], h, control_scale=control_scale)
        adapter -= 1
        ctrl_idx -= 1
        for block in self.output_blocks:
            h = self.project_modules[adapter](control[ctrl_idx], hs.pop(), h, control_scale=control_scale)
            adapter -= 1
            if isinstance(block[-1], Upsample):
                h = run_block(block[:-1], h, emb, context, self.remat)
                # ZeroCrossAttn before each Upsample
                h = self.project_modules[adapter](control[ctrl_idx], h, control_scale=control_scale)
                adapter -= 1
                h = block[-1](h)
            else:
                h = run_block(block, h, emb, context, self.remat)
            ctrl_idx -= 1
        if adapter != -1 or ctrl_idx != -1:
            raise RuntimeError(f"adapter/control bookkeeping off: {adapter}, {ctrl_idx}")
        return self.out(h).float()
