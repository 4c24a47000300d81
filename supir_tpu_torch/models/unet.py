"""SDXL UNet pieces (counterpart of supir_tpu/models/unet.py), NCHW.

State-dict keys are the reference's (`input_blocks.{i}.{j}`,
`middle_block.{j}`, `time_embed.{0,2}`, `label_emb.0.{0,2}`). The JAX
package nests the time embedding and the encoder under scopes of their own;
here `TimeEmbedding` and `UNetEncoder` are base classes of the models that
own them (GLVControl, LightGLVUNet), so their children sit at the root of the
state dict as the reference's do.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from supir_tpu_torch.config import UNetConfig
from supir_tpu_torch.models.attention import SpatialTransformer
from supir_tpu_torch.models.layers import (
    Conv,
    Dense,
    GroupNorm32,
    TimestepEmbedMLP,
    nearest_upsample_2x,
    timestep_embedding,
)


class ResBlock(nn.Module):
    """GN32+SiLU -> conv; + time-emb projection; GN32+SiLU -> zero conv;
    residual with a 1x1 skip when channels change. The SiLU is fused into
    the norm, so the reference's SiLU/Dropout slots are identities."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.in_layers = nn.Sequential(
            GroupNorm32(in_channels, fuse_silu=True, **kw),
            nn.Identity(),
            Conv(in_channels, out_channels, 3, **kw),
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_channels, out_channels, **kw))
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels, fuse_silu=True, **kw),
            nn.Identity(),
            nn.Identity(),
            Conv(out_channels, out_channels, 3, zero_init=True, **kw),
        )
        self.skip_connection = (
            Conv(in_channels, out_channels, 1, **kw) if in_channels != out_channels else nn.Identity()
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    """3x3 conv, stride 2."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.op = Conv(channels, channels, 3, stride=2, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class OutputHead(nn.Sequential):
    """GN32+SiLU -> zero conv to out_channels: keys .0 and .2."""

    def __init__(self, channels: int, out_channels: int, device=None, dtype=None):
        super().__init__(
            GroupNorm32(channels, fuse_silu=True, device=device, dtype=dtype),
            nn.Identity(),
            Conv(channels, out_channels, 3, zero_init=True, device=device, dtype=dtype),
        )


def encoder_feature_channels(cfg: UNetConfig) -> List[int]:
    """Channel count of each saved encoder feature (input_block_chans)."""
    chans = [cfg.model_channels]
    ch = cfg.model_channels
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            ch = mult * cfg.model_channels
            chans.append(ch)
        if level != cfg.levels - 1:
            chans.append(ch)
    return chans


def _transformer(cfg: UNetConfig, ch: int, depth: int, kw) -> SpatialTransformer:
    return SpatialTransformer(
        ch, ch // cfg.num_head_channels, cfg.num_head_channels, depth, cfg.context_dim, **kw
    )


class TimeEmbedding(nn.Module):
    """Sinusoidal t -> MLP, plus the SDXL ADM vector head (label_emb)."""

    def __init__(self, cfg: UNetConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ted = cfg.model_channels * 4
        self.cfg = cfg
        self.time_embed = TimestepEmbedMLP(cfg.model_channels, ted, **kw)
        if cfg.adm_in_channels is not None:
            self.label_emb = nn.Sequential(TimestepEmbedMLP(cfg.adm_in_channels, ted, **kw))

    def embed_time(self, timesteps: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels).to(dtype))
        if self.cfg.adm_in_channels is not None:
            if y is None:
                raise ValueError("class-conditional model needs y")
            emb = emb + self.label_emb(y.to(dtype))
        return emb


class UNetEncoder(TimeEmbedding):
    """Input blocks + middle block. `encode` returns (hs, h_middle); `hint`
    (GLVControl's guided hint) is added after the first conv."""

    def __init__(self, cfg: UNetConfig, device=None, dtype=None):
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        ted = cfg.model_channels * 4
        blocks = [nn.ModuleList([Conv(cfg.in_channels, cfg.model_channels, 3, **kw)])]
        ch = cfg.model_channels
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                out_ch = mult * cfg.model_channels
                layers = [ResBlock(ch, out_ch, ted, **kw)]
                ch = out_ch
                if ds in cfg.attention_resolutions:
                    layers.append(_transformer(cfg, ch, cfg.transformer_depth[level], kw))
                blocks.append(nn.ModuleList(layers))
            if level != cfg.levels - 1:
                blocks.append(nn.ModuleList([Downsample(ch, **kw)]))
                ds *= 2
        self.input_blocks = nn.ModuleList(blocks)
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, ted, **kw),
            _transformer(cfg, ch, cfg.middle_depth, kw),
            ResBlock(ch, ch, ted, **kw),
        ])

    def encode(self, x: torch.Tensor, emb: torch.Tensor, context: torch.Tensor,
               hint: Optional[torch.Tensor] = None) -> Tuple[List[torch.Tensor], torch.Tensor]:
        h = self.input_blocks[0][0](x)
        if hint is not None:
            h = h + hint
        hs = [h]
        for block in self.input_blocks[1:]:
            h = run_block(block, h, emb, context)
            hs.append(h)
        h = run_block(self.middle_block, h, emb, context)
        return hs, h


def run_block(block: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
              context: torch.Tensor) -> torch.Tensor:
    """Apply a TimestepEmbedSequential-style block: ResBlocks take emb,
    SpatialTransformers take the text context, the rest take h alone."""
    for layer in block:
        if isinstance(layer, ResBlock):
            h = layer(h, emb)
        elif isinstance(layer, SpatialTransformer):
            h = layer(h, context)
        else:
            h = layer(h)
    return h
