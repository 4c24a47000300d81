"""SDXL UNet (counterpart of supir_tpu/models/unet.py), NCHW.

State-dict keys are the reference's (`input_blocks.{i}.{j}`,
`middle_block.{j}`, `output_blocks.{i}.{j}`, `out.{0,2}`,
`time_embed.{0,2}`, `label_emb.0.{0,2}`). The JAX package nests the time
embedding, the encoder and the plain decoder under scopes of their own;
here `TimeEmbedding`, `UNetEncoder` and `UNetDecoderPlain` are base classes
of the models that own them (GLVControl, LightGLVUNet, the plain
`UNetModel`), so their children sit at the root of the state dict as the
reference's do.

Training: `remat` (off by default) recomputes each ResBlock and
SpatialTransformer in the backward pass, through
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`, as the JAX
modules wrap those two in `nn.remat` (`supir_tpu/models/unet.py:119-120,
198`; `models/control.py:274`); it takes effect only under grad mode. It
also recomputes LightGLVUNet's decoder SpatialTransformers, which the JAX
decoder keeps (its `remat` wraps only the decoder's ResBlocks), so that on
one card no transformer's activations outlive its forward pass.
`encode(..., detach_inputs=True)` is the JAX encoder's `stop_grad_inputs`
(:158-160): the input-block features and the pre-middle state are
detached, so the input blocks get no gradient and the middle block trains.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

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
        self.remat = False
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
               hint: Optional[torch.Tensor] = None,
               detach_inputs: bool = False) -> Tuple[List[torch.Tensor], torch.Tensor]:
        h = self.input_blocks[0][0](x)
        if hint is not None:
            h = h + hint
        hs = [h]
        for block in self.input_blocks[1:]:
            h = run_block(block, h, emb, context, self.remat)
            hs.append(h)
        if detach_inputs:
            hs = [t.detach() for t in hs]
            h = h.detach()
        h = run_block(self.middle_block, h, emb, context, self.remat)
        return hs, h


class UNetDecoderPlain(UNetEncoder):
    """The encoder and the standard SDXL decoder: each output block takes the
    decoder stream with its skip concatenated behind it, a ResBlock (and a
    SpatialTransformer at the attention levels), and an Upsample closing
    every level but the last; then the output head. `decode` runs them."""

    def __init__(self, cfg: UNetConfig, device=None, dtype=None):
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

    def decode(self, h: torch.Tensor, hs: List[torch.Tensor], emb: torch.Tensor,
               context: torch.Tensor) -> torch.Tensor:
        """The decoder stream from the middle block's h and the encoder's
        features hs (left as they are), through the output head."""
        hs = list(hs)
        for block in self.output_blocks:
            h = run_block(block, torch.cat([h, hs.pop()], dim=1), emb, context, self.remat)
        return self.out(h)


class UNetModel(UNetDecoderPlain):
    """The plain SDXL UNet (txt2img): forward(x, t, context, y) -> eps
    prediction, fp32."""

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        dtype = self.out[2].weight.dtype
        context = context.to(dtype)
        emb = self.embed_time(timesteps, y)
        hs, h = self.encode(x.to(dtype), emb, context)
        return self.decode(h, hs, emb, context).float()


def run_block(block: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
              context: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """Apply a TimestepEmbedSequential-style block: ResBlocks take emb,
    SpatialTransformers take the text context, the rest take h alone. With
    `remat` under grad mode, ResBlocks and SpatialTransformers are
    recomputed in the backward pass instead of keeping their activations."""
    remat = remat and torch.is_grad_enabled()
    for layer in block:
        if isinstance(layer, (ResBlock, SpatialTransformer)):
            arg = emb if isinstance(layer, ResBlock) else context
            h = checkpoint(layer, h, arg, use_reentrant=False) if remat else layer(h, arg)
        else:
            h = layer(h)
    return h
