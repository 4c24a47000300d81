"""AutoencoderKL (SD VAE, f8/z4) with SUPIR's `denoise_encoder` branch
(counterpart of supir_tpu/models/vae.py), NCHW. GroupNorm eps is 1e-6, the
VAE convention. State-dict keys are the reference's `first_stage_model.*`
keys relative to that prefix.

Every forward takes `norm`, the GroupNorm statistics' mode for a
tile-major batch of tiles (ops.groupnorm.TilePooled or GivenStats; None:
each sample's own, K2 on the card), the counterpart of `norm_axis` and
`tile_weight` at supir_tpu/models/vae.py:31-113. The blocks' norm and conv
parts, `VAEAttnBlock.attend` and `_Resample` are what the tiled VAE's
staged executor (parallel/tiled_vae.py) runs stage by stage.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.config import VAEConfig
from supir_tpu_torch.models.layers import Conv, GroupNorm32, nearest_upsample_2x
from supir_tpu_torch.ops.attention import attention


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm32(in_channels, eps=1e-6, fuse_silu=True, **kw)
        self.conv1 = Conv(in_channels, out_channels, 3, **kw)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6, fuse_silu=True, **kw)
        self.conv2 = Conv(out_channels, out_channels, 3, **kw)
        self.nin_shortcut = (
            Conv(in_channels, out_channels, 1, **kw) if in_channels != out_channels else nn.Identity()
        )

    def forward(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        h = self.conv1(self.norm1(x, norm))
        h = self.conv2(self.norm2(h, norm))
        return self.nin_shortcut(x) + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention over all H*W positions."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = GroupNorm32(channels, eps=1e-6, **kw)
        self.q = Conv(channels, channels, 1, **kw)
        self.k = Conv(channels, channels, 1, **kw)
        self.v = Conv(channels, channels, 1, **kw)
        self.proj_out = Conv(channels, channels, 1, **kw)

    def forward(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        return self.attend(x, self.norm(x, norm))

    def attend(self, x: torch.Tensor, hid: torch.Tensor) -> torch.Tensor:
        """x plus the attention over the normalised `hid`."""
        b, c, h, w = x.shape

        def tokens(t):  # [B, C, H, W] -> [B, HW, 1, C]
            return t.flatten(2).transpose(1, 2)[:, :, None, :].contiguous()

        out = attention(tokens(self.q(hid)), tokens(self.k(hid)), tokens(self.v(hid)))
        out = out[:, :, 0, :].transpose(1, 2).reshape(b, c, h, w).contiguous()
        return x + self.proj_out(out)


class _Level(nn.Module):
    """One resolution of the encoder (`down.{i}`) or decoder (`up.{i}`)."""

    def __init__(self, blocks, resample: Optional[nn.Module], name: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            self.add_module(name, resample)


class _Resample(nn.Module):
    """Holds the `.conv` of a down- or upsampling step: stride 2 is the
    encoder's asymmetric (0,1,0,1) pad and stride-2 valid conv, stride 1
    the decoder's nearest 2x upsample and conv."""

    def __init__(self, channels: int, stride: int, device=None, dtype=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=stride, padding=0 if stride == 2 else None,
                         device=device, dtype=dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.conv.stride[0] == 2:
            return self.conv(F.pad(h, (0, 1, 0, 1)))
        return self.conv(nearest_upsample_2x(h))


class _Mid(nn.Module):
    def __init__(self, ch: int, kw):
        super().__init__()
        self.block_1 = VAEResnetBlock(ch, ch, **kw)
        self.attn_1 = VAEAttnBlock(ch, **kw)
        self.block_2 = VAEResnetBlock(ch, ch, **kw)

    def forward(self, h: torch.Tensor, norm=None) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h, norm), norm), norm)


class VAEEncoder(nn.Module):
    """conv_in -> levels x (ResnetBlocks [+ downsample]) -> mid (res, attn,
    res) -> GN/SiLU -> conv_out (2*z_channels)."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv_in = Conv(cfg.in_channels, cfg.ch, 3, **kw)
        levels = []
        ch = cfg.ch
        for level, mult in enumerate(cfg.ch_mult):
            out_ch = cfg.ch * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(VAEResnetBlock(ch, out_ch, **kw))
                ch = out_ch
            down = _Resample(ch, 2, **kw) if level != len(cfg.ch_mult) - 1 else None
            levels.append(_Level(blocks, down, "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(ch, kw)
        self.norm_out = GroupNorm32(ch, eps=1e-6, fuse_silu=True, **kw)
        out_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv(ch, out_ch, 3, **kw)

    def forward(self, x: torch.Tensor, norm=None) -> torch.Tensor:
        h = self.conv_in(x.to(self.conv_in.weight.dtype))
        for level in self.down:
            for block in level.block:
                h = block(h, norm)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h, norm)
        return self.conv_out(self.norm_out(h, norm))


class VAEDecoder(nn.Module):
    """conv_in -> mid -> reversed levels x (ResnetBlocks [+ upsample]) ->
    GN/SiLU -> conv_out."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, ch, 3, **kw)
        self.mid = _Mid(ch, kw)
        levels = [None] * len(cfg.ch_mult)
        for level in reversed(range(len(cfg.ch_mult))):
            out_ch = cfg.ch * cfg.ch_mult[level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(VAEResnetBlock(ch, out_ch, **kw))
                ch = out_ch
            up = _Resample(ch, 1, **kw) if level != 0 else None
            levels[level] = _Level(blocks, up, "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(ch, eps=1e-6, fuse_silu=True, **kw)
        self.conv_out = Conv(ch, cfg.out_channels, 3, **kw)

    def forward(self, z: torch.Tensor, norm=None) -> torch.Tensor:
        h = self.mid(self.conv_in(z.to(self.conv_in.weight.dtype)), norm)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, norm)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, norm))


class DiagonalGaussian:
    """Moments [B, 2C, H, W] -> mean/logvar (clipped to [-30, 20])."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise, with the unit-normal noise given."""
        return self.mean + self.std * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """VAE with quant/post_quant 1x1 convs and SUPIR's `denoise_encoder`,
    a second encoder with the same architecture."""

    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.encoder = VAEEncoder(cfg, **kw)
        self.decoder = VAEDecoder(cfg, **kw)
        factor = 2 if cfg.double_z else 1
        self.quant_conv = Conv(factor * cfg.z_channels, factor * cfg.embed_dim, 1, **kw)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1, **kw)
        self.denoise_encoder = VAEEncoder(cfg, **kw)

    def moments(self, x: torch.Tensor, use_denoise_encoder: bool = False) -> torch.Tensor:
        enc = self.denoise_encoder if use_denoise_encoder else self.encoder
        return self.quant_conv(enc(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))
