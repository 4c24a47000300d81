"""Shared building blocks (counterpart of supir_tpu/models/layers.py), NCHW.

Behavioural contracts are the JAX package's: GroupNorm over 32 groups with
fp32 statistics E[x^2] - E[x]^2 clamped at 0, sinusoidal timestep
embeddings with cos before sin, zero-initialised output projections
(`zero_init`, read by the factory's random init). Every module takes
`device` and `dtype` like torch's own layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.ops.groupnorm import group_norm


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[N] -> [N, dim] fp32; cos first, then sin."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm(32) with fp32 statistics, output in the input's dtype.

    eps is 1e-5 by default (UNet) and 1e-6 in the VAE and SpatialTransformer.
    `fuse_silu` applies SiLU in the same pass. On CUDA every site runs K2
    (`ops/groupnorm.py`); on the CPU its plain version.
    """

    def __init__(self, channels: int, eps: float = 1e-5, fuse_silu: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, 32, self.eps, self.fuse_silu)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last dim with fp32 statistics, output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class Conv(nn.Conv2d):
    """kxk conv with explicit symmetric padding of k//2 unless given."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 1,
                 padding: int | None = None, zero_init: bool = False, device=None, dtype=None):
        super().__init__(
            in_channels, out_channels, kernel, stride=stride,
            padding=kernel // 2 if padding is None else padding, device=device, dtype=dtype,
        )
        self.zero_init = zero_init


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 zero_init: bool = False, device=None, dtype=None):
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=dtype)
        self.zero_init = zero_init


class TimestepEmbedMLP(nn.Sequential):
    """Linear -> SiLU -> Linear (time_embed / label_emb head): keys .0 and .2."""

    def __init__(self, in_features: int, features: int, device=None, dtype=None):
        super().__init__(
            Dense(in_features, features, device=device, dtype=dtype),
            nn.SiLU(),
            Dense(features, features, device=device, dtype=dtype),
        )


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
