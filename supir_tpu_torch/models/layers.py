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

from supir_tpu_torch.ops.grad_guard import needs_grad
from supir_tpu_torch.ops.groupnorm import GivenStats, TilePooled, group_norm, group_norm_plain, group_norm_pooled


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
    `fuse_silu` applies SiLU in the same pass.

    Routing: where something is differentiated (grad mode on, and x or the
    affine parameters require grad) the site takes `group_norm_plain`, which
    autograd differentiates; the JAX trainer differentiates XLA's GroupNorm
    there, since its Pallas kernel is opt-in and has no VJP
    (`supir_tpu/ops/groupnorm.py:32`). Every other site calls `group_norm`:
    K2 on CUDA, the plain version on the CPU. That includes the frozen UNet
    encoder during training. `GroupNorm32.plain_sites` counts the calls
    routed to the plain form.

    `norm` takes the statistics from elsewhere (the tiled VAE): a
    `TilePooled` pools them over the tiles of each image of a tile-major
    batch, a `GivenStats` supplies them. Such a call never reaches K2,
    which takes each slab's own statistics; it runs `group_norm_pooled`,
    plain torch (differentiable), and counts in `GroupNorm32.pooled_sites`.
    """

    plain_sites = 0
    pooled_sites = 0

    def __init__(self, channels: int, eps: float = 1e-5, fuse_silu: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor, norm: TilePooled | GivenStats | None = None) -> torch.Tensor:
        if norm is not None:
            GroupNorm32.pooled_sites += 1
            return group_norm_pooled(x, self.weight, self.bias, 32, self.eps, self.fuse_silu, norm)
        if needs_grad(x, self.weight, self.bias):
            GroupNorm32.plain_sites += 1
            return group_norm_plain(x, self.weight, self.bias, 32, self.eps, self.fuse_silu)
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


class Holder(nn.Module):
    """One named level of a reference key tree (HF's
    `vision_tower.vision_tower`, SDXL's `embedders.0.transformer`)."""

    def __init__(self, **children):
        super().__init__()
        for name, module in children.items():
            setattr(self, name, module)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm on a checkpoint's running statistics (the face
    models' `ConvBN`, `_bn`: supir_tpu/models/retinaface.py:69-74,
    parsenet.py:36-42): x * a + (bias - mean * a) with a = weight *
    rsqrt(var + 1e-5) in fp32, cast to x's dtype. It holds torch's
    BatchNorm2d keys (weight, bias, running_mean, running_var) without
    num_batches_tracked, which no inference reads."""

    def __init__(self, channels: int, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(channels, device=device, dtype=dtype))
        self.register_buffer("running_var", torch.ones(channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.float() * torch.rsqrt(self.running_var.float() + 1e-5)
        shift = self.bias.float() - self.running_mean.float() * a
        return x * a.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


@torch.no_grad()
def init_conv_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights for the plain-conv networks (the face models, LPIPS):
    each nn.Conv2d's weight from N(0, 1 / fan_in) (flax's lecun_normal
    variance), biases zero, FrozenBatchNorm left at identity; drawn
    from one generator on the model's device, seeded."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Conv2d):
            module.weight.normal_(0.0, module.weight[0].numel() ** -0.5, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
    return model
