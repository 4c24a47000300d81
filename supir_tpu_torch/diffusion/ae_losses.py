"""Autoencoder training losses (counterpart of
supir_tpu/diffusion/ae_losses.py; reference sgm/modules/autoencoding/):
reconstruction, the KL regularizer, the perceptual term and the patch-GAN
discriminator, GeneralLPIPSWithDiscriminator's (losses/__init__.py:87) and
DiagonalGaussianRegularizer's (:23) terms.

The discriminator is NCHW; its keys are the JAX module's names
(`conv0`, `conv{i}`, `norm{i}`, `conv_out`). Its norm is Flax's
`GroupNorm(num_groups=None, group_size=1)` (`ChannelNorm`): one group per
channel, with Flax's epsilon of 1e-6 (torch's GroupNorm defaults to 1e-5)
and Flax's one-pass variance. No site here reaches a kernel: the JAX
discriminator has no Pallas call, and every discriminator forward of the
trainer is differentiated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ChannelNorm(nn.Module):
    """Flax's GroupNorm(num_groups=None, group_size=1) on NCHW: each
    channel of each sample normalised over H and W, with fp32 statistics
    and Flax's one-pass variance max(E[x^2] - E[x]^2, 0) (its
    use_fast_variance default; torch's GroupNorm takes the two-pass one,
    which differs where a channel's mean dwarfs its spread), then
    (x - mean) * (rsqrt(var + eps) * weight) + bias, in x's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(channels, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf * xf).mean(dim=(2, 3), keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()[:, None, None]
        return ((xf - mean) * mul + self.bias.float()[:, None, None]).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator (reference lpips/model/model.py:88): 4x4
    convolutions with padding 1 at strides 2, 2, 2, 1, 1, LeakyReLU 0.2,
    and a ChannelNorm after every convolution but the first and the
    last. [B, 3, H, W] -> logits [B, 1, h, w]."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_channels: int = 3, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1, **kw)
        nf_prev = ndf
        for i in range(1, n_layers + 1):
            nf = min(ndf * 2**i, ndf * 8)
            stride = 2 if i < n_layers else 1
            self.add_module(f"conv{i}", nn.Conv2d(nf_prev, nf, 4, stride=stride, padding=1, bias=False, **kw))
            self.add_module(f"norm{i}", ChannelNorm(nf, **kw))
            nf_prev = nf
        self.conv_out = nn.Conv2d(nf_prev, 1, 4, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = F.leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h)), 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    return -logits_fake.mean()


def kl_regularizer(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """DiagonalGaussianRegularizer: the batch mean of each sample's KL to
    N(0, I), summed over its latent."""
    kl = 0.5 * (mean**2 + torch.exp(logvar) - 1.0 - logvar).sum(dim=(1, 2, 3))
    return kl.mean()


@dataclasses.dataclass
class AELossConfig:
    kl_weight: float = 1e-6
    disc_weight: float = 0.5
    disc_start: int = 50001
    perceptual_weight: float = 1.0


def disc_factor(step: int, cfg: AELossConfig) -> float:
    """1.0 from `cfg.disc_start` on, else 0.0 (the reference's adopt_weight)."""
    return 1.0 if step >= cfg.disc_start else 0.0


def generator_loss(recon, target, mean, logvar, disc_logits_fake, step: int, cfg: AELossConfig,
                   perceptual: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 reconstruction (+ perceptual) + kl_weight * KL + disc_weight * g,
    the adversarial term gated by disc_start; -> (total, {rec, kl, g})."""
    rec = (recon - target).abs().mean()
    if perceptual is not None:
        rec = rec + cfg.perceptual_weight * perceptual.mean()
    kl = kl_regularizer(mean, logvar)
    g = vanilla_g_loss(disc_logits_fake)
    total = rec + cfg.kl_weight * kl + cfg.disc_weight * disc_factor(step, cfg) * g
    return total, {"rec": rec, "kl": kl, "g": g}


def discriminator_loss(logits_real, logits_fake, step: int, cfg: AELossConfig) -> torch.Tensor:
    """The hinge loss, gated by disc_start."""
    return disc_factor(step, cfg) * hinge_d_loss(logits_real, logits_fake)
