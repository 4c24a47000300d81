"""Colour correction of the restored output against the stage-1 image
(counterpart of supir_tpu/utils/colorfix.py), on NCHW float tensors.

wavelet: a 5-level pyramid of dilated 3x3 binomial blurs; keep the sample's
high frequencies and the stage-1 image's low frequencies. The blur is a
depthwise conv2d with replicate padding, the reference's own form (the JAX
package's separable shift-and-add existed to dodge TPU lane padding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_KERNEL = (
    (0.0625, 0.125, 0.0625),
    (0.125, 0.25, 0.125),
    (0.0625, 0.125, 0.0625),
)


def wavelet_blur(image: torch.Tensor, radius: int) -> torch.Tensor:
    c = image.shape[1]
    kernel = torch.tensor(_KERNEL, dtype=image.dtype, device=image.device)
    kernel = kernel[None, None].repeat(c, 1, 1, 1)
    padded = F.pad(image, (radius, radius, radius, radius), mode="replicate")
    return F.conv2d(padded, kernel, groups=c, dilation=radius)


def wavelet_decomposition(image: torch.Tensor, levels: int = 5):
    """Returns (high_freq, low_freq) of a dilated-blur pyramid."""
    high_freq = torch.zeros_like(image)
    for i in range(levels):
        low_freq = wavelet_blur(image, 2**i)
        high_freq = high_freq + (image - low_freq)
        image = low_freq
    return high_freq, low_freq


def wavelet_reconstruction(content: torch.Tensor, style: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """content keeps its high frequencies; the low frequencies come from style."""
    content_high, _ = wavelet_decomposition(content, levels)
    _, style_low = wavelet_decomposition(style, levels)
    return content_high + style_low


def _mean_std(feat: torch.Tensor, eps: float = 1e-5):
    # per (N, C) statistics; unbiased variance, as torch.var's default
    n, c = feat.shape[:2]
    flat = feat.reshape(n, c, -1)
    return flat.mean(-1)[:, :, None, None], (flat.var(-1) + eps).sqrt()[:, :, None, None]


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Match content's per-channel mean and std to style's."""
    style_mean, style_std = _mean_std(style)
    content_mean, content_std = _mean_std(content)
    return (content - content_mean) / content_std * style_std + style_mean
