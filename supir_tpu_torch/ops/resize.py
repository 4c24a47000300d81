"""Bilinear resize with the semantics of `jax.image.resize` (counterpart of
supir_tpu/ops/resize.py:bilinear_resize), NCHW.

Each spatial axis is a matrix product with a weight matrix built as
jax.image's `compute_weight_mat` builds it: output pixel o samples the
input at (o + 0.5) / scale - 0.5 (half-pixel centres), with the triangle
kernel, widened by 1 / scale when `antialias` downsamples; each output's
weights are divided by their sum, so a sample near the edge renormalises
over the input pixels that exist. The formula is written out here, not
left to `F.interpolate`, whose edge handling is its own implementation's.
"""

from __future__ import annotations

import torch


def _weights(in_size: int, out_size: int, antialias: bool, device=None) -> torch.Tensor:
    """[in_size, out_size] fp32: the weight of input pixel i in output pixel o."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    weights = (1.0 - dist / kernel_scale).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def bilinear_resize(x: torch.Tensor, size, antialias: bool = False) -> torch.Tensor:
    """x [N, C, H, W] -> [N, C, size[0], size[1]] in x's dtype (its
    weights cast to it, as jax.image casts them); an axis whose size does
    not change is left as it is."""
    out_h, out_w = size
    if out_h != x.shape[2]:
        w = _weights(x.shape[2], out_h, antialias, x.device).to(x.dtype)
        x = torch.einsum("nchw,ho->ncow", x, w)
    if out_w != x.shape[3]:
        w = _weights(x.shape[3], out_w, antialias, x.device).to(x.dtype)
        x = torch.einsum("nchw,wo->ncho", x, w)
    return x.contiguous()
