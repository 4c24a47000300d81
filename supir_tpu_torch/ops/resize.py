"""Bilinear resize with the semantics of `jax.image.resize` (counterpart of
supir_tpu/ops/resize.py:bilinear_resize), NCHW.

Each spatial axis is a matrix product with a weight matrix built as
jax.image's `compute_weight_mat` builds it: output pixel o samples the
input at (o + 0.5) / scale - 0.5 (half-pixel centres), with the triangle
kernel, widened by 1 / scale when `antialias` downsamples; each output's
weights are divided by their sum, so a sample near the edge renormalises
over the input pixels that exist. The formula is written out here, not
left to `F.interpolate`, whose edge handling is its own implementation's.

`nearest_resize` is jax.image's "nearest" (half-pixel centres), and
`gaussian_blur` the JAX package's separable reflect-101 blur (NHWC), for
the face paste-back and ParseNet's mask.
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


def nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    """x [N, C, H, W] -> [N, C, size[0], size[1]] by `jax.image.resize(...,
    "nearest")` (supir_tpu/ops/resize.py:nearest_resize; RetinaFace's FPN,
    supir_tpu/models/retinaface.py:177, :179): output pixel o takes input
    pixel floor((o + 0.5) * in / out), the product and quotient in fp32 as
    jax.image takes them. `F.interpolate(mode="nearest")` takes floor(o *
    in / out), another row wherever out is not a multiple of in."""
    for dim, out in ((2, size[0]), (3, size[1])):
        n_in = x.shape[dim]
        if out != n_in:
            offsets = torch.floor((torch.arange(out, dtype=torch.float32, device=x.device) + 0.5)
                                  * n_in / out).long()
            x = x.index_select(dim, offsets)
    return x


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of x [N, H, W, C] (supir_tpu/ops/resize.py:38,
    cv2.GaussianBlur semantics: odd ksize, reflect-101 border): rows first,
    then columns, each a depthwise convolution on NCHW over a reflect-padded
    copy, in fp32 taps normalised to sum 1."""
    if ksize % 2 != 1:
        raise ValueError("kernel size must be odd")
    half = ksize // 2
    t = torch.arange(-half, half + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = (k / k.sum()).to(x.dtype)
    c = x.shape[-1]
    y = x.permute(0, 3, 1, 2)
    y = torch.nn.functional.pad(y, (0, 0, half, half), mode="reflect")
    y = torch.nn.functional.conv2d(y, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    y = torch.nn.functional.pad(y, (half, half, 0, 0), mode="reflect")
    y = torch.nn.functional.conv2d(y, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    return y.permute(0, 2, 3, 1).contiguous()
