"""Classifier-free guidance (counterpart of supir_tpu/diffusion/guidance.py):
the batch is doubled (uncond | cond) before the network call and combined
after; the scale schedule is a per-step table computed in numpy."""

from __future__ import annotations

import torch

from supir_tpu_torch.diffusion.discretization import SIGMA_MAX_LEGACY


def linear_cfg_scale(sigma, scale: float, scale_min: float | None = None):
    """Linear-in-sigma CFG scale (reference LinearCFG):
    scale(sigma) = (scale - scale_min) * sigma / 14.6146 + scale_min."""
    if scale_min is None:
        scale_min = scale
    return (scale - scale_min) * sigma / SIGMA_MAX_LEGACY + scale_min


def cfg_combine(denoised_uc: torch.Tensor, denoised_c: torch.Tensor, scale) -> torch.Tensor:
    """uncond + scale * (cond - uncond); scale is a float or one per batch row."""
    scale = torch.as_tensor(scale, dtype=denoised_c.dtype, device=denoised_c.device)
    scale = scale.reshape((-1,) + (1,) * (denoised_c.dim() - 1))
    return denoised_uc + scale * (denoised_c - denoised_uc)
