"""Denoiser preconditioning (counterpart of supir_tpu/diffusion/scaling.py).
SUPIR uses eps scaling: D(x, sigma) = net(x * c_in, t) * c_out + x * c_skip."""

from __future__ import annotations

import torch


def eps_scaling(sigma: torch.Tensor):
    """(c_skip, c_out, c_in, c_noise) for eps prediction."""
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise
