"""Denoiser preconditionings and loss weightings (counterpart of
supir_tpu/diffusion/scaling.py). Pure functions of sigma.

A scaling returns (c_skip, c_out, c_in, c_noise); the denoiser computes
`net(x * c_in, c_noise, cond) * c_out + x * c_skip`. SUPIR uses eps scaling
and eps weighting; the trainer's loss takes any of the four weightings.
"""

from __future__ import annotations

import torch


def eps_scaling(sigma: torch.Tensor):
    """(c_skip, c_out, c_in, c_noise) for eps prediction."""
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise


def unit_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(sigma)


def eps_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return sigma**-2.0


def edm_weighting(sigma: torch.Tensor, sigma_data: float = 0.5) -> torch.Tensor:
    return (sigma**2 + sigma_data**2) / (sigma * sigma_data) ** 2


def v_weighting(sigma: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + sigma**2)


WEIGHTINGS = {
    "unit": unit_weighting,
    "eps": eps_weighting,
    "edm": edm_weighting,
    "v": v_weighting,
}
