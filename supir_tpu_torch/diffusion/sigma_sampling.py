"""Training-time sigma samplers (counterpart of
supir_tpu/diffusion/sigma_sampling.py). Every draw comes from the
`torch.Generator` given; it gives other numbers than jax.random, so parity
runs inject the JAX side's sigma into the loss instead."""

from __future__ import annotations

import torch

from supir_tpu_torch.diffusion.discretization import legacy_ddpm_sigma_table


def edm_sampling(generator: torch.Generator, n: int, p_mean: float = -1.2, p_std: float = 1.2,
                 device=None) -> torch.Tensor:
    """Lognormal sigma [n] (the EDM training distribution)."""
    device = generator.device if device is None else device
    return torch.exp(p_mean + p_std * torch.randn(n, generator=generator, device=device))


def discrete_sampling(generator: torch.Generator, n: int, num_idx: int = 1000, idx_low: int = 0,
                      idx_high: int | None = None, device=None):
    """A uniform DDPM timestep index per sample, and its table sigma:
    (sigma [n] fp32, idx [n])."""
    device = generator.device if device is None else device
    hi = num_idx if idx_high is None else idx_high
    idx = torch.randint(idx_low, hi, (n,), generator=generator, device=device)
    table = torch.as_tensor(legacy_ddpm_sigma_table(num_idx), device=device)
    return table[idx], idx
