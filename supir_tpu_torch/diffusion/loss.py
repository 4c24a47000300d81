"""Diffusion training loss (counterpart of supir_tpu/diffusion/loss.py;
reference StandardDiffusionLoss):

    loss = mean_b mean(w(sigma) * (D(x + noise * sigma, sigma) - x)^2)

with sigma from the sampler. `sigma` and `noise` may be given instead of
drawn, which is how parity tests supply the JAX side's draws (the engine's
`noise_override` does the same for sampling).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from supir_tpu_torch.diffusion.scaling import WEIGHTINGS
from supir_tpu_torch.diffusion.sigma_sampling import discrete_sampling, edm_sampling


def diffusion_loss(
    denoise_fn: Callable[..., torch.Tensor],
    x: torch.Tensor,
    cond: Any,
    generator: Optional[torch.Generator] = None,
    weighting: str = "eps",
    sigma_sampler: str = "discrete",
    loss_type: str = "l2",
    sigma: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """denoise_fn(noised, sigma [B], cond) -> denoised, all shaped like x.
    Returns the scalar loss (fp32). The generator draws sigma first, then
    the noise; either may be given instead."""
    b = x.shape[0]
    if sigma is None:
        if sigma_sampler == "discrete":
            sigma, _ = discrete_sampling(generator, b, device=x.device)
        elif sigma_sampler == "edm":
            sigma = edm_sampling(generator, b, device=x.device)
        else:
            raise ValueError(f"unknown sigma sampler {sigma_sampler!r}")
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    sigma = sigma.to(device=x.device, dtype=torch.float32)
    sig = sigma.reshape((b,) + (1,) * (x.dim() - 1))
    noised = x + noise.to(x) * sig
    denoised = denoise_fn(noised, sigma, cond)
    w = WEIGHTINGS[weighting](sig)
    dims = tuple(range(1, x.dim()))
    if loss_type == "l2":
        per = torch.mean(w * (denoised - x) ** 2, dim=dims)
    elif loss_type == "l1":
        per = torch.mean(w * torch.abs(denoised - x), dim=dims)
    else:
        raise ValueError(loss_type)
    return per.mean()
