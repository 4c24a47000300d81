"""Sigma-quantising denoiser (counterpart of supir_tpu/diffusion/denoiser.py;
reference DiscreteDenoiserWithControl): continuous sigma snaps to the
nearest entry of the 1000-step DDPM table, whose index is the network's
timestep, and eps scaling wraps the network:

    D(x, sigma) = net(x * c_in, t_idx, cond, control_scale) * c_out + x * c_skip
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from supir_tpu_torch.diffusion.discretization import legacy_ddpm_sigma_table
from supir_tpu_torch.diffusion.scaling import eps_scaling


class DiscreteDenoiser:
    def __init__(self, num_idx: int = 1000):
        # ascending: sigma_table[i] is the sigma of DDPM timestep i
        self.sigma_table = legacy_ddpm_sigma_table(num_idx)

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        table = torch.as_tensor(self.sigma_table, device=sigma.device)
        return torch.argmin((sigma[:, None] - table[None]).abs(), dim=-1)

    def __call__(self, network: Callable[..., torch.Tensor], x: torch.Tensor,
                 sigma: torch.Tensor, cond: Any, control_scale: float = 1.0) -> torch.Tensor:
        """x: [B, C, H, W] fp32 noisy latent; sigma: [B]."""
        sigma = sigma.float()
        idx = self.sigma_to_idx(sigma)
        sigma_q = torch.as_tensor(self.sigma_table, device=x.device)[idx]
        c_skip, c_out, c_in, _ = eps_scaling(sigma_q.reshape(-1, 1, 1, 1))
        out = network(x * c_in, idx.float(), cond, control_scale)
        return out.float() * c_out + x * c_skip
