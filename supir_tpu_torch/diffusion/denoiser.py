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

    def _precondition(self, x: torch.Tensor, sigma: torch.Tensor):
        """(t, c_out, c_in, c_skip): the nearest table index as the timestep,
        and eps scaling at that entry's sigma."""
        idx = self.sigma_to_idx(sigma.float())
        sigma_q = torch.as_tensor(self.sigma_table, device=x.device)[idx]
        c_skip, c_out, c_in, _ = eps_scaling(sigma_q.reshape(-1, 1, 1, 1))
        return idx.float(), c_out, c_in, c_skip

    def __call__(self, network: Callable[..., torch.Tensor], x: torch.Tensor,
                 sigma: torch.Tensor, cond: Any, control_scale: float = 1.0) -> torch.Tensor:
        """x: [B, C, H, W] fp32 noisy latent; sigma: [B]."""
        t, c_out, c_in, c_skip = self._precondition(x, sigma)
        out = network(x * c_in, t, cond, control_scale)
        return out.float() * c_out + x * c_skip

    def call_cached(self, network_cached: Callable[..., Any], x: torch.Tensor, sigma: torch.Tensor,
                    cond: Any, control_scale, cache: Any, recompute: bool):
        """The same preconditioning around a network that threads the
        cross-step feature cache: `network_cached(x, t, cond, control_scale,
        cache, recompute) -> (eps, cache)` (SUPIREngine._network_cached).
        Returns (denoised, cache)."""
        t, c_out, c_in, c_skip = self._precondition(x, sigma)
        out, cache = network_cached(x * c_in, t, cond, control_scale, cache, recompute)
        return out.float() * c_out + x * c_skip, cache
