"""RestoreEDM, SUPIR's default sampler (counterpart of
supir_tpu/diffusion/samplers.py:75-193), as a Python loop.

Every per-step scalar (churn, CFG scale, control scale, restoration
weight) is precomputed into numpy `StepTables`, exactly as the JAX package
does. The `denoise` callable is the engine's closure
    denoise(x, sigma[B], cfg_scale[B], control_scale) -> denoised
which doubles the batch for CFG inside.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from supir_tpu_torch.config import SamplerConfig
from supir_tpu_torch.diffusion.discretization import SIGMA_MAX_LEGACY
from supir_tpu_torch.diffusion.guidance import linear_cfg_scale


@dataclasses.dataclass
class StepTables:
    """Per-step scalar schedules, numpy float32 of length num_steps."""

    sigma: np.ndarray
    sigma_hat: np.ndarray
    next_sigma: np.ndarray
    churn_std: np.ndarray        # sqrt(sigma_hat^2 - sigma^2), 0 when no churn
    cfg_scale: np.ndarray        # guider scale evaluated at sigma_hat
    control_scale: np.ndarray    # per-step control strength
    restore_weight: np.ndarray   # (sigma/sigma_max)^restore_cfg, 0 where off

    @property
    def num_steps(self) -> int:
        return len(self.sigma)


def make_step_tables(
    sigmas: np.ndarray,
    cfg: SamplerConfig,
    control_scale: float = 1.0,
    use_linear_control_scale: bool = False,
    control_scale_start: float = 0.0,
) -> StepTables:
    """sigmas: descending schedule with terminal zero, length num_steps+1."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    sigma = sig[:-1]
    next_sigma = sig[1:]

    gamma_val = min(cfg.s_churn / max(n, 1), 2**0.5 - 1.0) if cfg.s_churn > 0 else 0.0
    in_range = (sigma >= cfg.s_tmin) & (sigma <= cfg.s_tmax)
    gamma = np.where(in_range, gamma_val, 0.0)
    sigma_hat = sigma * (gamma + 1.0)
    churn_std = np.sqrt(np.maximum(sigma_hat**2 - sigma**2, 0.0))

    if cfg.use_linear_cfg:
        cfg_scale = linear_cfg_scale(sigma_hat, cfg.cfg_scale, cfg.cfg_scale_min)
    else:
        cfg_scale = np.full(n, cfg.cfg_scale_min)

    if use_linear_control_scale:
        cs = (sigma / SIGMA_MAX_LEGACY) * (control_scale_start - control_scale) + control_scale
    else:
        cs = np.full(n, control_scale)

    restore_on = (next_sigma > cfg.restore_cfg_s_tmin) & (cfg.restore_cfg > 0)
    with np.errstate(divide="ignore"):
        rw = np.where(restore_on, (sigma / SIGMA_MAX_LEGACY) ** max(cfg.restore_cfg, 0.0), 0.0)

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return StepTables(
        sigma=f32(sigma),
        sigma_hat=f32(sigma_hat),
        next_sigma=f32(next_sigma),
        churn_std=f32(churn_std),
        cfg_scale=f32(cfg_scale),
        control_scale=f32(cs),
        restore_weight=f32(rw),
    )


def restore_edm_sample(
    denoise: Callable[..., torch.Tensor],
    x: torch.Tensor,
    generator: torch.Generator,
    tables: StepTables,
    x_center: torch.Tensor,
    s_noise: float = 1.003,
) -> torch.Tensor:
    """Euler EDM with churn noise and restoration guidance toward the stage-1
    latent x_center. Churn noise is drawn from `generator` on steps whose
    churn is nonzero (the JAX package draws it every step from jax.random,
    so the two streams differ; tests run with churn 0 or compare shapes)."""
    b = x.shape[0]
    for i in range(tables.num_steps):
        sigma_hat = float(tables.sigma_hat[i])
        churn = float(tables.churn_std[i])
        if churn > 0.0:
            eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + eps * (s_noise * churn)
        sig_b = torch.full((b,), sigma_hat, device=x.device)
        cfg_b = torch.full((b,), float(tables.cfg_scale[i]), device=x.device)
        denoised = denoise(x, sig_b, cfg_b, float(tables.control_scale[i]))
        denoised = denoised - (denoised - x_center) * float(tables.restore_weight[i])
        d = (x - denoised) / sigma_hat
        x = x + d * (float(tables.next_sigma[i]) - sigma_hat)
    return x
