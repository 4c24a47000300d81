"""Noise-level (sigma) discretizations, in numpy (copied from
supir_tpu/diffusion/discretization.py, keeping the arguments the restore
path sets: importing that module would pull in jax through its package
__init__).

LegacyDDPM: sqrt-linear beta schedule (linear_start=0.00085,
linear_end=0.012, 1000 steps), sigma = sqrt((1-abar)/abar), returned
descending with an appended terminal zero. Karras: a rho-7 ramp between
two sigmas, with a terminal zero; EDM: the same ramp at EDM's defaults.
"""

from __future__ import annotations

import functools

import numpy as np

# max sigma of the 1000-step LegacyDDPM table, as the reference rounds it in
# its linear CFG/control schedules
SIGMA_MAX_LEGACY = 14.6146
LINEAR_START = 0.00085
LINEAR_END = 0.0120


def roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    """Indices into a `max_step`-entry table, roughly equally spaced,
    always including the last step."""
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


@functools.lru_cache(maxsize=None)
def legacy_ddpm_sigma_table(num_timesteps: int = 1000) -> np.ndarray:
    """Full ascending sigma table of the DDPM sqrt-linear beta schedule,
    float32, shape [T]."""
    betas = (
        np.linspace(LINEAR_START**0.5, LINEAR_END**0.5, num_timesteps, dtype=np.float64) ** 2
    )
    alphas_cumprod = np.cumprod(1.0 - betas)
    sigmas = np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)
    return sigmas.astype(np.float32)


def legacy_ddpm_sigmas(n: int, num_timesteps: int = 1000) -> np.ndarray:
    """n-step sub-sampled LegacyDDPM schedule, descending, with a terminal
    0 appended ([n+1] floats). The SUPIR default schedule."""
    table = legacy_ddpm_sigma_table(num_timesteps)
    if n < num_timesteps:
        sel = table[roughly_equally_spaced_steps(n, num_timesteps)]
    elif n == num_timesteps:
        sel = table
    else:
        raise ValueError(f"n={n} > num_timesteps={num_timesteps}")
    return np.concatenate([sel[::-1], np.zeros((1,), np.float32)]).astype(np.float32)


def edm_sigmas(n: int, sigma_min: float = 0.02, sigma_max: float = 80.0, rho: float = 7.0,
               append_zero: bool = True) -> np.ndarray:
    """EDM (Karras) rho-schedule, n sigmas descending from sigma_max to
    sigma_min, float32, with a terminal zero unless `append_zero` is off."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1.0 / rho)
    max_inv_rho = sigma_max ** (1.0 / rho)
    out = ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho).astype(np.float32)
    if append_zero:
        out = np.concatenate([out, np.zeros((1,), np.float32)])
    return out


def karras_sigmas(n: int, sigma_min: float, sigma_max: float, rho: float = 7.0) -> np.ndarray:
    """k-diffusion's `get_sigmas_karras`: n descending sigmas from sigma_max
    to sigma_min on a rho-7 ramp, plus a terminal zero. The Restore DPM++2M
    (Lightning) samplers rebuild this ramp between the LegacyDDPM table's
    extremes (sampling.py:486-494)."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = float(sigma_min) ** (1.0 / rho)
    max_inv_rho = float(sigma_max) ** (1.0 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)
