"""RestoreEDM, SUPIR's default sampler, and RestoreDPMPP2M, the Lightning
sampler (counterpart of supir_tpu/diffusion/samplers.py:75-193, 371-500),
as Python loops.

Every per-step scalar (churn, CFG scale, control scale, restoration
weight) is precomputed into numpy `StepTables`, exactly as the JAX package
does. The `denoise` callable is the engine's closure
    denoise(x, sigma[B], cfg_scale[B], control_scale) -> denoised
which doubles the batch for CFG inside.

DPM++(2M) SDE draws its noise from a virtual Brownian tree (`vbt_value`,
`brownian_increment`) built on explicit torch.Generators: W(t) is
deterministic in (seed, t), whatever other times are queried, as
k-diffusion's BrownianTreeNoiseSampler is. Its streams differ from
jax.random's, so parity tests inject the increments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from supir_tpu_torch.config import SamplerConfig
from supir_tpu_torch.diffusion.discretization import SIGMA_MAX_LEGACY, karras_sigmas, legacy_ddpm_sigmas
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


# ---------------------------------------------------------------------------
# DPM++(2M) SDE, the Restore DPM++2M (Lightning) sampler


def restore_dpmpp2m_tables(cfg: SamplerConfig, num_steps: int, **control_kw) -> StepTables:
    """The Restore DPM++2M samplers rebuild a Karras ramp between the
    LegacyDDPM table's extremes (sampling.py:486-494)."""
    base = legacy_ddpm_sigmas(num_steps)
    return make_step_tables(karras_sigmas(num_steps, float(base[-2]), float(base[0])), cfg, **control_kw)


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def node_seed(seed: int, level: int, index: int) -> int:
    """The generator seed of the tree's node `index` at depth `level`
    (level 0: the end point W(t1)); a function of the path alone."""
    h = _splitmix64(_splitmix64(_splitmix64(seed & _MASK64) ^ level) ^ index)
    return h & ((1 << 63) - 1)


def _node_normal(seed: int, level: int, index: int, shape, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(node_seed(seed, level, index))
    return torch.randn(shape, generator=g, device=device)


def vbt_value(seed: int, t: float, t0: float, t1: float, shape, device="cpu", levels: int = 24) -> torch.Tensor:
    """W(t) fp32 of a Brownian motion pinned to W(t0) = 0, W(t1) ~ N(0,
    t1 - t0), by `levels` bisections of the Brownian bridge, each midpoint
    drawn from its node's own generator: the same (seed, t) gives the same
    value whatever else is queried. Resolution |t1 - t0| * 2^-levels, linear
    in between."""
    ta, tb = float(t0), float(t1)
    wa = torch.zeros(shape, device=device)
    wb = _node_normal(seed, 0, 0, shape, device) * math.sqrt(max(tb - ta, 0.0))
    index = 0
    for level in range(levels):
        tm = 0.5 * (ta + tb)
        wm = 0.5 * (wa + wb) + _node_normal(seed, level + 1, index, shape, device) * math.sqrt(max(tb - ta, 0.0) / 4)
        if t < tm:
            tb, wb, index = tm, wm, 2 * index
        else:
            ta, wa, index = tm, wm, 2 * index + 1
    frac = min(max((t - ta) / max(tb - ta, 1e-30), 0.0), 1.0)
    return wa + (wb - wa) * frac


def brownian_increment(seed: int, sigma_from: float, sigma_to: float, sigma_min: float, sigma_max: float,
                       shape, device="cpu", levels: int = 24) -> torch.Tensor:
    """Unit-variance noise (W(hi) - W(lo)) / sqrt(hi - lo) of the tree on
    the span [sigma_min, sigma_max] (k-diffusion's BrownianTreeNoiseSampler,
    whose time is sigma itself)."""
    lo, hi = min(sigma_from, sigma_to), max(sigma_from, sigma_to)
    w_hi = vbt_value(seed, hi, sigma_min, sigma_max, shape, device, levels)
    w_lo = vbt_value(seed, lo, sigma_min, sigma_max, shape, device, levels)
    return (w_hi - w_lo) / math.sqrt(max(hi - lo, 1e-30))


def dpmpp2m_update(x: torch.Tensor, denoised: torch.Tensor, old_denoised: torch.Tensor, i: int,
                   p_sigma: float, sigma: float, next_sigma: float, eta: float) -> tuple[torch.Tensor, float]:
    """One DPM++(2M) step from x at sigma to next_sigma: (the stepped x, the
    std of the SDE noise it takes, 0 where none). Step 0 (no old_denoised)
    and a terminal step take the first-order update and no noise
    (sampling.py:471-474)."""
    t, t_next = -math.log(sigma), -math.log(max(next_sigma, 1e-20))
    h = t_next - t
    eta_h = eta * h
    mult1 = (next_sigma / sigma) * math.exp(-eta_h)
    mult2 = math.expm1(-h - eta_h)
    if i > 0 and next_sigma > 1e-14:
        r = (t + math.log(p_sigma)) / h
        denoised = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old_denoised
        std = next_sigma * math.sqrt(-math.expm1(-2.0 * eta_h)) if eta > 0 else 0.0
    else:
        std = 0.0
    return mult1 * x - mult2 * denoised, std


def dpmpp2m_sample(denoise: Callable[..., torch.Tensor], x: torch.Tensor, seed: int, tables: StepTables,
                   eta: float = 0.0, s_noise: float = 1.0) -> torch.Tensor:
    """DPM++(2M), the SDE where eta > 0: the plain DPMPP2M and the
    RestoreDPMPP2M step (reference sampling.py:293-368, 422-519). The SDE's
    noise is the Brownian tree's increment over each step's sigma interval,
    on the span [last sigma, first sigma] of this schedule, seeded by
    `seed`."""
    b = x.shape[0]
    bt_min, bt_max = float(tables.sigma[-1]), float(tables.sigma[0])
    old_denoised = torch.zeros_like(x)
    p_sigma = 1.0
    for i in range(tables.num_steps):
        sigma, next_sigma = float(tables.sigma[i]), float(tables.next_sigma[i])
        cfg_b = torch.full((b,), float(tables.cfg_scale[i]), device=x.device)
        denoised = denoise(x, torch.full((b,), sigma, device=x.device), cfg_b, float(tables.control_scale[i]))
        x, std = dpmpp2m_update(x, denoised, old_denoised, i, p_sigma, sigma, next_sigma, eta)
        if std > 0:
            noise = brownian_increment(seed, sigma, next_sigma, bt_min, bt_max, x.shape, x.device)
            x = x + noise * (std * s_noise)
        old_denoised, p_sigma = denoised, sigma
    return x
