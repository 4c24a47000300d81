"""The sampler family (counterpart of supir_tpu/diffusion/samplers.py), as
Python loops: RestoreEDM, SUPIR's default, and its cross-step feature
cache; EulerEDM and HeunEDM; EulerAncestral, DPM++(2S) ancestral and the
Substep schedule; DPM++(2M), the SDE of RestoreDPMPP2M (Lightning); LMS.

Every per-step scalar (churn, CFG scale, control scale, restoration
weight) is precomputed into numpy `StepTables`, exactly as the JAX package
does. The `denoise` callable is the engine's closure
    denoise(x, sigma[B], cfg_scale[B], control_scale) -> denoised
which doubles the batch for CFG inside.

The samplers that draw noise (churn, ancestral steps) take a
torch.Generator, and an optional hook `noise(i, shape) -> Tensor` that
gives step i's unit-normal draw instead: the port's streams differ from
jax.random's, so parity tests inject JAX's draws through it.

DPM++(2M) SDE draws its noise from a virtual Brownian tree (`vbt_value`,
`brownian_increment`) built on explicit torch.Generators: W(t) is
deterministic in (seed, t), whatever other times are queried, as
k-diffusion's BrownianTreeNoiseSampler is. Its streams differ from
jax.random's, so parity tests inject the increments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

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


NoiseHook = Callable[[int, tuple], torch.Tensor]


def _draw(noise: Optional[NoiseHook], generator: torch.Generator, i: int, like: torch.Tensor) -> torch.Tensor:
    """Step i's unit-normal draw shaped like `like`: the hook's where one is
    given, else from `generator`."""
    if noise is not None:
        return noise(i, tuple(like.shape)).to(device=like.device, dtype=like.dtype)
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def _to_d(x: torch.Tensor, sigma: float, denoised: torch.Tensor) -> torch.Tensor:
    return (x - denoised) / sigma


def _full(b: int, value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((b,), value, device=like.device)


def restore_edm_sample(
    denoise: Callable[..., torch.Tensor],
    x: torch.Tensor,
    generator: torch.Generator,
    tables: StepTables,
    x_center: Optional[torch.Tensor] = None,
    s_noise: float = 1.003,
    noise: Optional[NoiseHook] = None,
) -> torch.Tensor:
    """Euler EDM with churn noise and restoration guidance toward the stage-1
    latent x_center (zero where None, as EulerEDM runs it). The churn draw
    of step i is taken on steps whose churn is nonzero (the JAX package
    draws one every step and scales it by zero elsewhere)."""
    b = x.shape[0]
    xc = 0.0 if x_center is None else x_center
    for i in range(tables.num_steps):
        sigma_hat = float(tables.sigma_hat[i])
        churn = float(tables.churn_std[i])
        if churn > 0.0:
            x = x + _draw(noise, generator, i, x) * (s_noise * churn)
        denoised = denoise(x, _full(b, sigma_hat, x), _full(b, float(tables.cfg_scale[i]), x),
                           float(tables.control_scale[i]))
        denoised = denoised - (denoised - xc) * float(tables.restore_weight[i])
        x = x + _to_d(x, sigma_hat, denoised) * (float(tables.next_sigma[i]) - sigma_hat)
    return x


def with_feature_cache(denoise_cached: Callable, recompute: Sequence[bool], num_steps: int) -> Callable:
    """A denoise for a sampler that calls it once a step, in order, threading
    the cross-step feature cache through
        denoise_cached(*args, cache, recompute_i) -> (denoised, cache).
    The cache is None until step 0, which must recompute, fills it."""
    recompute = [bool(r) for r in recompute]
    if len(recompute) != num_steps or not recompute[0]:
        raise ValueError(f"recompute must hold one flag a step ({num_steps}) and start True: step 0 fills the "
                         f"cache, got {recompute}")
    state = {"step": 0, "cache": None}

    def denoise(*args):
        i = state["step"]
        out, state["cache"] = denoise_cached(*args, state["cache"], recompute[i])
        state["step"] = i + 1
        return out

    return denoise


def restore_edm_sample_cached(
    denoise_cached: Callable,
    recompute: Sequence[bool],
    x: torch.Tensor,
    generator: torch.Generator,
    tables: StepTables,
    x_center: Optional[torch.Tensor] = None,
    s_noise: float = 1.003,
    noise: Optional[NoiseHook] = None,
) -> torch.Tensor:
    """RestoreEDM with the cross-step feature cache (opt-in approximation):
    `denoise_cached(x, sigma_b, cfg_b, ctrl_s, cache, recompute_i)` returns
    (denoised, cache); on steps where `recompute[i]` is False it reuses the
    encoder and control features of the last recompute step, and only the
    decoder, adapters and time embedding run. recompute[0] must be True.
    With every flag True the result is bit-identical to
    `restore_edm_sample`: the same loop and draws."""
    return restore_edm_sample(with_feature_cache(denoise_cached, recompute, tables.num_steps), x, generator,
                              tables, x_center=x_center, s_noise=s_noise, noise=noise)


# ---------------------------------------------------------------------------
# Euler / Heun EDM (reference sampling.py:86-136, 216-240)


def euler_edm_sample(denoise, x, generator, tables, s_noise: float = 1.0, noise: Optional[NoiseHook] = None):
    """RestoreEDM's loop with no stage-1 latent: the restoration weight, where
    the tables hold one, pulls toward zero, as in the JAX package."""
    return restore_edm_sample(denoise, x, generator, tables, x_center=None, s_noise=s_noise, noise=noise)


def heun_correct(denoise, x, x_euler, d, dt: float, next_sigma: float, cfg_b, ctrl_s):
    """Heun's second-order correction of an Euler step x -> x_euler: the
    slope at x_euler averaged with the first one."""
    den2 = denoise(x_euler, torch.full_like(cfg_b, next_sigma), cfg_b, ctrl_s)
    return x + (d + _to_d(x_euler, next_sigma, den2)) / 2.0 * dt


def heun_edm_sample(denoise, x, generator, tables, s_noise: float = 1.0, noise: Optional[NoiseHook] = None):
    """Heun EDM with churn: two network calls a step, one where the step
    ends at sigma 0 (the correction runs only where next_sigma > 1e-14)."""
    b = x.shape[0]
    for i in range(tables.num_steps):
        sigma_hat, next_sigma = float(tables.sigma_hat[i]), float(tables.next_sigma[i])
        churn = float(tables.churn_std[i])
        if churn > 0.0:
            x = x + _draw(noise, generator, i, x) * (s_noise * churn)
        cfg_b, ctrl_s = _full(b, float(tables.cfg_scale[i]), x), float(tables.control_scale[i])
        d = _to_d(x, sigma_hat, denoise(x, _full(b, sigma_hat, x), cfg_b, ctrl_s))
        dt = next_sigma - sigma_hat
        x_euler = x + d * dt
        x = heun_correct(denoise, x, x_euler, d, dt, next_sigma, cfg_b, ctrl_s) if next_sigma > 1e-14 else x_euler
    return x


# ---------------------------------------------------------------------------
# Ancestral samplers (reference sampling.py:138-175, 243-289)


def _ancestral_step_sigmas(sigma_from, sigma_to, eta: float):
    """(sigma_down, sigma_up) of each step, float32 as the JAX package
    computes them (k-diffusion sampling_utils.py:27-36)."""
    sigma_from = np.asarray(sigma_from, np.float32)
    sigma_to = np.asarray(sigma_to, np.float32)
    if eta == 0:
        return sigma_to, np.zeros_like(sigma_to)
    up = np.minimum(sigma_to, np.float32(eta) * np.sqrt(
        sigma_to**2 * (sigma_from**2 - sigma_to**2) / np.maximum(sigma_from**2, np.float32(1e-20))))
    up = np.where(sigma_from > 0, up, np.float32(0.0)).astype(np.float32)
    down = np.sqrt(np.maximum(sigma_to**2 - up**2, np.float32(0.0))).astype(np.float32)
    return down, up


def euler_ancestral_sample(denoise, x, generator, tables, eta: float = 1.0, s_noise: float = 1.0,
                           noise: Optional[NoiseHook] = None):
    """Euler ancestral: a deterministic step to sigma_down, then noise of
    std sigma_up, none on a step that ends at sigma 0 (nor drawn where
    sigma_up is 0, as at eta 0)."""
    b = x.shape[0]
    down, up = _ancestral_step_sigmas(tables.sigma, tables.next_sigma, eta)
    for i in range(tables.num_steps):
        sigma = float(tables.sigma[i])
        denoised = denoise(x, _full(b, sigma, x), _full(b, float(tables.cfg_scale[i]), x),
                           float(tables.control_scale[i]))
        x = x + _to_d(x, sigma, denoised) * (float(down[i]) - sigma)
        if float(tables.next_sigma[i]) > 0.0 and up[i] > 0:
            x = x + _draw(noise, generator, i, x) * (s_noise * float(up[i]))
    return x


def dpmpp2s_ancestral_sample(denoise, x, generator, tables, eta: float = 1.0, s_noise: float = 1.0,
                             noise: Optional[NoiseHook] = None):
    """DPM++(2S) ancestral: a second network call at the log-sigma midpoint
    toward sigma_down (only where sigma_down > 1e-14, else the Euler step),
    then ancestral noise as in `euler_ancestral_sample`."""
    b = x.shape[0]
    down, up = _ancestral_step_sigmas(tables.sigma, tables.next_sigma, eta)
    for i in range(tables.num_steps):
        sigma, s_down = float(tables.sigma[i]), float(down[i])
        cfg_b, ctrl_s = _full(b, float(tables.cfg_scale[i]), x), float(tables.control_scale[i])
        denoised = denoise(x, _full(b, sigma, x), cfg_b, ctrl_s)
        if s_down > 1e-14:
            t, t_next = -math.log(sigma), -math.log(s_down)
            h = t_next - t
            sig_s = math.exp(-(t + 0.5 * h))
            x2 = (sig_s / sigma) * x - math.expm1(-0.5 * h) * denoised
            den2 = denoise(x2, _full(b, sig_s, x), cfg_b, ctrl_s)
            x = (s_down / sigma) * x - math.expm1(-h) * den2
        else:
            x = x + _to_d(x, sigma, denoised) * (s_down - sigma)
        if float(tables.next_sigma[i]) > 0.0 and up[i] > 0:
            x = x + _draw(noise, generator, i, x) * (s_noise * float(up[i]))
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


# ---------------------------------------------------------------------------
# Linear multistep (reference sampling.py:178-214)


def lms_coefficients(tables: StepTables, order: int = 4) -> np.ndarray:
    """[num_steps, order] float32: entry [i, j] weighs the j-th newest slope
    at step i (0 where j is past the step's order), the Adams-Bashforth
    integrals over the schedule (scipy quad at epsrel 1e-4, reference
    sampling_utils.py:12-24)."""
    from scipy import integrate

    n = tables.num_steps
    sig = np.concatenate([tables.sigma, [tables.next_sigma[-1]]]).astype(np.float64)

    def coeff(cur: int, i: int, j: int) -> float:
        def fn(tau):
            prod = 1.0
            for k in range(cur):
                if k != j:
                    prod *= (tau - sig[i - k]) / (sig[i - j] - sig[i - k])
            return prod

        return integrate.quad(fn, sig[i], sig[i + 1], epsrel=1e-4)[0]

    table = np.zeros((n, order), np.float32)
    for i in range(n):
        cur = min(i + 1, order)
        for j in range(cur):
            table[i, j] = coeff(cur, i, j)
    return table


def lms_sample(denoise, x, generator, tables, order: int = 4):
    """LMS: each step adds the newest `order` slopes weighted by
    `lms_coefficients`. Draws nothing; `generator` keeps the family's
    signature."""
    b = x.shape[0]
    coeffs = lms_coefficients(tables, order)
    ds = []  # slopes, newest first
    for i in range(tables.num_steps):
        sigma = float(tables.sigma[i])
        denoised = denoise(x, _full(b, sigma, x), _full(b, float(tables.cfg_scale[i]), x),
                           float(tables.control_scale[i]))
        ds = [_to_d(x, sigma, denoised)] + ds[:order - 1]
        x = x + sum(float(c) * d for c, d in zip(coeffs[i], ds))
    return x


# ---------------------------------------------------------------------------
# Substep (reference sampling.py:372-419): EulerAncestral on a fixed subset


SUBSTEP_SUBSET = (0, 100, 200, 300, 1000)
SUBSTEP_MAX_STEPS = len(SUBSTEP_SUBSET) - 1


def substep_sigmas(n_sample_steps: int) -> np.ndarray:
    """The first n entries of the subset of the 1000-step LegacyDDPM table,
    then its terminal zero. At 5 steps or more the subset runs out and the
    JAX package's schedule ends 0, 0, whose last ancestral step divides by
    sigma 0 (its output is not finite): the port raises there."""
    if not 1 <= n_sample_steps <= SUBSTEP_MAX_STEPS:
        raise ValueError(f"Substep takes 1 to {SUBSTEP_MAX_STEPS} steps (its subset {SUBSTEP_SUBSET} of the "
                         f"1000-step table), not {n_sample_steps}")
    full = legacy_ddpm_sigmas(1000)  # 1001 entries, descending, terminal zero
    return full[np.asarray(list(SUBSTEP_SUBSET[:n_sample_steps]) + [SUBSTEP_SUBSET[-1]])]
