"""Learning-rate multipliers (the port's own copy of
supir_tpu/diffusion/lr_schedulers.py; reference sgm/lr_scheduler.py:4-135).
numpy only. Each returns f(step), a multiplier of the base learning rate,
e.g. for `torch.optim.lr_scheduler.LambdaLR`.
"""

from __future__ import annotations

import numpy as np


def lambda_warmup_cosine(warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps):
    """Warm-up lr_start -> lr_max, then cosine to lr_min
    (LambdaWarmUpCosineScheduler)."""

    def f(step):
        step = np.asarray(step, np.float64)
        warm = lr_start + (lr_max - lr_start) / max(warm_up_steps, 1) * step
        t = (step - warm_up_steps) / max(max_decay_steps - warm_up_steps, 1)
        t = np.minimum(t, 1.0)
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1 + np.cos(t * np.pi))
        return np.where(step < warm_up_steps, warm, cos)

    return f


def _cycle(cum, n_cycles, step):
    """The cycle `step` falls in (the last one past the end) and the step
    within it."""
    c = min(int(np.searchsorted(cum[1:], step, side="right")), n_cycles - 1)
    return c, step - cum[c]


def lambda_warmup_cosine2(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """Cycled warm-up + cosine (LambdaWarmUpCosineScheduler2)."""
    cum = np.cumsum([0] + list(cycle_lengths))

    def f(step):
        c, s = _cycle(cum, len(cycle_lengths), step)
        if s < warm_up_steps[c]:
            return f_start[c] + (f_max[c] - f_start[c]) / max(warm_up_steps[c], 1) * s
        t = (s - warm_up_steps[c]) / max(cycle_lengths[c] - warm_up_steps[c], 1)
        t = min(t, 1.0)
        return f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1 + np.cos(t * np.pi))

    return f


def lambda_linear(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """Warm-up, then linear decay per cycle (LambdaLinearScheduler)."""
    cum = np.cumsum([0] + list(cycle_lengths))

    def f(step):
        c, s = _cycle(cum, len(cycle_lengths), step)
        if s < warm_up_steps[c]:
            return f_start[c] + (f_max[c] - f_start[c]) / max(warm_up_steps[c], 1) * s
        return f_min[c] + (f_max[c] - f_min[c]) * (cycle_lengths[c] - s) / cycle_lengths[c]

    return f
