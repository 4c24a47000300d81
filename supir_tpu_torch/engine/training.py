"""Training: diffusion fine-tuning of the SUPIR control path on one card
(counterpart of supir_tpu/engine/training.py; reference
sgm/models/diffusion.py:131-189, training_step + EMA).

What trains is the JAX trainer's `trainable_of`, the control net and the
UNet, less what JAX's stop_gradient keeps at zero gradient: the UNet's time
embedding and input blocks (`LightGLVUNet` detaches them, as
`supir_tpu/models/control.py:229` and `unet.py:158-160` stop them). Those
leaves get `requires_grad=False` and no optimizer state: with the default
`weight_decay=0` AdamW leaves a leaf of zero gradient unchanged, and with
`weight_decay > 0` they decay by lr * wd * p per step here, as optax decays
every leaf of its tree. The VAE is outside the trainable tree.

Semantics kept from the JAX trainer:
- `torch.optim.AdamW` with optax's `adamw` defaults (b1 0.9, b2 0.999, eps
  1e-8 outside the square root) and the weight decay passed explicitly
  (torch's default is 0.01); fused on the card, so the update needs no
  temporaries the size of the parameters.
- the EMA decay is min(decay, (1 + step) / (10 + step)) with the step
  before its increment, applied to the updated parameters.
- fp32 parameters; on the card the forward and backward run under bf16
  autocast, the counterpart of the Flax modules' `dtype`.
- the loss is `diffusion_loss` with eps weighting and discrete sigma
  sampling.
There is no mesh: one card holds everything (sharding is a later module).

The EMA keeps a copy of each leaf that trains. A stop-gradient leaf never
moves when `weight_decay` is 0, so its average is the leaf itself and no
copy is kept; with `weight_decay > 0` it moves, and the EMA copies it too.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from supir_tpu_torch.diffusion.loss import diffusion_loss
from supir_tpu_torch.engine.supir import SUPIREngine, _nchw

# parameter prefixes of trainable_of (control + unet), and the part of the
# UNet that JAX's stop_gradient freezes
TRAINABLE_PREFIXES = ("model.control_model.", "model.diffusion_model.")
STOP_GRADIENT_PREFIXES = tuple(
    "model.diffusion_model." + p for p in ("input_blocks.", "time_embed.", "label_emb.")
)


def train_autocast(device: torch.device):
    """The trainers' forward and backward precision: bf16 autocast on the
    card (the Flax modules' `dtype`), none on the CPU."""
    return torch.autocast("cuda", dtype=torch.bfloat16, enabled=device.type == "cuda")


def set_adam_state(optimizer: torch.optim.Optimizer, params: Mapping[str, torch.Tensor],
                   exp_avg: Mapping[str, torch.Tensor], exp_avg_sq: Mapping[str, torch.Tensor], step: int) -> None:
    """Give each of `params` (by name) that `exp_avg` holds the state of an
    Adam or AdamW `optimizer` after `step` steps with those moments (optax's
    mu and nu). torch keeps the step count per parameter: a float32 scalar,
    on the card when the optimizer is fused."""
    fused = bool(optimizer.defaults.get("fused"))
    for k, p in params.items():
        if k in exp_avg:
            optimizer.state[p] = {
                "step": torch.tensor(float(step), dtype=torch.float32, device=p.device if fused else "cpu"),
                "exp_avg": exp_avg[k].to(p).clone(),
                "exp_avg_sq": exp_avg_sq[k].to(p).clone(),
            }


class EMA:
    """Exponential moving average of named parameters (reference
    sgm/modules/ema.py), with LitEma's warm-up of the decay."""

    def __init__(self, decay: float = 0.9999):
        self.decay = decay

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in params.items()}

    def decay_at(self, step: int) -> float:
        """min(decay, (1 + step) / (10 + step)), in fp32 as the JAX
        trainer computes it."""
        s = np.float32(step)
        return float(np.minimum(np.float32(self.decay), (np.float32(1.0) + s) / (np.float32(10.0) + s)))

    @torch.no_grad()
    def update(self, ema: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor], step: int) -> None:
        """ema = ema * d + params * (1 - d), in place."""
        d = self.decay_at(step)
        targets = list(ema.values())
        torch._foreach_mul_(targets, d)
        torch._foreach_add_(targets, [params[k].detach() for k in ema], alpha=float(np.float32(1.0) - np.float32(d)))


class SUPIRTrainer:
    """One-card trainer of the control path over a SUPIREngine whose
    parameters are fp32 (`engine/factory.py:create_trainer` builds both).

    `train_step(z, cond, generator)` runs one step and returns the loss;
    it is `loss_and_grads` (forward and backward, gradients left in
    `.grad`) followed by `apply_gradients` (AdamW, the EMA, the step
    count). Latents are NHWC [B, h, w, 4] like the JAX trainer's; `cond`
    holds 'crossattn' [B, 77, ctx], 'vector' [B, adm] and 'control'
    [B, h, w, 4]."""

    def __init__(self, engine: SUPIREngine, learning_rate: float = 1e-5, weight_decay: float = 0.0,
                 ema_decay: Optional[float] = 0.9999):
        self.engine = engine
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.ema = EMA(ema_decay) if ema_decay else None
        named = dict(engine.model.named_parameters())
        for name, p in named.items():
            p.requires_grad_(name.startswith(TRAINABLE_PREFIXES) and not name.startswith(STOP_GRADIENT_PREFIXES))
        # leaves that receive gradients, and leaves of trainable_of that do not
        self.params = {k: p for k, p in named.items() if p.requires_grad}
        self.stopped = {k: p for k, p in named.items() if k.startswith(STOP_GRADIENT_PREFIXES)}
        self.init_state()

    def trainable_of(self) -> Dict[str, torch.Tensor]:
        """The JAX trainer's trainable tree: control net and UNet."""
        return {**self.params, **self.stopped}

    def init_state(self) -> Dict[str, Any]:
        """Fresh AdamW moments and EMA for the current parameters, step 0."""
        fused = self.engine.device.type == "cuda"
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay, fused=fused,
        )
        self.ema_params = self.ema.init(self._ema_sources()) if self.ema else None
        self.step = 0
        return self.state()

    def _ema_sources(self) -> Dict[str, torch.Tensor]:
        return self.trainable_of() if self.weight_decay else dict(self.params)

    def state(self) -> Dict[str, Any]:
        """The trainer's state by parameter name: 'params' (every parameter
        of the model), 'exp_avg' and 'exp_avg_sq' (AdamW's moments, optax's
        mu and nu; empty before the first step), 'ema' and 'step'."""
        opt = self.optimizer.state
        return {
            "params": dict(self.engine.model.named_parameters()),
            "exp_avg": {k: opt[p]["exp_avg"] for k, p in self.params.items() if p in opt},
            "exp_avg_sq": {k: opt[p]["exp_avg_sq"] for k, p in self.params.items() if p in opt},
            "ema": self.ema_params,
            "step": self.step,
        }

    @torch.no_grad()
    def load_state(self, state: Mapping[str, Any]) -> None:
        """Load a state shaped as `state()` returns it (for instance from
        `utils/weights.py:train_state_from_jax`): the parameters, AdamW's
        moments of every leaf that trains, the EMA and the step."""
        named = dict(self.engine.model.named_parameters())
        for k, v in state["params"].items():
            named[k].copy_(v)
        self.step = int(state["step"])
        set_adam_state(self.optimizer, self.params, state["exp_avg"], state["exp_avg_sq"], self.step)
        if self.ema:
            self.ema_params = {k: state["ema"][k].to(named[k]).clone() for k in self._ema_sources()}

    def _denoise(self, noised, sigma, cond):
        engine = self.engine
        return engine.denoiser(engine._network, noised, sigma, cond, 1.0)

    def loss_and_grads(self, z, cond: Mapping[str, Any], generator: Optional[torch.Generator] = None,
                       sigma=None, noise=None) -> torch.Tensor:
        """Forward and backward of one step: returns the loss (fp32, detached)
        and leaves each training leaf's gradient in `.grad`. `sigma` [B] and
        `noise` [B, h, w, 4] replace the generator's draws where given."""
        engine = self.engine
        t = engine._tensor
        z = _nchw(t(z))
        batch = {"crossattn": t(cond["crossattn"]), "vector": t(cond["vector"]),
                 "control": _nchw(t(cond["control"]))}
        sigma = None if sigma is None else t(sigma)
        noise = None if noise is None else _nchw(t(noise))
        for p in self.params.values():
            p.grad = None
        with train_autocast(engine.device):
            loss = diffusion_loss(self._denoise, z, batch, generator, weighting="eps",
                                  sigma_sampler="discrete", sigma=sigma, noise=noise)
        loss.backward()
        return loss.detach()

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """AdamW on the leaves that train (then their gradients are freed),
        weight decay of the stop-gradient leaves, the EMA of the updated
        leaves at the step before its increment, and the step count."""
        self.optimizer.step()
        for p in self.params.values():
            p.grad = None
        if self.weight_decay:
            for p in self.stopped.values():  # p + (-lr * wd * p), as optax adds its update
                p.add_(p * (-self.learning_rate * self.weight_decay))
        if self.ema:
            self.ema.update(self.ema_params, self.trainable_of(), self.step)
        self.step += 1

    def train_step(self, z, cond: Mapping[str, Any], generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One step, sigma and noise drawn from `generator`; returns its loss."""
        loss = self.loss_and_grads(z, cond, generator)
        self.apply_gradients()
        return loss
