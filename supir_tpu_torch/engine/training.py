"""Training: diffusion fine-tuning of the SUPIR control path, on one card or
over a mesh (counterpart of supir_tpu/engine/training.py; reference
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
- fp32 parameters, computing in the config's `diffusion_dtype`, as the
  Flax modules' `dtype` (`supir_tpu/engine/supir.py:95-97`): bf16 (or
  fp16) runs the forward and backward on the card under that autocast,
  fp32 runs with no autocast (its flash sites on K3 fp32 and K4 fp32).
  The CPU runs fp32 (`train_autocast`).
- the loss is `diffusion_loss` with eps weighting and discrete sigma
  sampling.

Over a mesh (`SUPIRTrainer(engine, mesh)`, a Mesh('data', 'model') as the
JAX trainer is built over): every tensor of the model is held as this
rank's shard by the FSDP rule (`parallel/sharding.py:shard_module`), and
so are AdamW's moments and the EMA, as JAX's `state_shardings` place them
(:75-92); the step count is replicated. Each rank's optimizer steps its
own shards. z and cond split over 'data' (`make_batch_shardings`, JAX
:130-133); the sigma and noise draws are taken for the whole batch on
every rank from the same generator and split alike, so a step equals the
one-card step on the same draws. The gradients reach the shards through
the gathers' backward, and `reduce_gradients` averages them over 'data'.
`state()` and `load_state()` gather and cut full tensors by name.

The EMA keeps a copy of each leaf that trains. A stop-gradient leaf never
moves when `weight_decay` is 0, so its average is the leaf itself and no
copy is kept; with `weight_decay > 0` it moves, and the EMA copies it too.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from supir_tpu_torch.config import dtype_of
from supir_tpu_torch.diffusion.loss import diffusion_loss
from supir_tpu_torch.diffusion.sigma_sampling import discrete_sampling
from supir_tpu_torch.engine.supir import SUPIREngine, _nchw
from supir_tpu_torch.parallel.sharding import (
    batch_sharding,
    drop_gathered,
    full_tensor,
    held_parameters,
    local_block,
    reduce_gradients,
    shard_module,
)

# parameter prefixes of trainable_of (control + unet), and the part of the
# UNet that JAX's stop_gradient freezes
TRAINABLE_PREFIXES = ("model.control_model.", "model.diffusion_model.")
STOP_GRADIENT_PREFIXES = tuple(
    "model.diffusion_model." + p for p in ("input_blocks.", "time_embed.", "label_emb.")
)


def autocast_dtype(device: torch.device, compute_dtype: torch.dtype) -> Optional[torch.dtype]:
    """The autocast a trainer runs under, from the dtype its model computes
    in (the Flax modules' `dtype` over fp32 parameters): that dtype on the
    card when it is narrower than fp32, else None, no autocast (fp32; and
    the CPU, which runs fp32)."""
    if device.type == "cuda" and compute_dtype in (torch.bfloat16, torch.float16):
        return compute_dtype
    return None


def train_autocast(device: torch.device, compute_dtype: torch.dtype):
    """The trainers' forward and backward precision (`autocast_dtype`)."""
    dtype = autocast_dtype(device, compute_dtype)
    return torch.autocast("cuda", dtype=dtype or torch.bfloat16, enabled=dtype is not None)


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
    """Trainer of the control path over a SUPIREngine whose parameters are
    fp32 (`engine/factory.py:create_trainer` builds both), on one card or,
    with `mesh`, sharded over it (module docstring).

    `train_step(z, cond, generator)` runs one step and returns the loss;
    it is `loss_and_grads` (forward and backward, gradients left in
    `.grad`) followed by `apply_gradients` (AdamW, the EMA, the step
    count). Latents are NHWC [B, h, w, 4] like the JAX trainer's; `cond`
    holds 'crossattn' [B, 77, ctx], 'vector' [B, adm] and 'control'
    [B, h, w, 4]."""

    def __init__(self, engine: SUPIREngine, mesh=None, learning_rate: float = 1e-5, weight_decay: float = 0.0,
                 ema_decay: Optional[float] = 0.9999):
        self.engine = engine
        self.mesh = mesh
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.ema = EMA(ema_decay) if ema_decay else None
        self.compute_dtype = dtype_of(engine.cfg.diffusion_dtype)
        for name, p in engine.model.named_parameters():
            p.requires_grad_(name.startswith(TRAINABLE_PREFIXES) and not name.startswith(STOP_GRADIENT_PREFIXES))
        if mesh is not None:
            shard_module(engine.model, mesh)
        # every parameter by its unsharded name: (the tensor this rank holds, its split dim or None)
        self.held = held_parameters(engine.model)
        named = {k: p for k, (p, _) in self.held.items()}
        # leaves that receive gradients, and leaves of trainable_of that do not
        self.params = {k: p for k, p in named.items() if p.requires_grad}
        self.stopped = {k: p for k, p in named.items() if k.startswith(STOP_GRADIENT_PREFIXES)}
        self.init_state()

    def trainable_of(self) -> Dict[str, torch.Tensor]:
        """The JAX trainer's trainable tree: control net and UNet."""
        return {**self.params, **self.stopped}

    def init_state(self) -> None:
        """Fresh AdamW moments and EMA for the current parameters (this
        rank's shards over a mesh), step 0."""
        fused = self.engine.device.type == "cuda"
        self.optimizer = torch.optim.AdamW(
            list(self.params.values()), lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay, fused=fused,
        )
        self.ema_params = self.ema.init(self._ema_sources()) if self.ema else None
        self.step = 0

    def _ema_sources(self) -> Dict[str, torch.Tensor]:
        return self.trainable_of() if self.weight_decay else dict(self.params)

    def full(self, name: str, held: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter `name` from this rank's block `held`
        (the parameter's shard, or its moment's or EMA's): gathered over
        'model' where the parameter is split; `held` itself on one card.
        Every rank of the mesh must call it."""
        return full_tensor(held, self.held[name][1], self.mesh) if self.mesh is not None else held

    def state(self) -> Dict[str, Any]:
        """The trainer's state by parameter name, full tensors (gathered
        over a mesh): 'params' (every parameter of the model), 'exp_avg'
        and 'exp_avg_sq' (AdamW's moments, optax's mu and nu; empty before
        the first step), 'ema' and 'step'."""
        opt = self.optimizer.state

        def full(tree):
            return {k: self.full(k, v) for k, v in tree.items()}

        return {
            "params": full({k: p for k, (p, _) in self.held.items()}),
            "exp_avg": full({k: opt[p]["exp_avg"] for k, p in self.params.items() if p in opt}),
            "exp_avg_sq": full({k: opt[p]["exp_avg_sq"] for k, p in self.params.items() if p in opt}),
            "ema": None if self.ema_params is None else full(self.ema_params),
            "step": self.step,
        }

    def _cut(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full tensor of parameter `name`."""
        return local_block(full, self.held[name][1], self.mesh) if self.mesh is not None else full

    @torch.no_grad()
    def load_state(self, state: Mapping[str, Any]) -> None:
        """Load a state shaped as `state()` returns it (for instance from
        `utils/weights.py:train_state_from_jax`), full tensors by name (cut
        to this rank's blocks over a mesh): the parameters, AdamW's moments
        of every leaf that trains, the EMA and the step."""
        named = {k: p for k, (p, _) in self.held.items()}
        for k, v in state["params"].items():
            named[k].copy_(self._cut(k, v))
        self.step = int(state["step"])
        cut = {m: {k: self._cut(k, v) for k, v in state[m].items()} for m in ("exp_avg", "exp_avg_sq")}
        set_adam_state(self.optimizer, self.params, cut["exp_avg"], cut["exp_avg_sq"], self.step)
        if self.ema:
            self.ema_params = {k: self._cut(k, state["ema"][k]).to(named[k]).clone() for k in self._ema_sources()}
        drop_gathered(self.engine.model)

    def make_batch_shardings(self, z, cond):
        """z's and each cond entry's layout over the mesh: the batch split
        over 'data' (JAX :130-133)."""
        zs = batch_sharding(self.mesh, z.dim())
        return zs, {k: batch_sharding(self.mesh, v.dim()) for k, v in cond.items()}

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
        z, cond = t(z), {k: t(cond[k]) for k in ("crossattn", "vector", "control")}
        sigma = None if sigma is None else t(sigma)
        noise = None if noise is None else t(noise)
        if self.mesh is not None:
            # the whole batch's draws on every rank, in diffusion_loss's order,
            # then each rank's block over 'data'
            if sigma is None:
                sigma, _ = discrete_sampling(generator, z.shape[0], device=z.device)
            if noise is None:
                noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
            zs, cs = self.make_batch_shardings(z, cond)
            z, cond = zs.local(z), {k: cs[k].local(v) for k, v in cond.items()}
            sigma, noise = batch_sharding(self.mesh, 1).local(sigma), zs.local(noise)
        z = _nchw(z)
        batch = {"crossattn": cond["crossattn"], "vector": cond["vector"], "control": _nchw(cond["control"])}
        noise = None if noise is None else _nchw(noise)
        for p in self.params.values():
            p.grad = None
        with train_autocast(engine.device, self.compute_dtype):
            loss = diffusion_loss(self._denoise, z, batch, generator, weighting="eps",
                                  sigma_sampler="discrete", sigma=sigma, noise=noise)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            reduce_gradients(self.engine.model, list(self.params.values()), self.mesh)
            loss = self._data_mean(loss)
        return loss

    def _data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """x averaged over 'data' (the whole batch's loss from each rank's)."""
        from supir_tpu_torch.parallel.mesh import all_reduce_mean_, axis_group, axis_size

        if axis_size(self.mesh, "data") <= 1:
            return x
        return all_reduce_mean_(x.clone(), axis_group(self.mesh, "data")[0])

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """AdamW on the leaves that train (then their gradients are freed),
        weight decay of the stop-gradient leaves, the EMA of the updated
        leaves at the step before its increment, and the step count."""
        self.optimizer.step()
        for p in self.params.values():
            p.grad = None
        drop_gathered(self.engine.model)
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
