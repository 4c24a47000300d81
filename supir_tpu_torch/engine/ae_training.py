"""Autoencoder (first-stage) adversarial training, on one card or over a
mesh (counterpart of supir_tpu/engine/ae_training.py; reference
sgm/models/autoencoder.py:182-215 with GeneralLPIPSWithDiscriminator,
sgm/modules/autoencoding/losses/__init__.py).

One `train_step` runs both phases back to back, as the JAX step does:

  generator:     L1 rec (+ perceptual) + kl_weight * KL
                 + d_weight * disc_weight * g, g gated by disc_start
  discriminator: hinge(real, fake), gated by disc_start, on a fresh
                 reconstruction by the updated generator

d_weight is the adaptive balance of losses/__init__.py:137-152: the norm of
the gradient of `rec` over the norm of the gradient of `g`, both at the
decoder's last convolution weight, clipped to [0, 1e4]. It is computed
only with `train_branch="all"`; with a frozen decoder it is 1.0. Both
gradients come from the generator phase's one forward
(`torch.autograd.grad(..., retain_graph=True)`); JAX evaluates the same
losses on the same draw again.

`train_branch="denoise_encoder"` trains only that branch (LQ in, HQ
target; the encoder, decoder and quant convolutions frozen): SUPIR's
stage-1 recipe, which makes the second encoder SUPIR_model.py:17 carries.
With "all" the generator's trainable tree is every autoencoder parameter,
as JAX's `_trainable` returns it; the denoise encoder is then outside the
forward and gets no update.

Kept from the JAX trainer:
- two Adam optimizers with optax's `adam(lr, b1=0.5, b2=0.9)` (eps 1e-8
  outside the square root), one for the generator's trainable leaves and
  one for the discriminator; fused on every device, so the CPU parity
  tests run the optimizer the card runs.
- the discriminator's gradients come only from the discriminator loss:
  the generator phase takes its gradients with `torch.autograd.grad` on
  the generator's trainable leaves, so nothing reaches the
  discriminator's `.grad` there.
- the discriminator phase reconstructs under `torch.no_grad()` (JAX's
  stop_gradient), so its GroupNorm sites run K2 on the card; every
  GroupNorm site under grad takes the plain form
  (`models/layers.py:GroupNorm32`).
- fp32 parameters, computing in the autoencoder's dtype (`compute_dtype`,
  JAX's module `dtype`, fp32 by default as in `supir_tpu/models/vae.py:
  160`): bf16 runs under bf16 autocast on the card, fp32 with none
  (`engine/training.py:train_autocast`).
- `mesh=` and `shard_state` (JAX :97-102): the whole state, the generator,
  the discriminator and both optimizers' moments, held as shards over the
  mesh's 'model' axis by the FSDP rule (`parallel/sharding.py`); each
  rank's optimizers step their own shards. As in JAX, the trainer does not
  split the batch: every rank computes the step on the whole batch, so the
  gradients of the shards are the slices of the one-card gradients. Each
  phase reads its sharded tensors under `parametrize.cached()`: one gather
  a tensor a phase, and the decoder's last kernel that d_weight
  differentiates is the tensor the forward read.
Difference: the two unit-normal draws of a step come from the
`torch.Generator` passed to `train_step`, through `unit_normal`, where JAX
splits its key.

Images are NHWC [B, H, W, 3] in [-1, 1], as the JAX trainer takes them;
`perceptual_fn(recon, target)` gets NHWC tensors too (e.g.
`utils/metrics.LPIPS`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
from torch.nn.utils import parametrize

from supir_tpu_torch.diffusion.ae_losses import (
    AELossConfig,
    ChannelNorm,
    NLayerDiscriminator,
    discriminator_loss,
    disc_factor,
    kl_regularizer,
)
from supir_tpu_torch.engine.training import set_adam_state, train_autocast
from supir_tpu_torch.models.vae import AutoencoderKL, DiagonalGaussian
from supir_tpu_torch.parallel.sharding import drop_gathered, full_tensor, held_parameters, local_block, shard_module

BRANCHES = ("all", "denoise_encoder")
METRICS = ("loss_g", "loss_d", "rec", "kl", "g_adv", "d_weight", "logits_real", "logits_fake")


def unit_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One fp32 N(0, 1) draw of `shape` on `device` from `generator`."""
    return torch.randn(shape, generator=generator, device=device)


@torch.no_grad()
def init_discriminator(disc: NLayerDiscriminator, generator: torch.Generator) -> None:
    """Convolutions N(0, 1/fan_in) (flax's lecun_normal variance), biases
    0, norms (1, 0)."""
    for m in disc.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, ChannelNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AETrainer:
    """Two-phase adversarial trainer of an fp32 AutoencoderKL on its
    device (`engine/factory.py:create_ae_trainer` builds both); with
    `mesh`, its state sharded over the mesh's 'model' axis (`shard_state`).

    `train_step(x, target, generator)` runs one step and returns the
    metrics of METRICS as 0-d fp32 tensors: loss_g, loss_d, rec, kl,
    g_adv, d_weight and the mean real and fake logits."""

    def __init__(self, model: AutoencoderKL, loss_cfg: AELossConfig = AELossConfig(),
                 learning_rate: float = 4.5e-6, disc_lr: Optional[float] = None, train_branch: str = "all",
                 perceptual_fn: Optional[Callable] = None, seed: int = 0, mesh=None,
                 compute_dtype: Optional[torch.dtype] = None):
        if train_branch not in BRANCHES:
            raise ValueError(f"train_branch must be one of {BRANCHES}, got {train_branch!r}")
        self.model = model
        self.loss_cfg = loss_cfg
        self.learning_rate = learning_rate
        self.disc_lr = disc_lr or learning_rate
        self.train_branch = train_branch
        self.perceptual_fn = perceptual_fn
        self.device = next(model.parameters()).device
        self.compute_dtype = compute_dtype or next(model.parameters()).dtype
        self.mesh = mesh
        self.sharded = False
        self.disc = NLayerDiscriminator(device=self.device)
        self.init_state(seed)
        if mesh is not None:
            self.shard_state()

    # ------------------------------------------------------------- state

    def trainable_of(self) -> Dict[str, torch.Tensor]:
        """The generator's trainable leaves by state-dict name (JAX's
        `_trainable`): the denoise encoder, or every parameter (this rank's
        shards over a mesh)."""
        named = {k: p for k, (p, _) in held_parameters(self.model).items()}
        if self.train_branch == "denoise_encoder":
            return {k: p for k, p in named.items() if k.startswith("denoise_encoder.")}
        return named

    def init_state(self, seed: int = 0) -> Dict[str, Any]:
        """A fresh discriminator drawn from `seed` on the device, fresh Adam
        moments for both phases, step 0 (before `shard_state`: the draws
        write whole tensors)."""
        if self.sharded:
            raise RuntimeError("init_state draws whole tensors: call it before shard_state")
        init_discriminator(self.disc, torch.Generator(device=self.device).manual_seed(seed))
        self.params = self.trainable_of()
        for name, p in self.model.named_parameters():
            p.requires_grad_(name in self.params)
        self.disc.requires_grad_(False)
        self._optimizers()
        self.step = 0
        return self.state()

    def _optimizers(self) -> None:
        disc = [p for p, _ in held_parameters(self.disc).values()]
        self.opt_g = torch.optim.Adam(list(self.params.values()), lr=self.learning_rate, betas=(0.5, 0.9),
                                      eps=1e-8, fused=True)
        self.opt_d = torch.optim.Adam(disc, lr=self.disc_lr, betas=(0.5, 0.9), eps=1e-8, fused=True)

    def shard_state(self) -> "AETrainer":
        """Hold the generator, the discriminator and both optimizers'
        moments as this rank's shards over the mesh's 'model' axis (JAX
        :97-102); a no-op without a mesh. Every rank calls it on the same
        state."""
        if self.mesh is None or self.sharded:
            return self
        state = self.state()
        shard_module(self.model, self.mesh)
        shard_module(self.disc, self.mesh)
        self.sharded = True
        self.params = self.trainable_of()
        self._optimizers()
        self.load_state(state)
        return self

    def _full(self, module: nn.Module, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors (gathered over 'model' where sharded) by name."""
        if not self.sharded:
            return dict(tree)
        held = held_parameters(module)
        return {k: full_tensor(v, held[k][1], self.mesh) for k, v in tree.items()}

    def _cut(self, module: nn.Module, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's blocks of full tensors by name."""
        if not self.sharded:
            return dict(tree)
        held = held_parameters(module)
        return {k: local_block(v, held[k][1], self.mesh) for k, v in tree.items()}

    @staticmethod
    def _moments(opt: torch.optim.Optimizer, named: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
        return {m: {k: opt.state[p][m] for k, p in named.items() if p in opt.state}
                for m in ("exp_avg", "exp_avg_sq")}

    def state(self) -> Dict[str, Any]:
        """'gen' (every autoencoder parameter), 'disc', 'opt_g' and 'opt_d'
        ({'exp_avg', 'exp_avg_sq'} by name: optax's mu and nu, empty before
        the first step) and 'step'; full tensors, gathered over a mesh."""
        gen = {k: p for k, (p, _) in held_parameters(self.model).items()}
        disc = {k: p for k, (p, _) in held_parameters(self.disc).items()}
        return {"gen": self._full(self.model, gen), "disc": self._full(self.disc, disc),
                "opt_g": {m: self._full(self.model, t) for m, t in self._moments(self.opt_g, self.params).items()},
                "opt_d": {m: self._full(self.disc, t) for m, t in self._moments(self.opt_d, disc).items()},
                "step": self.step}

    @torch.no_grad()
    def load_state(self, state: Mapping[str, Any]) -> None:
        """Load a state shaped as `state()` returns it (for instance from
        `utils/weights.py:ae_train_state_from_jax`), full tensors cut to
        this rank's blocks over a mesh."""
        for module, key in ((self.model, "gen"), (self.disc, "disc")):
            named = {k: p for k, (p, _) in held_parameters(module).items()}
            for k, v in self._cut(module, state[key]).items():
                named[k].copy_(v)
        self.step = int(state["step"])
        disc = {k: p for k, (p, _) in held_parameters(self.disc).items()}
        for opt, module, named, moments in ((self.opt_g, self.model, self.params, state["opt_g"]),
                                            (self.opt_d, self.disc, disc, state["opt_d"])):
            set_adam_state(opt, named, self._cut(module, moments["exp_avg"]), self._cut(module, moments["exp_avg_sq"]),
                           self.step)
            drop_gathered(module)

    # -------------------------------------------------------------- step

    def _recon(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        """NCHW x -> (reconstruction NCHW, mean, logvar) through the branch's
        encoder, one draw from the posterior and the decoder."""
        use_dn = self.train_branch == "denoise_encoder"
        dist = DiagonalGaussian(self.model.moments(x, use_denoise_encoder=use_dn))
        z = dist.sample(unit_normal(tuple(dist.mean.shape), generator, dist.mean.device))
        return self.model.decode(z), dist.mean, dist.logvar

    def _adaptive_weight(self, rec: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if self.train_branch != "all":
            return torch.ones((), device=self.device)
        last = self.model.decoder.conv_out.weight
        (rec_grad,) = torch.autograd.grad(rec, last, retain_graph=True)
        (g_grad,) = torch.autograd.grad(g, last, retain_graph=True)
        return (rec_grad.norm() / (g_grad.norm() + 1e-4)).clamp(0.0, 1e4).detach()

    def _generator_phase(self, x, target, generator):
        with parametrize.cached():
            return self._generator_step(x, target, generator)

    def _generator_step(self, x, target, generator):
        cfg = self.loss_cfg
        with train_autocast(self.device, self.compute_dtype):
            recon, mean, logvar = self._recon(x, generator)
            recon = recon.float()
            rec = (recon - target).abs().mean()
            if self.perceptual_fn is not None:
                rec = rec + cfg.perceptual_weight * self.perceptual_fn(_nhwc(recon), _nhwc(target)).float().mean()
            kl = kl_regularizer(mean.float(), logvar.float())
            g = -self.disc(recon).float().mean()
        d_weight = self._adaptive_weight(rec, g)
        total = rec + cfg.kl_weight * kl + d_weight * cfg.disc_weight * disc_factor(self.step, cfg) * g
        leaves = list(self.params.values())
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        for p, grad in zip(leaves, grads):
            p.grad = grad
        self.opt_g.step()
        self.opt_g.zero_grad(set_to_none=True)
        drop_gathered(self.model)
        return {"loss_g": total, "rec": rec, "kl": kl, "g_adv": g, "d_weight": d_weight}

    def _discriminator_phase(self, x, target, generator):
        with torch.no_grad(), train_autocast(self.device, self.compute_dtype):
            recon, _, _ = self._recon(x, generator)
        self.disc.requires_grad_(True)
        try:
            with parametrize.cached(), train_autocast(self.device, self.compute_dtype):
                logits_real = self.disc(target).float()
                logits_fake = self.disc(recon).float()
                loss_d = discriminator_loss(logits_real, logits_fake, self.step, self.loss_cfg)
            loss_d.backward()
        finally:
            self.disc.requires_grad_(False)
        self.opt_d.step()
        self.opt_d.zero_grad(set_to_none=True)
        drop_gathered(self.disc)
        return {"loss_d": loss_d, "logits_real": logits_real.mean(), "logits_fake": logits_fake.mean()}

    def train_step(self, x, target, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One generator and one discriminator step on NHWC images x (the
        encoder's input: LQ for the denoise encoder) and target (HQ); the
        two posterior draws come from `generator`."""
        x = _nchw(torch.as_tensor(x, device=self.device, dtype=torch.float32))
        target = _nchw(torch.as_tensor(target, device=self.device, dtype=torch.float32))
        metrics = self._generator_phase(x, target, generator)
        metrics.update(self._discriminator_phase(x, target, generator))
        self.step += 1
        return {k: metrics[k].detach().float() for k in METRICS}
