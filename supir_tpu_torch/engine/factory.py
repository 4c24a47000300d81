"""Engine and trainer construction: random init from a seed, or a given
state dict (counterpart of supir_tpu/engine/factory.py).

The modules are built on the meta device and materialised directly on the
target device in the target dtype, so a full-width engine never exists as
an fp32 copy on the host (~14 GB). Random init follows `init_params`:
convs and linears draw N(0, 1/fan_in) (flax's lecun_normal variance),
biases are zero, norms are (1, 0), and zero-initialised layers stay zero;
the text towers' token embeddings draw N(0, 1/width) (flax's Embed), their
position embeddings N(0, 0.01^2) and bigG's text projection N(0, 1/width).
Every draw comes from one `torch.Generator` on the target device, the
conditioner's after the restore modules', so adding it leaves their
weights as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn as nn

from supir_tpu_torch.config import ConditionerConfig, SUPIRConfig, UNetConfig, VAEConfig, dtype_of
from supir_tpu_torch.diffusion.ae_losses import AELossConfig
from supir_tpu_torch.engine.ae_training import AETrainer
from supir_tpu_torch.engine.supir import SUPIREngine, SUPIRModel
from supir_tpu_torch.engine.training import SUPIRTrainer
from supir_tpu_torch.models.clip import CLIPTextModel, OpenCLIPAttention
from supir_tpu_torch.models.layers import Conv, Dense, FusedLayerNorm, GroupNorm32
from supir_tpu_torch.models.vae import AutoencoderKL
from supir_tpu_torch.utils.device import resolve_device


def tiny_test_config():
    """(SUPIRConfig, ConditionerConfig) at tiny widths whose UNet context
    and ADM widths are the tiny conditioner's (supir_tpu/engine/factory.py:22),
    fp32 throughout: the CLI's --tiny and the CPU tests."""
    cond_cfg = ConditionerConfig().tiny()
    unet = dataclasses.replace(UNetConfig().tiny(), context_dim=cond_cfg.context_dim,
                               adm_in_channels=cond_cfg.adm_dim)
    base = SUPIRConfig.tiny()
    cfg = dataclasses.replace(base, unet=unet, control=dataclasses.replace(base.control, unet=unet),
                              ae_dtype="fp32", diffusion_dtype="fp32")
    return cfg, cond_cfg


@torch.no_grad()
def init_random(model: nn.Module, generator: torch.Generator) -> None:
    for module in model.modules():
        if isinstance(module, (Conv, Dense)):
            w = module.weight
            if module.zero_init:
                w.zero_()
            else:
                fan_in = w[0].numel()
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (GroupNorm32, FusedLayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Linear):
            module.weight.normal_(0.0, module.in_features ** -0.5, generator=generator)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.embedding_dim ** -0.5, generator=generator)
        elif isinstance(module, OpenCLIPAttention):
            w = module.in_proj_weight
            w.normal_(0.0, w.shape[1] ** -0.5, generator=generator)
            module.in_proj_bias.zero_()
        elif isinstance(module, CLIPTextModel) and module.layout == "openclip":
            module.positional_embedding.normal_(0.0, 0.01, generator=generator)
            proj = module.text_projection
            proj.normal_(0.0, proj.shape[0] ** -0.5, generator=generator)


def build_model(cfg: SUPIRConfig, device, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0, param_dtype: Optional[torch.dtype] = None,
                cond_cfg: Optional[ConditionerConfig] = None) -> SUPIRModel:
    """SUPIRModel on `device`, with the text conditioner where `cond_cfg`
    is given: filled from `state_dict` (strict, cast to the parameters'
    dtypes) or, when none is given, randomly from `seed`; every parameter
    in `param_dtype` if given, else in the config's dtypes."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = SUPIRModel(cfg, param_dtype=param_dtype, cond_cfg=cond_cfg)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_random(model, torch.Generator(device=device).manual_seed(seed))
    return model


def create_engine(cfg: Optional[SUPIRConfig] = None, device="cuda",
                  state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                  seed: int = 0, param_dtype: Optional[torch.dtype] = None,
                  cond_cfg: Optional[ConditionerConfig] = None) -> SUPIREngine:
    cfg = cfg or SUPIRConfig()
    return SUPIREngine(cfg, build_model(cfg, device, state_dict, seed, param_dtype, cond_cfg))


def create_trainer(cfg: Optional[SUPIRConfig] = None, device="cuda",
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                   remat: bool = True, learning_rate: float = 1e-5, weight_decay: float = 0.0,
                   ema_decay: Optional[float] = 0.9999, mesh=None) -> SUPIRTrainer:
    """A SUPIRTrainer over an engine with fp32 parameters (the JAX trainer's
    default, `create_engine(param_dtype=None)`); on the card its steps
    compute in the config's `diffusion_dtype` (bf16 autocast, or fp32 with
    none). `remat` recomputes ResBlocks and SpatialTransformers in the
    backward pass. With `mesh` the state is sharded over it (every rank
    builds the same engine from the same seed or state dict, then shards).
    Raises without a card unless `device="cpu"`."""
    engine = create_engine(cfg, device, state_dict, seed, param_dtype=torch.float32)
    for name in ("diffusion_model", "control_model"):
        engine.model.model[name].remat = remat
    return SUPIRTrainer(engine, mesh, learning_rate, weight_decay, ema_decay)


def create_ae_trainer(cfg: Optional[VAEConfig] = None, device="cuda",
                      state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                      loss_cfg: AELossConfig = AELossConfig(), learning_rate: float = 4.5e-6,
                      train_branch: str = "all", perceptual_fn=None, ae_dtype: str = "fp32",
                      mesh=None) -> AETrainer:
    """An AETrainer over an fp32 AutoencoderKL with its denoise encoder
    (SDXL's VAEConfig by default) on `device`, filled from `state_dict`
    (strict; the port's AutoencoderKL keys) or randomly from `seed`; the
    discriminator is drawn from seed + 1. Its steps compute in `ae_dtype`
    (the JAX VAE's `dtype`, fp32 by default; "bf16" runs under bf16
    autocast on the card); with `mesh` its state is sharded over the mesh's
    'model' axis. Raises without a card unless `device="cpu"`."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = AutoencoderKL(cfg or VAEConfig(), dtype=torch.float32)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_random(model, torch.Generator(device=device).manual_seed(seed))
    return AETrainer(model, loss_cfg, learning_rate, train_branch=train_branch, perceptual_fn=perceptual_fn,
                     seed=seed + 1, mesh=mesh, compute_dtype=dtype_of(ae_dtype))
