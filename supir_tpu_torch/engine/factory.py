"""Engine and trainer construction: random init from a seed, or a given
state dict (counterpart of supir_tpu/engine/factory.py).

The modules are built on the meta device and materialised directly on the
target device in the target dtype, so a full-width engine never exists as
an fp32 copy on the host (~14 GB). Random init follows `init_params`:
convs and linears draw N(0, 1/fan_in) (flax's lecun_normal variance),
biases are zero, norms are (1, 0), and zero-initialised layers stay zero.
Every draw comes from one `torch.Generator` on the target device.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from supir_tpu_torch.config import SUPIRConfig
from supir_tpu_torch.engine.supir import SUPIREngine, SUPIRModel
from supir_tpu_torch.engine.training import SUPIRTrainer
from supir_tpu_torch.models.layers import Conv, Dense, FusedLayerNorm, GroupNorm32
from supir_tpu_torch.utils.device import resolve_device


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


def build_model(cfg: SUPIRConfig, device, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0, param_dtype: Optional[torch.dtype] = None) -> SUPIRModel:
    """SUPIRModel on `device`: filled from `state_dict` (strict) or, when
    none is given, randomly from `seed`; every parameter in `param_dtype`
    if given, else in the config's dtypes."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = SUPIRModel(cfg, param_dtype=param_dtype)
    model = model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_random(model, torch.Generator(device=device).manual_seed(seed))
    return model


def create_engine(cfg: Optional[SUPIRConfig] = None, device="cuda",
                  state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                  seed: int = 0, param_dtype: Optional[torch.dtype] = None) -> SUPIREngine:
    cfg = cfg or SUPIRConfig()
    return SUPIREngine(cfg, build_model(cfg, device, state_dict, seed, param_dtype))


def create_trainer(cfg: Optional[SUPIRConfig] = None, device="cuda",
                   state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                   remat: bool = True, learning_rate: float = 1e-5, weight_decay: float = 0.0,
                   ema_decay: Optional[float] = 0.9999) -> SUPIRTrainer:
    """A SUPIRTrainer over an engine with fp32 parameters (the JAX trainer's
    default, `create_engine(param_dtype=None)`); on the card its steps run
    under bf16 autocast. `remat` recomputes ResBlocks and
    SpatialTransformers in the backward pass. Raises without a card unless
    `device="cpu"`."""
    engine = create_engine(cfg, device, state_dict, seed, param_dtype=torch.float32)
    for name in ("diffusion_model", "control_model"):
        engine.model.model[name].remat = remat
    return SUPIRTrainer(engine, learning_rate, weight_decay, ema_decay)
