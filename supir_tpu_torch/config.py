"""Configuration: the JAX package's JAX-free dataclasses, plus the port's own
map from dtype name to torch dtype (`supir_tpu.config.dtype_of` imports jax)."""

from __future__ import annotations

import torch

from supir_tpu.config import (  # noqa: F401  (re-exported)
    ControlConfig,
    SamplerConfig,
    SUPIRConfig,
    UNetConfig,
    VAEConfig,
)

_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]
