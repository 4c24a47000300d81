"""The weight bridge: JAX parameter trees -> the port's state dict.

`state_dict_from_jax(params_np, cfg)` walks the JAX package's checkpoint
rule tables (`supir_tpu/utils/ckpt.py`: light_glv_unet_rules :209,
glv_control_rules :228, vae_rules :314) backwards: every rule names a
reference torch key, a flax leaf path and a transform, and the inverse
transform turns the leaf into the torch tensor:

  linear  [in, out] -> [out, in]
  conv    HWIO -> OIHW
  other   as is (norm scale -> weight, biases)

The keys are the reference's (`model.diffusion_model.*`,
`model.control_model.*`, `first_stage_model.*`), so the result loads into
`SUPIRModel` with `strict=True`, and so will a real SDXL/SUPIR checkpoint.

The rule helpers of `supir_tpu.utils.ckpt` import only numpy and
`supir_tpu.config`. Its two top-level UNet tables import the flax models
for their adapter list, so they are rebuilt here from the same helpers and
the port's own `_build_adapter_specs` / `encoder_feature_channels`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from supir_tpu.utils import ckpt as C
from supir_tpu_torch.config import ControlConfig, SUPIRConfig, UNetConfig
from supir_tpu_torch.models.control import _build_adapter_specs
from supir_tpu_torch.models.unet import encoder_feature_channels


def light_glv_unet_rules(cfg: UNetConfig, ctrl: ControlConfig) -> List[C.Rule]:
    """model.diffusion_model.* -> params['unet'] (as ckpt.py:209)."""
    tk = "model.diffusion_model."
    rules = C._time_embed(tk, (), with_label=cfg.adm_in_channels is not None)
    rules += C.unet_encoder_rules(cfg, tk, ("enc",))
    rules += C.unet_decoder_rules(cfg, tk, (), encoder_feature_channels(cfg))
    for pos, (kind, _) in enumerate(_build_adapter_specs(ctrl)):
        base = f"{tk}project_modules.{pos}"
        if kind == "sft":
            rules += C.zero_sft_rules(base, (f"proj_{pos}",))
        else:
            rules += C.zero_xattn_rules(base, (f"proj_{pos}",))
    return rules


def supir_rules(cfg: SUPIRConfig) -> Dict[str, List[C.Rule]]:
    """The rule table of each parameter branch of the restore path."""
    return {
        "unet": light_glv_unet_rules(cfg.unet, cfg.control),
        "control": C.glv_control_rules(cfg.unet),
        "vae": C.vae_rules(cfg.vae),
    }


def _leaf(tree: Mapping[str, Any], path) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node)


def _to_torch(kind, v: np.ndarray) -> np.ndarray:
    if kind == "linear":
        return np.transpose(v, (1, 0))
    if kind == "conv":
        return np.transpose(v, (3, 2, 0, 1))
    if kind is None:
        return v
    raise ValueError(f"rule kind {kind!r} has no place on the restore path")


def state_dict_from_rules(tree: Mapping[str, Any], rules: List[C.Rule]) -> Dict[str, torch.Tensor]:
    return {
        tkey: torch.from_numpy(np.ascontiguousarray(_to_torch(kind, _leaf(tree, fpath)), np.float32))
        for tkey, fpath, kind in rules
    }


def state_dict_from_jax(params_np: Mapping[str, Any], cfg: SUPIRConfig) -> Dict[str, torch.Tensor]:
    """{'unet', 'control', 'vae'} parameter trees (numpy or array leaves) ->
    fp32 CPU tensors under the reference torch keys."""
    sd: Dict[str, torch.Tensor] = {}
    for branch, rules in supir_rules(cfg).items():
        sd.update(state_dict_from_rules(params_np[branch], rules))
    return sd
