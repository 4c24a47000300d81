"""Checkpoint loading: reference SDXL and SUPIR files into the port's model
(counterpart of supir_tpu/utils/ckpt.py:load_torch_file, :450, and
load_supir_checkpoint, :464-487).

The port's modules carry the reference's state-dict keys, so no conversion
is needed: the files are read, merged as the reference merges them
(SUPIR/util.py:34-51: SDXL base, then SUPIR-v0Q/F over it, later keys
winning), each denoise-encoder key the files lack is taken from the plain
encoder (SUPIR_model.py:17 deep-copies it at init), and the result
loads into `SUPIRModel` with every one of its keys required. Keys the model
does not hold are listed in the report, not loaded.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from supir_tpu_torch.config import ConditionerConfig, SUPIRConfig
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.engine.supir import SUPIREngine, SUPIRModel
from supir_tpu_torch.utils.weights import ConversionReport

ENCODER_PREFIX = "first_stage_model.encoder."
DENOISE_PREFIX = "first_stage_model.denoise_encoder."


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file, or a torch `.ckpt`/`.pt`/`.bin` with its
    `state_dict` unwrapped (reference SUPIR/util.py:15-24), as CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path, device="cpu"))
    # Lightning checkpoints hold more than tensors; the reference loads them whole
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v if torch.is_tensor(v) else torch.as_tensor(v) for k, v in sd.items()}


def load_supir_checkpoint(cfg: SUPIRConfig, sdxl_path: str, supir_path: Optional[str] = None,
                          cond_cfg: Optional[ConditionerConfig] = ConditionerConfig(), device="cuda",
                          param_dtype: Optional[torch.dtype] = None) -> Tuple[SUPIREngine, ConversionReport]:
    """The SDXL file with the SUPIR file over it, each denoise-encoder key
    the files lack taken from the encoder ->
    (engine on `device`, report). The engine holds the text
    conditioner where `cond_cfg` is given (the reference model always
    does); its parameters take the config's dtypes, or `param_dtype`.
    report.filled counts the keys loaded, report.unused lists the files'
    keys the model does not hold. A key the model holds and the files lack
    raises KeyError."""
    sd = load_torch_file(sdxl_path)
    if supir_path:
        sd.update(load_torch_file(supir_path))
    for k in [k for k in sd if k.startswith(ENCODER_PREFIX)]:
        sd.setdefault(DENOISE_PREFIX + k[len(ENCODER_PREFIX):], sd[k])
    with torch.device("meta"):
        held = SUPIRModel(cfg, param_dtype=param_dtype, cond_cfg=cond_cfg).state_dict()
    missing = sorted(k for k in held if k not in sd)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the model's {len(held)} keys; "
                       f"first: {missing[:5]}")
    report = ConversionReport(filled=len(held), unused=sorted(k for k in sd if k not in held))
    engine = create_engine(cfg, device, state_dict={k: sd[k] for k in held}, param_dtype=param_dtype,
                           cond_cfg=cond_cfg)
    return engine, report
