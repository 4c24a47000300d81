"""Converted-checkpoint cache and state-dict files (counterpart of
supir_tpu/utils/checkpoint.py, which keeps orbax checkpoints).

The reference re-reads and merges its torch files on every model build
(SUPIR/util.py:34-51) and keeps both the Q and F state dicts in host RAM to
swap them at run time (gradio_demo.py:52, 99-107). Here a checkpoint is
merged once (`load_supir_checkpoint`: SDXL, then the SUPIR file over it,
the denoise encoder filled) into the model's state dict in its parameter
dtypes, and written as one `.safetensors` file; later calls read that
file. A swap loads such a state dict into the engine's modules.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

from supir_tpu_torch.config import ConditionerConfig


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a state dict as one safetensors file (host copies, contiguous)."""
    from safetensors.torch import save_file

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".part"
    save_file({k: v.detach().to("cpu").contiguous() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def load_params(path: str, target: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """Read a state dict written by save_params, as CPU tensors. With a
    `target` (a state dict or its meta copy), its keys, shapes and dtypes
    must be the file's, else ValueError."""
    from safetensors.torch import load_file

    sd = load_file(path, device="cpu")
    if target is not None:
        bad = sorted(set(sd) ^ set(target))
        bad += [k for k in sd if k in target and (sd[k].shape != target[k].shape or sd[k].dtype != target[k].dtype)]
        if bad:
            raise ValueError(f"{path} does not match the target: {len(bad)} keys differ, first {bad[:5]}")
    return sd


def convert_and_cache(cfg, sdxl_path: str, supir_path: Optional[str], cache_dir: str, sign: str = "Q",
                      cond_cfg: Optional[ConditionerConfig] = ConditionerConfig(),
                      param_dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """The reference checkpoint files -> the model's state dict on the host.
    The first call merges them through `load_supir_checkpoint` (on the
    CPU: the result is a host copy, not a model to run) and writes
    `<cache_dir>/supir_<sign>.safetensors`; later calls read that file."""
    cache = os.path.join(cache_dir, f"supir_{sign}.safetensors")
    if os.path.exists(cache):
        return load_params(cache)
    from supir_tpu_torch.utils.ckpt import load_supir_checkpoint

    engine, report = load_supir_checkpoint(cfg, sdxl_path, supir_path, cond_cfg, "cpu", param_dtype)
    print(f"converted ({report.summary()}); caching to {cache}")
    sd = engine.model.state_dict()
    save_params(cache, sd)
    return sd
