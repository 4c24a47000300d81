"""Captioner checkpoints: an HF llava-v1.5 directory into the port's
`LlavaForCausalLM` (counterpart of supir_tpu/captioner/convert.py:
convert_captioner_state_dict, :75, and load_captioner_checkpoint, :88).

The port's model carries HF's keys, so conversion is a check: the keys the
JAX converter leaves unused and the port's tree does not hold go
(`utils/weights.py:convert_llava_state_dict`), every key of the model must
be present, and any other key of the files is reported as unused.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from supir_tpu_torch.utils.ckpt import load_torch_file
from supir_tpu_torch.utils.weights import ConversionReport, convert_llava_state_dict


class CaptionerCheckpointError(RuntimeError):
    """No captioner checkpoint where one was asked for, or an incomplete one.
    The batch CLI proceeds without a caption on this error alone."""


def convert_captioner_state_dict(torch_sd: Dict[str, torch.Tensor], cfg) -> Tuple[Dict[str, torch.Tensor],
                                                                                  ConversionReport]:
    """An HF LLaVA state dict -> (the model's keys only, report) for
    `LlavaForCausalLM(cfg)` (cfg: a CaptionerConfig, unquantized):
    report.missing lists the model's keys the dict lacks, report.unused the
    dict's keys the model does not hold (the dropped reference keys too)."""
    from supir_tpu_torch.captioner.agent import LlavaForCausalLM

    sd, report = convert_llava_state_dict(torch_sd, cfg)
    with torch.device("meta"):
        held = LlavaForCausalLM(cfg).state_dict()
    report.missing = sorted(k for k in held if k not in sd)
    report.unused = sorted(report.unused + [k for k in sd if k not in held])
    out = {k: sd[k] for k in held if k in sd}
    report.filled = len(out)
    return out, report


def load_captioner_checkpoint(path_or_dir: str, cfg) -> Tuple[Dict[str, torch.Tensor], ConversionReport]:
    """Every `*.safetensors` / `*.bin` of a directory (or one file), merged
    in name order, then convert_captioner_state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    if os.path.isdir(path_or_dir):
        for f in sorted(os.listdir(path_or_dir)):
            if f.endswith((".safetensors", ".bin")):
                sd.update(load_torch_file(os.path.join(path_or_dir, f)))
    else:
        sd = load_torch_file(path_or_dir)
    return convert_captioner_state_dict(sd, cfg)
