"""Where an entry point runs: the card unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); asking for CUDA where there is none raises, so
    nothing falls back to the CPU quietly."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device
