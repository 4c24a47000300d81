"""Image quality metrics for the eval app (counterpart of
supir_tpu/utils/metrics.py): PSNR, SSIM and LPIPS on torch tensors, on
the tensors' device.

Images are [B, H, W, C] in [-1, 1], as the JAX functions take them; each
metric returns one value per image. SSIM is the Gaussian-window SSIM
(11x11, sigma 1.5, valid positions only). LPIPS is the reference's
perceptual net (`sgm/modules/autoencoding/lpips/loss/lpips.py`): the
VGG16 trunk written out here (torchvision is not needed) under
torchvision's `features.{i}` indices, unit-normalized channel differences
at relu1_2 ... relu5_3, learned non-negative 1x1 weightings
(`lin{i}.model.1.weight`, the taming `vgg.pth` keys), spatial mean, sum.
Its weights come from a torchvision vgg16 state dict and the `vgg.pth`
heads through `convert_lpips_state`, or from a state-dict file of the
port's keys (`load_lpips_params`); without them `lpips_available()` is
False and the eval app scores PSNR/SSIM only.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.utils.device import resolve_device


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """[B, H, W, C] in [-1, 1] by default -> per-image PSNR in dB."""
    mse = ((a - b) ** 2).mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / mse.clamp_min(1e-12))


def _ssim_window(device) -> torch.Tensor:
    r = np.arange(11) - 5
    g = np.exp(-(r ** 2) / (2 * 1.5 ** 2))
    g = (g / g.sum()).astype(np.float32)
    return torch.from_numpy(np.outer(g, g)).to(device)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Gaussian-window SSIM (11x11, sigma 1.5) per image, over the valid
    positions and the channels."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    c = a.shape[-1]
    kern = _ssim_window(a.device).to(a.dtype).expand(c, 1, 11, 11)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    saa = filt(a * a) - mu_a ** 2
    sbb = filt(b * b) - mu_b ** 2
    sab = filt(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2))
    return s.mean(dim=(1, 2, 3))


# --------------------------------------------------------------------------
# LPIPS (VGG16 slices + learned linear heads)

VGG_SLICES = (2, 2, 3, 3, 3)  # conv counts per slice (vgg16 relu1_2..relu5_3)
VGG_CHANNELS = (64, 128, 256, 512, 512)
# torchvision vgg16 `features` indices of the 13 convs; the slices end at
# relu 3, 8, 15, 22, 29 with max pools at 4, 9, 16, 23 (lpips.py:109-119)
VGG_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_SLICE_ENDS = (3, 8, 15, 22, 29)
_POOLS = (4, 9, 16, 23)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """torchvision's vgg16 `features[:30]` (conv, ReLU, max pool at its
    indices) emitting the 5 LPIPS slices, NCHW."""

    def __init__(self):
        super().__init__()
        chans = iter(ch for n, ch in zip(VGG_SLICES, VGG_CHANNELS) for _ in range(n))
        layers, cin = [], 3
        for i in range(30):
            if i in VGG_TORCH_CONV_IDX:
                cout = next(chans)
                layers.append(nn.Conv2d(cin, cout, 3, padding=1))
                cin = cout
            elif i in _POOLS:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in _SLICE_ENDS:
                feats.append(x)
        return feats


class _Lin(nn.Module):
    """The taming head `lin{i}`: dropout (inactive at inference) + a 1x1
    conv without bias, key `model.1.weight` [1, C, 1, 1]."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(nn.Module):
    """Perceptual distance of a and b [B, H, W, 3] in [-1, 1]:
    sum_l mean_hw(sum_c max(w_l, 0) * (norm(f_l(a)) - norm(f_l(b)))^2)."""

    def __init__(self, device=None):
        super().__init__()
        self.vgg = VGG16Features()
        for i, ch in enumerate(VGG_CHANNELS):
            setattr(self, f"lin{i}", _Lin(ch))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1), persistent=False)
        if device is not None:
            self.to(device)

    def forward(self, a, b):
        fa = self.vgg((a.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fb = self.vgg((b.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.linalg.vector_norm(xa, dim=1, keepdim=True).clamp_min(1e-10)
            nb = xb / torch.linalg.vector_norm(xb, dim=1, keepdim=True).clamp_min(1e-10)
            w = getattr(self, f"lin{i}").model[1].weight.clamp_min(0.0)  # [1, C, 1, 1]
            total = total + ((na - nb) ** 2 * w).sum(dim=1).mean(dim=(1, 2))
        return total


_lpips_model: Optional[LPIPS] = None


def convert_lpips_state(vgg_sd: Mapping[str, torch.Tensor],
                        lin_sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """(torchvision vgg16 state dict, taming `vgg.pth` heads) -> LPIPS's
    state dict (lpips.py:16-31: `vgg16(pretrained=True)` + the heads'
    lin{0..4}.model.1.weight). A missing key raises KeyError;
    classifier.* and scaling_layer.* extras are ignored."""
    sd: Dict[str, torch.Tensor] = {}
    for t in VGG_TORCH_CONV_IDX:
        for part in ("weight", "bias"):
            sd[f"vgg.features.{t}.{part}"] = torch.as_tensor(np.asarray(vgg_sd[f"features.{t}.{part}"], np.float32))
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        sd[key] = torch.as_tensor(np.asarray(lin_sd[key], np.float32))
    return sd


def load_lpips_state(state_dict: Mapping[str, torch.Tensor], device="cuda") -> LPIPS:
    """Make LPIPS with these weights (strict) the module's, on `device`."""
    global _lpips_model
    model = LPIPS(device=resolve_device(device))
    model.load_state_dict(state_dict, strict=True)
    _lpips_model = model.eval()
    return _lpips_model


def load_lpips_from_torch(vgg_path: str, lin_path: str, device="cuda") -> LPIPS:
    """LPIPS from the reference's own sources: a torchvision vgg16
    checkpoint and the taming `vgg.pth` heads."""
    from supir_tpu_torch.utils.ckpt import load_torch_file

    return load_lpips_state(convert_lpips_state(load_torch_file(vgg_path), load_torch_file(lin_path)), device)


def load_lpips_params(path: str, device="cuda") -> LPIPS:
    """LPIPS from a state-dict file of the port's keys (`.safetensors`,
    `.pt`), as `convert_lpips_state` writes them."""
    from supir_tpu_torch.utils.ckpt import load_torch_file

    return load_lpips_state(load_torch_file(path), device)


def lpips_available() -> bool:
    return _lpips_model is not None


@torch.no_grad()
def lpips(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-image LPIPS of a and b [B, H, W, 3] in [-1, 1], on the loaded
    model's device."""
    if _lpips_model is None:
        raise RuntimeError("LPIPS weights not loaded; call load_lpips_params")
    dev = next(_lpips_model.parameters()).device
    return _lpips_model(a.to(dev, torch.float32), b.to(dev, torch.float32))
