"""ParseNet face parser (counterpart of supir_tpu/models/parsenet.py; the
reference's facexlib `parsenet`), NCHW.

The modules hold facexlib's state-dict keys (`encoder.0.conv2d.weight`,
`body.3.preact_func.0.norm.running_var`, `decoder.1.conv1.norm.norm.bias`,
`out_mask_conv.conv2d.bias`, ...), so a facexlib checkpoint loads with
`strict=True` (`utils/face_ckpt.py`). The arithmetic is the JAX module's:
an encoder of stride-2 pre-activation residual blocks, a body of
`res_depth` blocks, a decoder of nearest 2x-up blocks (channels clipped to
[32, 256]), reflection padding, LeakyReLU(0.2), BatchNorm on running
statistics; two heads, a 19-class map and an RGB reconstruction.

`FaceParser.parse_mask` is the reference's paste mask
(face_restoration_helper.py:448-470): [-1, 1] RGB in, argmax over the 19
classes, MASK_COLORMAP, two 101-tap sigma-11 Gaussian blurs, 10-px zeroed
borders, / 255, all on the model's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.models.layers import FrozenBatchNorm, init_conv_random, nearest_upsample_2x
from supir_tpu_torch.ops.resize import bilinear_resize, gaussian_blur
from supir_tpu_torch.utils.device import resolve_device


class _Norm(nn.Module):
    """facexlib's NormLayer: the BatchNorm under `.norm`."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = FrozenBatchNorm(channels)

    def forward(self, x):
        return self.norm(x)


class PConv(nn.Module):
    """facexlib's ConvLayer: optional nearest 2x up or stride-2 down,
    reflection padding, conv (biased unless normed), optional BatchNorm,
    optional LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, scale: str = "none", norm: bool = False,
                 act: bool = False):
        super().__init__()
        self.scale, self.act = scale, act
        self.pad = (kernel - 1) // 2
        self.conv2d = nn.Conv2d(cin, cout, kernel, stride=2 if scale == "down" else 1, bias=not norm)
        self.norm = _Norm(cout) if norm else None

    def forward(self, x):
        if self.scale == "up":
            x = nearest_upsample_2x(x)
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        x = self.conv2d(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.leaky_relu(x, 0.2) if self.act else x


class PResBlock(nn.Module):
    """Pre-activation residual block with optional down/up scaling; a conv
    shortcut wherever the shape changes."""

    def __init__(self, c_in: int, c_out: int, scale: str = "none"):
        super().__init__()
        self.shortcut_func = (None if scale == "none" and c_in == c_out
                              else PConv(c_in, c_out, 3, scale=scale))
        s1, s2 = {"down": ("none", "down"), "up": ("up", "none"), "none": ("none", "none")}[scale]
        self.preact_func = nn.Sequential(_Norm(c_in))
        self.conv1 = PConv(c_in, c_out, 3, scale=s1, norm=True, act=True)
        self.conv2 = PConv(c_out, c_out, 3, scale=s2)

    def forward(self, x):
        identity = x if self.shortcut_func is None else self.shortcut_func(x)
        h = F.leaky_relu(self.preact_func(x), 0.2)
        return identity + self.conv2(self.conv1(h))


def _clip(c: int, lo: int = 32, hi: int = 256) -> int:
    return max(lo, min(c, hi))


class ParseNet(nn.Module):
    """x [B, 3, in_size, in_size] in [-1, 1] -> (19-class logits, RGB), fp32."""

    def __init__(self, in_size: int = 512, min_feat_size: int = 32, base_ch: int = 64, parsing_ch: int = 19,
                 res_depth: int = 10, device=None):
        super().__init__()
        down_steps = int(math.log2(in_size // min_feat_size))
        ch = base_ch
        encoder = [PConv(3, base_ch, 3)]
        for _ in range(down_steps):
            encoder.append(PResBlock(_clip(ch), _clip(ch * 2), scale="down"))
            ch *= 2
        self.encoder = nn.ModuleList(encoder)
        self.body = nn.ModuleList(PResBlock(_clip(ch), _clip(ch)) for _ in range(res_depth))
        decoder = []
        for _ in range(down_steps):
            decoder.append(PResBlock(_clip(ch), _clip(ch // 2), scale="up"))
            ch //= 2
        self.decoder = nn.ModuleList(decoder)
        self.out_img_conv = PConv(_clip(ch), 3, 3)
        self.out_mask_conv = PConv(_clip(ch), parsing_ch, 3)
        if device is not None:
            self.to(device)

    def forward(self, x):
        for m in self.encoder:
            x = m(x)
        feat = x
        for m in self.body:
            x = m(x)
        x = feat + x
        for m in self.decoder:
            x = m(x)
        return self.out_mask_conv(x).float(), self.out_img_conv(x).float()


class FaceParser:
    """parse_mask(face_bgr) -> [in_size, in_size] soft paste mask in [0, 1],
    on the model's device."""

    MASK_COLORMAP = np.array([0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                              0, 255, 0, 0, 0], np.float32)

    def __init__(self, model: ParseNet, in_size: int = 512):
        self.model = model.eval()
        self.in_size = in_size
        self.device = next(model.parameters()).device
        self._colormap = torch.from_numpy(self.MASK_COLORMAP).to(self.device)

    @classmethod
    def create(cls, seed: int = 0, in_size: int = 512, res_depth: int = 10, device="cuda"):
        """Random weights from `seed`; facexlib weights load through
        `utils/face_ckpt.py:load_parsenet`."""
        model = ParseNet(in_size=in_size, res_depth=res_depth, device=resolve_device(device))
        return cls(init_conv_random(model, seed), in_size)

    @classmethod
    def from_state_dict(cls, state_dict, in_size: int = 512, res_depth: int = 10, device="cuda"):
        model = ParseNet(in_size=in_size, res_depth=res_depth, device=resolve_device(device))
        model.load_state_dict(state_dict, strict=True)
        return cls(model, in_size)

    @torch.no_grad()
    def logits(self, face_bgr) -> torch.Tensor:
        """HWC BGR in 0-255 (numpy or a tensor) -> [19, in_size, in_size] fp32."""
        face = torch.as_tensor(face_bgr if torch.is_tensor(face_bgr) else np.ascontiguousarray(face_bgr, np.float32),
                               dtype=torch.float32).to(self.device) / 255.0
        face = (face.flip(-1) - 0.5) / 0.5  # BGR -> RGB, [-1, 1]
        face = face.permute(2, 0, 1)[None]
        if face.shape[2] != self.in_size or face.shape[3] != self.in_size:
            face = bilinear_resize(face, (self.in_size, self.in_size))
        return self.model(face)[0][0]

    def mask_from_classes(self, classes: torch.Tensor) -> torch.Tensor:
        """[H, W] class map -> the blurred, border-zeroed mask in [0, 1]."""
        mask = self._colormap[classes.to(self.device).long()][None, :, :, None]
        mask = gaussian_blur(gaussian_blur(mask, 101, 11.0), 101, 11.0)[0, :, :, 0].clone()
        thres = 10
        mask[:thres, :] = 0
        mask[-thres:, :] = 0
        mask[:, :thres] = 0
        mask[:, -thres:] = 0
        return mask / 255.0

    def parse_mask(self, face_bgr) -> torch.Tensor:
        return self.mask_from_classes(self.logits(face_bgr).argmax(dim=0))
