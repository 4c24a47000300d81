"""CLIP ViT vision tower for the captioner (counterpart of
supir_tpu/captioner/vision.py:24-114).

Behavioural contract: `llava/model/multimodal_encoder/clip_encoder.py`, HF
CLIP ViT-L/14-336, patch features from hidden layer -2 with the CLS token
dropped. Module names are HF's `vision_model` (`embeddings.*`,
`pre_layrnorm`, `encoder.layers.{i}`), so reference keys load as they are.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List

import numpy as np
import torch
import torch.nn as nn

from supir_tpu_torch.models.clip import CLIPBlock, CLIPTextConfig
from supir_tpu_torch.models.layers import FusedLayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    use_quick_gelu: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def tiny(self) -> "CLIPVisionConfig":
        return dataclasses.replace(self, image_size=56, patch_size=14, width=64, layers=2, heads=4)

    def as_text_cfg(self) -> CLIPTextConfig:
        return CLIPTextConfig(width=self.width, layers=self.layers, heads=self.heads,
                              use_quick_gelu=self.use_quick_gelu)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width, **kw))
        self.patch_embedding = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False, **kw)
        self.position_embedding = nn.Embedding(1 + cfg.num_patches, cfg.width, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 1 + patches, width]."""
        w = self.patch_embedding.weight
        patches = self.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(w.dtype))
        patches = patches.flatten(2).transpose(1, 2)  # row-major patch order, as NHWC
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight[None, : x.shape[1]]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPBlock(cfg.as_text_cfg(), device=device, dtype=dtype) for _ in range(cfg.layers))


class CLIPVisionTower(nn.Module):
    """Returns every hidden state; the caller selects layer -2's patches."""

    def __init__(self, cfg: CLIPVisionConfig, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPVisionEmbeddings(cfg, device=device, dtype=dtype)
        self.pre_layrnorm = FusedLayerNorm(cfg.width, eps=1e-5, device=device, dtype=dtype)  # HF's spelling
        self.encoder = CLIPEncoder(cfg, device=device, dtype=dtype)

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        """pixel_values: [B, H, W, 3], CLIP-normalised."""
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        hidden = [x]
        for block in self.encoder.layers:
            x = block(x)
            hidden.append(x)
        return hidden


def select_patch_features(hidden: List[torch.Tensor], layer: int = -2) -> torch.Tensor:
    """Hidden layer -2, CLS dropped (LLaVA's default feature_select)."""
    return hidden[layer][:, 1:]


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


@lru_cache(maxsize=16)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 weights of a bicubic resize along one axis, built as
    `jax.image.scale_and_translate` builds them (jax/_src/image/scale.py,
    compute_weight_mat): half-pixel centres, the kernel widened by the
    downscale factor (antialiasing), columns normalised to sum to one."""
    f32 = np.float32
    inv_scale = f32(in_size / out_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps), w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0).astype(f32)
    w.setflags(write=False)
    return w


def bicubic_resize(img: torch.Tensor, size) -> torch.Tensor:
    """[H, W, C] float32 -> [size, size, C], or [h, w, C] for size (h, w),
    as jax.image.resize(..., "bicubic"): two matmuls with the separable
    weights, on img's device."""
    h, w, _ = img.shape
    oh, ow = (size, size) if isinstance(size, int) else size
    out = img
    if h != oh:
        out = torch.einsum("hwc,ho->owc", out, torch.tensor(resize_weights(h, oh), device=img.device))
    if w != ow:
        out = torch.einsum("hwc,wo->hoc", out, torch.tensor(resize_weights(w, ow), device=img.device))
    return out


def preprocess_images(images, image_size: int, pad_to_square: bool = True, device="cpu") -> torch.Tensor:
    """uint8 HWC images -> [B, S, S, 3] CLIP-normalised float32 on `device`:
    `expand2square` padding with the mean colour, then bicubic resize
    (llava/mm_utils.py:14-41). Each image crosses to the device as uint8 and
    is padded, resized and normalised there."""
    mean = torch.from_numpy(CLIP_IMAGE_MEAN).to(device)
    std = torch.from_numpy(CLIP_IMAGE_STD).to(device)
    out = []
    for img in images:
        arr = torch.from_numpy(np.array(img, np.uint8)).to(device).float() / 255.0
        h, w, _ = arr.shape
        if pad_to_square and h != w:
            side = max(h, w)
            canvas = mean.expand(side, side, 3).clone()
            y0, x0 = (side - h) // 2, (side - w) // 2
            canvas[y0: y0 + h, x0: x0 + w] = arr
            arr = canvas
        out.append((bicubic_resize(arr, image_size) - mean) / std)
    return torch.stack(out)
