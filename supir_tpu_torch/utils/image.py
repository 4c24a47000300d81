"""Image I/O and geometry on the host (counterpart of supir_tpu/utils/image.py;
behavioural contract SUPIR/util.py:60-170).

Arrays are HWC float32 in [-1, 1]. `pil_to_array`, `hwc3`, `upscale_image`
and `fix_resize` are the JAX package's PIL/cv2/numpy code, so the
round-to-64 and min-size geometry and the pixels match it bit for bit.
`array_to_pil` does `jax.image.resize(..., "bicubic")` in torch with
`captioner/vision.py:bicubic_resize`: the separable antialiased Keys-cubic
weights of `resize_weights`, applied as two matmuls.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from supir_tpu_torch.captioner.vision import bicubic_resize

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def pil_to_array(img: Image.Image, upscale: float = 1.0, min_size: int = 1024,
                 fix_resize: Optional[int] = None, gamma: float = 1.0) -> Tuple[np.ndarray, int, int]:
    """PIL -> ([H, W, 3] float32 in [-1, 1], h0, w0): resized bicubic to the
    64-rounded size that `upscale`, `min_size` and `fix_resize` give, with
    (h0, w0) the size before rounding (PIL2Tensor, SUPIR/util.py:60).
    gamma: `(x/255)**gamma` on the resized uint8 image, re-quantized (the
    reference UI's Gamma Correction, gradio_demo.py:69-71)."""
    w, h = img.size
    w *= upscale
    h *= upscale
    w0, h0 = round(w), round(h)
    if min(w, h) < min_size:
        s = min_size / min(w, h)
        w *= s
        h *= s
    if fix_resize is not None:
        s = fix_resize / min(w, h)
        w *= s
        h *= s
        w0, h0 = round(w), round(h)
    w = int(np.round(w / 64.0)) * 64
    h = int(np.round(h / 64.0)) * 64
    x = np.array(img.resize((w, h), Image.BICUBIC)).round().clip(0, 255).astype(np.uint8)
    if gamma != 1.0:
        g = np.power(x.astype(np.float32) / 255.0, gamma) * 255.0
        x = g.round().clip(0, 255).astype(np.uint8)
    return x.astype(np.float32) / 255.0 * 2.0 - 1.0, h0, w0


def array_to_pil(x, h0: Optional[int] = None, w0: Optional[int] = None) -> Image.Image:
    """[H, W, 3] in [-1, 1] (numpy or a tensor) -> PIL uint8, resized bicubic
    to (h0, w0) where they are given and differ."""
    x = torch.as_tensor(np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, np.float32))
    if h0 is not None and w0 is not None and tuple(x.shape[:2]) != (h0, w0):
        x = bicubic_resize(x, (h0, w0))
    return Image.fromarray((x.numpy() * 127.5 + 127.5).clip(0, 255).astype(np.uint8))


def hwc3(x: np.ndarray) -> np.ndarray:
    """Grayscale or RGBA uint8 -> 3 channels, alpha over white (HWC3,
    SUPIR/util.py:97)."""
    if x.dtype != np.uint8:
        raise ValueError(f"hwc3 takes uint8, got {x.dtype}")
    if x.ndim == 2:
        x = x[:, :, None]
    c = x.shape[2]
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x, x, x], axis=2)
    if c == 4:
        color = x[:, :, 0:3].astype(np.float32)
        alpha = x[:, :, 3:4].astype(np.float32) / 255.0
        return (color * alpha + 255.0 * (1.0 - alpha)).clip(0, 255).astype(np.uint8)
    raise ValueError(f"bad channel count {c}")


def upscale_image(x: np.ndarray, upscale: float, min_size: Optional[int] = None,
                  unit_resolution: int = 64) -> np.ndarray:
    """uint8 HWC upscale to a multiple of `unit_resolution` (upscale_image,
    SUPIR/util.py:116): Lanczos up, area down."""
    h, w, _ = x.shape
    hf, wf = float(h) * upscale, float(w) * upscale
    if min_size is not None and min(hf, wf) < min_size:
        s = min_size / min(wf, hf)
        wf *= s
        hf *= s
    h2 = int(np.round(hf / unit_resolution)) * unit_resolution
    w2 = int(np.round(wf / unit_resolution)) * unit_resolution
    interp = cv2.INTER_LANCZOS4 if upscale > 1 else cv2.INTER_AREA
    return cv2.resize(x, (w2, h2), interpolation=interp).round().clip(0, 255).astype(np.uint8)


def fix_resize(x: np.ndarray, size: int = 512, unit_resolution: int = 64) -> np.ndarray:
    """uint8 HWC with its short side scaled to `size`, rounded to the unit."""
    h, w, _ = x.shape
    s = size / min(h, w)
    h2 = int(np.round(h * s / unit_resolution)) * unit_resolution
    w2 = int(np.round(w * s / unit_resolution)) * unit_resolution
    interp = cv2.INTER_LANCZOS4 if s > 1 else cv2.INTER_AREA
    return cv2.resize(x, (w2, h2), interpolation=interp).round().clip(0, 255).astype(np.uint8)
