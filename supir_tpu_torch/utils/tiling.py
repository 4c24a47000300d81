"""Tiling geometry for tiled diffusion and the tiled VAE, in numpy (the
port's own copy of supir_tpu/utils/tiling.py: importing that module would
pull in jax through its package __init__). The results equal the JAX
package's exactly.

All geometry is computed on the host from static shapes. `sliding_windows`
and `gaussian_weights` follow the reference's tiled sampler
(`sgm/modules/diffusionmodules/sampling.py:733-766`); the VAE tile plan
follows the padded-tile geometry of `SUPIR/utils/tilevae.py:686-760`.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def sliding_windows(h: int, w: int, tile_size: int, tile_stride: int) -> List[Tuple[int, int, int, int]]:
    """(hi, hi_end, wi, wi_end) tile coordinates covering an h x w canvas:
    tiles start every `tile_stride`, plus a last tile flush with the edge
    where the stride does not land on it."""
    hi_list = list(range(0, h - tile_size + 1, tile_stride))
    if (h - tile_size) % tile_stride != 0:
        hi_list.append(h - tile_size)
    wi_list = list(range(0, w - tile_size + 1, tile_stride))
    if (w - tile_size) % tile_stride != 0:
        wi_list.append(w - tile_size)
    return [(hi, hi + tile_size, wi, wi + tile_size) for hi in hi_list for wi in wi_list]


def gaussian_weights(tile_width: int, tile_height: int) -> np.ndarray:
    """[tile_height, tile_width] float32 Gaussian blend weights (the
    reference's asymmetric midpoints: (w-1)/2 in x, h/2 in y)."""
    var = 0.01
    mid_x = (tile_width - 1) / 2
    x_probs = np.array([
        math.exp(-(x - mid_x) ** 2 / (tile_width * tile_width) / (2 * var)) / math.sqrt(2 * math.pi * var)
        for x in range(tile_width)
    ])
    mid_y = tile_height / 2
    y_probs = np.array([
        math.exp(-(y - mid_y) ** 2 / (tile_height * tile_height) / (2 * var)) / math.sqrt(2 * math.pi * var)
        for y in range(tile_height)
    ])
    return np.outer(y_probs, x_probs).astype(np.float32)


def vae_tile_grid(h: int, w: int, tile_size: int, pad: int
                  ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(rows, cols): the (start, end) of each tile's valid region along each
    axis; ceil(size / tile_size) tiles, one fewer where the last would be
    under half a tile."""

    def split(length: int) -> List[Tuple[int, int]]:
        num = math.ceil(length / tile_size)
        if num > 1 and length - (num - 1) * tile_size < tile_size // 2:
            num -= 1
        size = math.ceil(length / num)
        return [(i * size, min((i + 1) * size, length)) for i in range(num)]

    return split(h), split(w)


def padded_bbox(start: int, end: int, pad: int, limit: int) -> Tuple[int, int]:
    """A valid region extended by `pad` on each side, clamped to [0, limit]."""
    return max(0, start - pad), min(limit, end + pad)


def plan_vae_tiles(h: int, w: int, tile_size: int, pad: int):
    """Each tile's padded input box, its valid box, and the valid box
    relative to the padded tile."""
    rows, cols = vae_tile_grid(h, w, tile_size, pad)
    tiles = []
    for (r0, r1) in rows:
        for (c0, c1) in cols:
            pr0, pr1 = padded_bbox(r0, r1, pad, h)
            pc0, pc1 = padded_bbox(c0, c1, pad, w)
            tiles.append(dict(
                in_bbox=(pr0, pr1, pc0, pc1),
                valid_bbox=(r0, r1, c0, c1),
                rel_bbox=(r0 - pr0, r1 - pr0, c0 - pc0, c1 - pc0),
            ))
    return tiles
