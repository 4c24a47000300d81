"""Tiled diffusion sampling (counterpart of supir_tpu/parallel/tiled_sampler.py,
without its mesh and its feature cache), NCHW.

At every step each sliding-window latent tile is denoised with its own
slice of the control latent (and, with local prompts, its own text
conditioning), then the tiles are blended back with Gaussian weights
(reference TiledRestoreEDMSampler and TiledRestoreDPMPP2MSampler,
sampling.py:600-730). The reference denoises one tile after another; here
all tiles go through the network as one batch (tile axis folded into the
batch: with CFG's two halves, 2*T*B), or `tile_chunk` tiles at a time. The
blend accumulates in fp32 on the latent's device and is divided by the
weight sum, which does not depend on the step and is computed once.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from supir_tpu_torch.diffusion import samplers as S
from supir_tpu_torch.diffusion.samplers import StepTables
from supir_tpu_torch.utils.tiling import gaussian_weights, sliding_windows


def make_tile_plan(h: int, w: int, tile_size: int, tile_stride: int):
    """(starts [T, 2] int32, weights [ts, ts] fp32, count [h, w] fp32): each
    tile's top-left corner, the blend weights and their sum over the tiles
    at every latent pixel (the blend's normaliser)."""
    coords = sliding_windows(h, w, tile_size, tile_stride)
    weights = gaussian_weights(tile_size, tile_size)
    starts = np.asarray([(hi, wi) for (hi, _he, wi, _we) in coords], np.int32)
    count = np.zeros((h, w), np.float32)
    for (hi, he, wi, we) in coords:
        count[hi:he, wi:we] += weights
    return starts, weights, count


def _gather_tiles(x: torch.Tensor, starts, ts: int) -> torch.Tensor:
    """x [B, C, H, W] -> [T, B, C, ts, ts]."""
    return torch.stack([x[:, :, int(hi):int(hi) + ts, int(wi):int(wi) + ts] for hi, wi in starts])


def _scatter_tiles(tiles: torch.Tensor, starts, shape, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of tiles [T, B, C, ts, ts] into an fp32 [B, C, H, W]."""
    out = torch.zeros(shape, dtype=torch.float32, device=tiles.device)
    ts = tiles.shape[-1]
    for tile, (hi, wi) in zip(tiles, starts):
        out[:, :, int(hi):int(hi) + ts, int(wi):int(wi) + ts] += tile.float() * weights
    return out


class _Blend:
    """A tile plan on the latent's device: gather, and the normalised blend."""

    def __init__(self, x: torch.Tensor, tile_size: int, tile_stride: int):
        starts, weights, count = make_tile_plan(x.shape[2], x.shape[3], tile_size, tile_stride)
        self.starts, self.ts, self.shape = starts, tile_size, tuple(x.shape)
        self.weights = torch.from_numpy(weights).to(x.device)
        self.count = torch.from_numpy(count).to(x.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _gather_tiles(x, self.starts, self.ts)

    def __call__(self, tiles: torch.Tensor) -> torch.Tensor:
        return _scatter_tiles(tiles, self.starts, self.shape, self.weights) / self.count


def tiled_restore_edm_sample(
    denoise_tile: Callable,
    x: torch.Tensor,
    generator: torch.Generator,
    tables: StepTables,
    x_center: torch.Tensor,
    control_tiles: torch.Tensor,
    tile_size: int,
    tile_stride: int,
    s_noise: float = 1.003,
    crossattn_tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RestoreEDM over sliding-window tiles of x [B, C, H, W] (fp32).

    denoise_tile(x_tiles [T,B,C,ts,ts], sigma [B], cfg [B], control_scale,
                 control_tiles [T,B,C,ts,ts], crossattn_tiles or None)
        -> denoised tiles [T,B,C,ts,ts]
    control_tiles: the control latent cut once by the caller;
    crossattn_tiles: per-tile text conditioning [T, B, 77, D] of the local
    prompts, or None. Churn noise is drawn from `generator` on steps whose
    churn is nonzero, as `restore_edm_sample` draws it."""
    b = x.shape[0]
    blend = _Blend(x, tile_size, tile_stride)
    x_center_tiles = blend.gather(x_center)
    for i in range(tables.num_steps):
        sigma_hat = float(tables.sigma_hat[i])
        churn = float(tables.churn_std[i])
        if churn > 0.0:
            eps = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + eps * (s_noise * churn)
        x_tiles = blend.gather(x)
        sig_b = torch.full((b,), sigma_hat, device=x.device)
        cfg_b = torch.full((b,), float(tables.cfg_scale[i]), device=x.device)
        denoised = denoise_tile(x_tiles, sig_b, cfg_b, float(tables.control_scale[i]), control_tiles,
                                crossattn_tiles)
        denoised = denoised - (denoised - x_center_tiles) * float(tables.restore_weight[i])
        d = (x_tiles - denoised) / sigma_hat
        x = blend(x_tiles + d * (float(tables.next_sigma[i]) - sigma_hat))
    return x


def tiled_restore_dpmpp2m_sample(
    denoise_tile: Callable,
    x: torch.Tensor,
    seed: int,
    tables: StepTables,
    control_tiles: torch.Tensor,
    tile_size: int,
    tile_stride: int,
    eta: float = 1.0,
    s_noise: float = 1.003,
    crossattn_tiles: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Tiled DPM++(2M) SDE (reference TiledRestoreDPMPP2MSampler,
    sampling.py:663-730): each step denoises the tiles, steps them, and
    blends both the state and the denoised carry. The SDE noise is the
    Brownian tree's increment over the whole latent (seeded by `seed`, on
    the span [last sigma, first sigma]), cut into the tiles."""
    b = x.shape[0]
    blend = _Blend(x, tile_size, tile_stride)
    bt_min, bt_max = float(tables.sigma[-1]), float(tables.sigma[0])
    old_denoised = torch.zeros_like(x)
    p_sigma = 1.0
    for i in range(tables.num_steps):
        sigma, next_sigma = float(tables.sigma[i]), float(tables.next_sigma[i])
        x_tiles = blend.gather(x)
        sig_b = torch.full((b,), sigma, device=x.device)
        cfg_b = torch.full((b,), float(tables.cfg_scale[i]), device=x.device)
        denoised = denoise_tile(x_tiles, sig_b, cfg_b, float(tables.control_scale[i]), control_tiles,
                                crossattn_tiles)
        stepped, std = S.dpmpp2m_update(x_tiles, denoised, blend.gather(old_denoised), i, p_sigma, sigma,
                                        next_sigma, eta)
        if std > 0:
            noise = S.brownian_increment(seed, sigma, next_sigma, bt_min, bt_max, x.shape, x.device)
            stepped = stepped + blend.gather(noise) * (std * s_noise)
        x, old_denoised = blend(stepped), blend(denoised)
        p_sigma = sigma
    return x


def make_tiled_denoise(denoise_flat: Callable, tile_chunk: Optional[int] = None) -> Callable:
    """Lift a batch denoiser onto the tile axis.

    denoise_flat(x [B',C,h,w], sigma [B'], cfg [B'], control_scale,
                 control [B',...], crossattn or None) -> [B',C,h,w]

    The tile axis folds into the batch (tile-major, T*B), one network call
    for all tiles; with `tile_chunk`, `tile_chunk` tiles a call, the last
    call padded with copies of the last tiles."""

    def folded(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles):
        t, b = x_tiles.shape[:2]
        flat = x_tiles.reshape((t * b,) + x_tiles.shape[2:])
        ctrl = control_tiles.reshape((t * b,) + control_tiles.shape[2:])
        ca = None if crossattn_tiles is None else crossattn_tiles.reshape((t * b,) + crossattn_tiles.shape[2:])
        out = denoise_flat(flat, sigma.repeat(t), cfg.repeat(t), ctrl_s, ctrl, ca)
        return out.reshape(x_tiles.shape)

    def chunked(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles):
        t = x_tiles.shape[0]
        if t <= tile_chunk:
            return folded(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles)
        pad = (-t) % tile_chunk

        def padded(a):
            return a if a is None or not pad else torch.cat([a, a[-pad:]])

        x_tiles, control_tiles, crossattn_tiles = (padded(a) for a in (x_tiles, control_tiles, crossattn_tiles))
        out = []
        for i in range(0, t + pad, tile_chunk):
            ca = None if crossattn_tiles is None else crossattn_tiles[i:i + tile_chunk]
            out.append(folded(x_tiles[i:i + tile_chunk], sigma, cfg, ctrl_s, control_tiles[i:i + tile_chunk], ca))
        return torch.cat(out)[:t]

    return chunked if tile_chunk else folded
