"""Tiled diffusion sampling (counterpart of supir_tpu/parallel/tiled_sampler.py,
without its step segments), NCHW, on one card or over a tile mesh.

At every step each sliding-window latent tile is denoised with its own
slice of the control latent (and, with local prompts, its own text
conditioning), then the tiles are blended back with Gaussian weights
(reference TiledRestoreEDMSampler and TiledRestoreDPMPP2MSampler,
sampling.py:600-730). The reference denoises one tile after another; here
all tiles go through the network as one batch (tile axis folded into the
batch: with CFG's two halves, 2*T*B), or `tile_chunk` tiles at a time, or,
over a mesh with a 'tile' axis of n > 1 ranks (JAX's `shard_map`), each
rank its T/n windows as one batch, the tile axis padded to a multiple of n,
the results all-gathered (`tile_chunk` is ignored there, as in JAX). The
blend accumulates in fp32 on the latent's device and is divided by the
weight sum, which does not depend on the step and is computed once.

The cross-step feature cache (`tiled_restore_edm_sample_cached`) keeps,
for every window, the control pyramid and the UNet's encoder features of
the last recompute step: one cache over all windows folded, or one per
group of `tile_chunk` windows, or one per rank for its own windows.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from supir_tpu_torch.diffusion import samplers as S
from supir_tpu_torch.diffusion.samplers import StepTables
from supir_tpu_torch.parallel.mesh import all_gather, axis_group, axis_size
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


def tiled_restore_edm_sample_cached(
    denoise_tile_cached: Callable,
    recompute,
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
    """TiledRestoreEDM with the tile-indexed cross-step feature cache: every
    window's encoder, middle block and control pyramid run only on steps
    where `recompute[i]` holds (recompute[0] must) and are reused between.
    denoise_tile_cached(x_tiles, sigma, cfg, control_scale, control_tiles,
                        crossattn_tiles, cache, recompute_i)
        -> (denoised tiles, cache)
    (`make_tiled_denoise_cached`). With every flag True the result is
    bit-identical to `tiled_restore_edm_sample`."""
    return tiled_restore_edm_sample(
        S.with_feature_cache(denoise_tile_cached, recompute, tables.num_steps), x, generator, tables,
        x_center=x_center, control_tiles=control_tiles, tile_size=tile_size, tile_stride=tile_stride,
        s_noise=s_noise, crossattn_tiles=crossattn_tiles)


def make_tiled_denoise_cached(denoise_flat_cached: Callable, tile_chunk: Optional[int] = None, mesh=None) -> Callable:
    """Lift a batch denoiser that threads the feature cache onto the tile axis.

    denoise_flat_cached(x [B',C,h,w], sigma [B'], cfg [B'], control_scale,
                        control [B',...], crossattn or None, cache, recompute)
        -> ([B',C,h,w], cache)

    The tile axis folds into the batch (tile-major, T*B), one network call
    and one cache for all tiles; with `tile_chunk` (and more tiles than
    that), `tile_chunk` tiles a call, the last call padded with copies of
    the last tiles, and a list of one cache per call, each over its padded
    batch as the JAX package's chunk-major cache (`engine/supir.py:
    _tiled_feature_cache_zeros`). The padded rows never reach the result.
    Over a `mesh` with a 'tile' axis of n > 1 ranks, each rank folds its
    share of the windows (padded to a multiple of n with the last windows)
    into one call with its own cache, and the outputs are all-gathered;
    `tile_chunk` is ignored there."""

    def folded(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles, cache, rec):
        t, b = x_tiles.shape[:2]
        flat = x_tiles.reshape((t * b,) + x_tiles.shape[2:])
        ctrl = control_tiles.reshape((t * b,) + control_tiles.shape[2:])
        ca = None if crossattn_tiles is None else crossattn_tiles.reshape((t * b,) + crossattn_tiles.shape[2:])
        out, cache = denoise_flat_cached(flat, sigma.repeat(t), cfg.repeat(t), ctrl_s, ctrl, ca, cache, rec)
        return out.reshape(x_tiles.shape), cache

    def chunked(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles, cache, rec):
        t = x_tiles.shape[0]
        if t <= tile_chunk:
            return folded(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles, cache, rec)
        pad = (-t) % tile_chunk

        def padded(a):
            return a if a is None or not pad else torch.cat([a, a[-pad:]])

        x_tiles, control_tiles, crossattn_tiles = (padded(a) for a in (x_tiles, control_tiles, crossattn_tiles))
        groups = range(0, t + pad, tile_chunk)
        caches = [None] * len(groups) if cache is None else cache
        out, new = [], []
        for i, group_cache in zip(groups, caches):
            ca = None if crossattn_tiles is None else crossattn_tiles[i:i + tile_chunk]
            o, c = folded(x_tiles[i:i + tile_chunk], sigma, cfg, ctrl_s, control_tiles[i:i + tile_chunk], ca,
                          group_cache, rec)
            out.append(o)
            new.append(c)
        return torch.cat(out)[:t], new

    def sharded(x_tiles, sigma, cfg, ctrl_s, control_tiles, crossattn_tiles, cache, rec):
        group, n, rank = axis_group(mesh, "tile")
        t = x_tiles.shape[0]
        pad = (-t) % n
        local = (t + pad) // n
        mine = slice(rank * local, (rank + 1) * local)

        def share(a):
            return None if a is None else (torch.cat([a, a[-pad:]]) if pad else a)[mine]

        out, cache = folded(share(x_tiles), sigma, cfg, ctrl_s, share(control_tiles), share(crossattn_tiles), cache,
                            rec)
        return all_gather(out, group)[:t], cache

    if axis_size(mesh, "tile") > 1:
        return sharded
    return chunked if tile_chunk else folded


def make_tiled_denoise(denoise_flat: Callable, tile_chunk: Optional[int] = None, mesh=None) -> Callable:
    """Lift a batch denoiser onto the tile axis.

    denoise_flat(x [B',C,h,w], sigma [B'], cfg [B'], control_scale,
                 control [B',...], crossattn or None) -> [B',C,h,w]

    The tile axis folds into the batch (tile-major, T*B), one network call
    for all tiles; with `tile_chunk`, `tile_chunk` tiles a call, the last
    call padded with copies of the last tiles; over a tile `mesh`, each
    rank its share (`make_tiled_denoise_cached` without a cache)."""
    lifted = make_tiled_denoise_cached(lambda *args: (denoise_flat(*args[:6]), None), tile_chunk, mesh)
    return lambda *args: lifted(*args, None, True)[0]
