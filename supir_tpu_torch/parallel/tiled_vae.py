"""Tiled VAE encode and decode (counterpart of
supir_tpu/parallel/tiled_vae.py, without its mesh), NCHW.

The reference's "Ultimate VAE Tile Optimization" (`SUPIR/utils/tilevae.py:
677-971`) runs each tile through the VAE as a task queue that stops at
every GroupNorm until the statistics of all tiles are pooled. Here:

  - the image is split into uniform tiles with edge-replicated halos (32 px
    for the encoder, 8 latent px for the decoder) stacked on a leading tile
    axis, [T, B, C, h, w];
  - unchunked, the encoder or decoder runs once on the tile-major batch
    [T*B, C, h, w] with every GroupNorm's statistics pooled over each
    image's tiles (ops.groupnorm.TilePooled), attention inside each tile;
  - chunked (`chunk` tiles per call, which bounds the memory of a 4K image
    on one card), the default is the staged-exact executor below, which
    gives the unchunked result; `fast_mode` pools over each chunk only
    (the reference's fast mode, tilevae.py:855-876);
  - the merge crops each tile's halo and lays the tiles out on the grid.

Everything runs under torch.no_grad. The pooled GroupNorm sites run plain
torch, never K2, which takes each slab's own statistics.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.ops.groupnorm import GivenStats, TilePooled, group_moments

GROUPS = 32
ENCODER_PAD = 32  # image px of halo around each encoder tile
DECODER_PAD = 8   # latent px of halo around each decoder tile


def split_uniform_tiles(x: torch.Tensor, tile: int, pad: int):
    """[B, C, H, W] -> (tiles [T, B, C, tile+2p, tile+2p], grid (gh, gw),
    padded size (Hp, Wp)): the canvas edge-padded up to whole tiles, then by
    `pad` on every side, cut row-major."""
    b, c, h, w = x.shape
    gh, gw = math.ceil(h / tile), math.ceil(w / tile)
    hp, wp = gh * tile, gw * tile
    x = F.pad(x, (0, wp - w, 0, hp - h), mode="replicate")
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    tiles = [x[:, :, i * tile:i * tile + tile + 2 * pad, j * tile:j * tile + tile + 2 * pad]
             for i in range(gh) for j in range(gw)]
    return torch.stack(tiles), (gh, gw), (hp, wp)


def merge_valid_tiles(tiles: torch.Tensor, grid, out_hw, crop: int) -> torch.Tensor:
    """tiles [T, B, C, th, tw] -> [B, C, H, W]: `crop` px of halo cut from
    each side, the tiles laid out on the grid, the edge padding trimmed."""
    gh, gw = grid
    t, b, c, th, tw = tiles.shape
    valid = tiles[:, :, :, crop:th - crop, crop:tw - crop]
    vh, vw = valid.shape[3], valid.shape[4]
    canvas = valid.reshape(gh, gw, b, c, vh, vw).permute(2, 3, 0, 4, 1, 5).reshape(b, c, gh * vh, gw * vw)
    return canvas[:, :, :out_hw[0], :out_hw[1]]


def _pad_tile_axis(tiles: torch.Tensor, mult: int):
    """Repeat the last tile up to a multiple of `mult`; -> (tiles, T)."""
    t = tiles.shape[0]
    padded = (-t) % mult
    if padded:
        tiles = torch.cat([tiles, tiles[-1:].expand((padded,) + tiles.shape[1:])])
    return tiles, t


def _flat(g: torch.Tensor) -> torch.Tensor:
    """[chunk, B, ...] -> [chunk*B, ...], tile-major."""
    return g.reshape((g.shape[0] * g.shape[1],) + g.shape[2:])


def _unflat(u: torch.Tensor, chunk: int) -> torch.Tensor:
    return u.reshape((chunk, u.shape[0] // chunk) + u.shape[1:])


def _run_tiles(module: nn.Module, tiles: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """`module` (an encoder or decoder taking `norm`) over the tile axis.
    Unchunked: one call on all tiles, statistics pooled over all of them.
    Chunked (fast mode): one call per group of `chunk` tiles, the tile axis
    padded with copies of the last tile, statistics pooled within each
    group."""
    t = tiles.shape[0]
    if chunk is not None and t > chunk:
        tiles_p, t_orig = _pad_tile_axis(tiles, chunk)
        out = [_unflat(module(_flat(g), TilePooled(chunk)), chunk) for g in tiles_p.split(chunk)]
        return torch.cat(out)[:t_orig]
    return _unflat(module(_flat(tiles), TilePooled(t)), t)


# --------------------------------------------------------------------------
# Staged-exact chunked execution (the default when chunked)
#
# The network runs stage by stage over the whole tile set. A stage is one
# res or attention block. Its GroupNorm statistics are reductions over all
# tiles: directly over the stored all-tiles state where that state is the
# GroupNorm's input, or by a stats pass that recomputes the block's conv1
# (and any up- or downsample in front of it) chunk by chunk and keeps only
# the [2, B, G] moments. With the statistics known, the block completes
# chunk by chunk, in place in the one all-tiles buffer where it keeps the
# shape. conv1 and the resampling convs run twice: about 1.4x one pass.


def _moments_all(y: torch.Tensor, t_orig: int, groups: int = GROUPS) -> torch.Tensor:
    """Per-image moments [2, B, G] fp32 of the stored state y [T, B, C, ...]
    over its first t_orig tiles."""
    b = y.shape[1]
    m, m2 = group_moments(_flat(y[:t_orig]), groups)
    return torch.stack([m.view(t_orig, b, groups).mean(0), m2.view(t_orig, b, groups).mean(0)])


def _stats_chunks(y: torch.Tensor, chunk: int, t_orig: int, fn_flat: Callable, groups: int = GROUPS) -> torch.Tensor:
    """Per-image moments [2, B, G] of fn_flat(y) over the first t_orig tiles,
    chunk by chunk, without storing fn_flat's output: each chunk's per-tile
    moments, masked past t_orig, are summed."""
    t, b = y.shape[:2]
    s1 = s2 = 0.0
    for i in range(0, t, chunk):
        u = fn_flat(_flat(y[i:i + chunk]))
        m, m2 = group_moments(u, groups)
        mask = (torch.arange(i, i + chunk, device=u.device) < t_orig).float().view(chunk, 1, 1)
        s1 = s1 + (m.view(chunk, b, groups) * mask).sum(0)
        s2 = s2 + (m2.view(chunk, b, groups) * mask).sum(0)
    return torch.stack([s1 / t_orig, s2 / t_orig])


def _apply_chunks(y: torch.Tensor, chunk: int, fn_flat: Callable, inplace: bool) -> torch.Tensor:
    """fn_flat over y [T, B, ...] chunk by chunk: written back into y where
    `inplace` (a stage that keeps the shape), else into a fresh buffer."""
    t = y.shape[0]
    out = y if inplace else None
    for i in range(0, t, chunk):
        u = _unflat(fn_flat(_flat(y[i:i + chunk])), chunk)
        if out is None:
            out = u.new_empty((t,) + u.shape[1:])
        out[i:i + chunk] = u
    return out


def _staged_resblock(block: nn.Module, y: torch.Tensor, t_orig: int, chunk: int,
                     pre: Optional[Callable] = None) -> torch.Tensor:
    """A VAEResnetBlock over all tiles with exact statistics. `pre` is a
    per-chunk transform in front of the block (the up- or downsample
    between levels), recomputed in the stats passes so that its output is
    never stored for all tiles at once."""
    xin = pre if pre is not None else (lambda gf: gf)
    st1 = _moments_all(y, t_orig) if pre is None else _stats_chunks(y, chunk, t_orig, xin)

    def u_of(xf):
        return block.conv1(block.norm1(xf, GivenStats(st1)))

    st2 = _stats_chunks(y, chunk, t_orig, lambda gf: u_of(xin(gf)))

    def complete(gf):
        x = xin(gf)
        return block.nin_shortcut(x) + block.conv2(block.norm2(u_of(x), GivenStats(st2)))

    keeps_shape = pre is None and y.shape[2] == block.conv2.out_channels
    return _apply_chunks(y, chunk, complete, inplace=keeps_shape)


def _staged_attnblock(block: nn.Module, y: torch.Tensor, t_orig: int, chunk: int) -> torch.Tensor:
    """A VAEAttnBlock over all tiles: attention stays inside each tile, only
    the GroupNorm statistics couple the tiles."""
    st = _moments_all(y, t_orig)
    return _apply_chunks(y, chunk, lambda xf: block.attend(xf, block.norm(xf, GivenStats(st))), inplace=True)


def _staged_out(module: nn.Module, y: torch.Tensor, t_orig: int, chunk: int) -> torch.Tensor:
    """norm_out (SiLU) and conv_out with exact statistics, the padded tiles dropped."""
    st = _moments_all(y, t_orig)
    y = _apply_chunks(y, chunk, lambda xf: module.conv_out(module.norm_out(xf, GivenStats(st))), inplace=False)
    return y[:t_orig]


def _staged_encode_exact(encoder: nn.Module, tiles: torch.Tensor, chunk: int) -> torch.Tensor:
    """VAEEncoder over tiles [T, B, 3, h, w] with exact statistics, chunked;
    the downsamples fuse into the next block's passes."""
    tiles_p, t_orig = _pad_tile_axis(tiles, chunk)
    dtype = encoder.conv_in.weight.dtype
    y = _apply_chunks(tiles_p, chunk, lambda xf: encoder.conv_in(xf.to(dtype)), inplace=False)
    pre = None
    for level in encoder.down:
        for block in level.block:
            y = _staged_resblock(block, y, t_orig, chunk, pre)
            pre = None
        if hasattr(level, "downsample"):
            pre = level.downsample
    y = _staged_resblock(encoder.mid.block_1, y, t_orig, chunk, pre)
    y = _staged_attnblock(encoder.mid.attn_1, y, t_orig, chunk)
    y = _staged_resblock(encoder.mid.block_2, y, t_orig, chunk)
    return _staged_out(encoder, y, t_orig, chunk)


def _staged_decode_exact(decoder: nn.Module, tiles: torch.Tensor, chunk: int) -> torch.Tensor:
    """VAEDecoder over latent tiles with exact statistics, chunked; the
    upsamples fuse into the next block's passes, so the state at twice the
    size and the wider channel count is never stored for all tiles."""
    tiles_p, t_orig = _pad_tile_axis(tiles, chunk)
    dtype = decoder.conv_in.weight.dtype
    y = _apply_chunks(tiles_p, chunk, lambda zf: decoder.conv_in(zf.to(dtype)), inplace=False)
    y = _staged_resblock(decoder.mid.block_1, y, t_orig, chunk)
    y = _staged_attnblock(decoder.mid.attn_1, y, t_orig, chunk)
    y = _staged_resblock(decoder.mid.block_2, y, t_orig, chunk)
    pre = None
    for level in reversed(decoder.up):
        for block in level.block:
            y = _staged_resblock(block, y, t_orig, chunk, pre)
            pre = None
        if hasattr(level, "upsample"):
            pre = level.upsample
    return _staged_out(decoder, y, t_orig, chunk)


def _tiles_through(module: nn.Module, staged: Callable, tiles: torch.Tensor, chunk: Optional[int],
                   fast_mode: bool) -> torch.Tensor:
    if chunk is not None and tiles.shape[0] > chunk and not fast_mode:
        return staged(module, tiles, chunk)
    return _run_tiles(module, tiles, chunk)


@torch.no_grad()
def tiled_encode(encoder: nn.Module, quant_conv: nn.Module, x: torch.Tensor, tile_size: int = 512,
                 pad: int = ENCODER_PAD, chunk: Optional[int] = None, fast_mode: bool = False) -> torch.Tensor:
    """Tiled VAE encode: image [B, 3, H, W] -> moments [B, 2z, H/f, W/f].
    tile_size and pad are image px, multiples of the downscale factor f.
    `chunk` bounds the tiles of one call; chunked, the statistics are exact
    (staged) unless `fast_mode` pools them per chunk."""
    f = 2 ** (len(encoder.down) - 1)
    if tile_size % f or pad % f:
        raise ValueError(f"encoder tile_size {tile_size} and pad {pad} must be multiples of {f}")
    b, _, h, w = x.shape
    tiles, grid, (hp, wp) = split_uniform_tiles(x, tile_size, pad)
    z_tiles = _tiles_through(encoder, _staged_encode_exact, tiles, chunk, fast_mode)
    moments = merge_valid_tiles(z_tiles, grid, (hp // f, wp // f), pad // f)[:, :, :h // f, :w // f]
    # the 1x1 quant conv commutes with tiling: applied to the merged map
    return quant_conv(moments)


@torch.no_grad()
def tiled_decode(decoder: nn.Module, post_quant_conv: nn.Module, z: torch.Tensor, tile_size: int = 64,
                 pad: int = DECODER_PAD, chunk: Optional[int] = None, fast_mode: bool = False) -> torch.Tensor:
    """Tiled VAE decode: latent [B, z, h, w] -> image [B, 3, h*f, w*f].
    tile_size and pad are latent px; `chunk` and `fast_mode` as in
    tiled_encode."""
    f = 2 ** (len(decoder.up) - 1)
    _, _, h, w = z.shape
    z = post_quant_conv(z.to(post_quant_conv.weight.dtype))
    tiles, grid, (hp, wp) = split_uniform_tiles(z, tile_size, pad)
    img_tiles = _tiles_through(decoder, _staged_decode_exact, tiles, chunk, fast_mode)
    return merge_valid_tiles(img_tiles, grid, (hp * f, wp * f), pad * f)[:, :, :h * f, :w * f]
