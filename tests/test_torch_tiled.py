"""The port's tiled path against the JAX package on the CPU at tiny widths:
the tiling plans, split and merge, GroupNorm with pooled and with given
statistics, the tiled VAE in its four modes, the tiled RestoreEDM sampler
and its tile chunks, and the engine's tiled first stage and
batchify_sample_tiled.

Bounds: the plans bit for bit (numpy on both sides); tensors in fp32 to
rel-L2 1e-4 and allclose atol/rtol 2e-3 (the two packages differ only in
summation order; the tiled VAE's readings are below 1e-5 max abs on values
up to about 4); the port's staged-exact VAE against its own unchunked run
1e-5 max abs; the engine paths to 5e-5 max abs, the bound of
tests/test_torch_engine.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.models.layers import GroupNorm32 as JaxGroupNorm32
from supir_tpu.parallel import tiled_sampler as JTS
from supir_tpu.parallel import tiled_vae as JTV
from supir_tpu.utils import tiling as JTiling
from supir_tpu_torch.diffusion import samplers as S
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.models.layers import GroupNorm32
from supir_tpu_torch.models.vae import AutoencoderKL
from supir_tpu_torch.ops.groupnorm import GivenStats, TilePooled
from supir_tpu_torch.parallel import tiled_sampler as TS
from supir_tpu_torch.parallel import tiled_vae as TV
from supir_tpu_torch.utils import tiling as TTiling
from supir_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
REL = 1e-4
STAGED_BOUND = 1e-5
SLICE_BOUND = 5e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel(got, want) <= REL
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------------ plans

PLAN_CASES = {"square": (16, 16, 8, 4), "ragged": (13, 22, 8, 3), "one": (8, 8, 8, 4), "wide": (128, 192, 128, 64),
              "full_2k": (256, 256, 128, 64)}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_tiling_plans_equal_jax(case):
    h, w, ts, stride = PLAN_CASES[case]
    assert TTiling.sliding_windows(h, w, ts, stride) == JTiling.sliding_windows(h, w, ts, stride)
    np.testing.assert_array_equal(TTiling.gaussian_weights(ts, ts + 3), JTiling.gaussian_weights(ts, ts + 3))
    for pad in (0, 3, 8):
        assert TTiling.vae_tile_grid(h, w, ts, pad) == JTiling.vae_tile_grid(h, w, ts, pad)
        assert TTiling.plan_vae_tiles(h, w, ts, pad) == JTiling.plan_vae_tiles(h, w, ts, pad)
        assert TTiling.padded_bbox(2, 9, pad, h) == JTiling.padded_bbox(2, 9, pad, h)
    got, want = TS.make_tile_plan(h, w, ts, stride), JTS.make_tile_plan(h, w, ts, stride)
    for g, j in zip(got, want):
        assert g.dtype == j.dtype
        np.testing.assert_array_equal(g, j)


def test_sampler_plan_at_2048_has_nine_tiles():
    starts, _, count = TS.make_tile_plan(256, 256, 128, 64)
    assert len(starts) == 9 and (count > 0).all()


@pytest.mark.parametrize("shape,tile,pad", [((2, 3, 40, 56), 16, 8), ((1, 4, 13, 7), 4, 2)], ids=["image", "ragged"])
def test_split_merge_round_trip_and_equal_jax(shape, tile, pad):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    tiles, grid, (hp, wp) = TV.split_uniform_tiles(torch.from_numpy(x), tile, pad)
    jtiles, jgrid, jhw = JTV.split_uniform_tiles(jnp.asarray(P.nhwc(x)), tile, pad)
    assert (grid, (hp, wp)) == (jgrid, jhw)
    np.testing.assert_array_equal(tiles.numpy(), np.moveaxis(np.asarray(jtiles), -1, 2))
    merged = TV.merge_valid_tiles(tiles, grid, (hp, wp), pad)[:, :, :shape[2], :shape[3]]
    np.testing.assert_array_equal(merged.numpy(), x)
    jmerged = JTV.merge_valid_tiles(jtiles, jgrid, jhw, pad)
    np.testing.assert_array_equal(P.nhwc(TV.merge_valid_tiles(tiles, grid, (hp, wp), pad)), np.asarray(jmerged))


# ------------------------------------------------------------------ GroupNorm


@pytest.mark.parametrize("form", ["pooled", "pooled_weighted", "given"])
def test_pooled_group_norm_equals_jax(form):
    """Both statistics modes of GroupNorm32: pooled over the tiles (JAX:
    vmap with a named axis, pmean, optionally weighted by tile_weight) and
    given from outside (JAX: the gn_tape)."""
    rng = np.random.default_rng(2)
    t, b, c = 3, 2, 64
    x = (rng.standard_normal((t, b, 5, 6, c)) * rng.uniform(0.5, 2, c) + rng.uniform(-1, 1, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    gn = GroupNorm32(c, eps=1e-6, fuse_silu=True)
    gn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    flat = torch.from_numpy(P.nchw(x.reshape(t * b, 5, 6, c)))
    if form == "given":
        stats = np.stack([rng.standard_normal((b, 32)), 1.5 + rng.uniform(0, 1, (b, 32))]).astype(np.float32)
        tape = np.broadcast_to(stats[:, None], (2, t, b, 32)).reshape(2, t * b, 32)
        jgn = JaxGroupNorm32(eps=1e-6, fuse_silu=True)
        want = jgn.apply({"params": p, "gn_tape": {"tape": jnp.asarray(tape)}}, x.reshape(t * b, 5, 6, c))
        got = gn(flat, GivenStats(torch.from_numpy(stats)))
    else:
        jgn = JaxGroupNorm32(eps=1e-6, fuse_silu=True, axis_name="tile_local")
        weight = np.array([1.5, 1.5, 0.0], np.float32) if form == "pooled_weighted" else None
        if weight is None:
            want = jax.vmap(lambda one: jgn.apply({"params": p}, one), axis_name="tile_local")(x)
        else:
            want = jax.vmap(lambda one, w: jgn.apply({"params": p}, one, w), axis_name="tile_local")(x, weight)
        want = np.asarray(want).reshape(t * b, 5, 6, c)
        got = gn(flat, TilePooled(t, None if weight is None else torch.from_numpy(weight)))
    _close(P.nhwc(got.detach()), np.asarray(want))


def test_pooled_statistics_differ_from_each_tiles_own():
    """The pooled mode is not K2's per-slab statistics: on tiles with
    different means the two disagree."""
    x = torch.randn(4, 64, 6, 6) + torch.arange(4.0).view(4, 1, 1, 1)
    gn = GroupNorm32(64, eps=1e-6)
    assert (gn(x, TilePooled(4)) - gn(x)).abs().max() > 0.5


# ------------------------------------------------------------------ the tiled VAE


@pytest.fixture(scope="module")
def vae_pair():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=11)
    vae = AutoencoderKL(cfg.vae)
    vae.load_state_dict(P.sub_state_dict(state_dict_from_jax(params, cfg), "first_stage_model"))
    return cfg, jax.tree_util.tree_map(jnp.asarray, params["vae"]), vae.eval()


def _vae_inputs():
    rng = np.random.default_rng(3)
    # 32x48 image px in 16 px tiles, pad 8: 2x3 = 6 tiles; an 8x12 latent in
    # 4-latent tiles, pad 2: 6 tiles. Chunk 3 divides 6, chunk 4 pads it to 8.
    return rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32), rng.standard_normal((1, 8, 12, 4)).astype(np.float32)


VAE_MODES = {"unchunked": (None, False), "staged_chunk3": (3, False), "staged_chunk4": (4, False),
             "fast_chunk3": (3, True)}


@pytest.mark.parametrize("mode", sorted(VAE_MODES))
def test_tiled_encode_decode_equal_jax(vae_pair, mode):
    cfg, vp, vae = vae_pair
    chunk, fast = VAE_MODES[mode]
    x, z = _vae_inputs()
    enc = jax.jit(functools.partial(JTV.tiled_encode, cfg.vae, tile_size=16, pad=8, chunk=chunk, fast_mode=fast))
    got = TV.tiled_encode(vae.encoder, vae.quant_conv, torch.from_numpy(P.nchw(x)), 16, 8, chunk, fast)
    _close(P.nhwc(got), np.asarray(enc(vp["encoder"], vp["quant_conv"], x)))
    dec = jax.jit(functools.partial(JTV.tiled_decode, cfg.vae, tile_size=4, pad=2, chunk=chunk, fast_mode=fast))
    got = TV.tiled_decode(vae.decoder, vae.post_quant_conv, torch.from_numpy(P.nchw(z)), 4, 2, chunk, fast)
    _close(P.nhwc(got), np.asarray(dec(vp["decoder"], vp["post_quant_conv"], z)))


def test_staged_exact_equals_unchunked_and_fast_mode_differs(vae_pair):
    _, _, vae = vae_pair
    x, z = (torch.from_numpy(P.nchw(a)) for a in _vae_inputs())
    enc = functools.partial(TV.tiled_encode, vae.encoder, vae.quant_conv, x, 16, 8)
    dec = functools.partial(TV.tiled_decode, vae.decoder, vae.post_quant_conv, z, 4, 2)
    for run in (enc, dec):
        whole = run(None)
        for chunk in (3, 4):
            assert (run(chunk) - whole).abs().max().item() <= STAGED_BOUND, chunk
        assert (run(3, True) - whole).abs().max().item() > 1e-3  # chunk-local statistics move it


def test_one_tile_without_pad_equals_the_plain_vae(vae_pair):
    _, _, vae = vae_pair
    x, z = (torch.from_numpy(P.nchw(a)) for a in _vae_inputs())
    x, z = x[:, :, :, :32], z[:, :, :, :8]  # one whole tile each
    with torch.no_grad():
        torch.testing.assert_close(TV.tiled_encode(vae.encoder, vae.quant_conv, x, 32, 0), vae.moments(x),
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(TV.tiled_decode(vae.decoder, vae.post_quant_conv, z, 8, 0), vae.decode(z),
                                   atol=1e-5, rtol=0)


def test_tiled_vae_sites_never_take_each_slabs_own_statistics(vae_pair, monkeypatch):
    """Every GroupNorm of the tiled VAE runs with pooled or given statistics:
    none reaches `group_norm` (K2 on the card)."""
    from supir_tpu_torch.models import layers

    _, _, vae = vae_pair
    x, z = (torch.from_numpy(P.nchw(a)) for a in _vae_inputs())
    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1))
    before = GroupNorm32.pooled_sites
    for chunk, fast in VAE_MODES.values():
        TV.tiled_encode(vae.encoder, vae.quant_conv, x, 16, 8, chunk, fast)
        TV.tiled_decode(vae.decoder, vae.post_quant_conv, z, 4, 2, chunk, fast)
    assert calls == [] and GroupNorm32.pooled_sites > before


# ------------------------------------------------------------------ the tiled sampler


def _linear_denoiser(layout):
    """A fixed denoiser, linear in the tiles and the control, in either
    package's layout (channels last: 'nhwc', or 'nchw')."""

    def f(x_tiles, sigma, cfg_b, ctrl_s, control_tiles, ca):
        view = (1, -1, 1, 1, 1)
        lib = torch if layout == "nchw" else jnp
        s = sigma.reshape(view)
        c = cfg_b.reshape(view)
        return 0.8 * x_tiles / (1.0 + s * s) + 0.05 * c * ctrl_s * control_tiles + 0.01 * lib.tanh(x_tiles)

    return f


def _edm_case(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, 13, 22)).astype(np.float32)
    control = rng.standard_normal((2, 4, 13, 22)).astype(np.float32)
    center = rng.standard_normal((2, 4, 13, 22)).astype(np.float32)
    from supir_tpu_torch.config import SamplerConfig

    tables = S.make_step_tables(S.legacy_ddpm_sigmas(4), SamplerConfig(restore_cfg=4.0, cfg_scale=7.5,
                                                                        cfg_scale_min=4.0),
                                control_scale=0.8, use_linear_control_scale=True, control_scale_start=0.2)
    return x, control, center, tables


def test_tiled_restore_edm_sample_equals_jax():
    x, control, center, tables = _edm_case()
    starts, _, _ = TS.make_tile_plan(13, 22, 8, 3)
    jcontrol = JTS._gather_tiles(jnp.asarray(P.nhwc(control)), starts, 8)
    want = JTS.tiled_restore_edm_sample(
        _linear_denoiser("nhwc"), jnp.asarray(P.nhwc(x)), jax.random.PRNGKey(0), tables,
        x_center=jnp.asarray(P.nhwc(center)), control_tiles=jcontrol, tile_size=8, tile_stride=3)
    got = TS.tiled_restore_edm_sample(
        _linear_denoiser("nchw"), torch.from_numpy(x), torch.Generator(), tables, x_center=torch.from_numpy(center),
        control_tiles=TS._gather_tiles(torch.from_numpy(control), starts, 8), tile_size=8, tile_stride=3)
    _close(P.nhwc(got), np.asarray(want))


def test_tile_chunks_equal_the_folded_run():
    """make_tiled_denoise with tile_chunk 3, 4 and 16 (10 tiles: the last
    call padded, or one call) gives the folded run's result, and JAX's."""
    rng = np.random.default_rng(5)
    x_tiles = rng.standard_normal((10, 2, 4, 8, 8)).astype(np.float32)
    control = rng.standard_normal((10, 2, 4, 8, 8)).astype(np.float32)
    ca = rng.standard_normal((10, 2, 77, 8)).astype(np.float32)
    seen = []

    def denoise_flat(x, sigma, cfg_b, ctrl_s, ctrl, ca_flat):
        seen.append(x.shape[0])
        s = sigma.view(-1, 1, 1, 1)
        return x / (1 + s * s) + ctrl_s * ctrl * cfg_b.view(-1, 1, 1, 1) + ca_flat.mean((1, 2)).view(-1, 1, 1, 1)

    sigma, cfg_b = torch.tensor([3.0, 1.0]), torch.tensor([4.0, 2.0])
    args = (torch.from_numpy(x_tiles), sigma, cfg_b, 0.7, torch.from_numpy(control), torch.from_numpy(ca))
    folded = TS.make_tiled_denoise(denoise_flat)(*args)
    for chunk in (3, 4, 16):
        seen.clear()
        torch.testing.assert_close(TS.make_tiled_denoise(denoise_flat, tile_chunk=chunk)(*args), folded,
                                   rtol=0, atol=0)
        assert seen == [2 * min(chunk, 10)] * -(-10 // chunk)

    def jax_flat(x, sigma, cfg_b, ctrl_s, ctrl, ca_flat):
        s = sigma.reshape(-1, 1, 1, 1)
        return x / (1 + s * s) + ctrl_s * ctrl * cfg_b.reshape(-1, 1, 1, 1) + ca_flat.mean((1, 2)).reshape(-1, 1, 1, 1)

    want = JTS.make_tiled_denoise(jax_flat, tile_chunk=4)(
        jnp.asarray(np.moveaxis(x_tiles, 2, -1)), jnp.asarray(sigma.numpy()), jnp.asarray(cfg_b.numpy()), 0.7,
        jnp.asarray(np.moveaxis(control, 2, -1)), jnp.asarray(ca))
    _close(np.moveaxis(folded.numpy(), 2, -1), np.asarray(want))


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engines():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=12)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=state_dict_from_jax(params, cfg))
    return cfg, jax_engine, torch_engine


def _tiled_inputs(cfg, seed=13, hw=(96, 96)):
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32)
    c = {"crossattn": rng.standard_normal((1, 77, cfg.unet.context_dim)).astype(np.float32),
         "vector": rng.standard_normal((1, cfg.unet.adm_in_channels)).astype(np.float32)}
    uc = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in c.items()}
    noise, center = (rng.standard_normal((1, h // 8, w // 8, 4)).astype(np.float32) for _ in range(2))
    return x, c, uc, noise, center


TILED_KW = dict(num_steps=2, tile_size=8, tile_stride=4, restoration_scale=4.0, cfg_scale=4.0, use_linear_cfg=True,
                cfg_scale_start=7.5, s_churn=0.0, color_fix_type="Wavelet", seed=3)


def test_tiled_first_stage_equals_jax(engines):
    """init_tile_vae on both engines: the denoise-encode, the sampled encode
    with injected noise, the mode, and the decode, staged (4 encoder tiles
    at chunk 3, 6 decoder tiles at chunk 4)."""
    _, jax_engine, torch_engine = engines
    x, _, _, _, _ = _tiled_inputs(engines[0], hw=(64, 96))
    noise = np.random.default_rng(14).standard_normal((1, 8, 12, 4)).astype(np.float32)
    for engine in (jax_engine, torch_engine):
        engine.init_tile_vae(32, 4, chunk=(3, 4))
    try:
        z = torch_engine.encode_first_stage_with_denoise(x).numpy()
        _close(z, np.asarray(jax_engine.encode_first_stage_with_denoise(x)))
        _close(torch_engine.encode_first_stage(x, noise=noise).numpy(),
               np.asarray(jax_engine.encode_first_stage(x, noise=noise)))
        _close(torch_engine.encode_first_stage(x).numpy(), np.asarray(jax_engine.encode_first_stage(x)))
        _close(torch_engine.decode_first_stage(z).numpy(), np.asarray(jax_engine.decode_first_stage(z)))
    finally:
        jax_engine._tile_vae = None
        torch_engine._tile_vae = None


ENGINE_CASES = {"edm": {}, "tile_chunk": dict(tile_chunk=3), "local_prompts": {}}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_batchify_sample_tiled_equals_jax(engines, case):
    """TiledRestoreEDM end to end (4 windows of 8 latent px at stride 4 on a
    12x12 latent) with both noises injected and churn 0: folded, at
    tile_chunk 3, and with a local prompt per window."""
    cfg, jax_engine, torch_engine = engines
    x, c, uc, noise, center = _tiled_inputs(cfg)
    if case == "local_prompts":
        c["crossattn_tiles"] = np.random.default_rng(15).standard_normal(
            (4, 1, 77, cfg.unet.context_dim)).astype(np.float32)
    kw = dict(TILED_KW, noise_override=noise, center_noise_override=center, **ENGINE_CASES[case])
    z_jax = jax_engine.encode_first_stage_with_denoise(x)
    want = np.asarray(jax_engine.batchify_sample_tiled(
        x, dict(c, control=z_jax), dict(uc, control=z_jax), z_override=z_jax, **kw))
    z = torch_engine.encode_first_stage_with_denoise(x)
    got = torch_engine.batchify_sample_tiled(x, dict(c, control=z), dict(uc, control=z), z_override=z, **kw).numpy()
    assert got.shape == (1, 96, 96, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SLICE_BOUND, rtol=0)


def test_batchify_sample_tiled_checks_its_arguments(engines):
    cfg, _, engine = engines
    x, c, uc, noise, _ = _tiled_inputs(cfg)
    z = engine.encode_first_stage_with_denoise(x)
    c, uc = dict(c, control=z), dict(uc, control=z)
    with pytest.raises(ValueError, match="noise_override"):
        engine.batchify_sample_tiled(x, c, uc, noise_override=noise[:, :4], z_override=z, **TILED_KW)
    with pytest.raises(ValueError, match="center_noise_override"):
        engine.batchify_sample_tiled(x, c, uc, center_noise_override=noise[..., :3], z_override=z, **TILED_KW)
    with pytest.raises(ValueError, match="only supported with TiledRestoreEDM"):
        engine.batchify_sample_tiled(x, c, uc, feature_cache_interval=2, sampler_name="TiledRestoreDPMPP2M",
                                     z_override=z, **TILED_KW)
    assert torch.isfinite(engine.batchify_sample_tiled(x, c, uc, feature_cache_interval=2, z_override=z,
                                                       **TILED_KW)).all()
    with pytest.raises(ValueError, match="RestoreEDM"):
        engine.batchify_sample_tiled(x, c, uc, sampler_name="RestoreEDM", z_override=z, **TILED_KW)
    with pytest.raises(ValueError, match="batchify_sample_tiled"):
        engine.batchify_sample(x, c, uc, sampler_name="TiledRestoreEDM", num_steps=2, z_override=z)
    kw = dict(TILED_KW, s_churn=5.0, z_override=z)
    a = engine.batchify_sample_tiled(x, c, uc, **kw)
    torch.testing.assert_close(a, engine.batchify_sample_tiled(x, c, uc, **kw), rtol=0, atol=0)
    assert not torch.equal(a, engine.batchify_sample_tiled(x, c, uc, **dict(kw, seed=4)))

