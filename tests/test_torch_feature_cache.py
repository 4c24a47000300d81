"""The port's cross-step feature cache against the JAX package on the CPU,
untiled (`batchify_sample(feature_cache_interval=)`, RestoreEDM) and tiled
(`batchify_sample_tiled(feature_cache_interval=)`, TiledRestoreEDM, all
windows folded and in chunks of 3 with a padded last group), mirroring
tests/test_engine_e2e.py:118-185 and tests/test_tiled_feature_cache.py.

Every parameter is random (the stock tiny engine's zero-init output head
would make eps 0 whatever the features). Interval 1 must be bit-identical
to the plain path; interval 2 (recompute on steps 0 and 2 of 3, reuse on
step 1) must equal JAX's to 5e-5 max abs, the bound of
tests/test_torch_engine.py, with both noises injected and churn 0 (the
packages' churn streams differ), and differ from the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.models import layers
from supir_tpu_torch.ops import groupnorm as G
from supir_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

SLICE_BOUND = 5e-5


@pytest.fixture(scope="module")
def engines():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=41)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=state_dict_from_jax(params, cfg))
    return cfg, jax_engine, torch_engine


def _inputs(cfg, side, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
    c = {"crossattn": rng.standard_normal((1, 77, cfg.unet.context_dim)).astype(np.float32),
         "vector": rng.standard_normal((1, cfg.unet.adm_in_channels)).astype(np.float32)}
    uc = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in c.items()}
    noise, center = (rng.standard_normal((1, side // 8, side // 8, 4)).astype(np.float32) for _ in range(2))
    return x, c, uc, noise, center


KW = dict(num_steps=3, restoration_scale=4.0, cfg_scale=4.0, use_linear_cfg=True, cfg_scale_start=7.5,
          color_fix_type="Wavelet", seed=3)
# 96^2: a 12^2 latent, four windows of 8 at stride 4
CASES = {"untiled": (64, {}), "tiled_folded": (96, dict(tile_size=8, tile_stride=4)),
         "tiled_chunked": (96, dict(tile_size=8, tile_stride=4, tile_chunk=3))}


def _run(engine, case, x, c, uc, z, **kw):
    side, tile = CASES[case]
    run = engine.batchify_sample_tiled if tile else engine.batchify_sample
    return run(x, dict(c, control=z), dict(uc, control=z), z_override=z, **tile, **KW, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interval_one_is_bit_identical_to_the_plain_path(engines, case):
    """With churn (the generator's draws) and a padded last group of windows
    in the chunked case."""
    cfg, _, engine = engines
    x, c, uc, _, _ = _inputs(cfg, CASES[case][0], seed=42)
    z = engine.encode_first_stage_with_denoise(x)
    base = _run(engine, case, x, c, uc, z, s_churn=5.0)
    cached = _run(engine, case, x, c, uc, z, s_churn=5.0, feature_cache_interval=1)
    torch.testing.assert_close(cached, base, rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_interval_two_equals_jax(engines, case):
    cfg, jax_engine, torch_engine = engines
    x, c, uc, noise, center = _inputs(cfg, CASES[case][0], seed=43)
    kw = dict(noise_override=noise, center_noise_override=center, s_churn=0.0)
    z_jax = jax_engine.encode_first_stage_with_denoise(x)
    want = np.asarray(_run(jax_engine, case, x, c, uc, z_jax, feature_cache_interval=2, **kw))
    z = torch_engine.encode_first_stage_with_denoise(x)
    got = _run(torch_engine, case, x, c, uc, z, feature_cache_interval=2, **kw).numpy()
    plain = _run(torch_engine, case, x, c, uc, z, **kw).numpy()
    assert got.shape == plain.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SLICE_BOUND, rtol=0)
    assert np.abs(got - plain).max() > 1e-3  # an approximation, not a no-op


@pytest.mark.parametrize("case", ["untiled", "tiled_folded"])
def test_reuse_steps_skip_the_encoder_and_the_control_net(engines, monkeypatch, case):
    """GroupNorm calls (K2's sites on the card) of a 4-step run at interval
    2: two steps at every site of the UNet and the control net, two at the
    UNet's decoder, adapters and output head alone, as chip_smoke.py
    counts them."""
    import chip_smoke

    cfg, _, engine = engines
    x, c, uc, _, _ = _inputs(cfg, CASES[case][0], seed=44)
    z = engine.encode_first_stage_with_denoise(x)
    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1) or G.group_norm_plain(*a))
    kw = dict(KW, num_steps=4)
    tile = CASES[case][1]
    run = engine.batchify_sample_tiled if tile else engine.batchify_sample
    pooled = layers.GroupNorm32.pooled_sites
    run(x, dict(c, control=z), dict(uc, control=z), z_override=z, feature_cache_interval=2, **tile, **kw)
    assert layers.GroupNorm32.pooled_sites == pooled
    want = chip_smoke.expected_group_norm_launches(cfg, 2, reuse_steps=2, encodes=1, decodes=2)
    assert len(calls) == want > chip_smoke.expected_group_norm_launches(cfg, 2, encodes=1, decodes=2)
    full = chip_smoke.expected_group_norm_launches(cfg, 1, vae_passes=0)
    reuse = chip_smoke.expected_group_norm_launches(cfg, 0, reuse_steps=1, vae_passes=0)
    assert 0 < reuse < full


def test_cache_rejected_for_other_samplers(engines):
    """As the JAX engine: a ValueError for any other sampler, untiled or
    tiled, and for a negative interval."""
    cfg, _, engine = engines
    x, c, uc, _, _ = _inputs(cfg, 64, seed=45)
    z = engine.encode_first_stage_with_denoise(x)
    for name in ("EulerEDM", "Substep", "RestoreDPMPP2M"):
        with pytest.raises(ValueError, match="only supported with RestoreEDM"):
            _run(engine, "untiled", x, c, uc, z, sampler_name=name, feature_cache_interval=2)
    with pytest.raises(ValueError, match="only supported with TiledRestoreEDM"):
        _run(engine, "tiled_folded", x, c, uc, z, sampler_name="TiledRestoreDPMPP2M", feature_cache_interval=2)
    with pytest.raises(ValueError, match="< 0"):
        _run(engine, "untiled", x, c, uc, z, feature_cache_interval=-1)


def test_recompute_must_start_the_schedule():
    from supir_tpu_torch.diffusion import samplers as S

    with pytest.raises(ValueError, match="start True"):
        S.with_feature_cache(lambda *a: (a[0], None), [False, True], 2)
    with pytest.raises(ValueError, match="one flag a step"):
        S.with_feature_cache(lambda *a: (a[0], None), [True], 2)
