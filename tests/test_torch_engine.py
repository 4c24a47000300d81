"""The port's restore slice end to end against the JAX engine, the weight
bridge, and the import boundary.

Slice: `batchify_sample` on a 64^2 image, tiny widths, fp32, 2 RestoreEDM
steps, s_churn=0, linear CFG 7.5->4.0, restoration 4.0, Wavelet colour fix,
with the initial and the x_center posterior noise injected (the two
packages' generators differ). Observed max abs error on the output image
(values within about [-2.5, 3.1]): 9.89e-6. Bound 5e-5, five times that
reading: fp32 summation order differs between the packages and may differ
between CPUs. For scale, semantic slips move the image further: CFG start
7.4 instead of 7.5 by 2.8e-3, restoration scale 4.4 instead of 4.0 by
5.9e-5.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.config import SUPIRConfig
from supir_tpu.engine.factory import eval_shape_params
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.utils import ckpt as C
from supir_tpu_torch.engine.factory import build_model, create_engine
from supir_tpu_torch.engine.supir import SUPIRModel
from supir_tpu_torch.utils import weights as W
from tests import torch_parity as P

SLICE_BOUND = 5e-5


@pytest.fixture(scope="module")
def tiny():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=7)
    return cfg, params


def _sample_inputs(cfg, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    c = {
        "crossattn": rng.standard_normal((1, 77, cfg.unet.context_dim)).astype(np.float32),
        "vector": rng.standard_normal((1, cfg.unet.adm_in_channels)).astype(np.float32),
    }
    uc = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in c.items()}
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    center = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    return x, c, uc, noise, center


SAMPLE_KW = dict(num_steps=2, restoration_scale=4.0, cfg_scale=4.0, use_linear_cfg=True,
                 cfg_scale_start=7.5, s_churn=0.0, color_fix_type="Wavelet", seed=3)


def test_batchify_sample_matches_jax(tiny):
    cfg, params = tiny
    x, c, uc, noise, center = _sample_inputs(cfg)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=W.state_dict_from_jax(params, cfg))

    z_jax = jax_engine.encode_first_stage_with_denoise(x)
    want = np.asarray(jax_engine.batchify_sample(
        x, dict(c, control=z_jax), dict(uc, control=z_jax), z_override=z_jax,
        noise_override=noise, center_noise_override=center, **SAMPLE_KW))

    z = torch_engine.encode_first_stage_with_denoise(x)
    got = torch_engine.batchify_sample(
        x, dict(c, control=z), dict(uc, control=z), z_override=z,
        noise_override=noise, center_noise_override=center, **SAMPLE_KW).numpy()

    assert got.shape == (1, 64, 64, 3) and np.isfinite(got).all()
    assert np.abs(want - np.asarray(jax_engine.decode_first_stage(z_jax))).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=SLICE_BOUND, rtol=0)


def test_sample_is_seeded_and_checks_overrides(tiny):
    cfg, params = tiny
    x, c, uc, _, _ = _sample_inputs(cfg, seed=9)
    engine = create_engine(cfg, "cpu", state_dict=W.state_dict_from_jax(params, cfg))
    z = engine.encode_first_stage_with_denoise(x)
    c, uc = dict(c, control=z), dict(uc, control=z)
    kw = dict(num_steps=2, s_churn=5.0, color_fix_type="None", z_override=z)
    a = engine.batchify_sample(x, c, uc, seed=5, **kw)
    b = engine.batchify_sample(x, c, uc, seed=5, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, engine.batchify_sample(x, c, uc, seed=6, **kw))
    with pytest.raises(ValueError, match="noise_override"):
        engine.batchify_sample(x, c, uc, noise_override=np.zeros((1, 4, 4, 4), np.float32), **kw)
    with pytest.raises(ValueError, match="center_noise_override"):
        engine.batchify_sample(x, c, uc, center_noise_override=np.zeros((1, 8, 8, 3), np.float32), **kw)
    with pytest.raises(NotImplementedError):
        engine.batchify_sample(x, c, uc, sampler_name="RestoreDPMPP2M", **kw)


def test_bridge_loads_strict_and_round_trips(tiny):
    cfg, params = tiny
    sd = W.state_dict_from_jax(params, cfg)
    model = build_model(cfg, "cpu", state_dict=sd)  # load_state_dict(strict=True)
    assert set(model.state_dict()) == set(sd)
    # the rebuilt UNet table is the JAX package's own
    assert W.light_glv_unet_rules(cfg.unet, cfg.control) == C.light_glv_unet_rules(cfg.unet, cfg.control)
    leaf = params["unet"]["enc"]["in_4_attn"]["block_0"]["attn1"]["to_q"]["Dense_0"]["kernel"]
    torch.testing.assert_close(
        model.state_dict()["model.diffusion_model.input_blocks.4.1.transformer_blocks.0.attn1.to_q.weight"],
        torch.from_numpy(leaf.T.copy()))


def test_bridge_covers_full_width():
    """At full SDXL width the port's module tree has exactly the keys and
    shapes the JAX tree bridges to (checked on the meta device: no memory)."""
    cfg = SUPIRConfig()
    shapes = eval_shape_params(cfg, None, image_size=64)
    with torch.device("meta"):
        model = SUPIRModel(cfg)
    port = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    bridged = {}
    for branch, rules in W.supir_rules(cfg).items():
        for tkey, fpath, kind in rules:
            leaf = shapes[branch]
            for p in fpath:
                leaf = leaf[p]
            shape = leaf.shape
            if kind == "linear":
                shape = shape[::-1]
            elif kind == "conv":
                shape = (shape[3], shape[2], shape[0], shape[1])
            bridged[tkey] = tuple(shape)
    assert port == bridged


def test_dropped_engine_is_freed(tiny):
    """Nothing class-level pins an engine or its weights (the JAX engine's
    per-instance caches keep the same property, tests/test_engine_lifecycle.py)."""
    import gc
    import weakref

    cfg, params = tiny
    engine = create_engine(cfg, "cpu", state_dict=W.state_dict_from_jax(params, cfg))
    x = np.zeros((1, 64, 64, 3), np.float32)
    engine.batchify_denoise(x)
    refs = [weakref.ref(engine), weakref.ref(engine.model)]
    del engine
    gc.collect()
    assert all(r() is None for r in refs)


def test_port_imports_no_jax():
    code = (
        "import sys, supir_tpu_torch.engine.supir, supir_tpu_torch.engine.factory, "
        "supir_tpu_torch.utils.weights\n"
        "bad = [m for m in ('jax', 'flax') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
