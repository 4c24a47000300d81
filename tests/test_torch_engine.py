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

import dataclasses
import subprocess
import sys
from pathlib import Path

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
from torch_parity import one_torch_thread  # noqa: F401

SLICE_BOUND = 5e-5
ROOT = Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_port_imports_no_jax(target):
    """Every module of supir_tpu_torch, imported in a fresh interpreter,
    leaves no jax, flax or supir_tpu in sys.modules; chip_smoke.py (whose
    imports sit inside its phases) names none of them in any import."""
    if target == "package":
        code = (
            "import importlib, pkgutil, sys, supir_tpu_torch\n"
            "for m in pkgutil.walk_packages(supir_tpu_torch.__path__, 'supir_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'supir_tpu'))\n"
            "assert not bad, bad\n"
            "assert {'supir_tpu_torch.captioner.mpt', 'supir_tpu_torch.captioner.preprocess',\n"
            "        'supir_tpu_torch.captioner.train'} <= set(sys.modules)\n"
            "print(sum(m.startswith('supir_tpu_torch.') for m in sys.modules))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                             capture_output=True, text=True, cwd=ROOT).stdout
        assert int(out.split()[-1]) >= 30  # the walk reached the whole package
        return
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "supir_tpu_torch.engine.factory" in names
    bad = [m for m in names if m.split(".")[0] in ("jax", "flax", "supir_tpu")]
    assert not bad, bad


def test_port_config_equals_jax():
    """The port's own copy of the config dataclasses: the same fields and
    defaults as supir_tpu/config.py, tiny and scaled tables included."""
    from supir_tpu import config as JC
    from supir_tpu.engine.factory import tiny_test_config
    from supir_tpu_torch import config as TC

    def fields(cls):
        plain = lambda v: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v  # noqa: E731
        return [(f.name, plain(f.default)) for f in dataclasses.fields(cls)]

    for name in ("UNetConfig", "VAEConfig", "ControlConfig", "SamplerConfig", "SUPIRConfig"):
        assert fields(getattr(TC, name)) == fields(getattr(JC, name)), name
    assert dataclasses.asdict(TC.SUPIRConfig()) == dataclasses.asdict(JC.SUPIRConfig())
    assert dataclasses.asdict(TC.SUPIRConfig.tiny()) == dataclasses.asdict(JC.SUPIRConfig.tiny())
    want, _ = tiny_test_config()
    unet = dataclasses.replace(TC.UNetConfig().tiny(), context_dim=want.unet.context_dim,
                               adm_in_channels=want.unet.adm_in_channels)
    base = TC.SUPIRConfig.tiny()
    got = dataclasses.replace(base, unet=unet, control=dataclasses.replace(base.control, unet=unet),
                              ae_dtype="fp32", diffusion_dtype="fp32")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for cfg_t, cfg_j in ((got, want), (TC.SUPIRConfig(), JC.SUPIRConfig())):
        for prop in ("cond_output_channels", "project_channels", "concat_channels", "cross_attn_insert_idx"):
            assert getattr(cfg_t.control, prop) == getattr(cfg_j.control, prop), prop
        assert cfg_t.unet.middle_depth == cfg_j.unet.middle_depth
        assert cfg_t.vae.downscale_factor == cfg_j.vae.downscale_factor


def test_restore_rule_tables_equal_jax_at_full_width():
    """The port's rule table (utils/ckpt_rules.py through utils/weights.py)
    is the JAX package's, key for key and path for path, at full width."""
    from supir_tpu_torch import config as TC

    cfg = TC.SUPIRConfig()
    got = W.supir_rules(cfg)
    assert got["unet"] == C.light_glv_unet_rules(cfg.unet, cfg.control)
    assert got["control"] == C.glv_control_rules(cfg.unet)
    assert got["vae"] == C.vae_rules(cfg.vae)
    assert len(got["unet"]) > 1000


def test_create_engine_refuses_without_cuda(monkeypatch):
    """The entry point runs on the card unless the caller names the CPU;
    without a card it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_engine(P.tiny_cfg())
