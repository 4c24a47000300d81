"""The rest of models/unet.py and models/control.py against the JAX package
on the CPU, fp32, tiny widths: LightGLVUNet's feature cache
(`return_features`, `feature_cache`), the plain SDXL `UNetModel` and its
rule table, `ZeroConv`, `GLVControl(input_upscale=2)` with
`ops/resize.py:bilinear_resize` (against `jax.image.resize`, up and down),
and the progressive adapter masks (mirroring
tests/test_parity_fixes.py:143-200). Weights: every leaf random, through
the weight bridge. Bound: atol/rtol 2e-3, as tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.config import SUPIRConfig as JaxSUPIRConfig
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.models import control as JC
from supir_tpu.models.unet import UNetModel as JaxUNetModel
from supir_tpu.utils import ckpt as JCkpt
from supir_tpu_torch.config import SUPIRConfig
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.models import control as TC
from supir_tpu_torch.models.unet import UNetModel
from supir_tpu_torch.ops.resize import bilinear_resize
from supir_tpu_torch.utils import ckpt_rules as R
from supir_tpu_torch.utils.weights import plain_unet_state_dict_from_jax, state_dict_from_jax, state_dict_from_rules
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)


def _close(got, want):
    want = np.asarray(want)
    got = P.nhwc(got.detach()) if torch.is_tensor(got) and got.dim() == 4 else np.asarray(got)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def engines():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=51)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=state_dict_from_jax(params, cfg))
    return cfg, params, jax_engine, torch_engine


def _net_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 421.0], np.float32)
    ca = rng.standard_normal((2, 77, cfg.unet.context_dim)).astype(np.float32)
    vec = rng.standard_normal((2, cfg.unet.adm_in_channels)).astype(np.float32)
    hint = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    return x, t, ca, vec, hint


def _torch_control(torch_engine, hint, t, x, ca, vec):
    net = torch_engine.model.model["control_model"]
    return net(torch.from_numpy(P.nchw(hint)), torch.from_numpy(t), torch.from_numpy(P.nchw(x)),
               torch.from_numpy(ca), torch.from_numpy(vec))


# ------------------------------------------------------------------ LightGLVUNet's feature cache


@torch.no_grad()
def test_unet_return_features_and_feature_cache_equal_jax(engines):
    """return_features gives JAX's (hs, h); a call at another timestep on
    those features (feature_cache) gives JAX's, runs the time embedding
    fresh (it differs from the call that made them) and leaves the cache
    whole for the next reuse."""
    cfg, params, jax_engine, torch_engine = engines
    x, t, ca, vec, hint = _net_inputs(cfg, 52)
    unet = torch_engine.model.model["diffusion_model"]
    jctrl = jax_engine.control_net.apply({"params": params["control"]}, hint, t, x, ca, vec)
    want_out, (want_hs, want_h) = jax_engine.unet.apply({"params": params["unet"]}, x, t, ca, vec, jctrl, 0.8,
                                                        return_features=True)
    ctrl = _torch_control(torch_engine, hint, t, x, ca, vec)
    out, (hs, h) = unet(torch.from_numpy(P.nchw(x)), torch.from_numpy(t), torch.from_numpy(ca),
                        torch.from_numpy(vec), ctrl, 0.8, return_features=True)
    _close(out, want_out)
    assert len(hs) == len(want_hs) == 9
    for got_f, want_f in zip(hs + [h], list(want_hs) + [want_h]):
        _close(got_f, want_f)

    t2 = np.array([500.0, 120.0], np.float32)
    x2 = x + 0.3
    want2 = jax_engine.unet.apply({"params": params["unet"]}, x2, t2, ca, vec, jctrl, 0.8,
                                  feature_cache=(want_hs, want_h))
    cache = (hs, h)
    for _ in range(2):  # the second reuse sees the whole cache again
        got2 = unet(torch.from_numpy(P.nchw(x2)), torch.from_numpy(t2), torch.from_numpy(ca),
                    torch.from_numpy(vec), ctrl, 0.8, feature_cache=cache)
        _close(got2, want2)
        assert len(cache[0]) == 9
    fresh = unet(torch.from_numpy(P.nchw(x2)), torch.from_numpy(t2), torch.from_numpy(ca), torch.from_numpy(vec),
                 ctrl, 0.8)
    assert (fresh - got2).abs().max() > 1e-3
    stale = unet(torch.from_numpy(P.nchw(x2)), torch.from_numpy(t), torch.from_numpy(ca), torch.from_numpy(vec),
                 ctrl, 0.8, feature_cache=cache)
    assert (stale - got2).abs().max() > 1e-3  # the timestep reaches a reuse call


# ------------------------------------------------------------------ the plain UNet


def test_plain_unet_rules_equal_jax():
    for cfg_t, cfg_j in ((SUPIRConfig().unet, JaxSUPIRConfig().unet), (P.tiny_cfg().unet, P.tiny_cfg().unet)):
        assert R.plain_unet_rules(cfg_t) == JCkpt.plain_unet_rules(cfg_j)
        assert R.plain_unet_rules(cfg_t, tk="") == JCkpt.plain_unet_rules(cfg_j, tk="")


@torch.no_grad()
def test_unet_model_equals_jax():
    cfg = P.tiny_cfg().unet
    x, t, ca, vec, _ = _net_inputs(P.tiny_cfg(), 53)
    jmodel = JaxUNetModel(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, t, ca, vec))["params"]
    params = P.random_params(shapes, 54)
    want = jmodel.apply({"params": params}, x, t, ca, vec)
    model = UNetModel(cfg)
    model.load_state_dict(plain_unet_state_dict_from_jax(params, cfg), strict=True)
    got = model(torch.from_numpy(P.nchw(x)), torch.from_numpy(t), torch.from_numpy(ca), torch.from_numpy(vec))
    assert np.abs(np.asarray(want)).max() > 0.1 and got.dtype == torch.float32
    _close(got, want)


def test_unet_model_keys_are_the_references_at_full_width():
    """UNetModel's state dict at full width holds exactly the plain rule
    table's keys (on the meta device), and its decoder the LightGLVUNet's
    output blocks and head."""
    cfg = SUPIRConfig()
    with torch.device("meta"):
        model = UNetModel(cfg.unet)
        light = TC.LightGLVUNet(cfg.unet, cfg.control)
    keys = set(model.state_dict())
    assert keys == {k for k, _, _ in R.plain_unet_rules(cfg.unet, tk="")}
    assert keys == {k for k in light.state_dict() if not k.startswith("project_modules.")}


# ------------------------------------------------------------------ ZeroConv


@pytest.mark.parametrize("with_stream", [False, True])
def test_zero_conv_equals_jax(with_stream):
    rng = np.random.default_rng(55)
    c = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    h = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    h_ori = rng.standard_normal((2, 4, 4, 12)).astype(np.float32) if with_stream else None
    jmod = JC.ZeroConv(norm_nc=16)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), c, h, h_ori))["params"]
    params = P.random_params(shapes, 56)
    want = jmod.apply({"params": params}, c, h, h_ori)
    mod = TC.ZeroConv(8, 16)
    mod.load_state_dict(P.sub_state_dict(state_dict_from_rules(params, R._conv("blk.zero_conv", ("zero_conv",))),
                                         "blk"), strict=True)
    got = mod(*(None if a is None else torch.from_numpy(P.nchw(a)) for a in (c, h, h_ori)))
    _close(got, want)
    assert got.shape[1] == (28 if with_stream else 16)
    assert mod.zero_conv.zero_init  # the factory's init_random zeroes it


# ------------------------------------------------------------------ input_upscale and the resize


RESIZES = {"up2": ((8, 8), (16, 16)), "down2": ((16, 16), (8, 8)), "down_odd": ((12, 10), (5, 4)),
           "up_odd": ((7, 10), (10, 23)), "mixed": ((10, 7), (7, 10))}


@pytest.mark.parametrize("antialias", [True, False], ids=["aa", "plain"])
@pytest.mark.parametrize("case", sorted(RESIZES))
def test_bilinear_resize_equals_jax_image_resize(case, antialias):
    (h, w), (oh, ow) = RESIZES[case]
    x = np.random.default_rng(57).standard_normal((2, h, w, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, oh, ow, 3), "bilinear", antialias=antialias)
    got = bilinear_resize(torch.from_numpy(P.nchw(x)), (oh, ow), antialias=antialias)
    np.testing.assert_allclose(P.nhwc(got), np.asarray(want), atol=1e-6, rtol=1e-6)


@torch.no_grad()
def test_glv_control_input_upscale_equals_jax(engines):
    """input_upscale 2: the LQ latent at half the noisy latent's side,
    resized inside (antialiased bilinear) before the hint conv."""
    cfg, params, _, torch_engine = engines
    x, t, ca, vec, _ = _net_inputs(cfg, 58)
    hint = np.random.default_rng(59).standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = JC.GLVControl(cfg.unet, input_upscale=2).apply({"params": params["control"]}, hint, t, x, ca, vec)
    net = TC.GLVControl(cfg.unet, input_upscale=2)
    net.load_state_dict(torch_engine.model.model["control_model"].state_dict(), strict=True)
    got = net(torch.from_numpy(P.nchw(hint)), torch.from_numpy(t), torch.from_numpy(P.nchw(x)),
              torch.from_numpy(ca), torch.from_numpy(vec))
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------------ progressive adapter masks


def test_progressive_adapter_masks_equal_jax():
    cfg = P.tiny_cfg()
    for stage in range(6):
        got = TC.progressive_adapter_masks(cfg.control, stage)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JC.progressive_adapter_masks(cfg.control, stage)))
    assert TC.progressive_adapter_masks(cfg.control, 0).sum() == 11
    assert TC.progressive_adapter_masks(cfg.control, 4).sum() == 0


@torch.no_grad()
@pytest.mark.parametrize("stage", [0, 1, 2, 3, "all"])
def test_adapter_masks_equal_jax(engines, stage):
    """The UNet with each stage's masks (and every adapter masked) against
    JAX's; with every adapter masked the control features change nothing."""
    cfg, params, jax_engine, torch_engine = engines
    x, t, ca, vec, hint = _net_inputs(cfg, 60)
    n = len(cfg.control.cond_output_channels) + len(cfg.control.cross_attn_insert_idx)
    masks = (np.ones(n, np.float32) if stage == "all"
             else np.asarray(JC.progressive_adapter_masks(cfg.control, stage)))
    jctrl = jax_engine.control_net.apply({"params": params["control"]}, hint, t, x, ca, vec)
    want = jax_engine.unet.apply({"params": params["unet"]}, x, t, ca, vec, jctrl, 0.8,
                                 adapter_masks=jnp.asarray(masks))
    unet = torch_engine.model.model["diffusion_model"]
    ctrl = _torch_control(torch_engine, hint, t, x, ca, vec)
    args = (torch.from_numpy(P.nchw(x)), torch.from_numpy(t), torch.from_numpy(ca), torch.from_numpy(vec))
    got = unet(*args, ctrl, 0.8, adapter_masks=torch.from_numpy(masks))
    _close(got, want)
    moved = unet(*args, [c + 1.0 for c in ctrl], 0.8, adapter_masks=torch.from_numpy(masks))
    if stage == "all":
        torch.testing.assert_close(moved, got, atol=1e-5, rtol=0)
    else:
        assert (moved - got).abs().max() > 1e-3


@pytest.mark.parametrize("mode", ["XL-base", "XL-refine"])
def test_control_mode_tables_equal_jax(mode):
    """The port's mode tables and adapter layout at full width, XL-refine
    (the refiner's wider, deeper tables) included."""
    from supir_tpu.config import ControlConfig as JaxControlConfig
    from supir_tpu_torch.config import ControlConfig

    got, want = ControlConfig(mode=mode), JaxControlConfig(mode=mode)
    for prop in ("cond_output_channels", "project_channels", "concat_channels", "cross_attn_insert_idx"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert TC._build_adapter_specs(got) == JC._build_adapter_specs(want)
    n = len(got.cond_output_channels) + len(got.cross_attn_insert_idx)
    assert TC.progressive_adapter_masks(got, 0).shape == (n,)
