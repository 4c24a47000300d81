"""The port's Lightning sampler against the JAX package on the CPU: the
Karras ramp and the Restore DPM++2M tables, DPM++(2M) at eta 0 and as the
SDE at eta 1, tiled and untiled, the engine's RestoreDPMPP2M and
TiledRestoreDPMPP2M paths, and the port's own virtual Brownian tree.

The two packages' Brownian trees draw from different generators, so the
SDE comparisons inject the same increments on both sides: a table of
noise, one entry per step, picked by the step's sigma. On the JAX side a
test-time monkeypatch replaces `supir_tpu.diffusion.samplers.
brownian_increment`, which `dpmpp2m_sample` reads at trace time and the
tiled sampler imports at call time; on the port's side the same for
`supir_tpu_torch.diffusion.samplers.brownian_increment`.

Bounds: tables bit for bit (numpy on both sides); tensors in fp32 to rel-L2
1e-4 and allclose atol/rtol 2e-3; the engine paths 5e-5 max abs (the bound
of tests/test_torch_engine.py). The tree's statistics on 200 000 draws: a
mean within 0.01 and a variance within 0.02 of 1 (about 5 standard errors),
a correlation within 0.015 of 0 over disjoint intervals and within 0.015
of sqrt(1/2) over [1, 3] and its half [2, 3].
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.config import SamplerConfig as JaxSamplerConfig
from supir_tpu.diffusion import discretization as JD
from supir_tpu.diffusion import samplers as JS
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.parallel import tiled_sampler as JTS
from supir_tpu_torch.config import SamplerConfig
from supir_tpu_torch.diffusion import discretization as TD
from supir_tpu_torch.diffusion import samplers as S
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.parallel import tiled_sampler as TS
from supir_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
REL = 1e-4
SLICE_BOUND = 5e-5
N_DRAWS = 200_000


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= REL
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("n", [1, 8, 25])
def test_karras_sigmas_and_restore_dpmpp2m_tables_equal_jax(n):
    base = TD.legacy_ddpm_sigmas(n)
    np.testing.assert_array_equal(TD.karras_sigmas(n, float(base[-2]), float(base[0])),
                                  JD.karras_sigmas(n, float(base[-2]), float(base[0])))
    np.testing.assert_array_equal(TD.karras_sigmas(n, 0.1, 10.0, rho=3.0), JD.karras_sigmas(n, 0.1, 10.0, rho=3.0))
    kw = dict(restore_cfg=-1.0, cfg_scale=2.0, cfg_scale_min=1.5, use_linear_cfg=True)
    control = dict(control_scale=0.9, use_linear_control_scale=True, control_scale_start=0.1)
    got = S.restore_dpmpp2m_tables(SamplerConfig(**kw), n, **control)
    want = JS.restore_dpmpp2m_tables(JaxSamplerConfig(**kw), n, **control)
    for name in ("sigma", "sigma_hat", "next_sigma", "churn_std", "cfg_scale", "control_scale", "restore_weight"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


# ------------------------------------------------------------------ the sampler


def _tables(n=6):
    return S.restore_dpmpp2m_tables(SamplerConfig(restore_cfg=-1.0, cfg_scale=2.0, cfg_scale_min=1.5), n,
                                    control_scale=0.8)


def _linear(layout):
    """A fixed denoiser, linear in x with a tanh term, in either layout."""
    lib = torch if layout == "nchw" else jnp

    def f(x, sigma, cfg_b, ctrl_s):
        view = (-1,) + (1,) * (x.ndim - 1)
        s = sigma.reshape(view)
        return 0.7 * x / (1.0 + s * s) + 0.02 * cfg_b.reshape(view) * ctrl_s + 0.05 * lib.tanh(x)

    return f


class Increments:
    """One noise array per step, picked by the step's sigma: the same
    'Brownian' increments for both packages. `nhwc` [steps, B, h, w, C]."""

    def __init__(self, sigmas: np.ndarray, shape_nhwc, seed: int):
        self.sigmas = np.asarray(sigmas, np.float32)
        self.nhwc = np.random.default_rng(seed).standard_normal((len(sigmas),) + tuple(shape_nhwc)).astype(np.float32)
        self.calls = []

    def jax(self, key, sigma_from, sigma_to, sigma_min, sigma_max, shape, dtype=jnp.float32, levels=24):
        table = jnp.asarray(self.sigmas).reshape((-1,) + (1,) * len(shape))
        return jnp.sum(jnp.where(table == sigma_from, jnp.asarray(self.nhwc), 0.0), axis=0).astype(dtype)

    def torch(self, seed, sigma_from, sigma_to, sigma_min, sigma_max, shape, device="cpu", levels=24):
        i = int(np.flatnonzero(self.sigmas == np.float32(sigma_from))[0])
        self.calls.append(i)
        return torch.from_numpy(P.nchw(self.nhwc[i])).to(device)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_dpmpp2m_sample_equals_jax(eta, monkeypatch):
    tables = _tables()
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 4)).astype(np.float32)  # NHWC
    inc = Increments(tables.sigma, x.shape, seed=2)
    monkeypatch.setattr(JS, "brownian_increment", inc.jax)
    monkeypatch.setattr(S, "brownian_increment", inc.torch)
    want = JS.dpmpp2m_sample(_linear("nhwc"), jnp.asarray(x), jax.random.PRNGKey(0), tables, eta=eta, s_noise=1.003)
    got = S.dpmpp2m_sample(_linear("nchw"), torch.from_numpy(P.nchw(x)), 0, tables, eta=eta, s_noise=1.003)
    _close(P.nhwc(got), np.asarray(want))
    # the SDE takes noise on every step but the first and the terminal one
    assert inc.calls == (list(range(1, tables.num_steps - 1)) if eta else [])


def test_dpmpp2m_noise_moves_the_result():
    tables = _tables()
    x = torch.randn(1, 4, 6, 6, generator=torch.Generator().manual_seed(3))
    ode = S.dpmpp2m_sample(_linear("nchw"), x, 0, tables, eta=0.0)
    sde = S.dpmpp2m_sample(_linear("nchw"), x, 0, tables, eta=1.0)
    torch.testing.assert_close(sde, S.dpmpp2m_sample(_linear("nchw"), x, 0, tables, eta=1.0), rtol=0, atol=0)
    assert (sde - ode).abs().max() > 1e-2
    assert not torch.equal(sde, S.dpmpp2m_sample(_linear("nchw"), x, 1, tables, eta=1.0))


def test_tiled_dpmpp2m_sample_equals_jax(monkeypatch):
    """TiledRestoreDPMPP2M on a ragged 13x22 latent in 8-px windows at
    stride 3, the increments injected."""
    tables = _tables(5)
    rng = np.random.default_rng(4)
    x, control = (rng.standard_normal((2, 13, 22, 4)).astype(np.float32) for _ in range(2))
    inc = Increments(tables.sigma, x.shape, seed=5)
    monkeypatch.setattr(JS, "brownian_increment", inc.jax)
    monkeypatch.setattr(S, "brownian_increment", inc.torch)
    starts, _, _ = TS.make_tile_plan(13, 22, 8, 3)

    def tile_denoiser(layout):
        lib = torch if layout == "nchw" else jnp

        def f(xt, sigma, cfg_b, ctrl_s, ct, ca):
            s, cf = sigma.reshape(1, -1, 1, 1, 1), cfg_b.reshape(1, -1, 1, 1, 1)
            return 0.7 * xt / (1.0 + s * s) + 0.02 * cf * ctrl_s + 0.05 * lib.tanh(xt) + 0.1 * ct

        return f

    want = JTS.tiled_restore_dpmpp2m_sample(
        tile_denoiser("nhwc"), jnp.asarray(x), jax.random.PRNGKey(0), tables,
        control_tiles=JTS._gather_tiles(jnp.asarray(control), starts, 8), tile_size=8, tile_stride=3)
    got = TS.tiled_restore_dpmpp2m_sample(
        tile_denoiser("nchw"), torch.from_numpy(P.nchw(x)), 0, tables,
        control_tiles=TS._gather_tiles(torch.from_numpy(P.nchw(control)), starts, 8), tile_size=8, tile_stride=3)
    _close(P.nhwc(got), np.asarray(want))
    assert inc.calls == list(range(1, tables.num_steps - 1))


# ------------------------------------------------------------------ the Brownian tree


def test_brownian_tree_is_a_function_of_seed_and_time():
    shape = (3, 5)
    alone = S.vbt_value(7, 0.7, 0.03, 14.6, shape)
    for t in (0.3, 14.0, 0.71, 0.03):
        S.vbt_value(7, t, 0.03, 14.6, shape)
    torch.testing.assert_close(S.vbt_value(7, 0.7, 0.03, 14.6, shape), alone, rtol=0, atol=0)
    assert not torch.equal(S.vbt_value(8, 0.7, 0.03, 14.6, shape), alone)
    assert torch.equal(S.vbt_value(7, 0.03, 0.03, 14.6, shape), torch.zeros(shape))  # pinned at t0
    a = S.brownian_increment(7, 2.0, 1.0, 0.03, 14.6, shape)
    torch.testing.assert_close(S.brownian_increment(7, 1.0, 2.0, 0.03, 14.6, shape), a, rtol=0, atol=0)
    assert S.node_seed(7, 3, 5) == S.node_seed(7, 3, 5) != S.node_seed(7, 3, 4)


def test_brownian_increments_have_unit_variance_and_are_uncorrelated():
    lo, hi = 0.0292, 14.6146  # the Lightning schedule's span
    a = S.brownian_increment(11, 1.0, 2.0, lo, hi, (N_DRAWS,)).double()
    b = S.brownian_increment(11, 2.0, 3.5, lo, hi, (N_DRAWS,)).double()
    whole = S.brownian_increment(11, 1.0, 3.0, lo, hi, (N_DRAWS,)).double()
    half = S.brownian_increment(11, 2.0, 3.0, lo, hi, (N_DRAWS,)).double()
    for inc in (a, b, whole, half):
        assert abs(inc.mean().item()) < 0.01 and abs(inc.var().item() - 1.0) < 0.02
    corr = lambda u, v: torch.corrcoef(torch.stack([u, v]))[0, 1].item()  # noqa: E731
    assert abs(corr(a, b)) < 0.015
    # an increment and its own second half: W(3) - W(2) is half of W(3) - W(1)
    assert abs(corr(whole, half) - math.sqrt(0.5)) < 0.015


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engines():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=21)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=state_dict_from_jax(params, cfg))
    return cfg, jax_engine, torch_engine


@pytest.mark.parametrize("tiled", [False, True], ids=["untiled", "tiled"])
def test_engine_restore_dpmpp2m_equals_jax(engines, monkeypatch, tiled):
    """batchify_sample with RestoreDPMPP2M (a 64x64 image) and
    batchify_sample_tiled with TiledRestoreDPMPP2M (96x96, four windows of
    8 latent px at stride 4), 3 steps at the config's eta 1, the initial
    noise and the increments injected."""
    cfg, jax_engine, torch_engine = engines
    side = 96 if tiled else 64
    rng = np.random.default_rng(22)
    x = rng.uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
    c = {"crossattn": rng.standard_normal((1, 77, cfg.unet.context_dim)).astype(np.float32),
         "vector": rng.standard_normal((1, cfg.unet.adm_in_channels)).astype(np.float32)}
    uc = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in c.items()}
    lat = (1, side // 8, side // 8, 4)
    noise, center = (rng.standard_normal(lat).astype(np.float32) for _ in range(2))
    steps = 3
    inc = Increments(JS.restore_dpmpp2m_tables(JaxSamplerConfig(), steps).sigma, lat, seed=23)
    monkeypatch.setattr(JS, "brownian_increment", inc.jax)
    monkeypatch.setattr(S, "brownian_increment", inc.torch)
    kw = dict(num_steps=steps, restoration_scale=-1.0, cfg_scale=1.5, use_linear_cfg=True, cfg_scale_start=2.0,
              s_churn=0.0, color_fix_type="AdaIn", seed=3, noise_override=noise, center_noise_override=center)
    if tiled:
        kw.update(tile_size=8, tile_stride=4, sampler_name="TiledRestoreDPMPP2M")
    else:
        kw.update(sampler_name="RestoreDPMPP2M")
    z_jax = jax_engine.encode_first_stage_with_denoise(x)
    run = "batchify_sample_tiled" if tiled else "batchify_sample"
    want = np.asarray(getattr(jax_engine, run)(x, dict(c, control=z_jax), dict(uc, control=z_jax), z_override=z_jax,
                                               **kw))
    z = torch_engine.encode_first_stage_with_denoise(x)
    got = getattr(torch_engine, run)(x, dict(c, control=z), dict(uc, control=z), z_override=z, **kw).numpy()
    assert got.shape == (1, side, side, 3) and np.isfinite(got).all()
    assert inc.calls == [1]  # the one step between the first and the terminal one
    np.testing.assert_allclose(got, want, atol=SLICE_BOUND, rtol=0)
