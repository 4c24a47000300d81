"""The rest of the port's sampler family against the JAX package on the CPU:
EulerEDM, HeunEDM, EulerAncestral, DPMPP2SAncestral, DPMPP2M, LMS and
Substep, their schedules and tables, with a shared toy denoiser and through
the engine at tiny width.

The two packages' random streams differ, so the port's samplers take JAX's
own draws through their noise hook: step i's draw is
`jax.random.normal(jax.random.split(rng, n)[i], shape)`, the key the JAX
sampler gives that step. The engine runs take them by a test-time
monkeypatch of the engine's sampler table (the hook bound in), with the
initial noise injected as `noise_override`. Every run churns (s_churn 5)
and the ancestral samplers run at eta 1 (the config's).

JAX's engine cannot run LMS: its jitted sampler function hands
`lms_sample` traced tables, from which the host-side coefficient table
cannot be built (TracerArrayConversionError; a test records it). The
engine comparison of LMS runs JAX's sampler function unjitted.

Bounds: schedules and the LMS table bit for bit (numpy on both sides);
the toy runs in fp32 to rel-L2 1e-4 and allclose atol/rtol 2e-3; the
engine runs 5e-5 max abs (the bound of tests/test_torch_engine.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.config import SamplerConfig as JaxSamplerConfig
from supir_tpu.diffusion import discretization as JD
from supir_tpu.diffusion import samplers as JS
from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu_torch.config import SamplerConfig
from supir_tpu_torch.diffusion import discretization as TD
from supir_tpu_torch.diffusion import samplers as S
from supir_tpu_torch.engine import supir as E
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.utils.weights import state_dict_from_jax
from tests import torch_parity as P
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
REL = 1e-4
SLICE_BOUND = 5e-5
NEW_SAMPLERS = ("EulerEDM", "HeunEDM", "EulerAncestral", "DPMPP2SAncestral", "DPMPP2M", "LMS", "Substep")


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= REL
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------------------ schedules and tables


@pytest.mark.parametrize("n,kw", [(1, {}), (8, {}), (25, {}), (6, dict(sigma_min=0.1, sigma_max=10.0, rho=3.0)),
                                  (5, dict(append_zero=False))])
def test_edm_sigmas_equal_jax(n, kw):
    np.testing.assert_array_equal(TD.edm_sigmas(n, **kw), JD.edm_sigmas(n, **kw))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_substep_sigmas_equal_jax(n):
    got = S.substep_sigmas(n)
    np.testing.assert_array_equal(got, JS.substep_sigmas(n))
    assert got.dtype == np.float32 and len(got) == n + 1 and got[-1] == 0 and (got[:-1] > 0).all()


def _toy(layout):
    """A fixed denoiser, linear in x with a tanh term, in either layout."""
    lib = torch if layout == "nchw" else jnp

    def f(x, sigma, cfg_b, ctrl_s):
        view = (-1,) + (1,) * (x.ndim - 1)
        s = sigma.reshape(view)
        return 0.7 * x / (1.0 + s * s) + 0.02 * cfg_b.reshape(view) * ctrl_s + 0.05 * lib.tanh(x)

    return f


def test_substep_at_five_steps_jax_is_not_finite_and_the_port_raises():
    """JAX's subset runs out at 5 steps: its schedule ends 0, 0 and the last
    ancestral step divides by sigma 0 (here with the denoiser x -> 0.5 x,
    as the defect was found). The port raises there, naming the cap."""
    x = np.random.default_rng(0).standard_normal((1, 4, 4, 4)).astype(np.float32)
    half = lambda x, sigma, cfg_b, ctrl_s: 0.5 * x  # noqa: E731
    for n, finite in ((4, True), (5, False), (50, False)):
        sigmas = JS.substep_sigmas(n)
        tables = JS.make_step_tables(sigmas, JaxSamplerConfig())
        out = np.asarray(JS.euler_ancestral_sample(half, jnp.asarray(x), jax.random.PRNGKey(0), tables))
        assert np.isfinite(out).all() == finite, n
    assert list(JS.substep_sigmas(5)[-2:]) == [0.0, 0.0]
    for n in (5, 50, 0):
        with pytest.raises(ValueError, match="1 to 4 steps"):
            S.substep_sigmas(n)


def _family_tables(name, n=4, s_churn=5.0):
    sigmas = S.substep_sigmas(n) if name == "Substep" else TD.legacy_ddpm_sigmas(n)
    cfg = SamplerConfig(s_churn=s_churn, restore_cfg=4.0, cfg_scale=7.5, cfg_scale_min=4.0, use_linear_cfg=True)
    return S.make_step_tables(sigmas, cfg, control_scale=0.8, use_linear_control_scale=True,
                              control_scale_start=0.2)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_lms_coefficients_equal_jax(n, monkeypatch):
    """The port's Adams-Bashforth table against the one JAX's `lms_sample`
    hands its scan (read off the scan's inputs)."""
    tables = _family_tables("LMS", n)
    seen = []
    scan = jax.lax.scan

    def spy(f, init, xs, *a, **k):
        seen.append(np.asarray(xs[-1]))
        return scan(f, init, xs, *a, **k)

    monkeypatch.setattr(jax.lax, "scan", spy)
    JS.lms_sample(_toy("nhwc"), jnp.zeros((1, 2, 2, 1)), jax.random.PRNGKey(0), tables)
    got = S.lms_coefficients(tables)
    assert got.shape == (n, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, seen[0])


# ------------------------------------------------------------------ the samplers with a toy denoiser


class JaxDraws:
    """JAX's per-step draws, keys split from one PRNGKey as the JAX
    samplers split them; `hook` hands step i's to the port in NCHW."""

    def __init__(self, seed: int, n: int, shape_nhwc):
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
        self.rng = jax.random.PRNGKey(seed)
        self.nhwc = np.stack([np.asarray(jax.random.normal(k, shape_nhwc, jnp.float32)) for k in keys])
        self.steps = []

    def hook(self, i, shape):
        self.steps.append(i)
        out = torch.from_numpy(P.nchw(self.nhwc[i]))
        assert tuple(out.shape) == tuple(shape)
        return out


RUNS = {  # name -> (JAX sampler, port sampler, keywords, takes the hook)
    "EulerEDM": (JS.euler_edm_sample, S.euler_edm_sample, dict(s_noise=1.003), True),
    "HeunEDM": (JS.heun_edm_sample, S.heun_edm_sample, dict(s_noise=1.003), True),
    "EulerAncestral": (JS.euler_ancestral_sample, S.euler_ancestral_sample, dict(eta=1.0, s_noise=1.003), True),
    "DPMPP2SAncestral": (JS.dpmpp2s_ancestral_sample, S.dpmpp2s_ancestral_sample, dict(eta=1.0, s_noise=1.003),
                         True),
    "DPMPP2M": (JS.dpmpp2m_sample, S.dpmpp2m_sample, {}, False),
    "LMS": (JS.lms_sample, S.lms_sample, {}, False),
    "Substep": (JS.euler_ancestral_sample, S.euler_ancestral_sample, dict(eta=1.0, s_noise=1.003), True),
}


@pytest.mark.parametrize("name", NEW_SAMPLERS)
def test_sampler_equals_jax_with_its_draws(name):
    """Each sampler on a [2, 6, 5, 4] latent, 4 steps with churn 5 (the EDM
    ones) or at eta 1 (the ancestral ones), JAX's draws injected; the
    noise draws are those of the steps that take noise."""
    tables = _family_tables(name)
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 4)).astype(np.float32) * 3.0
    draws = JaxDraws(2, tables.num_steps, x.shape)
    jax_fn, port_fn, kw, hooked = RUNS[name]
    want = jax_fn(_toy("nhwc"), jnp.asarray(x), draws.rng, tables, **kw)
    port_kw = dict(kw, noise=draws.hook) if hooked else kw
    seed_or_gen = 0 if name == "DPMPP2M" else torch.Generator()
    got = port_fn(_toy("nchw"), torch.from_numpy(P.nchw(x)), seed_or_gen, tables, **port_kw)
    _close(P.nhwc(got), np.asarray(want))
    if name in ("EulerEDM", "HeunEDM"):
        assert draws.steps == [i for i in range(tables.num_steps) if tables.churn_std[i] > 0] != []
    elif hooked:
        assert draws.steps == [i for i in range(tables.num_steps) if tables.next_sigma[i] > 0] != []


def test_samplers_make_the_stated_network_calls():
    """Heun corrects and DPM++(2S) takes its midpoint on every step but the
    one ending at sigma 0; the rest call the network once a step."""
    for name in NEW_SAMPLERS:
        tables = _family_tables(name, 5 if name != "Substep" else 4)
        calls = []

        def counted(x, sigma, cfg_b, ctrl_s):
            calls.append(1)
            return _toy("nchw")(x, sigma, cfg_b, ctrl_s)

        _, port_fn, kw, _ = RUNS[name]
        port_fn(counted, torch.ones(1, 4, 3, 3), 0 if name == "DPMPP2M" else torch.Generator(), tables, **kw)
        n = tables.num_steps
        assert len(calls) == (2 * n - 1 if name in ("HeunEDM", "DPMPP2SAncestral") else n), name


def test_noise_and_eta_move_the_ancestral_result():
    """eta 0 draws nothing and gives the same result for any generator;
    eta 1 takes its noise from the generator, or the hook."""
    tables = _family_tables("EulerAncestral")
    x = torch.randn(1, 4, 6, 6, generator=torch.Generator().manual_seed(3))
    run = functools.partial(S.euler_ancestral_sample, _toy("nchw"), x)
    ode = run(torch.Generator().manual_seed(1), tables, eta=0.0)
    torch.testing.assert_close(run(torch.Generator().manual_seed(2), tables, eta=0.0), ode, rtol=0, atol=0)
    sde = run(torch.Generator().manual_seed(1), tables, eta=1.0)
    torch.testing.assert_close(run(torch.Generator().manual_seed(1), tables, eta=1.0), sde, rtol=0, atol=0)
    assert (sde - ode).abs().max() > 1e-2
    zeros = run(None, tables, eta=1.0, noise=lambda i, shape: torch.zeros(shape))
    torch.testing.assert_close(zeros, run(None, tables, eta=1.0, noise=lambda i, shape: torch.zeros(shape)))
    assert not torch.equal(zeros, sde)


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engines():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=31)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=state_dict_from_jax(params, cfg))
    return cfg, jax_engine, torch_engine


def _engine_inputs(cfg, seed=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    c = {"crossattn": rng.standard_normal((1, 77, cfg.unet.context_dim)).astype(np.float32),
         "vector": rng.standard_normal((1, cfg.unet.adm_in_channels)).astype(np.float32)}
    uc = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in c.items()}
    noise, center = (rng.standard_normal((1, 8, 8, 4)).astype(np.float32) for _ in range(2))
    return x, c, uc, noise, center


@pytest.mark.parametrize("name", NEW_SAMPLERS)
def test_engine_sampler_equals_jax(engines, monkeypatch, name):
    """batchify_sample with each sampler, 3 steps, churn 5, eta 1, linear
    CFG 7.5 -> 4, restoration 4, Wavelet colour fix: the initial noise
    injected, and JAX's per-step draws (split from the seed's sampling key
    as the JAX engine splits it) through the port's noise hook."""
    cfg, jax_engine, torch_engine = engines
    x, c, uc, noise, center = _engine_inputs(cfg)
    steps, seed = 3, 5
    kw = dict(num_steps=steps, restoration_scale=4.0, cfg_scale=4.0, use_linear_cfg=True, cfg_scale_start=7.5,
              s_churn=5.0, color_fix_type="Wavelet", seed=seed, noise_override=noise, center_noise_override=center,
              sampler_name=name)
    _, rng_sample = jax.random.split(jax.random.PRNGKey(seed))
    keys = jax.random.split(rng_sample, steps)
    draws = [P.nchw(np.asarray(jax.random.normal(k, (1, 8, 8, 4), jnp.float32))) for k in keys]
    entry = "EulerAncestral" if name == "Substep" else name
    if RUNS[name][3]:
        monkeypatch.setitem(E.SAMPLERS, entry, functools.partial(
            E.SAMPLERS[entry], noise=lambda i, shape: torch.from_numpy(draws[i])))
    z_jax = jax_engine.encode_first_stage_with_denoise(x)
    with monkeypatch.context() as m:
        if name == "LMS":
            m.setattr(jax, "jit", lambda f, **_: f)
        want = np.asarray(jax_engine.batchify_sample(x, dict(c, control=z_jax), dict(uc, control=z_jax),
                                                     z_override=z_jax, **kw))
    z = torch_engine.encode_first_stage_with_denoise(x)
    got = torch_engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), z_override=z, **kw).numpy()
    assert got.shape == (1, 64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SLICE_BOUND, rtol=0)


def test_jax_engine_cannot_jit_lms(engines):
    """The JAX engine's LMS fails under its jit (traced tables reach the
    numpy coefficient table); the port's runs (the test above)."""
    cfg, jax_engine, _ = engines
    x, c, uc, noise, _ = _engine_inputs(cfg, seed=34)
    z = jax_engine.encode_first_stage_with_denoise(x)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax_engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), z_override=z, num_steps=2,
                                   noise_override=noise, sampler_name="LMS")


def test_engine_samplers_differ_and_substep_takes_its_schedule(engines):
    """Every name reaches a sampler of its own: the nine results at 3 steps
    differ pairwise (Substep from EulerAncestral on the LegacyDDPM table)."""
    cfg, _, engine = engines
    x, c, uc, noise, _ = _engine_inputs(cfg, seed=33)
    z = engine.encode_first_stage_with_denoise(x)
    outs = {name: engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), z_override=z, num_steps=3,
                                         noise_override=noise, s_churn=5.0, seed=1, sampler_name=name)
            for name in engine.SAMPLERS}
    assert len(outs) == 9
    names = sorted(outs)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            assert (outs[a] - outs[b]).abs().max() > 1e-4, (a, b)
