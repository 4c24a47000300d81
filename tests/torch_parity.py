"""Shared helpers for the parity tests of supir_tpu_torch against supir_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages. Weights start from the JAX package's own parameter shapes
(`eval_shape_params`, no init compile) and every leaf is filled with random
values, zero-initialised layers included: left at zero, those layers would
hide most of the network from the comparison.

Every tests/test_torch_*.py imports `one_torch_thread` from here, so its
tests run torch on one intra-op thread. They import this module as
`torch_parity` (pytest puts tests/ on the path), since another installed
package may own the top-level name `tests`. JAX is imported inside the
helpers that need it: the `gpu` tests import this module where JAX is not
installed.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one intra-op thread for the module's tests, the previous
    count restored after them. The suite runs six xdist workers; at torch's
    default of one thread per core they oversubscribe the cores over
    thousands of small tensor ops (one plan test: 1.3 s alone, 77 s with
    six copies at once, 0.7 s at one thread). A fixture, not import-time
    code: every worker imports every test module, the JAX package's too."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_leaf(name: str, shape, rng: np.random.Generator) -> np.ndarray:
    if name == "kernel":
        fan_in = math.prod(shape[:-1])
        v = rng.standard_normal(shape) * fan_in ** -0.5
    elif name == "scale":
        v = 1.0 + 0.1 * rng.standard_normal(shape)
    else:
        v = 0.1 * rng.standard_normal(shape)
    return v.astype(np.float32)


def random_params(shapes, seed: int):
    """A tree of jax.ShapeDtypeStruct (or arrays) -> the same tree of random
    float32 numpy leaves."""
    import jax

    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        return _random_leaf(path[-1].key, leaf.shape, rng)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_cfg():
    from supir_tpu.engine.factory import tiny_test_config

    cfg, _ = tiny_test_config()
    return cfg


def tiny_params(cfg, seed: int = 0):
    """Random {'unet', 'control', 'vae'} params of `cfg` (no conditioner)."""
    from supir_tpu.engine.factory import eval_shape_params

    return random_params(eval_shape_params(cfg, None, image_size=64), seed)


def sub_state_dict(sd, prefix: str):
    """Keys under `prefix.` with the prefix stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def nhwc(x) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), 1, -1))


def tiny_engine_pair(seed: int = 21):
    """(cfg, JAX engine, port cfg, port engine on the CPU): the tiny model
    with its conditioner, every leaf random from `seed`, in both packages."""
    import jax
    import jax.numpy as jnp

    from supir_tpu.engine import factory as JF
    from supir_tpu.engine.supir import SUPIREngine as JaxEngine
    from supir_tpu_torch.engine.factory import create_engine, tiny_test_config
    from supir_tpu_torch.utils.weights import state_dict_from_jax

    cfg, cond = JF.tiny_test_config()
    params = random_params(JF.eval_shape_params(cfg, cond, image_size=64), seed=seed)
    jengine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params), cond_cfg=cond)
    tcfg, tcond = tiny_test_config()
    tengine = create_engine(tcfg, "cpu", state_dict=state_dict_from_jax(params, cfg), cond_cfg=tcond)
    return cfg, jengine, tcfg, tengine


def inject_noise(engine, seed: int = 0):
    """Wrap engine.batchify_sample (JAX or port) so that its n-th call gets
    noise_override and center_noise_override drawn with numpy from (seed,
    n): the two packages draw different noise from a seed, so parity runs
    of an app that passes `seed` give both engines these draws instead.
    Returns the list of the calls' latent shapes."""
    original = engine.batchify_sample
    calls = []

    def wrapped(x, c, uc, **kw):
        shape = tuple(np.shape(c["control"]))
        rng = np.random.default_rng((seed, len(calls)))
        calls.append(shape)
        noise, center = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        return original(x, c, uc, noise_override=noise, center_noise_override=center, **kw)

    engine.batchify_sample = wrapped
    return calls
