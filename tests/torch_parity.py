"""Shared helpers for the parity tests of supir_tpu_torch against supir_tpu.

Inputs and weights are made with numpy from a seed and handed to both
packages. Weights start from the JAX package's own parameter shapes
(`eval_shape_params`, no init compile) and every leaf is filled with random
values, zero-initialised layers included: left at zero, those layers would
hide most of the network from the comparison.
"""

from __future__ import annotations

import math

import jax
import numpy as np

from supir_tpu.engine.factory import eval_shape_params, tiny_test_config


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
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        return _random_leaf(path[-1].key, leaf.shape, rng)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tiny_cfg():
    cfg, _ = tiny_test_config()
    return cfg


def tiny_params(cfg, seed: int = 0):
    """Random {'unet', 'control', 'vae'} params of `cfg` (no conditioner)."""
    return random_params(eval_shape_params(cfg, None, image_size=64), seed)


def sub_state_dict(sd, prefix: str):
    """Keys under `prefix.` with the prefix stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def nhwc(x) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), 1, -1))
