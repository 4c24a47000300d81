"""supir_tpu_torch modules against their supir_tpu counterparts, CPU, fp32,
tiny widths. The same random weights (every leaf, see tests/torch_parity.py)
go to both packages through the weight bridge; inputs come from numpy
seeds. Bound: atol/rtol 2e-3, the torch-golden bound of
tests/test_ref_golden_vae.py; at fp32 the two packages differ only in
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.models.attention import SpatialTransformer as JaxSpatialTransformer
from supir_tpu.models.unet import ResBlock as JaxResBlock
from supir_tpu.utils import ckpt as C
from supir_tpu_torch.engine.factory import create_engine
from supir_tpu_torch.models.attention import SpatialTransformer
from supir_tpu_torch.models.unet import ResBlock
from supir_tpu_torch.utils.weights import state_dict_from_jax, state_dict_from_rules
from tests import torch_parity as P

TOL = dict(atol=2e-3, rtol=2e-3)


def _module_pair(flax_module, torch_module, rules, seed, *inputs):
    shapes = jax.eval_shape(
        lambda: flax_module.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    )["params"]
    params = P.random_params(shapes, seed)
    sd = P.sub_state_dict(state_dict_from_rules(params, rules), "blk")
    torch_module.load_state_dict(sd, strict=True)
    return params


def test_resblock_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    emb = rng.standard_normal((2, 96)).astype(np.float32)
    flax_block = JaxResBlock(out_channels=64)
    block = ResBlock(32, 64, 96)
    params = _module_pair(flax_block, block, C._resblock("blk", (), has_skip=True), 1, x, emb)
    want = flax_block.apply({"params": params}, x, emb)
    got = block(torch.from_numpy(P.nchw(x)), torch.from_numpy(emb))
    np.testing.assert_allclose(P.nhwc(got.detach()), np.asarray(want), **TOL)


def test_spatial_transformer_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 24)).astype(np.float32)
    flax_st = JaxSpatialTransformer(in_channels=32, heads=2, dim_head=16, depth=2, context_dim=24)
    st = SpatialTransformer(32, 2, 16, depth=2, context_dim=24)
    params = _module_pair(flax_st, st, C._spatial_transformer("blk", (), 2), 3, x, ctx)
    want = flax_st.apply({"params": params}, x, ctx)
    got = st(torch.from_numpy(P.nchw(x)), torch.from_numpy(ctx))
    np.testing.assert_allclose(P.nhwc(got.detach()), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def engines():
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=4)
    jax_engine = JaxEngine(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    torch_engine = create_engine(cfg, "cpu", state_dict=state_dict_from_jax(params, cfg))
    return cfg, jax_engine, torch_engine


def test_network_matches_jax(engines):
    """GLVControl + LightGLVUNet on a CFG-doubled batch, against
    SUPIREngine._network."""
    cfg, jax_engine, torch_engine = engines
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999.0, 421.0], np.float32)
    cond = {
        "crossattn": rng.standard_normal((2, 77, cfg.unet.context_dim)).astype(np.float32),
        "vector": rng.standard_normal((2, cfg.unet.adm_in_channels)).astype(np.float32),
        "control": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
    }
    net = jax.jit(lambda p, x, t, cond: jax_engine._network(p, x, t, cond, 0.8))
    want = np.asarray(net(jax_engine.params, x, t, cond))
    tcond = {k: torch.from_numpy(P.nchw(v) if k == "control" else v) for k, v in cond.items()}
    with torch.no_grad():
        got = torch_engine._network(torch.from_numpy(P.nchw(x)), torch.from_numpy(t), tcond, 0.8)
    assert np.abs(want).max() > 0.1  # the random weights reach the output
    np.testing.assert_allclose(P.nhwc(got), want, **TOL)


def test_vae_encode_decode_matches_jax(engines):
    cfg, jax_engine, torch_engine = engines
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    z_den = torch_engine.encode_first_stage_with_denoise(x)
    np.testing.assert_allclose(
        z_den.numpy(), np.asarray(jax_engine.encode_first_stage_with_denoise(x)), **TOL)
    np.testing.assert_allclose(
        torch_engine.encode_first_stage(x).numpy(),
        np.asarray(jax_engine.encode_first_stage(x)), **TOL)
    np.testing.assert_allclose(
        torch_engine.encode_first_stage(x, noise=noise).numpy(),
        np.asarray(jax_engine.encode_first_stage(x, noise=noise)), **TOL)
    z = z_den.numpy()
    np.testing.assert_allclose(
        torch_engine.decode_first_stage(z).numpy(),
        np.asarray(jax_engine.decode_first_stage(z)), **TOL)
