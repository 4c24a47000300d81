"""The port's multi-device modules against the JAX package on the CPU:
`parallel/mesh.py`, the FSDP rule of `parallel/sharding.py`,
`parallel/ring_attention.py` and its routing in `ops/attention.py`, the
tile-mesh forms of the tiled VAE and the tiled denoiser, and
`utils/flops.py`.

The port's side runs in four spawned gloo ranks (tests/torch_ranks.py,
one module-scoped spawn, started before the JAX side so that the two
overlap); the JAX side runs here on its 8 virtual CPU devices, on the
meshes its own tests build. Bounds: mesh shapes, errors, the sharding
rule, the routing decisions and the FLOP counts exact; ring attention
2e-5 (tests/test_ring_attention.py's); the tiled encode 1e-4
(tests/test_tiled_vae.py's mesh test); the tiled denoiser 1e-6
(tests/test_tiled_sampler.py's).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supir_tpu.config import SUPIRConfig as JaxSUPIRConfig
from supir_tpu.ops.attention import _xla_attention, dot_product_attention, sequence_sharding
from supir_tpu.parallel import mesh as JM
from supir_tpu.parallel import sharding as JS
from supir_tpu.parallel.ring_attention import ring_attention as jax_ring
from supir_tpu.parallel.tiled_sampler import make_tiled_denoise as jax_tiled_denoise
from supir_tpu.parallel.tiled_vae import tiled_encode as jax_tiled_encode
from supir_tpu.utils import flops as JF
from supir_tpu_torch import config as TC
from supir_tpu_torch.parallel import sharding as TS
from supir_tpu_torch.utils import flops as TF
from supir_tpu_torch.utils.weights import state_dict_from_jax
import torch_parity as P
import torch_ranks
from torch_parity import one_torch_thread  # noqa: F401

WORLD = 4
SIZES = (2, 4)
RING = (2, 64, 2, 16)        # [B, S, H, D], tests/test_ring_attention.py's
ROUTE = (1, 256, 2, 16)      # the dispatch tests' shape
ROUTE_MIN_SEQ = 256
VAE_IMAGE, VAE_TILE, VAE_PAD = 96, 32, 16  # 3x3 = 9 tiles: padded on 2 and on 4 ranks


def _inputs():
    rng = np.random.default_rng(5)
    ring = [rng.standard_normal(RING).astype(np.float32) for _ in range(3)]
    route = rng.standard_normal(ROUTE).astype(np.float32)
    x = rng.uniform(-1, 1, (1, VAE_IMAGE, VAE_IMAGE, 3)).astype(np.float32)
    x_tiles = rng.standard_normal((9, 2, 8, 8, 4)).astype(np.float32)
    control = rng.standard_normal((9, 2, 8, 8, 4)).astype(np.float32)
    return ring, route, x, x_tiles, control


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the ranks' results, the inputs, the tiny JAX VAE params): the port's
    side in four ranks, spawned before the JAX side runs."""
    ring, route, x, x_tiles, control = _inputs()
    cfg = P.tiny_cfg()
    params = P.tiny_params(cfg, seed=11)
    vae_sd = P.sub_state_dict(state_dict_from_jax(params, cfg), "first_stage_model")
    handle = torch_ranks.spawn(
        WORLD, tmp_path_factory.mktemp("parallel"),
        mesh_errors={},
        ring=dict(q=ring[0], k=ring[1], v=ring[2], sizes=SIZES),
        routing=dict(q=route, min_seq=ROUTE_MIN_SEQ),
        tiled_vae=dict(state_dict=vae_sd, cfg=_port_vae_cfg(cfg), x=P.nchw(x), tile=VAE_TILE, pad=VAE_PAD,
                       sizes=SIZES),
        tiled_denoise=dict(x_tiles=_tiles_nchw(x_tiles), control=_tiles_nchw(control), sigma=np.full(2, 3.0, np.float32),
                           cfg=np.full(2, 5.0, np.float32), sizes=SIZES),
    )
    return handle, (ring, route, x, x_tiles, control), params


def _tiles_nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 2))


def _port_vae_cfg(cfg):
    return TC.VAEConfig(**dataclasses.asdict(cfg.vae))


@pytest.fixture(scope="module")
def results(ranks):
    handle, inputs, params = ranks
    return handle.join(), inputs, params


# ------------------------------------------------------------------ mesh


def test_make_mesh_shapes_and_errors_equal_jax(results):
    got = results[0][0]["mesh_errors"]
    devices = jax.devices()[:WORLD]
    for key, (shape, sizes) in ((k, v) for k, v in got.items() if k != "error"):
        axis_sizes, names = key
        want = JM.make_mesh(axis_sizes, names, devices=devices)
        assert shape == tuple(want.devices.shape)
        assert sizes == {a: want.shape[a] for a in names}
    with pytest.raises(ValueError) as e:
        JM.make_mesh((2, 4), ("data", "model"), devices=devices)
    assert got["error"] == str(e.value)


# ------------------------------------------------------------------ the sharding rule


def _leaf_shapes(tree):
    return [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(tree)]


@functools.cache
def _rule_shapes():
    """Every leaf shape of the JAX tiny engine with its conditioner, and
    every tensor shape of the port's full-width XL-base engine with its
    text towers (built on the meta device: the JAX full-width tree takes
    25 s to trace)."""
    from supir_tpu.engine import factory as JFac
    from supir_tpu_torch.engine.supir import SUPIRModel

    cfg, cond = JFac.tiny_test_config()
    shapes = _leaf_shapes(JFac.eval_shape_params(cfg, cond, image_size=64))
    full = SUPIRModel(TC.SUPIRConfig(), device="meta", cond_cfg=TC.ConditionerConfig())
    shapes += [tuple(v.shape) for v in full.state_dict().values()]
    return sorted(set(shapes))


def test_fsdp_spec_equals_jax_on_every_leaf():
    """The rule at model-axis sizes 1, 2, 4 and 8; the captioner's leaves
    are held in tests/test_torch_sharded_engine.py, on its sharded ranks."""
    shapes = _rule_shapes()
    assert len(shapes) > 100
    for n in (1, 2, 4, 8):
        for shape in shapes:
            assert TS.fsdp_spec(shape, n) == tuple(JS._fsdp_spec(shape, n)), (shape, n)


def test_shardings_hold_jax_bytes_per_device():
    """replicated, batch_sharding and an FSDP leaf: one rank's bytes equal
    one JAX device's, on a (1, 1, 2) mesh."""
    mesh = JM.make_mesh((1, 1, 2), ("data", "tile", "model"), devices=jax.devices()[:2])

    class Mesh:  # the port's Sharding reads only axis sizes and this rank's index
        mesh_dim_names = ("data", "tile", "model")

        def size(self, i):
            return (1, 1, 2)[i]

        def get_local_rank(self, axis):
            return 0

    tmesh = Mesh()
    for shape in ((640, 320, 3, 3), (320,), (5, 7), (2, 6, 4)):
        x = jnp.zeros(shape, jnp.float32)
        for jsh, tsh in ((JS.replicated(mesh), TS.replicated(tmesh)),
                         (JS.NamedSharding(mesh, JS._fsdp_spec(shape, 2)),
                          TS.Sharding(tmesh, TS.fsdp_spec(shape, 2)))):
            want = jax.device_put(x, jsh).addressable_shards[0].data.nbytes
            assert tsh.local_nbytes(shape, 4) == want, shape
            assert tsh.local(torch.zeros(shape)).numel() * 4 == want
    jb = JM.make_mesh((2, 1, 1), ("data", "tile", "model"), devices=jax.devices()[:2])

    class Batch(Mesh):
        def size(self, i):
            return (2, 1, 1)[i]

    x = jnp.zeros((4, 3), jnp.float32)
    want = jax.device_put(x, JS.batch_sharding(jb, 2)).addressable_shards[0].data.nbytes
    assert TS.batch_sharding(Batch(), 2).local_nbytes((4, 3), 4) == want
    module = torch.nn.Sequential(torch.nn.Conv2d(320, 640, 3), torch.nn.GroupNorm(32, 640))
    for key, sh in TS.fsdp_param_shardings(module, tmesh).items():
        shape = tuple(module.state_dict()[key].shape)
        assert sh.spec == tuple(JS._fsdp_spec(shape, 2)), key


# ------------------------------------------------------------------ ring attention


@pytest.mark.parametrize("n", SIZES)
def test_ring_attention_equals_jax(results, n):
    per_rank, (ring, *_), _ = results
    mesh = JM.make_mesh((1, n, 1), ("data", "tile", "model"))
    want = np.asarray(jax_ring(*(jnp.asarray(a) for a in ring), mesh, axis="tile"))
    np.testing.assert_allclose(want, np.asarray(_xla_attention(*(jnp.asarray(a) for a in ring))), atol=2e-5)
    for r in range(n):
        np.testing.assert_allclose(per_rank[r]["ring"][n], want, atol=2e-5)
    for r in range(n, WORLD):
        assert n not in per_rank[r]["ring"]


def test_ring_attention_refuses_gradients(results):
    for rank in results[0]:
        assert "no autograd rule" in rank["ring"]["grad"]


def test_sequence_routing_equals_jax(results):
    """Under sequence_sharding the port's attention() rings exactly where
    the JAX dispatch lowers to a collective permute, and every case
    computes the plain attention."""
    per_rank, (_, route, *_), _ = results
    q = jnp.asarray(route)
    s, h = ROUTE[1], ROUTE[2]
    cut = s - 8 - 3
    cases = dict(
        eligible=lambda: dot_product_attention(q, q, q, impl="auto"),
        causal=lambda: dot_product_attention(q, q, q, causal=True, impl="auto"),
        biased=lambda: dot_product_attention(q, q, q, bias=jnp.zeros((1, h, s, s)), impl="auto"),
        short=lambda: dot_product_attention(q[:, :s // 2], q[:, :s // 2], q[:, :s // 2], impl="auto"),
        indivisible=lambda: dot_product_attention(q[:, :cut], q[:, :cut], q[:, :cut], impl="auto"),
        cross=lambda: dot_product_attention(q, q[:, :s // 2], q[:, :s // 2], impl="auto"),
    )
    mesh = JM.make_mesh((WORLD,), ("seq",), devices=jax.devices()[:WORLD])
    with sequence_sharding(mesh, "seq", min_seq=ROUTE_MIN_SEQ):
        for name, fn in cases.items():
            ringed = "collective_permute" in jax.jit(fn).lower().as_text()
            want = np.asarray(jax.jit(fn)())
            for rank in per_rank:
                took, got = rank["routing"][name]
                assert took == ringed, name
                np.testing.assert_allclose(got, want, atol=2e-5)
    assert all(rank["routing"]["restored"] and not rank["routing"]["outside"][0] for rank in per_rank)


# ------------------------------------------------------------------ the tile axis


@pytest.mark.parametrize("n", SIZES)
def test_tiled_encode_over_the_tile_axis_equals_jax(results, n):
    """9 tiles on 2 and on 4 ranks: the padded duplicates carry weight 0,
    so the pooled statistics stay exact."""
    per_rank, (_, _, x, *_), params = results
    cfg = P.tiny_cfg()
    vp = jax.tree_util.tree_map(jnp.asarray, params["vae"])
    mesh = JM.make_mesh((1, n, 1), ("data", "tile", "model"))
    encode = jax.jit(lambda e, q, xx: jax_tiled_encode(cfg.vae, e, q, xx, tile_size=VAE_TILE, pad=VAE_PAD,
                                                       mesh=mesh))
    want = np.asarray(encode(vp["encoder"], vp["quant_conv"], jnp.asarray(x)))
    for r in range(n):
        got = P.nhwc(per_rank[r]["tiled_vae"][n])
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_allclose(per_rank[r]["tiled_vae"][n], per_rank[r]["tiled_vae"][1], atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_tiled_denoise_over_the_tile_axis_equals_jax(results, n):
    per_rank, (*_, x_tiles, control), _ = results

    def denoise_flat(x, sigma, cfg, ctrl_s, control, ca):
        return x * 0.5 + control * 0.25 + sigma.reshape(-1, 1, 1, 1) * 0.01

    mesh = JM.make_mesh((1, n, 1), ("data", "tile", "model"))
    want = np.asarray(jax_tiled_denoise(denoise_flat, mesh=mesh)(
        jnp.asarray(x_tiles), jnp.full((2,), 3.0), jnp.full((2,), 5.0), 1.0, jnp.asarray(control), None))
    for r in range(n):
        np.testing.assert_allclose(np.moveaxis(per_rank[r]["tiled_denoise"][n], 2, -1), want, atol=1e-6)


# ------------------------------------------------------------------ FLOP counts


@pytest.mark.parametrize("which", ("full", "tiny"))
def test_flops_equal_jax(which):
    jcfg = JaxSUPIRConfig() if which == "full" else P.tiny_cfg()
    tcfg = TC.SUPIRConfig() if which == "full" else TC.SUPIRConfig(
        unet=TC.UNetConfig(**dataclasses.asdict(jcfg.unet)))
    for hw in (8, 32, 128, 256):
        assert TF.unet_eval_flops(tcfg.unet, hw, batch=3) == JF.unet_eval_flops(jcfg.unet, hw, batch=3)
        assert TF.pipeline_flops(tcfg, hw, 50, batch=2) == JF.pipeline_flops(jcfg, hw, 50, batch=2)
    assert TF.conv_flops(64, 48, 320, 640, 1) == JF.conv_flops(64, 48, 320, 640, 1)
    assert TF.attn_flops(4096, 77, 10, 64) == JF.attn_flops(4096, 77, 10, 64)
    assert TF.transformer_block_flops(1024, 640, 77, 2048, 10, 64) == JF.transformer_block_flops(
        1024, 640, 77, 2048, 10, 64)
