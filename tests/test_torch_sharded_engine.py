"""The port's multi-device inference against the JAX package on the CPU:
the tiny engine sharded over a (1, 1, 2) 'model' mesh
(`shard_for_inference`), over a (1, 2, 1) 'tile' mesh (the tiled VAE's
tiles and the tiled sampler's windows) and on a 'seq' mesh (ring
attention), and the tiny int4 captioner sharded over 'model' (`shard`),
with the engine and the captioner on disjoint ranks, as the JAX drill
places them (tests/test_captioner_shard.py).

Four spawned gloo ranks (tests/torch_ranks.py): 0 and 1 hold the engine,
2 and 3 the captioner, both at once; the JAX side runs here meanwhile, on
its 8 virtual CPU devices. The noise is injected (numpy draws given to
both packages). Bounds: against the JAX engine sharded the same way, the
torch-golden 2e-3 (atol and rtol, as tests/test_torch_engine.py); the port
sharded over 'model' against the port on one rank bit for bit (the
gathered tensors are the same bits); over 'tile' and 'seq' rel-L2 1e-5
(the tiled VAE's statistics and the ring's softmax are summed in another
order: 0.8-5.4e-6 measured); captions token
for token; the sharding rule and each rank's bytes exact.
"""

import collections

import jax
import numpy as np
import pytest

from supir_tpu.engine.supir import SUPIREngine as JaxEngine
from supir_tpu.parallel import sharding as JS
from supir_tpu.parallel.mesh import make_mesh
from supir_tpu_torch.parallel import sharding as TS
import torch_parity as P
import torch_ranks
from torch_parity import one_torch_thread  # noqa: F401

TOL = dict(atol=2e-3, rtol=2e-3)
SPLIT_BOUND = 1e-5
STEPS = 2
VAE_TILES = (24, 3, None)    # encoder 24 px, decoder 3 latent px, unchunked: 9 tiles each way
WINDOWS = (4, 2, 5)          # 4-latent windows at stride 2: 9 on the 8x8 latent, 5 a rank (padded)
UNIT_BYTES = 1 << 16         # gathering units of at most 64 KiB: hundreds of them, so they evict


def _engine_inputs(tengine, seed=7):
    """An image, its conditioning from the port's text towers (given to
    both packages) and the two noise draws."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    tok = rng.integers(0, 1000, (1, 77)).astype(np.int32)
    z = tengine.encode_first_stage_with_denoise(x)
    c, uc = tengine.prepare_condition(z, tok, tok, tok, tok)
    c, uc = ({k: v.numpy() for k, v in d.items()} for d in (c, uc))
    shape = tuple(z.shape)
    noise, center = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return x, c, uc, noise, center


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _per_device(tree):
    """(elements, bytes) of device 0's shard of every leaf."""
    return [(leaf.addressable_shards[0].data.size, leaf.addressable_shards[0].data.nbytes)
            for leaf in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the JAX results, the JAX trees' per-device bytes)."""
    cfg, jengine, tcfg, tengine = P.tiny_engine_pair()
    x, c, uc, noise, center = _engine_inputs(tengine)
    jagent, tagent = P.tiny_captioner_pair()
    image = (np.random.default_rng(0).random((30, 40, 3)) * 255).astype(np.uint8)
    handle = torch_ranks.spawn(4, tmp_path_factory.mktemp("sharded"), engine_and_captioner=dict(
        engine=dict(state_dict=tengine.model.state_dict(), cfg=tcfg, cond_cfg=tengine.cond_cfg, x=x, c=c, uc=uc,
                    noise=noise, center=center, steps=STEPS, vae_tiles=VAE_TILES, windows=WINDOWS,
                    unit_bytes=UNIT_BYTES),
        captioner=dict(state_dict=tagent.model.state_dict(), cfg=tagent.cfg, image=image, unit_bytes=UNIT_BYTES)))
    del tengine, tagent

    devices = jax.devices()
    jax_out = {}
    kw = dict(num_steps=STEPS, noise_override=noise, center_noise_override=center)
    sharded = JaxEngine(cfg, jengine.params, cond_cfg=jengine.cond_cfg)
    sharded.shard_for_inference(make_mesh((1, 1, 2), ("data", "tile", "model"), devices=devices[:2]))
    jax_out["A"] = np.asarray(sharded.batchify_sample(x, c, uc, **kw))
    jax_bytes = {"engine": {k: _per_device(v) for k, v in sharded.params.items()}}
    tiled = JaxEngine(cfg, jengine.params, cond_cfg=jengine.cond_cfg)
    tiled.shard_for_inference(make_mesh((1, 2, 1), ("data", "tile", "model"), devices=devices[:2]))
    tiled.init_tile_vae(*VAE_TILES)
    jax_out["C"] = np.asarray(tiled.batchify_sample_tiled(x, c, uc, tile_size=WINDOWS[0], tile_stride=WINDOWS[1],
                                                          **kw))
    jagent.shard(make_mesh((1, 2), ("data", "model"), devices=devices[2:4]))
    jax_out["caption"] = jagent.gen_image_caption([image], temperature=0.0)
    jax_bytes["captioner"] = _per_device(jagent.params)
    jax_bytes["captioner_shapes"] = [tuple(np.shape(leaf)) for leaf in jax.tree_util.tree_leaves(jagent.params)]
    return handle.join(), jax_out, jax_bytes


def test_sharded_engine_equals_jax(runs):
    per_rank, jax_out, _ = runs
    for r in (0, 1):
        got = per_rank[r]["engine_and_captioner"]
        np.testing.assert_allclose(got["A2"], jax_out["A"], **TOL)
        np.testing.assert_allclose(got["C1"], jax_out["C"], **TOL)
        np.testing.assert_allclose(got["A"], jax_out["A"], **TOL)


def test_model_sharding_is_bit_identical_to_one_rank(runs):
    for r in (0, 1):
        got = runs[0][r]["engine_and_captioner"]
        for one, split in (("A", "A2"), ("C0", "C2")):
            np.testing.assert_array_equal(got[split], got[one])
        assert got["tiled_mesh_of_model_mesh"]


def test_tile_and_sequence_splits_equal_one_rank(runs):
    for r in (0, 1):
        got = runs[0][r]["engine_and_captioner"]
        for one, split in (("B", "B1"), ("C", "C1"), ("B", "S")):
            assert _rel(got[split], got[one]) <= SPLIT_BOUND, split
        assert got["ring_sites"], "no attention site took the ring"
        assert all(s[1] >= 16 for s in got["ring_sites"])


ENGINE_TREES = {"unet": "model.diffusion_model.", "control": "model.control_model.", "vae": "first_stage_model.",
                "conditioner": "conditioner."}


def test_each_rank_holds_the_jax_bytes_of_each_leaf(runs):
    """One rank's share of every tensor against one JAX device's: the
    multisets of (elements, bytes) over the UNet's, GLVControl's and the
    VAE's leaves, which map one to one. The text towers' trees differ in
    layout (OpenCLIP's fused in_proj against JAX's q/k/v), so there the
    sums agree; the captioner's per-leaf elements agree, and its bytes
    but for the LM head's, which the port holds in fp32 with bf16 values
    at fp32 compute, where the JAX tree holds bf16."""
    per_rank, _, jax_bytes = runs
    for r in (0, 1):
        held = per_rank[r]["engine_and_captioner"]["held"]
        for tree, prefix in ENGINE_TREES.items():
            mine = [v for k, v in held.items() if k.startswith(prefix)]
            want = jax_bytes["engine"][tree]
            if tree == "conditioner":
                assert sum(b for _, b in mine) == sum(b for _, b in want)
            else:
                assert collections.Counter(mine) == collections.Counter(want), tree
        assert any(k.endswith(".original") for k in held)
    for r in (2, 3):
        held = per_rank[r]["engine_and_captioner"]["held"]
        want = jax_bytes["captioner"]
        assert collections.Counter(n for n, _ in held.values()) == collections.Counter(n for n, _ in want)
        head = held["lm_head.parametrizations.weight.original"]
        assert sum(b for _, b in held.values()) - head[1] // 2 == sum(b for _, b in want)


def test_captioner_rule_equals_jax_on_every_leaf(runs):
    per_rank, _, jax_bytes = runs
    for shape in jax_bytes["captioner_shapes"]:
        for n in (2, 4, 8):
            assert TS.fsdp_spec(shape, n) == tuple(JS._fsdp_spec(shape, n)), shape
    got = per_rank[2]["engine_and_captioner"]
    for key, shape in got["shapes"].items():
        assert got["specs"][key] == tuple(JS._fsdp_spec(shape, 2)), key


def test_sharded_caption_equals_jax(runs):
    per_rank, jax_out, _ = runs
    for r in (2, 3):
        got = per_rank[r]["engine_and_captioner"]
        assert got["sharded"] == got["one"] == jax_out["caption"]


def test_disjoint_placement(runs):
    """Each model's tensors gather only over its own two ranks, in many
    units; both ran."""
    per_rank = runs[0]
    for ranks, want in (((0, 1), [(0, 1)]), ((2, 3), [(2, 3)])):
        for r in ranks:
            got = per_rank[r]["engine_and_captioner"]
            assert got["groups"] == want
            assert got["units"] > 10
