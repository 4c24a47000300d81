"""The plans of the two cluster reductions, K2 (GroupNorm+SiLU,
csrc/group_norm.cu) and K8 (the int8 quantizer, csrc/quantize_int8.cu), on
the CPU: the geometry each kernel launches, and torch walks of their
algorithms held to the JAX functions.

- `gn_plan`: every element of a slab in exactly one rank's part, parts of
  whole 16-byte vectors, shared memory within the H100's 227 KB a CTA,
  clusters of at most 16 (8 where the plan says portable), and the
  cluster size at the restore path's shapes as PERF.md's table gives it;
  `fast_div`, the kernel's division by hw, exact for every slab offset.
- `gn_emulate` (per-rank partials summed in rank order, each part
  normalised on its own) against JAX's `group_norm_silu` in Pallas
  interpret mode, moved to NHWC, at atol 2e-5 (the bound of
  tests/test_torch_ops.py's plain-version test) and against
  `group_norm_plain`; the kernel's planted faults, emulated, break the
  card's 3e-2 bound on inputs whose channels each have their own mean and
  scale.
- `int8_plan` and `int8_thread_map`: each weight quantized once, with the
  first design's Philox counter e // 4 and word e % 4; `int8_emulate` in
  nearest mode equal to JAX's `quantize_int8` (interpret) bit for bit.
- `expected_group_norm_launches` (chip_smoke.py) against the GroupNorm
  calls of a tiny restore on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import groupnorm as G
from supir_tpu_torch.ops import quantize as Q
from torch_parity import one_torch_thread  # noqa: F401

JAX_ATOL = 2e-5
CARD_BOUND = 3e-2

# the restore path's GroupNorm shapes (latent 128^2, CFG batch 2; the VAE
# at batch 1 on a 1024^2 image) and their plan's cluster size, as PERF.md's
# table (§6) gives them
RESTORE_PLANS = {
    ((2, 320, 128, 128), torch.bfloat16): 4,
    ((2, 640, 128, 128), torch.bfloat16): 4,
    ((2, 960, 128, 128), torch.bfloat16): 4,
    ((2, 640, 64, 64), torch.bfloat16): 4,
    ((2, 1280, 64, 64), torch.bfloat16): 4,
    ((2, 1920, 64, 64), torch.bfloat16): 4,
    ((2, 1280, 32, 32), torch.bfloat16): 4,
    ((2, 2560, 32, 32), torch.bfloat16): 4,
    ((1, 512, 128, 128), torch.bfloat16): 8,
    ((1, 512, 256, 256), torch.bfloat16): 8,
    ((1, 256, 256, 256), torch.bfloat16): 8,
    ((1, 128, 512, 512), torch.bfloat16): 8,
    ((1, 256, 512, 512), torch.bfloat16): 8,
    ((1, 128, 1024, 1024), torch.bfloat16): 8,
    ((1, 256, 1024, 1024), torch.bfloat16): 8,
    ((2, 320, 128, 128), torch.float32): 4,
    ((2, 640, 64, 64), torch.float32): 4,
    ((1, 512, 256, 256), torch.float32): 8,
}

PLAN_SHAPES = list(RESTORE_PLANS) + [
    ((1, 96, 7, 9), torch.float32), ((1, 96, 7, 9), torch.bfloat16), ((2, 64, 8, 8), torch.float16),
    ((3, 32, 5, 1), torch.float32), ((1, 64, 1, 1), torch.bfloat16), ((2, 4096, 3, 3), torch.bfloat16),
]


@pytest.mark.parametrize("shape,dtype", PLAN_SHAPES)
def test_gn_plan_covers_each_element_once(shape, dtype):
    plan = G.gn_plan(shape, dtype)
    vec = 16 // plan.itemsize
    starts = [r[0] for r in plan.ranges]
    ends = [r[1] for r in plan.ranges]
    assert starts[0] == 0 and ends[-1] == plan.slab
    assert starts[1:] == ends[:-1] and all(e > s for s, e in plan.ranges)  # contiguous, none empty
    assert plan.part % vec == 0 and plan.ranks * plan.part >= plan.slab
    assert plan.smem == G.gn_smem(plan.cg) <= G.SMEM_MAX
    assert 1 <= plan.ranks <= 16 and (not plan.portable or plan.ranks <= 8)
    assert plan.nslabs == shape[0] * 32 and plan.slab * plan.nslabs == int(np.prod(shape))
    assert plan.nslabs * plan.ranks <= 2 * G.SMS or plan.ranks == 1  # at most two CTAs an SM


@pytest.mark.parametrize("shape,dtype", list(RESTORE_PLANS))
def test_gn_plan_modes_at_restore_shapes(shape, dtype):
    plan = G.gn_plan(shape, dtype)
    assert plan.ranks == RESTORE_PLANS[(shape, dtype)]


def _nhwc_case(shape, seed, channel_stats=False):
    """x [B, H, W, C] (NHWC, the JAX layout) and the affine; with
    channel_stats each channel gets its own mean and scale."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 2 + 0.5
    c = shape[-1]
    if channel_stats:
        x = rng.standard_normal(shape) * rng.uniform(0.3, 3.0, c) + rng.uniform(-2.0, 2.0, c)
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    return x.astype(np.float32), gamma, beta


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("shape,silu,eps,ranks", [
    ((2, 8, 8, 64), True, 1e-5, None),
    ((2, 8, 8, 64), False, 1e-5, None),
    ((1, 7, 9, 96), True, 1e-6, None),
    ((1, 16, 16, 32), False, 1e-6, None),
    ((1, 7, 9, 96), True, 1e-6, 3),      # 189 elements a slab: parts 64, 64, 61
    ((2, 8, 8, 64), True, 1e-5, 3),      # 128 elements: 44, 44, 40
    ((1, 16, 16, 32), False, 1e-6, 5),   # one channel of 256: 52 x 4 + 48
    ((1, 13, 11, 64), True, 1e-5, 7),    # 286 elements, hw 143: parts straddle a channel
])
def test_gn_emulation_matches_jax(shape, silu, eps, ranks):
    import jax.numpy as jnp

    from supir_tpu.ops.groupnorm import group_norm_silu

    x, gamma, beta = _nhwc_case(shape, seed=1)
    want = np.asarray(group_norm_silu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups=32, eps=eps,
                                      apply_silu=silu, block_rows=64, interpret=True))
    xt, w, b = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    plan = G.gn_plan(tuple(xt.shape), xt.dtype, ranks=ranks)
    if ranks is not None:
        assert plan.ranks == ranks and len({e - s for s, e in plan.ranges}) > 1  # uneven parts
    got = G.gn_emulate(xt, w, b, 32, eps, silu, plan)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, atol=JAX_ATOL)
    torch.testing.assert_close(got, G.group_norm_plain(xt, w, b, 32, eps, silu), rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("fault", [G.FAULT_DROP_RANK, G.FAULT_OWN_SLICE, G.FAULT_AFFINE_SHIFT,
                                   G.FAULT_NEIGHBOUR_GROUP])
@pytest.mark.parametrize("shape,ranks", [((2, 16, 16, 320), 4), ((1, 32, 32, 128), 8)])
def test_gn_emulated_faults_break_the_card_bound(fault, shape, ranks):
    """Each planted fault of the smoke run, walked in torch, moves the
    output past K2's 3e-2 bound on inputs with per-channel statistics
    (on i.i.d. inputs the per-slice statistics would pass unnoticed)."""
    x, gamma, beta = _nhwc_case(shape, seed=2, channel_stats=True)
    xt, w, b = _nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta)
    plan = G.gn_plan(tuple(xt.shape), xt.dtype, ranks=ranks)
    want = G.group_norm_plain(xt, w, b, 32, 1e-5, True)
    assert (G.gn_emulate(xt, w, b, 32, 1e-5, True, plan) - want).abs().max().item() <= JAX_ATOL
    bad = G.gn_emulate(xt, w, b, 32, 1e-5, True, plan, fault=fault)
    assert (bad - want).abs().max().item() > CARD_BOUND


def test_gn_plan_refuses_what_no_launch_takes():
    with pytest.raises(ValueError):
        G.gn_plan((1, 30, 4, 4), torch.float32)               # 30 channels, 32 groups
    with pytest.raises(ValueError):
        G.gn_plan((2048, 32, 4, 4), torch.bfloat16)           # 65536 slabs: past the grid's y
    with pytest.raises(ValueError):
        G.gn_plan((1, 32, 2**16, 2**15), torch.bfloat16)      # a slab of 2^31 elements


# ------------------------------------------------------------------ K8

INT8_SHAPES = [(5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120), (5120, 32000),
               (1000, 264), (1000, 263), (37, 13), (70, 36), (300, 20), (513, 48), (129, 100)]


@pytest.mark.parametrize("cin,cout", INT8_SHAPES)
def test_int8_plan_geometry(cin, cout):
    plan = Q.int8_plan(cin, cout)
    starts, ends = zip(*plan.ranges)
    assert starts[0] == 0 and ends[-1] == cin and list(starts[1:]) == list(ends[:-1])
    assert all(e > s for s, e in plan.ranges)
    assert plan.nboxes * plan.box_rows >= plan.rows and plan.box_rows <= Q.Q8_BOX_ROWS
    assert plan.nboxes <= Q.Q8_MAX_BOXES and plan.smem == Q.int8_smem(plan.cols, plan.box_rows, plan.nboxes, plan.threads)
    assert plan.smem <= Q.Q8_SMEM_MAX and plan.rows * plan.cols * 4 <= max(c for c, _ in Q.Q8_SLICE_TIERS)
    assert 1 <= plan.ranks <= 16 and (not plan.portable or plan.ranks <= 8)
    assert plan.tiles * plan.cols >= cout > (plan.tiles - 1) * plan.cols


def test_int8_plan_at_the_13b_shapes():
    """Whole 128-byte rows of 32 columns at every 13B shape, 16 ranks: 40 KB
    slices and 256 threads at cin 5120 (four CTAs an SM), 108 KB and 512
    threads at the down projection's 13824 (two)."""
    for cin, threads in ((5120, 256), (13824, 512)):
        plan = Q.int8_plan(cin, 5120)
        assert (plan.cols, plan.ranks, plan.threads) == (32, 16, threads)


@pytest.mark.parametrize("cin,cout", [(37, 13), (70, 36), (300, 20), (513, 48), (129, 100), (1000, 263)])
@pytest.mark.parametrize("cols,threads", [(None, None), (32, 512), (16, 256), (8, 512), (4, 256)])
def test_int8_thread_map_is_the_first_designs(cin, cout, cols, threads):
    plan = Q.int8_plan(cin, cout)
    if cols is not None:
        plan = dataclasses.replace(plan, cols=cols, threads=threads)
    counter, word, visits = Q.int8_thread_map(plan)
    e = torch.arange(cin * cout).reshape(cin, cout)
    assert torch.equal(visits, torch.ones_like(visits))
    assert torch.equal(counter, e // 4) and torch.equal(word, e % 4)


@pytest.mark.parametrize("cin,cout,ranks", [(1000, 264, None), (1000, 263, None), (37, 13, None),
                                            (513, 48, 5), (300, 100, 16)])
def test_int8_emulation_matches_jax_bit_for_bit(cin, cout, ranks):
    import jax.numpy as jnp

    from supir_tpu.ops.quantize import quantize_int8

    rng = np.random.default_rng(cin + cout)
    w = rng.standard_normal((cin, cout)).astype(np.float32) * rng.uniform(0.1, 3.0, cout).astype(np.float32)
    w[rng.integers(cin), 0] = 9.0  # one column's absmax in a single row
    plan = Q.int8_plan(cin, cout)
    if ranks is not None:
        rows = -(-cin // ranks)
        plan = dataclasses.replace(plan, ranks=ranks, rows=rows, nboxes=-(-rows // 256),
                                   box_rows=-(-rows // -(-rows // 256)))
    want_q, want_s = quantize_int8(jnp.asarray(w), interpret=True)  # nearest off the TPU
    got_q, got_s = Q.int8_emulate(torch.from_numpy(w), plan)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    plain_q, plain_s = Q.quantize_int8_plain(torch.from_numpy(w))
    assert torch.equal(got_q, plain_q) and torch.equal(got_s, plain_s)


def test_int8_emulated_missing_rank_changes_the_bytes():
    """One rank's maxima left out (the smoke run's fault) changes the
    scale of every column whose absmax lies in that rank's rows."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((600, 64)).astype(np.float32))
    w[550, :] = 10.0
    plan = Q.int8_plan(600, 64)
    plan = dataclasses.replace(plan, ranks=4, rows=150, nboxes=1, box_rows=150)
    dropped = dataclasses.replace(plan, ranks=3)  # rows 450..599 never reach the maxima
    assert not torch.equal(Q.int8_emulate(w, dropped)[1], Q.int8_emulate(w, plan)[1])


# ------------------------------------------------------------------ [main]


def test_expected_group_norm_launches_counts_a_tiny_restore(monkeypatch):
    """chip_smoke.py's K2 count against the GroupNorm calls of a tiny
    restore on the CPU, in the counted run's form: the denoise encoder,
    then batchify_sample (a decode, the encoder, one network call a step,
    a decode)."""
    import chip_smoke
    from supir_tpu_torch.config import SUPIRConfig
    from supir_tpu_torch.engine.factory import create_engine
    from supir_tpu_torch.models import layers

    cfg = SUPIRConfig.tiny()
    engine = create_engine(cfg, "cpu", seed=0)
    calls = []
    monkeypatch.setattr(layers, "group_norm", lambda *a: calls.append(1) or G.group_norm_plain(*a))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    c = {"crossattn": rng.standard_normal((1, 77, cfg.unet.context_dim)).astype(np.float32),
         "vector": rng.standard_normal((1, cfg.unet.adm_in_channels)).astype(np.float32)}
    uc = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in c.items()}
    with torch.no_grad():
        z = engine.encode_first_stage_with_denoise(x)
        engine.batchify_sample(x, dict(c, control=z), dict(uc, control=z), num_steps=2, z_override=z,
                               s_churn=0.0, color_fix_type="Wavelet", seed=1)
    assert len(calls) == chip_smoke.expected_group_norm_launches(cfg, steps=2, vae_passes=4) > 0


# ------------------------------------------------------------------ launch


@pytest.mark.parametrize("hw", [1, 2, 3, 7, 63, 143, 1024, 4096, 16384, 65536, 2**20, 3 * 2**20 - 1, 2**30 + 1,
                                2**31 - 1])
def test_fast_div_finds_every_channel(hw):
    """csrc/group_norm.cu's channel_of, ((e * mul) >> 32) >> shift with the
    plan's (mul, shift), equals e // hw for slab offsets up to 2^31 - 1,
    past the 2^24 where a float estimate would slip a channel."""
    mul, shift = G.fast_div(hw)
    assert 0 <= mul < 2**32 and 0 <= shift <= 31 and (mul == 0) == (hw == 1)
    rng = np.random.default_rng(hw)
    es = {0, 1, 2**24 - 1, 2**24, 2**24 + 1, 2**31 - 1} | {int(e) for e in rng.integers(0, 2**31, 2000)}
    for k in {1, 2, 2**24 // hw, (2**31 - 1) // hw}:
        es |= {k * hw - 1, k * hw, k * hw + 1}
    for e in sorted(e for e in es if 0 <= e < 2**31):
        assert ((e * mul) >> 32 >> shift if mul else e) == e // hw, e


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", i) for i in range(2)]


@pytest.mark.gpu
def test_cluster_kernels_launch_on_a_second_card(two_cards):
    """K2 and K8 on card 0, then on card 1: the cluster launch sets its
    kernel attributes (clusters past 8; K8's 112 KB of shared memory at
    cin 13824) and asks the occupancy on each card, not once for the
    process."""
    for dev in two_cards:
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn((2, 320, 64, 64), generator=g, device=dev).to(torch.bfloat16)
        w = 1.0 + 0.1 * torch.randn(320, generator=g, device=dev)
        b = 0.1 * torch.randn(320, generator=g, device=dev)
        want = G.group_norm_plain(x.float(), w, b, 32, 1e-5, True)
        for plan in (G.plan_for(x), G.gn_plan(tuple(x.shape), x.dtype, ranks=16)):  # 16: non-portable
            assert (G._launch(x, w, b, 32, 1e-5, True, plan).float() - want).abs().max().item() <= CARD_BOUND
        wq = torch.randn(13824, 96, generator=g, device=dev)
        assert Q.int8_plan(13824, 96).smem > 48 * 1024
        q, s = Q.quantize_int8(wq, stochastic=False)
        want_q, want_s = Q.quantize_int8_plain(wq)
        assert q.device == dev and torch.equal(q, want_q) and torch.equal(s, want_s)
