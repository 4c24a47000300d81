"""supir_tpu_torch.ops.quantize (the packers, K5-K11 and their plain
versions) against supir_tpu.ops.quantize on the CPU, and the kernels against
their plain versions on the card.

On the CPU every wrapper returns its plain version, and the JAX functions
run their XLA fallbacks (or `_qmm` in Pallas interpret mode). Tolerances:
- packers and nearest-mode int8: bit for bit (bytes, int8 values, scales);
- GEMVs in fp32: atol 1e-4 + rtol 1e-5 on outputs of magnitude ~10, which
  covers fp32 summation order; a swapped nibble order moves them by O(1);
- GEMVs at bf16 activations against the JAX functions at bf16: atol 2e-3 +
  rtol 2e-3 (both round the prologue's output to bf16 at the same place,
  and a rounding flip there moves an output by ~1e-3);
- the W4A8 activation quantizer bit for bit; the W4A8 GEMV 1e-6 relative
  (exact integer sums, two rounded scale multiplies); K5's act_int8 mode,
  the chained pair (K9) and native int4 (K11) 1e-5.
On the card the kernels are held to their plain versions in fp32 on the
same bf16 inputs by relative L2 <= 1e-2 (bf16 rounding of the prologue's
output gives a few 1e-3; K10 by 1e-6), with planted faults that must break
the bound.
JAX is imported inside the parity tests only, so the `gpu` tests also run
on a machine without it:
python -m pytest --noconftest tests/test_torch_quantize.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import quantize as Q
from torch_parity import one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-5
BF16_TOL = 2e-3
CARD_REL_BOUND = 1e-2
W4A8_REL_BOUND = 1e-6  # K10: exact integer sums, two rounded scale multiplies


def _weights(seed, cin, cout):
    """fp32 [cin, cout] with two columns whose entries sit exactly on half
    steps of the int4 grid (absmax 7, so scale 1), to pin round-half-even."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((cin, cout)).astype(np.float32)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5], np.float32)
    w[:, 0] = np.resize(halves, cin)
    w[0, 0] = 7.0
    w[:, 1] = -np.resize(halves, cin)
    w[0, 1] = -7.0
    return w


def _np(t):
    return np.array(t)  # a writable copy for torch.from_numpy


# ------------------------------------------------------------------ packers


@pytest.mark.parametrize("name", ["quantize_int4_paired", "quantize_int4"])
def test_int4_packers_are_bit_exact(name):
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    w = _weights(0, 64, 48)
    want_q, want_s = getattr(JQ, name)(jnp.asarray(w))
    got_q, got_s = getattr(Q, name)(torch.from_numpy(w))
    assert got_q.dtype == torch.uint8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
    unpack = Q.unpack_int4_paired if name == "quantize_int4_paired" else Q.unpack_int4
    junpack = JQ.unpack_int4_paired if name == "quantize_int4_paired" else JQ.unpack_int4
    np.testing.assert_array_equal(unpack(got_q).numpy(), _np(junpack(want_q)))
    # the half steps of column 0 round to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    assert unpack(got_q)[1:4, 0].tolist() == [2, 2, 0]


def test_int4_packers_refuse_odd_cin():
    with pytest.raises(ValueError):
        Q.quantize_int4_paired(torch.zeros(5, 8))


def test_int8_nearest_is_bit_exact():
    import jax.numpy as jnp

    from supir_tpu.ops.quantize import quantize_int8

    w = _weights(1, 96, 40) * 3.0
    want_q, want_s = quantize_int8(jnp.asarray(w), interpret=True)  # nearest off the TPU
    got_q, got_s = Q.quantize_int8(torch.from_numpy(w), stochastic=False)
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    np.testing.assert_array_equal(got_s.numpy(), _np(want_s))


def test_int8_stochastic_plain():
    """floor(w / scale + u): every value on floor or ceil of w / scale,
    seeded, and unbiased over many draws (mean within 4 sigma of w)."""
    w = torch.from_numpy(_weights(2, 64, 32))
    q0, s = Q.quantize_int8_plain(w)
    scaled = w / s
    draws = []
    for seed in range(64):
        q, s2 = Q.quantize_int8(w, seed=seed)
        torch.testing.assert_close(s2, s, rtol=0, atol=0)
        assert ((q.float() == scaled.floor()) | (q.float() == scaled.ceil())).all()
        draws.append(q.float())
    a, b = Q.quantize_int8(w, seed=5)[0], Q.quantize_int8(w, seed=5)[0]
    assert torch.equal(a, b) and not torch.equal(a, Q.quantize_int8(w, seed=6)[0])
    mean = torch.stack(draws).mean(0)
    # each draw's error is a Bernoulli step of 1 (variance <= 1/4)
    sigma = 0.5 / len(draws) ** 0.5
    assert ((mean - scaled).abs() <= 4 * sigma + 1e-6).float().mean() > 0.999
    assert ((mean - scaled).abs() <= 6 * sigma).all()
    # nearest mode is the u = None plain version
    torch.testing.assert_close(Q.quantize_int8(w, stochastic=False)[0], q0, rtol=0, atol=0)


# ---------------------------------------------------- plain versions vs JAX


def _x(seed, b, cin, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((b, cin)) * scale).astype(np.float32)


@pytest.mark.parametrize("prologue", ["none", "norm", "siluglu"])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_matches_jax(prologue, with_residual, dtype):
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin, cout, b = 128, 96, 3
    packed, scale = JQ.quantize_int4_paired(jnp.asarray(_weights(3, cin, cout)))
    x = _x(4, b, 2 * cin if prologue == "siluglu" else cin, 2.0)
    gamma = (1.0 + 0.1 * np.random.default_rng(5).standard_normal(cin)).astype(np.float32)
    residual = _x(6, b, cout) if with_residual else None
    kw = dict(eps=1e-6, siluglu=prologue == "siluglu")
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JQ.int4_paired_fused_matmul(
        jnp.asarray(x, jdt), packed, scale, gamma=jnp.asarray(gamma) if prologue == "norm" else None,
        residual=None if residual is None else jnp.asarray(residual), **kw)
    got = Q.int4_paired_fused_matmul(
        torch.from_numpy(x).to(tdt), torch.from_numpy(_np(packed)), torch.from_numpy(_np(scale)),
        gamma=torch.from_numpy(gamma) if prologue == "norm" else None,
        residual=None if residual is None else torch.from_numpy(residual), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, cout)
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else dict(atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(got.numpy(), _np(want), **tol)


def test_paired_plain_matches_jax():
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    packed, scale = JQ.quantize_int4_paired(jnp.asarray(_weights(7, 256, 64)))
    x = _x(8, 5, 256)
    want = JQ.int4_paired_matmul(jnp.asarray(x), packed, scale)
    got = Q.int4_paired_matmul(torch.from_numpy(x), torch.from_numpy(_np(packed)),
                               torch.from_numpy(_np(scale)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_plain_matches_jax(bits):
    """int8_matmul / int4_matmul against the JAX functions (XLA fallback) and
    the Pallas `_qmm` kernel in interpret mode, as tests/test_quantize.py runs
    it; bf16 activations, both sides' fp32 accumulation."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin, cout = 512, 256
    w = jnp.asarray(_weights(9, cin, cout))
    q, s = JQ.quantize_int8(w, interpret=True) if bits == 8 else JQ.quantize_int4(w)
    x = jnp.asarray(_x(10, 3, cin), jnp.bfloat16)
    fn = JQ.int8_matmul if bits == 8 else JQ.int4_matmul
    want = fn(x, q, s)
    want_kernel = JQ._qmm(x, q, s, bits=bits, interpret=True)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    qt, st = torch.from_numpy(_np(q)), torch.from_numpy(_np(s))
    got = (Q.int8_matmul if bits == 8 else Q.int4_matmul)(xt, qt, st)
    torch.testing.assert_close(got, Q.qmm(xt, qt, st, bits), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), _np(want_kernel), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_and_prefill_rows_never_reach_a_kernel():
    counters = (Q.int4_paired_fused_matmul, Q.int4_paired_matmul, Q.qmm, Q.quantize_int8, Q.int4_w4a8_matmul,
                Q.int4_native_matmul, Q.int4_paired_fused_pair)
    for fn in counters:
        fn.launches = 0
    w = torch.from_numpy(_weights(11, 64, 32))
    packed, scale = Q.quantize_int4_paired(w)
    qp2, sc2 = Q.quantize_int4_paired(torch.from_numpy(_weights(12, 32, 64)))
    for rows in (1, Q.DECODE_ROWS + 1):
        x = torch.randn(rows, 64)
        Q.int4_paired_fused_matmul(x, packed, scale, gamma=torch.ones(64))
        Q.int4_paired_fused_matmul(x, packed, scale, gamma=torch.ones(64), act_int8=True)
        Q.int4_paired_matmul(x, packed, scale)
        Q.int4_matmul(x, *Q.quantize_int4(w))
        Q.int8_matmul(x, *Q.quantize_int8(w))
        Q.int4_w4a8_matmul(x, packed, scale)
        Q.int4_native_matmul(x, *Q.quantize_int4_native(w))
        Q.int4_paired_fused_pair(x, packed, scale, torch.zeros(rows, 32), torch.ones(32), qp2, sc2)
    assert all(fn.launches == 0 for fn in counters)
    assert Q.int4_paired_fused_matmul.act_int8_launches == 0


def test_wrappers_refuse_bad_arguments():
    packed, scale = Q.quantize_int4_paired(torch.randn(64, 32))
    with pytest.raises(ValueError):
        Q.int4_paired_fused_matmul(torch.randn(2, 64), packed, scale, gamma=torch.ones(64), siluglu=True)
    with pytest.raises(ValueError):
        Q.qmm(torch.randn(2, 64), packed, scale, bits=2)


# ------------------------------------------------------- W4A8, native, pair


def test_quantize_act_int8_is_bit_exact():
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    x = _x(13, 5, 96, 3.0)
    x[1] = 0.0  # the 1e-6 floor of an all-zero row
    # exact half steps: 127 x / xs = 63.5 must round to 64 (a division, not
    # a multiplication by the reciprocal, gives exactly 63.5 here)
    x[2, :4] = np.array([5.1875, 2.59375, -2.59375, 0.0], np.float32)
    x[2, 4:] = np.clip(x[2, 4:], -5.0, 5.0)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        xj = jnp.asarray(x, jdt)
        want_q, want_s = JQ.quantize_act_int8(xj)
        got_q, got_s = Q.quantize_act_int8(torch.from_numpy(_np(xj.astype(jnp.float32))).to(tdt))
        assert got_q.dtype == torch.int8 and got_s.shape == (5, 1)
        np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
        np.testing.assert_array_equal(got_s.numpy(), _np(want_s))
        assert got_q[2, :3].tolist() == [127, 64, -64]


def test_w4a8_plain_matches_jax():
    """int4_w4a8_matmul_plain (exact integer dot as an fp32 matmul) against
    the JAX function's int32 dot: relative 1e-6, fp32 bf16 inputs alike."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    packed, scale = JQ.quantize_int4_paired(jnp.asarray(_weights(14, 256, 96)))
    for dtype in ("float32", "bfloat16"):
        x = jnp.asarray(_x(15, 4, 256, 2.0), getattr(jnp, dtype))
        want = JQ.int4_w4a8_matmul(x, packed, scale)
        xt = torch.from_numpy(_np(x.astype(jnp.float32))).to(getattr(torch, dtype))
        got = Q.int4_w4a8_matmul(xt, torch.from_numpy(_np(packed)), torch.from_numpy(_np(scale)))
        assert got.dtype == torch.float32 and got.shape == (4, 96)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6 * np.abs(_np(want)).max())


@pytest.mark.parametrize("prologue", ["none", "norm", "siluglu"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_act_int8_plain_matches_jax(prologue, with_residual):
    """K5's act_int8 plain version against the JAX function with
    act_int8=True on the same fp32 x: 1e-5 (the prologue's fp32 sums in
    another order may flip a quantizer rounding, ~1/127 of one term)."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin, cout, b = 128, 96, 3
    packed, scale = JQ.quantize_int4_paired(jnp.asarray(_weights(16, cin, cout)))
    x = _x(17, b, 2 * cin if prologue == "siluglu" else cin, 2.0)
    gamma = (1.0 + 0.1 * np.random.default_rng(18).standard_normal(cin)).astype(np.float32)
    residual = _x(19, b, cout) if with_residual else None
    kw = dict(eps=1e-6, siluglu=prologue == "siluglu", act_int8=True)
    want = JQ.int4_paired_fused_matmul(
        jnp.asarray(x), packed, scale, gamma=jnp.asarray(gamma) if prologue == "norm" else None,
        residual=None if residual is None else jnp.asarray(residual), **kw)
    got = Q.int4_paired_fused_matmul(
        torch.from_numpy(x), torch.from_numpy(_np(packed)), torch.from_numpy(_np(scale)),
        gamma=torch.from_numpy(gamma) if prologue == "norm" else None,
        residual=None if residual is None else torch.from_numpy(residual), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("siluglu1", [False, True])
def test_fused_pair_plain_matches_jax(siluglu1):
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin1, cout1, cout2, b = (256, 128, 192, 2) if siluglu1 else (128, 128, 256, 2)
    qp1, sc1 = JQ.quantize_int4_paired(jnp.asarray(_weights(20, cin1, cout1)))
    qp2, sc2 = JQ.quantize_int4_paired(jnp.asarray(_weights(21, cout1, cout2)))
    x = _x(22, b, 2 * cin1 if siluglu1 else cin1)
    residual = _x(23, b, cout1)
    gamma = (1.0 + 0.1 * np.random.default_rng(24).standard_normal(cout1)).astype(np.float32)
    want = JQ.int4_paired_fused_pair(jnp.asarray(x), qp1, sc1, jnp.asarray(residual), jnp.asarray(gamma), qp2, sc2,
                                     siluglu1=siluglu1, eps=1e-6)
    t = lambda a: torch.from_numpy(_np(a))  # noqa: E731
    got = Q.int4_paired_fused_pair(t(x), t(qp1), t(sc1), t(residual), t(gamma), t(qp2), t(sc2),
                                   siluglu1=siluglu1, eps=1e-6)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        Q.int4_paired_fused_pair(t(x), t(qp1), t(sc1), t(residual), t(gamma), t(qp2)[:8], t(sc2), siluglu1=siluglu1)


def test_int4_native_packer_matches_jax_and_round_trips():
    """quantize_int4_native: the JAX function's s4 values and scales bit for
    bit (and quantize_int4_paired's), packed two columns to a byte, low
    nibble first; pack and unpack invert each other."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    w = _weights(25, 64, 48)
    want_q, want_s = JQ.quantize_int4_native(jnp.asarray(w))
    packed, scale = Q.quantize_int4_native(torch.from_numpy(w))
    assert packed.dtype == torch.uint8 and packed.shape == (64, 24)
    values = Q.unpack_int4_native(packed)
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_q).astype(np.int8))
    np.testing.assert_array_equal(scale.numpy(), _np(want_s))
    np.testing.assert_array_equal(values.numpy(), Q.unpack_int4_paired(Q.quantize_int4_paired(torch.from_numpy(w))[0]).numpy())
    assert torch.equal(packed[:, 0] & 0xF, (values[:, 0] & 0xF).to(torch.uint8))
    assert torch.equal(packed[:, 0] >> 4, (values[:, 1] & 0xF).to(torch.uint8))
    assert torch.equal(Q.pack_int4_native(values), packed)
    with pytest.raises(ValueError):
        Q.quantize_int4_native(torch.zeros(4, 5))


def test_int4_native_plain_matches_jax():
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    w = jnp.asarray(_weights(26, 256, 64))
    qn, s = JQ.quantize_int4_native(w)
    x = _x(27, 3, 256)
    want = JQ.int4_native_matmul(jnp.asarray(x), qn, s)
    packed, scale = Q.quantize_int4_native(torch.from_numpy(np.asarray(w)))
    got = Q.int4_native_matmul(torch.from_numpy(x), packed, scale)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _card_weights(g, cin, cout, device):
    return torch.randn(cin, cout, generator=g, device=device) * cin ** -0.5


def _swap_nibbles(packed):
    return ((packed >> 4) | (packed << 4)).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("cin,cout,prologue,with_residual", [
    (512, 1536, "norm", False),
    (512, 512, "none", True),
    (1536, 512, "siluglu", True),
    (640, 264, "norm", True),
])
def test_fused_kernel_matches_plain(cuda, rows, cin, cout, prologue, with_residual):
    g = torch.Generator(device=cuda).manual_seed(0)
    packed, scale = Q.quantize_int4_paired(_card_weights(g, cin, cout, cuda))
    x = torch.randn(rows, 2 * cin if prologue == "siluglu" else cin, generator=g, device=cuda).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(cin, generator=g, device=cuda) if prologue == "norm" else None
    residual = torch.randn(rows, cout, generator=g, device=cuda) if with_residual else None
    kw = dict(gamma=gamma, siluglu=prologue == "siluglu", residual=residual)
    before = Q.int4_paired_fused_matmul.launches
    got = Q.int4_paired_fused_matmul(x, packed, scale, **kw)
    torch.cuda.synchronize()
    assert Q.int4_paired_fused_matmul.launches == before + 1
    want = Q.int4_paired_fused_matmul_plain(x.float(), packed, scale, **kw)
    assert _rel_l2(got, want) <= CARD_REL_BOUND
    swapped = Q.int4_paired_fused_matmul(x, _swap_nibbles(packed), scale, **kw)
    assert _rel_l2(swapped, want) > CARD_REL_BOUND
    if prologue == "norm":
        no_gamma = Q.int4_paired_fused_matmul(x, packed, scale, **dict(kw, gamma=torch.ones_like(gamma)))
        assert _rel_l2(no_gamma, want) > CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 5, 32])
def test_paired_and_qmm_kernels_match_plain(cuda, rows):
    g = torch.Generator(device=cuda).manual_seed(1)
    w = _card_weights(g, 1024, 768, cuda)
    x = torch.randn(rows, 1024, generator=g, device=cuda).to(torch.bfloat16)
    packed, scale = Q.quantize_int4_paired(w)
    got = Q.int4_paired_matmul(x, packed, scale)
    assert _rel_l2(got, Q.int4_paired_matmul_plain(x.float(), packed, scale)) <= CARD_REL_BOUND
    q8, s8 = Q.quantize_int8(w, stochastic=False)
    assert _rel_l2(Q.int8_matmul(x, q8, s8), Q.qmm_plain(x.float(), q8, s8, 8)) <= CARD_REL_BOUND
    q4, s4 = Q.quantize_int4(w)
    want4 = Q.qmm_plain(x.float(), q4, s4, 4)
    assert _rel_l2(Q.int4_matmul(x, q4, s4), want4) <= CARD_REL_BOUND
    # in the half-split layout, swapping the nibbles swaps the two halves
    assert _rel_l2(Q.int4_matmul(x, _swap_nibbles(q4), s4), want4) > CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(1000, 264), (1000, 263), (13824, 96), (37, 13)])
def test_quantize_int8_kernel(cuda, cin, cout):
    """Nearest mode bit for bit with the plain version; stochastic: on floor
    or ceil, the same seed the same bytes, unbiased over 64 seeds, and the
    bytes of the first design (`quantize_int8_first_design`) for each seed,
    at ragged couts too (not a multiple of 16, 32 or 4)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn(cin, cout, generator=g, device=cuda)
    before = Q.quantize_int8.launches
    q, s = Q.quantize_int8(w, stochastic=False)
    assert Q.quantize_int8.launches == before + 1
    want_q, want_s = Q.quantize_int8_plain(w)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    scaled = w / s
    a = Q.quantize_int8(w, seed=3)[0]
    assert torch.equal(a, Q.quantize_int8(w, seed=3)[0])
    assert ((a.float() == scaled.floor()) | (a.float() == scaled.ceil())).all()
    mean = torch.stack([Q.quantize_int8(w, seed=i)[0].float() for i in range(64)]).mean(0)
    assert ((mean - scaled).abs() <= 6 * 0.5 / 8).all()
    for seed in (3, 11, 2**40 + 7):
        first_q, first_s = Q.quantize_int8_first_design(w, seed=seed)
        got_q, got_s = Q.quantize_int8(w, seed=seed)
        assert torch.equal(got_q, first_q) and torch.equal(got_s, first_s)


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(5120, 512), (1000, 263)])
def test_quantize_int8_planted_faults_change_the_bytes(cuda, cin, cout):
    """Each planted fault of csrc/quantize_int8.cu breaks equality with the
    plain version (nearest) or the first design (stochastic): one rank's
    column maxima left out (the absmax planted in its rows), the Philox
    words rotated, the tile loaded one column off."""
    g = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn(cin, cout, generator=g, device=cuda)
    w[-1] = 8.0  # every column's absmax in the last rank's rows
    plan = Q.int8_plan(cin, cout)
    assert plan.ranks > 1
    want_q, want_s = Q.quantize_int8_plain(w)
    first_q = Q.quantize_int8_first_design(w, seed=9)[0]
    dropped = Q._launch_int8(w, 0, False, plan, fault=Q.Q8_FAULT_DROP_RANK)
    assert not torch.equal(dropped[1], want_s)
    assert not torch.equal(Q._launch_int8(w, 9, True, plan, fault=Q.Q8_FAULT_ROTATE_WORDS)[0], first_q)
    assert not torch.equal(Q._launch_int8(w, 0, False, plan, fault=Q.Q8_FAULT_SHIFT_TILE)[0], want_q)


@pytest.mark.gpu
def test_gemv_kernels_refuse_what_they_do_not_take(cuda):
    packed, scale = Q.quantize_int4_paired(torch.randn(64, 32, device=cuda))
    with pytest.raises(TypeError):
        Q.int4_paired_matmul(torch.randn(2, 64, device=cuda), packed, scale)  # fp32
    with pytest.raises(ValueError):
        Q.int4_paired_matmul(torch.randn(2, 66, device=cuda).to(torch.bfloat16), packed, scale)
    packed12, scale12 = Q.quantize_int4_paired(torch.randn(64, 12, device=cuda))
    with pytest.raises(ValueError):
        Q.int4_paired_matmul(torch.randn(2, 64, device=cuda).to(torch.bfloat16), packed12, scale12)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("cin,cout", [(512, 1536), (1536, 520)])
def test_w4a8_kernel_matches_plain(cuda, rows, cin, cout):
    """K10: the integer sums are exact on both sides, so only the two scale
    multiplies round: relative L2 <= 1e-6. The activation scale without its
    1/127 and a swapped nibble order must break it."""
    g = torch.Generator(device=cuda).manual_seed(3)
    packed, scale = Q.quantize_int4_paired(_card_weights(g, cin, cout, cuda))
    x = torch.randn(rows, cin, generator=g, device=cuda).to(torch.bfloat16)
    before = Q.int4_w4a8_matmul.launches
    got = Q.int4_w4a8_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert Q.int4_w4a8_matmul.launches == before + 1
    want = Q.int4_w4a8_matmul_plain(x.float(), packed, scale)
    assert _rel_l2(got, want) <= W4A8_REL_BOUND
    assert _rel_l2(got * 127.0, want) > W4A8_REL_BOUND
    assert _rel_l2(Q.int4_w4a8_matmul(x, _swap_nibbles(packed), scale), want) > CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("cin,cout,prologue,with_residual", [
    (512, 1536, "norm", False),
    (512, 512, "none", True),
    (1536, 512, "siluglu", True),
])
def test_fused_act_int8_kernel_matches_plain(cuda, rows, cin, cout, prologue, with_residual):
    """K5's act_int8 mode against its fp32 plain version: relative L2 <=
    1e-2 (the prologue's fp32 sums in another order can flip a few
    roundings of the activation quantizer)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    packed, scale = Q.quantize_int4_paired(_card_weights(g, cin, cout, cuda))
    x = torch.randn(rows, 2 * cin if prologue == "siluglu" else cin, generator=g, device=cuda).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(cin, generator=g, device=cuda) if prologue == "norm" else None
    residual = torch.randn(rows, cout, generator=g, device=cuda) if with_residual else None
    kw = dict(gamma=gamma, siluglu=prologue == "siluglu", residual=residual)
    before = Q.int4_paired_fused_matmul.act_int8_launches
    got = Q.int4_paired_fused_matmul(x, packed, scale, act_int8=True, **kw)
    torch.cuda.synchronize()
    assert Q.int4_paired_fused_matmul.act_int8_launches == before + 1
    want = Q.int4_paired_fused_matmul_plain(x.float(), packed, scale, act_int8=True, **kw)
    assert _rel_l2(got, want) <= CARD_REL_BOUND
    swapped = Q.int4_paired_fused_matmul(x, _swap_nibbles(packed), scale, act_int8=True, **kw)
    assert _rel_l2(swapped, want) > CARD_REL_BOUND
    if prologue == "norm":
        # planted fault: the activation quantized after bf16 rounding of an
        # RMSNorm without gamma
        xn = Q._prologue(x, cin, torch.ones_like(gamma), 1e-6, False).to(torch.bfloat16)
        assert _rel_l2(Q.int4_w4a8_matmul(xn, packed, scale), want) > CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("cin,cout", [(512, 1536), (1536, 520)])
def test_native_kernel_matches_plain(cuda, rows, cin, cout):
    """K11 against its fp32 plain version; the two column nibbles of each
    byte swapped must break the bound."""
    g = torch.Generator(device=cuda).manual_seed(5)
    packed, scale = Q.quantize_int4_native(_card_weights(g, cin, cout, cuda))
    x = torch.randn(rows, cin, generator=g, device=cuda).to(torch.bfloat16)
    before = Q.int4_native_matmul.launches
    got = Q.int4_native_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert Q.int4_native_matmul.launches == before + 1
    want = Q.int4_native_matmul_plain(x.float(), packed, scale)
    assert _rel_l2(got, want) <= CARD_REL_BOUND
    assert _rel_l2(Q.int4_native_matmul(x, _swap_nibbles(packed), scale), want) > CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 20])
@pytest.mark.parametrize("siluglu1", [False, True])
def test_pair_kernel_matches_plain(cuda, rows, siluglu1):
    """K9 against its fp32 plain version, small and big by relative L2 <=
    1e-2; phase 2 normalising by one strip's statistics instead of the
    whole row must break it. The first shape is taken by the tensor-core
    pair, the second (cout2 8 mod 16) by the strip body."""
    g = torch.Generator(device=cuda).manual_seed(6)
    cin1, cout1, cout2 = (1536, 512, 1032) if siluglu1 else (512, 512, 1536)
    qp1, sc1 = Q.quantize_int4_paired(_card_weights(g, cin1, cout1, cuda))
    qp2, sc2 = Q.quantize_int4_paired(_card_weights(g, cout1, cout2, cuda))
    x = torch.randn(rows, 2 * cin1 if siluglu1 else cin1, generator=g, device=cuda).to(torch.bfloat16)
    residual = torch.randn(rows, cout1, generator=g, device=cuda)
    gamma = 1.0 + 0.1 * torch.randn(cout1, generator=g, device=cuda)
    args = (qp1, sc1, residual, gamma, qp2, sc2)
    assert Q.pair_grid_blocks(rows) > 0
    before = Q.int4_paired_fused_pair.launches
    small, big = Q.int4_paired_fused_pair(x, *args, siluglu1=siluglu1)
    torch.cuda.synchronize()
    assert Q.int4_paired_fused_pair.launches == before + 1
    want_small, want_big = Q.int4_paired_fused_pair_plain(x.float(), *args, siluglu1=siluglu1)
    assert _rel_l2(small, want_small) <= CARD_REL_BOUND
    assert _rel_l2(big, want_big) <= CARD_REL_BOUND
    _, bad = Q.int4_paired_fused_pair(x, *args, siluglu1=siluglu1, _norm_cols=32)
    assert _rel_l2(bad, want_big) > CARD_REL_BOUND


# K9 on the tensor-core body: both phases' paired plans over one cooperative
# grid, phase 2 staged from fp32 small once every phase-1 strip is counted in
# (csrc/quant_gemv_tc.cu:qpair_tc_kernel). (cin1, cout1, cout2, SiLU-GLU):
# the 13B layer's two pairs and ragged cuts (couts not a multiple of the
# 128-column strip, cin not of the chunk).
TC_PAIRS = [(5120, 5120, 27648, False), (13824, 5120, 15360, True), (640, 272, 400, False), (1000, 400, 144, True)]


def _tc_pair_case(cuda, seed, rows, cin1, cout1, cout2, siluglu1):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qp1, sc1 = Q.quantize_int4_paired(_card_weights(g, cin1, cout1, cuda))
    qp2, sc2 = Q.quantize_int4_paired(_card_weights(g, cout1, cout2, cuda))
    x = torch.randn(rows, 2 * cin1 if siluglu1 else cin1, generator=g, device=cuda).to(torch.bfloat16)
    residual = torch.randn(rows, cout1, generator=g, device=cuda)
    gamma = 1.0 + 0.1 * torch.randn(cout1, generator=g, device=cuda)
    return x, (qp1, sc1, residual, gamma, qp2, sc2)


def _pair_rel(got, want):
    return max(_rel_l2(g_, w_) for g_, w_ in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("cin1,cout1,cout2,siluglu1", TC_PAIRS)
def test_tc_pair_kernel_matches_plain(cuda, rows, cin1, cout1, cout2, siluglu1):
    """K9, counted, on the tensor-core pair: small and big within relative
    L2 1e-2 of the fp32 plain version (which rounds small to bf16 before
    the RMSNorm, where the kernel reads it in fp32), and the strip body it
    replaced within the same bound of both."""
    from supir_tpu_torch.ops import gemv_plan as GP

    x, w = _tc_pair_case(cuda, 30, rows, cin1, cout1, cout2, siluglu1)
    assert GP.tc_pair_eligible(rows, cin1, cout1, cout2, w[0].data_ptr(), w[4].data_ptr(), x.data_ptr(), x.stride(0))
    before = Q.int4_paired_fused_pair.launches
    got = Q.int4_paired_fused_pair(x, *w, siluglu1=siluglu1)
    torch.cuda.synchronize()
    assert Q.int4_paired_fused_pair.launches == before + 1
    want = Q.int4_paired_fused_pair_plain(x.float(), *w, siluglu1=siluglu1)
    assert _pair_rel(got, want) <= CARD_REL_BOUND
    strip = Q.strip_body_pair(x, *w, siluglu1=siluglu1)
    assert Q.int4_paired_fused_pair.launches == before + 1
    assert _pair_rel(strip, want) <= CARD_REL_BOUND and _pair_rel(got, strip) <= CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 32])
def test_tc_pair_two_runs_are_bit_identical(cuda, rows):
    """No atomic adds a value: three more runs and a CUDA-graph replay of
    the launch give the first run's bits."""
    x, w = _tc_pair_case(cuda, 31, rows, 13824, 5120, 15360, True)
    first = Q.int4_paired_fused_pair(x, *w, siluglu1=True)
    for _ in range(3):
        again = Q.int4_paired_fused_pair(x, *w, siluglu1=True)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        Q.int4_paired_fused_pair(x, *w, siluglu1=True)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = Q.int4_paired_fused_pair(x, *w, siluglu1=True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first[0], captured[0]) and torch.equal(first[1], captured[1])


@pytest.mark.gpu
@pytest.mark.parametrize("pair", [0, 1])
@pytest.mark.parametrize("rows", [1, 8])
def test_tc_pair_planted_faults_break_the_bound(cuda, pair, rows):
    """Phase 2 staged without waiting for phase 1's strips (it reads small
    as it stood at launch), the statistics from 32 columns of one strip or
    from one strip's sums of squares alone, phase 1's combine run twice, one block's share dropped, x' staged
    without its interleave, W2's nibbles swapped: each must break the
    bound; a sound launch after them still meets it (the counters were left
    zero). Phase 1 is cut into k-slices on this card, so its combine runs."""
    from supir_tpu_torch.ops import gemv_plan as GP

    cin1, cout1, cout2, siluglu1 = TC_PAIRS[pair]
    x, w = _tc_pair_case(cuda, 32, rows, cin1, cout1, cout2, siluglu1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert GP.tc_pair_plan(rows, cin1, cout1, cout2, sms).first.slices > 1
    want = Q.int4_paired_fused_pair_plain(x.float(), *w, siluglu1=siluglu1)
    assert _pair_rel(Q.int4_paired_fused_pair(x, *w, siluglu1=siluglu1), want) <= CARD_REL_BOUND
    assert _pair_rel(Q.int4_paired_fused_pair(x, *w, siluglu1=siluglu1, _norm_cols=32), want) > CARD_REL_BOUND
    for fault in (GP.FAULT_STALE_SMALL, GP.FAULT_ONE_STRIP, GP.FAULT_COMBINE_TWICE, GP.FAULT_DROP_SHARE,
                  GP.FAULT_X_ORDER):
        got = Q.int4_paired_fused_pair(x, *w, siluglu1=siluglu1, _fault=fault)
        assert _pair_rel(got, want) > CARD_REL_BOUND, fault
    swapped = (*w[:4], _swap_nibbles(w[4]), w[5])
    assert _pair_rel(Q.int4_paired_fused_pair(x, *swapped, siluglu1=siluglu1), want) > CARD_REL_BOUND
    assert _pair_rel(Q.int4_paired_fused_pair(x, *w, siluglu1=siluglu1), want) <= CARD_REL_BOUND


# ---------------------------- the tensor-core body (K5, K6, K7, K10, K11)
# csrc/quant_gemv_tc.cu: TMA weight stream, mma.sync, k-slice tiles combined
# in slice order (ops/gemv_plan.py). Held to the fp32 plain versions by
# relative L2 <= 1e-2 (bf16 rounding of x' gives a few 1e-3; K6, K7 and
# K11, whose x is bf16 already, agree to ~1e-6), at tile edges (cout not a
# multiple of the 128-column strip, cin not a multiple of the 128-k chunk
# or of a 16-k step) and at 1-32 rows.

TC_SHAPES = [(5120, 5120), (640, 272), (1000, 144), (264, 400), (13824, 5120)]
# the same edges where the half-split layout needs cin % 16 == 0 and the native one cout % 32 == 0
TC_INT4_SHAPES = {"half": [(5120, 5120), (640, 272), (1008, 144), (2048, 384), (13824, 5120)],
                  "native": [(5120, 5120), (640, 288), (1000, 160), (2048, 384), (13824, 5120)]}


def _int4_layout(mode, w, x):
    """(weights, the wrapper's call on x, its fp32 plain version) of K7's
    half-split instance or K11."""
    if mode == "half":
        q, s = Q.quantize_int4(w)
        return (q, s), (lambda xx, qq=q: Q.int4_matmul(xx, qq, s)), Q.qmm_plain(x.float(), q, s, 4)
    q, s = Q.quantize_int4_native(w)
    return (q, s), (lambda xx, qq=q: Q.int4_native_matmul(xx, qq, s)), Q.int4_native_matmul_plain(x.float(), q, s)


def _tc_case(cuda, seed, rows, cin, cout, prologue, with_residual):
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = _card_weights(g, cin, cout, cuda)
    x = torch.randn(rows, 2 * cin if prologue == "siluglu" else cin, generator=g, device=cuda).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(cin, generator=g, device=cuda) if prologue == "norm" else None
    residual = torch.randn(rows, cout, generator=g, device=cuda) if with_residual else None
    return w, x, dict(gamma=gamma, siluglu=prologue == "siluglu", residual=residual)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("cin,cout", TC_SHAPES)
@pytest.mark.parametrize("prologue,with_residual", [("none", False), ("none", True), ("norm", False),
                                                    ("norm", True), ("siluglu", False), ("siluglu", True)])
def test_tc_fused_kernel_matches_plain(cuda, rows, cin, cout, prologue, with_residual):
    from supir_tpu_torch.ops import gemv_plan as GP

    w, x, kw = _tc_case(cuda, 10, rows, cin, cout, prologue, with_residual)
    packed, scale = Q.quantize_int4_paired(w)
    assert GP.tc_eligible("paired", cin, cout, packed.data_ptr(), x.data_ptr(), x.stride(0))
    before = Q.int4_paired_fused_matmul.launches
    got = Q.int4_paired_fused_matmul(x, packed, scale, **kw)
    torch.cuda.synchronize()
    assert Q.int4_paired_fused_matmul.launches == before + 1
    assert _rel_l2(got, Q.int4_paired_fused_matmul_plain(x.float(), packed, scale, **kw)) <= CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("cin,cout", TC_SHAPES)
def test_tc_paired_and_int8_kernels_match_plain(cuda, rows, cin, cout):
    w, x, _ = _tc_case(cuda, 11, rows, cin, cout, "none", False)
    packed, scale = Q.quantize_int4_paired(w)
    assert _rel_l2(Q.int4_paired_matmul(x, packed, scale), Q.int4_paired_matmul_plain(x.float(), packed, scale)) \
        <= CARD_REL_BOUND
    q8, s8 = Q.quantize_int8(w, stochastic=False)
    assert _rel_l2(Q.int8_matmul(x, q8, s8), Q.qmm_plain(x.float(), q8, s8, 8)) <= CARD_REL_BOUND
    # the strip body the tensor-core body replaced, kept for comparisons
    assert _rel_l2(Q.strip_body_gemv(x, q8, s8, "int8"), Q.qmm_plain(x.float(), q8, s8, 8)) <= CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("mode,cin,cout", [(m, cin, cout) for m, shapes in TC_INT4_SHAPES.items()
                                           for cin, cout in shapes])
def test_tc_half_and_native_kernels_match_plain(cuda, rows, mode, cin, cout):
    """K7's half-split instance and K11 on the tensor-core body, counted,
    and the strip body they left, both within the bound."""
    from supir_tpu_torch.ops import gemv_plan as GP

    w, x, _ = _tc_case(cuda, 14, rows, cin, cout, "none", False)
    weights, call, want = _int4_layout(mode, w, x)
    assert GP.tc_eligible(mode, cin, cout, weights[0].data_ptr(), x.data_ptr(), x.stride(0))
    counter = Q.qmm if mode == "half" else Q.int4_native_matmul
    before = counter.launches
    got = call(x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _rel_l2(got, want) <= CARD_REL_BOUND
    assert _rel_l2(Q.strip_body_gemv(x, *weights, mode), want) <= CARD_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["half", "native"])
@pytest.mark.parametrize("rows", [1, 32])
def test_tc_int4_layouts_two_runs_are_bit_identical(cuda, mode, rows):
    w, x, _ = _tc_case(cuda, 15, rows, 5120, 5120, "none", False)
    _, call, _ = _int4_layout(mode, w, x)
    first = call(x)
    assert all(torch.equal(first, call(x)) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 32])
def test_tc_two_runs_are_bit_identical(cuda, rows):
    w, x, kw = _tc_case(cuda, 12, rows, 5120, 5120, "norm", True)
    packed, scale = Q.quantize_int4_paired(w)
    first = Q.int4_paired_fused_matmul(x, packed, scale, **kw)
    assert all(torch.equal(first, Q.int4_paired_fused_matmul(x, packed, scale, **kw)) for _ in range(3))
    q8, s8 = Q.quantize_int8(w, stochastic=False)
    first = Q.int8_matmul(x, q8, s8)
    assert all(torch.equal(first, Q.int8_matmul(x, q8, s8)) for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["paired", "int8", "half", "native"])
@pytest.mark.parametrize("rows", [1, 8])
def test_tc_planted_faults_break_the_bound(cuda, mode, rows):
    """One block's share dropped, the combine run twice, x' staged without
    its word interleave (half-split: in natural order), the nibbles swapped
    (half-split: the two halves; native: the two columns of a byte): each
    must break the bound. The shape is cut into k-slices on this card, so
    the combine runs."""
    from supir_tpu_torch.ops import gemv_plan as GP

    cin, cout = 5120, 5120
    prologue = "norm" if mode == "paired" else "none"
    w, x, kw = _tc_case(cuda, 13, rows, cin, cout, prologue, False)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert GP.tc_plan(mode, rows, cin, cout, sms).slices > 1
    if mode == "paired":
        weights = Q.quantize_int4_paired(w)
        want = Q.int4_paired_fused_matmul_plain(x.float(), *weights, **kw)
        pro, gamma = 1, kw["gamma"]
        assert _rel_l2(Q.int4_paired_fused_matmul(x, _swap_nibbles(weights[0]), weights[1], **kw), want) \
            > CARD_REL_BOUND
    elif mode in ("half", "native"):
        weights, call, want = _int4_layout(mode, w, x)
        pro, gamma = 0, None
        assert _rel_l2(call(x), want) <= CARD_REL_BOUND
        assert _rel_l2(Q._launch_gemv(x, _swap_nibbles(weights[0]), weights[1], mode, cin), want) > CARD_REL_BOUND
    else:
        weights = Q.quantize_int8(w, stochastic=False)
        want = Q.qmm_plain(x.float(), *weights, 8)
        pro, gamma = 0, None
    assert _rel_l2(Q._launch_gemv(x, *weights, mode, cin, gamma, 1e-6, pro), want) <= CARD_REL_BOUND
    for fault in (GP.FAULT_DROP_SHARE, GP.FAULT_COMBINE_TWICE, GP.FAULT_X_ORDER):
        got = Q._launch_gemv(x, *weights, mode, cin, gamma, 1e-6, pro, _fault=fault)
        assert _rel_l2(got, want) > CARD_REL_BOUND, fault
    # a planted fault leaves the strip counters as it found them
    assert _rel_l2(Q._launch_gemv(x, *weights, mode, cin, gamma, 1e-6, pro), want) <= CARD_REL_BOUND


# W4A8 on the tensor-core body (K10, and K5's act_int8 mode): the paired
# weights against int8 x on mma.sync m16n8k32, exact int32 sums. K10 equals
# the strip body it replaced bit for bit (the same integer dot, the same two
# scale multiplies), and K5's act_int8 mode does too where no prologue's
# fp32 statistics are summed in another order.

W4A8_TC_SHAPES = [(5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120), (640, 272), (1000, 144), (264, 400)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 32])
@pytest.mark.parametrize("cin,cout", W4A8_TC_SHAPES)
def test_tc_w4a8_equals_the_strip_body(cuda, rows, cin, cout):
    """K10, counted, on the tensor-core body at every 13B shape and at
    ragged ones (cout not a multiple of the strip, cin not of the chunk or
    of a 32-k step): bit for bit the strip body's output, and within 1e-6 of
    the plain version."""
    from supir_tpu_torch.ops import gemv_plan as GP

    w, x, _ = _tc_case(cuda, 16, rows, cin, cout, "none", False)
    packed, scale = Q.quantize_int4_paired(w)
    xq, xs = Q.quantize_act_int8(x)
    assert GP.tc_eligible("w4a8", cin, cout, packed.data_ptr(), xq.data_ptr(), xq.stride(0))
    before = Q.int4_w4a8_matmul.launches
    got = Q.int4_w4a8_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert Q.int4_w4a8_matmul.launches == before + 1
    assert torch.equal(got, Q._launch_w4a8(xq, xs, packed, scale))
    assert torch.equal(got, Q.strip_body_w4a8(xq, xs, packed, scale))
    assert _rel_l2(got, Q.int4_w4a8_matmul_plain(x.float(), packed, scale)) <= W4A8_REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 17, 32])
@pytest.mark.parametrize("cin,cout", [(5120, 5120), (640, 272), (1000, 144), (13824, 5120)])
@pytest.mark.parametrize("prologue,with_residual", [("none", False), ("none", True), ("norm", False),
                                                    ("norm", True), ("siluglu", False), ("siluglu", True)])
def test_tc_act_int8_matches_plain(cuda, rows, cin, cout, prologue, with_residual):
    """K5's act_int8 mode, counted, on the tensor-core body in every
    prologue and residual form: relative L2 <= 1e-2 of the plain version,
    as the strip body; without a prologue bit for bit the strip body's
    output."""
    from supir_tpu_torch.ops import gemv_plan as GP

    w, x, kw = _tc_case(cuda, 17, rows, cin, cout, prologue, with_residual)
    packed, scale = Q.quantize_int4_paired(w)
    assert GP.tc_eligible("w4a8", cin, cout, packed.data_ptr(), x.data_ptr(), x.stride(0))
    before = Q.int4_paired_fused_matmul.act_int8_launches
    got = Q.int4_paired_fused_matmul(x, packed, scale, act_int8=True, **kw)
    torch.cuda.synchronize()
    assert Q.int4_paired_fused_matmul.act_int8_launches == before + 1
    want = Q.int4_paired_fused_matmul_plain(x.float(), packed, scale, act_int8=True, **kw)
    assert _rel_l2(got, want) <= CARD_REL_BOUND
    strip = Q.strip_body_w4a8(x, None, packed, scale, **kw)
    assert _rel_l2(strip, want) <= CARD_REL_BOUND
    if prologue == "none":
        assert torch.equal(got, strip)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 32])
def test_tc_w4a8_two_runs_are_bit_identical(cuda, rows):
    w, x, kw = _tc_case(cuda, 19, rows, 5120, 5120, "norm", True)
    packed, scale = Q.quantize_int4_paired(w)
    first = Q.int4_w4a8_matmul(x, packed, scale)
    assert all(torch.equal(first, Q.int4_w4a8_matmul(x, packed, scale)) for _ in range(3))
    first = Q.int4_paired_fused_matmul(x, packed, scale, act_int8=True, **kw)
    assert all(torch.equal(first, Q.int4_paired_fused_matmul(x, packed, scale, act_int8=True, **kw))
               for _ in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["k10", "act_int8"])
@pytest.mark.parametrize("rows", [1, 8])
def test_tc_w4a8_planted_faults_break_the_bound(cuda, form, rows):
    """One block's share dropped, the combine run twice, x staged without
    its quad interleave, the row scale applied twice, the nibbles swapped:
    each must break K10's bound (1e-6) or K5 act_int8's (1e-2). The shape
    is cut into k-slices on this card, so the combine runs."""
    from supir_tpu_torch.ops import gemv_plan as GP

    cin, cout = 5120, 5120
    w, x, kw = _tc_case(cuda, 20, rows, cin, cout, "norm" if form == "act_int8" else "none", False)
    packed, scale = Q.quantize_int4_paired(w)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert GP.tc_plan("w4a8", rows, cin, cout, sms).slices > 1
    if form == "k10":
        args, extra, bound = Q.quantize_act_int8(x), {}, W4A8_REL_BOUND
        want = Q.int4_w4a8_matmul_plain(x.float(), packed, scale)
    else:
        args, extra, bound = (x, None), dict(gamma=kw["gamma"], prologue=1), CARD_REL_BOUND
        want = Q.int4_paired_fused_matmul_plain(x.float(), packed, scale, act_int8=True, **kw)
    assert _rel_l2(Q._launch_w4a8(*args, packed, scale, **extra), want) <= bound
    for fault in (GP.FAULT_DROP_SHARE, GP.FAULT_COMBINE_TWICE, GP.FAULT_X_ORDER, GP.FAULT_ROW_SCALE):
        assert _rel_l2(Q._launch_w4a8(*args, packed, scale, **extra, _fault=fault), want) > bound, fault
    assert _rel_l2(Q._launch_w4a8(*args, _swap_nibbles(packed), scale, **extra), want) > bound
    # a planted fault leaves the strip counters as it found them
    assert _rel_l2(Q._launch_w4a8(*args, packed, scale, **extra), want) <= bound
