"""K3 fp32 and K4 fp32: the flash forward with its logsumexp and the flash
backward for fp32 operands (`csrc/flash_attn_fwd_fp32.cu` with an lse
output, `csrc/flash_attn_bwd_fp32.cu`), and the routing that sends fp32
work under grad and fp32 rings to them.

K4 fp32's walk (`flash_bwd_fp32_emulate`: the dQ and dK/dV kernels'
blocks and tiles, TF32 pairs, three products, the transposed operands'
key order), from JAX's own residuals, against JAX's `_flash_bwd` in
interpret mode at JAX_BOUND (relative L2), with and without MPT's slopes,
multiquery too, and against the plain version; each emulated planted
fault over K4_FP32_REL_BOUND; the tile constants and the TMA plans at the
backward's box rows. On the card the kernel is held to its walk.

On the CPU: the port's fp32 lse forward and backward (the plain versions
the wrappers return for CPU tensors, and K3 fp32's walk
`flash_fp32_emulate(..., with_lse=True)`) against the JAX package's
`_flash_fwd_lse` and `_flash_bwd` in Pallas interpret mode on fp32 inputs,
causal and not, at relative L2 1e-5 (the lse at 1e-5 absolute); the walk's
planted lse fault over that bound; and the routing with the card stubbed
in: an fp32 site under grad runs `FlashAttention` on the fp32 launchers,
an fp16 one is widened, computed in fp32 and rounded back once (its
gradients too), bf16 stays on the bf16 launchers, and an fp32 or fp16
ALiBi site under grad (MPT's) reaches K3 ALiBi fp32 and K4 ALiBi fp32 with
its slopes, through `attention`, `FlashAttention` and MPT's causal-LM loss.
K3 ALiBi fp32's walk and K4 ALiBi fp32's plain version are held to JAX's
`_flash_fwd_lse` and `_flash_bwd` with slopes in fp32 (2e-5 absolute, the
JAX package's ALiBi tolerance). The `gpu` tests hold the kernels to their
plain versions on the card (K3 fp32: O 1e-5 relative L2 and lse 1e-3
absolute; K4 fp32: dQ, dK, dV 2e-5 each; with ALiBi: O against
`attention_plain` and dQ, dK, dV at 1e-5), every planted fault over its
bound, two K4 fp32 runs bit-identical:
python -m pytest --noconftest tests/test_torch_flash_train_fp32.py -m gpu
"""

import functools

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops import flash_attention as fa
from supir_tpu_torch.ops.flash_attention import (
    BWD_FP32_BOX,
    BWD_FP32_FAULT_DIAGONAL,
    BWD_FP32_FAULT_DK_SCALE,
    BWD_FP32_FAULT_LSE_LOG2,
    BWD_FP32_FAULT_NO_DELTA,
    BWD_FP32_FAULT_NO_T_LO,
    BWD_FP32_FAULT_ONE_PRODUCT,
    BWD_FP32_FAULT_T_ORDER,
    BWD_FP32_ROWS,
    FP32_FAULT_LSE_LOG2,
    FP32_FAULT_NO_RESCALE,
    FlashAttention,
    attention_bwd_plain,
    attention_fwd_lse_plain,
    flash_attention_bwd,
    flash_attention_fwd_lse,
    flash_bwd_fp32_emulate,
    flash_fp32_emulate,
    tma_plan,
)
from torch_parity import one_torch_thread  # noqa: F401

O_BOUND = 1e-5     # K3 fp32's O, relative L2 (K1 fp32's bound)
LSE_BOUND = 1e-3   # K3 fp32's lse on the card, absolute
CPU_LSE = 1e-5     # the CPU walk's and plain lse against JAX, absolute
GRAD_BOUND = 2e-5  # K4 fp32's dQ, dK, dV on the card, each relative L2
JAX_BOUND = 1e-5   # the plain versions against JAX's interpret mode, relative L2

# (b, s, t, h, d, causal): ragged S and T, both head dims
CASES = [
    (1, 130, 130, 2, 64, False),
    (1, 130, 130, 2, 64, True),
    (1, 100, 150, 2, 128, False),
    (1, 96, 96, 1, 128, True),
]


def _inputs(seed, b, s, t, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d), (b, s, h, d)))


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(q, k, v, g, JAX's out, lse [B,H,S], dq, dk, dv) in fp32, interpret mode."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import _flash_bwd, _flash_fwd_lse

    b, s, t, h, d, causal = case
    q, k, v, g = _inputs(sum(case[:5]), b, s, t, h, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse_lanes = _flash_fwd_lse(jq, jk, jv, causal, None, 64, 64, True)
    grads = _flash_bwd(jq, jk, jv, out, lse_lanes, jnp.asarray(g), causal, None, 64, 64, True)
    lse = np.asarray(lse_lanes)[:, :s, 0].reshape(b, h, s)
    assert np.asarray(out).dtype == np.float32 and all(np.asarray(x).dtype == np.float32 for x in grads)
    return (q, k, v, g, np.asarray(out), lse) + tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("case", CASES)
def test_fp32_lse_forward_matches_jax(case):
    """The port's fp32 lse forward (the plain version the CPU runs, and K3
    fp32's walk) against `_flash_fwd_lse` on fp32 inputs."""
    q, k, v, _, want_out, want_lse = _jax_case(case)[:6]
    causal = case[-1]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_fwd_lse(tq, tk, tv, causal)
    assert out.dtype == lse.dtype == torch.float32
    assert _rel(out, want_out) <= JAX_BOUND
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=CPU_LSE, rtol=0)
    walk_out, walk_lse = flash_fp32_emulate(tq, tk, tv, causal, with_lse=True)
    assert _rel(walk_out, want_out) <= JAX_BOUND
    np.testing.assert_allclose(walk_lse.numpy(), want_lse, atol=CPU_LSE, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_fp32_backward_matches_jax(case):
    """The port's fp32 backward (plain on the CPU), from JAX's own
    residuals, against `_flash_bwd`; and FlashAttention's fp32 gradients
    through autograd."""
    q, k, v, g, out, lse, *want = _jax_case(case)
    causal = case[-1]
    got = flash_attention_bwd(*map(torch.from_numpy, (q, k, v, np.array(out), lse, g)), causal)
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == torch.float32
        assert _rel(a, w) <= JAX_BOUND, f"d{name}"
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (FlashAttention.apply(tq, tk, tv, causal) * torch.from_numpy(g)).sum().backward()
    for name, a, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert _rel(a, w) <= JAX_BOUND, f"d{name} via autograd"


ALIBI_ATOL = 2e-5  # against JAX's ALiBi kernels, absolute (tests/test_flash_attention.py:72)
# (b, s, t, h, d, causal, multiquery): both head dims, causal and not
ALIBI_CASES = [
    (1, 130, 130, 4, 64, True, False),
    (1, 100, 150, 2, 128, False, False),
    (1, 96, 96, 2, 128, True, False),
    (1, 130, 130, 6, 64, True, True),
]


@functools.lru_cache(maxsize=None)
def _jax_alibi_case(case):
    """(q, k, v, g, slopes, JAX's out, lse [B,H,S], dq, dk, dv) in fp32 with
    MPT's slopes, interpret mode; multiquery k and v broadcast over heads."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import _flash_bwd, _flash_fwd_lse
    from supir_tpu_torch.captioner.mpt import alibi_slopes

    b, s, t, h, d, causal, mqa = case
    q, k, v, g = _inputs(sum(case[:5]), b, s, t, h, d)
    if mqa:
        k, v = (np.ascontiguousarray(np.broadcast_to(x[:, :, :1], x.shape)) for x in (k, v))
    slopes = alibi_slopes(h)
    static = tuple(float(x) for x in slopes)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse_lanes = _flash_fwd_lse(jq, jk, jv, causal, static, 64, 64, True)
    grads = _flash_bwd(jq, jk, jv, out, lse_lanes, jnp.asarray(g), causal, static, 64, 64, True)
    lse = np.asarray(lse_lanes)[:, :s, 0].reshape(b, h, s)
    return (q, k, v, g, slopes, np.asarray(out), lse) + tuple(np.asarray(x) for x in grads)


@pytest.mark.parametrize("case", ALIBI_CASES)
def test_alibi_fp32_lse_forward_matches_jax(case):
    """K3 ALiBi fp32's walk (with its lse) and the plain version against
    `_flash_fwd_lse` with MPT's slopes on fp32 inputs: O and the lse, which
    holds the whole bias, its -(T - 1) offset too."""
    q, k, v, _, slopes, want_out, want_lse = _jax_alibi_case(case)[:7]
    causal = case[5]
    tq, tk, tv, ts = map(torch.from_numpy, (q, k, v, slopes))
    walk_out, walk_lse = flash_fp32_emulate(tq, tk, tv, causal, with_lse=True, alibi_slopes=ts)
    np.testing.assert_allclose(walk_out.numpy(), want_out, atol=ALIBI_ATOL, rtol=0)
    np.testing.assert_allclose(walk_lse.numpy(), want_lse, atol=ALIBI_ATOL, rtol=0)
    out, lse = flash_attention_fwd_lse(tq, tk, tv, causal, ts)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ALIBI_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ALIBI_ATOL, rtol=0)


@pytest.mark.parametrize("case", ALIBI_CASES)
def test_alibi_fp32_backward_matches_jax(case):
    """K4 ALiBi fp32's plain version, from JAX's own residuals, against
    `_flash_bwd` with the slopes; and FlashAttention's gradients with the
    slopes through autograd."""
    q, k, v, g, slopes, out, lse, *want = _jax_alibi_case(case)
    causal = case[5]
    ts = torch.from_numpy(slopes)
    got = flash_attention_bwd(*map(torch.from_numpy, (q, k, v, np.array(out), lse, g)), causal, ts)
    for name, a, w in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), w, atol=ALIBI_ATOL, rtol=0, err_msg=f"d{name}")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (FlashAttention.apply(tq, tk, tv, causal, ts) * torch.from_numpy(g)).sum().backward()
    for name, a, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), w, atol=ALIBI_ATOL, rtol=0, err_msg=f"d{name} via autograd")


def test_walk_lse_fault_breaks_the_bound():
    """K3 fp32's planted lse fault (log2 units) moves the lse far past the
    bound and leaves O as it was."""
    q, k, v, *_ = (torch.from_numpy(x) for x in _inputs(1, 1, 130, 130, 2, 64))
    out, lse = flash_fp32_emulate(q, k, v, True, with_lse=True)
    bad_out, bad_lse = flash_fp32_emulate(q, k, v, True, FP32_FAULT_LSE_LOG2, with_lse=True)
    assert torch.equal(out, bad_out)
    assert (bad_lse - lse).abs().max().item() > LSE_BOUND


# ------------------------------------------------------------ K4 fp32's walk

BWD_FAULTS = [BWD_FP32_FAULT_NO_DELTA, BWD_FP32_FAULT_DK_SCALE, BWD_FP32_FAULT_DIAGONAL, BWD_FP32_FAULT_LSE_LOG2,
              BWD_FP32_FAULT_ONE_PRODUCT, BWD_FP32_FAULT_NO_T_LO, BWD_FP32_FAULT_T_ORDER]


@pytest.mark.parametrize("case", CASES)
def test_bwd_walk_matches_jax(case):
    """K4 fp32's walk, from JAX's residuals, against `_flash_bwd` on fp32
    inputs and against the plain version: the 3xTF32 products and the
    per-tile sums stay within JAX_BOUND."""
    q, k, v, g, out, lse, *want = _jax_case(case)
    causal = case[-1]
    args = tuple(map(torch.from_numpy, (q, k, v, np.array(out), lse, g)))
    walk = flash_bwd_fp32_emulate(*args, causal)
    plain = attention_bwd_plain(*args, causal)
    for name, a, w, pl in zip("qkv", walk, want, plain):
        assert a.dtype == torch.float32 and a.shape == pl.shape
        assert _rel(a, w) <= JAX_BOUND, f"d{name}"
        assert _rel(a, pl) <= JAX_BOUND, f"d{name} vs plain"


@pytest.mark.parametrize("case", ALIBI_CASES)
def test_alibi_bwd_walk_matches_jax(case):
    """K4 ALiBi fp32's walk (the bias added to the scaled score, each step
    rounded to fp32) against `_flash_bwd` with MPT's slopes, multiquery
    k and v too."""
    q, k, v, g, slopes, out, lse, *want = _jax_alibi_case(case)
    causal = case[5]
    walk = flash_bwd_fp32_emulate(*map(torch.from_numpy, (q, k, v, np.array(out), lse, g)), causal,
                                  alibi_slopes=torch.from_numpy(slopes))
    for name, a, w in zip("qkv", walk, want):
        assert _rel(a, w) <= JAX_BOUND, f"d{name}"


K4_FP32_REL_BOUND = 2e-5  # chip_smoke.py's bound on K4 fp32's dQ, dK, dV (GRAD_BOUND on the card)


@pytest.mark.parametrize("fault", BWD_FAULTS)
def test_bwd_walk_faults_break_the_bound(fault):
    """Every planted fault of K4 fp32, walked, leaves the plain version by
    more than the card's bound: the one-product walk (plain TF32) and the
    walk without the transposed operands' lo parts are why 3xTF32 takes
    three products and both halves of every operand."""
    q, k, v, g, out, lse, *_ = _jax_case(CASES[1])
    args = tuple(map(torch.from_numpy, (q, k, v, np.array(out), lse, g)))
    want = attention_bwd_plain(*args, True)
    assert max(_rel(a, w) for a, w in zip(flash_bwd_fp32_emulate(*args, True), want)) <= JAX_BOUND
    bad = flash_bwd_fp32_emulate(*args, True, fault)
    assert max(_rel(a, w) for a, w in zip(bad, want)) > K4_FP32_REL_BOUND


def test_bwd_tiles_and_plans_are_the_kernels():
    """The walk's tiles are the source's ROWS and R; q, k, v and dout map in
    R-row boxes of 32 fp32 columns, multiquery k/v without the head axis."""
    import re
    from pathlib import Path

    src = (Path(fa.__file__).resolve().parents[1] / "csrc" / fa._BWD_FP32_SOURCE).read_text()
    assert re.search(rf"constexpr int ROWS = {BWD_FP32_ROWS};", src)
    assert re.search(rf"constexpr int R = {BWD_FP32_BOX};", src)
    assert '#include "flash_attn_tf32.cuh"' in src and "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in src
    for d in (64, 128):
        plan = tma_plan(torch.empty(2, 300, 4, d), BWD_FP32_BOX)
        assert plan.box == (32, BWD_FP32_BOX, 1, 1) and plan.dims == (d, 300, 4, 2)
        kv = tma_plan(torch.empty(1, 300, 1, d).expand(1, 300, 4, d), BWD_FP32_BOX)
        assert kv.head == -1 and kv.dims == (d, 300)


# ------------------------------------------------------------ routing


@pytest.fixture
def stub_card(monkeypatch):
    """The wrappers' card branch on CPU tensors: `_on_card` says yes, and
    the launchers are recorders that return what the kernels compute (the
    plain versions). Yields the list of (launcher, dtype of q); the slopes
    each fp32 launcher was given land in `given`."""
    calls = []
    given.clear()

    def fwd_fp32_lse(q, k, v, causal, fault=0, slopes=None):
        calls.append(("K3 fp32" if slopes is None else "K3 ALiBi fp32", q.dtype))
        given.append(slopes)
        return attention_fwd_lse_plain(q, k, v, causal, slopes)

    def bwd_fp32(q, k, v, out, lse, dout, causal, fault=0, slopes=None):
        calls.append(("K4 fp32" if slopes is None else "K4 ALiBi fp32", q.dtype))
        given.append(slopes)
        return attention_bwd_plain(q, k, v, out, lse, dout, causal, slopes)

    def forward(q, k, v, causal, with_lse, slopes=None):
        calls.append(("K3" if with_lse else "K1", q.dtype))
        out, lse = attention_fwd_lse_plain(q.float(), k.float(), v.float(), causal)
        return out.to(q.dtype), lse if with_lse else None

    monkeypatch.setattr(fa, "_on_card", lambda kernel, q, inputs: not torch.is_grad_enabled() or not any(
        x.requires_grad for x in inputs))
    monkeypatch.setattr(fa, "_forward_fp32_lse", fwd_fp32_lse)
    monkeypatch.setattr(fa, "_backward_fp32", bwd_fp32)
    monkeypatch.setattr(fa, "_forward", forward)
    monkeypatch.setattr(fa, "_bwd_library", lambda: pytest.fail("the bf16 backward was reached"))
    yield calls


given = []


def _site(seed, dtype, s=1024, d=64):
    q, k, v, g = _inputs(seed, 1, s, s, 1, d)
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v, g))


def test_fp32_site_under_grad_runs_k3_and_k4_fp32(stub_card):
    q, k, v, g = _site(1, torch.float32)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    counts = (flash_attention_fwd_lse.fp32_launches, flash_attention_bwd.fp32_launches,
              flash_attention_fwd_lse.launches, flash_attention_bwd.launches)
    out = attn_ops.attention(q, k, v)
    (out * g).sum().backward()
    assert stub_card == [("K3 fp32", torch.float32), ("K4 fp32", torch.float32)]
    assert (flash_attention_fwd_lse.fp32_launches, flash_attention_bwd.fp32_launches,
            flash_attention_fwd_lse.launches, flash_attention_bwd.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert out.dtype == q.grad.dtype == torch.float32
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    (fa.attention_plain(qr, kr, vr) * g).sum().backward()
    for a, w in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert _rel(a, w) <= JAX_BOUND


def test_fp16_site_under_grad_is_widened_and_rounded_once(stub_card):
    q, k, v, g = _site(2, torch.float16)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = attn_ops.attention(q, k, v)
    (out.float() * g.float()).sum().backward()
    assert stub_card == [("K3 fp32", torch.float32), ("K4 fp32", torch.float32)]
    assert out.dtype == q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.float16
    # the widening is exact: the fp32 result on the same values, rounded once
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = FlashAttention.apply(qf, kf, vf)
    assert torch.equal(out, want.half())
    (want * g.float()).sum().backward()
    assert torch.equal(q.grad, qf.grad.half()) and torch.equal(v.grad, vf.grad.half())


def test_mixed_site_under_grad_is_promoted(stub_card):
    q, k, v, g = _site(3, torch.float32)
    q, k, v = q.bfloat16().requires_grad_(), k.requires_grad_(), v.requires_grad_()
    out = attn_ops.attention(q, k, v)
    out.sum().backward()
    assert [route for route, _ in stub_card] == ["K3 fp32", "K4 fp32"]
    assert out.dtype == torch.float32 and q.grad.dtype == torch.bfloat16


def test_bf16_site_under_grad_stays_on_k3(stub_card):
    q, k, v, _ = _site(4, torch.bfloat16)
    out = attn_ops.attention(*(x.requires_grad_() for x in (q, k, v)))
    assert stub_card == [("K3", torch.bfloat16)] and out.dtype == torch.bfloat16


def test_fp32_alibi_names_the_missing_kernels(stub_card):
    """No fp32 ALiBi kernel is missing: each wrapper takes fp32 operands
    with slopes to its fp32 ALiBi launcher, counted in
    `alibi_fp32_launches`; what is refused is a mix of dtypes."""
    q, k, v, g = _site(5, torch.float32)
    slopes = torch.tensor([0.25])
    counters = (flash_attention_fwd_lse, flash_attention_bwd)
    before = [(f.alibi_fp32_launches, f.fp32_launches, f.alibi_launches) for f in counters]
    out, lse = flash_attention_fwd_lse(q, k, v, True, slopes)
    flash_attention_bwd(q, k, v, out, lse, g, True, slopes)
    assert stub_card == [("K3 ALiBi fp32", torch.float32), ("K4 ALiBi fp32", torch.float32)]
    assert all(torch.equal(x, slopes) for x in given)
    assert [(f.alibi_fp32_launches, f.fp32_launches, f.alibi_launches) for f in counters] == [
        (a + 1, b, c) for a, b, c in before]
    with pytest.raises(TypeError, match="all-bf16 or all-fp32"):
        flash_attention_bwd(q, k, v, out.bfloat16(), lse, g, True, slopes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_alibi_site_under_grad_runs_k3_and_k4_alibi_fp32(stub_card, dtype):
    """MPT's attention (causal, ALiBi) under grad at an fp32 or fp16 site:
    `attention` sends it through `FlashAttention`, whose forward reaches K3
    ALiBi fp32 and whose backward hands the same slopes to K4 ALiBi fp32;
    the slopes get no gradient, and the gradients are the plain route's."""
    q, k, v, g = _site(6, dtype)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    slopes = torch.tensor([0.5], requires_grad=True)
    out = attn_ops.attention(q, k, v, causal=True, alibi_slopes=slopes)
    (out.float() * g.float()).sum().backward()
    assert stub_card == [("K3 ALiBi fp32", torch.float32), ("K4 ALiBi fp32", torch.float32)]
    assert len(given) == 2 and all(torch.equal(x, slopes.detach()) for x in given)
    assert slopes.grad is None and out.dtype == q.grad.dtype == dtype
    qr, kr, vr = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = fa.attention_plain(qr, kr, vr, causal=True, alibi_slopes=slopes.detach())
    (want * g.float()).sum().backward()
    tol = JAX_BOUND if dtype == torch.float32 else 1e-3  # fp16: one rounding of out and each gradient
    assert _rel(out.detach().float(), want.detach()) <= tol
    for a, w in ((q.grad, qr.grad), (k.grad, kr.grad), (v.grad, vr.grad)):
        assert _rel(a.float(), w) <= tol


def test_fp32_mpt_loss_under_grad_runs_k3_and_k4_alibi_fp32(stub_card, monkeypatch):
    """One causal-LM loss and backward through an fp32 MPT at 1024 tokens:
    every layer's attention runs K3 ALiBi fp32 and K4 ALiBi fp32 with the
    model's slopes, and every gradient is the plain route's."""
    from supir_tpu_torch.captioner.mpt import MPTConfig, MPTForCausalLM
    from supir_tpu_torch.captioner.train import causal_lm_loss

    cfg = MPTConfig(d_model=128, n_heads=2, n_layers=2, vocab_size=64, max_seq_len=1024)
    torch.manual_seed(0)
    model = MPTForCausalLM(cfg)
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=torch.Generator().manual_seed(2))
    causal_lm_loss(model(ids), ids).backward()
    assert stub_card == [("K3 ALiBi fp32", torch.float32)] * cfg.n_layers + [
        ("K4 ALiBi fp32", torch.float32)] * cfg.n_layers
    assert all(torch.equal(x, model.slopes("cpu")) for x in given)
    got = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    monkeypatch.setattr(fa, "_on_card", lambda kernel, q, inputs: False)  # the plain route
    causal_lm_loss(model(ids), ids).backward()
    for name, p in model.named_parameters():
        assert _rel(got[name], p.grad) <= JAX_BOUND, name


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K3 fp32 and K4 fp32 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(cuda, seed, b, s, t, h, d):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=cuda)
                 for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d), (b, s, h, d)))


def _card_rel(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


# the trainers' and the ring's shape classes, then tile edges: ragged S and
# T, causal with the diagonal in a ragged last block, both head dims
CARD_CASES = [
    (1, 4096, 4096, 10, 64, False),
    (2, 1024, 1024, 1, 128, False),
    (1, 1000, 1000, 2, 128, True),
    (2, 1100, 1500, 3, 64, False),
    (1, 1100, 1100, 4, 64, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal", CARD_CASES)
def test_k3_fp32_matches_plain(cuda, b, s, t, h, d, causal):
    q, k, v, _ = _card(cuda, 11, b, s, t, h, d)
    before = flash_attention_fwd_lse.fp32_launches
    out, lse = flash_attention_fwd_lse(q, k, v, causal)
    assert flash_attention_fwd_lse.fp32_launches == before + 1
    want_out, want_lse = attention_fwd_lse_plain(q, k, v, causal)
    assert _card_rel(out, want_out) <= O_BOUND
    assert (lse - want_lse).abs().max().item() <= LSE_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("fault,causal", [(FP32_FAULT_NO_RESCALE, False), (FP32_FAULT_LSE_LOG2, True)])
def test_k3_fp32_planted_faults(cuda, fault, causal):
    q, k, v, _ = _card(cuda, 12, 1, 1000, 1000, 2, 64)
    want_out, want_lse = attention_fwd_lse_plain(q, k, v, causal)
    out, lse = fa._forward_fp32_lse(q, k, v, causal, fault)
    broken = _card_rel(out, want_out) > O_BOUND or (lse - want_lse).abs().max().item() > LSE_BOUND
    assert broken


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal", CARD_CASES)
def test_k4_fp32_matches_plain(cuda, b, s, t, h, d, causal):
    q, k, v, g = _card(cuda, 13, b, s, t, h, d)
    out, lse = attention_fwd_lse_plain(q, k, v, causal)
    before = flash_attention_bwd.fp32_launches
    got = flash_attention_bwd(q, k, v, out, lse, g, causal)
    again = flash_attention_bwd(q, k, v, out, lse, g, causal)
    assert flash_attention_bwd.fp32_launches == before + 2
    want = attention_bwd_plain(q, k, v, out, lse, g, causal)
    for name, a, w, b2 in zip("qkv", got, want, again):
        assert a.dtype == torch.float32 and torch.equal(a, b2), f"d{name} differs between two runs"
        assert _card_rel(a, w) <= GRAD_BOUND, f"d{name}"


@pytest.mark.gpu
@pytest.mark.parametrize("fault", BWD_FAULTS)
def test_k4_fp32_planted_faults(cuda, fault):
    q, k, v, g = _card(cuda, 14, 1, 1000, 1000, 2, 128)
    out, lse = attention_fwd_lse_plain(q, k, v, True)
    want = attention_bwd_plain(q, k, v, out, lse, g, True)
    sound = fa._backward_fp32(q, k, v, out, lse, g, True)
    assert max(_card_rel(a, w) for a, w in zip(sound, want)) <= GRAD_BOUND
    bad = fa._backward_fp32(q, k, v, out, lse, g, True, fault)
    assert max(_card_rel(a, w) for a, w in zip(bad, want)) > GRAD_BOUND


@pytest.mark.gpu
def test_fp32_flash_attention_grads_on_the_card(cuda):
    q, k, v, g = _card(cuda, 15, 1, 1024, 1024, 2, 64)
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, k, v))
    (attn_ops.attention(qs, ks, vs) * g).sum().backward()
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    (fa.attention_plain(qr, kr, vr) * g).sum().backward()
    for a, w in ((qs.grad, qr.grad), (ks.grad, kr.grad), (vs.grad, vr.grad)):
        assert _card_rel(a, w) <= GRAD_BOUND


def _card_slopes(cuda, h):
    from supir_tpu_torch.captioner.mpt import alibi_slopes

    return torch.from_numpy(alibi_slopes(h)).to(cuda)


def _card_alibi(cuda, seed, b, s, t, h, d, mqa):
    q, k, v, g = _card(cuda, seed, b, s, t, h, d)
    if mqa:
        k, v = (x[:, :, :1].expand(b, t, h, d) for x in (k, v))
    return q, k, v, g, _card_slopes(cuda, h)


# (b, s, t, h, d, causal, multiquery): MPT-7B's gradient shape, then tile
# edges, both head dims, MPT's multiquery k and v (expanded, stride 0)
ALIBI_CARD_CASES = [
    (1, 2048, 2048, 32, 128, True, False),
    (1, 1000, 1000, 4, 128, True, False),
    (2, 1100, 1500, 3, 64, False, False),
    (1, 1030, 1030, 8, 128, True, True),
]
ALIBI_BOUND = 1e-5  # K3 ALiBi fp32's O and K4 ALiBi fp32's dQ, dK, dV, each relative L2


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal,mqa", ALIBI_CARD_CASES)
def test_k3_and_k4_alibi_fp32_match_plain(cuda, b, s, t, h, d, causal, mqa):
    """K3 ALiBi fp32: O against attention_plain in fp32 (K3's plain version
    normalises by its fp32 lse, whose rounding at |lse| ~ 1700 moves O by
    ~1e-5; attention_plain normalises by the sum, as the kernel does), the
    lse against attention_fwd_lse_plain's; K4 ALiBi fp32 on K3's residuals
    against attention_bwd_plain, two runs bit-identical; counted in
    `alibi_fp32_launches` alone."""
    q, k, v, g, slopes = _card_alibi(cuda, 16, b, s, t, h, d, mqa)
    counters = (flash_attention_fwd_lse, flash_attention_bwd)
    before = [(f.alibi_fp32_launches, f.fp32_launches, f.alibi_launches) for f in counters]
    out, lse = flash_attention_fwd_lse(q, k, v, causal, slopes)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, slopes)
    again = flash_attention_bwd(q, k, v, out, lse, g, causal, slopes)
    torch.cuda.synchronize()
    assert [(f.alibi_fp32_launches, f.fp32_launches, f.alibi_launches) for f in counters] == [
        (before[0][0] + 1,) + before[0][1:], (before[1][0] + 2,) + before[1][1:]]
    assert _card_rel(out, fa.attention_plain(q, k, v, causal=causal, alibi_slopes=slopes)) <= ALIBI_BOUND
    assert (lse - attention_fwd_lse_plain(q, k, v, causal, slopes)[1]).abs().max().item() <= LSE_BOUND
    want = attention_bwd_plain(q, k, v, out, lse, g, causal, slopes)
    for name, a, w, a2 in zip("qkv", got, want, again):
        assert a.dtype == torch.float32 and torch.equal(a, a2), f"d{name} differs between two runs"
        assert _card_rel(a, w) <= ALIBI_BOUND, f"d{name}"


@pytest.mark.gpu
def test_k3_and_k4_alibi_fp32_planted_faults(cuda):
    """The bias in raw q.k units and the slopes reversed break O's bound,
    the -(T - 1) offset dropped breaks the lse's, K4 without the bias (or
    with the reversed slopes) the gradients'."""
    q, k, v, g, slopes = _card_alibi(cuda, 17, 1, 1000, 1000, 4, 128, False)
    want_out = fa.attention_plain(q, k, v, causal=True, alibi_slopes=slopes)
    want_lse = attention_fwd_lse_plain(q, k, v, True, slopes)[1]
    out, lse = fa._forward_fp32_lse(q, k, v, True, slopes=slopes)
    assert _card_rel(out, want_out) <= ALIBI_BOUND
    raw, _ = fa._forward_fp32_lse(q, k, v, True, fa.FP32_FAULT_ALIBI_RAW_UNITS, slopes)
    assert _card_rel(raw, want_out) > ALIBI_BOUND
    assert _card_rel(fa._forward_fp32_lse(q, k, v, True, slopes=slopes.flip(0))[0], want_out) > ALIBI_BOUND
    _, no_offset = fa._forward_fp32_lse(q, k, v, True, fa.FP32_FAULT_ALIBI_NO_OFFSET, slopes)
    assert (no_offset - want_lse).abs().max().item() > LSE_BOUND
    want = attention_bwd_plain(q, k, v, out, lse, g, True, slopes)
    for bad in (fa._backward_fp32(q, k, v, out, lse, g, True), fa._backward_fp32(q, k, v, out, lse, g, True,
                                                                                   slopes=slopes.flip(0))):
        assert not max(_card_rel(a, w) for a, w in zip(bad, want)) <= ALIBI_BOUND


# the kernel against its walk on the same values: the same blocks, tiles,
# TF32 roundings and products, causal with ragged blocks, both head dims.
# The walk's sums are the CPU's; the tensor cores' own fp32 accumulation
# (its S, dP and each tile's products) sits 1-2e-6 from an exact sum (the
# kernel's distance to fp64 on the card), so the walk is held at 5e-6, a
# fortieth of the faults' 2e-4.
BWD_WALK_BOUND = 5e-6


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [0, BWD_FP32_FAULT_ONE_PRODUCT, BWD_FP32_FAULT_NO_T_LO, BWD_FP32_FAULT_T_ORDER])
@pytest.mark.parametrize("d,alibi", [(64, False), (128, True)])
def test_k4_fp32_kernel_equals_its_walk(cuda, fault, d, alibi):
    """K4 fp32 (and K4 ALiBi fp32) and flash_bwd_fp32_emulate on the same
    values. Where the TF32 rounding decides the result (one product, the
    transposed operands without their lo parts: ~5e-4 and ~2e-4 from the
    plain version) the walk stays within a twentieth of the kernel's
    distance to the plain version: the walk's rounding is what the card's
    tensor cores read. On one product (plain TF32 in S and dP too) the
    tensor cores' sums of TF32 products leave the walk's by ~1.1e-5, so
    that fault is held to the second test alone."""
    q, k, v, g = _card(cuda, 18, 1, 300, 300, 2, d)
    slopes = _card_slopes(cuda, 2) if alibi else None
    out, lse = attention_fwd_lse_plain(q, k, v, True, slopes)
    got = [x.cpu() for x in fa._backward_fp32(q, k, v, out, lse, g, True, fault, slopes)]
    cpu = [x.cpu() for x in (q, k, v, out, lse, g)]
    walk = flash_bwd_fp32_emulate(*cpu, True, fault, None if slopes is None else slopes.cpu())
    plain = attention_bwd_plain(*cpu, True, None if slopes is None else slopes.cpu())
    for name, a, w, pl in zip("qkv", got, walk, plain):
        if fault != BWD_FP32_FAULT_ONE_PRODUCT:
            assert _card_rel(a, w) <= BWD_WALK_BOUND, f"d{name}"
        if fault in (BWD_FP32_FAULT_ONE_PRODUCT, BWD_FP32_FAULT_NO_T_LO):
            assert _card_rel(a, w) <= _card_rel(a, pl) / 20, f"d{name}"
