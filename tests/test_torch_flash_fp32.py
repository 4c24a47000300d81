"""K1 fp32 (`supir_tpu_torch/csrc/flash_attn_fwd_fp32.cu`), the flash
forward for fp32 q, k and v, and the attention sites' routing by dtype.

On the CPU: `flash_fp32_emulate`, which walks the kernel's 64-row query
blocks and 64-key tiles in the kernel's order with its online softmax,
against the JAX package's `flash_attention` at fp32 in Pallas interpret
mode (relative L2 1e-5: both sum fp32 products in their own orders, some
1e-7), with each planted fault over that bound; and the routing with the
card stubbed in: fp32 sites go to K1 fp32, fp16 ones are widened exactly
and rounded back once, mixed dtypes are promoted, and no site that was not
bf16 reaches the bf16 kernel. The `gpu` tests hold the kernel to
`attention_plain` in fp32 on the card. JAX is imported inside the parity
tests only, so the `gpu` tests also run where it is not installed:
python -m pytest --noconftest tests/test_torch_flash_fp32.py -m gpu
"""

import functools

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops import flash_attention as fa
from supir_tpu_torch.ops.flash_attention import (
    FP32_FAULT_DIAGONAL,
    FP32_FAULT_NO_RESCALE,
    FP32_FAULT_RAGGED,
    attention_plain,
    flash_attention,
    flash_fp32_emulate,
)
from torch_parity import one_torch_thread  # noqa: F401

REL_BOUND = 1e-5  # K1 fp32 against an fp32 reference, relative L2

# (b, s, t, h, d, causal): ragged S and T, both head dims, causal and not;
# every case spans several 64-key tiles, so the running max rises
CASES = [
    (1, 200, 150, 2, 64, False),
    (1, 150, 150, 2, 64, True),
    (1, 130, 200, 2, 128, False),
    (1, 130, 130, 2, 128, True),
]


def _qkv(seed, b, s, t, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d)))


def _rel(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(q, k, v, JAX's fp32 flash_attention in interpret mode) of a case."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    b, s, t, h, d, causal = case
    q, k, v = _qkv(sum(case[:5]), b, s, t, h, d)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    assert want.dtype == jnp.float32
    return q, k, v, np.asarray(want)


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_jax_flash_attention_fp32(case):
    q, k, v, want = _jax_case(case)
    got = flash_fp32_emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), case[-1])
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= REL_BOUND
    # the plain version agrees as closely
    plain = attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), causal=case[-1])
    assert _rel(plain.numpy(), want) <= REL_BOUND


# each fault where it can show: no rescale wherever the max rises after the
# first tile, the ragged tile where T is not a whole number of tiles and
# nothing else masks its keys (not causal), the diagonal where causal
FAULTS = [
    (FP32_FAULT_NO_RESCALE, CASES[0]), (FP32_FAULT_NO_RESCALE, CASES[3]),
    (FP32_FAULT_RAGGED, CASES[0]), (FP32_FAULT_RAGGED, CASES[2]),
    (FP32_FAULT_DIAGONAL, CASES[1]), (FP32_FAULT_DIAGONAL, CASES[3]),
]


@pytest.mark.parametrize("fault,case", FAULTS)
def test_emulated_faults_break_the_bound(fault, case):
    q, k, v, want = _jax_case(case)
    got = flash_fp32_emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), case[-1], fault)
    assert _rel(got.numpy(), want) > REL_BOUND


def test_emulation_of_a_row_past_every_key_is_finite():
    """A causal block whose rows lie past S (rows read as zeros) and a
    ragged tile: no NaN arises from a row whose max starts at -inf."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 65, 65, 1, 64))
    got = flash_fp32_emulate(q, k, v, causal=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, attention_plain(q, k, v, causal=True), rtol=1e-5, atol=1e-6)


@pytest.fixture
def stub_card(monkeypatch):
    """Run the kernel wrapper's card branch on CPU tensors: `_on_card` says
    yes, and the two launchers are replaced by recorders that return what
    the kernels compute (the fp32 walk; the plain version rounded to bf16).
    Yields the list of (launcher, dtypes of q, k, v)."""
    calls = []

    def fp32(q, k, v, causal, fault=0):
        calls.append(("fp32", (q.dtype, k.dtype, v.dtype)))
        return flash_fp32_emulate(q, k, v, causal, fault)

    def bf16(q, k, v, causal, with_lse, slopes=None):
        calls.append(("bf16", (q.dtype, k.dtype, v.dtype)))
        return attention_plain(q.float(), k.float(), v.float(), causal).to(q.dtype), None

    monkeypatch.setattr(fa, "_on_card", lambda kernel, q, inputs: True)
    monkeypatch.setattr(fa, "_forward_fp32", fp32)
    monkeypatch.setattr(fa, "_forward", bf16)
    yield calls


def _site(seed, dtypes, s=1024, d=64):
    q, k, v = _qkv(seed, 1, s, s, 1, d)
    return tuple(torch.from_numpy(x).to(dt) for x, dt in zip((q, k, v), dtypes))


def test_fp32_site_runs_on_the_fp32_instance(stub_card):
    q, k, v = _site(1, [torch.float32] * 3)
    before = (flash_attention.launches, flash_attention.fp32_launches)
    out = attn_ops.attention(q, k, v)
    assert stub_card == [("fp32", (torch.float32,) * 3)]
    assert (flash_attention.launches, flash_attention.fp32_launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float32
    assert _rel(out.numpy(), attention_plain(q, k, v).numpy()) <= REL_BOUND


def test_fp16_site_is_widened_and_rounded_once(stub_card):
    q, k, v = _site(2, [torch.float16] * 3)
    out = attn_ops.attention(q, k, v)
    assert stub_card == [("fp32", (torch.float32,) * 3)]
    assert out.dtype == torch.float16
    # the widening is exact, so the result is the fp32 walk on the same
    # values, rounded to fp16 once
    assert torch.equal(out, flash_fp32_emulate(q.float(), k.float(), v.float()).half())


@pytest.mark.parametrize("dtypes", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.float16, torch.bfloat16, torch.bfloat16),
])
def test_mixed_site_is_promoted(stub_card, dtypes):
    q, k, v = _site(3, dtypes)
    out = attn_ops.attention(q, k, v, causal=True)
    assert stub_card == [("fp32", (torch.float32,) * 3)]
    assert out.dtype == torch.float32
    want = attention_plain(q.float(), k.float(), v.float(), causal=True)
    assert _rel(out.numpy(), want.numpy()) <= REL_BOUND


def test_only_bf16_sites_reach_the_bf16_kernel(stub_card):
    for dtypes in ([torch.float32] * 3, [torch.float16] * 3, [torch.bfloat16] * 3,
                   [torch.bfloat16, torch.float16, torch.bfloat16]):
        stub_card.clear()
        q, k, v = _site(4, dtypes)
        attn_ops.attention(q, k, v)
        want = "bf16" if dtypes == [torch.bfloat16] * 3 else "fp32"
        assert [route for route, _ in stub_card] == [want]
        assert all(dt == (torch.bfloat16 if want == "bf16" else torch.float32) for dt in stub_card[0][1])
    stub_card.clear()
    q, k, v = _site(5, [torch.float16] * 3)
    attn_ops.attention(q, k[:, :77], v[:, :77])  # text cross-attention: the plain route, no kernel
    assert stub_card == []


def test_fp32_refusals_name_the_missing_path(stub_card):
    """K3, K4 and the ALiBi variants take bf16 only: no path of the port
    reaches them in fp32; K1 takes no mix of dtypes."""
    q, k, v = _site(6, [torch.float32] * 3)
    with pytest.raises(TypeError, match="no path"):
        flash_attention(q, k, v, alibi_slopes=torch.ones(1))
    with pytest.raises(TypeError, match="no path"):
        fa.flash_attention_fwd_lse(q, k, v)
    with pytest.raises(TypeError, match="all-bf16 or all-fp32"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="all-bf16 or all-fp32"):
        flash_attention(q.half(), k.half(), v.half())
    assert stub_card == []


def test_fp32_alignment_rule_is_the_loads():
    """fp32 operands need 16-byte aligned bases and strides in multiples of
    4 elements (16 bytes), no more: a packed qkv's views and an expanded
    (stride 0) k/v pass; a view one element off fails."""
    qkv = torch.zeros(1, 1024, 3, 2, 64)
    fa._check(*qkv.unbind(2), False, dtypes=fa.K1_DTYPES)
    kv = torch.zeros(1, 1024, 1, 64).expand(1, 1024, 2, 64)
    fa._check(qkv[:, :, 0], kv, kv, False, dtypes=fa.K1_DTYPES)
    flat = torch.zeros(1024 * 2 * 64 + 1)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check(flat[1:].view(1, 1024, 2, 64), kv, kv, False, dtypes=fa.K1_DTYPES)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 fp32 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(cuda, seed, b, s, t, h, d, layout):
    g = torch.Generator(device=cuda).manual_seed(seed)
    if layout == "packed":
        return torch.randn(b, s, 3, h, d, generator=g, device=cuda).unbind(2)
    q = torch.randn(b, s, h, d, generator=g, device=cuda)
    if layout == "mqa":
        return (q, *(torch.randn(b, t, 1, d, generator=g, device=cuda).expand(b, t, h, d) for _ in range(2)))
    return q, torch.randn(b, t, h, d, generator=g, device=cuda), torch.randn(b, t, h, d, generator=g, device=cuda)


def _card_rel(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


# the restore's two shapes, then tile edges: ragged S and T, causal with
# the diagonal in a ragged last block, both head dims, packed and multiquery
CARD_CASES = [
    (2, 4096, 4096, 10, 64, False, "contiguous"),
    (2, 1024, 1024, 20, 64, False, "contiguous"),
    (1, 1000, 1000, 2, 128, True, "contiguous"),
    (1, 1000, 1000, 2, 128, False, "contiguous"),
    (2, 1100, 1500, 3, 64, False, "contiguous"),
    (1, 1100, 1100, 4, 64, True, "packed"),
    (1, 1030, 1030, 8, 128, False, "mqa"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal,layout", CARD_CASES)
def test_fp32_kernel_matches_plain(cuda, b, s, t, h, d, causal, layout):
    """K1 fp32 against attention_plain in fp32 on the same inputs within
    relative L2 1e-5 (a bf16 cast would miss it by 400x), one fp32 launch
    counted a call, two runs bit-identical."""
    q, k, v = _card_inputs(cuda, 7, b, s, t, h, d, layout)
    before = (flash_attention.launches, flash_attention.fp32_launches)
    out = flash_attention(q, k, v, causal)
    again = flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.fp32_launches) == (before[0], before[1] + 2)
    assert out.dtype == torch.float32 and torch.equal(out, again)
    assert _card_rel(out, attention_plain(q, k, v, causal=causal)) <= REL_BOUND


@pytest.mark.gpu
@pytest.mark.parametrize("fault,causal", [(FP32_FAULT_NO_RESCALE, False), (FP32_FAULT_NO_RESCALE, True),
                                          (FP32_FAULT_RAGGED, False), (FP32_FAULT_DIAGONAL, True)])
def test_fp32_kernel_planted_faults(cuda, fault, causal):
    q, k, v = _card_inputs(cuda, 8, 1, 1000, 1000, 2, 128, "contiguous")
    want = attention_plain(q, k, v, causal=causal)
    assert _card_rel(fa._forward_fp32(q, k, v, causal), want) <= REL_BOUND
    assert _card_rel(fa._forward_fp32(q, k, v, causal, fault), want) > REL_BOUND


@pytest.mark.gpu
def test_fp32_kernel_equals_its_walk(cuda):
    """The kernel and flash_fp32_emulate on the same values: the same tiles
    and updates, sums in other orders (the walk's products are BLAS's)."""
    q, k, v = _card_inputs(cuda, 9, 1, 300, 300, 2, 64, "contiguous")
    got = flash_attention(q, k, v, True).cpu()
    want = flash_fp32_emulate(q.cpu(), k.cpu(), v.cpu(), True)
    assert _card_rel(got, want) <= REL_BOUND
    bad = fa._forward_fp32(q, k, v, True, FP32_FAULT_DIAGONAL).cpu()
    assert _card_rel(bad, flash_fp32_emulate(q.cpu(), k.cpu(), v.cpu(), True, FP32_FAULT_DIAGONAL)) <= REL_BOUND


@pytest.mark.gpu
def test_fp16_site_runs_on_the_card(cuda):
    q, k, v = (x.half() for x in _card_inputs(cuda, 10, 1, 1024, 1024, 2, 64, "contiguous"))
    before = (flash_attention.launches, flash_attention.fp32_launches)
    out = attn_ops.attention(q, k, v)
    assert (flash_attention.launches, flash_attention.fp32_launches) == (before[0], before[1] + 1)
    assert out.dtype == torch.float16
    want = attention_plain(q.float(), k.float(), v.float())
    assert _card_rel(out.float(), want.half().float()) <= 1e-3  # one fp16 rounding on each side
    assert torch.equal(out, flash_attention(q.float(), k.float(), v.float()).half())
