"""K1 fp32 (`supir_tpu_torch/csrc/flash_attn_fwd_fp32.cu`), the flash
forward for fp32 q, k and v on the tensor cores (3xTF32), and the
attention sites' routing by dtype.

On the CPU: `tf32_split` (hi with its low 13 bits clear, hi + lo == x
exactly); `flash_fp32_emulate`, which walks the kernel's 64-row
warpgroups and key tiles in the kernel's order with its TF32 pairs, three
products and online softmax, against the JAX package's `flash_attention`
at fp32 in Pallas interpret mode (relative L2 1e-5: both sum fp32 products
in their own orders and 3xTF32 drops lo lo, some 1e-7), with each planted
fault over that bound (the one-product walk, plain TF32, is the proof that
the bound tells 3xTF32 from TF32); the fragment permutation of V^T
(`vt_key`) against the kernel's constants and the wgmma fragments; the
fp32 TMA plans; and the routing with the card stubbed in: fp32 sites go to
K1 fp32, fp16 ones are widened exactly and rounded back once, mixed dtypes
are promoted, and no site that was not bf16 reaches the bf16 kernel.

K3 ALiBi fp32 (the same source, MPT's bias, `alibi_slopes`): the walk with
slopes against JAX's `flash_attention(..., alibi_slopes=, interpret=True)`
in fp32 at 2e-5 absolute (the JAX package's own tolerance for its ALiBi
kernel, tests/test_flash_attention.py:72), causal and not, both head dims,
multiquery; each planted ALiBi fault (the bias in raw q.k units, the slopes
reversed) over the bound, the dropped -(T - 1) offset in the lse alone; and
fp32 and fp16 ALiBi sites reaching the fp32 ALiBi launcher with their
slopes, through `attention` and MPT's prefill.

The `gpu` tests hold the kernels to `attention_plain` in fp32 and to
their walk on the card. JAX is imported inside the parity tests only, so
the `gpu` tests also run where it is not installed:
python -m pytest --noconftest tests/test_torch_flash_fp32.py -m gpu
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from supir_tpu_torch.captioner.mpt import MPTConfig, MPTForCausalLM, alibi_slopes
from supir_tpu_torch.ops import attention as attn_ops
from supir_tpu_torch.ops import flash_attention as fa
from supir_tpu_torch.ops.flash_attention import (
    FP32_FAULT_ALIBI_NO_OFFSET,
    FP32_FAULT_ALIBI_RAW_UNITS,
    FP32_FAULT_DIAGONAL,
    FP32_FAULT_NO_RESCALE,
    FP32_FAULT_NO_V_LO,
    FP32_FAULT_ONE_PRODUCT,
    FP32_FAULT_RAGGED,
    FP32_FAULT_VT_ORDER,
    FP32_TILES,
    VT_KEY,
    attention_plain,
    flash_attention,
    flash_fp32_emulate,
    tf32_operand,
    tf32_split,
    tma_plan,
    vt_key,
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
# nothing else masks its keys (not causal), the diagonal where causal; one
# product (plain TF32), V without its lo part and V^T in key order anywhere
FAULTS = [
    (FP32_FAULT_NO_RESCALE, CASES[0]), (FP32_FAULT_NO_RESCALE, CASES[3]),
    (FP32_FAULT_RAGGED, CASES[0]), (FP32_FAULT_RAGGED, CASES[2]),
    (FP32_FAULT_DIAGONAL, CASES[1]), (FP32_FAULT_DIAGONAL, CASES[3]),
    (FP32_FAULT_ONE_PRODUCT, CASES[0]), (FP32_FAULT_ONE_PRODUCT, CASES[3]),
    (FP32_FAULT_NO_V_LO, CASES[1]), (FP32_FAULT_NO_V_LO, CASES[2]),
    (FP32_FAULT_VT_ORDER, CASES[0]), (FP32_FAULT_VT_ORDER, CASES[3]),
]


@pytest.mark.parametrize("fault,case", FAULTS)
def test_emulated_faults_break_the_bound(fault, case):
    q, k, v, want = _jax_case(case)
    got = flash_fp32_emulate(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), case[-1], fault)
    assert _rel(got.numpy(), want) > REL_BOUND


def test_one_product_walk_is_tf32_grade():
    """S on one product is plain TF32: 10-1000x over the bound (the 10
    mantissa bits' ~1e-4), while the three products stay within it."""
    q, k, v, want = _jax_case(CASES[0])
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), CASES[0][-1])
    assert 10 * REL_BOUND < _rel(flash_fp32_emulate(*args, FP32_FAULT_ONE_PRODUCT).numpy(), want) < 1e-2
    assert _rel(flash_fp32_emulate(*args).numpy(), want) < REL_BOUND / 10


# ------------------------------------------------------------ K3 ALiBi fp32

ALIBI_ATOL = 2e-5  # the ALiBi walk against JAX's ALiBi kernel, absolute (tests/test_flash_attention.py:72)
LSE_MOVE = 1e-3    # K3 fp32's lse bound on the card, absolute: a fault must move the lse past it
# (b, s, t, h, d, causal, layout): both head dims, causal and not (T != S
# too: the bias runs over the keys), multiquery (k and v expanded over the
# heads, stride 0); the walk's tiles cut every case several times
ALIBI_CASES = [
    (1, 200, 150, 4, 64, False, "contiguous"),
    (1, 150, 150, 4, 64, True, "contiguous"),
    (1, 130, 200, 2, 128, False, "contiguous"),
    (1, 130, 130, 2, 128, True, "contiguous"),
    (1, 150, 150, 6, 64, True, "mqa"),
    (1, 100, 160, 4, 128, False, "mqa"),
]


def _alibi_inputs(case):
    """(q, k, v, slopes) as torch tensors, multiquery k and v expanded."""
    b, s, t, h, d, causal, layout = case
    q, k, v = (torch.from_numpy(x) for x in _qkv(sum(case[:5]), b, s, t, h, d))
    if layout == "mqa":
        k, v = (x[:, :, :1].expand(b, t, h, d) for x in (k, v))
    return q, k, v, torch.from_numpy(alibi_slopes(h))


@functools.lru_cache(maxsize=None)
def _jax_alibi_case(case):
    """JAX's fp32 ALiBi flash_attention (interpret mode) on a case's inputs."""
    import jax.numpy as jnp

    from supir_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q, k, v, slopes = _alibi_inputs(case)
    want = jax_flash_attention(*(jnp.asarray(x.contiguous().numpy()) for x in (q, k, v)), causal=case[5],
                               alibi_slopes=slopes.numpy(), interpret=True)
    assert want.dtype == jnp.float32
    return np.asarray(want)


@pytest.mark.parametrize("case", ALIBI_CASES)
def test_alibi_emulation_matches_jax_flash_attention_fp32(case):
    """K3 ALiBi fp32's walk (TF32 pairs, three products, the bias added in
    scaled units before the masks) and the plain version against JAX's
    Pallas ALiBi kernel in fp32."""
    q, k, v, slopes = _alibi_inputs(case)
    want = _jax_alibi_case(case)
    got = flash_fp32_emulate(q, k, v, case[5], alibi_slopes=slopes)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ALIBI_ATOL, rtol=0)
    plain = attention_plain(q, k, v, causal=case[5], alibi_slopes=slopes)
    np.testing.assert_allclose(plain.numpy(), want, atol=ALIBI_ATOL, rtol=0)


@pytest.mark.parametrize("case", [ALIBI_CASES[1], ALIBI_CASES[2], ALIBI_CASES[4]])
def test_alibi_emulated_faults_break_the_bound(case):
    """The bias in raw q.k units (added before the scale) and the heads'
    slopes reversed move O far past the bound; the -(T - 1) offset dropped
    moves only the lse, by slope_h (T - 1) a head, and leaves O within it."""
    q, k, v, slopes = _alibi_inputs(case)
    want = _jax_alibi_case(case)
    causal, t = case[5], case[2]
    raw = flash_fp32_emulate(q, k, v, causal, FP32_FAULT_ALIBI_RAW_UNITS, alibi_slopes=slopes)
    assert _rel(raw.numpy(), want) > REL_BOUND
    flipped = flash_fp32_emulate(q, k, v, causal, alibi_slopes=slopes.flip(0))
    assert _rel(flipped.numpy(), want) > REL_BOUND
    out, lse = flash_fp32_emulate(q, k, v, causal, with_lse=True, alibi_slopes=slopes)
    no_offset, bad_lse = flash_fp32_emulate(q, k, v, causal, FP32_FAULT_ALIBI_NO_OFFSET, with_lse=True,
                                            alibi_slopes=slopes)
    np.testing.assert_allclose(no_offset.numpy(), want, atol=ALIBI_ATOL, rtol=0)
    assert _rel(no_offset.numpy(), out.numpy()) <= REL_BOUND
    shift = (bad_lse - lse).amax(dim=(0, 2))  # per head
    torch.testing.assert_close(shift, slopes * (t - 1), rtol=1e-5, atol=1e-4)
    assert (bad_lse - lse).abs().max().item() > LSE_MOVE


def test_alibi_walk_without_slopes_is_k1_fp32():
    """Slopes of zero add nothing but change the softmax's units: the walk
    agrees with the walk without ALiBi within the bound, and without slopes
    it is K1 fp32's walk bit for bit."""
    q, k, v, _ = _alibi_inputs(ALIBI_CASES[1])
    plain_walk = flash_fp32_emulate(q, k, v, True)
    assert _rel(flash_fp32_emulate(q, k, v, True, alibi_slopes=torch.zeros(4)).numpy(),
                plain_walk.numpy()) <= REL_BOUND
    assert torch.equal(flash_fp32_emulate(q, k, v, True, alibi_slopes=None), plain_walk)


def _split_inputs(kind):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(4096).astype(np.float32)
    scale = {"normal": 1.0, "large": 1e30, "tiny": 1e-30, "subnormal": 1e-39}[kind]
    return torch.from_numpy((x * np.float32(scale)).astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "large", "tiny", "subnormal"])
def test_tf32_split_is_exact(kind):
    """hi keeps 10 mantissa bits (the low 13 clear) and lies within half a
    TF32 ulp of x; lo = x - hi is exact: hi + lo == x bit for bit."""
    x = _split_inputs(kind)
    if kind == "subnormal":
        assert (x.abs() < torch.finfo(torch.float32).tiny).all()
    hi, lo = tf32_split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, x)
    # rounded to nearest: |lo| at most half of hi's last place (2^-11 of |x|, or 2^-137 below the normals)
    half_ulp = torch.maximum(x.abs() * 2.0 ** -11, torch.full_like(x, 2.0 ** -137))
    assert (lo.abs() <= half_ulp).all()
    # what the tensor cores read of lo: its low 13 bits cleared, within 2^-10
    # of it (2^13 of the smallest subnormal, 2^-136, where lo is subnormal)
    read = tf32_operand(lo)
    assert not (read.view(torch.int32) & 0x1FFF).any()
    assert ((lo - read).abs() <= torch.maximum(lo.abs() * 2.0 ** -10, torch.full_like(lo, 2.0 ** -136))).all()


def test_tf32_split_rounds_ties_away_from_zero():
    """The add-and-mask is round to nearest, ties away from zero (PTX's
    cvt.rna.tf32.f32): 1 + 2^-11 is halfway between two TF32 values."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23, 1 + 3 * 2.0 ** -11])
    hi, _ = tf32_split(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1 + 2 * 2.0 ** -10]


CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"


def test_fragment_permutation_matches_the_kernel_source():
    """V^T's key order (`vt_key`) is the kernel's VT_KEY, and it is what
    makes S's accumulator the A operand of P V without an exchange: lane t
    of a quad holds S's columns 2t and 2t + 1 of each 8-column group
    (wgmma's accumulator fragment), the TF32 A fragment takes its k-indices
    t and t + 4, so V^T's slots t and t + 4 must hold keys 2t and 2t + 1.
    The tile constants are the kernel's too. The table lives in the 3xTF32
    header the forward and K4 fp32 share."""
    src = (CSRC / fa._FP32_SOURCE).read_text()
    assert '#include "flash_attn_tf32.cuh"' in src
    table = re.search(r"constexpr int VT_KEY\[8\] = \{([^}]*)\};", (CSRC / "flash_attn_tf32.cuh").read_text())
    assert table and tuple(int(x) for x in table.group(1).split(",")) == VT_KEY
    assert sorted(VT_KEY) == list(range(8))
    for lane in range(32):
        t = lane % 4
        acc_cols = (2 * t, 2 * t + 1)   # C fragment: d[4j], d[4j + 1] of row g
        a_kidx = (t, t + 4)             # A fragment (tf32, k8): a[0] and a[2] of row g
        assert tuple(vt_key(p) for p in a_kidx) == acc_cols
    for name in ("BM", "BN"):
        found = re.search(rf"constexpr int {name} = D == 64 \? (\d+) : (\d+);", src)
        assert found, name
        want = tuple(FP32_TILES[d][name == "BN"] for d in (64, 128))
        assert (int(found.group(1)), int(found.group(2))) == want
    assert '#include "flash_attn_tma.cuh"' in src and "CU_TENSOR_MAP_DATA_TYPE_FLOAT32" in src


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_tma_plans(d):
    """fp32 operands map in 32-column (128-byte) boxes of the kernel's rows:
    contiguous, a packed qkv's views and k/v expanded over heads (the head
    axis dropped)."""
    rows, keys = FP32_TILES[d]
    x = torch.empty(2, 300, 3, d)
    plan = tma_plan(x, rows)
    assert plan.box == (32, rows, 1, 1) and plan.dims == (d, 300, 3, 2)
    assert plan.strides == (3 * d * 4, d * 4, 300 * 3 * d * 4)
    qkv = torch.empty(2, 300, 3, 2, d)
    for i, view in enumerate(qkv.unbind(2)):
        plan = tma_plan(view, keys)
        assert plan.strides == (3 * 2 * d * 4, d * 4, 300 * 3 * 2 * d * 4) and plan.box[:2] == (32, keys)
    kv = torch.empty(1, 300, 1, d).expand(1, 300, 4, d)
    plan = tma_plan(kv, keys)
    assert plan.head == -1 and plan.dims == (d, 300)


def test_ab_tool_exits_without_a_card(monkeypatch):
    """tools/flash_fp32_ab measures the card and has no CPU mode, for K1
    fp32 and with --backward for K4 fp32."""
    from supir_tpu_torch.tools import flash_fp32_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--backward"]):
        with pytest.raises(SystemExit) as exc:
            flash_fp32_ab.main(["--variant", "new=csrc", *extra])
        assert "no CUDA device" in str(exc.value.code)


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
    Yields the list of (launcher, dtypes of q, k, v); the slopes the fp32
    launcher was given land in `stub_slopes`."""
    calls = []
    stub_slopes.clear()

    def fp32(q, k, v, causal, fault=0, slopes=None):
        calls.append(("fp32" if slopes is None else "fp32 alibi", (q.dtype, k.dtype, v.dtype)))
        if slopes is not None:
            stub_slopes.append(slopes)
        return flash_fp32_emulate(q, k, v, causal, fault, alibi_slopes=slopes)

    def bf16(q, k, v, causal, with_lse, slopes=None):
        calls.append(("bf16", (q.dtype, k.dtype, v.dtype)))
        return attention_plain(q.float(), k.float(), v.float(), causal).to(q.dtype), None

    monkeypatch.setattr(fa, "_on_card", lambda kernel, q, inputs: True)
    monkeypatch.setattr(fa, "_forward_fp32", fp32)
    monkeypatch.setattr(fa, "_forward", bf16)
    yield calls


stub_slopes = []


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
    """What the kernels refuse: no mix of dtypes and no fp16, with ALiBi or
    without (the refusal names the dtypes they take; `attention` promotes
    and widens before it calls them). fp32 with ALiBi is no longer refused:
    it launches K3 ALiBi fp32 with the slopes, counted apart."""
    q, k, v = _site(6, [torch.float32] * 3)
    slopes = torch.tensor([0.5])
    for kwargs in ({}, {"alibi_slopes": slopes}):
        with pytest.raises(TypeError, match="all-bf16 or all-fp32"):
            flash_attention(q, k.bfloat16(), v, **kwargs)
        with pytest.raises(TypeError, match="all-bf16 or all-fp32"):
            flash_attention(q.half(), k.half(), v.half(), **kwargs)
    assert stub_card == []
    before = (flash_attention.alibi_fp32_launches, flash_attention.fp32_launches, flash_attention.alibi_launches)
    out = flash_attention(q, k, v, alibi_slopes=slopes)
    assert stub_card == [("fp32 alibi", (torch.float32,) * 3)] and torch.equal(stub_slopes[0], slopes)
    assert (flash_attention.alibi_fp32_launches, flash_attention.fp32_launches,
            flash_attention.alibi_launches) == (before[0] + 1, before[1], before[2])
    assert _rel(out.numpy(), attention_plain(q, k, v, alibi_slopes=slopes).numpy()) <= REL_BOUND


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_fp32_alibi_site_reaches_the_fp32_alibi_launcher(stub_card, dtype):
    """An fp32 ALiBi site, and an fp16 one widened to fp32, reach K3 ALiBi
    fp32 with the slopes through `attention` (causal, MPT's form), counted in
    `alibi_fp32_launches`; the result is the walk with those slopes, rounded
    to the site's dtype once."""
    q, k, v = _site(7, [dtype] * 3)
    slopes = torch.from_numpy(alibi_slopes(1))
    before = (flash_attention.alibi_fp32_launches, flash_attention.fp32_launches, flash_attention.alibi_launches)
    out = attn_ops.attention(q, k, v, causal=True, alibi_slopes=slopes)
    assert stub_card == [("fp32 alibi", (torch.float32,) * 3)] and torch.equal(stub_slopes[0], slopes)
    assert (flash_attention.alibi_fp32_launches, flash_attention.fp32_launches,
            flash_attention.alibi_launches) == (before[0] + 1, before[1], before[2])
    assert out.dtype == dtype
    walk = flash_fp32_emulate(q.float(), k.float(), v.float(), True, alibi_slopes=slopes)
    assert torch.equal(out, walk.to(dtype))


def test_fp32_mpt_prefill_reaches_the_fp32_alibi_launcher(stub_card, monkeypatch):
    """An fp32 MPT's prefill (the fast path at cache index 0) at 1024 tokens:
    every layer's attention reaches K3 ALiBi fp32 with the model's slopes,
    and the logits are those of the plain route."""
    cfg = MPTConfig(d_model=128, n_heads=2, n_layers=2, vocab_size=64, max_seq_len=1024)
    torch.manual_seed(0)
    model = MPTForCausalLM(cfg)
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = model(ids, caches=model.init_cache(1, 1024), cache_index=0)
    assert stub_card == [("fp32 alibi", (torch.float32,) * 3)] * cfg.n_layers
    assert all(torch.equal(x, model.slopes("cpu")) for x in stub_slopes)
    monkeypatch.setattr(fa, "_on_card", lambda kernel, q, inputs: False)  # the plain route
    with torch.no_grad():
        want, _ = model(ids, caches=model.init_cache(1, 1024), cache_index=0)
    assert _rel(logits.numpy(), want.numpy()) <= REL_BOUND


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
                                          (FP32_FAULT_RAGGED, False), (FP32_FAULT_DIAGONAL, True),
                                          (FP32_FAULT_ONE_PRODUCT, False), (FP32_FAULT_NO_V_LO, True),
                                          (FP32_FAULT_VT_ORDER, False), (FP32_FAULT_VT_ORDER, True)])
def test_fp32_kernel_planted_faults(cuda, fault, causal):
    q, k, v = _card_inputs(cuda, 8, 1, 1000, 1000, 2, 128, "contiguous")
    want = attention_plain(q, k, v, causal=causal)
    assert _card_rel(fa._forward_fp32(q, k, v, causal), want) <= REL_BOUND
    assert _card_rel(fa._forward_fp32(q, k, v, causal, fault), want) > REL_BOUND


# the kernel against its walk on the same values: the TF32 operands are the
# same bits, the sums run in other orders (the tensor cores' against
# BLAS's). The card read 3.4e-7 to 4.8e-7 here and up to 6.9e-7 at T = 1000
# (NVIDIA H100 80GB HBM3, PERF.md); the TF32-decided faults sit 2e-4 from
# the plain version
WALK_BOUND = 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [0, FP32_FAULT_ONE_PRODUCT, FP32_FAULT_NO_V_LO, FP32_FAULT_DIAGONAL])
def test_fp32_kernel_equals_its_walk(cuda, fault):
    """The kernel and flash_fp32_emulate on the same values: the same
    warpgroups, tiles, TF32 roundings and products. Where the TF32 rounding
    decides the result (one product, V without its lo part: ~3e-4 and ~2e-4
    from the plain version) the walk stays within a tenth of the kernel's
    distance to the plain version: the walk's rounding is what the card's
    tensor cores read. The sound kernel's own distance to the plain version
    is fp32 summation noise, of the order of the walk's."""
    q, k, v = _card_inputs(cuda, 9, 1, 300, 300, 2, 64, "contiguous")
    got = fa._forward_fp32(q, k, v, True, fault).cpu()
    walk = flash_fp32_emulate(q.cpu(), k.cpu(), v.cpu(), True, fault)
    assert _card_rel(got, walk) <= WALK_BOUND
    if fault in (FP32_FAULT_ONE_PRODUCT, FP32_FAULT_NO_V_LO):
        assert _card_rel(got, walk) <= _card_rel(got, attention_plain(q, k, v, causal=True).cpu()) / 10


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


# K3 ALiBi fp32 without the lse (the generate path's prefill): MPT-7B's
# prompt shape, then tile edges, both head dims, multiquery, packed
ALIBI_CARD_CASES = [
    (1, 1536, 1536, 32, 128, True, "contiguous"),
    (2, 1100, 1500, 3, 64, False, "contiguous"),
    (1, 1030, 1030, 8, 128, True, "mqa"),
    (1, 1100, 1100, 4, 64, True, "packed"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,d,causal,layout", ALIBI_CARD_CASES)
def test_alibi_fp32_kernel_matches_plain(cuda, b, s, t, h, d, causal, layout):
    """K3 ALiBi fp32 without the lse against attention_plain in fp32 with
    the slopes within 1e-5, counted in `alibi_fp32_launches`, two runs
    bit-identical and equal to the instance with the lse (one kernel, the
    lse a runtime pointer)."""
    q, k, v = _card_inputs(cuda, 11, b, s, t, h, d, layout)
    slopes = torch.from_numpy(alibi_slopes(h)).to(cuda)
    before = (flash_attention.alibi_fp32_launches, flash_attention.fp32_launches)
    out = flash_attention(q, k, v, causal, slopes)
    again = flash_attention(q, k, v, causal, slopes)
    torch.cuda.synchronize()
    assert (flash_attention.alibi_fp32_launches, flash_attention.fp32_launches) == (before[0] + 2, before[1])
    assert torch.equal(out, again) and torch.equal(out, fa.flash_attention_fwd_lse(q, k, v, causal, slopes)[0])
    assert _card_rel(out, attention_plain(q, k, v, causal=causal, alibi_slopes=slopes)) <= REL_BOUND


@pytest.mark.gpu
def test_alibi_fp32_kernel_equals_its_walk(cuda):
    """K3 ALiBi fp32 and flash_fp32_emulate with the slopes on the same
    values: the same tiles, TF32 roundings and fp32-rounded bias."""
    q, k, v = _card_inputs(cuda, 12, 1, 300, 300, 4, 64, "contiguous")
    slopes = torch.from_numpy(alibi_slopes(4))
    got = fa._forward_fp32(q, k, v, True, slopes=slopes.to(cuda)).cpu()
    walk = flash_fp32_emulate(q.cpu(), k.cpu(), v.cpu(), True, alibi_slopes=slopes)
    assert _card_rel(got, walk) <= WALK_BOUND
