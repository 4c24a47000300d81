"""The decode-GEMV probes' kernels (supir_tpu_torch/ops/probes.py, T1-T4) and
the geometry keywords of ops/quantize.py against the JAX probes in tools/
on the CPU, the probes' entry points, the LLaVA loader's conversion of
reference keys, and the kernels against their plain versions on the card.

The JAX probes are loaded from their files (tools/ is no package). Their
Pallas kernels run in interpret mode: through a pallas_call built here with
the tool's own BlockSpecs and interpret=True, or through the tool's own
function with its module's `pl` replaced by a copy whose pallas_call
interprets. The closures `sum2d_kernel` (inside stream_ceiling.main) and `k`
(inside int4_native_probe.stage2_mosaic) are reached by running those
functions with a pallas_call that records the kernel it is handed.

Tolerances:
- column sum (the ring's tile walk and slice-order combine as
  ops/probes.py:column_sum_emulate walks them), nibble unpack (and the walk
  of the body's decodes, ops/probes.py:unpack_emulate), native cast: bit for
  bit (integers, and small integers times 2 in bf16);
- W4A8 before the activation scale (T2): its plain version 1e-6 relative
  against the JAX probe; the tensor-core body's walk (tc_emulate on the
  W4A8 plan, every row scale 127) bit for bit (exact integer sums, one
  rounded scale multiply on each side);
- single-cast GEMV, native GEMV, K7 at a forced width: relative L2 1e-5 (the
  same exact products summed in another order);
- T1c, T3b and T4b on the tensor-core body at a k-slices override, walked
  by ops/gemv_plan.py:tc_emulate in IEEE fp32: relative L2 1e-5 too. The
  emulation cannot show the tensor cores' own accumulation error: the card
  check does.
On the card the kernels are held to their plain versions: the bit-exact
ones (T2 among them) bit for bit, the GEMVs by relative L2 1e-2 (K10's
strip body 1e-6), with planted faults that must break the bound.
JAX is imported inside the parity tests only, so the `gpu` tests also run on
a machine without it:
python -m pytest --noconftest tests/test_torch_probes.py -m gpu -q
"""

import functools
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import gemv_plan as GP
from supir_tpu_torch.ops import probes as P
from supir_tpu_torch.ops import quantize as Q
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PROBES = ("stream_ceiling", "gemv_sweep", "bitcast_probe", "int4_native_probe")
REL_1E5 = 1e-5
W4A8_REL = 1e-6
CARD_REL_BOUND = 1e-2


def _tool(name):
    """The JAX probe tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpreting_pl(record=None):
    """A stand-in for a tool's `pl`: the real module's names, with a
    pallas_call that runs in interpret mode (and hands each kernel to
    `record` first)."""
    from jax.experimental import pallas as pl

    def pallas_call(kernel, **kw):
        if record is not None:
            record.append(kernel)
        return pl.pallas_call(kernel, interpret=True, **kw)

    names = {n: getattr(pl, n) for n in dir(pl) if not n.startswith("_")}
    return types.SimpleNamespace(**dict(names, pallas_call=pallas_call))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _bytes(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# ------------------------------------------------------------ T1: column sum


@pytest.fixture(scope="module")
def sum2d_kernel():
    """stream_ceiling.main's sum2d_kernel closure, recorded by running main
    at a small CIN/COUT/L with a pallas_call that records and refuses (main
    catches that and goes on, as it does for a grid that does not fit)."""
    mod = _tool("stream_ceiling")
    recorded = []

    def refuse(kernel, **kw):
        recorded.append(kernel)
        raise RuntimeError("recorded")

    real = _interpreting_pl()
    mod.pl = types.SimpleNamespace(**vars(real))
    mod.pl.pallas_call = refuse
    mod.CIN, mod.COUT, mod.L = 256, 512, 1
    mod.main()
    mod.pl = real
    kernels = [k for k in recorded if getattr(k, "__name__", None) == "sum2d_kernel"]
    assert len(kernels) == 4  # one closure per (brow, bout) pair of main
    return mod, kernels[0]


def _sum2d_call(kernel, q, brow, bout):
    """sum2d_kernel in interpret mode under stream_ceiling's BlockSpecs."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    rows, cout = q.shape
    return np.asarray(pl.pallas_call(
        kernel,
        grid=(cout // bout, rows // brow),
        in_specs=[pl.BlockSpec((brow, bout), lambda oo, ii: (ii, oo))],
        out_specs=pl.BlockSpec((1, bout), lambda oo, ii: (0, oo)),
        out_shape=jax.ShapeDtypeStruct((1, cout), jnp.float32),
        interpret=True,
    )(jnp.asarray(q)))


@pytest.mark.parametrize("brow,bout", [(16, 128), (32, 64)])
def test_column_sum_matches_sum2d_kernel(sum2d_kernel, brow, bout):
    _, kernel = sum2d_kernel
    q = _bytes(0, 64, 256)
    want = _sum2d_call(kernel, q, brow, bout)
    qt = torch.from_numpy(q)
    np.testing.assert_array_equal(P.column_sum_2d(qt).numpy(), np.asarray(want))
    np.testing.assert_array_equal(P.column_sum_2d(qt, 1).numpy(), np.asarray(want))
    np.testing.assert_array_equal(P.column_sum(qt).numpy(), np.asarray(want))


def _sum_kernel_call(q, bout):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    mod = _tool("stream_ceiling")
    rows, cout = q.shape
    return np.asarray(pl.pallas_call(
        mod.sum_kernel,
        grid=(cout // bout,),
        in_specs=[pl.BlockSpec((rows, bout), lambda oo: (0, oo))],
        out_specs=pl.BlockSpec((1, bout), lambda oo: (0, oo)),
        out_shape=jax.ShapeDtypeStruct((1, cout), jnp.float32),
        interpret=True,
    )(jnp.asarray(q)))


def test_column_sum_matches_sum_kernel_at_one_block():
    q = _bytes(1, 64, 256)
    want = _sum_kernel_call(q, 256)
    np.testing.assert_array_equal(P.column_sum_2d(torch.from_numpy(q)).numpy(), want)
    np.testing.assert_array_equal(P.column_sum(torch.from_numpy(q)).numpy(), want)


def test_sum_kernel_defect_leaves_later_blocks_uninitialised():
    """The reference probe's defect, not the port's: sum_kernel zeroes its
    output only at grid step 0, so each later output block accumulates onto
    memory it never initialised (NaN in interpret mode). The first block is
    the column sum; the others are not."""
    q = _bytes(2, 64, 256)
    got = _sum_kernel_call(q, 128)
    want = P.column_sum(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got[:, :128], want[:, :128])
    assert np.isnan(got[:, 128:]).all()


@pytest.mark.parametrize("slices", [1, 2, 3])
def test_ring_emulation_matches_sum2d_kernel(sum2d_kernel, slices):
    """T1a/T1b's kernel, the column sum on the tensor-core body's ring,
    walked by column_sum_emulate (4 chunks over 2 strips on 3 blocks; at 3
    k-slices the chunks split 1, 1, 2), against sum2d_kernel at its row
    blocks of one chunk, bit for bit; the CPU routes too."""
    _, kernel = sum2d_kernel
    q = _bytes(9, 256, 256)
    want = _sum2d_call(kernel, q, 64, 128)
    plan = P.ring_plan(256, 256, 3, slices)
    assert (plan.slices, plan.strips, plan.chunks, plan.grid) == (slices, 2, 4, min(3, 2 * slices))
    qt = torch.from_numpy(q)
    np.testing.assert_array_equal(P.column_sum_emulate(plan, qt).numpy(), want)
    np.testing.assert_array_equal(P.column_sum_2d(qt, slices).numpy(), want)
    np.testing.assert_array_equal(P.column_sum(qt).numpy(), want)


@pytest.mark.parametrize("fault,slices", [(P.RING_FAULT_SIGNED, 1), (P.RING_FAULT_SIGNED, 3),
                                          (P.RING_FAULT_DROP_SLICE, 2), (P.RING_FAULT_DROP_SLICE, 3),
                                          (P.RING_FAULT_COMBINE_TWICE, 2), (P.RING_FAULT_COMBINE_TWICE, 3)])
def test_ring_emulated_faults_break_the_sum(fault, slices):
    """Each of csrc/colsum_tc.cu's planted faults, emulated, changes the
    column sums."""
    q = torch.from_numpy(_bytes(10, 256, 256))
    plan = P.ring_plan(256, 256, 3, slices)
    assert torch.equal(P.column_sum_emulate(plan, q), P.column_sum_plain(q))
    assert not torch.equal(P.column_sum_emulate(plan, q, fault), P.column_sum_plain(q))


def test_ring_lane_words_read_each_byte_once_without_bank_conflicts():
    """The consumers' reads of a 64 x 128-byte stage (TMA's 128-byte
    swizzle): every byte read exactly once, the byte lane l takes as its
    b-th is column 4l + b of its row, each warp load's 32 words in 32
    distinct banks; and the 16-bit sums flushed before they could carry."""
    box, strip, per_warp = 64, GP.TC_STRIP, 64 // P.RING_CONSUMERS
    seen = torch.zeros(box * strip, dtype=torch.int64)
    where = {GP.swizzle(r, c): (r, c) for r in range(box) for c in range(strip)}
    for warp in range(P.RING_CONSUMERS):
        for i in range(per_warp):
            words = [P.ring_word(warp, lane) + 1024 * i for lane in range(32)]
            assert len({(w // 4) % 32 for w in words}) == 32
            for lane, w in enumerate(words):
                assert w % 4 == 0
                for b in range(4):
                    assert where[w + b] == (warp + 8 * i, 4 * lane + b)
                    seen[w + b] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    assert P.RING_FLUSH_CHUNKS * per_warp * 255 < 2 ** 16


@pytest.mark.parametrize("rows,cout,slices", [(100, 256, 1), (128, 200, 1), (65856, 128, 1), (128, 256, 3),
                                              (128, 256, 0)])
def test_ring_refuses_what_it_cannot_take(rows, cout, slices):
    """The ring column sum refuses, on the CPU as on the card: rows not a
    multiple of 64, cout not a multiple of 128, rows * 255 >= 2^24, more
    k-slices than chunks, no k-slice."""
    q = torch.zeros(rows, cout, dtype=torch.uint8)
    with pytest.raises(ValueError):
        P.column_sum_2d(q, slices)
    if slices == 1:
        with pytest.raises(ValueError):
            P.column_sum(q)


def test_ring_refuses_unaligned_bytes_and_the_scratch_overflow():
    """A tensor whose data does not start 16-byte aligned (the TMA box's
    source), and a slice count whose int32 partials overflow the device's
    partial-sum scratch, are refused."""
    buf = torch.zeros(64 * 128 + 16, dtype=torch.uint8)
    start = next(k for k in range(1, 16) if (buf.data_ptr() + k) % 16)
    q = buf[start:start + 64 * 128].view(64, 128)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError):
        P.column_sum(q)
    with pytest.raises(ValueError):
        P.column_sum_2d(q)
    strips = GP.TC_MAX_STRIPS
    most = GP.TC_PART_BYTES // (strips * GP.TC_STRIP * 4)     # the slices whose partials fit
    assert P.ring_plan(64 * (most + 1), strips * GP.TC_STRIP, 132, most).slices == most
    with pytest.raises(ValueError):
        P.ring_plan(64 * (most + 1), strips * GP.TC_STRIP, 132, most + 1)


# ------------------------------------------------------- T3: order, GEMV


def test_unpack_matches_order_kernel_on_every_byte():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    mod = _tool("bitcast_probe")
    q = np.arange(256, dtype=np.int32).astype(np.uint8).reshape(2, 128)
    want = pl.pallas_call(mod.order_kernel, out_shape=jax.ShapeDtypeStruct((4, 128), jnp.float32),
                          interpret=True)(jnp.asarray(q))
    got = P.unpack_nibbles(torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and it is quantize_int4_paired's order: row 2i low nibble, 2i+1 high
    w = torch.arange(16 * 128).reshape(16, 128).remainder(15).sub(7).float()
    w[0] = 7.0
    packed, scale = Q.quantize_int4_paired(w)
    assert torch.equal(scale, torch.ones_like(scale))
    assert torch.equal(P.unpack_nibbles(packed), w)


@functools.lru_cache(maxsize=1)
def _order_kernel_every_byte():
    """order_kernel in interpret mode on all 256 byte values, u8 [2, 128]:
    (the bytes, its fp32 [4, 128] output), numpy."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    mod = _tool("bitcast_probe")
    q = np.arange(256, dtype=np.int32).astype(np.uint8).reshape(2, 128)
    want = pl.pallas_call(mod.order_kernel, out_shape=jax.ShapeDtypeStruct((4, 128), jnp.float32),
                          interpret=True)(jnp.asarray(q))
    return q, np.asarray(want)


@pytest.mark.parametrize("decode", P.DECODES)
def test_body_decode_walk_matches_order_kernel(decode):
    """T3a's kernel, the walk of csrc/tc_decode.cuh's bit operations
    (nib2 for "paired", quad16 for "w4a8", ops/probes.py:unpack_emulate), on
    all 256 bytes against order_kernel, bit for bit; and on odd row counts
    (the W4A8 walk's zero row) and quantize_int4_paired's packing."""
    q, want = _order_kernel_every_byte()
    np.testing.assert_array_equal(P.unpack_emulate(torch.from_numpy(q), decode).numpy(), want)
    odd = torch.from_numpy(_bytes(13, 5, 12))
    assert torch.equal(P.unpack_emulate(odd, decode), P.unpack_nibbles_plain(odd))
    w = torch.arange(16 * 128).reshape(16, 128).remainder(15).sub(7).float()
    w[0] = 7.0
    packed, _ = Q.quantize_int4_paired(w)
    assert torch.equal(P.unpack_emulate(packed, decode), w)


@pytest.mark.parametrize("decode,fault", [("paired", P.ORDER_FAULT_SWAP), ("paired", P.ORDER_FAULT_UNSIGNED),
                                          ("w4a8", P.ORDER_FAULT_SWAP), ("w4a8", P.ORDER_FAULT_UNSIGNED),
                                          ("w4a8", P.ORDER_FAULT_K_ORDER)])
def test_body_decode_walk_faults_break_it(decode, fault):
    """Each of csrc/nibble_order.cu's planted faults, walked, breaks the
    equality with order_kernel: the nibbles swapped (the selector
    mirrored), the sign not restored, W4A8's k order left permuted."""
    q, want = _order_kernel_every_byte()
    assert not np.array_equal(P.unpack_emulate(torch.from_numpy(q), decode, fault).numpy(), want)


@pytest.mark.parametrize("mode", ["paired", "w4a8"])
def test_body_decode_walk_is_the_emulators_decode(mode):
    """The registers chunk_products builds from a lane's words by nib2
    (paired) or quad16 (W4A8) hold, byte for byte or half for half, what
    tc_emulate decodes at gemv_plan.a_register's (word, byte, nibble):
    every byte value in every position, and random words."""
    rng = np.random.default_rng(14)
    v = torch.arange(256, dtype=torch.int64)
    words = torch.from_numpy(rng.integers(0, 2 ** 32, (4, 512)).astype(np.int64))
    words[:, :256] = torch.stack([v * 0x01010101, (255 - v) * 0x01010101, v << 8 * (v % 4), v * 0x00010001])
    stage = torch.stack([(words[i] >> 8 * b) & 0xFF for i in range(4) for b in range(4)]).to(torch.uint8)  # [16, N]
    for frag in range(2):
        for reg in range(4):
            parts = GP.a_register(mode, [0, 4, 8, 12], frag, reg)        # (word index, byte, nibble)
            want = [GP._decode(mode, stage, torch.tensor(4 * wi + b), torch.full((stage.shape[1],), n))
                    for wi, b, n in parts]
            if mode == "paired":        # a[f][reg] = nib2(w[reg >> 1], ., 2 f + (reg & 1))
                w = words[reg >> 1]
                got = GP.bf16x2_floats(GP.nib2(w, w >> 4, 2 * frag + (reg & 1)))
            else:                       # a[f][0], a[f][1] = quad16(w0, w1, f); a[f][2], a[f][3] from w2, w3
                r = GP.quad16(words[2 * (reg >> 1)], words[2 * (reg >> 1) + 1], frag)[reg & 1]
                got = [((r >> 8 * i) & 0xFF).to(torch.uint8).view(torch.int8).to(torch.int64) for i in range(4)]
            for g_, w_ in zip(got, want):
                assert torch.equal(g_.to(w_.dtype), w_), (frag, reg)


def test_body_decodes_defined_in_one_csrc_file():
    """nib2_sel, nib2 and quad16 are defined once, in csrc/tc_decode.cuh,
    which the tensor-core body and the nibble-order check both include:
    the check reads the bytes back through the conversion the body
    compiles."""
    csrc = ROOT / "supir_tpu_torch" / "csrc"
    for name in ("nib2_sel", "nib2", "quad16"):
        pattern = re.compile(rf"__device__\s+__forceinline__\s+\w+\s+{name}\s*\(")
        assert [f.name for f in sorted(csrc.glob("*.cu*")) if pattern.search(f.read_text())] == ["tc_decode.cuh"]
    for source in ("quant_gemv_tc.cu", "nibble_order.cu"):
        assert '#include "tc_decode.cuh"' in (csrc / source).read_text()


@functools.lru_cache(maxsize=4)
def _bitcast_case(rows):
    """gemv_kernel_bitcast in interpret mode on a seeded case: (x as fp32,
    packed, scale, the kernel's output), numpy."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    mod = _tool("bitcast_probe")
    cin, cout, bout = 512, 512, 256
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((rows, cin)).astype(np.float32)).astype(jnp.bfloat16)
    packed = _bytes(4, cin // 2, cout)
    scale = (rng.random((1, cout)) * 0.1 + 0.01).astype(np.float32)
    want = pl.pallas_call(
        mod.gemv_kernel_bitcast,
        grid=(cout // bout,),
        in_specs=[pl.BlockSpec((rows, cin), lambda oo: (0, 0)),
                  pl.BlockSpec((cin // 2, bout), lambda oo: (0, oo)),
                  pl.BlockSpec((1, bout), lambda oo: (0, oo))],
        out_specs=pl.BlockSpec((rows, bout), lambda oo: (0, oo)),
        out_shape=jax.ShapeDtypeStruct((rows, cout), jnp.float32),
        interpret=True,
    )(x, jnp.asarray(packed), jnp.asarray(scale))
    return np.array(x.astype(jnp.float32)), packed, scale, np.asarray(want)


@pytest.mark.parametrize("rows", [1, 8])
def test_single_cast_matches_gemv_kernel_bitcast(rows):
    """The CPU route of T3b, at every slice count of the probes' sweep,
    against gemv_kernel_bitcast."""
    x, packed, scale, want = _bitcast_case(rows)
    xt = torch.from_numpy(x)
    for slices in (None, 1, 2, 4, 8):
        got = P.int4_single_cast_matmul(xt, torch.from_numpy(packed), torch.from_numpy(scale), slices)
        assert _rel(got.numpy(), want) <= REL_1E5


@pytest.mark.parametrize("slices", [1, 2, 3])
@pytest.mark.parametrize("rows", [1, 8])
def test_body_emulation_matches_gemv_kernel_bitcast(rows, slices):
    """T3b's kernel, the tensor-core body on the paired layout at a slices
    override (3: uneven slices of the 4 chunks), walked by tc_emulate,
    against gemv_kernel_bitcast."""
    x, packed, scale, want = _bitcast_case(rows)
    plan = GP.tc_plan("paired", rows, x.shape[1], packed.shape[1], 3, slices)
    assert plan.slices == slices
    got = GP.tc_emulate(plan, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(packed),
                        torch.from_numpy(scale))
    assert _rel(got.numpy(), want) <= REL_1E5


# --------------------------------------------------------------- T2: W4A8


@functools.lru_cache(maxsize=4)
def _w4a8_case(rows, direct=False):
    """gemv_sweep.w4a8_matmul in interpret mode on a seeded case (512 x 512:
    _paired_bout needs cout >= 512): (xq, packed, scale, its output), numpy."""
    import jax.numpy as jnp

    mod = _tool("gemv_sweep")
    mod.pl = _interpreting_pl()
    cin, cout = 512, 512
    rng = np.random.default_rng(5 + rows)
    xq = rng.integers(-127, 128, (rows, cin)).astype(np.int8)
    packed = _bytes(6, cin // 2, cout)
    scale = (rng.random((1, cout)) * 0.1 + 0.01).astype(np.float32)
    want = np.asarray(mod.w4a8_matmul(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(scale), direct=direct))
    return xq, packed, scale, want


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("rows", [1, 8])
def test_w4a8_preact_matches_jax(direct, rows):
    """T2's plain version against w4a8_matmul; on the CPU T2 at every slice
    count of the sweep and its first design at every strip x split-K equal
    the plain version."""
    xq, packed, scale, want = _w4a8_case(rows, direct)
    args = (torch.from_numpy(xq), torch.from_numpy(packed), torch.from_numpy(scale))
    base = P.w4a8_preact_plain(*args)
    assert _rel(base.numpy(), want) <= W4A8_REL
    for slices in (None, *range(1, 9)):
        assert torch.equal(P.w4a8_preact(*args, slices), base)
    for strip in Q.GEMV_STRIPS:
        for split in Q.W4A8_SPLITS:
            assert torch.equal(P.w4a8_preact_strip(*args, strip=strip, split_k=split), base)


def _row_scales_127(rows):
    return torch.full((rows, 1), 127.0)


@pytest.mark.parametrize("slices", [1, 2, 3])
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_t2_body_emulation_matches_w4a8_matmul(rows, slices):
    """T2's kernel, the tensor-core body's W4A8 instances with every row
    scale 127 at a slices override (3: uneven slices of the 4 chunks),
    walked by tc_emulate in integers, against w4a8_matmul bit for bit: the
    sums are exact integers and the row factor 127 * (1 / 127) is 1.0f."""
    xq, packed, scale, want = _w4a8_case(rows)
    plan = GP.tc_plan("w4a8", rows, 512, 512, 3, slices)
    assert (plan.slices, plan.chunks, plan.strips) == (slices, 4, 4)
    got = GP.tc_emulate(plan, torch.from_numpy(xq), torch.from_numpy(packed), torch.from_numpy(scale),
                        xs=_row_scales_127(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fault,slices,breaks", [(GP.FAULT_DROP_SHARE, None, True), (GP.FAULT_X_ORDER, None, True),
                                                 (GP.FAULT_COMBINE_TWICE, 2, True), ("scale", None, True),
                                                 (GP.FAULT_ROW_SCALE, None, False)])
def test_t2_body_emulated_faults(fault, slices, breaks):
    """The faults T2 is held to, emulated, each break bit equality with
    w4a8_matmul: one block's share dropped, x staged out of the A
    registers' k order, the combine run twice (2 slices), the scale left
    out. FAULT_ROW_SCALE squares the row factor, 1.0 here, so T2 cannot
    see it: it stays equal."""
    xq, packed, scale, want = _w4a8_case(8)
    plan = GP.tc_plan("w4a8", 8, 512, 512, 3, slices)
    sc = torch.ones(1, 512) if fault == "scale" else torch.from_numpy(scale)
    got = GP.tc_emulate(plan, torch.from_numpy(xq), torch.from_numpy(packed), sc, xs=_row_scales_127(8),
                        fault=0 if fault == "scale" else fault)
    assert np.array_equal(got.numpy(), want) != breaks


# --------------------------------------------------------------- T4: native


def test_native_cast_matches_stage2_kernel():
    """stage2_mosaic's closure k, recorded with the int4 block it was given,
    against the port's native cast of the same integers, bit for bit, and
    on every int4 value."""
    import jax
    import jax.numpy as jnp

    mod = _tool("int4_native_probe")
    recorded, calls = [], []
    pl_interp = _interpreting_pl(recorded)

    def pallas_call(kernel, **kw):
        run = pl_interp.pallas_call(kernel, **kw)

        def call(*args):
            out = run(*args)
            calls.append((args, out))
            return out

        return call

    mod.pl = types.SimpleNamespace(**vars(pl_interp))
    mod.pl.pallas_call = pallas_call
    mod.stage2_mosaic()
    assert [k.__name__ for k in recorded] == ["k"]
    (a,), want = calls[0]
    ints = torch.from_numpy(np.array(a.astype(jnp.int8)))
    got = P.native_cast(Q.pack_int4_native(ints))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the probe's block holds 0..6 only; the same k on every int4 value
    every = (np.arange(128 * 128).reshape(128, 128) % 16 - 8).astype(np.int8)
    want = pl_interp.pallas_call(recorded[0], out_shape=jax.ShapeDtypeStruct((128, 128), jnp.bfloat16))(
        jnp.asarray(every).astype(jnp.int4))
    got = P.native_cast(Q.pack_int4_native(torch.from_numpy(every)))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_native_cast_emulation_matches_stage2_kernel():
    """T4a's walk of its kernel (nib2 of csrc/tc_decode.cuh on the packed
    words, doubled in bf16) against stage2_mosaic's closure k in interpret
    mode, bit for bit, on the probe's block and on every int4 value, and on
    a byte count that leaves a partial last word; each planted fault differs
    from it."""
    import jax
    import jax.numpy as jnp

    mod = _tool("int4_native_probe")
    recorded = []
    pl_interp = _interpreting_pl(recorded)
    mod.pl = pl_interp
    mod.stage2_mosaic()
    kernel, = recorded
    arange = np.arange(128 * 128).reshape(128, 128)
    for ints in (arange % 7, arange % 16 - 8):
        ints = ints.astype(np.int8)
        want = pl_interp.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.bfloat16))(
            jnp.asarray(ints).astype(jnp.int4))
        packed = Q.pack_int4_native(torch.from_numpy(ints))
        got = P.native_cast_emulate(packed)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        for fault in (P.ORDER_FAULT_SWAP, P.ORDER_FAULT_UNSIGNED):
            bad = P.native_cast_emulate(packed, fault).float().numpy()
            assert not np.array_equal(bad, np.asarray(want.astype(jnp.float32))), fault
    odd = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 7)).astype(np.uint8))
    assert torch.equal(P.native_cast_emulate(odd).view(torch.int16), P.native_cast_plain(odd).view(torch.int16))


@pytest.mark.parametrize("rows", [1, 8])
def test_native_gemv_matches_native_int4_matmul(rows):
    import jax.numpy as jnp

    mod = _tool("int4_native_probe")
    mod.pl = _interpreting_pl()
    cin, cout = 384, 512
    rng = np.random.default_rng(7 + rows)
    x = jnp.asarray(rng.standard_normal((rows, cin)).astype(np.float32)).astype(jnp.bfloat16)
    q = rng.integers(-8, 8, (cin, cout)).astype(np.int8)
    scale = (rng.random((1, cout)) * 0.1 + 0.01).astype(np.float32)
    want = np.asarray(mod.native_int4_matmul(x, jnp.asarray(q).astype(jnp.int4), jnp.asarray(scale), bout=256))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    packed = Q.pack_int4_native(torch.from_numpy(q))
    for strip in (Q.STRIP, 256):
        got = Q.int4_native_matmul(xt, packed, torch.from_numpy(scale), strip=strip)
        assert _rel(got.numpy(), want) <= REL_1E5


@functools.lru_cache(maxsize=4)
def _native_case(rows):
    """native_int4_matmul (bout 256) in interpret mode on a seeded case: (x
    as fp32, s4 values int8 [cin, cout], scale, its output), numpy."""
    import jax.numpy as jnp

    mod = _tool("int4_native_probe")
    mod.pl = _interpreting_pl()
    cin, cout = 384, 512
    rng = np.random.default_rng(7 + rows)
    x = jnp.asarray(rng.standard_normal((rows, cin)).astype(np.float32)).astype(jnp.bfloat16)
    q = rng.integers(-8, 8, (cin, cout)).astype(np.int8)
    scale = (rng.random((1, cout)) * 0.1 + 0.01).astype(np.float32)
    want = np.asarray(mod.native_int4_matmul(x, jnp.asarray(q).astype(jnp.int4), jnp.asarray(scale), bout=256))
    return np.array(x.astype(jnp.float32)), q, scale, want


@pytest.mark.parametrize("slices", [1, 2, 3])
@pytest.mark.parametrize("rows", [1, 8])
def test_body_emulation_matches_native_int4_matmul(rows, slices):
    """T4b's kernel, the tensor-core body on the native layout (3 chunks:
    one a slice at 3), walked by tc_emulate, against native_int4_matmul; on
    the CPU native_single_cast_matmul is its plain version."""
    x, q, scale, want = _native_case(rows)
    packed = Q.pack_int4_native(torch.from_numpy(q))
    plan = GP.tc_plan("native", rows, x.shape[1], q.shape[1], 3, slices)
    assert plan.slices == slices
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert _rel(GP.tc_emulate(plan, xt, packed, torch.from_numpy(scale)).numpy(), want) <= REL_1E5
    assert _rel(P.native_single_cast_matmul(xt, packed, torch.from_numpy(scale)).numpy(), want) <= REL_1E5


# ----------------------------------------------------- T1c: K7, forced bout


@functools.lru_cache(maxsize=4)
def _forced_bout_case(cin, cout, bout):
    """quantize._qmm_kernel (bits 4) under stream_ceiling's BlockSpecs (8
    rows, full contraction, forced bout) in interpret mode on a seeded
    case: (x as fp32, half-split q, scale, its output), numpy."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from supir_tpu.ops import quantize as qz

    rng = np.random.default_rng(bout)
    x = jnp.asarray(rng.standard_normal((8, cin)).astype(np.float32)).astype(jnp.bfloat16)
    q = _bytes(8, cin // 2, cout)
    scale = (rng.random((1, cout)) * 0.1 + 0.01).astype(np.float32)
    want = pl.pallas_call(
        functools.partial(qz._qmm_kernel, bits=4),
        grid=(cout // bout,),
        in_specs=[pl.BlockSpec((8, cin), lambda oo: (0, 0)),
                  pl.BlockSpec((cin // 2, bout), lambda oo: (0, oo)),
                  pl.BlockSpec((1, bout), lambda oo: (0, oo))],
        out_specs=pl.BlockSpec((8, bout), lambda oo: (0, oo)),
        out_shape=jax.ShapeDtypeStruct((8, cout), jnp.float32),
        interpret=True,
    )(x, jnp.asarray(q), jnp.asarray(scale))
    return np.array(x.astype(jnp.float32)), q, scale, np.asarray(want)


@pytest.mark.parametrize("bout", [256, 512])
def test_k7_strip_matches_forced_bout_qmm_kernel(bout):
    """K7's half-split GEMV (T1c's first design, the strip body at strip
    128) against quantize._qmm_kernel under stream_ceiling's BlockSpecs."""
    x, q, scale, want = _forced_bout_case(256, 1024, bout)
    got = Q.int4_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale), strip=128)
    assert _rel(got.numpy(), want) <= REL_1E5


@pytest.mark.parametrize("slices", [1, 2, 3])
def test_t1c_body_emulation_matches_forced_bout_qmm_kernel(slices):
    """T1c's kernel, the tensor-core body on the half-split layout at a
    slices override (3: uneven slices of the 4 chunks), walked by
    tc_emulate, against the forced-bout _qmm_kernel; on the CPU
    half_split_matmul is its plain version."""
    x, q, scale, want = _forced_bout_case(512, 1024, 512)
    plan = GP.tc_plan("half", 8, 512, 1024, 3, slices)
    assert (plan.slices, plan.chunks) == (slices, 4)
    xt, qt, st = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q), torch.from_numpy(scale)
    assert _rel(GP.tc_emulate(plan, xt, qt, st).numpy(), want) <= REL_1E5
    assert _rel(P.half_split_matmul(xt, qt, st, slices).numpy(), want) <= REL_1E5


# ------------------------------------------------------ geometry keywords


def test_geometry_keywords_leave_cpu_results_unchanged():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(256, 512, generator=g)
    x = torch.randn(3, 256, generator=g).to(torch.bfloat16)
    q4, s4 = Q.quantize_int4(w)
    qp, sp = Q.quantize_int4_paired(w)
    qn, sn = Q.quantize_int4_native(w)
    for strip in Q.GEMV_STRIPS:
        assert torch.equal(Q.int4_matmul(x, q4, s4, strip=strip), Q.int4_matmul(x, q4, s4))
        assert torch.equal(Q.qmm(x, q4, s4, 4, strip=strip), Q.qmm(x, q4, s4, 4))
        assert torch.equal(Q.int4_native_matmul(x, qn, sn, strip=strip), Q.int4_native_matmul(x, qn, sn))
        for split in Q.W4A8_SPLITS:
            assert torch.equal(Q.int4_w4a8_matmul(x, qp, sp, strip=strip, split_k=split),
                               Q.int4_w4a8_matmul(x, qp, sp))
    # a geometry no instance was built for raises, on any device
    with pytest.raises(ValueError):
        Q.int4_matmul(x, q4, s4, strip=48)
    with pytest.raises(ValueError):
        Q.int4_w4a8_matmul(x, qp, sp, split_k=3)
    q8, s8 = Q.quantize_int8(w, stochastic=False)
    with pytest.raises(ValueError):
        Q.qmm(x, q8, s8, 8, strip=64)   # K7's int8 instance exists at strip 32 only


# ---------------------------------------------------------- entry points


@pytest.mark.parametrize("name", PROBES)
def test_probe_main_exits_without_cuda(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"supir_tpu_torch.tools.{name}")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--reps", "1"])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)


def test_probe_entry_points_exit_nonzero_without_cuda():
    """`python -m supir_tpu_torch.tools.<name>` for each probe, in a fresh
    interpreter with no card visible: every one exits non-zero, and none
    imports jax, flax or supir_tpu."""
    code = (
        "import runpy, sys\n"
        "codes = []\n"
        f"for name in {list(PROBES)!r}:\n"
        "    try:\n"
        "        runpy.run_module('supir_tpu_torch.tools.' + name, run_name='__main__')\n"
        "        codes.append(0)\n"
        "    except SystemExit as e:\n"
        "        codes.append(0 if e.code in (0, None) else 1)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'supir_tpu'))\n"
        "print(codes, bad)\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120, capture_output=True, text=True,
                         cwd=ROOT, env=env).stdout
    assert out.strip().splitlines()[-1] == "[1, 1, 1, 1] []"


# ------------------------------------------------- LLaVA reference keys


def _manifest():
    return json.loads((ROOT / "supir_tpu" / "data" / "ref_key_manifests.json").read_text())["llava"]


POST_LN = ["model.vision_tower.vision_tower.vision_model.post_layernorm.bias",
           "model.vision_tower.vision_tower.vision_model.post_layernorm.weight"]


def test_llava_manifest_loads_strict_through_create_captioner():
    """Every key and shape of the reference's 758-key LLaVA-1.5-13B tree, on
    the meta device, converts and loads through create_captioner with
    strict=True; exactly the two post_layernorm keys are reported unused;
    the loaded tree's keys and shapes equal the converted dict's."""
    from supir_tpu_torch.captioner.agent import CaptionerConfig, create_captioner
    from supir_tpu_torch.utils.weights import convert_llava_state_dict

    man = _manifest()
    assert len(man) == 758
    sd = {k: torch.empty(shape, device="meta") for k, shape in man.items()}
    cfg = CaptionerConfig()
    converted, report = convert_llava_state_dict(sd, cfg)
    assert report.unused == POST_LN
    assert report.filled == 756 and not report.missing
    agent = create_captioner(cfg, device="meta", state_dict=sd)
    held = {k: tuple(v.shape) for k, v in agent.model.state_dict().items()}
    assert held == {k: tuple(v.shape) for k, v in converted.items()}


def _tiny_reference_dict(seed=0):
    """The tiny captioner's state dict under HF LLaVA keys, random, plus the
    keys a reference checkpoint holds that the port's tree lacks."""
    from supir_tpu_torch.captioner.agent import CaptionerConfig, LlavaForCausalLM

    cfg = CaptionerConfig.tiny()
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in LlavaForCausalLM(cfg).state_dict().items()}
    width = cfg.vision.width
    sd[POST_LN[0]] = torch.randn(width, generator=g)
    sd[POST_LN[1]] = torch.randn(width, generator=g)
    sd["model.vision_tower.vision_tower.vision_model.embeddings.position_ids"] = torch.arange(4)[None]
    return cfg, sd


def test_llava_reference_dict_loads_on_cpu_and_reports_unused():
    from supir_tpu_torch.captioner.agent import create_captioner
    from supir_tpu_torch.utils.weights import convert_llava_state_dict

    cfg, sd = _tiny_reference_dict()
    _, report = convert_llava_state_dict(sd, cfg)
    assert report.unused == sorted(POST_LN + ["model.vision_tower.vision_tower.vision_model.embeddings.position_ids"])
    agent = create_captioner(cfg, device="cpu", state_dict=sd)
    held = agent.model.state_dict()
    assert set(held) == set(sd) - set(report.unused)
    for k, v in held.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("stray", ["model.foo.weight", "model.layers.0.post_layernorm.weight",
                                   "model.vision_tower.vision_tower.vision_model.post_layernorm.scale"])
def test_llava_other_stray_keys_still_raise(stray):
    from supir_tpu_torch.captioner.agent import create_captioner

    cfg, sd = _tiny_reference_dict()
    sd[stray] = torch.zeros(4)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        create_captioner(cfg, device="cpu", state_dict=sd)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cout", [(64, 128), (192, 1408), (640, 4096), (2560, 15360)])
def test_ring_column_sum_kernel(cuda, rows, cout):
    """T1a and T1b on the ring (csrc/colsum_tc.cu) equal the plain sum at
    every k-slice count and the plan's, two runs the same bits, one launch
    counted a call."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    q = torch.randint(0, 256, (rows, cout), dtype=torch.uint8, generator=g, device=cuda)
    want = P.column_sum_plain(q)
    before = P.column_sum.launches
    assert torch.equal(P.column_sum(q), want)
    assert P.column_sum.launches == before + 1
    for slices in [None, *range(1, rows // 64 + 1)]:
        before = P.column_sum_2d.launches
        got = P.column_sum_2d(q, slices)
        assert P.column_sum_2d.launches == before + 1
        assert torch.equal(got, want), slices
        assert torch.equal(P.column_sum_2d(q, slices), got), slices
    top = torch.full_like(q, 255)                          # the largest sums: rows x 255
    assert torch.equal(P.column_sum(top), P.column_sum_plain(top))
    assert torch.equal(P.column_sum_2d(top, rows // 64), P.column_sum_plain(top))


@pytest.mark.gpu
@pytest.mark.parametrize("slices", [1, 2, 3, 10])
def test_ring_column_sum_planted_faults(cuda, slices):
    """Each planted fault of the ring breaks equality: the bytes read as
    int8 at any slice count, slice 0's partial dropped and the combine run
    twice wherever a strip has more than one slice."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randint(0, 256, (640, 1408), dtype=torch.uint8, generator=g, device=cuda)
    want = P.column_sum_plain(q)
    assert not torch.equal(P.column_sum_2d(q, slices, _fault=P.RING_FAULT_SIGNED), want)
    for fault in (P.RING_FAULT_DROP_SLICE, P.RING_FAULT_COMBINE_TWICE):
        assert torch.equal(P.column_sum_2d(q, slices, _fault=fault), want) == (slices == 1), fault
    assert torch.equal(P.column_sum_2d(q, slices), want)   # the scratch is left as a sound launch needs it


@pytest.mark.gpu
def test_ring_column_sum_refusals_on_the_card(cuda):
    for shape in ((64, 200), (100, 256)):
        with pytest.raises(ValueError):
            P.column_sum(torch.zeros(shape, dtype=torch.uint8, device=cuda))
    buf = torch.zeros(64 * 128 + 16, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        P.column_sum_2d(buf[1:1 + 64 * 128].view(64, 128))
    with pytest.raises(ValueError):
        P.column_sum_2d(torch.zeros(128, 256, dtype=torch.uint8, device=cuda), 3)


@pytest.mark.gpu
def test_unpack_and_native_cast_kernels(cuda):
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128).to(cuda)
    big = torch.randint(0, 256, (300, 1000), dtype=torch.uint8, device=cuda)
    for q in (every, big):
        want = P.unpack_nibbles_plain(q)
        before = P.unpack_nibbles.launches
        assert torch.equal(P.unpack_nibbles(q), want)
        assert P.unpack_nibbles.launches == before + 1
        assert not torch.equal(P.unpack_nibbles(q, _fault=1), want)
        assert not torch.equal(P.unpack_nibbles(q, _fault=2), want)
        want = P.native_cast_plain(q)
        before = P.native_cast.launches
        assert torch.equal(P.native_cast(q).view(torch.int16), want.view(torch.int16))
        assert P.native_cast.launches == before + 1
        assert not torch.equal(P.native_cast(q, _fault=1), want)
        assert not torch.equal(P.native_cast(q, _fault=2), want)


@pytest.mark.gpu
def test_native_cast_through_the_body_decode(cuda):
    """T4a (csrc/nibble_order.cu, nib2 of csrc/tc_decode.cuh) equals the
    plain cast and its CPU walk bit for bit on every int4 value, on random
    bytes and on byte counts that leave a partial last word; each planted
    fault equals its walk and breaks the cast; one launch counted a call."""
    every = Q.pack_int4_native((torch.arange(128 * 128).reshape(128, 128) % 16 - 8).to(torch.int8))
    g = torch.Generator().manual_seed(11)
    for q in (every, torch.randint(0, 256, (300, 1000), dtype=torch.uint8, generator=g),
              torch.randint(0, 256, (3, 7), dtype=torch.uint8, generator=g),
              torch.randint(0, 256, (1, 2), dtype=torch.uint8, generator=g)):
        want = P.native_cast_plain(q)
        before = P.native_cast.launches
        got = P.native_cast(q.to(cuda))
        assert P.native_cast.launches == before + 1
        assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
        for fault in (P.ORDER_FAULT_SWAP, P.ORDER_FAULT_UNSIGNED):
            bad = P.native_cast(q.to(cuda), _fault=fault).cpu()
            assert torch.equal(bad.view(torch.int16), P.native_cast_emulate(q, fault).view(torch.int16))
            assert not torch.equal(bad, want)
    with pytest.raises(ValueError, match="4-byte"):
        P.native_cast(torch.zeros(1, 64, dtype=torch.uint8, device=cuda).view(-1)[1:33].view(1, 32))


ORDER_FAULTS = {"paired": (P.ORDER_FAULT_SWAP, P.ORDER_FAULT_UNSIGNED),
                "w4a8": (P.ORDER_FAULT_SWAP, P.ORDER_FAULT_UNSIGNED, P.ORDER_FAULT_K_ORDER)}


@pytest.mark.gpu
@pytest.mark.parametrize("decode", P.DECODES)
def test_unpack_through_the_body_decodes(cuda, decode):
    """T3a (csrc/nibble_order.cu) through each of the body's decodes
    (csrc/tc_decode.cuh) equals the plain unpack on all 256 bytes, on
    random bytes and on an odd row count, one launch counted a call; each
    planted fault breaks it; the empty kernel launches."""
    g = torch.Generator(device=cuda).manual_seed(5)
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 128).to(cuda)
    for q in (every, torch.randint(0, 256, (301, 1000), dtype=torch.uint8, generator=g, device=cuda)):
        want = P.unpack_nibbles_plain(q)
        before = P.unpack_nibbles.launches
        assert torch.equal(P.unpack_nibbles(q, decode), want)
        assert P.unpack_nibbles.launches == before + 1
        for fault in ORDER_FAULTS[decode]:
            assert not torch.equal(P.unpack_nibbles(q, decode, _fault=fault), want), fault
    with pytest.raises(ValueError):
        P.unpack_nibbles(every[:, :126].contiguous(), decode)
    P.empty_launch(cuda)
    torch.cuda.synchronize()


def _card_weights(g, cin, cout, device):
    return torch.randn(cin, cout, generator=g, device=device) * cin ** -0.5


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 20])
@pytest.mark.parametrize("strip", [32, 64, 128, 256])
def test_single_cast_and_strip_instances(cuda, rows, strip):
    """K7's half-split and K11's native instances (the first designs of T1c
    and T4b) at each strip, against their fp32 plain versions; the scale
    left out must break it."""
    g = torch.Generator(device=cuda).manual_seed(1)
    cin, cout = 1024, 1544
    w = _card_weights(g, cin, cout, cuda)
    x = torch.randn(rows, cin, generator=g, device=cuda).to(torch.bfloat16)
    for kernel, plain, (q, s) in (
        (lambda xx, q, s: Q.int4_matmul(xx, q, s, strip=strip), lambda xx, q, s: Q.qmm_plain(xx, q, s, 4),
         Q.quantize_int4(w)),
        (lambda xx, q, s: Q.int4_native_matmul(xx, q, s, strip=strip), Q.int4_native_matmul_plain,
         Q.quantize_int4_native(w)),
    ):
        want = plain(x.float(), q, s)
        assert _card_rel(kernel(x, q, s), want) <= CARD_REL_BOUND
        assert _card_rel(kernel(x, q, torch.ones_like(s)), want) > CARD_REL_BOUND


ON_BODY = {"half": (P.half_split_matmul, Q.quantize_int4, P.half_split_matmul_plain),
           "paired": (P.int4_single_cast_matmul, Q.quantize_int4_paired, Q.int4_paired_matmul_plain),
           "native": (P.native_single_cast_matmul, Q.quantize_int4_native, Q.int4_native_matmul_plain)}
SLICES_SWEEP = (1, 2, 4, 8, None)   # the probes' sweep; None: the plan's own


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(ON_BODY))
@pytest.mark.parametrize("rows", [1, 8, 16])
def test_single_cast_kernels(cuda, rows, layout):
    """T1c (half), T3b (paired) and T4b (native) on the tensor-core body
    against their fp32 plain versions at 1e-2, at every slice count of the probes' sweep,
    two runs bit for bit, one launch counted a call; each of the body's
    planted faults breaks the bound (the combine run twice at 4 slices)."""
    kernel, quantize, plain = ON_BODY[layout]
    g = torch.Generator(device=cuda).manual_seed(3 + rows)
    cin, cout = 1024, 1536
    q, s = quantize(_card_weights(g, cin, cout, cuda))
    x = torch.randn(rows, cin, generator=g, device=cuda).to(torch.bfloat16)
    want = plain(x.float(), q, s)
    for slices in SLICES_SWEEP:
        before = kernel.launches
        got = kernel(x, q, s, slices)
        assert kernel.launches == before + 1
        assert _card_rel(got, want) <= CARD_REL_BOUND, slices
        assert torch.equal(got, kernel(x, q, s, slices))
    for slices, fault in ((None, GP.FAULT_DROP_SHARE), (None, GP.FAULT_X_ORDER), (4, GP.FAULT_COMBINE_TWICE)):
        assert _card_rel(kernel(x, q, s, slices, _fault=fault), want) > CARD_REL_BOUND, fault


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(ON_BODY))
@pytest.mark.parametrize("rows", [1, 8])
def test_single_cast_holds_all_positive_x_at_the_longest_contraction(cuda, rows, layout):
    """x of one sign (|N(0,1)|, as after SiLU) over the 13B down
    projection's cin 13824: T1c, T3b and T4b within 1e-2 of their fp32
    plain versions at every slice count of the sweep."""
    kernel, quantize, plain = ON_BODY[layout]
    g = torch.Generator(device=cuda).manual_seed(11)
    cin, cout = 13824, 5120
    q, s = quantize(_card_weights(g, cin, cout, cuda))
    x = torch.randn(rows, cin, generator=g, device=cuda).abs().to(torch.bfloat16)
    want = plain(x.float(), q, s)
    for slices in SLICES_SWEEP:
        assert _card_rel(kernel(x, q, s, slices), want) <= CARD_REL_BOUND, slices


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 20])
@pytest.mark.parametrize("strip", [32, 64, 128, 256])
@pytest.mark.parametrize("split", [1, 2, 4])
def test_w4a8_geometry_instances(cuda, rows, strip, split):
    """T2's first design: K10's strip body at each strip x split-K, exact
    integer sums: relative 1e-6 against the plain version; one slice
    dropped must break it. It counts no launch."""
    g = torch.Generator(device=cuda).manual_seed(2)
    cin, cout = 1536, 520
    packed, scale = Q.quantize_int4_paired(_card_weights(g, cin, cout, cuda))
    xq = torch.randint(-127, 128, (rows, cin), dtype=torch.int8, generator=g, device=cuda)
    want = P.w4a8_preact_plain(xq, packed, scale)
    before = P.w4a8_preact.launches
    assert _card_rel(P.w4a8_preact_strip(xq, packed, scale, strip, split), want) <= W4A8_REL
    assert P.w4a8_preact.launches == before
    if split > 1:
        assert _card_rel(P.w4a8_preact_strip(xq, packed, scale, strip, split, _skip_split=split - 1),
                         want) > W4A8_REL
    x = torch.randn(rows, cin, generator=g, device=cuda).to(torch.bfloat16)
    got = Q.int4_w4a8_matmul(x, packed, scale, strip=strip, split_k=split)
    assert _card_rel(got, Q.int4_w4a8_matmul_plain(x.float(), packed, scale)) <= W4A8_REL


T2_SHAPES = {"qkv": (5120, 15360), "down": (13824, 5120)}   # the 13B projections, cin x cout


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 16, 20])
@pytest.mark.parametrize("shape", sorted(T2_SHAPES))
def test_w4a8_preact_on_the_body(cuda, shape, rows):
    """T2 on the tensor-core body (K10's W4A8 instances, every row scale
    127; 20 rows are two launches) bit-equal to its plain version at 1, 2,
    4 and 8 k-slices and the plan's count, two runs the same bits, one
    launch counted a call; each planted fault breaks the equality: one
    block's share dropped, x staged out of order, the combine run twice (2
    slices), the scale left out."""
    cin, cout = T2_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(rows)
    packed = torch.randint(0, 256, (cin // 2, cout), dtype=torch.uint8, generator=g, device=cuda)
    scale = torch.rand(1, cout, generator=g, device=cuda) * 0.01 + 0.001
    xq = torch.randint(-127, 128, (rows, cin), dtype=torch.int8, generator=g, device=cuda)
    want = P.w4a8_preact_plain(xq, packed, scale)
    for slices in SLICES_SWEEP:
        before = P.w4a8_preact.launches
        got = P.w4a8_preact(xq, packed, scale, slices)
        assert P.w4a8_preact.launches == before + 1
        assert torch.equal(got, want), slices
        assert torch.equal(P.w4a8_preact(xq, packed, scale, slices), got), slices
    for slices, fault in ((None, GP.FAULT_DROP_SHARE), (None, GP.FAULT_X_ORDER), (2, GP.FAULT_COMBINE_TWICE)):
        assert not torch.equal(P.w4a8_preact(xq, packed, scale, slices, _fault=fault), want), fault
    assert not torch.equal(P.w4a8_preact(xq, packed, torch.ones_like(scale)), want)
    assert torch.equal(P.w4a8_preact(xq, packed, scale), want)   # the scratch is left as a sound launch needs it
