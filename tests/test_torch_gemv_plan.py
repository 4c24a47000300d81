"""The tensor-core decode GEMV's plan (`supir_tpu_torch/ops/gemv_plan.py`),
on the CPU: the k-slice tiles and their order, the fixed combine order, the weight tensor
map's box and stride, the shared-memory words each lane reads, and
`tc_emulate`, which walks the plan in torch (shares, the k permutation
inside each 16-k step, the combine order) and must equal the plain K5 (every
prologue and residual form) and K7 int8 at the fp32 tolerance of
tests/test_torch_quantize.py (atol 1e-4 + rtol 1e-5), and the JAX functions
at that file's tolerances. The kernel itself (`csrc/quant_gemv_tc.cu`) runs
only on the card (tests/test_torch_quantize.py, `gpu`)."""

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import gemv_plan as GP
from supir_tpu_torch.ops import quantize as Q

ATOL, RTOL = 1e-4, 1e-5
BF16_TOL = 2e-3
LLAMA_13B = ((5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120))
RAGGED = ((640, 272), (1000, 144), (256, 16))   # cout % 128 != 0; cin % 128 != 0
SMS = 132


def _all_shapes():
    return [(m, cin, cout, rows) for m in ("paired", "int8") for cin, cout in LLAMA_13B + RAGGED
            for rows in (1, 8, 32)]


@pytest.mark.parametrize("mode,cin,cout,rows", _all_shapes())
def test_tiles_cover_every_weight_byte_once(mode, cin, cout, rows):
    plan = GP.tc_plan(mode, rows, cin, cout, SMS)
    assert plan.tiles == plan.strips * plan.slices and plan.grid == min(plan.tiles, SMS)
    # every tile belongs to one block, and blocks' work is within one tile of equal
    owners = [b for b in range(plan.grid) for _ in plan.tiles_of(b)]
    assert sorted(t for b in range(plan.grid) for t in plan.tiles_of(b)) == list(range(plan.tiles))
    counts = [len(plan.tiles_of(b)) for b in range(plan.grid)]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1 and len(owners) == plan.tiles
    sizes = [sum(plan.slice_chunks(plan.tile(t)[1])[1] - plan.slice_chunks(plan.tile(t)[1])[0]
                 for t in plan.tiles_of(b)) for b in range(plan.grid)]
    largest = max(c1 - c0 for c0, c1 in map(plan.slice_chunks, range(plan.slices)))
    assert max(sizes) - min(sizes) <= largest            # every share within one tile of equal
    # slices cut the chunks in order; tiles tile the weight: strips x chunk ranges
    assert plan.slice_chunks(0)[0] == 0 and plan.slice_chunks(plan.slices - 1)[1] == plan.chunks
    assert all(plan.slice_chunks(p)[1] == plan.slice_chunks(p + 1)[0] for p in range(plan.slices - 1))
    owner = torch.full((plan.chunks * plan.box_rows, plan.strips * GP.TC_STRIP), -1, dtype=torch.int32)
    for b in range(plan.grid):
        for t in plan.tiles_of(b):
            s, p = plan.tile(t)
            c0, c1 = plan.slice_chunks(p)
            tile = owner[c0 * plan.box_rows:c1 * plan.box_rows, s * GP.TC_STRIP:(s + 1) * GP.TC_STRIP]
            assert (tile == -1).all()
            tile.fill_(b)
    assert (owner >= 0).all()
    assert plan.wrows == (cin // 2 if mode == "paired" else cin)


@pytest.mark.parametrize("mode,cin,cout,rows", _all_shapes())
def test_blocks_move_through_k_together(mode, cin, cout, rows):
    # the blocks' i-th tiles lie in at most two neighbouring slices (whole rows read together)
    plan = GP.tc_plan(mode, rows, cin, cout, SMS)
    for i in range(-(-plan.tiles // plan.grid)):
        slices = {plan.tile(t)[1] for t in range(i * plan.grid, min(plan.tiles, (i + 1) * plan.grid))}
        assert max(slices) - min(slices) <= 1 + plan.grid // plan.strips


@pytest.mark.parametrize("mode,cin,cout,rows", _all_shapes())
def test_combine_order_is_fixed(mode, cin, cout, rows):
    plan = GP.tc_plan(mode, rows, cin, cout, SMS)
    seen = []
    for s in range(plan.strips):
        contrib = plan.contributors(s)
        assert contrib == plan.contributors(s) and len(contrib) == plan.slices
        assert [plan.tile(t) for t in contrib] == [(s, p) for p in range(plan.slices)]   # slice order
        seen += contrib
    assert sorted(seen) == list(range(plan.tiles))
    if plan.slices > 1:
        assert plan.tiles * rows * GP.TC_STRIP * 4 <= GP.TC_PART_BYTES


@pytest.mark.parametrize("mode,cin,cout,rows", _all_shapes())
def test_tensor_map_and_smem_are_legal(mode, cin, cout, rows):
    plan = GP.tc_plan(mode, rows, cin, cout, SMS)
    # the map supir_qgemv_tc_map encodes: uint8 [wrows, cout], row stride
    # cout bytes, box 128 bytes x box_rows rows, 128-byte swizzle
    box = (GP.TC_STRIP, plan.box_rows)
    assert box[0] % 16 == 0 and all(1 <= b <= 256 for b in box)
    assert box[0] == 128                              # the 128-byte swizzle's span
    assert plan.cout % 16 == 0 and plan.cout < 2 ** 40
    assert plan.wrows == (cin // 2 if mode == "paired" else cin) and max(plan.cout, plan.wrows) < 2 ** 32
    assert (box[0] * box[1]) % 1024 == 0              # stages stay 1024-byte aligned
    assert plan.smem <= 227 * 1024
    assert plan.xrs % 32 == 8 and plan.rows * plan.xrs * 4 <= GP.TC_XS_BYTES
    assert plan.nt * 8 >= rows


def test_what_the_tensor_cores_do_not_take():
    assert not GP.tc_eligible("paired", 640, 264, 0, 0, 640)       # cout 8 mod 16: no TMA row stride
    assert not GP.tc_eligible("half", 640, 256, 0, 0, 640)
    assert not GP.tc_eligible("native", 640, 256, 0, 0, 640)
    assert not GP.tc_eligible("paired", 640, 256, 8, 0, 640)       # weights 8-byte aligned only
    assert not GP.tc_eligible("int8", 640, 256, 0, 4, 640)
    assert not GP.tc_eligible("paired", 644, 256, 0, 0, 648)       # SiLU-GLU's second half unaligned
    assert GP.tc_eligible("int8", 640, 256, 0, 0, 640) and GP.tc_eligible("paired", 5120, 5120, 256, 512, 5120)
    with pytest.raises(ValueError):
        GP.tc_plan("paired", 33, 512, 256, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("paired", 1, 512, 264, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("native", 1, 512, 256, SMS)


@pytest.mark.parametrize("mode", ["paired", "int8"])
def test_lane_reads_meet_no_bank_twice(mode):
    steps = GP.TC_BOX_ROWS[mode] // (8 if mode == "paired" else 16)
    for warp in range(GP.TC_WARPS):
        for step in range(steps):
            loads = [[GP.a_word_offset(r, warp, lane >> 2) for r in GP.a_rows(mode, step, lane & 3)]
                     for lane in range(32)]
            for i in range(len(loads[0])):
                offs = [load[i] for load in loads]
                assert all(o % 4 == 0 for o in offs)
                assert len({(o // 4) % 32 for o in offs}) == 32
                # and the lane's word holds the columns the fragment rules say
                for lane in range(32):
                    r = GP.a_rows(mode, step, lane & 3)[i]
                    assert offs[lane] == GP.swizzle(r, 32 * warp + 4 * (lane >> 2))
    # the B fragments: an 8-byte load a lane, rows 8 nt + g, words 2t, 2t+1; served in half-warps
    for rows, cin in ((8, 5120), (32, 13824), (8, 13824)):
        plan = GP.tc_plan(mode, rows, cin, 5120, SMS)
        for half in (range(16), range(16, 32)):
            banks = [((lane >> 2) * plan.xrs + 2 * (lane & 3) + h) % 32 for lane in half for h in (0, 1)]
            assert len(set(banks)) == 32


def test_staged_word_order_is_a_permutation():
    for mode in ("paired", "int8"):
        ks = sorted(k for pos in range(8) for k in GP.x_word_k(mode, pos))
        assert ks == list(range(16))
        # the planted fault (the word interleave dropped) moves k in both layouts
        assert [GP.x_word_k(mode, pos, GP.FAULT_X_ORDER) for pos in range(8)] != \
            [GP.x_word_k(mode, pos) for pos in range(8)]
    # paired: the lanes' row order (k pairs t, t + 4 in rows 2t, 2t + 1) and
    # the interleave cancel, so the words hold k in natural order; int8's do not
    assert [GP.x_word_k("paired", pos) for pos in range(8)] == [(2 * pos, 2 * pos + 1) for pos in range(8)]
    assert [GP.x_word_k("int8", pos) for pos in range(8)] != [(2 * pos, 2 * pos + 1) for pos in range(8)]


def _case(mode, rows, cin, cout, prologue, with_residual, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(cin, cout, generator=g) * cin ** -0.5
    if mode == "paired":
        wq, scale = Q.quantize_int4_paired(w)
    else:
        wq, scale = Q.quantize_int8_plain(w)
    x = (torch.randn(rows, 2 * cin if prologue == 2 else cin, generator=g) * 2).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(cin, generator=g) if prologue == 1 else None
    residual = torch.randn(rows, cout, generator=g) if with_residual else None
    return wq, scale, x, gamma, residual


def _plain(mode, x, wq, scale, gamma, prologue, residual):
    if mode == "paired":
        return Q.int4_paired_fused_matmul_plain(x, wq, scale, gamma=gamma, siluglu=prologue == 2, residual=residual)
    return Q.qmm_plain(x, wq, scale, 8)


FORMS = [("paired", 0, False), ("paired", 0, True), ("paired", 1, False), ("paired", 1, True),
         ("paired", 2, False), ("paired", 2, True), ("int8", 0, False)]


@pytest.mark.parametrize("mode,prologue,with_residual", FORMS)
@pytest.mark.parametrize("rows,cin,cout,sms", [(1, 640, 272, 4), (8, 1000, 144, 3), (32, 264, 384, 7),
                                               (3, 512, 256, 64)])
def test_emulation_matches_plain(mode, prologue, with_residual, rows, cin, cout, sms):
    wq, scale, x, gamma, residual = _case(mode, rows, cin, cout, prologue, with_residual, rows + cin)
    plan = GP.tc_plan(mode, rows, cin, cout, sms)
    got = GP.tc_emulate(plan, x, wq, scale, gamma, 1e-6, prologue, residual)
    want = _plain(mode, x, wq, scale, gamma, prologue, residual)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["paired", "int8"])
def test_emulated_faults_break_the_bound(mode):
    rows, cin, cout = 4, 640, 272
    wq, scale, x, gamma, residual = _case(mode, rows, cin, cout, 1 if mode == "paired" else 0, False, 5)
    prologue = 1 if gamma is not None else 0
    plan = GP.tc_plan(mode, rows, cin, cout, 12)
    assert plan.slices > 1                      # strips are combined, so the combine fault has a place
    want = _plain(mode, x, wq, scale, gamma, prologue, None)

    def rel(got):
        return ((got - want).norm() / want.norm()).item()

    assert rel(GP.tc_emulate(plan, x, wq, scale, gamma, 1e-6, prologue)) < 1e-5
    for fault in (GP.FAULT_DROP_SHARE, GP.FAULT_COMBINE_TWICE, GP.FAULT_X_ORDER):
        assert rel(GP.tc_emulate(plan, x, wq, scale, gamma, 1e-6, prologue, fault=fault)) > 1e-2, fault
    if mode == "paired":
        swapped = ((wq >> 4) | (wq << 4)).contiguous()
        assert rel(GP.tc_emulate(plan, x, swapped, scale, gamma, 1e-6, prologue)) > 1e-2


@pytest.mark.parametrize("prologue", [0, 1, 2])
@pytest.mark.parametrize("with_residual", [False, True])
def test_emulation_matches_jax_fused(prologue, with_residual):
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    rows, cin, cout = 3, 384, 144
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
    x = (rng.standard_normal((rows, 2 * cin if prologue == 2 else cin)) * 2).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32) if prologue == 1 else None
    residual = rng.standard_normal((rows, cout)).astype(np.float32) if with_residual else None
    packed, scale = JQ.quantize_int4_paired(jnp.asarray(w))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = JQ.int4_paired_fused_matmul(xj, packed, scale, gamma=None if gamma is None else jnp.asarray(gamma),
                                       eps=1e-6, siluglu=prologue == 2,
                                       residual=None if residual is None else jnp.asarray(residual))
    plan = GP.tc_plan("paired", rows, cin, cout, 5)
    got = GP.tc_emulate(plan, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(np.asarray(packed)),
                        torch.from_numpy(np.asarray(scale)), None if gamma is None else torch.from_numpy(gamma),
                        1e-6, prologue, None if residual is None else torch.from_numpy(residual))
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=BF16_TOL, rtol=BF16_TOL)


def test_emulation_matches_jax_int8():
    """K7 int8 against the JAX int8_matmul (XLA fallback) and its Pallas
    `_qmm` kernel in interpret mode, as tests/test_torch_quantize.py runs
    them."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    rows, cin, cout = 5, 512, 256   # the TPU kernel's blocks take whole 128-column tiles
    rng = np.random.default_rng(12)
    w = jnp.asarray((rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32))
    q, s = JQ.quantize_int8(w, interpret=True)
    x = jnp.asarray(rng.standard_normal((rows, cin)).astype(np.float32), jnp.bfloat16)
    want = JQ.int8_matmul(x, q, s)
    want_kernel = JQ._qmm(x, q, s, bits=8, interpret=True)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    plan = GP.tc_plan("int8", rows, cin, cout, 6)
    got = GP.tc_emulate(plan, xt, torch.from_numpy(np.asarray(q)), torch.from_numpy(np.asarray(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL, rtol=RTOL)


def test_plan_is_cached_and_packed_in_field_order():
    a = GP.tc_plan("paired", 1, 5120, 15360, SMS)
    assert a is GP.tc_plan("paired", 1, 5120, 15360, SMS)
    assert a.packed() is a.packed()
    assert list(a.packed()) == [getattr(a, f) for f in GP.PLAN_FIELDS]


def test_host_cost_tool_exits_without_cuda(monkeypatch):
    from supir_tpu_torch.tools import gemv_host_cost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        gemv_host_cost.main(["--variant", "new=."])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)


def test_the_kernel_source_walks_these_rules():
    """The constants and index rules the emulation walks appear in the
    kernel's source as written here."""
    from pathlib import Path

    src = (Path(GP.__file__).resolve().parents[1] / "csrc" / "quant_gemv_tc.cu").read_text()
    assert f"constexpr int TC_STRIP = {GP.TC_STRIP};" in src
    assert "BOX_ROWS = MODE == MODE_PAIRED ? 64 : 128;" in src and GP.TC_BOX_ROWS == {"paired": 64, "int8": 128}
    assert "STAGES = MODE == MODE_PAIRED ? 16 : 8;" in src and GP.TC_STAGES == {"paired": 16, "int8": 8}
    assert "static constexpr int PARTS = 2;" in src and GP.TC_PARTS == 2
    assert "SETS = NT == 1 ? 4 : (NT == 2 ? 2 : 1);" in src and [GP.acc_sets(n) for n in (1, 2, 4)] == [4, 2, 1]
    assert "FAULT_DROP_SHARE = 1, FAULT_COMBINE_TWICE = 2, FAULT_X_ORDER = 3;" in src
    assert "int rows, cin, cout, wrows, strips, chunks, slices, tiles, grid, wch, xrs, smem, nt, stages, box_rows;" \
        in src and ", ".join(GP.PLAN_FIELDS) == "rows, cin, cout, wrows, strips, chunks, slices, tiles, grid, wch, " \
        "xrs, smem, nt, stages, box_rows"
    assert "const int pair = fault == FAULT_X_ORDER ? pos : (pos >> 1) + 4 * (pos & 1);" in src
    assert "aoff[l] = r * TC_STRIP + ((chunk0 ^ (r & 7)) << 4) + within;" in src
