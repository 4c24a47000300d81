"""The tensor-core decode GEMV's plan (`supir_tpu_torch/ops/gemv_plan.py`),
on the CPU, in its five layouts (paired int4, half-split int4, int8,
native int4 column pairs, and W4A8: paired int4 against int8 x): the
k-slice tiles and their order, the fixed combine order, the weight tensor
map's box and stride, the shared-memory pieces each lane reads, and
`tc_emulate`, which walks the plan in torch (shares, the k permutation
inside each step, the combine order; W4A8 in integers) and must equal the
plain K5 (every prologue and residual form), K6, K7 (int8 and half-split
int4), K11 and K5's act_int8 mode at the fp32 tolerance of
tests/test_torch_quantize.py (atol 1e-4 + rtol 1e-5), the plain K10 bit
for bit, and the JAX functions at that file's tolerances. The kernel
itself (`csrc/quant_gemv_tc.cu`) runs only on the card
(tests/test_torch_quantize.py, `gpu`)."""

import numpy as np
import pytest
import torch

from supir_tpu_torch.ops import gemv_plan as GP
from supir_tpu_torch.ops import quantize as Q

ATOL, RTOL = 1e-4, 1e-5
BF16_TOL = 2e-3
LLAMA_13B = ((5120, 15360), (5120, 5120), (5120, 27648), (13824, 5120))
RAGGED = ((640, 272), (1000, 144), (256, 16))   # cout % 128 != 0; cin % 128 != 0
# the same cuts where the half-split layout needs cin % 16 == 0 and the native one cout % 32 == 0
RAGGED_OF = {"paired": RAGGED, "int8": RAGGED, "half": ((640, 272), (1008, 144), (256, 16)),
             "native": ((640, 288), (1000, 160), (256, 32)), "w4a8": RAGGED}
MODES = ("paired", "int8", "half", "native", "w4a8")
SMS = 132


def _most_rows(mode):
    return GP.TC_W4A8_ROWS if mode == "w4a8" else GP.TC_MAX_ROWS


def _all_shapes():
    return [(m, cin, cout, rows) for m in MODES for cin, cout in LLAMA_13B + RAGGED_OF[m]
            for rows in (1, 8, _most_rows(m))]


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
    width = plan.box_bytes
    owner = torch.full((plan.chunks * plan.box_rows, plan.strips * width), -1, dtype=torch.int32)
    for b in range(plan.grid):
        for t in plan.tiles_of(b):
            s, p = plan.tile(t)
            c0, c1 = plan.slice_chunks(p)
            tile = owner[c0 * plan.box_rows:c1 * plan.box_rows, s * width:(s + 1) * width]
            assert (tile == -1).all()
            tile.fill_(b)
    assert (owner >= 0).all()
    assert owner.shape[0] >= plan.wrows and owner.shape[1] >= plan.wcols     # every weight byte has its block
    assert plan.wrows == (cin // 2 if mode in ("paired", "half", "w4a8") else cin)
    assert plan.wcols == (cout // 2 if mode == "native" else cout)


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
    # the map supir_qgemv_tc_map encodes: uint8 [wrows, wcols], row stride
    # wcols bytes, box box_bytes x box_rows rows, the swizzle of box_bytes
    box = (plan.box_bytes, plan.box_rows)
    assert box[0] % 16 == 0 and all(1 <= b <= 256 for b in box)
    assert box[0] == (64 if mode == "native" else 128)   # the swizzle's span, one strip's bytes of a row
    assert box[0] * (2 if mode == "native" else 1) == GP.TC_STRIP
    assert plan.wcols % 16 == 0 and plan.wcols < 2 ** 40    # TMA's global row stride
    assert max(plan.wcols, plan.wrows) < 2 ** 32
    assert (box[0] * box[1]) % 1024 == 0              # stages stay 1024-byte aligned
    assert plan.stages * box[0] * box[1] == 128 * 1024
    assert plan.smem <= 227 * 1024
    assert plan.xrs % 32 == 8 and plan.rows * plan.xrs * 4 <= GP.TC_XS_BYTES
    assert plan.nt * 8 >= rows


def test_what_the_tensor_cores_do_not_take():
    assert not GP.tc_eligible("paired", 640, 264, 0, 0, 640)       # cout 8 mod 16: no TMA row stride
    assert not GP.tc_eligible("half", 640, 264, 0, 0, 640)
    assert not GP.tc_eligible("native", 640, 272, 0, 0, 640)       # rows of 136 bytes: 8 mod 16
    assert not GP.tc_eligible("half", 1000, 256, 0, 0, 1000)       # the second half starts 8-byte aligned
    assert not GP.tc_eligible("paired", 640, 256, 8, 0, 640)       # weights 8-byte aligned only
    assert not GP.tc_eligible("native", 640, 256, 8, 0, 640)
    assert not GP.tc_eligible("int8", 640, 256, 0, 4, 640)
    assert not GP.tc_eligible("half", 640, 256, 0, 4, 640)
    assert not GP.tc_eligible("paired", 644, 256, 0, 0, 648)       # SiLU-GLU's second half unaligned
    assert not GP.tc_eligible("w4a8", 640, 264, 0, 0, 640)         # W4A8 takes the paired layout's rules
    assert not GP.tc_eligible("w4a8", 644, 256, 0, 0, 644)         # int8 x rows 4-byte aligned only
    assert not GP.tc_eligible("int4", 640, 256, 0, 0, 640)         # no such layout
    assert GP.tc_eligible("int8", 640, 256, 0, 0, 640) and GP.tc_eligible("paired", 5120, 5120, 256, 512, 5120)
    assert GP.tc_eligible("half", 640, 272, 0, 0, 640) and GP.tc_eligible("native", 1000, 288, 0, 0, 1000)
    with pytest.raises(ValueError):
        GP.tc_plan("paired", 33, 512, 256, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("paired", 1, 512, 264, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("native", 1, 512, 272, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("half", 1, 1000, 256, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("w4a8", 1, 512, 264, SMS)
    with pytest.raises(ValueError):
        GP.tc_plan("int4", 1, 512, 256, SMS)
    with pytest.raises(ValueError):                                  # W4A8 takes 17-32 rows in two launches
        GP.tc_plan("w4a8", GP.TC_W4A8_ROWS + 1, 512, 256, SMS)
    assert GP.tc_eligible("w4a8", 1000, 272, 0, 0, 1000)


@pytest.mark.parametrize("mode", MODES)
def test_every_13b_shape_is_taken(mode):
    """Every projection of the 13B decode, in every layout, at 16-byte
    aligned tensors: the tensor-core body takes it."""
    for cin, cout in LLAMA_13B:
        assert GP.tc_eligible(mode, cin, cout, 1 << 20, 1 << 12, cin)
        assert GP.tc_plan(mode, 1, cin, cout, SMS).wcols % 16 == 0


@pytest.mark.parametrize("mode", MODES)
def test_lane_reads_meet_no_bank_twice(mode):
    steps = GP.tc_steps(mode)
    width = GP.TC_BOX_BYTES[mode]
    for warp in range(GP.TC_WARPS):
        for step in range(steps):
            loads = [[GP.a_word_offset(mode, r, warp, lane >> 2) for r in GP.a_rows(mode, step, lane & 3)]
                     for lane in range(32)]
            for i in range(len(loads[0])):
                offs = [load[i] for load in loads]
                if mode == "native":
                    # 2-byte loads: two lanes share each 4-byte word (a broadcast),
                    # and the warp's 16 distinct words meet 16 banks
                    words = {o // 4 for o in offs}
                    assert all(o % 2 == 0 for o in offs) and len(words) == 16
                    assert len({w % 32 for w in words}) == len(words)
                else:
                    assert all(o % 4 == 0 for o in offs)
                    assert len({(o // 4) % 32 for o in offs}) == 32
                # and the lane's piece holds the columns the fragment rules say
                for lane in range(32):
                    r = GP.a_rows(mode, step, lane & 3)[i]
                    col = 16 * warp + 2 * (lane >> 2) if mode == "native" else 32 * warp + 4 * (lane >> 2)
                    assert offs[lane] == GP.swizzle(r, col, width)
                    assert r < GP.TC_BOX_ROWS[mode] and GP.swizzle(r, col, width) // width == r
    # the B fragments: an 8-byte load a lane, rows 8 nt + g, words 2t, 2t+1; served in half-warps
    for rows, cin in ((8, 5120), (_most_rows(mode), 13824), (8, 13824)):
        plan = GP.tc_plan(mode, rows, cin, 5120, SMS)
        for half in (range(16), range(16, 32)):
            banks = [((lane >> 2) * plan.xrs + 2 * (lane & 3) + h) % 32 for lane in half for h in (0, 1)]
            assert len(set(banks)) == 32


@pytest.mark.parametrize("mode", MODES)
def test_staged_word_order_is_a_permutation(mode):
    ks = sorted(k for pos in range(8) for k in GP.x_word_k(mode, pos))
    assert ks == list(range(GP.TC_STEP_K[mode]))
    # the planted fault (the word interleave dropped; the half-split pairs
    # staged in natural order) moves values in every layout
    assert [GP.x_word_k(mode, pos, GP.FAULT_X_ORDER) for pos in range(8)] != \
        [GP.x_word_k(mode, pos) for pos in range(8)]
    natural = [(2 * pos, 2 * pos + 1) for pos in range(8)]
    words = [GP.x_word_k(mode, pos) for pos in range(8)]
    if mode == "paired":
        # the lanes' row order (k pairs t, t + 4 in rows 2t, 2t + 1) and the
        # interleave cancel, so the words hold k in natural order
        assert words == natural
    elif mode == "half":
        # word p: packed row p's two halves, x[p0 + p] and x[h + p0 + p]
        assert words == [(pos, pos + 8) for pos in range(8)]
        assert [GP.x_word_k(mode, pos, GP.FAULT_X_ORDER) for pos in range(8)] == natural
    elif mode == "w4a8":
        # word 2t: k quad t, word 2t + 1: quad t + 4 (a lane's two B registers), bytes in
        # the A registers' order (4q, 4q + 2, 4q + 1, 4q + 3)
        quads = [(pos >> 1) + 4 * (pos & 1) for pos in range(8)]
        assert words == [(4 * q, 4 * q + 2, 4 * q + 1, 4 * q + 3) for q in quads]
    else:
        assert words != natural and words == [GP.x_word_k("int8", pos) for pos in range(8)]


def test_half_split_steps_take_both_halves():
    x = torch.arange(2 * 200, dtype=torch.float32).reshape(2, 200)   # cin 200: h 100, 2 chunks of 64 packed rows
    v = GP.step_values("half", x, 2)
    assert v.shape == (2, 16, 16)
    assert v[1, 3, :8].tolist() == list(range(200 + 24, 200 + 32))
    assert v[1, 3, 8:].tolist() == list(range(200 + 124, 200 + 132))
    assert v[0, 12, :4].tolist() == [96, 97, 98, 99] and (v[0, 12, 4:8] == 0).all() and (v[0, 13:] == 0).all()
    assert v[0, 12, 8:12].tolist() == [196, 197, 198, 199] and (v[0, 12, 12:] == 0).all()
    n = GP.step_values("native", x, 2)
    assert n.shape == (2, 16, 16) and n[1, 2].tolist() == list(range(232, 248)) and (n[:, 13:] == 0).all()


QUANTIZERS = {"paired": Q.quantize_int4_paired, "half": Q.quantize_int4, "int8": Q.quantize_int8_plain,
              "native": Q.quantize_int4_native, "w4a8": Q.quantize_int4_paired}


def _case(mode, rows, cin, cout, prologue, with_residual, seed):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(cin, cout, generator=g) * cin ** -0.5
    wq, scale = QUANTIZERS[mode](w)
    x = (torch.randn(rows, 2 * cin if prologue == 2 else cin, generator=g) * 2).to(torch.bfloat16)
    gamma = 1.0 + 0.1 * torch.randn(cin, generator=g) if prologue == 1 else None
    residual = torch.randn(rows, cout, generator=g) if with_residual else None
    return wq, scale, x, gamma, residual


def _plain(mode, x, wq, scale, gamma, prologue, residual):
    if mode in ("paired", "w4a8"):    # w4a8: K5's act_int8 mode
        return Q.int4_paired_fused_matmul_plain(x, wq, scale, gamma=gamma, siluglu=prologue == 2, residual=residual,
                                                act_int8=mode == "w4a8")
    if mode == "native":
        return Q.int4_native_matmul_plain(x, wq, scale)
    return Q.qmm_plain(x, wq, scale, 4 if mode == "half" else 8)


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


@pytest.mark.parametrize("mode,rows,cin,cout,sms", [(m, r, cin, cout, sms) for m in ("half", "native")
                                                     for r in (1, 8, 32)
                                                     for (cin, cout), sms in zip(RAGGED_OF[m] + ((2048, 384),),
                                                                                 (4, 3, 7, 9))]
                         + [("half", 1, 13824, 5120, SMS), ("native", 1, 13824, 5120, SMS)])
def test_emulation_matches_plain_int4_layouts(mode, rows, cin, cout, sms):
    """K7's half-split instance and K11 against qmm_plain(bits=4) and
    int4_native_matmul_plain: ragged shapes (cout a multiple of 16 or 32
    but not of the strip, cin not a multiple of the chunk, a native cin
    that ends inside a 16-k step), one cut into k-slices, and the 13B down
    projection at one row."""
    wq, scale, x, _, _ = _case(mode, rows, cin, cout, 0, False, rows + cin + cout)
    plan = GP.tc_plan(mode, rows, cin, cout, sms)
    got = GP.tc_emulate(plan, x, wq, scale)
    want = _plain(mode, x, wq, scale, None, 0, None)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_emulated_faults_break_the_bound(mode):
    rows, cin, cout = 4, 640, 288 if mode == "native" else 272
    wq, scale, x, gamma, residual = _case(mode, rows, cin, cout, 1 if mode in ("paired", "w4a8") else 0, False, 5)
    prologue = 1 if gamma is not None else 0
    plan = GP.tc_plan(mode, rows, cin, cout, 12)
    assert plan.slices > 1                      # strips are combined, so the combine fault has a place
    want = _plain(mode, x, wq, scale, gamma, prologue, None)

    def rel(got):
        return ((got - want).norm() / want.norm()).item()

    assert rel(GP.tc_emulate(plan, x, wq, scale, gamma, 1e-6, prologue)) < 1e-5
    faults = (GP.FAULT_DROP_SHARE, GP.FAULT_COMBINE_TWICE, GP.FAULT_X_ORDER)
    for fault in faults + ((GP.FAULT_ROW_SCALE,) if mode == "w4a8" else ()):
        assert rel(GP.tc_emulate(plan, x, wq, scale, gamma, 1e-6, prologue, fault=fault)) > 1e-2, fault
    if mode != "int8":
        # paired: the k order inside a byte; half-split: the two halves;
        # native: the two columns of each byte
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


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_emulation_matches_jax_half_split(rows):
    """K7's half-split instance against the JAX int4_matmul (XLA fallback)
    and its Pallas `_qmm` kernel at bits=4 in interpret mode: atol 1e-4 +
    rtol 1e-5, as test_emulation_matches_jax_int8."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin, cout = 512, 256   # the TPU kernel's blocks take whole 128-column tiles
    rng = np.random.default_rng(13 + rows)
    w = jnp.asarray((rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32))
    q, s = JQ.quantize_int4(w)
    x = jnp.asarray(rng.standard_normal((rows, cin)).astype(np.float32), jnp.bfloat16)
    want = JQ.int4_matmul(x, q, s)
    want_kernel = JQ._qmm(x, q, s, bits=4, interpret=True)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    plan = GP.tc_plan("half", rows, cin, cout, 6)
    got = GP.tc_emulate(plan, xt, torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows", [1, 8, 32])
def test_emulation_matches_jax_native(rows):
    """K11 against the JAX int4_native_matmul (its XLA path off the TPU)
    on the s4 weights of quantize_int4_native, packed as the port's column
    pairs: atol 1e-4 + rtol 1e-5."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin, cout = 640, 288
    rng = np.random.default_rng(17 + rows)
    w = jnp.asarray((rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32))
    qn, s = JQ.quantize_int4_native(w)
    x = jnp.asarray(rng.standard_normal((rows, cin)).astype(np.float32), jnp.bfloat16)
    want = JQ.int4_native_matmul(x, qn, s)
    packed = Q.pack_int4_native(torch.from_numpy(np.asarray(qn).astype(np.int8)))
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    plan = GP.tc_plan("native", rows, cin, cout, 5)
    got = GP.tc_emulate(plan, xt, packed, torch.from_numpy(np.array(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


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
    assert "BOX_ROWS = MODE == MODE_PAIRED || MODE == MODE_HALF || MODE == MODE_W4A8 ? 64 : 128;" in src
    assert GP.TC_BOX_ROWS == {"paired": 64, "half": 64, "int8": 128, "native": 128, "w4a8": 64}
    assert "BOX_BYTES = MODE == MODE_NATIVE ? 64 : 128;" in src
    assert GP.TC_BOX_BYTES == {"paired": 128, "half": 128, "int8": 128, "native": 64, "w4a8": 128}
    assert "STEPS = MODE == MODE_W4A8 ? 4 : 8;" in src and "STEP_BYTES = STAGE_BYTES / STEPS;" in src
    assert {m: GP.tc_steps(m) for m in MODES} == {"paired": 8, "int8": 8, "half": 8, "native": 8, "w4a8": 4}
    assert "XWORDS = MODE == MODE_W4A8 ? 32 : 64;" in src and "xlane + M::XWORDS * (j - xa)" in src
    assert {m: GP.chunk_words(m) for m in MODES} == {"paired": 64, "int8": 64, "half": 64, "native": 64, "w4a8": 32}
    assert "constexpr int TC_RING_BYTES = 128 * 1024;" in src and "STAGES = TC_RING_BYTES / STAGE_BYTES;" in src
    assert all(GP.TC_STAGES[m] == 128 * 1024 // (GP.TC_BOX_ROWS[m] * GP.TC_BOX_BYTES[m]) for m in MODES)
    assert "constexpr int MODE_PAIRED = 0, MODE_HALF = 1, MODE_INT8 = 2, MODE_NATIVE = 3, MODE_W4A8 = 4;" in src
    assert Q._MODES == {"paired": 0, "half": 1, "int8": 2, "native": 3, "w4a8": 4}
    assert "static constexpr int PARTS = 2;" in src and GP.TC_PARTS == 2
    assert "SETS = NT == 1 ? 4 : (NT == 2 ? 2 : 1);" in src and [GP.acc_sets(n) for n in (1, 2, 4)] == [4, 2, 1]
    # W4A8's part takes 2 steps of a chunk: at most 2 sets
    assert "SETS = TcWarps<NT>::SETS < STEPS ? TcWarps<NT>::SETS : STEPS;" in src
    assert [GP.acc_sets(n, "w4a8") for n in (1, 2, 4)] == [2, 2, 1]
    assert "FAULT_DROP_SHARE = 1, FAULT_COMBINE_TWICE = 2, FAULT_X_ORDER = 3, FAULT_ROW_SCALE = 4;" in src
    assert (GP.FAULT_DROP_SHARE, GP.FAULT_COMBINE_TWICE, GP.FAULT_X_ORDER, GP.FAULT_ROW_SCALE) == (1, 2, 3, 4)
    fields = "rows, cin, cout, wrows, strips, chunks, slices, tiles, grid, wch, xrs, smem, nt, stages, box_rows, wcols"
    assert f"int {fields};" in src and ", ".join(GP.PLAN_FIELDS) == fields
    assert "const int pair = fault == FAULT_X_ORDER ? pos : (pos >> 1) + 4 * (pos & 1);" in src
    assert ("if (MODE == MODE_HALF) return fault == FAULT_X_ORDER ? make_int2(2 * pos, 2 * pos + 1) : "
            "make_int2(pos, pos + 8);") in src
    assert "aoff[l] = r * TC_STRIP + ((chunk0 ^ (r & 7)) << 4) + within;" in src
    assert "if (MODE == MODE_NATIVE) aoff[l] = r * 64 + ((group ^ ((r >> 1) & 3)) << 4) + 2 * g;" in src
    assert "const int r = MODE == MODE_PAIRED || MODE == MODE_HALF ? 2 * t + (l & 1) : 2 * t + (l & 1) + 8 * (l >> 1);" \
        in src
    # native: the low nibbles of byte f in rows 2t, 2t + 1 (bytes f, 2 + f of the joined word), then the high ones
    assert "a[f][0] = nib2_sel(lo, lo4, f | ((2 + f) << 8));" in src
    assert "a[f][1] = nib2_sel(lo, lo4, (4 + f) | ((6 + f) << 8));" in src
    assert "if (MODE == MODE_HALF) half_step_values(v, x + (size_t)n * ldx, k0 / 2, p.cin / 2);" in src
    # W4A8: the staged quads' interleave and byte order, the lanes' row pairs and their decode
    assert "return fault == FAULT_X_ORDER ? q : (q & 3) * 2 + (q >> 2);" in src
    assert "dst[x_quad_word(4 * h + i, fault)] = __byte_perm(quads[i], 0u, 0x3120);" in src
    for fault in (0, GP.FAULT_X_ORDER):     # the kernel's quad -> word map inverts x_word_k's word -> quad
        word_of = [q if fault else (q & 3) * 2 + (q >> 2) for q in range(8)]
        assert all(GP.x_word_k("w4a8", word_of[q], fault)[0] == 4 * q for q in range(8))
    assert "quad16(a[f][0], a[f][1], w0, w1, f);" in src and "quad16(a[f][2], a[f][3], w2, w3, f);" in src
    assert ("const uint32_t u = __byte_perm(wa, wb, (2 * f) | ((4 + 2 * f) << 4) | ((2 * f + 1) << 8) | "
            "((5 + 2 * f) << 12));") in src
    assert "const uint32_t h = u & 0xF0F0F0F0u;" in src and "const uint32_t l = (u << 4) & 0xF0F0F0F0u;" in src
    assert "lo = __byte_perm(l, h, 0x5410);" in src and "hi = __byte_perm(l, h, 0x7632);" in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    # no 4-tile W4A8 instance: 16 rows a launch
    assert "if constexpr (MODE != MODE_W4A8) {\n    if (p.nt == 4)" in src and GP.TC_W4A8_ROWS == 16
    assert "const float a = (float)(acc16 >> 4);" in src
    assert "float s = k10 ? __fmul_rn(__fmul_rn(a, sc), rs) : __fmul_rn(__fmul_rn(a, rs), sc);" in src
    assert "if (fault == FAULT_ROW_SCALE) rs = __fmul_rn(rs, rs);" in src
    assert "rowsc[tid] = xsc[tid] * (1.f / 127.f);" in src and "mul[tid] = 127.f / xs;" in src
    assert "swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B" in src


@pytest.mark.parametrize("mode", ["half", "native"])
def test_native_and_half_register_rules_decode_the_packers(mode):
    """The A registers the lane rules name hold, for every lane of a step,
    exactly the values the packer put at (column, k): built from one
    swizzled stage of known values and read back through a_register."""
    rows, width = GP.TC_BOX_ROWS[mode], GP.TC_BOX_BYTES[mode]
    g_ = torch.Generator().manual_seed(3)
    vals = torch.randint(-8, 8, (2 * rows if mode == "half" else rows, GP.TC_STRIP), generator=g_).to(torch.int8)
    if mode == "native":
        packed = Q.pack_int4_native(vals)
    else:
        u = (vals & 0xF).to(torch.uint8)
        packed = u[:rows] | (u[rows:] << 4)            # the half-split byte: k p low, k p + rows high
    stage = torch.zeros(rows * width, dtype=torch.uint8)
    for r in range(rows):
        for c in range(width):
            stage[GP.swizzle(r, c, width)] = packed[r, c]
    for warp in range(GP.TC_WARPS):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            words = [GP.a_word_offset(mode, r, warp, g) for r in GP.a_rows(mode, 0, t)]
            for frag in range(2):
                for reg in range(4):
                    col = GP.c_column(warp, g, frag, 2 * (reg & 1))
                    for half, (wi, byte, nibble) in enumerate(GP.a_register(mode, words, frag, reg)):
                        got = GP._decode(mode, stage, torch.tensor(words[wi] + byte), torch.tensor(nibble)).item()
                        kl = 2 * t + half + 8 * (reg >> 1)       # the fragment's k
                        if mode == "native":
                            k = kl                               # natural order
                        else:                                    # pair t: row 2t, pair t + 4: row 2t + 1
                            row = 2 * t + (reg >> 1)
                            k = row if half == 0 else row + rows
                        assert got == vals[k, col].item(), (warp, lane, frag, reg, half)


@pytest.mark.parametrize("rows,cin,cout,sms", [(1, 640, 272, 4), (8, 1000, 144, 3), (16, 264, 384, 7),
                                               (3, 512, 256, 64), (1, 13824, 5120, SMS)])
def test_w4a8_emulation_equals_k10_plain(rows, cin, cout, sms):
    """K10 on the W4A8 layout, walked in integers (the 16 n nibbles, the
    shares, the k order inside a 32-k step, the combine, the shift back),
    equals int4_w4a8_matmul_plain bit for bit: exact sums, then the same
    two scale multiplies in the same order. Ragged shapes, one cut into
    k-slices, a launch's most rows (16), and the 13B down projection at one
    row."""
    wq, scale, x, _, _ = _case("w4a8", rows, cin, cout, 0, False, rows + cin)
    xq, xs = Q.quantize_act_int8(x)
    plan = GP.tc_plan("w4a8", rows, cin, cout, sms)
    got = GP.tc_emulate(plan, xq, wq, scale, xs=xs)
    assert torch.equal(got, Q.int4_w4a8_matmul_plain(x, wq, scale))
    assert torch.equal(got, Q.w4a8_gemv_plain(xq, xs, wq, scale))


@pytest.mark.parametrize("prologue", [0, 1, 2])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("rows,cin,cout,sms", [(1, 640, 272, 4), (8, 1000, 144, 3)])
def test_w4a8_emulation_matches_act_int8_plain(prologue, with_residual, rows, cin, cout, sms):
    """K5's act_int8 mode on the W4A8 layout against its plain version in
    every prologue and residual form: atol 1e-4 + rtol 1e-5."""
    wq, scale, x, gamma, residual = _case("w4a8", rows, cin, cout, prologue, with_residual, rows + cin + prologue)
    plan = GP.tc_plan("w4a8", rows, cin, cout, sms)
    got = GP.tc_emulate(plan, x, wq, scale, gamma, 1e-6, prologue, residual)
    want = _plain("w4a8", x, wq, scale, gamma, prologue, residual)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_w4a8_emulation_matches_jax_k10(rows):
    """K10's emulation against the JAX int4_w4a8_matmul (its XLA path off
    the TPU: the same int8 x, an int32 dot): relative 1e-6, as
    tests/test_torch_quantize.py holds the plain version."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    cin, cout = 512, 272
    rng = np.random.default_rng(21 + rows)
    w = (rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
    x = (rng.standard_normal((rows, cin)) * 2).astype(np.float32)
    packed, scale = JQ.quantize_int4_paired(jnp.asarray(w))
    want = np.asarray(JQ.int4_w4a8_matmul(jnp.asarray(x), packed, scale))
    xq, xs = Q.quantize_act_int8(torch.from_numpy(x))
    got = GP.tc_emulate(GP.tc_plan("w4a8", rows, cin, cout, 5), xq, torch.from_numpy(np.array(packed)),
                        torch.from_numpy(np.array(scale)), xs=xs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("prologue", [0, 1, 2])
@pytest.mark.parametrize("with_residual", [False, True])
def test_w4a8_emulation_matches_jax_act_int8(prologue, with_residual):
    """K5's act_int8 mode, emulated, against the JAX int4_paired_fused_matmul
    with act_int8=True on the same fp32 x: 1e-5, as
    tests/test_torch_quantize.py holds the plain version."""
    import jax.numpy as jnp

    from supir_tpu.ops import quantize as JQ

    rows, cin, cout = 3, 384, 144
    rng = np.random.default_rng(31 + prologue)
    w = (rng.standard_normal((cin, cout)) * cin ** -0.5).astype(np.float32)
    x = (rng.standard_normal((rows, 2 * cin if prologue == 2 else cin)) * 2).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(cin)).astype(np.float32) if prologue == 1 else None
    residual = rng.standard_normal((rows, cout)).astype(np.float32) if with_residual else None
    packed, scale = JQ.quantize_int4_paired(jnp.asarray(w))
    want = JQ.int4_paired_fused_matmul(jnp.asarray(x), packed, scale,
                                       gamma=None if gamma is None else jnp.asarray(gamma), eps=1e-6,
                                       siluglu=prologue == 2, act_int8=True,
                                       residual=None if residual is None else jnp.asarray(residual))
    got = GP.tc_emulate(GP.tc_plan("w4a8", rows, cin, cout, 5), torch.from_numpy(x),
                        torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale)),
                        None if gamma is None else torch.from_numpy(gamma), 1e-6, prologue,
                        None if residual is None else torch.from_numpy(residual))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_w4a8_register_rules_decode_the_packer():
    """Every byte of every A register a lane builds in a 32-k step holds
    16 times the value the paired packer put at (column, k), and the B
    register byte it meets holds x at that same k: built from one swizzled
    stage of known values, read back through a_register and x_word_k."""
    rows, width = GP.TC_BOX_ROWS["w4a8"], GP.TC_BOX_BYTES["w4a8"]
    g_ = torch.Generator().manual_seed(4)
    vals = torch.randint(-8, 8, (2 * rows, GP.TC_STRIP), generator=g_).to(torch.int8)
    u = (vals & 0xF).to(torch.uint8)
    packed = u[0::2] | (u[1::2] << 4)                 # the paired byte: k 2p low, k 2p + 1 high
    stage = torch.zeros(rows * width, dtype=torch.uint8)
    for r in range(rows):
        for c in range(width):
            stage[GP.swizzle(r, c, width)] = packed[r, c]
    for step in range(GP.tc_steps("w4a8")):
        for warp in range(GP.TC_WARPS):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                words = [GP.a_word_offset("w4a8", r, warp, g) for r in GP.a_rows("w4a8", step, t)]
                for frag in range(2):
                    for reg in range(4):
                        col = GP.c_column(warp, g, frag, 2 * (reg & 1))
                        b_word = 2 * t + (reg >> 1)       # the B register that meets this one: word 2t or 2t + 1
                        for i, (wi, byte, nibble) in enumerate(GP.a_register("w4a8", words, frag, reg)):
                            got = GP._decode("w4a8", stage, torch.tensor(words[wi] + byte),
                                             torch.tensor(nibble)).item()
                            k = 32 * step + GP.x_word_k("w4a8", b_word)[i]
                            assert got == 16 * vals[k, col].item(), (step, warp, lane, frag, reg, i)
