"""The plan of the tensor-core decode GEMV (`csrc/quant_gemv_tc.cu`), which
K5, K6, K7 (int8 and half-split int4), K10, K5's act_int8 mode and K11
launch: how the work is
split over the SMs, how each thread maps its shared-memory words onto
`mma.sync` fragments, and how the staged activations are ordered. The
kernel walks exactly these rules; they live here so that the CPU tests
reach them (`tc_emulate` walks the plan in torch and must equal the plain
GEMVs).

Work: the weights [wrows, wcols] bytes (paired or half-split int4, and
W4A8's paired int4, wrows = cin / 2, wcols = cout; int8, cin x cout;
native int4 column pairs, cin x cout / 2) are cut into strips of TC_STRIP
output columns (one TMA box row: 128 bytes, or 64 native bytes) and chunks
of TC_CHUNK_K values of the contraction (one TMA box: 64 packed rows or
128 int8 or native rows), and each strip's chunks into `slices` contiguous
k-slices. A tile is one (strip, slice), numbered slice-major, and block b
of a grid of G takes the tiles b, b + G, b + 2G, ...: at any moment the
blocks work on one or two neighbouring k-slices of every strip, so the
rows they read are read whole (a DRAM page is opened once, not once per
block), and each block's work is within one tile of equal. `slices` is
chosen per shape (`_choose_slices`): the most even split, traded against
the partial sums it writes. A strip of one slice is stored by its tile's
block; the slices of a strip are summed from their partials in slice order
by the block that took its last slice (in the final round), so two runs
give the same bits.

Threads: 4 groups of 32 columns of the strip, TC_PARTS consumer warps each,
each taking a part of every chunk's 16-k steps into `acc_sets(nt)`
accumulator sets; at the tile's end each warp sums its sets in order, and
the parts are summed in part order. Lane (g = lane / 4, t = lane % 4)
reads, per weight row it needs, the bytes of its 4 columns in the swizzle
TMA writes (`swizzle`): paired and half-split rows 2t and 2t + 1 of each
8-row (16 k) step, one 4-byte word each; int8 rows 2t, 2t + 1, 2t + 8,
2t + 9 of each 16-row step, a word each; native the same rows, 2 bytes
each. Each load of a warp meets no bank twice. Columns 4g + 2F and
4g + 2F + 1 of the warp's 32 are rows g and g + 8 of A fragment F (F = 0,
1). A paired byte holds k = 2p and 2p + 1 of one column, one bf16x2
register of A; the rows 2t and 2t + 1 the lane reads stand for the
fragment's k pairs t and t + 4, a permutation of k inside the 16-k step
that the activations are staged in too. A half-split byte holds k = p and
p + cin / 2: the same A path, with the pair standing for (p, p + cin / 2).
In int8 the fragments' k order is the natural one. A native byte holds
columns 4g + 2F and 4g + 2F + 1 of one k, rows g and g + 8 of fragment F:
its low nibbles in rows 2t and 2t + 1 make one A register, its high
nibbles the next, in the natural k order.

Activations: x' (bf16, after K5's prologue) is staged per row as 32-bit
words, 8 per 16-k step: the word of k pair p at (p % 4) * 2 + p // 4, so
that a lane's two B registers (pairs t and t + 4) are one 8-byte load; rows
are `xrs` words apart (8 mod 32: the 8-byte loads of a warp meet no bank
twice). In the half-split layout a step is 8 packed rows p0..p0 + 7 and
its word of packed row p holds (x[p], x[p + cin / 2]).

W4A8 (K10, and K5's act_int8 mode): the paired weights against int8
activations on `mma.sync.m16n8k32` s8 x s8 -> s32, so a step is 32 k (16
packed rows, 4 a chunk). Lane (g, t) reads packed rows 2t, 2t + 1, 2t + 8
and 2t + 9 of the step (the int8 layout's rows), a word of its 4 columns
each. A register of A holds one column's 4 k of a row pair, its bytes in
the order (4t, 4t + 2, 4t + 1, 4t + 3): a byte permute joins the column's
bytes of the two rows, and its nibbles become bytes of value 16 n without a
sign extension (the high nibble masked in place, the low one shifted up and
masked), so the int32 sums are 16 times the dot, exact, and the combine
shifts them back. x is staged as int8, 4 to a word, 8 words a step: the
word of k quad q at (q % 4) * 2 + q // 4 (so a lane's two B registers, quads
t and t + 4, are one 8-byte load), its bytes in the A registers' order. K10
takes int8 x with its row scales xs; K5's act_int8 mode runs the prologue in
fp32, takes each row's absmax and quantizes as it stages. The scales are
applied once per output, in each function's order: K10 (acc * scale) *
(xs / 127), K5 (acc * (xs / 127)) * scale (+ residual). A W4A8 launch takes
at most TC_W4A8_ROWS rows.

K9 (`PairPlan`): two paired plans over one grid, small = glue(x) W1 s1 +
residual, then big = bf16(RMSNorm(small) gamma) W2 s2. Each block walks
its phase-1 tiles, then its phase-2 tiles, on one ring: the producer runs
on into W2's boxes, which do not depend on `small`. A phase-1 strip is
final when its tile's block stores it (one slice) or its last-slice owner
combines it; that block then writes the strip's per-row sum of squares of
`small` and counts the strip in on a device counter (release). Before any
phase-2 staging every block waits until all phase-1 strips are counted in
(acquire), sums the strips' squares in a fixed order, so that every block
takes the same rstd, and stages x' from `small` in fp32. `pair_schedule`
runs the blocks' programs under those counters, `tc_emulate_pair` the
arithmetic.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

TC_STRIP = 128      # output columns per strip: one TMA box row
TC_CHUNK_K = 128    # contraction values per chunk (a ring stage)
TC_WARPS = 4        # column groups of 32 columns
TC_MAX_ROWS = 32    # activation rows a launch takes (DECODE_ROWS)
TC_W4A8_ROWS = 16   # W4A8's rows a launch: it has no 4-tile instance (csrc/quant_gemv_tc.cu:launch_nt)
TC_BOX_ROWS = {"paired": 64, "half": 64, "int8": 128, "native": 128, "w4a8": 64}      # weight rows per chunk
TC_BOX_BYTES = {"paired": 128, "half": 128, "int8": 128, "native": 64, "w4a8": 128}   # a strip's bytes of a row
TC_STAGES = {"paired": 16, "half": 16, "int8": 8, "native": 16, "w4a8": 16}           # ring depth: 128 KB each
TC_STEP_K = {"paired": 16, "half": 16, "int8": 16, "native": 16, "w4a8": 32}          # contraction values a step
TC_XS_BYTES = 57344                         # staged-x' budget
TC_MAX_STRIPS = 4096                        # the per-strip counters a device keeps
TC_PART_BYTES = 16 * 2 ** 20                # the partial-sum scratch a device keeps
TC_RED_BYTES = TC_WARPS * 32 * 32 * 4       # the step halves' sums: 32 lanes x up to 32 floats a group
# csrc/quant_gemv_tc.cu's planted faults (tests and chip_smoke only); then
# W4A8's: the row scale applied twice; and K9's: phase 2 does not wait for
# phase 1's strips (it reads `small` as it stood at launch), phase 2's
# statistics from the first strip's sums of squares alone; (K9) the combine
# run twice is phase 1's
FAULT_DROP_SHARE, FAULT_COMBINE_TWICE, FAULT_X_ORDER, FAULT_ROW_SCALE, FAULT_STALE_SMALL = 1, 2, 3, 4, 5
FAULT_ONE_STRIP = 6
PAIR_COUNTERS = 2   # after the two phases' strip counters: the phase-1 strips counted in, the blocks through
# wcols last: only the C entry reads it, and the fields the kernel reads keep
# their offsets (moving them reschedules the kernel's code)
PLAN_FIELDS = ("rows", "cin", "cout", "wrows", "strips", "chunks", "slices", "tiles", "grid", "wch", "xrs",
               "smem", "nt", "stages", "box_rows", "wcols")


TC_PARTS = 2        # consumer warps per column group: part p takes steps [4p, 4p + 4) of every chunk


def tc_steps(mode: str) -> int:
    """Steps of a chunk: 8 of 16 k, or W4A8's 4 of 32 k."""
    return TC_CHUNK_K // TC_STEP_K[mode]


def acc_sets(nt: int, mode: str = "paired") -> int:
    """Accumulator sets per warp (csrc/quant_gemv_tc.cu:TcWarps::SETS, at
    most a part's steps of a chunk: TcSets): a part's i-th step adds into
    set i % sets; the sets are summed in order at the tile's end, then the
    parts in order."""
    return min(4 if nt == 1 else (2 if nt == 2 else 1), tc_steps(mode) // TC_PARTS)


def tc_eligible(mode: str, cin: int, cout: int, w_ptr: int, x_ptr: int, ldx: int) -> bool:
    """Whether the TMA body takes this call: a weight row stride that is a
    multiple of 16 bytes (cout % 16 == 0; native, whose rows are cout / 2
    bytes: cout % 32 == 0), a 16-byte aligned weight base, and activation
    rows (and SiLU-GLU's second half, cin % 8 == 0; the half-split
    layout's second half, cin % 16 == 0) that start 16-byte aligned.
    W4A8's int8 x rows then start 8-byte aligned. Anything else keeps the
    strip body of quant_gemv.cuh."""
    return (mode in TC_BOX_ROWS and cin % (16 if mode == "half" else 8) == 0
            and cout % (32 if mode == "native" else 16) == 0 and w_ptr % 16 == 0 and x_ptr % 16 == 0
            and ldx % 8 == 0)


@dataclasses.dataclass(frozen=True)
class TcPlan:
    mode: str
    rows: int       # activation rows B
    cin: int
    cout: int
    wrows: int      # weight rows: cin / 2 (paired, half) or cin (int8, native)
    wcols: int      # bytes of a weight row: cout, or cout / 2 (native)
    strips: int
    chunks: int     # chunks per strip
    slices: int     # k-slices per strip
    tiles: int      # strips * slices
    grid: int       # blocks, at most one per SM
    wch: int        # chunks of x' one staging holds
    xrs: int        # staged-x' row stride, 32-bit words
    smem: int       # dynamic shared memory, bytes
    nt: int         # n-tiles of 8 rows: 1, 2 or 4
    stages: int
    box_rows: int

    @property
    def box_bytes(self) -> int:
        """A box row's bytes, which is also the TMA swizzle's span."""
        return TC_BOX_BYTES[self.mode]

    def slice_chunks(self, p: int) -> tuple[int, int]:
        """Slice p's chunks [c0, c1)."""
        return p * self.chunks // self.slices, (p + 1) * self.chunks // self.slices

    def tile(self, t: int) -> tuple[int, int]:
        """Tile t's (strip, slice)."""
        return t % self.strips, t // self.strips

    def tiles_of(self, b: int) -> range:
        """Block b's tiles, in the order it takes them."""
        return range(b, self.tiles, self.grid)

    def contributors(self, strip: int) -> list[int]:
        """The tiles of `strip`, in the order the combine adds their partials."""
        return [p * self.strips + strip for p in range(self.slices)]

    def packed(self):
        return _packed(self)


@functools.lru_cache(maxsize=1024)
def _packed(plan: TcPlan):
    return (ctypes.c_int * len(PLAN_FIELDS))(*(getattr(plan, f) for f in PLAN_FIELDS))


def _makespan(strips: int, chunks: int, slices: int, grid: int) -> int:
    """The most chunks one block streams when `slices` k-slices per strip
    are dealt round-robin over `grid` blocks."""
    size = [(p + 1) * chunks // slices - p * chunks // slices for p in range(slices)]
    tiles = strips * slices
    return max(sum(size[t // strips] for t in range(b, tiles, grid)) for b in range(min(grid, tiles)))


def _choose_slices(strips: int, chunks: int, grid: int, rows: int, chunk_bytes: int) -> int:
    """The k-slices per strip: the least of (the bytes the busiest block
    streams + a chunk a tile for its end + a quarter of the partial sums it
    writes and the combine reads back, which stay in L2 + the combine's
    wait, a quarter chunk a slice), the fewest slices on a tie, within the
    device's partial-sum scratch."""
    best = None
    for slices in range(1, chunks + 1):
        tiles = strips * slices
        if slices > 1 and tiles * rows * TC_STRIP * 4 > TC_PART_BYTES:
            break
        per_block = -(-tiles // grid)
        part = 0 if slices == 1 else per_block * rows * TC_STRIP * 4 * 2
        # each tile's end holds the consumers about a chunk's streaming time,
        # and the combine waits on one L2 read per slice, 8 at a time: about a
        # quarter chunk a slice
        cost = ((_makespan(strips, chunks, slices, grid) + per_block) * chunk_bytes + part // 4
                + slices * chunk_bytes // 4)
        if best is None or cost < best[0]:
            best = (cost, slices)
    return best[1]


@functools.lru_cache(maxsize=1024)
def tc_plan(mode: str, rows: int, cin: int, cout: int, sms: int, slices: int | None = None) -> TcPlan:
    """The plan of one launch: `rows` activation rows against [cin, cout]
    weights in `mode` ("paired", "half", "int8", "native" or "w4a8") on a
    card of `sms` SMs. `slices` (the probes' geometry: T1c, T2, T3b, T4b)
    replaces `_choose_slices`' k-slices per strip; the model paths never
    pass it."""
    if mode not in TC_BOX_ROWS:
        raise ValueError(f"the tensor-core GEMV takes the layouts {sorted(TC_BOX_ROWS)}, not {mode}")
    most = TC_W4A8_ROWS if mode == "w4a8" else TC_MAX_ROWS
    if not 1 <= rows <= most:
        raise ValueError(f"the tensor-core GEMV ({mode}) takes 1-{most} activation rows a launch, got {rows}")
    kmod, cmod = 16 if mode == "half" else 8, 32 if mode == "native" else 16
    if cin <= 0 or cin % kmod or cout <= 0 or cout % cmod:
        raise ValueError(f"the tensor-core GEMV ({mode}) needs cin % {kmod} == 0 and cout % {cmod} == 0, got "
                         f"{cin}, {cout}")
    box_rows = TC_BOX_ROWS[mode]
    wrows = cin // 2 if mode in ("paired", "half", "w4a8") else cin
    wcols = cout // 2 if mode == "native" else cout
    strips = -(-cout // TC_STRIP)
    if strips > TC_MAX_STRIPS:
        raise ValueError(f"cout {cout} has more than {TC_MAX_STRIPS} strips")
    chunks = -(-wrows // box_rows)
    stage_bytes = box_rows * TC_BOX_BYTES[mode]
    if slices is None:
        slices = _choose_slices(strips, chunks, sms, rows, stage_bytes)
    elif not 1 <= slices <= chunks or (slices > 1 and strips * slices * rows * TC_STRIP * 4 > TC_PART_BYTES):
        raise ValueError(f"{slices} k-slices of {chunks} chunks over {strips} strips at {rows} rows: a slice needs a "
                         f"chunk and the partials must fit the {TC_PART_BYTES}-byte scratch")
    tiles = strips * slices
    grid = min(tiles, sms)
    nt = 1 if rows <= 8 else (2 if rows <= 16 else 4)
    # x' staging: `rows` rows of wch chunks (64 words each, W4A8's int8 32)
    # plus 8 words of pad
    words = chunk_words(mode)
    wch = max(1, min(chunks, (TC_XS_BYTES // (4 * rows) - 8) // words))
    xrs = words * wch + 8
    stages = TC_STAGES[mode]
    smem = _smem(stages * stage_bytes, 4 * rows * xrs, 3 if mode == "w4a8" else 1, stages)
    return TcPlan(mode, rows, cin, cout, wrows, wcols, strips, chunks, slices, tiles, grid, wch, xrs, smem, nt, stages,
                  box_rows)


def _smem(ring: int, window: int, row_floats: int, stages: int) -> int:
    """Dynamic shared memory: ring | x' window | the step halves' sums |
    rstd (W4A8: and the rows' 127 / xs and xs / 127) | finished tiles |
    barriers (+ go) | alignment slack."""
    return ring + -(-window // 16) * 16 + TC_RED_BYTES + 4 * TC_MAX_ROWS * row_floats + 16 + 16 * stages + 8 + 1024


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """K9's launch: two paired plans walked by one grid of `grid` blocks,
    one per SM (a cooperative launch, so that every block is resident
    while the others wait for phase 1's strips)."""
    first: TcPlan       # glue(x) [rows, cin1] @ W1 -> small [rows, cout1]
    second: TcPlan      # x' [rows, cout1] @ W2 -> big [rows, cout2]
    grid: int
    smem: int           # the ring, the larger phase's x' window, the rest as tc_plan's

    def packed(self):
        return _pair_packed(self)


@functools.lru_cache(maxsize=256)
def _pair_packed(plan: PairPlan):
    fields = [getattr(p, f) for p in (plan.first, plan.second) for f in PLAN_FIELDS] + [plan.grid, plan.smem]
    return (ctypes.c_int * len(fields))(*fields)


def tc_pair_eligible(rows: int, cin1: int, cout1: int, cout2: int, w1_ptr: int, w2_ptr: int, x_ptr: int,
                     ldx: int) -> bool:
    """Whether K9 runs on the tensor-core body: both weights as
    `tc_eligible("paired", ...)` takes them (`small` is the wrapper's own,
    16-byte aligned, rows cout1 floats apart), at most TC_MAX_ROWS rows, and
    room for both phases' strip counters."""
    return (1 <= rows <= TC_MAX_ROWS and tc_eligible("paired", cin1, cout1, w1_ptr, x_ptr, ldx)
            and tc_eligible("paired", cout1, cout2, w2_ptr, 0, cout1)
            and -(-cout1 // TC_STRIP) + -(-cout2 // TC_STRIP) + PAIR_COUNTERS <= TC_MAX_STRIPS)


@functools.lru_cache(maxsize=256)
def tc_pair_plan(rows: int, cin1: int, cout1: int, cout2: int, sms: int) -> PairPlan:
    """K9's plan on a card of `sms` SMs: each phase as K5 would launch it
    (its slices cut for the whole grid). Both phases' partial sums share the
    device's scratch: phase 2 writes its first partial only after every
    phase-1 combine has read its own."""
    first = tc_plan("paired", rows, cin1, cout1, sms)
    second = tc_plan("paired", rows, cout1, cout2, sms)
    if first.strips + second.strips + PAIR_COUNTERS > TC_MAX_STRIPS:
        raise ValueError(f"K9 at cout1 {cout1}, cout2 {cout2} needs more than {TC_MAX_STRIPS} strip counters")
    window = 4 * rows * max(first.xrs, second.xrs)
    smem = _smem(first.stages * first.box_rows * first.box_bytes, window, 1, first.stages)
    return PairPlan(first, second, max(first.grid, second.grid), smem)


def chunk_words(mode: str) -> int:
    """Staged 32-bit words of x' a chunk takes per row: bf16 two to a
    word, W4A8's int8 four."""
    return TC_CHUNK_K // (4 if mode == "w4a8" else 2)


# ------------------------------------------------- the kernel's index rules
# Each mirrors one expression of csrc/quant_gemv_tc.cu.


def swizzle(row: int, col: int, width: int = TC_STRIP) -> int:
    """Byte offset in a stage of weight byte (row, col) of a box `width`
    bytes wide, as TMA writes it in the swizzle of that span (128 or 64
    bytes): address bits 4.. (the 16-byte chunk) XOR bits 7.. of the same
    address. At 128 bytes chunk c of row r lands at c ^ (r % 8); at 64
    bytes at c ^ (r / 2 % 4)."""
    addr = row * width + col
    return addr ^ (((addr >> 7) & (width // 16 - 1)) << 4)


def a_rows(mode: str, step: int, t: int) -> tuple[int, ...]:
    """The stage rows lane (., t) reads in step `step`: paired and
    half-split 2t, 2t+1 of the 16-k step's 8 packed rows; int8 and native
    2t, 2t+1, 2t+8, 2t+9 of its 16 rows, W4A8 the same of its 32-k step's
    16 packed rows."""
    if mode in ("paired", "half"):
        r = 8 * step + 2 * t
        return r, r + 1
    r = 16 * step + 2 * t
    return r, r + 1, r + 8, r + 9


def a_word_offset(mode: str, row: int, warp: int, g: int) -> int:
    """Byte offset of the piece lane (g, .) of `warp` reads from stage row
    `row`: columns 32 warp + 4g .. + 3, a 4-byte word, or in the native
    layout their 2 bytes 16 warp + 2g, + 1 of a 64-byte row."""
    if mode == "native":
        return row * 64 + ((warp ^ ((row >> 1) & 3)) << 4) + 2 * g
    chunk = 2 * warp + (g >> 2)
    return row * TC_STRIP + ((chunk ^ (row & 7)) << 4) + 4 * (g & 3)


def a_register(mode: str, words, frag: int, reg: int):
    """Register `reg` (0-3) of A fragment `frag` from the lane's words: as
    (word index, byte index, nibble) for each of its two bf16 halves (low
    half first); nibble is 0 (low), 1 (high) or None (an int8 byte).
    reg 0: row g, k pair t; 1: row g + 8, pair t; 2: row g, pair t + 4;
    3: row g + 8, pair t + 4 (the PTX m16n8k16 A layout). W4A8 (m16n8k32):
    its four bytes, each (word index, byte index, nibble), the nibble taken
    as 16 n; reg 0: row g, k 4t..4t+3 (rows 2t, 2t + 1), 1: row g + 8, the
    same k, 2 and 3: k 16 + 4t.. (rows 2t + 8, 2t + 9); the bytes hold k 4t,
    4t + 2, 4t + 1, 4t + 3 in that order."""
    first = 2 * (reg >> 1)                # k 2t, 2t+1: rows 2t, 2t+1; k + 8: rows 2t+8, 2t+9
    if mode == "w4a8":                    # byte 2 frag (+1 for row g + 8) of the row pair: low nibbles, then high
        byte = 2 * frag + (reg & 1)
        return (first, byte, 0), (first + 1, byte, 0), (first, byte, 1), (first + 1, byte, 1)
    if mode == "native":                  # byte frag: columns 4g + 2 frag (low), + 1 (high nibble)
        return (first, frag, reg & 1), (first + 1, frag, reg & 1)
    byte = 2 * frag + (reg & 1)           # column 4g + 2 frag (+1 for row g + 8)
    if mode in ("paired", "half"):
        word = reg >> 1                   # pair t: row 2t; pair t + 4: row 2t + 1
        return (word, byte, 0), (word, byte, 1)
    return (first, byte, None), (first + 1, byte, None)


def x_word_k(mode: str, pos: int, fault: int = 0) -> tuple[int, ...]:
    """The values (indices into a step's 16, or W4A8's 32, `step_values`)
    of staged word `pos`, low half (byte) first. In the paired layout the
    lanes' row order and the word interleave cancel, so its words hold k in
    natural order; in the half-split layout word pos holds packed row pos's
    two halves; in W4A8 word pos holds k quad (pos >> 1) + 4 (pos & 1) in
    the A registers' byte order. FAULT_X_ORDER drops the interleave (word pos
    holds k pair or quad pos), and in the half-split layout stages the
    step's values in natural order."""
    if mode == "w4a8":
        quad = pos if fault == FAULT_X_ORDER else (pos >> 1) + 4 * (pos & 1)
        return 4 * quad, 4 * quad + 2, 4 * quad + 1, 4 * quad + 3
    if mode == "half":
        return (2 * pos, 2 * pos + 1) if fault == FAULT_X_ORDER else (pos, pos + 8)
    pair = pos if fault == FAULT_X_ORDER else (pos >> 1) + 4 * (pos & 1)   # pair p sits at (p % 4) * 2 + p // 4
    if mode == "paired":
        row = 2 * pair if pair < 4 else 2 * (pair - 4) + 1
        return 2 * row, 2 * row + 1
    return 2 * pair, 2 * pair + 1


def c_column(warp: int, g: int, frag: int, reg: int) -> int:
    """Strip column of accumulator register `reg` (0-3) of fragment `frag`:
    c0, c1 row g, c2, c3 row g + 8 of the fragment."""
    return 32 * warp + 4 * g + 2 * frag + (reg >> 1)


# ------------------------------------------------------- torch emulation


def _prologue_bf16(x, cin, gamma, eps, prologue, dtype=torch.bfloat16):
    """x' as the kernel stages it: fp32 prologue rounded to bf16 (or to
    `dtype`), as float."""
    xf = x.float()
    if prologue == 1:
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xf = (xf * rstd) * gamma.float()
    elif prologue == 2:
        a = xf[:, :cin]
        xf = (a * torch.sigmoid(a)) * xf[:, cin:2 * cin]
    return xf[:, :cin].to(dtype).float()


def step_values(mode: str, xp, chunks: int) -> torch.Tensor:
    """x' [B, cin] -> [B, steps, TC_STEP_K], the values each step stages
    its words from (zeros past the weight's edge): k0..k0 + 15 (W4A8: the
    int8 x of k0..k0 + 31), or in the half-split layout x[p0..p0 + 7] then
    x[h + p0 .. h + p0 + 7] for the step's packed rows p0..p0 + 7, h = cin
    / 2."""
    B, cin = xp.shape
    kpad = chunks * TC_CHUNK_K
    if mode != "half":
        return torch.nn.functional.pad(xp, (0, kpad - cin)).reshape(B, -1, TC_STEP_K[mode])
    h, hpad = cin // 2, kpad // 2
    lo = torch.nn.functional.pad(xp[:, :h], (0, hpad - h)).reshape(B, -1, 8)
    hi = torch.nn.functional.pad(xp[:, h:], (0, hpad - h)).reshape(B, -1, 8)
    return torch.cat([lo, hi], -1)


def _decode(mode, stage, offs, nibble):
    """Bytes of a stage image at offsets -> values: an int4 nibble or an
    int8 byte as float; W4A8's nibble as the kernel makes it, the s8 byte 16
    n (the high nibble masked in place, the low one shifted up and masked),
    as int64."""
    b = stage[offs]
    if mode == "w4a8":
        return torch.where(nibble == 1, b, b << 4).bitwise_and(0xF0).to(torch.int8).to(torch.int64)
    if mode != "int8":
        v = (b >> (4 * nibble)) & 0xF
        return ((v ^ 8) - 8).float()
    return b.to(torch.int8).float()


# The decodes of csrc/tc_decode.cuh, bit for bit on int64 tensors of 32-bit
# words (the nibble-order check T3a walks them in ops/probes.py:
# unpack_emulate; `_decode` above is what they amount to per byte).


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes y:x (0-3 from x, 4-7 from y)."""
    out = torch.zeros_like(x)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= (((x if src < 4 else y) >> (8 * (src & 3))) & 0xFF) << (8 * i)
    return out


def nib2_sel(w: torch.Tensor, w4: torch.Tensor, sel: int, signed: bool = True) -> torch.Tensor:
    """tc_decode.cuh's nib2_sel: the low nibbles of bytes 0 and 2 of
    byte_perm(w, w4, sel) as a bf16x2 word, by the lop3 ((r & 0x000F000F) ^
    0x43084308; `signed` False drops the ^ 8) and the hsub2 of 136, each
    half rounded to bf16 as the hsub2 rounds it."""
    r = byte_perm(w, w4, sel)
    bits = (r & 0x000F000F) ^ (0x43084308 if signed else 0x43004300)
    halves = torch.stack([bits & 0xFFFF, bits >> 16])
    diff = ((halves.to(torch.int32) << 16).view(torch.float32) - 136.0).to(torch.bfloat16)
    h = diff.view(torch.int16).to(torch.int64) & 0xFFFF
    return h[0] | (h[1] << 16)


def nib2(w: torch.Tensor, w4: torch.Tensor, i: int, signed: bool = True, swap: bool = False) -> torch.Tensor:
    """tc_decode.cuh's nib2: byte i's two nibbles, low in the low half
    (`swap` mirrors the selector)."""
    return nib2_sel(w, w4, (4 + i) | (i << 8) if swap else i | ((4 + i) << 8), signed)


def quad16(wa: torch.Tensor, wb: torch.Tensor, f: int, swap: bool = False):
    """tc_decode.cuh's quad16: the W4A8 A registers (lo, hi) of columns 2f
    and 2f + 1 of a word pair, each byte an s8 of value 16 n, in the k order
    (row a low, row b low, row a high, row b high); `swap` mirrors the
    sorting permutes."""
    u = byte_perm(wa, wb, (2 * f) | ((4 + 2 * f) << 4) | ((2 * f + 1) << 8) | ((5 + 2 * f) << 12))
    h = u & 0xF0F0F0F0
    low = (u << 4) & 0xF0F0F0F0
    return byte_perm(low, h, 0x1054 if swap else 0x5410), byte_perm(low, h, 0x3276 if swap else 0x7632)


def bf16x2_floats(v: torch.Tensor):
    """A bf16x2 word's halves as floats, (low, high)."""
    return tuple(((v >> s) & 0xFFFF).to(torch.int32).bitwise_left_shift(16).view(torch.float32) for s in (0, 16))


@functools.lru_cache(maxsize=8)
def _fragment_maps(mode: str):
    """Index maps of one warp's step: for each warp, step, fragment and A
    element (m, kl): the stage byte offset and nibble it decodes; for each B
    element kl: the staged word position and its piece (bf16 half or int8
    byte). kl is the fragment's k: register byte (or half) i of lane t holds
    kl = per t + i (+ TC_STEP_K / 2 for the second register), per = 2 values
    a register (bf16) or 4 (W4A8). Built from the lane-level rules above,
    through the PTX fragment layouts."""
    steps, ksteps = tc_steps(mode), TC_STEP_K[mode]
    per = ksteps // 8
    offs = torch.zeros(TC_WARPS, steps, 2, 16, ksteps, dtype=torch.long)
    nib = torch.zeros(TC_WARPS, steps, 2, 16, ksteps, dtype=torch.long)
    for warp in range(TC_WARPS):
        for step in range(steps):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                words = [a_word_offset(mode, r, warp, g) for r in a_rows(mode, step, t)]
                for frag in range(2):
                    for reg in range(4):
                        m = g + 8 * (reg & 1)
                        for i, (wi, byte, nibble) in enumerate(a_register(mode, words, frag, reg)):
                            kl = per * t + i + 4 * per * (reg >> 1)
                            offs[warp, step, frag, m, kl] = words[wi] + byte
                            nib[warp, step, frag, m, kl] = nibble or 0
    # b0: kl per t .. per t + per - 1 (word 2t), b1: the same + ksteps / 2 (word 2t + 1): one 8-byte load
    kl = torch.arange(ksteps)
    reg, t = kl // (ksteps // 2), (kl % (ksteps // 2)) // per
    return offs, nib, 2 * t + reg, kl % per


def tc_emulate(plan: TcPlan, x, w, scale, gamma=None, eps: float = 1e-6, prologue: int = 0, residual=None,
               fault: int = 0, xs=None, stage_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic on the CPU, walking `plan`: per block its
    tiles; per chunk of a tile each warp's steps as products of the A
    fragments decoded from a TMA-swizzled stage image and the B fragments
    read from the staged x', summed per part of the chunk's steps and per
    accumulator set, the sets and then the parts added at the tile's end in
    order; per strip a direct store or its slices' partials combined in
    slice order. The tensor cores' sums inside a step are taken as fp32
    matmuls; W4A8's as int64 ones, walked in integers to the combine's
    shift, then its two scale multiplies in the kernel's order. W4A8: x int8
    with its row scales `xs` [B, 1] (K10), or, without xs, x in bf16 or fp32
    through K5's fp32 prologue and the plain per-row quantizer (K5's
    act_int8 mode; the card takes the prologue's statistics in another
    order). `fault` plants csrc/quant_gemv_tc.cu's faults. x' is staged
    in bf16 as the kernel stages it, or in `stage_dtype`: fp32 walks the
    same plan at the fp32 plain versions' precision."""
    mode, B, cin, cout = plan.mode, plan.rows, plan.cin, plan.cout
    w4a8 = mode == "w4a8"
    offs, nib, bpos, bhalf = _fragment_maps(mode)
    nparts, nsets = TC_PARTS, acc_sets(plan.nt, mode)
    steps, box_rows, width = offs.shape[1], plan.box_rows, plan.box_bytes
    dtype = torch.int64 if w4a8 else torch.float32
    quantized = xs is not None
    if w4a8:
        if not quantized:
            from supir_tpu_torch.ops.quantize import _prologue, quantize_act_int8

            x, xs = quantize_act_int8(_prologue(x, cin, gamma, eps, prologue == 2))
        xp = x.to(torch.int64)                                               # [B, cin]
    else:
        xp = _prologue_bf16(x, cin, gamma, eps, prologue, stage_dtype)      # [B, cin]
    # staged words: word position pos of step holds values x_word_k(pos) of the step
    src = torch.tensor([x_word_k(mode, pos, fault) for pos in range(8)])   # [8, per]
    staged = step_values(mode, xp, plan.chunks)[:, :, src]                  # [B, steps, 8, per]
    blog = staged[:, :, bpos, bhalf]                                        # [B, steps, k]: the fragments' k
    wbytes = w.view(torch.uint8) if w.dtype == torch.int8 else w
    wpad = torch.zeros(plan.chunks * box_rows, plan.strips * width, dtype=torch.uint8)
    wpad[: plan.wrows, : plan.wcols] = wbytes
    scatter = torch.tensor([[swizzle(r, c, width) for c in range(width)] for r in range(box_rows)])
    col_of = torch.tensor([[[c_column(warp, m % 8, frag, 2 * (m // 8)) for m in range(16)] for frag in range(2)]
                           for warp in range(TC_WARPS)])                    # [warps, 2, 16]
    part_of = [next(q for q in range(nparts) if step < steps * (q + 1) // nparts) for step in range(steps)]
    partials = {}
    out = torch.zeros(B, plan.strips * TC_STRIP, dtype=dtype)
    for b in range(plan.grid):
        for t in plan.tiles_of(b):
            s, p = plan.tile(t)
            acc = torch.zeros(nparts, nsets, TC_WARPS, 2, 16, B, dtype=dtype)   # per part and set of each chunk's steps
            c0, c1 = plan.slice_chunks(p)
            for j in range(c0, c1):
                if fault == FAULT_DROP_SHARE and b == 0:
                    continue
                stage = torch.zeros(box_rows * width, dtype=torch.uint8)
                stage[scatter.flatten()] = wpad[j * box_rows:(j + 1) * box_rows, s * width:(s + 1) * width].flatten()
                a = _decode(mode, stage, offs, nib)                                # [warps, steps, 2, 16 m, k]
                prods = torch.einsum("wsfmk,bsk->swfmb", a, blog[:, j * steps:(j + 1) * steps])
                for step in range(steps):
                    part = part_of[step]
                    acc[part, (step - steps * part // nparts) % nsets] += prods[step]
            total = None
            for part in range(nparts):
                psum = acc[part, 0]
                for q in range(1, nsets):
                    psum = psum + acc[part, q]
                total = psum if total is None else total + psum
            cols = s * TC_STRIP + col_of.flatten()
            vals = total.reshape(-1, B).T                                          # [B, 128] by col_of
            if plan.slices == 1:
                out[:, cols] = vals
            else:
                partials[t] = (cols, vals)
    if plan.slices > 1:
        for s in range(plan.strips):
            total = None
            for t in plan.contributors(s):
                cols, vals = partials[t]
                total = vals if total is None else total + vals
            if fault == FAULT_COMBINE_TWICE:
                total = total + total
            out[:, cols] = total
    out = out[:, :cout]
    sc = scale.float().reshape(1, -1)
    if w4a8:
        out = (out >> 4).float()                       # the products were taken at 16 n: exact
        rs = xs.float().reshape(-1, 1) * (1.0 / 127.0)
        if fault == FAULT_ROW_SCALE:
            rs = rs * rs
        out = (out * sc) * rs if quantized else (out * rs) * sc
    else:
        out = out * sc
    if residual is not None:
        out = out + residual.float()
    return out


# ---------------------------------------------------------------- K9's pair


def pair_schedule(plan: PairPlan, fault: int = 0):
    """Run the consumers' programs of K9's blocks, one step of each ready
    block per round, under the counters that order them, as the kernel
    does: phase-1 tiles (each but a last slice counted in on its strip), the
    block's phase-1 combines (each waiting for its strip's other slices),
    one release of the strips it made final, the wait for every phase-1
    strip (FAULT_STALE_SMALL leaves it out), then phase 2's tiles and
    combines. A block knows the strips it made final itself and, once it
    has waited, every strip released before. Returns the events in the
    order they ran, (block, what, strip or tile), and whether every phase-2
    staging knew every phase-1 strip final: only then does it read
    `small` as phase 1 left it. Raises if the programs cannot end."""
    first, second = plan.first, plan.second
    progs = []
    for b in range(plan.grid):
        ops = [("tile1", t) for t in first.tiles_of(b)]
        if first.slices > 1:
            ops += [("combine1", t) for t in first.tiles_of(b) if first.tile(t)[1] == first.slices - 1]
        ops.append(("release", None))
        if fault != FAULT_STALE_SMALL:
            ops.append(("wait", None))
        for t in second.tiles_of(b):
            ops += [("stage2", t), ("tile2", t)]
        if second.slices > 1:
            ops += [("combine2", t) for t in second.tiles_of(b) if second.tile(t)[1] == second.slices - 1]
        progs.append(ops)
    counts = {1: [0] * first.strips, 2: [0] * second.strips}
    final = [set() for _ in range(plan.grid)]      # strips this block made final, not yet released
    known = [set() for _ in range(plan.grid)]      # phase-1 strips this block knows final
    released = set()
    pc = [0] * plan.grid
    events, ordered = [], True
    while any(pc[b] < len(progs[b]) for b in range(plan.grid)):
        moved = False
        for b in range(plan.grid):
            if pc[b] == len(progs[b]):
                continue
            what, t = progs[b][pc[b]]
            phase_plan = first if what.endswith("1") else second
            if what in ("combine1", "combine2"):
                s = phase_plan.tile(t)[0]
                if counts[int(what[-1])][s] < phase_plan.slices - 1:
                    continue
            if what == "wait" and len(released) < first.strips:
                continue
            pc[b] += 1
            moved = True
            if what in ("tile1", "tile2"):
                s, p = phase_plan.tile(t)
                if phase_plan.slices == 1 and what == "tile1":
                    final[b].add(s)
                    known[b].add(s)
                elif p < phase_plan.slices - 1:
                    counts[int(what[-1])][s] += 1
            elif what == "combine1":
                s = first.tile(t)[0]
                final[b].add(s)
                known[b].add(s)
            elif what == "release":
                released |= final[b]
            elif what == "wait":
                known[b] |= released
            elif what == "stage2":
                ordered &= len(known[b]) == first.strips
            events.append((b, what, t))
        if not moved:
            raise RuntimeError(f"K9's blocks cannot all end: {[progs[b][pc[b]] for b in range(plan.grid) if pc[b] < len(progs[b])][:4]}")
    return events, ordered


def _xor_tree(v: torch.Tensor) -> torch.Tensor:
    """A warp's butterfly sum over the last dimension (32 lanes), as
    `__shfl_xor_sync` with offsets 16 .. 1 leaves it in every lane."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def pair_rstd(small: torch.Tensor, plan: PairPlan, norm_cols: int, eps: float, fault: int = 0) -> torch.Tensor:
    """Each row's rsqrt(mean square + eps) of `small`'s first `norm_cols`
    columns in the kernel's order: per phase-1 strip the squares of each
    warp's 32 columns summed by the butterfly, the strip's four warps in
    order (the strip's sum of squares, `strip_ssq`); then lane l sums strips
    l, l + 32, ... in order (FAULT_ONE_STRIP: strip 0 alone) and the
    butterfly sums the lanes. [rows, 1]."""
    rows, cout1 = small.shape
    strips = plan.first.strips
    v = torch.zeros(rows, strips * TC_STRIP, dtype=torch.float32)
    v[:, :min(cout1, norm_cols)] = small[:, :min(cout1, norm_cols)].float()
    warp = _xor_tree((v * v).reshape(rows, strips, 4, 32))            # [rows, strips, 4]
    ssq = ((warp[..., 0] + warp[..., 1]) + warp[..., 2]) + warp[..., 3]
    lane = torch.zeros(rows, 32, dtype=torch.float32)
    for s in range(1 if fault == FAULT_ONE_STRIP else strips):
        lane[:, s % 32] += ssq[:, s]
    total = _xor_tree(lane)
    return torch.rsqrt(total / norm_cols + eps).reshape(rows, 1)


def tc_emulate_pair(plan: PairPlan, x, w1, s1, residual, gamma, w2, s2, siluglu1: bool = False,
                    eps: float = 1e-6, norm_cols: int | None = None, fault: int = 0):
    """K9's arithmetic on the CPU: phase 1 as `tc_emulate` walks
    `plan.first` (SiLU-GLU or no prologue, the residual), the strips'
    statistics in the kernel's order (`pair_rstd`, over the first
    `norm_cols` columns: all of cout1 but for planted faults), x' =
    (small * rstd) * gamma rounded as staged, and phase 2 as `tc_emulate`
    walks `plan.second`. Phase 2 reads `small` as phase 1 left it only if
    `pair_schedule` orders every phase-2 staging after every phase-1 strip;
    otherwise as it stood at launch (zeros, as the card's fault hook fills
    it). x' is staged in x's dtype: bf16 as on the card, or fp32, where the
    walk meets the fp32 plain version. `fault`: FAULT_DROP_SHARE and
    FAULT_X_ORDER in both phases, FAULT_COMBINE_TWICE in phase 1,
    FAULT_STALE_SMALL, FAULT_ONE_STRIP. Returns (small, big)."""
    dtype = x.dtype if x.dtype in (torch.bfloat16, torch.float32) else torch.float32
    cout1 = plan.first.cout
    both = fault if fault in (FAULT_DROP_SHARE, FAULT_X_ORDER) else 0
    small = tc_emulate(plan.first, x, w1, s1, None, eps, 2 if siluglu1 else 0, residual,
                       fault=both or (fault if fault == FAULT_COMBINE_TWICE else 0), stage_dtype=dtype)
    _, ordered = pair_schedule(plan, fault)
    seen = small if ordered else torch.zeros_like(small)
    rstd = pair_rstd(seen, plan, cout1 if norm_cols is None else norm_cols, eps, fault)
    xp = ((seen * rstd) * gamma.float()).to(dtype).float()
    big = tc_emulate(plan.second, xp, w2, s2, fault=both, stage_dtype=dtype)
    return small, big
