"""The decode-GEMV probes' kernels (T1-T4), their plain versions and launch
counters: the counterparts of the Pallas kernels in the JAX package's
`tools/` probes, driven by `supir_tpu_torch/tools/`.

Kernels of `csrc/colsum_tc.cu` (its header says what bounds them and how
they are laid out): the column sum on the tensor-core GEMV body's weight
stream (K6's tile plan at one row, TMA ring, slice-order combine), with a
byte sum in place of the decode and the products:
  T1a column_sum      (tools/stream_ceiling.py:sum_kernel :48, pallas_call
      :78)  u8 [rows, cout] -> fp32 [1, cout] at one k-slice: every tile
      owns whole columns, as the TPU's 1-D grid of column blocks. The TPU
      kernel zeroes its output only at grid step 0, so with more than one
      output block every block past the first sums onto memory it never
      initialised; this one computes the column sum that was meant.
  T1b column_sum_2d   (sum2d_kernel :99, pallas_call :110)  the same sum
      with the rows cut into `slices` k-slices (the TPU's row blocks: its
      brow 1280 and 640 are 2 and 4 slices of 2560 rows), the slices'
      int32 partials summed in slice order.
  column_sum_strip    T1a's and T1b's first design (`csrc/probes.cu`, one
      block per strip x row block, fp32 atomics), kept to time them in
      turns; it counts no launch.
Kernels of `csrc/probes.cu`:
  T3a unpack_nibbles  (tools/bitcast_probe.py:order_kernel :33, :46)  u8
      [r, c] -> fp32 [2r, c], row 2i the low nibble of byte row i and 2i+1
      the high one, sign-extended: the order of quantize_int4_paired, read
      back through the GEMVs' own nibble conversion.
  T4a native_cast     (tools/int4_native_probe.py:stage2_mosaic.k :46, :50)
      column-pair-packed int4 u8 [r, c/2] -> bf16 [r, c] x 2.
  int4_single_cast_matmul_strip  T3b's first design (gemv_kernel_bitcast :63,
      :111): bf16 x @ paired int4 -> bf16 by one packed subtract per byte ->
      fp32 sums * scale, at strip 32-256; kept for timing T3b in turns.
and of `csrc/quant_gemv_tc.cu`, the model paths' tensor-core body (TMA
ring, mma.sync, k-slice tiles; ops/gemv_plan.py), with its own int4 decode
(permute, lop3, hsub2 a nibble pair) at the probes' geometry:
  T1c half_split_matmul   (forced-bout quantize.py:_qmm_kernel,
      tools/stream_ceiling.py:162)  bf16 x [B <= 32, cin] @ half-split int4
      [cin/2, cout] -> fp32 sums * scale: K7 int4's instances at `slices`
      k-slices per strip (the plan's by default). Its first design, K7's
      strip body at strips 64-256, stays reachable as
      `quantize.int4_matmul(..., strip=)`.
  T3b int4_single_cast_matmul   (tools/bitcast_probe.py:gemv_kernel_bitcast
      :63, pallas_call :111)  bf16 x [B <= 32, cin] @ paired int4 -> fp32
      sums * scale: K6's instances at `slices` k-slices per strip.
  T4b native_single_cast_matmul (tools/int4_native_probe.py:_native_kernel
      :58, pallas_call :72)  the same against column-pair-packed int4, on
      K11's instances (the first design, K11's strip body at strip 256,
      stays reachable as `quantize.int4_native_matmul(..., strip=256)`).
and of `csrc/gemv_sweep.cu` through ops/quantize.py's geometry keywords:
  T2  w4a8_preact     (tools/gemv_sweep.py:_w4a8_kernel :48, :69)  int8 x [B,
      cin] @ paired int4 -> exact int32 sums * column scale, fp32, before the
      activation scale (w4a8_matmul :58-83): K10's body with xs = 127 (so
      the row factor xs / 127 is exactly 1.0f), at strip x split-K. The
      probe's `direct` variant hands the s4 operand straight to the TPU's
      matrix unit against int8 activations; Hopper's tensor cores (wgmma,
      mma.sync) take no 4-bit operand and no mixed s8 x s4 product, so it
      has no twin here.

On a CPU tensor every function returns its plain version; on a CUDA tensor
it launches its kernel or raises. The ring column sum refuses what the
ring cannot take on either device. `_fault` selects a planted-fault instance
of a kernel (the ring column sum: RING_FAULT_*; its first design: 1 bytes
read as int8, 2 last row block dropped; unpack and cast: 1 nibbles
swapped, 2 sign not extended; T1c, T3b and T4b: one of gemv_plan.FAULT_*),
for the checks that must see a fault break their bound.
"""

from __future__ import annotations

import ctypes

import torch

from supir_tpu_torch.ops import gemv_plan as GP, quantize as Q

_SOURCE = "probes.cu"
_RING_SOURCE = "colsum_tc.cu"
SOURCES = (_SOURCE, _RING_SOURCE)
RING_FLUSH_CHUNKS = 16    # csrc/colsum_tc.cu: chunks (8 rows a lane each) between flushes of the 16-bit sums
RING_CONSUMERS = 8        # consumer warps; warp w takes rows w, w + 8, ... of a 64-row stage
# csrc/colsum_tc.cu's planted faults (tests and chip_smoke only): the bytes
# read as int8, slice 0's partial left out of the combine, the combine run twice
RING_FAULT_SIGNED, RING_FAULT_DROP_SLICE, RING_FAULT_COMBINE_TWICE = 1, 2, 3


def _library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_colsum.restype = i
    lib.supir_colsum.argtypes = [p, i, i, i, i, i, i, p, p]
    lib.supir_unpack_nibbles.restype = i
    lib.supir_unpack_nibbles.argtypes = [p, i, i, i, p, p]
    lib.supir_native_cast.restype = i
    lib.supir_native_cast.argtypes = [p, ctypes.c_longlong, i, p, p]
    lib.supir_gemv_single_cast.restype = i
    lib.supir_gemv_single_cast.argtypes = [p, i, p, p, p, i, i, i, i, p]
    return lib


def _ring_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_RING_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_colsum_ring.restype = i
    lib.supir_colsum_ring.argtypes = [p, i, i, i, i, i, p, p, p, p]
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _check_bytes(q: torch.Tensor, name: str) -> None:
    if q.dim() != 2 or q.dtype != torch.uint8 or not q.is_contiguous():
        raise ValueError(f"{name} takes a contiguous uint8 [rows, cols] tensor, got {q.dtype} {tuple(q.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {q.device}")


# ------------------------------------------------------------ column sum


def column_sum_plain(q: torch.Tensor) -> torch.Tensor:
    """u8 [rows, cout] -> fp32 [1, cout], the exact column sums of the bytes
    read as unsigned (integers below 2^24, so fp32 holds them exactly)."""
    return q.to(torch.int32).sum(0, keepdim=True).float()


def ring_plan(rows: int, cout: int, sms: int, slices: int | None = None) -> GP.TcPlan:
    """The ring column sum's plan over u8 [rows, cout]: K6's on a [2 rows,
    cout] layer at one activation row (the same bytes), at `slices`
    k-slices per strip (None: the plan's). Raises ValueError on what the
    ring cannot take: rows not a multiple of 64 (a chunk), cout not a
    multiple of 128 (a strip), rows * 255 >= 2^24 (past fp32's exact
    integers), or a slice count beyond the chunks or the partials' scratch."""
    box, strip = GP.TC_BOX_ROWS["paired"], GP.TC_STRIP
    if rows <= 0 or rows % box or cout <= 0 or cout % strip:
        raise ValueError(f"the ring column sum needs rows a multiple of {box} and cout a multiple of {strip}, "
                         f"got [{rows}, {cout}]")
    if rows * 255 >= 2**24:
        raise ValueError(f"{rows} rows could sum past 2^24, where fp32 stops being exact")
    return GP.tc_plan("paired", 1, 2 * rows, cout, sms, slices)


def ring_word(warp: int, lane: int) -> int:
    """Byte offset in a stage of the word lane `lane` of consumer warp
    `warp` reads from the warp's first row (row `warp`; row warp + 8i is
    1024 i bytes further): columns 4 lane .. 4 lane + 3 of the strip, the
    logical 16-byte chunk lane / 4 under TMA's 128-byte swizzle, which puts
    chunk c of row r at c ^ (r % 8) (csrc/colsum_tc.cu's lane_off)."""
    return warp * GP.TC_STRIP + (((lane >> 2) ^ warp) << 4) + 4 * (lane & 3)


def column_sum_emulate(plan: GP.TcPlan, q: torch.Tensor, fault: int = 0) -> torch.Tensor:
    """The ring column sum's arithmetic on the CPU, walking `plan`: per
    block its tiles, per chunk of a tile a TMA-swizzled stage image read by
    each consumer warp's lanes at `ring_word` (rows warp, warp + 8, ...,
    lane l's bytes taken as columns 4l .. 4l + 3), the warps' sums added in
    order at the tile's end, a one-slice strip stored, else its slices'
    partials summed in slice order. `fault` plants RING_FAULT_*."""
    box, strip = plan.box_rows, GP.TC_STRIP
    scatter = torch.tensor([[GP.swizzle(r, c) for c in range(strip)] for r in range(box)]).flatten()
    offs = torch.tensor([[[ring_word(w, lane) + 1024 * i + b for lane in range(32) for b in range(4)]
                          for i in range(box // RING_CONSUMERS)] for w in range(RING_CONSUMERS)])   # [warps, rows, 128]
    dtype = torch.int8 if fault == RING_FAULT_SIGNED else torch.uint8
    partials, out = {}, torch.zeros(plan.strips * strip, dtype=torch.int64)
    for b in range(plan.grid):
        for t in plan.tiles_of(b):
            s, p = plan.tile(t)
            warps = torch.zeros(RING_CONSUMERS, strip, dtype=torch.int64)
            for j in range(*plan.slice_chunks(p)):
                stage = torch.zeros(box * strip, dtype=torch.uint8)
                stage[scatter] = q[j * box:(j + 1) * box, s * strip:(s + 1) * strip].flatten()
                warps += stage.view(dtype)[offs].to(torch.int64).sum(1)
            total = warps[0]
            for w in range(1, RING_CONSUMERS):
                total = total + warps[w]
            if plan.slices == 1:
                out[s * strip:(s + 1) * strip] = total
            else:
                partials[t] = total
    if plan.slices > 1:
        for s in range(plan.strips):
            total = torch.zeros(strip, dtype=torch.int64)
            for t in plan.contributors(s)[1 if fault == RING_FAULT_DROP_SLICE else 0:]:
                total = total + partials[t]
            out[s * strip:(s + 1) * strip] = 2 * total if fault == RING_FAULT_COMBINE_TWICE else total
    return out.float().reshape(1, -1)


def _ring(q: torch.Tensor, slices: int | None, fault: int) -> torch.Tensor | None:
    """The ring column sum over q at `slices` k-slices per strip (None: the
    plan's), its geometry checked on either device; None on the CPU."""
    if q.dim() != 2 or q.dtype != torch.uint8 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"the column sum takes a contiguous, 16-byte aligned uint8 [rows, cols] tensor (the TMA "
                         f"box's source), got {q.dtype} {tuple(q.shape)} at {q.data_ptr():#x}")
    rows, cout = q.shape
    if q.device.type == "cpu":
        ring_plan(rows, cout, 1, slices)
        return None
    _check_bytes(q, "the column sum")
    plan = ring_plan(rows, cout, Q._sm_count(q.device.index), slices)
    out = torch.empty((1, cout), dtype=torch.float32, device=q.device)
    part, counters = Q._tc_scratch(q.device)[3:5]
    with torch.cuda.device(q.device):
        err = _ring_library().supir_colsum_ring(q.data_ptr(), rows, cout, plan.slices, plan.grid, fault, part,
                                                counters, out.data_ptr(), _stream(q))
    if err < 0:
        raise RuntimeError(f"the column sum's tensor map failed to encode: CUresult {-err}")
    _raise_on(err, f"ring column sum ({plan.slices} k-slices)")
    return out


def column_sum(q: torch.Tensor, *, _fault: int = 0) -> torch.Tensor:
    """T1a: u8 [rows, cout] -> fp32 [1, cout] on the ring at one k-slice:
    each tile owns whole columns."""
    out = _ring(q, 1, _fault)
    if out is None:
        return column_sum_plain(q)
    column_sum.launches += 1
    return out


def column_sum_2d(q: torch.Tensor, slices: int | None = None, *, _fault: int = 0) -> torch.Tensor:
    """T1b: the column sum on the ring with the rows cut into `slices`
    k-slices per strip (None: the plan's count), the partials summed in
    slice order."""
    out = _ring(q, slices, _fault)
    if out is None:
        return column_sum_plain(q)
    column_sum_2d.launches += 1
    return out


def column_sum_strip(q: torch.Tensor, strip: int = 512, brow: int | None = None, *, _fault: int = 0) -> torch.Tensor:
    """T1a's and T1b's first design (csrc/probes.cu): one block per strip of
    `strip` columns (a multiple of 16) x block of `brow` rows (all by
    default); the row blocks' partials meet by fp32 atomics (exact: every
    partial and running total is an integer below 2^24). Kept to time the
    ring in turns; it counts no launch."""
    if brow is not None and brow <= 0:
        raise ValueError(f"brow must be positive, got {brow}")
    if q.device.type == "cpu":
        return column_sum_plain(q)
    _check_bytes(q, "the column sum")
    rows, cout = q.shape
    if cout % 16 or strip % 16 or strip <= 0 or q.data_ptr() % 16:
        raise ValueError(f"the column sum needs cout and strip multiples of 16 and 16-byte aligned rows, "
                         f"got cout {cout}, strip {strip}")
    if rows * 255 >= 2**24:
        raise ValueError(f"{rows} rows could sum past 2^24, where fp32 stops being exact")
    two_d = brow is not None
    out = (torch.zeros if two_d else torch.empty)((1, cout), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().supir_colsum(q.data_ptr(), rows, cout, strip, brow or rows, int(two_d), _fault,
                                      out.data_ptr(), _stream(q))
    _raise_on(err, "column sum")
    return out


# -------------------------------------------------------- nibbles, casts


def unpack_nibbles_plain(q: torch.Tensor) -> torch.Tensor:
    """u8 [r, c] -> fp32 [2r, c]: row 2i the low nibble of byte row i, row
    2i+1 the high one, sign-extended (quantize_int4_paired's order)."""
    return Q.unpack_int4_paired(q).float()


def unpack_nibbles(q: torch.Tensor, *, _fault: int = 0) -> torch.Tensor:
    """T3a: the nibble unpack through the GEMVs' own conversion."""
    if q.device.type == "cpu":
        return unpack_nibbles_plain(q)
    _check_bytes(q, "the nibble unpack")
    r, c = q.shape
    out = torch.empty((2 * r, c), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().supir_unpack_nibbles(q.data_ptr(), r, c, _fault, out.data_ptr(), _stream(q))
    _raise_on(err, "nibble unpack")
    unpack_nibbles.launches += 1
    return out


def native_cast_plain(packed: torch.Tensor) -> torch.Tensor:
    """Column-pair-packed int4 u8 [r, c/2] -> bf16 [r, c] x 2, in bf16 as the
    TPU probe computes it (every value is exact)."""
    return Q.unpack_int4_native(packed).to(torch.bfloat16) * 2.0


def native_cast(packed: torch.Tensor, *, _fault: int = 0) -> torch.Tensor:
    """T4a: the native int4 -> bf16 cast, doubled."""
    if packed.device.type == "cpu":
        return native_cast_plain(packed)
    _check_bytes(packed, "the native cast")
    r, half = packed.shape
    out = torch.empty((r, 2 * half), dtype=torch.bfloat16, device=packed.device)
    with torch.cuda.device(packed.device):
        err = _library().supir_native_cast(packed.data_ptr(), packed.numel(), _fault, out.data_ptr(),
                                           _stream(packed))
    _raise_on(err, "native cast")
    native_cast.launches += 1
    return out


# ----------------------------------------------------------------- GEMVs


def int4_single_cast_matmul_plain(x, packed, scale):
    """x [B, cin] @ dequant(packed, adjacent pairs) * scale -> [B, cout]
    fp32: every int4 value is exact in bf16, so the single cast changes
    nothing but the order of the sums (K6's plain version)."""
    return Q.int4_paired_matmul_plain(x, packed, scale)


def _on_body(name, x, packed, scale, layout, slices, fault):
    """One launch of the tensor-core body (csrc/quant_gemv_tc.cu) over
    packed int4 in `layout` ("paired" or "half" [cin/2, cout], "native"
    [cin, cout/2]), without prologue or residual, at `slices` k-slices per
    strip (None: the plan's)."""
    native = layout == "native"
    cin = packed.shape[0] if native else 2 * packed.shape[0]
    cout = 2 * packed.shape[1] if native else packed.shape[1]
    if x.shape[0] > Q.DECODE_ROWS:
        raise ValueError(f"{name} takes at most {Q.DECODE_ROWS} rows, got {x.shape[0]}")
    Q._check_activation(x, cin)
    Q._check_weights(packed, scale, packed.shape[0], packed.shape[1], cout, torch.uint8)
    Q._check_on_card(name, x, (("weights", packed), ("scale", scale)))
    if not GP.tc_eligible(layout, cin, cout, packed.data_ptr(), x.data_ptr(), x.stride(0)):
        raise ValueError(f"{name} runs on the tensor-core body only: cin % {16 if layout == 'half' else 8} == 0, "
                         f"cout % {32 if native else 16} == 0, 16-byte aligned rows; got {cin}, {cout}")
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    return Q._launch_tc(x, packed, scale, layout, cin, cout, None, 1e-6, 0, None, out, fault, None, slices)


def half_split_matmul_plain(x, q, scale):
    """x [B, cin] @ dequant(q, half-split) * scale -> [B, cout] fp32 (K7
    int4's plain version)."""
    return Q.qmm_plain(x, q, scale, 4)


def half_split_matmul(x, q, scale, slices: int | None = None, *, _fault: int = 0):
    """T1c: x [B <= 32, cin] bf16 @ half-split int4 uint8 [cin/2, cout]
    (byte p holds k p low, k p + cin/2 high) -> [B, cout] fp32 on the
    tensor-core body (K7 int4's instances), `slices` k-slices per strip
    (the plan's by default)."""
    if x.device.type == "cpu":
        return half_split_matmul_plain(x, q, scale)
    out = _on_body("the half-split GEMV", x, q, scale, "half", slices, _fault)
    half_split_matmul.launches += 1
    return out


def int4_single_cast_matmul(x, packed, scale, slices: int | None = None, *, _fault: int = 0):
    """T3b: x [B <= 32, cin] bf16 @ paired int4 uint8 [cin/2, cout] ->
    [B, cout] fp32 on the tensor-core body (K6's instances), `slices`
    k-slices per strip (the plan's by default)."""
    if x.device.type == "cpu":
        return int4_single_cast_matmul_plain(x, packed, scale)
    out = _on_body("the single-cast GEMV", x, packed, scale, "paired", slices, _fault)
    int4_single_cast_matmul.launches += 1
    return out


def native_single_cast_matmul_plain(x, packed, scale):
    """x [B, cin] @ dequant(packed, column pairs) * scale -> [B, cout] fp32
    (K11's plain version)."""
    return Q.int4_native_matmul_plain(x, packed, scale)


def native_single_cast_matmul(x, packed, scale, slices: int | None = None, *, _fault: int = 0):
    """T4b: x [B <= 32, cin] bf16 @ native int4 column pairs uint8 [cin,
    cout/2] -> [B, cout] fp32 on the tensor-core body (K11's instances), as
    int4_single_cast_matmul."""
    if x.device.type == "cpu":
        return native_single_cast_matmul_plain(x, packed, scale)
    out = _on_body("the native single-cast GEMV", x, packed, scale, "native", slices, _fault)
    native_single_cast_matmul.launches += 1
    return out


def int4_single_cast_matmul_strip(x, packed, scale, strip: int = Q.STRIP):
    """T3b's first design: x [B <= 32, cin] bf16 @ paired int4, one
    bf16-pair conversion per byte, fp32 sums * scale -> [B, cout] fp32, at
    `strip` columns per block (csrc/probes.cu). Kept to time T3b in turns;
    it counts no launch."""
    Q.check_geometry(strip)
    if x.device.type == "cpu":
        return int4_single_cast_matmul_plain(x, packed, scale)
    cin, cout = 2 * packed.shape[0], packed.shape[1]
    if x.shape[0] > Q.DECODE_ROWS:
        raise ValueError(f"the single-cast GEMV takes at most {Q.DECODE_ROWS} rows, got {x.shape[0]}")
    Q._check_activation(x, cin)
    if cout % 8:
        raise ValueError(f"the single-cast GEMV needs cout % 8 == 0, got {cout}")
    Q._check_weights(packed, scale, cin // 2, cout, cout, torch.uint8)
    Q._check_on_card("the single-cast GEMV", x, (("weights", packed), ("scale", scale)))
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().supir_gemv_single_cast(x.data_ptr(), x.stride(0), packed.data_ptr(), scale.data_ptr(),
                                                out.data_ptr(), x.shape[0], cin, cout, strip, _stream(x))
    _raise_on(err, f"single-cast GEMV (strip {strip})")
    return out


def w4a8_preact_plain(xq, packed, scale):
    """int8 xq [B, cin] @ dequant(packed, adjacent pairs) -> the exact integer
    sums * scale, fp32 [B, cout]: gemv_sweep.py's w4a8_matmul, before the
    activation scale."""
    return Q._int_dot(xq, Q.unpack_int4_paired(packed)) * scale.float()


def w4a8_preact(xq, packed, scale, strip: int = Q.STRIP, split_k: int = 1, *, _skip_split: int = -1):
    """T2: K10's body on int8 xq with the row factor fixed at 1 (xs = 127),
    at `strip` columns per block and `split_k` slices of the contraction;
    `_skip_split` drops one slice (planted fault)."""
    Q.check_geometry(strip, split_k)
    if xq.device.type == "cpu":
        return w4a8_preact_plain(xq, packed, scale)
    if xq.shape[0] > Q.DECODE_ROWS:
        raise ValueError(f"the W4A8 GEMV takes at most {Q.DECODE_ROWS} rows, got {xq.shape[0]}")
    xs = torch.full((xq.shape[0], 1), 127.0, dtype=torch.float32, device=xq.device)
    out = Q._launch_w4a8(xq, xs, packed, scale, strip=strip, split_k=split_k, skip_split=_skip_split)
    w4a8_preact.launches += 1
    return out


column_sum.launches = 0
column_sum_2d.launches = 0
half_split_matmul.launches = 0
unpack_nibbles.launches = 0
native_cast.launches = 0
int4_single_cast_matmul.launches = 0
native_single_cast_matmul.launches = 0
w4a8_preact.launches = 0
