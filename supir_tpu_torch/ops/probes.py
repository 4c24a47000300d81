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
Kernels of `csrc/nibble_order.cu`, on the tensor-core body's own int4
decodes (`csrc/tc_decode.cuh`, which `csrc/quant_gemv_tc.cu` compiles too):
  T3a unpack_nibbles  (tools/bitcast_probe.py:order_kernel :33, :46)  u8
      [r, c] -> fp32 [2r, c], row 2i the low nibble of byte row i and 2i+1
      the high one, sign-extended: the order of quantize_int4_paired, read
      back through the decode the GEMVs run on the card: `decode="paired"`
      by nib2 (a word of 4 columns, each byte a bf16x2; the paired and
      half-split layouts), `decode="w4a8"` by quad16 (the words of two
      packed rows, s8 bytes of 16 n in the k order 4t, 4t + 2, 4t + 1,
      4t + 3, shifted back and put in row order). `unpack_emulate` walks
      the same bit operations on the CPU (ops/gemv_plan.py:nib2, quad16).
  T4a native_cast     (tools/int4_native_probe.py:stage2_mosaic.k :46, :50)
      column-pair-packed int4 u8 [r, c/2] -> bf16 [r, c] x 2: each 4-byte
      word's bytes through nib2, the decode of K11's native layout, then
      one packed doubling. `native_cast_emulate` walks the same bits on the
      CPU (ops/gemv_plan.py:nib2).
  `empty_launch` launches an empty kernel, the launch floor T3a's and
  T4a's times are read against; it counts no launch.
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
  T2  w4a8_preact     (tools/gemv_sweep.py:_w4a8_kernel :48, :69)  int8 x [B
      <= 32, cin] @ paired int4 -> exact int32 sums * column scale, fp32,
      before the activation scale (w4a8_matmul :58-83): K10's W4A8
      instances with every row scale 127 (so the row factor xs / 127 is
      exactly 1.0f and the output is bit-equal to the plain version), at
      `slices` k-slices per strip, 16 rows a launch. The TPU sweep's
      split-K is the body's k-slices; its strip width has no counterpart
      (the body's strip is 128 columns). Its first design, K10's strip body
      at strip x split-K (`csrc/gemv_sweep.cu`, `csrc/quant_gemv.cu` at
      strip 32), stays reachable as `w4a8_preact_strip` to time T2 in
      turns. The probe's `direct` variant hands the s4 operand straight to
      the TPU's matrix unit against int8 activations; Hopper's tensor cores
      (wgmma, mma.sync) take no 4-bit operand and no mixed s8 x s4 product,
      so it has no twin here.

On a CPU tensor every function returns its plain version; on a CUDA tensor
it launches its kernel or raises. The ring column sum refuses what the
ring cannot take on either device. `_fault` selects a planted-fault instance
of a kernel (the ring column sum: RING_FAULT_*; the unpack: ORDER_FAULT_*;
the cast: ORDER_FAULT_SWAP, nibbles swapped, or ORDER_FAULT_UNSIGNED, sign
not restored; T1c, T2, T3b and T4b: one of gemv_plan.FAULT_*), for the
checks that must see a fault break their bound.
"""

from __future__ import annotations

import ctypes

import torch

from supir_tpu_torch.ops import gemv_plan as GP, quantize as Q

_ORDER_SOURCE = "nibble_order.cu"
_RING_SOURCE = "colsum_tc.cu"
SOURCES = (_ORDER_SOURCE, _RING_SOURCE)
RING_FLUSH_CHUNKS = 16    # csrc/colsum_tc.cu: chunks (8 rows a lane each) between flushes of the 16-bit sums
RING_CONSUMERS = 8        # consumer warps; warp w takes rows w, w + 8, ... of a 64-row stage
# csrc/colsum_tc.cu's planted faults (tests and chip_smoke only): the bytes
# read as int8, slice 0's partial left out of the combine, the combine run twice
RING_FAULT_SIGNED, RING_FAULT_DROP_SLICE, RING_FAULT_COMBINE_TWICE = 1, 2, 3
# csrc/nibble_order.cu's (T3a's, and T4a's first two): the nibbles swapped
# (nib2's or quad16's selector mirrored), the sign not restored (nib2's ^ 8
# dropped; W4A8's bytes read back unsigned), W4A8's k order left permuted
ORDER_FAULT_SWAP, ORDER_FAULT_UNSIGNED, ORDER_FAULT_K_ORDER = 1, 2, 3
DECODES = ("paired", "w4a8")


def _order_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_ORDER_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_unpack_nibbles.restype = i
    lib.supir_unpack_nibbles.argtypes = [p, i, i, i, i, p, p]
    lib.supir_empty_launch.restype = i
    lib.supir_empty_launch.argtypes = [p]
    lib.supir_native_cast.restype = i
    lib.supir_native_cast.argtypes = [p, ctypes.c_longlong, i, p, p]
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


# -------------------------------------------------------- nibbles, casts


def unpack_nibbles_plain(q: torch.Tensor) -> torch.Tensor:
    """u8 [r, c] -> fp32 [2r, c]: row 2i the low nibble of byte row i, row
    2i+1 the high one, sign-extended (quantize_int4_paired's order)."""
    return Q.unpack_int4_paired(q).float()


def unpack_emulate(q: torch.Tensor, decode: str = "paired", fault: int = 0) -> torch.Tensor:
    """T3a's kernel on the CPU: u8 [r, c] (c % 4 == 0) -> fp32 [2r, c] by
    the bit operations of csrc/tc_decode.cuh (ops/gemv_plan.py:nib2,
    quad16) on the 4-byte words the kernel reads: "paired", each word's
    bytes by nib2 into a bf16x2; "w4a8", the words of packed rows 2p and 2p
    + 1 (zeros past r) by quad16, each s8 byte shifted back by 4 and put
    from the k order 4p, 4p + 2, 4p + 1, 4p + 3 into row order. `fault`
    plants ORDER_FAULT_*."""
    if decode not in DECODES:
        raise ValueError(f"the nibble unpack decodes as one of {DECODES}, not {decode}")
    r, c = q.shape
    b = q.to(torch.int64).reshape(r, c // 4, 4)
    words = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)      # [r, c / 4]
    out = torch.zeros(4 * ((r + 1) // 2), c // 4, 4)                                   # [rows, words, column]
    if decode == "paired":
        for i in range(4):
            v = GP.nib2(words, words >> 4, i, fault != ORDER_FAULT_UNSIGNED, fault == ORDER_FAULT_SWAP)
            out[0:2 * r:2, :, i], out[1:2 * r:2, :, i] = GP.bf16x2_floats(v)
        return out[:2 * r].reshape(2 * r, c)
    if r % 2:
        words = torch.cat([words, torch.zeros_like(words[:1])])
    regs = []                                                                          # columns 0-3 of a word
    for f in range(2):
        regs += list(GP.quad16(words[0::2], words[1::2], f, fault == ORDER_FAULT_SWAP))
    rows = (0, 1, 2, 3) if fault == ORDER_FAULT_K_ORDER else (0, 2, 1, 3)            # byte b holds k 4p + rows[b]
    for col, reg in enumerate(regs):
        for byte in range(4):
            v = (reg >> (8 * byte)) & 0xFF
            v = v >> 4 if fault == ORDER_FAULT_UNSIGNED else v.to(torch.uint8).view(torch.int8).to(torch.int64) >> 4
            out[rows[byte]::4, :, col] = v.float()
    return out[:2 * r].reshape(2 * r, c)


def unpack_nibbles(q: torch.Tensor, decode: str = "paired", *, _fault: int = 0) -> torch.Tensor:
    """T3a: the nibble unpack through the tensor-core body's own decode,
    `decode` "paired" (nib2) or "w4a8" (quad16); on a CUDA tensor c % 4 ==
    0 (the kernel reads 4-byte words)."""
    if decode not in DECODES:
        raise ValueError(f"the nibble unpack decodes as one of {DECODES}, not {decode}")
    if q.device.type == "cpu":
        return unpack_nibbles_plain(q)
    _check_bytes(q, "the nibble unpack")
    r, c = q.shape
    if c % 4 or q.data_ptr() % 4:
        raise ValueError(f"the nibble unpack reads 4-byte words: c % 4 == 0 and 4-byte aligned rows, got {c}")
    out = torch.empty((2 * r, c), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _order_library().supir_unpack_nibbles(q.data_ptr(), r, c, DECODES.index(decode), _fault,
                                                    out.data_ptr(), _stream(q))
    _raise_on(err, f"nibble unpack ({decode})")
    unpack_nibbles.launches += 1
    return out


def empty_launch(device: torch.device) -> None:
    """One empty kernel on the current stream of `device`: the launch floor
    T3a and T4a are read against. It counts no launch."""
    with torch.cuda.device(device):
        _raise_on(_order_library().supir_empty_launch(torch.cuda.current_stream(device).cuda_stream), "empty")


def native_cast_plain(packed: torch.Tensor) -> torch.Tensor:
    """Column-pair-packed int4 u8 [r, c/2] -> bf16 [r, c] x 2, in bf16 as the
    TPU probe computes it (every value is exact)."""
    return Q.unpack_int4_native(packed).to(torch.bfloat16) * 2.0


def native_cast_emulate(packed: torch.Tensor, fault: int = 0) -> torch.Tensor:
    """T4a's kernel on the CPU: u8 [r, c/2] -> bf16 [r, c] by the bit
    operations of csrc/tc_decode.cuh's nib2 (ops/gemv_plan.py:nib2) on the
    4-byte words the kernel reads (the last one zero-padded), each byte's
    bf16x2 doubled in bf16 (exact). `fault`: ORDER_FAULT_SWAP or
    ORDER_FAULT_UNSIGNED."""
    r, half = packed.shape
    n = r * half
    b = torch.nn.functional.pad(packed.reshape(-1).to(torch.int64), (0, -n % 4)).reshape(-1, 4)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    pairs = torch.stack([GP.nib2(words, words >> 4, i, fault != ORDER_FAULT_UNSIGNED, fault == ORDER_FAULT_SWAP)
                         for i in range(4)], dim=-1).reshape(-1)[:n]                  # one bf16x2 a byte
    halves = torch.stack(GP.bf16x2_floats(pairs), dim=-1).to(torch.bfloat16)          # [n, (low, high)]
    return (halves * 2.0).reshape(r, 2 * half)


def native_cast(packed: torch.Tensor, *, _fault: int = 0) -> torch.Tensor:
    """T4a: the native int4 -> bf16 cast, doubled, through the tensor-core
    body's nib2; on a CUDA tensor the bytes 4-byte aligned (the kernel reads
    words)."""
    if packed.device.type == "cpu":
        return native_cast_plain(packed)
    _check_bytes(packed, "the native cast")
    if packed.data_ptr() % 4:
        raise ValueError("the native cast reads 4-byte words: the bytes must be 4-byte aligned")
    r, half = packed.shape
    out = torch.empty((r, 2 * half), dtype=torch.bfloat16, device=packed.device)
    with torch.cuda.device(packed.device):
        err = _order_library().supir_native_cast(packed.data_ptr(), packed.numel(), _fault, out.data_ptr(),
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


_ROW_SCALES: dict = {}    # device index -> fp32 [DECODE_ROWS, 1] of 127: T2's row scales


def _on_body(name, x, packed, scale, layout, slices, fault):
    """The tensor-core body (csrc/quant_gemv_tc.cu) over packed int4 in
    `layout` ("paired", "half" or "w4a8" [cin/2, cout], "native" [cin,
    cout/2]), without prologue or residual, at `slices` k-slices per strip
    (None: the plan's): one launch, or for "w4a8" (int8 x, every row scale
    127) one launch a block of gemv_plan.TC_W4A8_ROWS rows."""
    native, w4a8 = layout == "native", layout == "w4a8"
    cin = packed.shape[0] if native else 2 * packed.shape[0]
    cout = 2 * packed.shape[1] if native else packed.shape[1]
    if x.shape[0] > Q.DECODE_ROWS:
        raise ValueError(f"{name} takes at most {Q.DECODE_ROWS} rows, got {x.shape[0]}")
    Q._check_activation(x, cin, torch.int8 if w4a8 else torch.bfloat16)
    Q._check_weights(packed, scale, packed.shape[0], packed.shape[1], cout, torch.uint8)
    Q._check_on_card(name, x, (("weights", packed), ("scale", scale)))
    if not GP.tc_eligible(layout, cin, cout, packed.data_ptr(), x.data_ptr(), x.stride(0)):
        raise ValueError(f"{name} runs on the tensor-core body only: cin % {16 if layout == 'half' else 8} == 0, "
                         f"cout % {32 if native else 16} == 0, 16-byte aligned rows; got {cin}, {cout}")
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    if not w4a8:
        return Q._launch_tc(x, packed, scale, layout, cin, cout, None, 1e-6, 0, None, out, fault, None, slices)
    xs = _ROW_SCALES.get(x.device.index)
    if xs is None:
        xs = _ROW_SCALES[x.device.index] = torch.full((Q.DECODE_ROWS, 1), 127.0, device=x.device)
    for r0 in range(0, x.shape[0], GP.TC_W4A8_ROWS):
        rs = slice(r0, r0 + GP.TC_W4A8_ROWS)
        Q._launch_tc(x[rs], packed, scale, "w4a8", cin, cout, None, 1e-6, 0, None, out[rs], fault,
                     xs[r0:r0 + x[rs].shape[0]], slices)
    return out


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


def w4a8_preact_plain(xq, packed, scale):
    """int8 xq [B, cin] @ dequant(packed, adjacent pairs) -> the exact integer
    sums * scale, fp32 [B, cout]: gemv_sweep.py's w4a8_matmul, before the
    activation scale."""
    return Q._int_dot(xq, Q.unpack_int4_paired(packed)) * scale.float()


def w4a8_preact(xq, packed, scale, slices: int | None = None, *, _fault: int = 0):
    """T2: int8 xq [B <= 32, cin] @ paired int4 uint8 [cin/2, cout] -> the
    exact integer sums * scale, [B, cout] fp32, on the tensor-core body
    (K10's W4A8 instances, the row factor fixed at 1 by xs = 127), `slices`
    k-slices per strip (the plan's by default)."""
    if xq.device.type == "cpu":
        return w4a8_preact_plain(xq, packed, scale)
    out = _on_body("the W4A8 GEMV", xq, packed, scale, "w4a8", slices, _fault)
    w4a8_preact.launches += 1
    return out


def w4a8_preact_strip(xq, packed, scale, strip: int = Q.STRIP, split_k: int = 1, *, _skip_split: int = -1):
    """T2's first design: K10's strip body on int8 xq with the row factor
    fixed at 1 (xs = 127), at `strip` columns per block and `split_k`
    slices of the contraction (`csrc/quant_gemv.cu` at strip 32 without a
    split, `csrc/gemv_sweep.cu` otherwise); `_skip_split` drops one slice
    (planted fault). Kept to time T2 in turns; it counts no launch."""
    Q.check_geometry(strip, split_k)
    if xq.device.type == "cpu":
        return w4a8_preact_plain(xq, packed, scale)
    if xq.shape[0] > Q.DECODE_ROWS:
        raise ValueError(f"the W4A8 GEMV takes at most {Q.DECODE_ROWS} rows, got {xq.shape[0]}")
    xs = torch.full((xq.shape[0], 1), 127.0, dtype=torch.float32, device=xq.device)
    return Q._launch_w4a8(xq, xs, packed, scale, strip=strip, split_k=split_k, skip_split=_skip_split,
                          _tensor_cores=False)


column_sum.launches = 0
column_sum_2d.launches = 0
half_split_matmul.launches = 0
unpack_nibbles.launches = 0
native_cast.launches = 0
int4_single_cast_matmul.launches = 0
native_single_cast_matmul.launches = 0
w4a8_preact.launches = 0
