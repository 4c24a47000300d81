"""The decode-GEMV probes' kernels (T1-T4), their plain versions and launch
counters: the counterparts of the Pallas kernels in the JAX package's
`tools/` probes, driven by `supir_tpu_torch/tools/`.

Kernels of `csrc/probes.cu` (its header says what bounds each on the card
and how it is laid out):
  T1a column_sum      (tools/stream_ceiling.py:sum_kernel :48, pallas_call
      :78)  u8 [rows, cout] -> fp32 [1, cout], a 1-D grid of column strips.
      The TPU kernel zeroes its output only at grid step 0, so with more
      than one output block every block past the first sums onto memory it
      never initialised; this one computes the column sum that was meant.
  T1b column_sum_2d   (sum2d_kernel :99, pallas_call :110)  the same sum on a
      2-D grid that also splits the rows; the row blocks' partials meet in
      the output by fp32 atomics, exact because every partial and running
      total is an integer below 2^24.
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
  T3b int4_single_cast_matmul   (tools/bitcast_probe.py:gemv_kernel_bitcast
      :63, pallas_call :111)  bf16 x [B <= 32, cin] @ paired int4 -> fp32
      sums * scale: K6's instances at `slices` k-slices per strip (the
      plan's by default).
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
  T1c K7 at a strip (`qmm(..., strip=)`).

On a CPU tensor every function returns its plain version; on a CUDA tensor
it launches its kernel or raises. `_fault` selects a planted-fault instance
of a kernel (column sum: 1 bytes read as int8, 2 last row block dropped;
unpack and cast: 1 nibbles swapped, 2 sign not extended; T3b and T4b: one
of gemv_plan.FAULT_*), for the checks that must see a fault break their
bound.
"""

from __future__ import annotations

import ctypes

import torch

from supir_tpu_torch.ops import gemv_plan as GP, quantize as Q

_SOURCE = "probes.cu"
SOURCES = (_SOURCE,)


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


def _colsum(q, strip: int, brow: int, two_d: bool, fault: int) -> torch.Tensor:
    _check_bytes(q, "the column sum")
    rows, cout = q.shape
    if cout % 16 or strip % 16 or strip <= 0 or q.data_ptr() % 16:
        raise ValueError(f"the column sum needs cout and strip multiples of 16 and 16-byte aligned rows, "
                         f"got cout {cout}, strip {strip}")
    if rows * 255 >= 2**24:
        raise ValueError(f"{rows} rows could sum past 2^24, where fp32 stops being exact")
    out = (torch.zeros if two_d else torch.empty)((1, cout), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().supir_colsum(q.data_ptr(), rows, cout, strip, brow, int(two_d), fault,
                                      out.data_ptr(), _stream(q))
    _raise_on(err, "column sum")
    return out


def column_sum(q: torch.Tensor, strip: int = 512, *, _fault: int = 0) -> torch.Tensor:
    """T1a: u8 [rows, cout] -> fp32 [1, cout], one block per strip of
    `strip` columns (a multiple of 16) down all the rows."""
    if q.device.type == "cpu":
        return column_sum_plain(q)
    out = _colsum(q, strip, q.shape[0], False, _fault)
    column_sum.launches += 1
    return out


def column_sum_2d(q: torch.Tensor, brow: int, bout: int, *, _fault: int = 0) -> torch.Tensor:
    """T1b: the column sum on a 2-D grid of (brow rows x bout columns)
    blocks; the row blocks' partials meet by fp32 atomics (exact)."""
    if brow <= 0:
        raise ValueError(f"brow must be positive, got {brow}")
    if q.device.type == "cpu":
        return column_sum_plain(q)
    out = _colsum(q, bout, brow, True, _fault)
    column_sum_2d.launches += 1
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
    packed int4 in `layout` ("paired" [cin/2, cout], "native" [cin,
    cout/2]), without prologue or residual, at `slices` k-slices per strip
    (None: the plan's)."""
    cin = 2 * packed.shape[0] if layout == "paired" else packed.shape[0]
    cout = packed.shape[1] if layout == "paired" else 2 * packed.shape[1]
    if x.shape[0] > Q.DECODE_ROWS:
        raise ValueError(f"{name} takes at most {Q.DECODE_ROWS} rows, got {x.shape[0]}")
    Q._check_activation(x, cin)
    Q._check_weights(packed, scale, packed.shape[0], packed.shape[1], cout, torch.uint8)
    Q._check_on_card(name, x, (("weights", packed), ("scale", scale)))
    if not GP.tc_eligible(layout, cin, cout, packed.data_ptr(), x.data_ptr(), x.stride(0)):
        raise ValueError(f"{name} runs on the tensor-core body only: cin % 8 == 0, cout % "
                         f"{32 if layout == 'native' else 16} == 0, 16-byte aligned rows; got {cin}, {cout}")
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    return Q._launch_tc(x, packed, scale, layout, cin, cout, None, 1e-6, 0, None, out, fault, None, slices)


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
unpack_nibbles.launches = 0
native_cast.launches = 0
int4_single_cast_matmul.launches = 0
native_single_cast_matmul.launches = 0
w4a8_preact.launches = 0
