"""Weight quantization for the captioner's decode: packers, K5-K11 and
their plain versions (counterpart of supir_tpu/ops/quantize.py).

Packers (plain tensor code in the JAX package too, bit for bit the same
values; `torch.round` and `jnp.round` both round half to even):
  quantize_int4_paired  byte i = row 2i (low nibble) | row 2i+1 (high nibble)
  quantize_int4         half-split: byte i = row i (low) | row i + in/2 (high)
  quantize_int4_native  column pairs: byte (k, j) = column 2j (low) | 2j+1 (high),
                        the byte order of a dense row-major s4 [in, out] buffer,
                        which is what the JAX package's jnp.int4 weights hold
All use the [-7, 7] grid with per-output-channel scales absmax / 7.

Kernels, each with its plain version beside it and a launch counter:
  K5 int4_paired_fused_matmul  (_qmm_fused_kernel :260)   paired int4 GEMV with
     an RMSNorm or SiLU-GLU prologue and an fp32 residual epilogue; with
     act_int8 the prologue's fp32 output is quantized per row to int8 and
     the dot is exact in int32 (W4A8, :291-297)
  K6 int4_paired_matmul        (_qmm_paired_kernel :116)  paired int4 GEMV
  K7 qmm (int8_matmul, int4_matmul) (_qmm_kernel :606)   int8 or half-split int4 GEMV
  K8 quantize_int8             (_quant_kernel :21)        absmax int8, stochastic rounding
  K9 int4_paired_fused_pair    (_qmm_pair_kernel :398)    two chained paired int4
     GEMVs in one launch: small = glue(x) W1 s1 + residual, big = RMSNorm(small) W2 s2
  K10 int4_w4a8_matmul         (_qmm_w4a8_kernel :191)    paired int4 weights x
     per-row int8 activations, exact int32 accumulation
  K11 int4_native_matmul       (_qmm_native_kernel :555)  GEMV against
     column-pair-packed int4 weights
K5-K7, K10 and K11 are `csrc/quant_gemv.cu`, K8 is `csrc/quantize_int8.cu`,
K9 `csrc/quant_pair.cu`; their headers say what bounds them on the card and
how they are laid out.

Launch geometry: `qmm` (K7, half-split int4), `int4_native_matmul` (K11)
and `int4_w4a8_matmul` (K10) take `strip=`, the output columns per block
(32, the default, or 64, 128, 256), and K10 also `split_k=` (1, the
default, 2 or 4 slices of the contraction summed exactly in int32). The
default is the geometry the model paths run (`csrc/quant_gemv.cu`); the
others are instances in `csrc/gemv_sweep.cu` for the decode-GEMV probes
(`supir_tpu_torch/tools/`). On a CPU tensor the keywords change nothing; on
a CUDA tensor a geometry that was not built raises. Launches at a
non-default geometry are counted also in `geometry_launches`.

Routing follows the JAX functions: an activation of at most `DECODE_ROWS`
rows (decode) goes to the kernel; more rows (prefill) go to the plain
version, dequantize then one fp32 matmul, as the JAX package leaves that
case to XLA. On a CPU tensor every function returns its plain version; on a
CUDA tensor it launches its kernel or raises. The TPU's block guards
(`cin % 256`, `_paired_bout`, `_qmm_bout`) are TPU tiling rules and are not
carried over: the kernels take any even cin (K10 and K5's act_int8 mode a
cin divisible by 4) and any cout that is a multiple of 8.

The integer dots of the W4A8 plain versions run as fp32 matmuls of the
integer values: torch has no int32 matmul on CUDA, and `int8 @ int8`
returns int8 and overflows. They are exact because every product and
partial sum is an integer below 2^24: |x| <= 127 and |w| <= 7, so a sum
over cin terms stays below 127 * 7 * cin, 1.23e7 at the widest cin of the
13B model (13824).
"""

from __future__ import annotations

import ctypes

import torch

_GEMV_SOURCE = "quant_gemv.cu"
_QUANT_SOURCE = "quantize_int8.cu"
_PAIR_SOURCE = "quant_pair.cu"
_SWEEP_SOURCE = "gemv_sweep.cu"
STRIP = 32                     # output columns per block on the model paths
GEMV_STRIPS = (32, 64, 128, 256)
W4A8_SPLITS = (1, 2, 4)
DECODE_ROWS = 32  # the largest activation the TPU functions send to a kernel
_MODES = {"paired": 0, "half": 1, "int8": 2, "native": 3}


# ------------------------------------------------------------------ packers


def _scale_of(w: torch.Tensor, qmax: float) -> torch.Tensor:
    return (w.abs().amax(dim=0, keepdim=True) / qmax).float()


def _int4_grid(w: torch.Tensor):
    if w.shape[0] % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {w.shape[0]}")
    scale = _scale_of(w, 7.0)
    q = torch.round(w / scale.clamp_min(1e-12)).clamp(-7, 7).to(torch.int8)
    return (q & 0xF).to(torch.uint8), scale


def quantize_int4_paired(w: torch.Tensor):
    """w [in, out] -> (packed uint8 [in/2, out], scale fp32 [1, out]),
    adjacent-pair layout."""
    qu, scale = _int4_grid(w)
    return qu[0::2] | (qu[1::2] << 4), scale


def quantize_int4(w: torch.Tensor):
    """w [in, out] -> (packed uint8 [in/2, out], scale fp32 [1, out]),
    half-split layout."""
    qu, scale = _int4_grid(w)
    half = w.shape[0] // 2
    return qu[:half] | (qu[half:] << 4), scale


def pack_int4_native(q: torch.Tensor) -> torch.Tensor:
    """int values in [-8, 7] [in, out] -> uint8 [in, out/2], column 2j in the
    low nibble of byte j and column 2j+1 in the high one."""
    if q.shape[-1] % 2:
        raise ValueError(f"native int4 packing needs an even output dim, got {q.shape[-1]}")
    qu = (q.to(torch.int8) & 0xF).to(torch.uint8)
    return qu[:, 0::2] | (qu[:, 1::2] << 4)


def quantize_int4_native(w: torch.Tensor):
    """w [in, out] -> (packed uint8 [in, out/2], scale fp32 [1, out]): the
    values and scales of quantize_int4_native (quantize.py:541-552), which
    equal quantize_int4_paired's bit for bit, stored as a dense s4 buffer."""
    scale = _scale_of(w, 7.0)
    q = torch.round(w / scale.clamp_min(1e-12)).clamp(-7, 7).to(torch.int8)
    return pack_int4_native(q), scale


def _sx4(u: torch.Tensor) -> torch.Tensor:
    """Sign-extend the 4-bit two's-complement nibble held in a uint8."""
    return ((u & 0xF).to(torch.int8) ^ 8) - 8


def unpack_int4_paired(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [in/2, out] -> int8 [in, out] (adjacent-pair layout)."""
    half, cout = packed.shape
    return torch.stack([_sx4(packed), _sx4(packed >> 4)], dim=1).reshape(2 * half, cout)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [in/2, out] -> int8 [in, out] (half-split layout)."""
    return torch.cat([_sx4(packed), _sx4(packed >> 4)], dim=0)


def unpack_int4_native(packed: torch.Tensor) -> torch.Tensor:
    """packed uint8 [in, out/2] -> int8 [in, out] (column-pair layout)."""
    cin, half = packed.shape
    return torch.stack([_sx4(packed), _sx4(packed >> 4)], dim=-1).reshape(cin, 2 * half)


# ----------------------------------------------------------- plain versions


def _dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ q * scale with fp32 products and sums: the JAX functions' dot with
    preferred_element_type=float32 on values that bf16 or fp32 hold exactly."""
    return (x.float() @ q.float()) * scale.float()


def int4_paired_matmul_plain(x, packed, scale):
    """x [B, in] @ dequant(packed) -> [B, out] fp32 (quantize.py:186-188)."""
    return _dot(x, unpack_int4_paired(packed), scale)


def quantize_act_int8(x: torch.Tensor):
    """x [B, in] float -> (xq int8 [B, in], xs fp32 [B, 1]), per-row
    symmetric, x ~ xq * xs / 127 (quantize.py:205-214): the dynamic
    activation half of W4A8."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    # a true division: torch computes `127.0 / xs` as reciprocal(xs) * 127,
    # which rounds otherwise and flips a half step now and then
    xq = torch.round(xf * (torch.full_like(xs, 127.0) / xs)).clamp(-127, 127).to(torch.int8)
    return xq, xs


def _int_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 [B, in] @ int [in, out] -> the exact integer sums as fp32 (see
    the module's note: every partial sum is an integer below 2^24)."""
    return xq.float() @ q.float()


def int4_w4a8_matmul_plain(x, packed, scale):
    """x [B, in] float @ dequant(packed, adjacent pairs) -> [B, out] fp32
    through per-row int8 activations (quantize.py:250-257): the integer dot,
    then * scale, then * (xs / 127), in that order."""
    xq, xs = quantize_act_int8(x)
    out = _int_dot(xq, unpack_int4_paired(packed)) * scale.float()
    return out * (xs * (1.0 / 127.0))


def _prologue(x, cin: int, gamma, eps: float, siluglu: bool) -> torch.Tensor:
    """K5's prologue in fp32: RMSNorm(gamma), SiLU-GLU over [a | g], or x."""
    xf = x.float()
    if gamma is not None:
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xf = xf * gamma.float()
    elif siluglu:
        a = xf[:, :cin]
        xf = (a * torch.sigmoid(a)) * xf[:, cin:]
    return xf


def int4_paired_fused_matmul_plain(x, packed, scale, gamma=None, eps: float = 1e-6,
                                   siluglu: bool = False, residual=None, act_int8: bool = False):
    """The fused decode projection of quantize.py:373-395: an RMSNorm(gamma)
    or SiLU-GLU prologue in fp32, rounded to x's dtype (bf16 or fp32), the
    paired-int4 dot, the scale, an fp32 residual. With act_int8 the fp32
    prologue output itself (not its rounding) is quantized per row to int8
    and the dot is integer: acc * (xs / 127), then * scale."""
    if gamma is not None and siluglu:
        raise ValueError("the RMSNorm and SiLU-GLU prologues are exclusive")
    cin = 2 * packed.shape[0]
    xdtype = x.dtype if x.dtype in (torch.bfloat16, torch.float32) else torch.float32
    xf = _prologue(x, cin, gamma, eps, siluglu)
    if act_int8:
        xq, xs = quantize_act_int8(xf)
        out = _int_dot(xq, unpack_int4_paired(packed)) * (xs * (1.0 / 127.0)) * scale.float()
    else:
        out = _dot(xf.to(xdtype), unpack_int4_paired(packed), scale)
    if residual is not None:
        out = out + residual.float()
    return out


def int4_paired_fused_pair_plain(x, qp1, sc1, residual, gamma, qp2, sc2, *, siluglu1: bool = False,
                                 eps: float = 1e-6):
    """K9's plain version, the JAX fallback (quantize.py:532-538):
    small = glue(x) @ deq(qp1) * sc1 + residual, then
    big = RMSNorm(small rounded to x's dtype, gamma) @ deq(qp2) * sc2."""
    _check_pair_shapes(qp1, qp2)
    small = int4_paired_fused_matmul_plain(x, qp1, sc1, siluglu=siluglu1, residual=residual)
    big = int4_paired_fused_matmul_plain(small.to(x.dtype), qp2, sc2, gamma=gamma, eps=eps)
    return small, big


def _check_pair_shapes(qp1, qp2) -> None:
    if 2 * qp2.shape[0] != qp1.shape[1]:
        raise ValueError(f"the pair's second GEMV takes the first one's output: qp1 {tuple(qp1.shape)}, "
                         f"qp2 {tuple(qp2.shape)}")


def int4_native_matmul_plain(x, packed, scale):
    """x [B, in] @ dequant(packed, column pairs) -> [B, out] fp32
    (quantize.py:591-592)."""
    return _dot(x, unpack_int4_native(packed), scale)


def qmm_plain(x, q, scale, bits: int):
    """x [B, in] @ dequant(q) -> [B, out] fp32; bits 8: int8 [in, out],
    bits 4: half-split uint8 [in/2, out] (quantize.py:695-707)."""
    return _dot(x, unpack_int4(q) if bits == 4 else q, scale)


def quantize_int8_plain(w: torch.Tensor, u: torch.Tensor | None = None):
    """w [in, out] -> (q int8 [in, out], scale fp32 [1, out]). u None rounds
    to nearest (the JAX function off the TPU, :43-48); u in [0, 1) of w's
    shape rounds stochastically, floor(w / scale + u) (the TPU kernel).
    The scale is absmax * float32(1 / 127), as XLA computes the jitted JAX
    function's absmax / 127 off the TPU, so nearest mode matches it bit for
    bit."""
    scale = w.abs().amax(dim=0, keepdim=True).float() * (1.0 / 127.0)
    scaled = w.float() / scale.clamp_min(1e-12)
    q = torch.round(scaled) if u is None else torch.floor(scaled + u)
    return q.clamp(-127, 127).to(torch.int8), scale


# ------------------------------------------------------------------ kernels


def _gemv_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_GEMV_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.supir_qgemv.restype = i
    lib.supir_qgemv.argtypes = [p, i, p, f, i, p, p, p, p, i, i, i, i, p]
    lib.supir_qgemv_w4a8.restype = i
    lib.supir_qgemv_w4a8.argtypes = [p, i, p, i, p, f, i, p, p, p, p, i, i, i, p]
    return lib


def _pair_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_PAIR_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.supir_qpair.restype = i
    lib.supir_qpair.argtypes = [p, i, i, p, p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.supir_qpair_grid.restype = i
    lib.supir_qpair_grid.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    return lib


def _quant_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_QUANT_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_quantize_int8.restype = i
    lib.supir_quantize_int8.argtypes = [p, i, i, p, ctypes.c_ulonglong, i, p, p, p]
    return lib


def _sweep_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_SWEEP_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_qgemv_geo.restype = i
    lib.supir_qgemv_geo.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.supir_qgemv_w4a8_geo.restype = i
    lib.supir_qgemv_w4a8_geo.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, p]
    return lib


SOURCES = (_GEMV_SOURCE, _QUANT_SOURCE, _PAIR_SOURCE, _SWEEP_SOURCE)  # for cuda_build.build_all


def check_geometry(strip: int, split_k: int = 1) -> bool:
    """Raise on a launch geometry that no instance was built for; return
    whether it is a non-default one."""
    if strip not in GEMV_STRIPS or split_k not in W4A8_SPLITS:
        raise ValueError(f"no GEMV instance at strip {strip}, split-K {split_k}: strips {GEMV_STRIPS}, "
                         f"split-K {W4A8_SPLITS}")
    return (strip, split_k) != (STRIP, 1)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_on_card(name: str, x: torch.Tensor, tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {x.device}")
    for tname, t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on {x.device}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_weights(w, scale, rows: int, cols: int, cout: int, dtype) -> None:
    if (w.dim() != 2 or tuple(w.shape) != (rows, cols) or w.dtype != dtype
            or not w.is_contiguous() or w.data_ptr() % 8):
        raise ValueError(f"weights must be a contiguous, 8-byte aligned {dtype} [{rows}, {cols}] "
                         f"tensor, got {w.dtype} {tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != cout or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous fp32 [1, {cout}] tensor")


def _check_activation(x, xin: int, dtype=torch.bfloat16) -> None:
    if x.dim() != 2 or x.shape[1] != xin or not x.is_contiguous():
        raise ValueError(f"the GEMV kernels take a contiguous [B, {xin}] activation, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"this GEMV kernel takes {dtype} activations, not {x.dtype}")


def _gamma_residual(gamma, residual, cin: int, rows: int, cout: int):
    if gamma is not None:
        gamma = gamma.float().contiguous()
        if gamma.shape != (cin,):
            raise ValueError(f"gamma must be [{cin}], got {tuple(gamma.shape)}")
    if residual is not None:
        if residual.shape != (rows, cout):
            raise ValueError(f"residual must be [{rows}, {cout}], got {tuple(residual.shape)}")
        residual = residual.float().contiguous()
    return gamma, residual


def _launch_gemv(x, w, scale, mode: str, cin: int, gamma=None, eps: float = 1e-6,
                 prologue: int = 0, residual=None, strip: int = STRIP) -> torch.Tensor:
    """One launch of `csrc/quant_gemv.cu` over x [B, cin] (or [B, 2 cin] with
    the SiLU-GLU prologue) bf16, or of `csrc/gemv_sweep.cu` at another strip
    (half-split and native int4, no prologue, no residual); returns
    [B, cout] fp32."""
    cout = 2 * w.shape[-1] if mode == "native" else w.shape[-1]
    _check_activation(x, 2 * cin if prologue == 2 else cin)
    if cin % 2 or cout % 8:
        raise ValueError(f"the GEMV kernels need an even cin and cout % 8 == 0, got {cin}, {cout}")
    rows, cols = {"int8": (cin, cout), "native": (cin, cout // 2)}.get(mode, (cin // 2, cout))
    _check_weights(w, scale, rows, cols, cout, torch.int8 if mode == "int8" else torch.uint8)
    gamma, residual = _gamma_residual(gamma, residual, cin, x.shape[0], cout)
    _check_on_card("the GEMV kernels", x, (("weights", w), ("scale", scale), ("gamma", gamma),
                                           ("residual", residual)))
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    if strip != STRIP:
        if mode not in ("half", "native") or prologue or residual is not None:
            raise ValueError(f"strip {strip} is built for the half-split and native GEMVs without prologue "
                             f"or residual, not {mode} with prologue {prologue}")
        with torch.cuda.device(x.device):
            err = _sweep_library().supir_qgemv_geo(
                x.data_ptr(), x.stride(0), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
                x.shape[0], cin, cout, _MODES[mode], strip, _stream(x.device))
        if err != 0:
            raise RuntimeError(f"GEMV kernel launch failed ({mode}, strip {strip}): cudaError {err}")
        return out
    with torch.cuda.device(x.device):
        err = _gemv_library().supir_qgemv(
            x.data_ptr(), x.stride(0), _ptr(gamma), float(eps), prologue,
            w.data_ptr(), scale.data_ptr(), _ptr(residual), out.data_ptr(),
            x.shape[0], cin, cout, _MODES[mode], _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"GEMV kernel launch failed ({mode}, prologue {prologue}): cudaError {err}")
    return out


def _launch_w4a8(x, xs, packed, scale, gamma=None, eps: float = 1e-6, prologue: int = 0,
                 residual=None, strip: int = STRIP, split_k: int = 1, skip_split: int = -1) -> torch.Tensor:
    """One launch of the W4A8 GEMV of `csrc/quant_gemv.cu`: x int8 [B, cin]
    with its row scales xs fp32 [B, 1] (K10), or x bf16 [B, cin] (or
    [B, 2 cin]) that the kernel runs through the prologue and quantizes
    itself (K5's act_int8 mode, xs None); returns [B, cout] fp32. Another
    strip or split-K (K10's form only) launches `csrc/gemv_sweep.cu`;
    `skip_split` leaves one slice out, for planted faults only."""
    cin, cout = 2 * packed.shape[0], packed.shape[1]
    quantized = xs is not None
    _check_activation(x, 2 * cin if prologue == 2 else cin, torch.int8 if quantized else torch.bfloat16)
    if cin % 4 or cout % 8:
        raise ValueError(f"the W4A8 kernel needs cin % 4 == 0 and cout % 8 == 0, got {cin}, {cout}")
    if quantized and (xs.dtype != torch.float32 or xs.numel() != x.shape[0] or not xs.is_contiguous()):
        raise ValueError(f"xs must be a contiguous fp32 [{x.shape[0]}, 1] tensor")
    _check_weights(packed, scale, cin // 2, cout, cout, torch.uint8)
    gamma, residual = _gamma_residual(gamma, residual, cin, x.shape[0], cout)
    _check_on_card("the W4A8 kernel", x, (("xs", xs), ("weights", packed), ("scale", scale), ("gamma", gamma),
                                          ("residual", residual)))
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    if (strip, split_k) != (STRIP, 1):
        if not quantized or prologue or residual is not None:
            raise ValueError("another W4A8 geometry is built for K10's form only: int8 x with its scales, "
                             "no prologue, no residual")
        # split-K's slices add their exact int32 sums here, in any order
        acc = torch.zeros((x.shape[0], cout), dtype=torch.int32, device=x.device) if split_k > 1 else None
        with torch.cuda.device(x.device):
            err = _sweep_library().supir_qgemv_w4a8_geo(
                x.data_ptr(), x.stride(0), xs.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(acc),
                out.data_ptr(), x.shape[0], cin, cout, strip, split_k, skip_split, _stream(x.device))
        if err != 0:
            raise RuntimeError(f"W4A8 kernel launch failed (strip {strip}, split-K {split_k}): cudaError {err}")
        return out
    with torch.cuda.device(x.device):
        err = _gemv_library().supir_qgemv_w4a8(
            x.data_ptr(), x.stride(0), _ptr(xs), int(quantized), _ptr(gamma), float(eps), prologue,
            packed.data_ptr(), scale.data_ptr(), _ptr(residual), out.data_ptr(),
            x.shape[0], cin, cout, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"W4A8 kernel launch failed (prologue {prologue}): cudaError {err}")
    return out


def int4_paired_fused_matmul(x, packed, scale, *, gamma=None, eps: float = 1e-6,
                             siluglu: bool = False, residual=None, act_int8: bool = False):
    """K5: the fused decode projection, x [B, cin] (or [B, 2 cin] with
    siluglu) -> [B, cout] fp32; see int4_paired_fused_matmul_plain. With
    act_int8 the kernel quantizes its prologue's fp32 output per row and
    runs the integer dot (counted also in `act_int8_launches`)."""
    if gamma is not None and siluglu:
        raise ValueError("the RMSNorm and SiLU-GLU prologues are exclusive")
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_paired_fused_matmul_plain(x, packed, scale, gamma, eps, siluglu, residual, act_int8)
    prologue = 1 if gamma is not None else (2 if siluglu else 0)
    if act_int8:
        out = _launch_w4a8(x, None, packed, scale, gamma, eps, prologue, residual)
        int4_paired_fused_matmul.act_int8_launches += 1
    else:
        out = _launch_gemv(x, packed, scale, "paired", 2 * packed.shape[0], gamma, eps, prologue, residual)
    int4_paired_fused_matmul.launches += 1
    return out


def int4_paired_matmul(x, packed, scale):
    """K6: x [B, cin] @ dequant(packed, adjacent pairs) * scale -> [B, cout] fp32."""
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_paired_matmul_plain(x, packed, scale)
    out = _launch_gemv(x, packed, scale, "paired", 2 * packed.shape[0])
    int4_paired_matmul.launches += 1
    return out


def qmm(x, q, scale, bits: int, strip: int = STRIP):
    """K7: x [B, cin] @ dequant(q) * scale -> [B, cout] fp32, q int8
    [cin, cout] (bits 8) or half-split uint8 [cin/2, cout] (bits 4); the
    half-split instance also at another `strip` (T1c's sweep)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    other = check_geometry(strip)
    if bits == 8 and other:
        raise ValueError(f"K7's int8 instance is built at strip {STRIP} only")
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return qmm_plain(x, q, scale, bits)
    cin = q.shape[0] if bits == 8 else 2 * q.shape[0]
    out = _launch_gemv(x, q, scale, "int8" if bits == 8 else "half", cin, strip=strip)
    qmm.launches += 1
    qmm.geometry_launches += other
    return out


def int8_matmul(x, q, scale):
    return qmm(x, q, scale, 8)


def int4_w4a8_matmul(x, packed, scale, strip: int = STRIP, split_k: int = 1):
    """K10: x [B, cin] float @ dequant(packed, adjacent pairs) -> [B, cout]
    fp32 through per-row int8 activations; see int4_w4a8_matmul_plain. The
    activation quantizer runs as torch ops before the launch, as XLA runs
    it outside the TPU kernel (quantize.py:227); the kernel applies the
    weight scales and then the row scales xs / 127, at `strip` columns per
    block and `split_k` slices of the contraction."""
    other = check_geometry(strip, split_k)
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_w4a8_matmul_plain(x, packed, scale)
    xq, xs = quantize_act_int8(x)
    out = _launch_w4a8(xq, xs, packed, scale, strip=strip, split_k=split_k)
    int4_w4a8_matmul.launches += 1
    int4_w4a8_matmul.geometry_launches += other
    return out


def int4_native_matmul(x, packed, scale, strip: int = STRIP):
    """K11: x [B, cin] bf16 @ dequant(packed, column pairs) * scale ->
    [B, cout] fp32; packed uint8 [cin, cout/2] from quantize_int4_native;
    at `strip` columns per block (T4b runs 256)."""
    other = check_geometry(strip)
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_native_matmul_plain(x, packed, scale)
    out = _launch_gemv(x, packed, scale, "native", packed.shape[0], strip=strip)
    int4_native_matmul.launches += 1
    int4_native_matmul.geometry_launches += other
    return out


def pair_grid_blocks(rows: int = 1) -> int:
    """K9's grid on this card for `rows` activation rows: the blocks that
    can be resident at once (blocks per SM from the occupancy API x SMs),
    which a cooperative launch may not exceed."""
    blocks = ctypes.c_int(0)
    err = _pair_library().supir_qpair_grid(rows, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"K9 occupancy query failed: cudaError {err}")
    return blocks.value


def int4_paired_fused_pair(x, qp1, sc1, residual, gamma, qp2, sc2, *, siluglu1: bool = False,
                           eps: float = 1e-6, _norm_cols: int | None = None):
    """K9: two chained paired-int4 GEMVs in one cooperative launch ->
    (small [B, cout1], big [B, cout2]) fp32; see int4_paired_fused_pair_plain.
    On the card the RMSNorm reads `small` in fp32, as the TPU kernel does,
    where the plain version rounds it to x's dtype first. `_norm_cols` is
    for planted-fault checks only: the RMSNorm then takes its statistics
    from the first `_norm_cols` columns of `small`."""
    _check_pair_shapes(qp1, qp2)
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_paired_fused_pair_plain(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1=siluglu1, eps=eps)
    cin1, cout1 = 2 * qp1.shape[0], qp1.shape[1]
    cout2 = qp2.shape[1]
    _check_activation(x, 2 * cin1 if siluglu1 else cin1)
    if cin1 % 2 or cout1 % 8 or cout2 % 8:
        raise ValueError(f"K9 needs an even cin and both couts % 8 == 0, got {cin1}, {cout1}, {cout2}")
    _check_weights(qp1, sc1, cin1 // 2, cout1, cout1, torch.uint8)
    _check_weights(qp2, sc2, cout1 // 2, cout2, cout2, torch.uint8)
    gamma, residual = _gamma_residual(gamma, residual, cout1, x.shape[0], cout1)
    if gamma is None or residual is None:
        raise ValueError("K9 takes a residual for its first GEMV and a gamma for its second")
    _check_on_card("K9", x, (("qp1", qp1), ("sc1", sc1), ("residual", residual), ("gamma", gamma),
                             ("qp2", qp2), ("sc2", sc2)))
    small = torch.empty((x.shape[0], cout1), dtype=torch.float32, device=x.device)
    big = torch.empty((x.shape[0], cout2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _pair_library().supir_qpair(
            x.data_ptr(), x.stride(0), int(siluglu1), qp1.data_ptr(), sc1.data_ptr(), residual.data_ptr(),
            gamma.data_ptr(), qp2.data_ptr(), sc2.data_ptr(), small.data_ptr(), big.data_ptr(),
            x.shape[0], cin1, cout1, cout2, float(eps), cout1 if _norm_cols is None else _norm_cols,
            _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"K9 cooperative launch failed: cudaError {err}")
    int4_paired_fused_pair.launches += 1
    return small, big


def int4_matmul(x, packed, scale, strip: int = STRIP):
    return qmm(x, packed, scale, 4, strip)


def quantize_int8(w: torch.Tensor, seed: int = 0, stochastic: bool = True):
    """K8: w [in, out] -> (q int8 [in, out], scale fp32 [1, out]), rounding
    stochastically with u drawn from `seed`, or to nearest. On the CPU the
    plain version draws u from a torch.Generator seeded with `seed`; on the
    card the kernel draws it from Philox, so the two differ bit for bit in
    stochastic mode and agree in nearest mode."""
    if w.device.type == "cpu":
        u = None
        if stochastic:
            u = torch.rand(w.shape, generator=torch.Generator().manual_seed(seed))
        return quantize_int8_plain(w, u)
    _check_on_card("quantize_int8", w, ())
    if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"quantize_int8 takes a contiguous fp32 [in, out] tensor, got {w.dtype} {tuple(w.shape)}")
    cin, cout = w.shape
    amax = torch.zeros(cout, dtype=torch.int32, device=w.device)
    q = torch.empty((cin, cout), dtype=torch.int8, device=w.device)
    scale = torch.empty((1, cout), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _quant_library().supir_quantize_int8(
            w.data_ptr(), cin, cout, amax.data_ptr(), seed & (2**64 - 1), int(stochastic),
            q.data_ptr(), scale.data_ptr(), _stream(w.device),
        )
    if err != 0:
        raise RuntimeError(f"quantize_int8 kernel launch failed: cudaError {err}")
    quantize_int8.launches += 1
    return q, scale


int4_paired_fused_matmul.launches = 0
int4_paired_fused_matmul.act_int8_launches = 0
int4_paired_matmul.launches = 0
int4_w4a8_matmul.launches = 0
int4_w4a8_matmul.geometry_launches = 0
int4_native_matmul.launches = 0
int4_native_matmul.geometry_launches = 0
int4_paired_fused_pair.launches = 0
qmm.launches = 0
qmm.geometry_launches = 0
quantize_int8.launches = 0
