"""Weight quantization for the captioner's decode: packers, K5-K8 and their
plain versions (counterpart of supir_tpu/ops/quantize.py).

Packers (plain tensor code in the JAX package too, bit for bit the same
bytes; `torch.round` and `jnp.round` both round half to even):
  quantize_int4_paired  byte i = row 2i (low nibble) | row 2i+1 (high nibble)
  quantize_int4         half-split: byte i = row i (low) | row i + in/2 (high)
Both use the [-7, 7] grid with per-output-channel scales absmax / 7.

Kernels, each with its plain version beside it and a launch counter:
  K5 int4_paired_fused_matmul  (_qmm_fused_kernel :260)   paired int4 GEMV with
     an RMSNorm or SiLU-GLU prologue and an fp32 residual epilogue
  K6 int4_paired_matmul        (_qmm_paired_kernel :116)  paired int4 GEMV
  K7 qmm (int8_matmul, int4_matmul) (_qmm_kernel :606)   int8 or half-split int4 GEMV
  K8 quantize_int8             (_quant_kernel :21)        absmax int8, stochastic rounding
K5-K7 are `csrc/quant_gemv.cu`, K8 is `csrc/quantize_int8.cu`; their
headers say what bounds them on the card and how they are laid out.

Routing follows the JAX functions: an activation of at most `DECODE_ROWS`
rows (decode) goes to the kernel; more rows (prefill) go to the plain
version, dequantize then one fp32 matmul, as the JAX package leaves that
case to XLA. On a CPU tensor every function returns its plain version; on a
CUDA tensor it launches its kernel or raises. The TPU's block guards
(`cin % 256`, `_paired_bout`, `_qmm_bout`) are TPU tiling rules and are not
carried over: the kernels take any even cin and any cout that is a multiple
of 8. W4A8 (K10), the chained pair (K9) and native int4 (K11) are not ported.
"""

from __future__ import annotations

import ctypes

import torch

_GEMV_SOURCE = "quant_gemv.cu"
_QUANT_SOURCE = "quantize_int8.cu"
DECODE_ROWS = 32  # the largest activation the TPU functions send to a kernel
_MODES = {"paired": 0, "half": 1, "int8": 2}


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


# ----------------------------------------------------------- plain versions


def _dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x @ q * scale with fp32 products and sums: the JAX functions' dot with
    preferred_element_type=float32 on values that bf16 or fp32 hold exactly."""
    return (x.float() @ q.float()) * scale.float()


def int4_paired_matmul_plain(x, packed, scale):
    """x [B, in] @ dequant(packed) -> [B, out] fp32 (quantize.py:186-188)."""
    return _dot(x, unpack_int4_paired(packed), scale)


def int4_paired_fused_matmul_plain(x, packed, scale, gamma=None, eps: float = 1e-6,
                                   siluglu: bool = False, residual=None):
    """The fused decode projection of quantize.py:373-395: an RMSNorm(gamma)
    or SiLU-GLU prologue in fp32, rounded to x's dtype (bf16 or fp32), the
    paired-int4 dot, the scale, an fp32 residual."""
    if gamma is not None and siluglu:
        raise ValueError("the RMSNorm and SiLU-GLU prologues are exclusive")
    cin = 2 * packed.shape[0]
    xdtype = x.dtype if x.dtype in (torch.bfloat16, torch.float32) else torch.float32
    xf = x.float()
    if gamma is not None:
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        xf = xf * gamma.float()
    elif siluglu:
        a = xf[:, :cin]
        xf = (a * torch.sigmoid(a)) * xf[:, cin:]
    out = _dot(xf.to(xdtype), unpack_int4_paired(packed), scale)
    if residual is not None:
        out = out + residual.float()
    return out


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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_qgemv.restype = i
    lib.supir_qgemv.argtypes = [p, i, p, ctypes.c_float, i, p, p, p, p, i, i, i, i, p]
    return lib


def _quant_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_QUANT_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_quantize_int8.restype = i
    lib.supir_quantize_int8.argtypes = [p, i, i, p, ctypes.c_ulonglong, i, p, p, p]
    return lib


SOURCES = (_GEMV_SOURCE, _QUANT_SOURCE)  # for cuda_build.build_all


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_on_card(name: str, x: torch.Tensor, tensors) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {x.device}")
    for tname, t in tensors:
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on {x.device}")


def _launch_gemv(x, w, scale, mode: str, cin: int, gamma=None, eps: float = 1e-6,
                 prologue: int = 0, residual=None) -> torch.Tensor:
    """One launch of `csrc/quant_gemv.cu` over x [B, cin] (or [B, 2 cin] with
    the SiLU-GLU prologue) bf16; returns [B, cout] fp32."""
    rows_of_w = cin if mode == "int8" else cin // 2
    cout = w.shape[-1]
    xin = 2 * cin if prologue == 2 else cin
    if x.dim() != 2 or x.shape[1] != xin or not x.is_contiguous():
        raise ValueError(f"the GEMV kernels take a contiguous [B, {xin}] activation, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the GEMV kernels take bf16 activations, not {x.dtype}")
    if cin % 2 or cout % 8:
        raise ValueError(f"the GEMV kernels need an even cin and cout % 8 == 0, got {cin}, {cout}")
    want_dtype = torch.int8 if mode == "int8" else torch.uint8
    if (w.dim() != 2 or tuple(w.shape) != (rows_of_w, cout) or w.dtype != want_dtype
            or not w.is_contiguous() or w.data_ptr() % 8):
        raise ValueError(f"weights must be a contiguous, 8-byte aligned {want_dtype} [{rows_of_w}, {cout}] "
                         f"tensor, got {w.dtype} {tuple(w.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != cout or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous fp32 [1, {cout}] tensor")
    if gamma is not None:
        gamma = gamma.float().contiguous()
        if gamma.shape != (cin,):
            raise ValueError(f"gamma must be [{cin}], got {tuple(gamma.shape)}")
    if residual is not None:
        if residual.shape != (x.shape[0], cout):
            raise ValueError(f"residual must be [{x.shape[0]}, {cout}], got {tuple(residual.shape)}")
        residual = residual.float().contiguous()
    _check_on_card("the GEMV kernels", x, (("weights", w), ("scale", scale), ("gamma", gamma),
                                           ("residual", residual)))
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        err = _gemv_library().supir_qgemv(
            x.data_ptr(), x.stride(0), ptr(gamma), float(eps), prologue,
            w.data_ptr(), scale.data_ptr(), ptr(residual), out.data_ptr(),
            x.shape[0], cin, cout, _MODES[mode], _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"GEMV kernel launch failed ({mode}, prologue {prologue}): cudaError {err}")
    return out


def int4_paired_fused_matmul(x, packed, scale, *, gamma=None, eps: float = 1e-6,
                             siluglu: bool = False, residual=None):
    """K5: the fused decode projection, x [B, cin] (or [B, 2 cin] with
    siluglu) -> [B, cout] fp32; see int4_paired_fused_matmul_plain."""
    if gamma is not None and siluglu:
        raise ValueError("the RMSNorm and SiLU-GLU prologues are exclusive")
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_paired_fused_matmul_plain(x, packed, scale, gamma, eps, siluglu, residual)
    prologue = 1 if gamma is not None else (2 if siluglu else 0)
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


def qmm(x, q, scale, bits: int):
    """K7: x [B, cin] @ dequant(q) * scale -> [B, cout] fp32, q int8
    [cin, cout] (bits 8) or half-split uint8 [cin/2, cout] (bits 4)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return qmm_plain(x, q, scale, bits)
    cin = q.shape[0] if bits == 8 else 2 * q.shape[0]
    out = _launch_gemv(x, q, scale, "int8" if bits == 8 else "half", cin)
    qmm.launches += 1
    return out


def int8_matmul(x, q, scale):
    return qmm(x, q, scale, 8)


def int4_matmul(x, packed, scale):
    return qmm(x, packed, scale, 4)


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
int4_paired_matmul.launches = 0
qmm.launches = 0
quantize_int8.launches = 0
