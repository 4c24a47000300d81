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
     (on the tensor-core body: both phases' plans over one cooperative grid)
  K10 int4_w4a8_matmul         (_qmm_w4a8_kernel :191)    paired int4 weights x
     per-row int8 activations, exact int32 accumulation
  K11 int4_native_matmul       (_qmm_native_kernel :555)  GEMV against
     column-pair-packed int4 weights
K5, K6, K7 (int8 and half-split int4), K10, K5's act_int8 mode and K11
launch `csrc/quant_gemv_tc.cu` (TMA weight stream, `mma.sync`, k-slice
tiles planned in `ops/gemv_plan.py`; K10 and act_int8 on its integer
W4A8 layout, `mma.sync` m16n8k32 s8 with exact int32 sums) where the call
allows it at the default geometry (`gemv_plan.tc_eligible`: cin % 8 == 0
(half-split 16), cout % 16 == 0 (native 32) and 16-byte aligned weights
and activation rows, which every model shape meets), else the strip body
of `csrc/quant_gemv.cu`. K9 launches the same file's pair kernel where
`gemv_plan.tc_pair_eligible` holds (both weights as `tc_eligible` takes
them), else `csrc/quant_pair.cu`. K8 is `csrc/quantize_int8.cu`: one
cluster of CTAs per tile of columns, w read once into shared memory, the
column maxima exchanged over distributed shared memory (`int8_plan` lays
it out, `int8_emulate` and `int8_thread_map` walk it on the CPU). The
headers say what bounds each kernel on the card and how it is laid out.
The tensor-core body's weight tensor maps are encoded once per weight and
cached here (`_tc_map`), and each device keeps one partial-sum scratch, one
set of strip counters and K9's per-strip sums of squares (`_tc_scratch`),
so its launches must be ordered on one stream.

Launch geometry: `qmm` (K7, half-split int4), `int4_native_matmul` (K11)
and `int4_w4a8_matmul` (K10) take `strip=`, the output columns per block
(32, the default, or 64, 128, 256), and K10 also `split_k=` (1, the
default, 2 or 4 slices of the contraction summed exactly in int32). The
default is the geometry the model paths run (`csrc/quant_gemv.cu`); the
others are instances in `csrc/gemv_sweep.cu` for the decode-GEMV probes
(`supir_tpu_torch/tools/`). On a CPU tensor the keywords change nothing; on
a CUDA tensor a geometry that was not built raises.

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
import dataclasses
import functools

import torch

from supir_tpu_torch.ops import gemv_plan as GP

_GEMV_SOURCE = "quant_gemv.cu"
_QUANT_SOURCE = "quantize_int8.cu"
_PAIR_SOURCE = "quant_pair.cu"
_SWEEP_SOURCE = "gemv_sweep.cu"
_TC_SOURCE = "quant_gemv_tc.cu"
STRIP = 32                     # output columns per block on the model paths
GEMV_STRIPS = (32, 64, 128, 256)
W4A8_SPLITS = (1, 2, 4)
DECODE_ROWS = 32  # the largest activation the TPU functions send to a kernel
_MODES = {"paired": 0, "half": 1, "int8": 2, "native": 3, "w4a8": 4}


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


def w4a8_gemv_plain(xq, xs, packed, scale):
    """K10's kernel alone on int8 xq [B, in] (any dtype holding the
    integers) with its row scales xs [B, 1]: the integer dot against the
    paired weights, then * scale, then * (xs / 127), in that order."""
    out = _int_dot(xq, unpack_int4_paired(packed)) * scale.float()
    return out * (xs.float().reshape(-1, 1) * (1.0 / 127.0))


def int4_w4a8_matmul_plain(x, packed, scale):
    """x [B, in] float @ dequant(packed, adjacent pairs) -> [B, out] fp32
    through per-row int8 activations (quantize.py:250-257): the integer dot,
    then * scale, then * (xs / 127), in that order."""
    return w4a8_gemv_plain(*quantize_act_int8(x), packed, scale)


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


# K8's geometry (csrc/quantize_int8.cu's Q8_* constants): a cluster of
# `ranks` CTAs per tile of `cols` columns, rank r owning rows [r * rows,
# min((r + 1) * rows, cin)), loaded as `nboxes` TMA boxes of `box_rows`
# rows. The grid holds as many clusters as the card places at once, each
# walking every gridDim-th tile.
Q8_MAX_BOXES = 8
Q8_BOX_ROWS = 256             # TMA's largest box side
Q8_SMEM_MAX = 232448          # shared memory one CTA may use on the H100 (227 KB)
# a slice's bytes, and the CTA's threads: up to 55 KB four CTAs of 256
# threads share an SM, up to 110 KB two of 512 (more CTAs an SM hide the
# cluster exchange and the loads under the others' quantization: PERF.md
# §6)
Q8_SLICE_TIERS = ((55 * 1024, 256), (110 * 1024, 512))
Q8_FAULT_DROP_RANK = 1        # one rank's column maxima left out
Q8_FAULT_ROTATE_WORDS = 2     # each element takes the next Philox word
Q8_FAULT_SHIFT_TILE = 3       # the tile loaded one column to the right


@dataclasses.dataclass(frozen=True)
class Int8Plan:
    cin: int
    cout: int
    cols: int
    ranks: int
    rows: int
    box_rows: int
    nboxes: int
    threads: int
    smem: int

    @property
    def tiles(self) -> int:
        return -(-self.cout // self.cols)

    @property
    def portable(self) -> bool:
        return self.ranks <= 8

    @property
    def ranges(self):
        """Each rank's [first row, end row)."""
        return [(min(r * self.rows, self.cin), min((r + 1) * self.rows, self.cin)) for r in range(self.ranks)]


def int8_smem(cols: int, box_rows: int, nboxes: int, threads: int) -> int:
    """csrc/quantize_int8.cu's shared memory: the slice, the boxes'
    mbarriers, the warps' column maxima, two sets of the CTA's maxima, the
    tile's scales and the ranks' maxima (up to 16 ranks)."""
    return (nboxes * box_rows * cols * 4 + 8 * Q8_MAX_BOXES + (threads // 32) * cols * 4 + 3 * cols * 4
            + 16 * cols * 4)


def _box_rows(rows: int, nboxes: int, cols: int) -> int:
    """Rows of one TMA box: the slice over `nboxes` boxes, rounded up so
    that a box is a multiple of 128 bytes (each box lands 128-byte aligned)."""
    step = max(1, 32 // cols)
    return -(-(-(-rows // nboxes)) // step) * step


def int8_plan(cin: int, cout: int) -> Int8Plan:
    """K8's geometry for w [cin, cout]: tiles of 32 columns (128 bytes of a
    row; 16, 8 or 4 for matrices too tall for that), the first tier of
    Q8_SLICE_TIERS whose slice holds the fewest ranks' rows (a power of two,
    at most 16), the slice loaded as up to Q8_MAX_BOXES TMA boxes of equal
    rows."""
    for cols in (32, 16, 8, 4):
        for cap, threads in Q8_SLICE_TIERS:
            ranks = 1
            while ranks <= 16 and -(-cin // ranks) * cols * 4 > cap:
                ranks *= 2
            if ranks > 16:
                continue
            rows = -(-cin // ranks)
            while ranks > 1 and (ranks - 1) * rows >= cin:   # no empty rank
                ranks -= 1
            nboxes = -(-rows // Q8_BOX_ROWS)
            box_rows = _box_rows(rows, nboxes, cols)
            smem = int8_smem(cols, box_rows, nboxes, threads)
            if nboxes <= Q8_MAX_BOXES and smem <= Q8_SMEM_MAX and -(-cout // cols) <= 65535:
                return Int8Plan(cin, cout, cols, ranks, rows, box_rows, nboxes, threads, smem)
    raise ValueError(f"quantize_int8 kernel: no geometry for [{cin}, {cout}]")


def int8_emulate(w: torch.Tensor, plan: Int8Plan) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 in nearest mode on `plan`, in torch: each rank's column maxima
    over its row slice of each tile, their maximum over the ranks, then the
    plain version's scale and rounding."""
    amax = torch.zeros(plan.cout)
    a = w.float().abs()
    for tile in range(plan.tiles):
        c0, c1 = tile * plan.cols, min((tile + 1) * plan.cols, plan.cout)
        for r0, r1 in plan.ranges:
            if r1 > r0:
                amax[c0:c1] = torch.maximum(amax[c0:c1], a[r0:r1, c0:c1].amax(0))
    scale = amax.reshape(1, -1) * (1.0 / 127.0)
    q = torch.round(w.float() / scale.clamp_min(1e-12))
    return q.clamp(-127, 127).to(torch.int8), scale


def int8_thread_map(plan: Int8Plan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Philox (counter, word) each element of w takes in the kernel,
    and how many times the kernel quantizes it, as the kernel's loops
    compute them: where cout % 4 == 0, thread t of rank r and tile j takes
    columns 4 (t % tpr) .. + 3 of rows r * rows + t / tpr + i * rps (tpr =
    cols / 4 threads a row, rps = threads / tpr rows a step), one counter
    e / 4 of the first element e for all four, words 0..3; otherwise each
    element of the slice its own, e / 4 and e % 4. Returns int64 [cin,
    cout] counters, words and visits."""
    cin, cout, cols = plan.cin, plan.cout, plan.cols
    counter = torch.full((cin * cout,), -1, dtype=torch.int64)
    word = torch.full((cin * cout,), -1, dtype=torch.int64)
    visits = torch.zeros(cin * cout, dtype=torch.int64)
    tpr, t = cols // 4, torch.arange(plan.threads)
    rps = plan.threads // tpr
    for tile in range(plan.tiles):
        col0 = tile * cols
        for r0, r1 in plan.ranges:
            nrows = r1 - r0
            if cout % 4 == 0:
                steps = -(-nrows // rps)
                i = torch.arange(steps)[:, None]
                r = (i * rps + t[None, :] // tpr).reshape(-1)
                col = (col0 + 4 * (t % tpr))[None, :].expand(steps, -1).reshape(-1)
                live = (r < nrows) & (col < cout)
                e = (r0 + r[live]) * cout + col[live]
                for k in range(4):
                    counter[e + k] = e >> 2
                    word[e + k] = k
                    visits.index_add_(0, e + k, torch.ones_like(e))
            else:
                i = torch.arange(nrows * cols)
                r, c = i // cols, i % cols
                live = col0 + c < cout
                e = (r0 + r[live]) * cout + col0 + c[live]
                counter[e] = e >> 2
                word[e] = e & 3
                visits.index_add_(0, e, torch.ones_like(e))
    return counter.reshape(cin, cout), word.reshape(cin, cout), visits.reshape(cin, cout)


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


@functools.lru_cache(maxsize=None)
def _quant_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_QUANT_SOURCE)
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.supir_quantize_int8.restype = i
    lib.supir_quantize_int8.argtypes = [p, i, i, i, i, i, i, i, i, u64, i, p, p, i, i, p, ctypes.POINTER(ctypes.c_int)]
    lib.supir_quantize_int8_first.restype = i
    lib.supir_quantize_int8_first.argtypes = [p, i, i, p, u64, i, p, p, p]
    return lib


def _sweep_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_SWEEP_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.supir_qgemv_geo.restype = i
    lib.supir_qgemv_geo.argtypes = [p, i, p, p, p, i, i, i, i, i, p]
    lib.supir_qgemv_w4a8_geo.restype = i
    lib.supir_qgemv_w4a8_geo.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, p]
    lib.supir_qgemv_strip.restype = i
    lib.supir_qgemv_strip.argtypes = [p, i, p, ctypes.c_float, i, p, p, p, p, i, i, i, i, p]
    return lib


@functools.lru_cache(maxsize=None)
def _tc_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_TC_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.supir_qgemv_tc.restype = i
    lib.supir_qgemv_tc.argtypes = [p, p, i, p, i, p, p, f, i, p, p, p, p, p, i, p]
    lib.supir_qgemv_tc_map.restype = i
    lib.supir_qgemv_tc_map.argtypes = [p, ctypes.c_longlong, ctypes.c_longlong, i, i, i, p]
    lib.supir_qpair_tc.restype = i
    lib.supir_qpair_tc.argtypes = [p, p, p, p, i, i, p, p, p, p, p, f, i, p, p, p, p, p, i, p]
    return lib


SOURCES = (_GEMV_SOURCE, _QUANT_SOURCE, _PAIR_SOURCE, _SWEEP_SOURCE, _TC_SOURCE)  # for cuda_build.build_all


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
                 prologue: int = 0, residual=None, strip: int = STRIP, _fault: int = 0) -> torch.Tensor:
    """One launch over x [B, cin] (or [B, 2 cin] with the SiLU-GLU prologue)
    bf16; returns [B, cout] fp32. At the default strip every layout goes to
    the tensor-core body (`csrc/quant_gemv_tc.cu`) when
    `gemv_plan.tc_eligible` holds, everything else to the strip body of
    `csrc/quant_gemv.cu`; another strip (half-split and native int4, no
    prologue, no residual) launches `csrc/gemv_sweep.cu`. `_fault` plants
    one of the tensor-core body's faults (gemv_plan.FAULT_*), for checks
    only."""
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
    if strip == STRIP and GP.tc_eligible(mode, cin, cout, w.data_ptr(), x.data_ptr(), x.stride(0)):
        return _launch_tc(x, w, scale, mode, cin, cout, gamma, eps, prologue, residual, out, _fault)
    if _fault:
        raise ValueError(f"planted faults are the tensor-core body's; this call ({mode}, cout {cout}) takes the "
                         "strip body")
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


_TC_MAPS: dict = {}       # (device, weight address, rows, row bytes, box) -> (buffer, its address)
_TC_SCRATCH: dict = {}    # device index -> (partials, strip counters, K9's sums of squares, their addresses)
_TC_PLANS: dict = {}      # (mode, rows, cin, cout, device index, slices) -> (plan, its packed fields' address)
_PAIR_PLANS: dict = {}    # (rows, cin1, cout1, cout2, device index) -> (plan, its packed fields' address)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tc_map(w: torch.Tensor, plan: GP.TcPlan, index: int) -> int:
    """The address of w's encoded tensor map (128 bytes), encoded at the
    first launch over this weight and kept: a map depends only on the
    address, extent and box, which a weight never changes."""
    key = (index, w.data_ptr(), plan.wrows, plan.wcols, plan.box_rows, plan.box_bytes)
    hit = _TC_MAPS.get(key)
    if hit is None:
        if len(_TC_MAPS) >= 8192:
            _TC_MAPS.clear()
        buf = (ctypes.c_ubyte * 128)()
        # the box is one strip's bytes of a row, and the swizzle spans it
        err = _tc_library().supir_qgemv_tc_map(w.data_ptr(), plan.wrows, plan.wcols, plan.box_rows, plan.box_bytes,
                                               plan.box_bytes, ctypes.addressof(buf))
        if err != 0:
            raise RuntimeError(f"the GEMV weight's tensor map failed to encode ({plan.wrows} x {plan.wcols} bytes): "
                               f"{'CUresult ' + str(-err) if err < 0 else 'cudaError ' + str(err)}")
        hit = _TC_MAPS[key] = (buf, ctypes.addressof(buf))
    return hit[1]


def _tc_scratch(device: torch.device):
    """The device's partial sums (gemv_plan.TC_PART_BYTES of fp32, which
    every plan stays within), strip counters (zero; each launch leaves them
    zero) and K9's per-strip sums of squares (fp32 [strips x rows]).
    Allocated once, so a captured CUDA graph keeps valid addresses. Returns
    (partials, counters, sums of squares) and their addresses."""
    hit = _TC_SCRATCH.get(device.index)
    if hit is None:
        part = torch.empty(GP.TC_PART_BYTES // 4, dtype=torch.float32, device=device)
        counters = torch.zeros(GP.TC_MAX_STRIPS, dtype=torch.int32, device=device)
        ssq = torch.zeros(GP.TC_MAX_STRIPS * GP.TC_MAX_ROWS, dtype=torch.float32, device=device)
        hit = _TC_SCRATCH[device.index] = (part, counters, ssq, part.data_ptr(), counters.data_ptr(), ssq.data_ptr())
    return hit


def _launch_tc(x, w, scale, mode, cin, cout, gamma, eps, prologue, residual, out, fault=0, xs=None, slices=None):
    """One launch of `csrc/quant_gemv_tc.cu` (K5, K6, K7, K10, K11); xs:
    K10's row scales (W4A8 only); `slices`: the probes' k-slices per strip
    (T1c, T2, T3b, T4b) in place of the plan's."""
    if gamma is not None and gamma.data_ptr() % 16:
        gamma = gamma.clone()  # the kernel reads gamma in 16-byte vectors
    device = x.device
    index = device.index
    key = (mode, x.shape[0], cin, cout, index, slices)
    hit = _TC_PLANS.get(key)
    if hit is None:
        plan = GP.tc_plan(mode, x.shape[0], cin, cout, _sm_count(index), slices)
        hit = _TC_PLANS[key] = (plan, ctypes.addressof(plan.packed()))
    plan, plan_addr = hit
    part, counters = _tc_scratch(device)[3:5]
    with torch.cuda.device(device):
        err = _tc_library().supir_qgemv_tc(
            _tc_map(w, plan, index), plan_addr, _MODES[mode], x.data_ptr(), x.stride(0), _ptr(xs), _ptr(gamma),
            float(eps), prologue, scale.data_ptr(), _ptr(residual), out.data_ptr(), part, counters, fault,
            _stream(device))
    if err != 0:
        raise RuntimeError(f"tensor-core GEMV launch failed ({mode}, prologue {prologue}, {x.shape[0]} rows): "
                           f"cudaError {err}")
    return out


def strip_body_gemv(x, w, scale, mode: str, gamma=None, eps: float = 1e-6, siluglu: bool = False,
                    residual=None) -> torch.Tensor:
    """The strip body (K5, K6, K7 and K11's kernel before the tensor-core
    body) at the model paths' geometry: for comparing it with the
    tensor-core body on one card. No model path calls it, and it counts no
    launch. x bf16 [B, cin] ([B, 2 cin] with siluglu); w paired uint8
    [cin/2, cout] (mode "paired", from `csrc/gemv_sweep.cu`), int8 [cin,
    cout] ("int8", the same), half-split uint8 [cin/2, cout] ("half") or
    native uint8 [cin, cout/2] ("native"), these two without prologue or
    residual from `csrc/quant_gemv.cu`, which still launches them for the
    calls the tensor-core body does not take. W4A8's strip body is
    `strip_body_w4a8`."""
    if mode not in _MODES or mode == "w4a8":
        raise ValueError(f"the strip body's layouts are {sorted(_MODES)}, not {mode}")
    cin = 2 * w.shape[0] if mode in ("paired", "half") else w.shape[0]
    cout = 2 * w.shape[1] if mode == "native" else w.shape[1]
    prologue = 1 if gamma is not None else (2 if siluglu else 0)
    if mode in ("half", "native") and (prologue or residual is not None):
        raise ValueError(f"the strip body takes no prologue or residual in the {mode} layout")
    _check_activation(x, 2 * cin if prologue == 2 else cin)
    _check_weights(w, scale, w.shape[0], w.shape[1], cout, torch.int8 if mode == "int8" else torch.uint8)
    gamma, residual = _gamma_residual(gamma, residual, cin, x.shape[0], cout)
    _check_on_card("the strip body", x, (("weights", w), ("scale", scale), ("gamma", gamma), ("residual", residual)))
    out = torch.empty((x.shape[0], cout), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        if mode in ("half", "native"):
            err = _gemv_library().supir_qgemv(
                x.data_ptr(), x.stride(0), None, float(eps), 0, w.data_ptr(), scale.data_ptr(), None,
                out.data_ptr(), x.shape[0], cin, cout, _MODES[mode], _stream(x.device))
        else:
            err = _sweep_library().supir_qgemv_strip(
                x.data_ptr(), x.stride(0), _ptr(gamma), float(eps), prologue, w.data_ptr(), scale.data_ptr(),
                _ptr(residual), out.data_ptr(), x.shape[0], cin, cout, _MODES[mode], _stream(x.device))
    if err != 0:
        raise RuntimeError(f"strip-body GEMV launch failed ({mode}, prologue {prologue}): cudaError {err}")
    return out


def strip_body_w4a8(x, xs, packed, scale, gamma=None, eps: float = 1e-6, siluglu: bool = False,
                    residual=None) -> torch.Tensor:
    """The strip body (K10 and K5's act_int8 mode before the tensor-core
    body, `csrc/quant_gemv.cu`'s `__dp4a` kernel) at the model paths'
    geometry, for comparing it with the tensor-core body on one card: x
    int8 with its row scales xs (K10), or bf16 x with xs None, through the
    prologue and quantized in the kernel (act_int8). No model path calls it,
    and it counts no launch."""
    prologue = 1 if gamma is not None else (2 if siluglu else 0)
    return _launch_w4a8(x, xs, packed, scale, gamma, eps, prologue, residual, _tensor_cores=False)


def _launch_w4a8(x, xs, packed, scale, gamma=None, eps: float = 1e-6, prologue: int = 0,
                 residual=None, strip: int = STRIP, split_k: int = 1, skip_split: int = -1, _fault: int = 0,
                 _tensor_cores: bool = True) -> torch.Tensor:
    """One call of the W4A8 GEMV: x int8 [B, cin] with its row scales xs
    fp32 [B, 1] (K10), or x bf16 [B, cin] (or [B, 2 cin]) that the kernel
    runs through the prologue and quantizes itself (K5's act_int8 mode, xs
    None); returns [B, cout] fp32. At the default geometry the tensor-core
    body (`csrc/quant_gemv_tc.cu`, W4A8 layout; one launch a block of
    `gemv_plan.TC_W4A8_ROWS` rows) takes every call
    `gemv_plan.tc_eligible` allows, the strip body of `csrc/quant_gemv.cu`
    the rest (and `strip_body_w4a8`'s); another strip or split-K (K10's
    form only) launches `csrc/gemv_sweep.cu`. `skip_split` leaves one slice
    out and `_fault` plants one of the tensor-core body's faults
    (gemv_plan.FAULT_*), for checks only."""
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
    if (_tensor_cores and (strip, split_k) == (STRIP, 1)
            and GP.tc_eligible("w4a8", cin, cout, packed.data_ptr(), x.data_ptr(), x.stride(0))):
        if x.shape[0] <= GP.TC_W4A8_ROWS:
            return _launch_tc(x, packed, scale, "w4a8", cin, cout, gamma, eps, prologue, residual, out, _fault, xs)
        # at most TC_W4A8_ROWS rows a launch: row blocks of 16 keep 16-byte aligned rows
        for r0 in range(0, x.shape[0], GP.TC_W4A8_ROWS):
            rs = slice(r0, r0 + GP.TC_W4A8_ROWS)
            _launch_tc(x[rs], packed, scale, "w4a8", cin, cout, gamma, eps, prologue,
                       None if residual is None else residual[rs], out[rs], _fault, None if xs is None else xs[rs])
        return out
    if _fault:
        raise ValueError(f"planted faults are the tensor-core body's; this W4A8 call (cout {cout}) takes the strip "
                         "body")
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
    half-split instance also at another `strip` (T1c's first design)."""
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
    return out


def int8_matmul(x, q, scale):
    return qmm(x, q, scale, 8)


def int4_w4a8_matmul(x, packed, scale, strip: int = STRIP, split_k: int = 1):
    """K10: x [B, cin] float @ dequant(packed, adjacent pairs) -> [B, cout]
    fp32 through per-row int8 activations; see int4_w4a8_matmul_plain. The
    activation quantizer runs as torch ops before the launch, as XLA runs
    it outside the TPU kernel (quantize.py:227); the kernel applies the
    weight scales and then the row scales xs / 127. At the default geometry
    it runs on the tensor-core body; `strip` columns per block and `split_k`
    slices of the contraction select the strip body's probe instances."""
    check_geometry(strip, split_k)
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_w4a8_matmul_plain(x, packed, scale)
    xq, xs = quantize_act_int8(x)
    out = _launch_w4a8(xq, xs, packed, scale, strip=strip, split_k=split_k)
    int4_w4a8_matmul.launches += 1
    return out


def int4_native_matmul(x, packed, scale, strip: int = STRIP):
    """K11: x [B, cin] bf16 @ dequant(packed, column pairs) * scale ->
    [B, cout] fp32; packed uint8 [cin, cout/2] from quantize_int4_native;
    at `strip` columns per block (T4b runs 256)."""
    check_geometry(strip)
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_native_matmul_plain(x, packed, scale)
    out = _launch_gemv(x, packed, scale, "native", packed.shape[0], strip=strip)
    int4_native_matmul.launches += 1
    return out


def pair_grid_blocks(rows: int = 1) -> int:
    """The strip-body K9's grid on this card for `rows` activation rows: the
    blocks that can be resident at once (blocks per SM from the occupancy
    API x SMs), which its cooperative launch may not exceed."""
    blocks = ctypes.c_int(0)
    err = _pair_library().supir_qpair_grid(rows, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"K9 occupancy query failed: cudaError {err}")
    return blocks.value


def int4_paired_fused_pair(x, qp1, sc1, residual, gamma, qp2, sc2, *, siluglu1: bool = False,
                           eps: float = 1e-6, _norm_cols: int | None = None, _fault: int = 0):
    """K9: two chained paired-int4 GEMVs in one cooperative launch ->
    (small [B, cout1], big [B, cout2]) fp32; see int4_paired_fused_pair_plain.
    On the card the RMSNorm reads `small` in fp32, as the TPU kernel does,
    where the plain version rounds it to x's dtype first. Where
    `gemv_plan.tc_pair_eligible` holds (every 13B shape) the launch is the
    tensor-core body's pair kernel, else the strip body of
    `csrc/quant_pair.cu`. For planted-fault checks only: `_norm_cols` takes
    the RMSNorm's statistics from the first `_norm_cols` columns of `small`,
    `_fault` plants one of the tensor-core pair's faults (gemv_plan:
    FAULT_DROP_SHARE, FAULT_COMBINE_TWICE (phase 1's), FAULT_X_ORDER,
    FAULT_STALE_SMALL, FAULT_ONE_STRIP)."""
    _check_pair_shapes(qp1, qp2)
    if x.device.type == "cpu" or x.shape[0] > DECODE_ROWS:
        return int4_paired_fused_pair_plain(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1=siluglu1, eps=eps)
    out = _launch_pair(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1, eps, _norm_cols, _fault)
    int4_paired_fused_pair.launches += 1
    return out


def strip_body_pair(x, qp1, sc1, residual, gamma, qp2, sc2, *, siluglu1: bool = False, eps: float = 1e-6):
    """K9's strip body (`csrc/quant_pair.cu`, its kernel before the
    tensor-core pair), for comparing the two on one card. No model path
    calls it, and it counts no launch."""
    _check_pair_shapes(qp1, qp2)
    return _launch_pair(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1, eps, None, 0, tensor_cores=False)


def _launch_pair(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1, eps, norm_cols, fault, tensor_cores=True):
    """One K9 launch on CUDA tensors: the tensor-core pair where
    `gemv_plan.tc_pair_eligible` holds (and `tensor_cores`), else the strip
    body. A launch the card refuses raises; it is never split in two."""
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
    norm_cols = cout1 if norm_cols is None else norm_cols
    if not 0 < norm_cols <= cout1:
        raise ValueError(f"K9's statistics take 1-{cout1} columns of small, not {norm_cols}")
    rows = x.shape[0]
    small = torch.empty((rows, cout1), dtype=torch.float32, device=x.device)
    big = torch.empty((rows, cout2), dtype=torch.float32, device=x.device)
    if tensor_cores and GP.tc_pair_eligible(rows, cin1, cout1, cout2, qp1.data_ptr(), qp2.data_ptr(), x.data_ptr(),
                                            x.stride(0)):
        return _launch_pair_tc(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1, eps, norm_cols, fault, small, big)
    if fault:
        raise ValueError(f"planted faults are the tensor-core pair's; this call (cout1 {cout1}, cout2 {cout2}) takes "
                         "the strip body")
    with torch.cuda.device(x.device):
        err = _pair_library().supir_qpair(
            x.data_ptr(), x.stride(0), int(siluglu1), qp1.data_ptr(), sc1.data_ptr(), residual.data_ptr(),
            gamma.data_ptr(), qp2.data_ptr(), sc2.data_ptr(), small.data_ptr(), big.data_ptr(),
            rows, cin1, cout1, cout2, float(eps), norm_cols, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"K9 cooperative launch failed: cudaError {err}")
    return small, big


def _launch_pair_tc(x, qp1, sc1, residual, gamma, qp2, sc2, siluglu1, eps, norm_cols, fault, small, big):
    """One launch of `csrc/quant_gemv_tc.cu`'s pair kernel."""
    if gamma.data_ptr() % 16:
        gamma = gamma.clone()  # the kernel reads gamma in 16-byte vectors
    device = x.device
    index = device.index
    rows, cin1, cout1, cout2 = x.shape[0], 2 * qp1.shape[0], qp1.shape[1], qp2.shape[1]
    key = (rows, cin1, cout1, cout2, index)
    hit = _PAIR_PLANS.get(key)
    if hit is None:
        plan = GP.tc_pair_plan(rows, cin1, cout1, cout2, _sm_count(index))
        hit = _PAIR_PLANS[key] = (plan, ctypes.addressof(plan.packed()))
    plan, plan_addr = hit
    part, counters, ssq = _tc_scratch(device)[3:]
    # FAULT_STALE_SMALL: phase 2 reads `small` as it stood at launch, zeros
    small_in = torch.zeros_like(small) if fault == GP.FAULT_STALE_SMALL else small
    with torch.cuda.device(device):
        err = _tc_library().supir_qpair_tc(
            _tc_map(qp1, plan.first, index), _tc_map(qp2, plan.second, index), plan_addr, x.data_ptr(), x.stride(0),
            int(siluglu1), sc1.data_ptr(), residual.data_ptr(), small.data_ptr(), small_in.data_ptr(),
            gamma.data_ptr(), float(eps), norm_cols, sc2.data_ptr(), big.data_ptr(), part, counters, ssq, fault,
            _stream(device))
    if err != 0:
        raise RuntimeError(f"K9's tensor-core launch failed ({rows} rows, {cin1} -> {cout1} -> {cout2}): "
                           f"cudaError {err}")
    return small, big


def int4_matmul(x, packed, scale, strip: int = STRIP):
    return qmm(x, packed, scale, 4, strip)


def quantize_int8(w: torch.Tensor, seed: int = 0, stochastic: bool = True):
    """K8: w [in, out] -> (q int8 [in, out], scale fp32 [1, out]), rounding
    stochastically with u drawn from `seed`, or to nearest. On the CPU the
    plain version draws u from a torch.Generator seeded with `seed`; on the
    card one cluster launch (`csrc/quantize_int8.cu`, `int8_plan`) reads w
    once and draws u from Philox, so the two differ bit for bit in
    stochastic mode and agree in nearest mode."""
    if w.device.type == "cpu":
        u = None
        if stochastic:
            u = torch.rand(w.shape, generator=torch.Generator().manual_seed(seed))
        return quantize_int8_plain(w, u)
    _check_int8(w)
    out = _launch_int8(w, seed, stochastic, _int8_plan(*w.shape))
    quantize_int8.launches += 1
    return out


def _check_int8(w: torch.Tensor) -> None:
    _check_on_card("quantize_int8", w, ())
    if w.dim() != 2 or w.dtype != torch.float32 or not w.is_contiguous() or 0 in w.shape:
        raise ValueError(f"quantize_int8 takes a contiguous fp32 [in, out] tensor, got {w.dtype} {tuple(w.shape)}")


_int8_plan = functools.lru_cache(maxsize=64)(int8_plan)


def _launch_int8(w, seed: int, stochastic: bool, plan: Int8Plan, fault: int = 0):
    """One launch of K8's cluster kernel on `plan`; returns (q, scale)."""
    cin, cout = w.shape
    q = torch.empty((cin, cout), dtype=torch.int8, device=w.device)
    scale = torch.empty((1, cout), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _quant_library().supir_quantize_int8(
            w.data_ptr(), cin, cout, plan.cols, plan.ranks, plan.rows, plan.box_rows, plan.nboxes, plan.threads,
            seed & (2**64 - 1), int(stochastic), q.data_ptr(), scale.data_ptr(), plan.smem, fault,
            _stream(w.device), None)
    if err != 0:
        why = "the cluster cannot be placed on this card" if err == -1 else (
            f"CUresult {-err} (tensor map)" if err < 0 else f"cudaError {err}")
        raise RuntimeError(f"quantize_int8 kernel launch failed ([{cin}, {cout}], {plan.ranks} ranks): {why}")
    return q, scale


def int8_clusters(plan: Int8Plan) -> int:
    """How many clusters of `plan` the current card holds at once
    (cudaOccupancyMaxActiveClusters); 0: the plan cannot be launched."""
    out = ctypes.c_int(0)
    err = _quant_library().supir_quantize_int8(None, plan.cin, plan.cout, plan.cols, plan.ranks, plan.rows,
                                               plan.box_rows, plan.nboxes, plan.threads, 0, 0, None, None,
                                               plan.smem, 0, None, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"quantize_int8 occupancy query failed: cudaError {err}")
    return out.value


def quantize_int8_first_design(w: torch.Tensor, seed: int = 0, stochastic: bool = True):
    """K8's first design (`supir_quantize_int8_first`: a zeroed amax scratch, the
    column maxima by atomicMax over 64-row slabs, then a second read of w to
    quantize), for the comparisons on the card only; the same seed gives
    the same bytes as `quantize_int8`."""
    _check_int8(w)
    cin, cout = w.shape
    amax = torch.zeros(cout, dtype=torch.int32, device=w.device)
    q = torch.empty((cin, cout), dtype=torch.int8, device=w.device)
    scale = torch.empty((1, cout), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        err = _quant_library().supir_quantize_int8_first(
            w.data_ptr(), cin, cout, amax.data_ptr(), seed & (2**64 - 1), int(stochastic),
            q.data_ptr(), scale.data_ptr(), _stream(w.device))
    if err != 0:
        raise RuntimeError(f"quantize_int8 first design launch failed: cudaError {err}")
    return q, scale


int4_paired_fused_matmul.launches = 0
int4_paired_fused_matmul.act_int8_launches = 0
int4_paired_matmul.launches = 0
int4_w4a8_matmul.launches = 0
int4_native_matmul.launches = 0
int4_paired_fused_pair.launches = 0
qmm.launches = 0
quantize_int8.launches = 0
