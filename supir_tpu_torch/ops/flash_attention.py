"""Flash attention, written by hand in CUDA C++ for Hopper: the forward K1,
the forward with logsumexp K3, and the backward K4.

- K1 replaces `supir_tpu/ops/flash_attention.py:_attn_kernel_packed` (:35)
  and `_attn_kernel_packed_single` (:123), launched from `_flash_primal`
  (:363): softmax(Q K^T / sqrt(D)) V over [B, S, H, D] with a ragged last kv
  block, and with the TPU kernels' causal mask (query i sees keys 0..i,
  S == T). Source `supir_tpu_torch/csrc/flash_attn_fwd.cu`.
- K3 replaces `_attn_kernel` (:164) with `with_lse`, launched from
  `_flash_fwd_lse` (:434, `pallas_call` :459): the same forward, plus each
  query row's natural-log logsumexp of the scaled scores, [B, H, S] fp32.
  It is K1's kernel instantiated with a flag, in the same source.
- K4 replaces `_bwd_dq_kernel` (:499) and `_bwd_dkv_kernel` (:539),
  launched from `_flash_bwd` (:592): dQ, dK and dV from the residuals q, k,
  v, out and lse and the output gradient. Source
  `supir_tpu_torch/csrc/flash_attn_bwd.cu`.
Each source's header says what bounds it on the card and how it is laid out.

ALiBi (MPT's positional bias; the TPU kernels' `alibi` branch, :197-201 and
`_bwd_scores` :481-497): every function here takes `alibi_slopes`, fp32 [H]
(a tensor or anything `torch.as_tensor` takes), and adds
slope_h * (col - (T - 1)) to head h's scaled scores before the mask, T the
key length; the lse is then that of the biased scores, and the backward
re-adds the bias. The kernels take the slopes as a runtime pointer, in bf16
(K3 ALiBi in `flash_attn_fwd.cu`, K4 ALiBi in `flash_attn_bwd.cu`) and in
fp32 (K3 ALiBi fp32 in `flash_attn_fwd_fp32.cu`, K4 ALiBi fp32 in
`flash_attn_bwd_fp32.cu`). ALiBi is never head-packed on the TPU (:339), so
its forward is `_attn_kernel`, K3's kernel, with or without the lse: a
wrapper's ALiBi launches are counted in `<wrapper>.alibi_launches` (bf16)
and `<wrapper>.alibi_fp32_launches` (fp32), apart from `launches` and
`fp32_launches`.

Routing under autograd, as the JAX function is differentiable through its
`custom_vjp` (`_make_diff_fn`, :305-325): the kernel wrappers
`flash_attention`, `flash_attention_fwd_lse` and `flash_attention_bwd` write
into fresh tensors, so they serve only calls where nothing is
differentiated, and raise when grad mode is on and an input requires grad.
`FlashAttention` is the counterpart of the `custom_vjp`: its forward runs
K3 and saves q, k, v, out and lse, its backward runs K4.

K1 fp32 is K1 for fp32 q, k and v, as the TPU kernels run in the
inputs' dtype (`_flash_primal`'s `out_shape`, :373): an engine with fp32
parameters (`--full_params`, `--diff_dtype fp32`) attends in fp32. Its
source, `supir_tpu_torch/csrc/flash_attn_fwd_fp32.cu`, runs on the tensor
cores at TF32 with fp32-grade accuracy (3xTF32): every operand is split
into a TF32 high part and the TF32 of the rest (`tf32_split`,
`tf32_operand`), and every product of Q K^T and P V is taken as three
wgmma products (lo hi + hi lo + hi hi), fed by TMA (`tma_plan` of fp32
operands: 32-column slabs); V is written transposed in the key order of
`VT_KEY`, which lets P go from S's accumulator to the A operand in
registers. `flash_attention` launches it for fp32 inputs and counts those
calls in `flash_attention.fp32_launches`, apart from `launches`.
`flash_fp32_emulate` walks its warpgroups, tiles, TF32 roundings and
products on the CPU.

K3 fp32 and K4 fp32 are K3 and K4 for fp32 operands, as `_flash_fwd_lse`
and `_flash_bwd` write in q's dtype (:467-470, :637, :663): the fp32 ring
(`parallel/ring_attention.py`) and the trainers whose model computes in
fp32 (`FlashAttention` under grad) run them. K3 fp32 is K1 fp32's kernel
with an lse output (`flash_attention_fwd_lse` counts it in
`fp32_launches`); K4 fp32, `supir_tpu_torch/csrc/flash_attn_bwd_fp32.cu`,
is K4's split (a delta pre-pass, a dQ kernel, a dK/dV kernel) in 3xTF32
on `wgmma` as K1 fp32 is, fed by TMA (`tma_plan` at BWD_FP32_BOX rows),
with K^T, Q^T and dO^T written in the `VT_KEY` order, counted in
`flash_attention_bwd.fp32_launches`; `flash_bwd_fp32_emulate` walks its
blocks, tiles, TF32 roundings and products on the CPU. Their ALiBi
instances serve MPT at its default dtype: `MPTBlock` and `MPTForCausalLM`
compute in fp32 unless told otherwise (`supir_tpu/captioner/mpt.py:113,
:195`), and on a TPU every such self-attention site of 1024 tokens or more
runs the Pallas ALiBi kernel in fp32, its backward too under `jax.grad`.
K3 ALiBi fp32 rounds the biased scores as the TPU kernel does (:193-201),
scale * q.k and the bias each rounded to fp32 before their sum, and runs
its softmax in those units (the source says why); `flash_fp32_emulate`
takes the slopes too.

Each wrapper, on a CPU tensor, returns its plain version (`attention_plain`,
`attention_fwd_lse_plain`, `attention_bwd_plain`); on a CUDA tensor it
launches its kernel or raises. `<wrapper>.launches` counts launching calls.

The forwards read q, k and v, the backward q, k, v and dout, through TMA
tensor maps. `tma_plan` lays each one out in Python (dims innermost-first,
byte strides, box, and where the seq, head and batch coordinates go), so
the CPU tests reach it; the C side only encodes the plan
(`cuTensorMapEncodeTiled`) and raises nothing itself: a failed encode comes
back as a negative code and the wrapper raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from supir_tpu_torch.ops.grad_guard import refuse_grad

_FWD_SOURCE = "flash_attn_fwd.cu"
_BWD_SOURCE = "flash_attn_bwd.cu"
_FP32_SOURCE = "flash_attn_fwd_fp32.cu"
_BWD_FP32_SOURCE = "flash_attn_bwd_fp32.cu"
SOURCES = (_FWD_SOURCE, _BWD_SOURCE, _FP32_SOURCE, _BWD_FP32_SOURCE)  # for cuda_build.build_all
HEAD_DIMS = (64, 128)
# the forward's tiles (csrc/flash_attn_fwd.cu: BM, BN, SLAB)
BLOCK_M = 128  # query rows per block: two consumer warpgroups of 64
BLOCK_N = 128  # keys per K/V tile
SLAB = 64      # head-dim columns per 128-byte swizzle slab (one TMA box)
PLAN_LEN = 15  # values of a packed plan: rank, dims[4], strides[3], box[4], positions[3]
# the backward's tiles (csrc/flash_attn_bwd.cu: BLOCK, BOX)
BWD_BLOCK = 128  # rows a backward block owns; the lse/delta scratch is padded to it
BWD_BOX = 64     # rows of every backward TMA box (q, k, v and dout)
# K1 fp32's tiles (csrc/flash_attn_fwd_fp32.cu: Tiles<D>::BM, BN): head dim
# -> (query rows a block, keys a tile); every warpgroup takes 64 of a block's rows
FP32_TILES = {64: (128, 64), 128: (64, 32)}
FP32_WG_ROWS = 64
LOG2E = 1.4426950408889634  # the kernels' fp32 log2(e), folded into the scale
LN2 = 0.6931471805599453
# K1 fp32's planted faults: the accumulator not rescaled when the max rises,
# the ragged last key tile not masked, the causal diagonal not masked, S on
# one product (hi hi: plain TF32), P V without V's lo part, V^T written in
# key order (without the fragment permutation)
(FP32_FAULT_NO_RESCALE, FP32_FAULT_RAGGED, FP32_FAULT_DIAGONAL, FP32_FAULT_ONE_PRODUCT, FP32_FAULT_NO_V_LO,
 FP32_FAULT_VT_ORDER) = range(1, 7)
FP32_FAULT_LSE_LOG2 = 7  # K3 fp32 only: the lse written in log2 units (O untouched)
# K3 ALiBi fp32's planted faults (with slopes only): the bias added to the raw
# q.k before the scale (the slope in the wrong units), the -(T - 1) offset
# dropped (the lse moves by slope_h (T - 1), O does not in exact arithmetic)
FP32_FAULT_ALIBI_RAW_UNITS, FP32_FAULT_ALIBI_NO_OFFSET = 8, 9
# K4 fp32's planted faults (csrc/flash_attn_bwd_fp32.cu): delta dropped, dK
# without the scale, the causal diagonal not masked, P read with the lse in
# log2 units, every product on one TF32 product (hi hi: plain TF32), the lo
# part of the transposed operands (K^T, Q^T, dO^T) dropped, the transposed
# operands written in row order (without the fragment permutation)
(BWD_FP32_FAULT_NO_DELTA, BWD_FP32_FAULT_DK_SCALE, BWD_FP32_FAULT_DIAGONAL, BWD_FP32_FAULT_LSE_LOG2,
 BWD_FP32_FAULT_ONE_PRODUCT, BWD_FP32_FAULT_NO_T_LO, BWD_FP32_FAULT_T_ORDER) = range(1, 8)
# K4 fp32's tiles (csrc/flash_attn_bwd_fp32.cu: ROWS, R): rows a block owns
# (queries in the dQ kernel, keys in the dK/dV kernel), rows of a streamed
# tile and of every TMA box
BWD_FP32_ROWS = 64
BWD_FP32_BOX = 32
TF32_HALF = 0x1000  # half a TF32 ulp, in the fp32 bits
TF32_KEEP = -0x2000  # 0xFFFFE000 as an int32: the bits of an fp32 word a TF32 operand keeps


@dataclasses.dataclass(frozen=True)
class TmaPlan:
    """One operand's TMA tensor map as the forward kernel encodes it.

    dims: element counts innermost-first, (D, seq[, head][, batch]);
    strides: byte strides of dims[1:]; box: the copy's extent per dim,
    (SLAB, rows, 1, ...): one 128-byte swizzle slab of `rows` rows, so a
    D = 128 tile is two copies; seq, head, batch: the map position
    of each coordinate, -1 for an axis dropped from the map (stride 0, as
    MPT's multiquery k/v expanded over heads, or extent 1). The kernel then
    passes no coordinate for it."""

    dims: tuple[int, ...]
    strides: tuple[int, ...]
    box: tuple[int, ...]
    seq: int
    head: int
    batch: int

    def packed(self) -> list[int]:
        """The PLAN_LEN values the C entry points read."""
        def pad(xs, n):
            return list(xs) + [0] * (n - len(xs))

        return ([len(self.dims)] + pad(self.dims, 4) + pad(self.strides, 3) + pad(self.box, 4)
                + [self.seq, self.head, self.batch])


def tma_plan(x: torch.Tensor, rows: int) -> TmaPlan:
    """The tensor map of a [B, N, H, D] bf16 or fp32 operand read in boxes
    of `rows` rows (the forward: BLOCK_M for q, BLOCK_N for k and v; the
    backward: BWD_BOX for q, k, v and dout; K1 fp32: FP32_TILES), one
    128-byte slab of columns a box (SLAB bf16, 32 fp32). Raises ValueError
    on what TMA cannot take: a head dim that is not contiguous or not a
    whole number of slabs, a base address that is not 16-byte aligned, or a
    kept stride that is not a multiple of 16 bytes."""
    slab = 128 // x.element_size()
    if x.dim() != 4 or x.shape[-1] % slab or x.stride(-1) != 1:
        raise ValueError(f"a TMA plan wants [B,N,H,D] with a contiguous D a multiple of {slab}; got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base address; this view starts {x.data_ptr() % 16} bytes off")
    return _layout_plan(tuple(x.shape), x.stride(), x.element_size(), rows)


@functools.lru_cache(maxsize=256)
def _layout_plan(shape, stride, size: int, rows: int) -> TmaPlan:
    """tma_plan's layout part, which depends on shape and strides alone:
    cached, since the main path calls the same few layouts thousands of
    times."""
    b, n, h, d = shape
    dims, strides, box, pos = [d], [], [128 // size], {}
    for name, extent, step, keep in (("seq", n, stride[1], True), ("head", h, stride[2], False),
                                     ("batch", b, stride[0], False)):
        if not keep and (step == 0 or extent == 1):
            pos[name] = -1
            continue
        if (step * size) % 16:
            raise ValueError(f"TMA needs {name} strides in multiples of 16 bytes; got {step * size} bytes")
        pos[name] = len(dims)
        dims.append(extent)
        strides.append(step * size)
        box.append(rows if name == "seq" else 1)
    return TmaPlan(tuple(dims), tuple(strides), tuple(box), **pos)


@functools.lru_cache(maxsize=256)
def _packed_plans(*plans: TmaPlan):
    """The plans of q, k and v (and dout, for the backward) as the C entry
    points read them (read-only there, so one array serves every call with
    these layouts)."""
    return (ctypes.c_longlong * (len(plans) * PLAN_LEN))(*(x for plan in plans for x in plan.packed()))


def _causal_keep(s: int, t: int, device) -> torch.Tensor:
    """Query i sees keys up to i + T - S (the last S keys end on the
    diagonal, which is the plain causal mask when S == T)."""
    return torch.ones(s, t, dtype=torch.bool, device=device).tril(t - s)


def alibi_bias(slopes, t: int, device=None) -> torch.Tensor:
    """The [1, H, 1, T] fp32 ALiBi column bias slope_h * (col - (T - 1)),
    as `supir_tpu/ops/attention.py` materialises it (:119-124)."""
    slopes = torch.as_tensor(slopes, dtype=torch.float32, device=device)
    col = torch.arange(t, dtype=torch.float32, device=slopes.device) - (t - 1)
    return slopes[None, :, None, None] * col


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, alibi_slopes=None) -> torch.Tensor:
    """scale * q k^T (+ the ALiBi column bias) as [B, H, S, T] in q's
    (float) dtype, causal-masked."""
    logits = torch.einsum("bshd,bthd->bhst", q, k) * q.shape[-1] ** -0.5
    if alibi_slopes is not None:
        logits = logits + alibi_bias(alibi_slopes, k.shape[1], q.device).to(logits.dtype)
    if causal:
        s, t = logits.shape[-2:]
        logits = logits.masked_fill(~_causal_keep(s, t, q.device), torch.finfo(logits.dtype).min)
    return logits


def _float(*tensors: torch.Tensor):
    """The tensors in fp32, or fp64 if they are fp64."""
    dtype = torch.promote_types(tensors[0].dtype, torch.float32)
    return tuple(t.to(dtype) for t in tensors)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    bias: torch.Tensor | None = None, alibi_slopes=None) -> torch.Tensor:
    """[B,S,H,D] x [B,T,H,D] -> [B,S,H,D] with fp32 logits and softmax: the
    form of `supir_tpu/ops/attention.py:_xla_attention` (:63-76). `bias` and
    the ALiBi column bias of `alibi_slopes` are added to the fp32 logits;
    `causal` lets query i see keys up to i + T - S. Autocast is off inside,
    so the logits stay fp32 under it, as XLA's preferred_element_type=float32
    keeps them. The weights are rounded to q's dtype and meet v in the wider
    of the two dtypes, as jnp.einsum promotes them."""
    with torch.autocast(q.device.type, enabled=False):
        scale = q.shape[-1] ** -0.5
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
        if bias is not None:
            logits = logits + bias.float()
        if alibi_slopes is not None:
            logits = logits + alibi_bias(alibi_slopes, k.shape[1], q.device)
        if causal:
            s, t = logits.shape[-2:]
            logits = logits.masked_fill(~_causal_keep(s, t, q.device), torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        dtype = torch.promote_types(weights.dtype, v.dtype)
        return torch.einsum("bhst,bthd->bshd", weights.to(dtype), v.to(dtype))


def attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = False, alibi_slopes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: (out [B,S,H,D] in q's dtype, lse [B,H,S]), lse the
    natural-log logsumexp of the scaled (ALiBi-biased), masked scores, in
    fp32 (fp64 for fp64 inputs)."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf = _float(q, k)
        logits = _scores(qf, kf, causal, alibi_slopes)
        lse = torch.logsumexp(logits, dim=-1)
        weights = torch.exp(logits - lse[..., None]).to(q.dtype)
        return torch.einsum("bhst,bthd->bshd", weights, v), lse


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = False, alibi_slopes=None):
    """K4's plain version, written out in fp32 (fp64 for fp64 inputs) as the
    reference for the kernel: P = exp(scale S + alibi - lse), delta = rowsum(dO * O),
    dS = P * (dO V^T - delta), dQ = scale dS K, dK = scale dS^T Q,
    dV = P^T dO; masked entries give zero. Returns (dq, dk, dv) in q's dtype."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, of, gf = _float(q, k, v, out, dout)
        scale = q.shape[-1] ** -0.5
        p = torch.exp(_scores(qf, kf, False, alibi_slopes) - lse.to(qf.dtype)[..., None])
        if causal:
            p = p.masked_fill(~_causal_keep(p.shape[-2], p.shape[-1], q.device), 0.0)
        delta = (gf * of).sum(-1).transpose(1, 2)  # [B, H, S]
        dp = torch.einsum("bshd,bthd->bhst", gf, vf)
        ds = p * (dp - delta[..., None])
        dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
        dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
        dv = torch.einsum("bhst,bshd->bthd", p, gf)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _fwd_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_FWD_SOURCE)
    # q, k, v, out[, lse], slopes; B H S T D causal; the three plans; out's strides
    for fn, n_ptrs in ((lib.supir_flash_attn_fwd_bf16, 5), (lib.supir_flash_attn_fwd_lse_bf16, 6)):
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_longlong] * 3
            + [ctypes.c_float, ctypes.c_void_p]
        )
    return lib


@functools.cache
def _fp32_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_FP32_SOURCE)
    # q, k, v, out[, lse], slopes; B H S T D causal; the three plans; out's strides; scale, fault, stream
    for fn, n_ptrs in ((lib.supir_flash_attn_fwd_fp32, 5), (lib.supir_flash_attn_fwd_lse_fp32, 6)):
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs
            + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_longlong)]
            + [ctypes.c_longlong] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return lib


@functools.cache
def _bwd_fp32_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_BWD_FP32_SOURCE)
    fn = lib.supir_flash_attn_bwd_fp32
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 11  # q, k, v, out, dout, lse, rows scratch, slopes, dq, dk, dv
        + [ctypes.c_int] * 6    # B H S T D causal
        + [ctypes.POINTER(ctypes.c_longlong)] * 2  # the four plans; strides of out, dout
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, fault, stream
    )
    return lib


def _bwd_library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_BWD_SOURCE)
    fn = lib.supir_flash_attn_bwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 11  # q, k, v, out, dout, lse, rows, slopes, dq, dk, dv
        + [ctypes.c_int] * 6    # B H S T D causal
        + [ctypes.POINTER(ctypes.c_longlong)] * 2  # the four plans; strides of out, dout, dq, dk, dv
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return lib


def _on_card(kernel: str, q: torch.Tensor, inputs) -> bool:
    """False for a CPU tensor (the plain route); for any other device,
    refuse an input that asks for a gradient, then require CUDA."""
    if q.device.type == "cpu":
        return False
    refuse_grad(kernel, *inputs)
    if q.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CPU or CUDA tensors, not {q.device}")
    return True


K1_DTYPES = (torch.bfloat16, torch.float32)  # K1, K3 and K4, with ALiBi or not: bf16 and fp32 instances


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, *more,
           dtypes=K1_DTYPES, kernel: str = "K1") -> None:
    """Shapes, dtype, device and layout the kernels take: q [B,S,H,D], k/v
    [B,T,H,D], all of one dtype of `dtypes`; `more` are further [B,*,H,D]
    operands (out, dout). Every operand 16-byte aligned with strides in
    multiples of 16 bytes: TMA's rule."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash attention wants q [B,S,H,D], k/v [B,T,H,D]; got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch, heads or head dim")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"the causal kernel wants as many queries as keys; got {q.shape[1]} and {k.shape[1]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for i, t in enumerate((q, k, v) + more):
        name = ("q", "k", "v", "out", "dout")[i]
        if i >= 3 and t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} is not shaped like q {tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise TypeError(f"{kernel} takes all-bf16 or all-fp32 operands; q is {q.dtype}, {name} {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride {t.stride()})")
        if any(s * t.element_size() % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples of 16 bytes "
                             f"(stride {t.stride()}, {t.element_size()} bytes an element)")


def _slopes(alibi_slopes, q: torch.Tensor) -> torch.Tensor | None:
    """The ALiBi slopes as the kernels take them: fp32 [H], contiguous, on
    q's device; None for no ALiBi."""
    if alibi_slopes is None:
        return None
    slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device).contiguous()
    if slopes.shape != (q.shape[2],):
        raise ValueError(f"alibi_slopes must be [{q.shape[2]}] (one per head), got {tuple(slopes.shape)}")
    return slopes


def bwd_rows(s: int) -> int:
    """Query rows of the backward's lse/delta scratch per (b, h): S rounded
    up to BWD_BLOCK (the C side's S_pad)."""
    return -(-s // BWD_BLOCK) * BWD_BLOCK


def _strides(*tensors: torch.Tensor):
    return [s for t in tensors for s in t.stride()[:3]]


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def _forward(q, k, v, causal: bool, with_lse: bool, slopes: torch.Tensor | None = None):
    """Launch K1 (with_lse False) or K3, with ALiBi if `slopes` (K3's
    kernel with or without the lse); returns (out, lse or None)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    if s == 0 or b * h == 0:
        return out, lse
    if t == 0:  # no keys: what the plain version gives (TMA takes no empty dim)
        return out.zero_(), None if lse is None else lse.fill_(float("-inf"))
    plans = _packed_plans(tma_plan(q, BLOCK_M), tma_plan(k, BLOCK_N), tma_plan(v, BLOCK_N))
    lib = _fwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        fn = lib.supir_flash_attn_fwd_bf16
        if with_lse:
            ptrs.append(lse.data_ptr())
            fn = lib.supir_flash_attn_fwd_lse_bf16
        ptrs.append(None if slopes is None else slopes.data_ptr())
        err = fn(*ptrs, b, h, s, t, d, int(causal), plans, *out.stride()[:3], d ** -0.5, stream)
    if err < 0:
        raise RuntimeError(f"flash attention forward: cuTensorMapEncodeTiled failed with CUresult {-err}")
    _raise_on(err, "flash attention forward" + (" (lse)" if with_lse else ""))
    return out, lse


def _launch_fp32(q, k, v, causal: bool, fault: int, with_lse: bool, slopes: torch.Tensor | None = None):
    """Launch K1 fp32, or K3 fp32 (with_lse: the same kernel, which then
    also writes the lse), with ALiBi if `slopes` (K3 ALiBi fp32, with or
    without the lse); returns (out, lse or None)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    if s == 0 or b * h == 0:
        return out, lse
    if t == 0:  # no keys: what the plain version gives (TMA takes no empty dim)
        return out.zero_(), None if lse is None else lse.fill_(float("-inf"))
    rows, keys = FP32_TILES[d]
    plans = _packed_plans(tma_plan(q, rows), tma_plan(k, keys), tma_plan(v, keys))
    lib = _fp32_library()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    fn = lib.supir_flash_attn_fwd_fp32
    if with_lse:
        ptrs.append(lse.data_ptr())
        fn = lib.supir_flash_attn_fwd_lse_fp32
    ptrs.append(None if slopes is None else slopes.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, b, h, s, t, d, int(causal), plans, *out.stride()[:3], d ** -0.5, fault, stream)
    label = ("flash attention forward (fp32" + (", ALiBi" if slopes is not None else "")
             + (", lse)" if with_lse else ")"))
    if err < 0:
        raise RuntimeError(f"{label}: cuTensorMapEncodeTiled failed with CUresult {-err}")
    _raise_on(err, label)
    return out, lse


def _forward_fp32(q, k, v, causal: bool, fault: int = 0, slopes: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K1 fp32 (`fault` > 0: one of its FP32_FAULT_* instances, for
    the checks), or with `slopes` (fp32 [H] on the card) K3 ALiBi fp32
    without the lse (faults FP32_FAULT_ALIBI_*); returns out, fp32
    [B,S,H,D]. Counts nothing."""
    return _launch_fp32(q, k, v, causal, fault, False, slopes)[0]


def _forward_fp32_lse(q, k, v, causal: bool, fault: int = 0, slopes: torch.Tensor | None = None):
    """Launch K3 fp32 (`fault`: an FP32_FAULT_*, FP32_FAULT_LSE_LOG2 too),
    or with `slopes` K3 ALiBi fp32 (FP32_FAULT_ALIBI_*); returns (out fp32
    [B,S,H,D], lse fp32 [B,H,S]). Counts nothing."""
    return _launch_fp32(q, k, v, causal, fault, True, slopes)


def _backward_fp32(q, k, v, out, lse, dout, causal: bool, fault: int = 0, slopes: torch.Tensor | None = None):
    """Launch K4 fp32 (`fault`: a BWD_FP32_FAULT_*, for the checks), with
    ALiBi if `slopes` (K4 ALiBi fp32), on checked operands; returns (dq,
    dk, dv), fp32 and contiguous. Counts nothing."""
    b, s, h, d = q.shape
    t = k.shape[1]
    dq, dk, dv = (torch.empty(x.shape, dtype=torch.float32, device=q.device) for x in (q, k, v))
    if s == 0 or t == 0 or b * h == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # lse and delta per query row, padded to whole blocks (the pre-pass fills it)
    rows = torch.empty(2 * b * h * bwd_rows(s), dtype=torch.float32, device=q.device)
    plans = _packed_plans(*(tma_plan(x, BWD_FP32_BOX) for x in (q, k, v, dout)))
    strides = (ctypes.c_longlong * 6)(*_strides(out, dout))
    fn = _bwd_fp32_library().supir_flash_attn_bwd_fp32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 rows.data_ptr(), None if slopes is None else slopes.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, s, t, d, int(causal), plans, strides, d ** -0.5, fault, stream)
    label = "flash attention backward (fp32" + (", ALiBi)" if slopes is not None else ")")
    if err < 0:
        raise RuntimeError(f"{label}: cuTensorMapEncodeTiled failed with CUresult {-err}")
    _raise_on(err, label)
    return dq, dk, dv


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 x as K1 fp32 splits it: hi = x rounded to TF32 (its
    bits + TF32_HALF with the low 13 cleared: nearest, ties away from
    zero), lo = x - hi, exact in fp32 (hi + lo == x)."""
    hi = ((x.view(torch.int32) + TF32_HALF) & TF32_KEEP).view(torch.float32)
    return hi, x - hi


def tf32_operand(x: torch.Tensor) -> torch.Tensor:
    """The TF32 word K1 fp32 hands the tensor cores for fp32 x: its low 13
    mantissa bits cleared, which the tensor cores do not read."""
    return (x.view(torch.int32) & TF32_KEEP).view(torch.float32)


def _tf32_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 operands of x's three products: hi and lo's TF32."""
    hi, lo = tf32_split(x)
    return hi, tf32_operand(lo)


def vt_key(p: int) -> int:
    """The key that slot p (0..7) of each 8-key group of a V^T row holds in
    K1 fp32 (csrc: VT_KEY): S's accumulator gives lane t of a quad the
    columns 2t and 2t + 1 of every 8-column group, the TF32 A operand wants
    k-indices t and t + 4, so slot t holds key 2t and slot t + 4 key 2t + 1."""
    return 2 * (p % 4) + p // 4


VT_KEY = tuple(vt_key(p) for p in range(8))


def flash_fp32_emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                       fault: int = 0, with_lse: bool = False, alibi_slopes=None):
    """K1 fp32's kernel walked on the CPU in its own order: warpgroups of 64
    query rows, key tiles of FP32_TILES[D][1] keys (zero past T; with
    `causal`, none past the warpgroup's last row), every operand split into
    its TF32 pair (`tf32_split`, `tf32_operand`) and every product of
    Q K^T and P V taken as lo hi + hi lo + hi hi, the ragged and causal
    masks, the online softmax in raw q.k units with exp2 and the scale
    folded in (a row with no key yet subtracts 0), the accumulator and sum
    rescaled when the max rises, each tile's P V summed apart and added to
    it, O / max(l, 1e-30). `fault` plants
    FP32_FAULT_*: with FP32_FAULT_VT_ORDER P's key 8 g + VT_KEY[p] meets V's
    key 8 g + p. Returns fp32 [B,S,H,D]; with `with_lse` (K3 fp32) also the
    lse [B,H,S], m scale + ln(max(l, 1e-30)) (FP32_FAULT_LSE_LOG2: in log2
    units). With `alibi_slopes` (fp32 [H]) it walks K3 ALiBi fp32: each
    tile's scores become scale s + slope_h (col - (T - 1)), each step
    rounded to fp32 (FP32_FAULT_ALIBI_RAW_UNITS: (s + bias) scale;
    FP32_FAULT_ALIBI_NO_OFFSET: slope_h col), before the masks; the softmax
    then runs in those units (exp2's factor log2 e) and the lse is
    m + ln(max(l, 1e-30))."""
    b, s, h, d = q.shape
    t = k.shape[1]
    bn = FP32_TILES[d][1]
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    slopes = None if alibi_slopes is None else torch.as_tensor(alibi_slopes, dtype=torch.float32)[:, None, None]
    c = torch.tensor(LOG2E, dtype=torch.float32) if slopes is not None else scale * torch.tensor(LOG2E, dtype=torch.float32)
    n_tiles = -(-t // bn)
    pad = (0, 0, 0, n_tiles * bn - t)
    qh, kh, vh = (x.float().transpose(1, 2).contiguous() for x in (q, k, v))  # [B, H, N, D]
    q_hi, q_lo = _tf32_pair(qh)
    k_hi, k_lo = _tf32_pair(torch.nn.functional.pad(kh, pad))
    v_hi, v_lo = _tf32_pair(torch.nn.functional.pad(vh, pad))
    if fault == FP32_FAULT_VT_ORDER:
        # slot p of V^T holds key p where P's k-index p is key VT_KEY[p]
        meets = torch.tensor([8 * (key // 8) + VT_KEY.index(key % 8) for key in range(n_tiles * bn)])
        v_hi, v_lo = v_hi[:, :, meets], v_lo[:, :, meets]
    out = torch.empty(b, h, s, d)
    lse = torch.empty(b, h, s)
    for first in range(0, s, FP32_WG_ROWS):
        rows = torch.arange(first, min(s, first + FP32_WG_ROWS))
        qa_hi, qa_lo = q_hi[:, :, rows], q_lo[:, :, rows]
        m = torch.full(qa_hi.shape[:3], float("-inf"))
        l = torch.zeros(qa_hi.shape[:3])
        acc = torch.zeros(qa_hi.shape)
        tiles = -(-min(t, first + FP32_WG_ROWS) // bn) if causal else n_tiles
        for j in range(tiles):
            keys = slice(j * bn, (j + 1) * bn)
            kt_hi, kt_lo = k_hi[:, :, keys].transpose(-1, -2), k_lo[:, :, keys].transpose(-1, -2)
            scores = qa_hi @ kt_hi
            if fault != FP32_FAULT_ONE_PRODUCT:
                scores = qa_lo @ kt_hi + qa_hi @ kt_lo + scores
            cols = torch.arange(j * bn, (j + 1) * bn)
            if slopes is not None:
                bias = slopes * (cols - (0 if fault == FP32_FAULT_ALIBI_NO_OFFSET else t - 1)).float()
                if fault == FP32_FAULT_ALIBI_RAW_UNITS:
                    scores = (scores + bias) * scale
                else:
                    scores = scores * scale + bias
            drop = torch.zeros(len(rows), bn, dtype=torch.bool)
            if fault != FP32_FAULT_RAGGED:
                drop |= cols[None] >= t
            if fault != FP32_FAULT_DIAGONAL and causal:
                drop |= cols[None] > rows[:, None]
            scores = scores.masked_fill(drop, float("-inf"))
            m_new = torch.maximum(m, scores.amax(-1))
            sub = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
            corr = torch.exp2((m - sub) * c)
            p = torch.exp2((scores - sub[..., None]) * c)
            l = l * corr + p.sum(-1)
            if fault != FP32_FAULT_NO_RESCALE:
                acc = acc * corr[..., None]
            p_hi, p_lo = _tf32_pair(p)
            pv = p_lo @ v_hi[:, :, keys]
            if fault != FP32_FAULT_NO_V_LO:
                pv = pv + p_hi @ v_lo[:, :, keys]
            acc = acc + (pv + p_hi @ v_hi[:, :, keys])
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
        if slopes is not None:
            lse[:, :, rows] = m + torch.log(l.clamp_min(1e-30))
        elif fault == FP32_FAULT_LSE_LOG2:
            lse[:, :, rows] = m * c + torch.log2(l.clamp_min(1e-30))
        else:
            lse[:, :, rows] = m * c * torch.tensor(LN2, dtype=torch.float32) + torch.log(l.clamp_min(1e-30))
    return (out.transpose(1, 2), lse) if with_lse else out.transpose(1, 2)


def flash_bwd_fp32_emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor, causal: bool = False, fault: int = 0,
                           alibi_slopes=None):
    """K4 fp32's kernels walked on the CPU in their own order: the pre-pass's
    delta = rowsum(dO * O) (lse +inf and delta 0 past S); the dQ kernel's
    blocks of BWD_FP32_ROWS queries over key tiles of BWD_FP32_BOX (with
    `causal`, none past the block's last query), the dK/dV kernel's blocks
    of keys over query tiles (with `causal`, from the block's first key);
    every operand split into its TF32 pair and every product taken as lo hi
    + hi lo + hi hi, each tile's S (or S^T) and dP (or dP^T) over the head
    dim, P = exp(scale s - lse) (with `alibi_slopes`, scale s +
    slope_h (col - (T - 1)) - lse, each step rounded to fp32), the ragged and
    causal masks, dS = P (dP - delta), and each tile's dQ, dK and dV product
    taken apart and added to the block's fp32 sums; dQ and dK times the
    scale. The sums inside a product are the CPU's: the tensor cores' own
    (truncating) fp32 sums are not walked, which leaves the kernel 1-3e-6
    from the walk. `fault` plants BWD_FP32_FAULT_*: with
    BWD_FP32_FAULT_T_ORDER the tile's column 8 g + VT_KEY[p] meets the
    transposed operand's row 8 g + p. Returns (dq, dk, dv), fp32
    [B,S|T,H,D]."""
    b, s, h, d = q.shape
    t = k.shape[1]
    rows_n, box = BWD_FP32_ROWS, BWD_FP32_BOX
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    one = fault == BWD_FP32_FAULT_ONE_PRODUCT
    masked = causal and fault != BWD_FP32_FAULT_DIAGONAL
    slopes = None if alibi_slopes is None else torch.as_tensor(alibi_slopes, dtype=torch.float32)[:, None, None]
    qh, kh, vh, oh, gh = (x.float().transpose(1, 2) for x in (q, k, v, out, dout))  # [B, H, N, D]
    delta = (gh * oh).sum(-1)
    lse = lse.float()
    if fault == BWD_FP32_FAULT_LSE_LOG2:
        lse = lse * torch.tensor(LOG2E, dtype=torch.float32)
    if fault == BWD_FP32_FAULT_NO_DELTA:
        delta = torch.zeros_like(delta)
    meets = torch.tensor([8 * (c // 8) + VT_KEY.index(c % 8) for c in range(box)])

    def padded(x, n):  # rows past the extent arrive as zeros (TMA)
        return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[2]))

    def padded_rows(x, n, fill):  # the pre-pass's rows: `fill` past S
        return torch.nn.functional.pad(x, (0, n - x.shape[2]), value=fill)

    def product(a, bb):  # a [.., M, D] . bb [.., R, D]^T, 3xTF32
        a_hi, a_lo = _tf32_pair(a)
        b_hi, b_lo = _tf32_pair(bb)
        hh = a_hi @ b_hi.transpose(-1, -2)
        return hh if one else a_lo @ b_hi.transpose(-1, -2) + a_hi @ b_lo.transpose(-1, -2) + hh

    def out_product(a, rows):  # a [.., M, R] . rows [.., R, D] (the transposed operand), 3xTF32
        a_hi, a_lo = _tf32_pair(a)
        b_hi, b_lo = _tf32_pair(rows)
        if fault == BWD_FP32_FAULT_T_ORDER:
            b_hi, b_lo = b_hi[..., meets, :], b_lo[..., meets, :]
        hh = a_hi @ b_hi
        if one:
            return hh
        return (a_lo @ b_hi + hh) if fault == BWD_FP32_FAULT_NO_T_LO else a_lo @ b_hi + a_hi @ b_lo + hh

    def p_of(sc, lse_, bias):  # P from the tile's raw scores
        x = sc * scale
        if slopes is not None:
            x = x + bias
        return torch.exp(x - lse_)

    def bias_of(idx):  # the ALiBi bias of key indices `idx`, by head ([H, *idx.shape])
        return None if slopes is None else slopes * (idx - (t - 1)).float()

    t_pad, s_pad = -(-t // box) * box, -(-s // box) * box
    kp, vp, qp, gp = padded(kh, t_pad), padded(vh, t_pad), padded(qh, s_pad), padded(gh, s_pad)
    lse_p, delta_p = padded_rows(lse, s_pad, float("inf")), padded_rows(delta, s_pad, 0.0)
    dq, dk, dv = torch.zeros(b, h, s, d), torch.zeros(b, h, t, d), torch.zeros(b, h, t, d)
    for first in range(0, s, rows_n):  # the dQ kernel: owned queries
        rows = torch.arange(first, min(s, first + rows_n))
        end = min(t, first + rows_n) if masked else t
        sums = torch.zeros(b, h, len(rows), d)
        for c0 in range(0, end, box):
            cols = torch.arange(c0, c0 + box)
            kt, vt = kp[:, :, c0:c0 + box], vp[:, :, c0:c0 + box]
            p = p_of(product(qh[:, :, rows], kt), lse[:, :, rows, None], bias_of(cols))
            drop = (cols[None] >= t) | ((cols[None] > rows[:, None]) if masked else False)
            p = p.masked_fill(drop, 0.0)
            ds = p * (product(gh[:, :, rows], vt) - delta[:, :, rows, None])
            sums = sums + out_product(ds, kt)
        dq[:, :, rows] = sums * scale
    for first in range(0, t, rows_n):  # the dK/dV kernel: owned keys
        keys = torch.arange(first, min(t, first + rows_n))
        sums_k, sums_v = torch.zeros(b, h, len(keys), d), torch.zeros(b, h, len(keys), d)
        for c0 in range(first if masked else 0, s, box):
            cols = torch.arange(c0, c0 + box)
            qt, gt = qp[:, :, c0:c0 + box], gp[:, :, c0:c0 + box]
            p = p_of(product(kh[:, :, keys], qt), lse_p[:, :, None, c0:c0 + box], bias_of(keys[:, None]))
            if masked:
                p = p.masked_fill(cols[None] < keys[:, None], 0.0)
            ds = p * (product(vh[:, :, keys], gt) - delta_p[:, :, None, c0:c0 + box])
            sums_v = sums_v + out_product(p, gt)
            sums_k = sums_k + out_product(ds, qt)
        dk[:, :, keys] = sums_k if fault == BWD_FP32_FAULT_DK_SCALE else sums_k * scale
        dv[:, :, keys] = sums_v
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, alibi_slopes=None) -> torch.Tensor:
    """K1: softmax(q k^T / sqrt(D)) v over q [B,S,H,D] and k/v [B,T,H,D];
    with `causal`, query i sees keys 0..i (S == T). bf16 q, k, v launch the
    bf16 kernel (counted in `launches`), fp32 ones K1 fp32 (counted in
    `fp32_launches`). With `alibi_slopes` it is K3 ALiBi without the lse
    (counted in `alibi_launches`; fp32: K3 ALiBi fp32, counted in
    `alibi_fp32_launches`). Not differentiable on the card: raises there if
    grad mode is on and an input requires grad."""
    if not _on_card("flash_attention (K1)", q, (q, k, v)):
        return attention_plain(q, k, v, causal=causal, alibi_slopes=alibi_slopes)
    _check(q, k, v, causal, kernel="K1" if alibi_slopes is None else "K3 ALiBi")
    slopes = _slopes(alibi_slopes, q)
    if q.dtype == torch.float32:
        out = _forward_fp32(q, k, v, causal, slopes=slopes)
    else:
        out, _ = _forward(q, k, v, causal, with_lse=False, slopes=slopes)
    _count(flash_attention, q, slopes)
    return out


def _count(wrapper, q: torch.Tensor, slopes) -> None:
    """One launch of `wrapper`'s kernel, in the counter of its instance:
    `launches`, `fp32_launches`, `alibi_launches` or `alibi_fp32_launches`."""
    name = ("alibi_" if slopes is not None else "") + ("fp32_" if q.dtype == torch.float32 else "") + "launches"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = False, alibi_slopes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (out [B,S,H,D], lse [B,H,S] fp32), lse the natural-log
    logsumexp of each query row's scaled (ALiBi-biased) scores. bf16 q, k,
    v launch K3 (counted in `launches`), fp32 ones K3 fp32 (counted in
    `fp32_launches`); ALiBi launches are counted in `alibi_launches` (bf16)
    and `alibi_fp32_launches` (fp32)."""
    if not _on_card("flash_attention_fwd_lse (K3)", q, (q, k, v)):
        return attention_fwd_lse_plain(q, k, v, causal, alibi_slopes)
    _check(q, k, v, causal, kernel="K3" if alibi_slopes is None else "K3 ALiBi")
    slopes = _slopes(alibi_slopes, q)
    if q.dtype == torch.float32:
        out, lse = _forward_fp32_lse(q, k, v, causal, slopes=slopes)
    else:
        out, lse = _forward(q, k, v, causal, with_lse=True, slopes=slopes)
    _count(flash_attention_fwd_lse, q, slopes)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = False, alibi_slopes=None):
    """K4: (dq, dk, dv) in q's dtype from the forward's residuals (q, k, v,
    out, lse as K3 returns them, with the same `alibi_slopes`) and the
    output gradient dout. bf16 operands launch K4 (counted in `launches`),
    fp32 ones K4 fp32 (counted in `fp32_launches`); ALiBi launches are
    counted in `alibi_launches` (bf16) and `alibi_fp32_launches` (fp32)."""
    if not _on_card("flash_attention_bwd (K4)", q, (q, k, v, out, lse, dout)):
        return attention_bwd_plain(q, k, v, out, lse, dout, causal, alibi_slopes)
    _check(q, k, v, causal, out, dout, kernel="K4" if alibi_slopes is None else "K4 ALiBi")
    b, s, h, d = q.shape
    t = k.shape[1]
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{b},{h},{s}] tensor, got {lse.dtype} {tuple(lse.shape)}")
    slopes = _slopes(alibi_slopes, q)
    if q.dtype == torch.float32:
        grads = _backward_fp32(q, k, v, out, lse, dout, causal, slopes=slopes)
        _count(flash_attention_bwd, q, slopes)
        return grads
    dq, dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format) for x in (q, k, v))
    if s == 0 or t == 0 or b * h == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # delta and lse * log2 e per query row, padded to whole blocks (the pre-pass fills it)
    rows = torch.empty(2 * b * h * bwd_rows(s), dtype=torch.float32, device=q.device)
    plans = _packed_plans(*(tma_plan(x, BWD_BOX) for x in (q, k, v, dout)))
    strides = (ctypes.c_longlong * 15)(*_strides(out, dout, dq, dk, dv))
    fn = _bwd_library().supir_flash_attn_bwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), rows.data_ptr(), None if slopes is None else slopes.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s, t, d, int(causal), plans, strides,
                 d ** -0.5, stream)
    if err < 0:
        raise RuntimeError(f"flash attention backward: cuTensorMapEncodeTiled failed with CUresult {-err}")
    _raise_on(err, "flash attention backward")
    _count(flash_attention_bwd, q, slopes)
    return dq, dk, dv


for _wrapper in (flash_attention, flash_attention_fwd_lse, flash_attention_bwd):
    _wrapper.launches = 0
    _wrapper.alibi_launches = 0
    _wrapper.fp32_launches = 0
    _wrapper.alibi_fp32_launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX function's
    `custom_vjp` (`_make_diff_fn`, :305-325): the forward runs K3 and saves
    q, k, v, out and lse (and the ALiBi slopes, which get no gradient, as
    the JAX function holds them static); the backward runs K4 with the same
    slopes, each in the operands' dtype (bf16, or fp32 on K3 fp32 and K4
    fp32, with ALiBi or not). On
    CPU tensors both are the plain versions, so the CPU tests run the
    backward's arithmetic. The backward runs under the forward's autocast
    state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, causal=False, alibi_slopes=None):
        out, lse = flash_attention_fwd_lse(q, k, v, causal, alibi_slopes)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.alibi_slopes = alibi_slopes
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.to(out.dtype).contiguous(), ctx.causal,
                                         ctx.alibi_slopes)
        return dq, dk, dv, None, None
