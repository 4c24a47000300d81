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
re-adds the bias. The kernels take it as a runtime argument (K3 ALiBi in
`flash_attn_fwd.cu`, K4 ALiBi in `flash_attn_bwd.cu`). ALiBi is never
head-packed on the TPU (:339), so its forward is `_attn_kernel`, K3's
kernel, with or without the lse: a wrapper's ALiBi launches are counted in
`<wrapper>.alibi_launches`, apart from `launches`.

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
source, `supir_tpu_torch/csrc/flash_attn_fwd_fp32.cu`, runs every product
as an fp32 FMA on the CUDA cores (wgmma takes no fp32 operand; TF32 would
lower the precision), reading q, k and v through their strides with
16-byte loads. `flash_attention` launches it for fp32 inputs and counts
those calls in `flash_attention.fp32_launches`, apart from `launches`.
`flash_fp32_emulate` walks its tiles on the CPU. K3, K4 and the ALiBi
variants take bf16 only: no path of the port reaches them in fp32 (the
trainer runs under bf16 autocast, MPT in bf16).

Each wrapper, on a CPU tensor, returns its plain version (`attention_plain`,
`attention_fwd_lse_plain`, `attention_bwd_plain`); on a CUDA tensor it
launches its kernel or raises. `<wrapper>.launches` counts launching calls.

The forward reads q, k and v, the backward q, k, v and dout, through TMA
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
SOURCES = (_FWD_SOURCE, _BWD_SOURCE, _FP32_SOURCE)  # for cuda_build.build_all
HEAD_DIMS = (64, 128)
# the forward's tiles (csrc/flash_attn_fwd.cu: BM, BN, SLAB)
BLOCK_M = 128  # query rows per block: two consumer warpgroups of 64
BLOCK_N = 128  # keys per K/V tile
SLAB = 64      # head-dim columns per 128-byte swizzle slab (one TMA box)
PLAN_LEN = 15  # values of a packed plan: rank, dims[4], strides[3], box[4], positions[3]
# the backward's tiles (csrc/flash_attn_bwd.cu: BLOCK, BOX)
BWD_BLOCK = 128  # rows a backward block owns; the lse/delta scratch is padded to it
BWD_BOX = 64     # rows of every backward TMA box (q, k, v and dout)
# K1 fp32's tiles (csrc/flash_attn_fwd_fp32.cu: BM, BN) and planted faults:
# the accumulator not rescaled when the max rises, the ragged last key tile
# not masked, the causal diagonal tile not masked
FP32_BLOCK = 64
LOG2E = 1.4426950408889634  # the kernels' fp32 log2(e), folded into the scale
FP32_FAULT_NO_RESCALE, FP32_FAULT_RAGGED, FP32_FAULT_DIAGONAL = 1, 2, 3


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
    """The tensor map of a [B, N, H, D] bf16 operand read in boxes of
    `rows` rows (the forward: BLOCK_M for q, BLOCK_N for k and v; the
    backward: BWD_BOX for q, k, v and dout). Raises ValueError on
    what TMA cannot take: a head dim that is not contiguous or not a whole
    number of slabs, a base address that is not 16-byte aligned, or a kept
    stride that is not a multiple of 16 bytes."""
    if x.dim() != 4 or x.shape[-1] % SLAB or x.stride(-1) != 1:
        raise ValueError(f"a TMA plan wants [B,N,H,D] with a contiguous D a multiple of {SLAB}; got "
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
    dims, strides, box, pos = [d], [], [SLAB], {}
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
    fn = lib.supir_flash_attn_fwd_fp32
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4   # q, k, v, out
        + [ctypes.c_int] * 6    # B H S T D causal
        + [ctypes.POINTER(ctypes.c_longlong)]  # strides of q, k, v, out
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


BF16_ONLY = (torch.bfloat16,)
K1_DTYPES = (torch.bfloat16, torch.float32)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, *more,
           dtypes=BF16_ONLY, kernel: str = "the bf16 kernels") -> None:
    """Shapes, dtype, device and layout the kernels take: q [B,S,H,D], k/v
    [B,T,H,D], all of one dtype of `dtypes`; `more` are further [B,*,H,D]
    operands (out, dout). Every operand 16-byte aligned with strides in
    multiples of 16 bytes: TMA's rule for the bf16 kernels, the 16-byte
    loads' for K1 fp32."""
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
            if dtypes == BF16_ONLY:
                raise TypeError(f"{kernel} take bf16 (no path of the port reaches them in fp32); {name} is "
                                f"{t.dtype}")
            raise TypeError(f"K1 takes all-bf16 or all-fp32 q, k, v; q is {q.dtype}, {name} {t.dtype}")
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


def _forward_fp32(q, k, v, causal: bool, fault: int = 0) -> torch.Tensor:
    """Launch K1 fp32 (`fault` > 0: one of its FP32_FAULT_* instances, for
    the checks); returns out, fp32 [B,S,H,D]. Counts nothing."""
    b, s, h, d = q.shape
    t = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    if s == 0 or b * h == 0:
        return out
    if t == 0:  # no keys: what the plain version gives
        return out.zero_()
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, out))
    fn = _fp32_library().supir_flash_attn_fwd_fp32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, t, d, int(causal), strides,
                 d ** -0.5, fault, stream)
    _raise_on(err, "flash attention forward (fp32)")
    return out


def flash_fp32_emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                       fault: int = 0) -> torch.Tensor:
    """K1 fp32's kernel walked on the CPU in its own order: 64-row query
    blocks, 64-key tiles (zero-filled past T, none wholly above the causal
    diagonal), the ragged and diagonal masks, the online softmax in raw
    q.k units with exp2 and the scale folded in (a row with no key yet
    subtracts 0), the accumulator and sum rescaled when the max rises, O /
    max(l, 1e-30); `fault` plants FP32_FAULT_*. Returns fp32 [B,S,H,D]."""
    b, s, h, d = q.shape
    t = k.shape[1]
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, N, D]
    n_tiles = -(-t // FP32_BLOCK)
    out = torch.empty(b, h, s, d)
    for qb in range(-(-s // FP32_BLOCK)):
        first = qb * FP32_BLOCK
        qt = qh[:, :, first:first + FP32_BLOCK]
        rows = torch.arange(first, first + qt.shape[2])
        m = torch.full(qt.shape[:3], float("-inf"))
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for j in range(min(n_tiles, qb + 1) if causal else n_tiles):
            kf = j * FP32_BLOCK
            pad = (0, 0, 0, FP32_BLOCK - min(FP32_BLOCK, t - kf))
            kt = torch.nn.functional.pad(kh[:, :, kf:kf + FP32_BLOCK], pad)
            vt = torch.nn.functional.pad(vh[:, :, kf:kf + FP32_BLOCK], pad)
            scores = qt @ kt.transpose(-1, -2)
            cols = torch.arange(kf, kf + FP32_BLOCK)
            drop = torch.zeros(len(rows), FP32_BLOCK, dtype=torch.bool)
            if fault != FP32_FAULT_RAGGED and kf + FP32_BLOCK > t:
                drop |= cols[None] >= t
            if fault != FP32_FAULT_DIAGONAL and causal and j == qb:
                drop |= cols[None] > rows[:, None]
            scores = scores.masked_fill(drop, float("-inf"))
            m_new = torch.maximum(m, scores.amax(-1))
            sub = torch.where(m_new == float("-inf"), torch.zeros(()), m_new)
            corr = torch.exp2((m - sub) * c)
            p = torch.exp2((scores - sub[..., None]) * c)
            l = l * corr + p.sum(-1)
            if fault != FP32_FAULT_NO_RESCALE:
                acc = acc * corr[..., None]
            acc = acc + p @ vt
            m = m_new
        out[:, :, first:first + qt.shape[2]] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, alibi_slopes=None) -> torch.Tensor:
    """K1: softmax(q k^T / sqrt(D)) v over q [B,S,H,D] and k/v [B,T,H,D];
    with `causal`, query i sees keys 0..i (S == T). bf16 q, k, v launch the
    bf16 kernel (counted in `launches`), fp32 ones K1 fp32 (counted in
    `fp32_launches`). With `alibi_slopes` it is K3 ALiBi without the lse
    (bf16 only; counted in `alibi_launches`). Not differentiable on the
    card: raises there if grad mode is on and an input requires grad."""
    if not _on_card("flash_attention (K1)", q, (q, k, v)):
        return attention_plain(q, k, v, causal=causal, alibi_slopes=alibi_slopes)
    _check(q, k, v, causal, dtypes=K1_DTYPES if alibi_slopes is None else BF16_ONLY, kernel="the ALiBi kernels")
    if q.dtype == torch.float32:
        out = _forward_fp32(q, k, v, causal)
        flash_attention.fp32_launches += 1
        return out
    slopes = _slopes(alibi_slopes, q)
    out, _ = _forward(q, k, v, causal, with_lse=False, slopes=slopes)
    if slopes is None:
        flash_attention.launches += 1
    else:
        flash_attention.alibi_launches += 1
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = False, alibi_slopes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (out [B,S,H,D], lse [B,H,S] fp32), lse the natural-log
    logsumexp of each query row's scaled (ALiBi-biased) scores. ALiBi
    launches are counted in `alibi_launches`."""
    if not _on_card("flash_attention_fwd_lse (K3)", q, (q, k, v)):
        return attention_fwd_lse_plain(q, k, v, causal, alibi_slopes)
    _check(q, k, v, causal, kernel="K3 and K3 ALiBi")
    slopes = _slopes(alibi_slopes, q)
    out, lse = _forward(q, k, v, causal, with_lse=True, slopes=slopes)
    if slopes is None:
        flash_attention_fwd_lse.launches += 1
    else:
        flash_attention_fwd_lse.alibi_launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = False, alibi_slopes=None):
    """K4: (dq, dk, dv) in q's dtype from the forward's residuals (q, k, v,
    out, lse as K3 returns them, with the same `alibi_slopes`) and the
    output gradient dout. ALiBi launches are counted in `alibi_launches`."""
    if not _on_card("flash_attention_bwd (K4)", q, (q, k, v, out, lse, dout)):
        return attention_bwd_plain(q, k, v, out, lse, dout, causal, alibi_slopes)
    _check(q, k, v, causal, out, dout, kernel="K4 and K4 ALiBi")
    slopes = _slopes(alibi_slopes, q)
    b, s, h, d = q.shape
    t = k.shape[1]
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [{b},{h},{s}] tensor, got {lse.dtype} {tuple(lse.shape)}")
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
    if slopes is None:
        flash_attention_bwd.launches += 1
    else:
        flash_attention_bwd.alibi_launches += 1
    return dq, dk, dv


for _wrapper in (flash_attention, flash_attention_fwd_lse, flash_attention_bwd):
    _wrapper.launches = 0
    _wrapper.alibi_launches = 0
flash_attention.fp32_launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX function's
    `custom_vjp` (`_make_diff_fn`, :305-325): the forward runs K3 and saves
    q, k, v, out and lse (and the ALiBi slopes); the backward runs K4. On
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
