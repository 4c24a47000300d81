"""K2: GroupNorm(32) with an optional fused SiLU, written by hand in CUDA
C++ for Hopper (`csrc/group_norm.cu`, one thread-block cluster per group).

Replaces `supir_tpu/ops/groupnorm.py:_gn_silu_kernel` (:40), launched from
`group_norm_silu` (:118): fp32 per-(batch, group) mean and E[x^2] - mean^2
(clamped at 0), the per-channel affine, then SiLU, written in x's dtype. On
the TPU the kernel was opt-in; here it is the CUDA path of every
`GroupNorm32` site.

What bounds it on the card: bytes. One read and one write of x against a
handful of flops per element puts it far below the H100's ridge point.

Design (the source's header has the details): in NCHW each (b, g) group is
one contiguous slab of cg*H*W elements. A cluster of `ranks` CTAs owns a
slab, cut into contiguous parts; each CTA sums its part, the CTAs exchange
their (sum, sumsq) over distributed shared memory and every CTA sums them
in rank order (the same mean and rstd everywhere, no atomics, two runs give
the same bits), then reads its part again, backwards, and normalises it
(x as the op before it left it in L2, where holding the part in shared
memory instead measured slower on the H100: PERF.md §6). `gn_plan`
chooses the cluster size and the parts; `gn_emulate` walks the same plan in
torch for the CPU tests.

`group_norm` is the wrapper: on a CPU tensor it returns the plain version,
`group_norm_plain`; on a CUDA tensor it launches the kernel or raises.
`group_norm.launches` counts its launches. The kernel writes into a fresh
tensor and has no backward (the TPU kernel had none either), so on the card
the wrapper raises when grad mode is on and x or the affine parameters
require grad; `GroupNorm32` (models/layers.py) sends such a site to
`group_norm_plain`, which autograd differentiates.

`group_norm_triton` is the first design, two Triton launches (statistics
into a partials tensor, then normalise, reading x twice). It stays only as
the comparator that chip_smoke.py times in turns with the cluster kernel;
no model path calls it. Triton is imported inside it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from supir_tpu_torch.ops.grad_guard import refuse_grad

_SOURCE = "group_norm.cu"
SOURCES = (_SOURCE,)  # for cuda_build.build_all

# csrc/group_norm.cu's layout (GN_* there)
GN_THREADS = 256
GN_WARPS = GN_THREADS // 32
SMEM_MAX = 232448             # shared memory one CTA may use on the H100 (227 KB)
SMS = 132                     # H100 SXM

FAULT_NONE = 0
FAULT_DROP_RANK = 1           # one rank's partials left out of the reduction
FAULT_OWN_SLICE = 2           # each CTA normalises with its own part's statistics
FAULT_AFFINE_SHIFT = 3        # the affine read one channel off
FAULT_NEIGHBOUR_GROUP = 4     # pass 2 reads the neighbouring group's x

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the first design's Triton geometry
BLOCK = 1024            # elements per program per loop step
TARGET_PROGRAMS = 1024  # about 8 programs per SM on 132 SMs

_kernels = None


def group_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int = 32, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm over [B, C, *] with fp32 statistics, returned in x's dtype."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


# ------------------------------------------------ statistics from elsewhere
#
# The tiled VAE normalises each tile with statistics taken over all the
# tiles of its image (supir_tpu/models/layers.py:124-152): K2 takes each
# slab's own statistics, so these sites run plain torch, fp32 sums and then
# one FMA per channel (XLA's work in the JAX package, whose Pallas kernel
# never takes a pooled site either, :82-88).

MOMENT_SLICE = 2**27  # elements per fp32 temporary of group_moments


@dataclasses.dataclass(frozen=True)
class TilePooled:
    """Statistics pooled over the `tiles` tiles of each image of a
    tile-major batch [T*B, C, ...] (the JAX package's `pmean` over the
    vmapped tile axis), each tile's moments scaled by `weight` [T] (mean 1
    over the tiles; zero for a padded duplicate) where given. With a
    process `group` (the tile axis of a mesh, each rank holding `tiles` of
    the image's tiles) the means are averaged over the group's ranks too,
    by an all-reduce: JAX's `pmean` over ("tile_local", "tile")."""

    tiles: int
    weight: torch.Tensor | None = None
    group: object = None


@dataclasses.dataclass(frozen=True)
class GivenStats:
    """Statistics supplied from outside, `stats` [2, B, G] fp32 (mean and
    E[x^2] per image and group), for every tile of a tile-major batch
    [T*B, C, ...] (the JAX package's `gn_tape`)."""

    stats: torch.Tensor


def group_moments(x: torch.Tensor, groups: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, E[x^2]) fp32 [N, G] of x [N, C, ...] per sample and group,
    taken over slices of samples so that the fp32 copies stay under
    MOMENT_SLICE elements."""
    n = x.shape[0]
    step = max(1, MOMENT_SLICE // max(1, x[0].numel()))
    means, means2 = [], []
    for i in range(0, n, step):
        xf = x[i:i + step].float().reshape(min(step, n - i), groups, -1)
        means.append(xf.mean(-1))
        means2.append((xf * xf).mean(-1))
    return torch.cat(means), torch.cat(means2)


def group_norm_given(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                     mean2: torch.Tensor, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm of x [N, C, ...] with the fp32 moments [N, G] given:
    var = max(E[x^2] - mean^2, 0), folded with the affine into one
    x * a + b per channel in x's dtype, then SiLU."""
    n, c = x.shape[:2]
    cg = c // mean.shape[1]
    rstd = torch.rsqrt((mean2 - mean * mean).clamp_min(0.0) + eps)
    a = rstd.repeat_interleave(cg, 1) * weight.float()
    b = bias.float() - (mean * rstd).repeat_interleave(cg, 1) * weight.float()
    view = (n, c) + (1,) * (x.dim() - 2)
    y = x * a.view(view).to(x.dtype) + b.view(view).to(x.dtype)
    return F.silu(y) if silu else y


def group_norm_pooled(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                      silu: bool, norm: TilePooled | GivenStats) -> torch.Tensor:
    """GroupNorm of a tile-major batch x [T*B, C, ...] with the statistics
    `norm` names: pooled over each image's tiles, or given."""
    n = x.shape[0]
    if isinstance(norm, GivenStats):
        mean, mean2 = norm.stats[0], norm.stats[1]
    elif isinstance(norm, TilePooled):
        mean, mean2 = (m.view(norm.tiles, n // norm.tiles, groups) for m in group_moments(x, groups))
        if norm.weight is not None:
            w = norm.weight.float().view(-1, 1, 1)
            mean, mean2 = mean * w, mean2 * w
        mean, mean2 = mean.mean(0), mean2.mean(0)
        if norm.group is not None:
            from supir_tpu_torch.parallel.mesh import all_reduce_

            both = all_reduce_(torch.stack([mean, mean2]), norm.group) / dist.get_world_size(norm.group)
            mean, mean2 = both[0], both[1]
    else:
        raise TypeError(f"norm must be TilePooled or GivenStats, not {type(norm).__name__}")
    reps = n // mean.shape[0]
    return group_norm_given(x, weight, bias, mean.repeat(reps, 1), mean2.repeat(reps, 1), eps, silu)


# ------------------------------------------------------------------ the plan


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """One launch's geometry: a cluster of `ranks` CTAs per slab, rank r
    owning the slab's elements [r * part, min((r + 1) * part, slab))."""

    ranks: int
    part: int        # elements per rank, a multiple of 16 bytes
    slab: int        # elements per (b, g) slab
    hw: int          # elements per channel
    cg: int          # channels per group
    nslabs: int      # B * groups
    itemsize: int
    smem: int        # dynamic shared memory per CTA, bytes

    @property
    def portable(self) -> bool:
        return self.ranks <= 8

    @property
    def hw_div(self):
        """(mul, shift) of the kernel's division by hw (fast_div)."""
        return fast_div(self.hw)

    @property
    def ranges(self):
        """Each rank's [start, end) within the slab."""
        return [(min(r * self.part, self.slab), min((r + 1) * self.part, self.slab)) for r in range(self.ranks)]


def fast_div(d: int) -> tuple[int, int]:
    """(mul, shift) such that e // d == ((e * mul) >> 32) >> shift for every
    0 <= e < 2**31 (mul 0 where d is 1: e itself): the round-up multiplier
    (Granlund and Montgomery) with which csrc/group_norm.cu's channel_of
    finds an element's channel."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()  # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def gn_smem(cg: int) -> int:
    """csrc/group_norm.cu's shared memory: (sum, sumsq) and padding, the
    warps' partials, (mean, rstd) and padding, then scale and shift per
    channel of the group."""
    return 4 * (4 + 2 * GN_WARPS + 4 + 2 * cg)


def gn_plan(shape, dtype: torch.dtype, sms: int = SMS, groups: int = 32, ranks: int | None = None) -> GnPlan:
    """The geometry for x of `shape` ([B, C, *], NCHW) in `dtype`: the
    largest cluster (a power of two, at most 16) that keeps the grid within
    two CTAs an SM, the slab cut into that many parts of whole 16-byte
    vectors. (Every cluster size measured on the H100 at the restore path's
    shapes, after the add that writes x: PERF.md §6.)
    `ranks` overrides the choice (for comparisons on the card)."""
    b, c = int(shape[0]), int(shape[1])
    hw = math.prod(int(d) for d in shape[2:])
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    cg = c // groups
    slab = cg * hw
    nslabs = b * groups
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    if slab >= 2**31 or nslabs > 65535:
        raise ValueError(f"group_norm kernel: slab {slab} or {nslabs} slabs out of range")
    if ranks is None:
        ranks = 1
        while 2 * ranks <= 16 and nslabs * 2 * ranks <= 2 * sms:
            ranks *= 2
    part = -(-(-(-slab // ranks)) // vec) * vec
    while ranks > 1 and (ranks - 1) * part >= slab:  # no empty rank
        ranks -= 1
    smem = gn_smem(cg)
    if not 1 <= ranks <= 16 or smem > SMEM_MAX:
        raise ValueError(f"no group_norm geometry: {ranks} ranks, smem {smem}")
    return GnPlan(ranks, part, slab, hw, cg, nslabs, itemsize, smem)


def gn_emulate(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, silu: bool,
               plan: GnPlan, fault: int = FAULT_NONE) -> torch.Tensor:
    """The kernel's algorithm in torch on `plan`: each rank's fp32 (sum,
    sumsq) over its part, the partials summed in rank order, mean and rstd,
    then each part normalised as (x - mean) * (w * rstd) + b, with the
    planted faults of the kernel's `fault` argument."""
    c = x.shape[1]
    xf = x.float().reshape(plan.nslabs, plan.slab)
    w, b = weight.float(), bias.float()
    g0 = (torch.arange(plan.nslabs) % groups) * plan.cg
    s1 = torch.zeros(plan.nslabs)
    s2 = torch.zeros(plan.nslabs)
    partials = []
    for rank, (e0, e1) in enumerate(plan.ranges):
        seg = xf[:, e0:e1]
        partials.append((seg.sum(1), (seg * seg).sum(1), e1 - e0))
        if not (fault == FAULT_DROP_RANK and rank == plan.ranks - 1):
            s1 = s1 + partials[-1][0]
            s2 = s2 + partials[-1][1]
    y = torch.empty_like(xf)
    for (e0, e1), (p1, p2, n) in zip(plan.ranges, partials):
        a1, a2, count = (p1, p2, max(n, 1)) if fault == FAULT_OWN_SLICE else (s1, s2, plan.slab)
        mean = a1 / count
        var = (a2 / count - mean * mean).clamp_min(0.0)
        rstd = 1.0 / torch.sqrt(var + eps)
        ch = g0[:, None] + torch.arange(e0, e1)[None, :] // plan.hw
        if fault == FAULT_AFFINE_SHIFT:
            ch = (ch + 1) % c
        src = xf[:, e0:e1]
        if fault == FAULT_NEIGHBOUR_GROUP:
            src = xf.roll(-1, 0)[:, e0:e1]
        y[:, e0:e1] = (src - mean[:, None]) * (w[ch] * rstd[:, None]) + b[ch]
    if silu:
        y = F.silu(y)
    return y.reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------------ the kernel


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.supir_group_norm.restype = i
    lib.supir_group_norm.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_uint, i, i, i, i, f, i, i, i, i, i, p]
    lib.supir_group_norm_clusters.restype = i
    lib.supir_group_norm_clusters.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    return lib


def build() -> None:
    """Compile and load csrc/group_norm.cu (at first use otherwise)."""
    _library()


@functools.lru_cache(maxsize=256)
def _plan(shape, dtype, index: int) -> GnPlan:
    return gn_plan(shape, dtype, torch.cuda.get_device_properties(index).multi_processor_count)


def plan_for(x: torch.Tensor) -> GnPlan:
    """The plan `group_norm` launches for x on its card."""
    return _plan(tuple(x.shape), x.dtype, x.device.index)


def clusters(plan: GnPlan, dtype: torch.dtype) -> int:
    """How many clusters of `plan` the current card holds at once
    (cudaOccupancyMaxActiveClusters); 0: the plan cannot be launched."""
    out = ctypes.c_int(0)
    err = _library().supir_group_norm_clusters(_DTYPES[dtype], plan.ranks, plan.part, plan.smem, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"group_norm occupancy query failed: cudaError {err}")
    return out.value


def _check(x, weight, bias, groups):
    if x.dim() < 3:
        raise ValueError(f"group_norm wants [B, C, ...], got {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes bf16, fp16 or fp32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs a contiguous NCHW tensor")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.shape != (c,) or not t.is_contiguous() or t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be a contiguous fp32, bf16 or fp16 [{c}] tensor on {x.device}")


def _launch(x, weight, bias, groups: int, eps: float, silu: bool, plan: GnPlan,
            fault: int = FAULT_NONE) -> torch.Tensor:
    """One launch of csrc/group_norm.cu on `plan`; returns y."""
    if x.data_ptr() % 16 == 0:
        y = torch.empty_like(x)
    else:
        # y at x's offset mod 16, so that one head/body/tail split serves both
        shift = (x.data_ptr() % 16) // x.element_size()
        y = torch.empty(x.numel() + 16 // x.element_size(), dtype=x.dtype, device=x.device)
        y = y[(shift - y.data_ptr() % 16 // x.element_size()) % (16 // x.element_size()):][:x.numel()].view(x.shape)
    with torch.cuda.device(x.device):
        err = _library().supir_group_norm(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), _DTYPES[x.dtype], _DTYPES[weight.dtype],
            _DTYPES[bias.dtype], plan.slab, plan.hw, *plan.hw_div, plan.cg, groups, plan.nslabs, float(eps), int(silu),
            plan.ranks, plan.part, plan.smem, fault,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        why = "the cluster cannot be placed on this card" if err == -1 else f"cudaError {err}"
        raise RuntimeError(f"group_norm kernel launch failed ({tuple(x.shape)}, {plan.ranks} ranks): {why}")
    return y


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) over NCHW x with fp32 statistics, in x's dtype."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    refuse_grad("group_norm (K2)", x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on CPU or CUDA tensors, not {x.device}")
    _check(x, weight, bias, groups)
    if x.numel() == 0:
        return torch.empty_like(x)
    y = _launch(x, weight, bias, groups, eps, silu, plan_for(x))
    group_norm.launches += 1
    return y


group_norm.launches = 0


# ------------------------------------------------------- the first design


def _get_kernels():
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def _gn_stats(x_ptr, part_ptr, slab, chunk, n_chunks, BLOCK: tl.constexpr):
        g = tl.program_id(0)
        c = tl.program_id(1)
        base = x_ptr + g.to(tl.int64) * slab
        acc = tl.zeros([BLOCK], tl.float32)
        acc2 = tl.zeros([BLOCK], tl.float32)
        for off in range(0, chunk, BLOCK):
            idx = c * chunk + off + tl.arange(0, BLOCK)
            x = tl.load(base + idx, mask=idx < slab, other=0.0).to(tl.float32)
            acc += x
            acc2 += x * x
        out = part_ptr + (g * n_chunks + c) * 2
        tl.store(out, tl.sum(acc, 0))
        tl.store(out + 1, tl.sum(acc2, 0))

    @triton.jit
    def _gn_apply(x_ptr, y_ptr, w_ptr, b_ptr, part_ptr, slab, chunk, n_chunks,
                  hw, cg, groups, eps,
                  APPLY_SILU: tl.constexpr, BLOCK: tl.constexpr, BLOCK_P: tl.constexpr):
        g = tl.program_id(0)
        c = tl.program_id(1)
        p = tl.arange(0, BLOCK_P)
        parts = part_ptr + (g * n_chunks + p) * 2
        s1 = tl.sum(tl.load(parts, mask=p < n_chunks, other=0.0), 0)
        s2 = tl.sum(tl.load(parts + 1, mask=p < n_chunks, other=0.0), 0)
        n = slab * 1.0
        mean = s1 / n
        var = tl.maximum(s2 / n - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        ch0 = (g % groups) * cg
        xbase = x_ptr + g.to(tl.int64) * slab
        ybase = y_ptr + g.to(tl.int64) * slab
        for off in range(0, chunk, BLOCK):
            idx = c * chunk + off + tl.arange(0, BLOCK)
            mask = idx < slab
            x = tl.load(xbase + idx, mask=mask, other=0.0).to(tl.float32)
            ch = ch0 + idx // hw
            w = tl.load(w_ptr + ch, mask=mask, other=1.0).to(tl.float32)
            bb = tl.load(b_ptr + ch, mask=mask, other=0.0).to(tl.float32)
            y = (x - mean) * rstd * w + bb
            if APPLY_SILU:
                y = y * tl.sigmoid(y)
            tl.store(ybase + idx, y.to(y_ptr.dtype.element_ty), mask=mask)

    _kernels = (triton, _gn_stats, _gn_apply)
    return _kernels


def build_triton() -> None:
    """Import Triton and define the first design's kernels; Triton compiles
    each specialisation at its first launch."""
    _get_kernels()


def group_norm_triton(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      groups: int = 32, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """The first design, for comparisons on the card only: `_gn_stats`
    writes each (group, chunk) program's fp32 sum and sum of squares into a
    partials tensor allocated per call, `_gn_apply` reduces them and
    normalises its chunk (x read twice, two launches)."""
    _check(x, weight, bias, groups)
    triton, gn_stats, gn_apply = _get_kernels()
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    cg = c // groups
    slab = cg * hw
    n_groups = b * groups
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    want = max(1, min(triton.cdiv(slab, BLOCK), triton.cdiv(TARGET_PROGRAMS, n_groups)))
    chunk = triton.cdiv(triton.cdiv(slab, want), BLOCK) * BLOCK
    n_chunks = triton.cdiv(slab, chunk)
    partials = torch.empty((n_groups, n_chunks, 2), dtype=torch.float32, device=x.device)
    grid = (n_groups, n_chunks)
    with torch.cuda.device(x.device):
        gn_stats[grid](x, partials, slab, chunk, n_chunks, BLOCK=BLOCK, num_warps=4)
        gn_apply[grid](
            x, y, weight, bias, partials, slab, chunk, n_chunks, hw, cg, groups, float(eps),
            APPLY_SILU=bool(silu), BLOCK=BLOCK,
            BLOCK_P=triton.next_power_of_2(n_chunks), num_warps=4,
        )
    return y
