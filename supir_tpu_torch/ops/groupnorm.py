"""K2: GroupNorm(32) with an optional fused SiLU, written by hand in Triton.

Replaces `supir_tpu/ops/groupnorm.py:_gn_silu_kernel` (:40), launched from
`group_norm_silu` (:118): fp32 per-(batch, group) mean and E[x^2] - mean^2
(clamped at 0), the per-channel affine, then SiLU, written in x's dtype. On
the TPU the kernel was opt-in; here it is the CUDA path of every
`GroupNorm32` site.

What bounds it on the card: bytes. It reads x twice and writes it once,
against a handful of flops per element, so it sits far below the H100's
ridge point and can at best stream at HBM bandwidth.

Design: in NCHW each (b, g) group is one contiguous slab of cg*H*W
elements. One slab per program would leave most of the 132 SMs idle at
[1, 128, 1024, 1024] (32 groups), so the slab is cut into chunks:
  1. `_gn_stats`: each (group, chunk) program writes its fp32 sum and sum
     of squares to a [B*G, n_chunks, 2] buffer. No atomics, so runs are
     deterministic.
  2. `_gn_apply`: each (group, chunk) program reduces its group's partials
     to mean and rstd and normalises its chunk, with the affine and SiLU
     fused into the same pass.
Triton is imported inside the launching function, so the module imports on
machines without it.

`group_norm` is the wrapper: on a CPU tensor it returns the plain version,
`group_norm_plain`; on a CUDA tensor it launches the kernels or raises.
`group_norm.launches` counts calls that launched the pair.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def build() -> None:
    """Import Triton and define the kernels; Triton compiles each
    specialisation at its first launch."""
    _get_kernels()


def _check(x, weight, bias, groups):
    if x.dim() < 3:
        raise ValueError(f"group_norm wants [B, C, ...], got {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"group_norm kernel takes bf16, fp16 or fp32, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm kernel needs a contiguous NCHW tensor")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{c}] tensor on {x.device}")


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = 32, eps: float = 1e-5, silu: bool = False) -> torch.Tensor:
    """GroupNorm (+ SiLU) over NCHW x with fp32 statistics, in x's dtype."""
    if x.device.type == "cpu":
        return group_norm_plain(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm runs on CPU or CUDA tensors, not {x.device}")
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
    group_norm.launches += 1
    return y


group_norm.launches = 0
