"""K1: flash-attention forward, written by hand in CUDA C++ for Hopper.

Replaces `supir_tpu/ops/flash_attention.py:_attn_kernel_packed` (:35) and
`_attn_kernel_packed_single` (:123), launched from `_flash_primal` (:363):
softmax(Q K^T / sqrt(D)) V over [B, S, H, D] with a ragged last kv block,
and with the TPU kernels' causal mask (query i sees keys 0..i, S == T). The kernel is `supir_tpu_torch/csrc/flash_attn_fwd.cu`; its header
says what bounds it on the card and how it is laid out.

`flash_attention` is the wrapper: on a CPU tensor it returns the plain
version, `attention_plain`; on a CUDA tensor it launches the kernel or
raises. `flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

_SOURCE = "flash_attn_fwd.cu"
HEAD_DIMS = (64, 128)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """[B,S,H,D] x [B,T,H,D] -> [B,S,H,D] with an fp32 softmax: the form of
    `supir_tpu/ops/attention.py:_xla_attention` (:63-76). `bias` is added to
    the fp32 logits; `causal` lets query i see keys up to i + T - S (the last
    S keys end on the diagonal, which is the plain causal mask when S == T)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        s, t = logits.shape[-2:]
        keep = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", weights, v)


def _library() -> ctypes.CDLL:
    from supir_tpu_torch.ops.cuda_build import load_library

    lib = load_library(_SOURCE)
    fn = lib.supir_flash_attn_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_void_p]
    )
    return lib


SOURCES = (_SOURCE,)  # for cuda_build.build_all


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention wants q [B,S,H,D], k/v [B,T,H,D]; got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch, heads or head dim")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"the causal kernel wants as many queries as keys; got {q.shape[1]} and {k.shape[1]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernel takes bf16; {name} is {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous (stride {t.stride()})")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned with strides in multiples of 8 (stride {t.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over q [B,S,H,D] and k/v [B,T,H,D]; with
    `causal`, query i sees keys 0..i (S == T)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device}")
    _check(q, k, v, causal)
    b, s, h, d = q.shape
    t = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if s == 0 or b * h == 0:
        return out
    fn = _library().supir_flash_attn_fwd_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, s, t, d, int(causal),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            d ** -0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
