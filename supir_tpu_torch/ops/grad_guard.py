"""Where gradients are asked for. A kernel bound through ctypes writes into
a fresh tensor, so its result has no autograd history: a site where
`needs_grad` holds takes a differentiable route (`FlashAttention`, the plain
GroupNorm), and a kernel wrapper handed such inputs raises (`refuse_grad`)
rather than return a result that would drop the gradient without a word.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Grad mode is on and one of `tensors` requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if `needs_grad(*tensors)`."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{kernel} has no autograd rule: called under grad mode on a tensor that requires a "
            f"gradient, its result would drop that gradient (use the differentiable route)"
        )
