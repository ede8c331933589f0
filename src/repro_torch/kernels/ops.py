"""Dispatch to the kernels: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors.  There is no fallback from one to the other; a
CUDA tensor the kernel refuses raises.  Forward only: serving needs no
gradient (the backward kernel comes with the training slice)."""

from __future__ import annotations

import torch

from .ref import rmsnorm_ref
from .rmsnorm import check_args, rmsnorm_fused

__all__ = ["rmsnorm"]


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., H), g (H,) -> x * rsqrt(mean(x^2) + eps) * (1 + g), x's dtype."""
    if x.device.type == "cuda":
        return rmsnorm_fused(x, g, eps)  # checks its arguments itself
    check_args(x, g)  # the plain path refuses what the kernel would refuse
    if x.device.type == "cpu":
        return rmsnorm_ref(x, g, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")
