"""Plain PyTorch versions of the kernels (the CPU path and the oracle the
CUDA kernels are held against on the card)."""

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + g)`` in fp32, cast to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + g.float())).to(x.dtype)
