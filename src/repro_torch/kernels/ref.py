"""Plain PyTorch versions of the kernels (the CPU path and the oracle the
CUDA kernels are held against on the card)."""

import torch

__all__ = ["rmsnorm_ref", "rmsnorm_bwd_ref", "wgrad_accum_ref"]


def rmsnorm_ref(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + g)`` in fp32, cast to x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + g.float())).to(x.dtype)


def wgrad_accum_ref(a: torch.Tensor, g: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc + a^T @ g``: a (N, H), g (N, F), acc (H, F); the product in
    fp32 (inputs upcast, so bf16 inputs are multiplied exactly), plus acc,
    cast to acc's dtype."""
    return (acc.float() + a.float().t() @ g.float()).to(acc.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, g: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6):
    """Backward of :func:`rmsnorm_ref` from x and g alone (inv-rms is
    recomputed, nothing else is saved): returns (dx in x's dtype, dg in g's
    dtype), dg summed over every leading axis.  The arithmetic of the JAX
    package's ``kernels/ops.py::_rms_bwd``."""
    x32, dy32 = x.float(), dy.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = x32 * inv
    dg = torch.sum((dy32 * xhat).reshape(-1, x.shape[-1]), dim=0)
    dxhat = dy32 * (1.0 + g.float())
    dx = inv * (dxhat - xhat * torch.mean(dxhat * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dg.to(g.dtype)
