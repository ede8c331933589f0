"""Plain PyTorch versions of the kernels (the CPU path and the oracle the
CUDA kernels are held against on the card)."""

import torch

__all__ = ["rmsnorm_ref", "rmsnorm_bwd_ref", "wgrad_accum_ref", "slstm_step", "slstm_scan_ref"]


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


def slstm_step(i_t, f_t, z_t, c, n, m):
    """One step of the sLSTM loop (the JAX ``apply_slstm`` scan body and its
    decode step), fp32 (b, h) each: -> (h, c, n, m) after the step.  The
    plain loop (:func:`slstm_scan_ref`) and a decode step
    (``models/serve.py``) both run it; the CUDA kernel is its bits."""
    m_new = torch.maximum(f_t + m, i_t)
    i_e = torch.exp(i_t - m_new)
    f_e = torch.exp(f_t + m - m_new)
    c = f_e * c + i_e * z_t
    n = f_e * n + i_e
    return c / torch.maximum(n, torch.ones((), dtype=n.dtype, device=n.device)), c, n, m_new


def slstm_scan_ref(i_pre: torch.Tensor, f_pre: torch.Tensor, z: torch.Tensor):
    """The sLSTM time loop of the JAX ``apply_slstm`` (its ``lax.scan``
    body), step by step: i_pre, f_pre, z fp32 (b, s, h) -> (hs (b, s, h),
    (c, n, m) (b, h) after the last step), all fp32, from the state
    ``c = n = 0``, ``m = -1e30``.  Written with ``torch.maximum``, whose
    gradient at a tie is half to each side as ``jnp.maximum``'s: at every
    channel's first step ``n`` is exactly 1 (``m = i``, so the input gate is
    1 and the forget gate 0), the tie of ``max(n, 1)``.  Differentiable by
    autograd."""
    b, s, h = i_pre.shape
    c = torch.zeros((b, h), dtype=torch.float32, device=i_pre.device)
    n = torch.zeros_like(c)
    m = torch.full_like(c, -1e30)
    hs = []
    for t in range(s):
        h_t, c, n, m = slstm_step(i_pre[:, t], f_pre[:, t], z[:, t], c, n, m)
        hs.append(h_t)
    return torch.stack(hs, dim=1), (c, n, m)
