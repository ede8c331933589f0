"""Dispatch to the kernels: the plain version for CPU tensors, the CUDA
kernel for CUDA tensors.  There is no fallback from one to the other; a
CUDA tensor the kernel refuses raises.

``rmsnorm`` is differentiable: a ``torch.autograd.Function`` whose forward is
the kernel (on the card) and whose backward is plain PyTorch
(``ref.rmsnorm_bwd_ref``, the JAX package's ``_rms_bwd``): only x and g are
saved and inv-rms is recomputed.  The JAX package has no TPU kernel for that
backward; a CUDA one is later work.

``slstm_scan`` is the sLSTM time loop (no TPU kernel: the JAX package runs
it as a ``lax.scan``), differentiable: on the card a forward and a backward
kernel (``kernels/slstm_scan.py::SLSTMScan``), on the CPU the plain loop
(``ref.slstm_scan_ref``) under autograd.

``wgrad_accum`` is a W-pass op and needs no gradient.  It updates its
accumulator in place and returns it, where the JAX reference returns a new
array (and updates the donated buffer in place under ``jit``).  That is safe
on the training path: the accumulators are fresh zeros made per step by
``core/executor.py`` (one stacked fp32 tensor per block leaf and chunk,
each stage writing its own view; in graph mode the same buffers at the
addresses of capture, zeroed by every replay), W is the only writer,
nothing reads them before the step's gradients are returned, and
``optim/postval.py``'s rollback and redo read only those returned
gradients, never a W-pass intermediate.

Fake tensors (``torch._subclasses.fake_tensor.FakeTensor``, of the dry run
``launch/dryrun.py``) take the kernels' route whatever their device,
and launch nothing: each entry returns what its kernel returns, in shape,
dtype and device, allocated under the fake mode; the sLSTM loop goes
through :class:`~repro_torch.kernels.slstm_scan.SLSTMScan`, which saves
what it saves on the card; ``wgrad_accum`` runs its product ``a^T @ g``
as a fake ``torch.mm``, which an active ``FlopCounterMode`` counts as the
kernel's 2·N·H·F operations (the kernel is a ctypes call that no mode
sees).  No launch counter moves.  A real tensor never takes this branch.
"""

from __future__ import annotations

import torch

from . import is_fake
from . import rmsnorm as _rms
from . import slstm_scan as _sl
from . import wgrad_accum as _wg
from .ref import rmsnorm_bwd_ref, rmsnorm_ref, slstm_scan_ref

__all__ = ["rmsnorm", "slstm_scan", "wgrad_accum"]


def _rmsnorm_fwd(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    if is_fake(x):  # the kernel's output, no launch
        _rms.check_args(x, g)
        return torch.empty_like(x)
    if x.device.type == "cuda":
        return _rms.rmsnorm_fused(x, g, eps)  # checks its arguments itself
    _rms.check_args(x, g)  # the plain path refuses what the kernel would refuse
    if x.device.type == "cpu":
        return rmsnorm_ref(x, g, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, eps):
        ctx.save_for_backward(x, g)
        ctx.eps = eps
        return _rmsnorm_fwd(x, g, eps)

    @staticmethod
    def backward(ctx, dy):
        x, g = ctx.saved_tensors
        dx, dg = rmsnorm_bwd_ref(x, g, dy, ctx.eps)
        return dx, dg, None


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., H), g (H,) -> x * rsqrt(mean(x^2) + eps) * (1 + g), x's dtype."""
    return _RMSNorm.apply(x, g, eps)


def slstm_scan(i_pre: torch.Tensor, f_pre: torch.Tensor, z: torch.Tensor):
    """The sLSTM time loop: i_pre, f_pre, z fp32 (b, s, h) -> (h (b, s, h),
    (c, n, m) (b, h), the state after the last step, which carries no
    gradient on the card)."""
    if is_fake(i_pre) or i_pre.device.type == "cuda":  # a fake tensor launches nothing
        hs, c, n, m = _sl.SLSTMScan.apply(i_pre, f_pre, z)  # checks its arguments itself
        return hs, (c, n, m)
    _sl.check_args(i_pre, f_pre, z)
    if i_pre.device.type == "cpu":
        return slstm_scan_ref(i_pre, f_pre, z)
    raise ValueError(f"slstm_scan: no kernel for device {i_pre.device}")


def wgrad_accum(a: torch.Tensor, g: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """a (N, H), g (N, F), acc (H, F) float32: adds ``a^T @ g`` (summed in
    fp32) into ``acc`` in place, in the reference's order ``acc + sum``, and
    returns ``acc``."""
    if is_fake(a):  # in place, no launch; the product for a flop counter
        _wg.check_args(a, g, acc)
        torch.mm(a.t(), g)
        return acc
    if a.device.type == "cuda":
        return _wg.wgrad_accum_cuda(a, g, acc)  # checks its arguments itself
    _wg.check_args(a, g, acc)
    if a.device.type == "cpu":
        return acc.add_(a.float().t() @ g.float())
    raise ValueError(f"wgrad_accum: no kernel for device {a.device}")
