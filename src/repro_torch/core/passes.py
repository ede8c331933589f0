"""F/B/W split of the port: the backward of a pipeline block, cut into B
(input gradient) and W (weight gradient).

Counterpart of ``src/repro/core/passes.py``.  Every pipeline-stage
computation is an :class:`FBWModule` with three passes:

  * ``fwd(params, x, side)           -> (y, res)``   -- forward, keeping residuals
  * ``bwd_x(params, res, dy, side)   -> (dx, wctx)`` -- input gradient (B)
  * ``bwd_w(params, wctx, side, acc) -> grads``      -- parameter gradient (W)

The JAX package derives the cut by partitioning the backward jaxpr.  The port
makes it with autograd and one deferred linear instead:

  * :func:`linear` is ``x @ w``.  While a W-context is being collected (inside
    :func:`autograd_fbw`'s forward) it is the ``torch.autograd.Function``
    :class:`_DeferredLinear`, whose backward returns only ``dx = g @ w^T`` and
    appends ``(a, g)`` -- the input and the output gradient, flattened to
    (N, H) and (N, F), contiguous -- to the W-context.  It computes no dW.
  * B is one ``torch.autograd.grad`` of the block output w.r.t. its input and
    the *cheap* parameter leaves (every leaf that is not a deferred weight:
    norm gains, the padding mask).  Their gradients are finished at B, as the
    reference's compact cut folds them (DESIGN.md Sec. 3 and 7).  The
    residual graph is freed there (``retain_graph=False``).
  * W reads only the W-context: one ``kernels.ops.wgrad_accum(a, g, acc)``
    per deferred linear (the CUDA kernel on the card), which adds into that
    weight's fp32 accumulator in place, plus the finished cheap grads, added
    out of place.

A module built with ``fuse_wgrad=False`` adds ``a^T @ g``, computed by
``torch.matmul`` in the weight's dtype, to the accumulator instead: the
sink's head product, which the reference leaves to XLA.
"""

from __future__ import annotations

import contextvars
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels import ops
from ..tree import tree_flatten, tree_unflatten

__all__ = ["FBWModule", "SequentialFBW", "autograd_fbw", "linear", "loss_seed"]

PyTree = Any


class FBWModule:
    """Protocol + base class for split-backward modules."""

    name: str = "fbw"

    def fwd(self, params: PyTree, x: PyTree, side: PyTree) -> Tuple[PyTree, PyTree]:
        raise NotImplementedError

    def bwd_x(self, params: PyTree, res: PyTree, dy: PyTree, side: PyTree) -> Tuple[PyTree, PyTree]:
        raise NotImplementedError

    def bwd_w(self, params: PyTree, wctx: PyTree, side: PyTree, acc: PyTree) -> PyTree:
        """Parameter gradients from the B pass's ``wctx`` alone; the F->B
        residuals are gone.  Returns ``acc + grads`` (``acc`` is a tree like
        params), the terminal products fused through the accumulation
        kernel, which updates those leaves of ``acc`` in place."""
        raise NotImplementedError


# --------------------------------------------------------------------- #
# the deferred linear
# --------------------------------------------------------------------- #
class _WContext:
    """What one forward of a split module collects: each deferred linear's
    weight (in call order) and, once B ran, its ``(a, g)`` pair."""

    def __init__(self):
        self.weights: List[torch.Tensor] = []
        self.pairs: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = []


# the W-context the current forward collects into (None: plain products)
_collecting: contextvars.ContextVar[Optional[_WContext]] = contextvars.ContextVar(
    "repro_torch_wctx", default=None)


class _DeferredLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, wc, i):
        a = x.reshape(-1, x.shape[-1]).contiguous()
        ctx.save_for_backward(a, w)
        ctx.wc, ctx.i, ctx.x_shape = wc, i, x.shape
        return (a @ w).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, gy):
        a, w = ctx.saved_tensors
        g = gy.reshape(-1, gy.shape[-1]).contiguous()
        ctx.wc.pairs[ctx.i] = (a.detach(), g)  # W's operands; no dW here
        return (g @ w.t()).reshape(ctx.x_shape), None, None, None


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w is (in, out)); deferred while a W-context is collected."""
    wc = _collecting.get()
    if wc is None:
        return x @ w
    wc.weights.append(w)
    wc.pairs.append(None)
    return _DeferredLinear.apply(x, w, wc, len(wc.pairs) - 1)


# --------------------------------------------------------------------- #
# a split module from any forward whose weight products use `linear`
# --------------------------------------------------------------------- #
class _AutogradFBW(FBWModule):
    def __init__(self, f: Callable, name: str, fuse_wgrad: bool):
        self.f = f
        self.name = name
        self.fuse_wgrad = fuse_wgrad

    def fwd(self, params, x, side):
        leaves, struct = tree_flatten(params)
        alias = [t.detach().requires_grad_(True) if t.is_floating_point() else t for t in leaves]
        x_leaf = x.detach().requires_grad_(True)
        wc = _WContext()
        token = _collecting.set(wc)
        try:
            with torch.enable_grad():
                y = self.f(tree_unflatten(struct, alias), x_leaf, side)
        finally:
            _collecting.reset(token)
        index = {id(t): k for k, t in enumerate(alias)}
        deferred = [index[id(w)] for w in wc.weights]
        cheap = [k for k, t in enumerate(alias) if t.is_floating_point() and k not in deferred]
        return y.detach(), (x_leaf, y, [alias[k] for k in cheap], cheap, deferred, wc)

    def bwd_x(self, params, res, dy, side):
        x_leaf, y, cheap_leaves, cheap, deferred, wc = res
        grads = torch.autograd.grad(y, [x_leaf] + cheap_leaves, grad_outputs=dy,
                                    allow_unused=True)
        if any(pair is None for pair in wc.pairs):
            raise RuntimeError(f"{self.name}: a deferred linear got no gradient in B")
        return grads[0], (deferred, wc.pairs, cheap, list(grads[1:]))

    def bwd_w(self, params, wctx, side, acc):
        deferred, pairs, cheap, cheap_grads = wctx
        out, struct = tree_flatten(acc)
        for k, (a, g) in zip(deferred, pairs):
            if self.fuse_wgrad:
                out[k] = ops.wgrad_accum(a, g, out[k])
            else:
                out[k] = out[k] + (a.t() @ g).to(out[k].dtype)
        for k, dg in zip(cheap, cheap_grads):
            if dg is not None:
                out[k] = out[k] + dg.to(out[k].dtype)
        return tree_unflatten(struct, out)


def autograd_fbw(f: Callable[[PyTree, torch.Tensor, PyTree], torch.Tensor], name: str = "auto",
                 fuse_wgrad: bool = True) -> FBWModule:
    """Split ``f(params, x, side) -> y`` into F/B/W passes: weight products
    that go through :func:`linear` are deferred to W, every other parameter
    leaf gets its gradient at B."""
    return _AutogradFBW(f, name, fuse_wgrad)


# --------------------------------------------------------------------- #
# sequential composition
# --------------------------------------------------------------------- #
class SequentialFBW(FBWModule):
    """Compose FBW modules; F runs left-to-right, B right-to-left, and W
    reads each sub-module's own context."""

    def __init__(self, modules: Sequence[FBWModule], name: str = "seq"):
        self.modules = list(modules)
        self.name = name

    def fwd(self, params, x, side):
        res_all = []
        for mod, p in zip(self.modules, params):
            x, res = mod.fwd(p, x, side)
            res_all.append(res)
        return x, tuple(res_all)

    def bwd_x(self, params, res, dy, side):
        wctx_all: List[PyTree] = [None] * len(self.modules)
        for i in reversed(range(len(self.modules))):
            dy, wctx_all[i] = self.modules[i].bwd_x(params[i], res[i], dy, side)
        return dy, tuple(wctx_all)

    def bwd_w(self, params, wctx, side, acc):
        return tuple(
            mod.bwd_w(p, w, side, acc=a)
            for mod, p, w, a in zip(self.modules, params, wctx, acc)
        )


def loss_seed(loss: torch.Tensor) -> torch.Tensor:
    """Cotangent that seeds B at the loss position."""
    return torch.ones_like(loss)
