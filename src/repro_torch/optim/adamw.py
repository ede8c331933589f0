"""AdamW with arithmetically reversible rollback (paper Alg. 1).

Counterpart of ``src/repro/optim/adamw.py``, the same arithmetic in the same
order on torch tensors:

    STEP:      t+=1;  m = b1 m + (1-b1) g;   v = b2 v + (1-b2) g^2
               theta = theta - lr*wd*theta - lr * m_hat / (sqrt(v_hat)+eps)
    ROLLBACK:  theta = (theta + lr * m_hat / (sqrt(v_hat)+eps)) / (1 - lr*wd)
               m = (m - (1-b1) g)/b1;  v = (v - (1-b2) g^2)/b2;  t-=1

:func:`step` and :func:`rollback` are functional: they return new trees
and leave their inputs as they were.  :func:`step_` and :func:`rollback_`
run the same arithmetic on the same leaves in place, as the JAX step's
donated update writes into its buffers: each leaf is cut, as a flat view,
into slices of :data:`SLICE` elements, and a slice's new parameter and
moments are written into the stored ones before the next slice starts.
Every element goes through the same torch ops in the same order on the
same dtypes, so both give the same bits; the in-place ones hold one slice's
temporaries instead of a whole tree's new state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from ..tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any

__all__ = ["AdamWConfig", "AdamWState", "SLICE", "init", "step", "rollback", "step_",
           "rollback_"]

# elements of a slice of the in-place step: its new parameter and moments
# and its fp32 temporaries hold at most 40 bytes an element at once (bf16
# weights, counted on meta tensors), 0.63 GiB a slice, under the 0.71 GiB
# fp32 square of internlm2-1.8b's largest leaf (the 92544 x 2048 embedding)
# that the gradient norm takes anyway (stepped whole, that leaf's own
# temporaries held 7 GiB); and a slice is still large enough that its ~20 elementwise launches
# (~0.2 ms of host time, reckoned) stay under the ~0.5 ms that its ~100
# bytes an element of HBM traffic take (reckoned from the H100's 3.35 TB/s)
SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0  # global-norm clip threshold


class AdamWState(NamedTuple):
    t: torch.Tensor  # scalar int32 timestep
    m: PyTree  # first moment, fp32
    v: PyTree  # second moment, fp32


def init(params: PyTree) -> AdamWState:
    leaves, struct = tree_flatten(params)
    dev = leaves[0].device if leaves else "cpu"

    def zeros():
        return tree_unflatten(struct, [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                       for p in leaves])

    return AdamWState(t=torch.zeros((), dtype=torch.int32, device=dev), m=zeros(), v=zeros())


def _hat(x, beta, t):
    return x / (1.0 - beta**t)


def _step_leaf(p, m, v, g, cfg: AdamWConfig, tf, scale):
    """One leaf's step: the new (parameter, m, v)."""
    g = g.float() * scale
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
    m_hat = _hat(m, cfg.b1, tf)
    v_hat = _hat(v, cfg.b2, tf)
    p32 = p.float()
    p32 = p32 - cfg.lr * cfg.weight_decay * p32 - cfg.lr * m_hat / (torch.sqrt(v_hat) + cfg.eps)
    return p32.to(p.dtype), m, v


def _rollback_leaf(p, m, v, g, cfg: AdamWConfig, tf, scale):
    """One leaf's rollback: the previous (parameter, m, v)."""
    g = g.float() * scale
    m_hat = _hat(m, cfg.b1, tf)
    v_hat = _hat(v, cfg.b2, tf)
    p32 = p.float()
    p32 = (p32 + cfg.lr * m_hat / (torch.sqrt(v_hat) + cfg.eps)) / (1.0 - cfg.lr * cfg.weight_decay)
    return p32.to(p.dtype), (m - (1.0 - cfg.b1) * g) / cfg.b1, (v - (1.0 - cfg.b2) * g * g) / cfg.b2


def _functional(leaf_fn, params, state, grads, cfg, tf, scale):
    """(new params, m, v) trees of ``leaf_fn`` over every leaf."""
    p_leaves, struct = tree_flatten(params)
    new = [leaf_fn(*leaves, cfg, tf, scale) for leaves in zip(
        p_leaves, tree_leaves(state.m), tree_leaves(state.v), tree_leaves(grads))]
    return tuple(tree_unflatten(struct, [n[k] for n in new]) for k in range(3))


def _flat(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError(f"the in-place AdamW step needs contiguous leaves; got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    return x.view(-1)


def _in_place(leaf_fn, params, state, grads, cfg, tf, scale) -> None:
    """``leaf_fn`` over every leaf, slice by slice, written into ``params``
    and the moments of ``state``."""
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.m), tree_leaves(state.v),
                          tree_leaves(grads)):
        p, m, v, g = (_flat(x) for x in (p, m, v, g))
        for a in range(0, p.numel(), SLICE):
            ps, ms, vs, gs = (x[a:a + SLICE] for x in (p, m, v, g))
            new_p, new_m, new_v = leaf_fn(ps, ms, vs, gs, cfg, tf, scale)
            ps.copy_(new_p)
            ms.copy_(new_m)
            vs.copy_(new_v)
            del new_p, new_m, new_v  # freed before the next slice steps


def step(params: PyTree, state: AdamWState, grads: PyTree, cfg: AdamWConfig,
         scale: Union[torch.Tensor, float] = 1.0) -> Tuple[PyTree, AdamWState]:
    """One AdamW step on ``scale * grads`` (scale carries the clip factor)."""
    t = state.t + 1
    new_p, new_m, new_v = _functional(_step_leaf, params, state, grads, cfg, t.float(), scale)
    return new_p, AdamWState(t=t, m=new_m, v=new_v)


def rollback(params: PyTree, state: AdamWState, grads: PyTree, cfg: AdamWConfig,
             scale: Union[torch.Tensor, float] = 1.0) -> Tuple[PyTree, AdamWState]:
    """Exact inverse of :func:`step` (paper Algorithm 1, lines 13-20)."""
    prev_p, prev_m, prev_v = _functional(_rollback_leaf, params, state, grads, cfg,
                                         state.t.float(), scale)
    return prev_p, AdamWState(t=state.t - 1, m=prev_m, v=prev_v)


def step_(params: PyTree, state: AdamWState, grads: PyTree, cfg: AdamWConfig,
          scale: Union[torch.Tensor, float] = 1.0) -> Tuple[PyTree, AdamWState]:
    """:func:`step` in place, slice by slice: ``params`` and the moments of
    ``state`` (contiguous leaves) are overwritten with the bits
    :func:`step` returns; returns them with the new step count."""
    t = state.t + 1
    _in_place(_step_leaf, params, state, grads, cfg, t.float(), scale)
    return params, AdamWState(t=t, m=state.m, v=state.v)


def rollback_(params: PyTree, state: AdamWState, grads: PyTree, cfg: AdamWConfig,
              scale: Union[torch.Tensor, float] = 1.0) -> Tuple[PyTree, AdamWState]:
    """:func:`rollback` in place, slice by slice, as :func:`step_`."""
    _in_place(_rollback_leaf, params, state, grads, cfg, state.t.float(), scale)
    return params, AdamWState(t=state.t - 1, m=state.m, v=state.v)
