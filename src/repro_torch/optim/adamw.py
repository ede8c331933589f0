"""AdamW with arithmetically reversible rollback (paper Alg. 1).

Counterpart of ``src/repro/optim/adamw.py``, the same arithmetic in the same
order on torch tensors:

    STEP:      t+=1;  m = b1 m + (1-b1) g;   v = b2 v + (1-b2) g^2
               theta = theta - lr*wd*theta - lr * m_hat / (sqrt(v_hat)+eps)
    ROLLBACK:  theta = (theta + lr * m_hat / (sqrt(v_hat)+eps)) / (1 - lr*wd)
               m = (m - (1-b1) g)/b1;  v = (v - (1-b2) g^2)/b2;  t-=1

Both are functional: they return new trees and leave their inputs as they
were (the training step copies the result back into its buffers).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from ..tree import tree_flatten, tree_unflatten

PyTree = Any

__all__ = ["AdamWConfig", "AdamWState", "init", "step", "rollback"]


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


def step(params: PyTree, state: AdamWState, grads: PyTree, cfg: AdamWConfig,
         scale: Union[torch.Tensor, float] = 1.0) -> Tuple[PyTree, AdamWState]:
    """One AdamW step on ``scale * grads`` (scale carries the clip factor)."""
    t = state.t + 1
    tf = t.float()
    p_leaves, struct = tree_flatten(params)
    m_leaves, v_leaves = tree_flatten(state.m)[0], tree_flatten(state.v)[0]
    g_leaves = tree_flatten(grads)[0]
    new_p, new_m, new_v = [], [], []
    for p, m, v, g in zip(p_leaves, m_leaves, v_leaves, g_leaves):
        g = g.float() * scale
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * g * g
        m_hat = _hat(m, cfg.b1, tf)
        v_hat = _hat(v, cfg.b2, tf)
        p32 = p.float()
        p32 = p32 - cfg.lr * cfg.weight_decay * p32 - cfg.lr * m_hat / (torch.sqrt(v_hat) + cfg.eps)
        new_p.append(p32.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    unf = lambda leaves: tree_unflatten(struct, leaves)  # noqa: E731
    return unf(new_p), AdamWState(t=t, m=unf(new_m), v=unf(new_v))


def rollback(params: PyTree, state: AdamWState, grads: PyTree, cfg: AdamWConfig,
             scale: Union[torch.Tensor, float] = 1.0) -> Tuple[PyTree, AdamWState]:
    """Exact inverse of :func:`step` (paper Algorithm 1, lines 13-20)."""
    tf = state.t.float()
    p_leaves, struct = tree_flatten(params)
    m_leaves, v_leaves = tree_flatten(state.m)[0], tree_flatten(state.v)[0]
    g_leaves = tree_flatten(grads)[0]
    prev_p, prev_m, prev_v = [], [], []
    for p, m, v, g in zip(p_leaves, m_leaves, v_leaves, g_leaves):
        g = g.float() * scale
        m_hat = _hat(m, cfg.b1, tf)
        v_hat = _hat(v, cfg.b2, tf)
        p32 = p.float()
        p32 = (p32 + cfg.lr * m_hat / (torch.sqrt(v_hat) + cfg.eps)) / (1.0 - cfg.lr * cfg.weight_decay)
        prev_p.append(p32.to(p.dtype))
        prev_m.append((m - (1.0 - cfg.b1) * g) / cfg.b1)
        prev_v.append((v - (1.0 - cfg.b2) * g * g) / cfg.b2)
    unf = lambda leaves: tree_unflatten(struct, leaves)  # noqa: E731
    return unf(prev_p), AdamWState(t=state.t - 1, m=unf(prev_m), v=unf(prev_v))
