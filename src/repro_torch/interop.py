"""Carry the JAX package's parameters and AdamW state over to the port,
leaf for leaf.

The port keeps the JAX layout (linear weights ``(in, out)``, stage-stacked
leaves with their leading ``(p,)`` axis, the ``mask`` leaf), so the carry-over
is a copy.  Callers turn every JAX leaf into numpy first (``np.asarray``), so
this module needs neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .optim.adamw import AdamWState
from .tree import tree_map

__all__ = ["params_from_numpy", "adamw_from_numpy", "to_torch"]


def to_torch(a: np.ndarray, *, device="cpu", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy (including ``ml_dtypes.bfloat16``, bit for bit) -> torch."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_numpy(stacked, shared, *, device, dtype: Optional[torch.dtype] = None):
    """(stacked per chunk, shared) numpy trees -> the port's parameters.

    ``dtype`` casts the floating-point weights that are not float32 in the
    JAX tree: a float32 leaf (the ``mask``, the moe router, which the JAX
    ``init_moe`` keeps in float32 in a bf16 model) stays float32.
    """

    def conv(a):
        keep = dtype is None or np.asarray(a).dtype == np.float32
        return to_torch(a, device=device, dtype=None if keep else dtype)

    out_stacked = tuple(
        {
            "mask": to_torch(chunk["mask"], device=device, dtype=torch.float32),
            "blocks": tree_map(conv, chunk["blocks"]),
        }
        for chunk in stacked
    )
    return out_stacked, tree_map(conv, dict(shared))


def adamw_from_numpy(state, *, device) -> AdamWState:
    """A JAX ``AdamWState`` (``t``, ``m``, ``v``; stacked or shared trees,
    leaves as numpy) -> the port's: int32 ``t``, fp32 moments."""
    t, m, v = state

    def conv(a):
        return to_torch(a, device=device, dtype=torch.float32)

    return AdamWState(t=to_torch(t, device=device, dtype=torch.int32), m=tree_map(conv, m),
                      v=tree_map(conv, v))
