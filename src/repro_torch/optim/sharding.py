"""ZeRO-1 byte rule of the port: optimizer-state bytes per data-parallel rank.

Counterpart of ``src/repro/optim/sharding.py::zero1_state_bytes``; only the
byte rule is ported (the planner prices the optimizer term with it).  The
sharded optimizer itself -- flat padded shards, reduce-scatter of the grads,
all-gather of the updated params -- is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

from ..tree import tree_leaves

__all__ = ["zero1_state_bytes"]


def _pad_len(n: int, dp: int) -> int:
    return (n + dp - 1) // dp * dp


def zero1_state_bytes(params: Any, dp_size: int, n_moments: int = 2,
                      moment_dtype_bytes: int = 4) -> float:
    """Per-rank optimizer-state bytes under ZeRO-1 sharding.

    AdamW keeps ``n_moments`` fp32 mirrors (m, v) of every parameter; each dp
    rank holds the padded 1/dp flat shard of each leaf, so this is exact for
    every ``dp_size``.  Only the leaves' ``shape`` is read (tensors, fake or
    meta tensors, anything with a shape).
    """
    dp = max(1, int(dp_size))
    elems = 0
    for leaf in tree_leaves(params):
        n = math.prod(leaf.shape) if len(leaf.shape) else 1
        elems += _pad_len(n, dp) // dp
    return float(elems * n_moments * moment_dtype_bytes)
