"""Baseline pipeline schedules: GPipe and 1F1B.

Translated from ``src/repro/core/schedules/baselines.py`` (the interleaved
1F1B builder is not ported yet).  In the IR every backward is split into B
and W; in these baselines each W directly follows its B, the classic fused
backward.
"""

from __future__ import annotations

from typing import List

from .ir import Op, OpKind, Schedule

__all__ = ["gpipe", "one_f_one_b"]


def gpipe(p: int, m: int) -> Schedule:
    """All forwards, then all backwards (Huang et al., 2019)."""
    stage_ops: List[List[Op]] = []
    for _s in range(p):
        ops = [Op(OpKind.F, j) for j in range(m)]
        for j in range(m):
            ops += [Op(OpKind.B, j), Op(OpKind.W, j)]
        stage_ops.append(ops)
    return Schedule(p, m, stage_ops, name="gpipe")


def one_f_one_b(p: int, m: int) -> Schedule:
    """Megatron-style non-interleaved 1F1B (Fan 2021; Narayanan 2021).

    Stage s runs ``p - 1 - s`` warm-up forwards, then alternates F/B with the
    weight pass immediately after each B (fused backward).
    """
    stage_ops: List[List[Op]] = []
    for s in range(p):
        warm = min(p - 1 - s, m)
        ops = [Op(OpKind.F, j) for j in range(warm)]
        for j in range(m):
            if warm + j < m:
                ops.append(Op(OpKind.F, warm + j))
            ops += [Op(OpKind.B, j), Op(OpKind.W, j)]
        stage_ops.append(ops)
    return Schedule(p, m, stage_ops, name="1f1b")
