"""Baseline pipeline schedules: GPipe, 1F1B, interleaved 1F1B.

Translated from ``src/repro/core/schedules/baselines.py``.  In the IR every
backward is split into B and W; in these baselines each W directly follows
its B, the classic fused backward (the planner simulates them with
``TimeModel(grouped_w=True)``).
"""

from __future__ import annotations

from typing import List

from .ir import Op, OpKind, Placement, Schedule

__all__ = ["gpipe", "one_f_one_b", "interleaved_1f1b"]


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


def interleaved_1f1b(p: int, m: int, v: int = 2) -> Schedule:
    """Megatron interleaved 1F1B with ``v`` chunks per stage.

    Requires ``m % p == 0`` (Megatron's constraint).  Virtual microbatches are
    walked in groups of ``p``: group g covers chunk ``g % v`` of microbatches
    ``(g // v) * p .. (g // v) * p + p - 1``.
    """
    if m % p != 0:
        raise ValueError(f"interleaved 1F1B requires m % p == 0 (m={m}, p={p})")
    if v < 2:
        raise ValueError("interleaved needs v >= 2 chunks")
    total = m * v

    def fwd_virtual(k: int) -> Op:
        g, r = divmod(k, p)
        return Op(OpKind.F, (g // v) * p + r, g % v)

    def bwd_virtual(k: int) -> Op:
        g, r = divmod(k, p)
        return Op(OpKind.B, (g // v) * p + r, v - 1 - (g % v))

    stage_ops: List[List[Op]] = []
    for s in range(p):
        warm = min((p - s - 1) * 2 + (v - 1) * p, total)
        ops: List[Op] = [fwd_virtual(k) for k in range(warm)]
        nf, nb = warm, 0
        while nb < total:
            if nf < total:
                ops.append(fwd_virtual(nf))
                nf += 1
            b = bwd_virtual(nb)
            ops += [b, Op(OpKind.W, b.mb, b.chunk)]
            nb += 1
        stage_ops.append(ops)
    return Schedule(p, m, stage_ops, placement=Placement.linear(p, v),
                    name=f"1f1b-interleaved-v{v}")
