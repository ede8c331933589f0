"""Handcrafted zero-bubble schedules ZB-H1 and ZB-H2 (paper Sec. 2).

Translated from ``src/repro/core/schedules/handcrafted.py``.

Both are "delayed-W 1F1B" variants: the backward is split, the B wave
propagates at T_B per hop (instead of T_B + T_W), and each stage defers its W
passes by a stage-dependent amount so W fills what would otherwise be
bubbles.

  * ZB-H1: warm-up identical to 1F1B (p-1-s forwards); stage s defers W_k
    until after B_{k+s}.  In-flight microbatches stay at p on every stage, so
    peak activation memory matches 1F1B (p * M_B).  Bubble:
    (p-1)(T_F + T_B - T_W).
  * ZB-H2: warm-up extended to 2(p-s)-3+... precisely min(m, 2p-1-2s)
    forwards, steady phase is B-then-F, and stage s defers W_k until after
    B_{k+2s}; the layout becomes a parallelogram with zero bubble under
    T_F = T_B = T_W at (2p-1) * M_B peak memory.
"""

from __future__ import annotations

from typing import Callable, List

from .ir import Op, OpKind, Schedule

__all__ = ["zb_h1", "zb_h2"]


def _delayed_w(
    p: int,
    m: int,
    warmup: Callable[[int], int],
    w_delay: Callable[[int], int],
    b_first: bool,
    name: str,
) -> Schedule:
    stage_ops: List[List[Op]] = []
    for s in range(p):
        warm = max(0, min(warmup(s), m))
        delay = w_delay(s)
        ops: List[Op] = [Op(OpKind.F, j) for j in range(warm)]
        w_next = 0
        for j in range(m):
            if b_first:
                # B, then due W passes, then F: keeps the steady-state peak at
                # the warm-up level (no +M_W transient above (2p-1) M_B).
                ops.append(Op(OpKind.B, j))
                while w_next <= j - delay and w_next < m:
                    ops.append(Op(OpKind.W, w_next))
                    w_next += 1
                if warm + j < m:
                    ops.append(Op(OpKind.F, warm + j))
            else:
                if warm + j < m:
                    ops.append(Op(OpKind.F, warm + j))
                ops.append(Op(OpKind.B, j))
                while w_next <= j - delay and w_next < m:
                    ops.append(Op(OpKind.W, w_next))
                    w_next += 1
        ops += [Op(OpKind.W, k) for k in range(w_next, m)]
        stage_ops.append(ops)
    return Schedule(p, m, stage_ops, name=name)


def zb_h1(p: int, m: int) -> Schedule:
    """Memory-efficient handcrafted schedule (paper Sec. 2.1)."""
    return _delayed_w(
        p,
        m,
        warmup=lambda s: p - 1 - s,
        w_delay=lambda s: s,
        b_first=False,
        name="zb-h1",
    )


def zb_h2(p: int, m: int) -> Schedule:
    """Zero-bubble handcrafted schedule (paper Sec. 2.2)."""
    return _delayed_w(
        p,
        m,
        warmup=lambda s: 2 * p - 1 - 2 * s,
        w_delay=lambda s: 2 * s,
        b_first=True,
        name="zb-h2",
    )
