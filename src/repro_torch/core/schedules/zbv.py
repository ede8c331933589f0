"""ZB-V schedule (paper Sec. 6).

Copied from ``src/repro/core/schedules/zbv.py``.

Two chunks per worker placed in a "V": chunk 0 runs stages 0..p-1, chunk 1
runs stages p-1..0.  Both the forward entry (embedding) and the loss exit land
on worker 0, and the first worker starts B without waiting for a p-hop return
trip, which is what buys zero bubble at 1F1B-parity memory (p * M_B) under
T_F = T_B = T_W.

Warm-up (0-indexed worker s): ``min(2p-1-s, m)`` chunk-0 forwards interleaved
with ``min(s, m)`` chunk-1 forwards (in dependency-arrival order).  Steady
state: ``p-1-s`` F-B-W groups of chunk 1, then alternating chunk-1/chunk-0
groups.  Final phase: drain B (prioritized) then W.
"""

from __future__ import annotations

from typing import List, Optional

from .ir import Op, OpKind, Placement, Schedule

__all__ = ["zb_v"]


def _warmup_interleave(p: int, s: int, n0: int, n1: int) -> List[Op]:
    """Order warm-up forwards by their earliest possible start at worker s.

    Chunk-0 F of mb j reaches worker s no earlier than tick s + j; chunk-1 F
    of mb j no earlier than tick (2p - 1 - s) + 2j (down-sweep of the V).
    """
    items = []
    for j in range(n0):
        items.append((s + j, 0, j))
    for j in range(n1):
        items.append((2 * p - 1 - s + 2 * j, 1, j))
    items.sort()
    return [Op(OpKind.F, j, c) for _, c, j in items]


def zb_v(
    p: int,
    m: int,
    times: Optional["TimeModel"] = None,
    m_limit: Optional[float] = None,
    m_b: float = 1.0,
    m_w: float = 0.5,
) -> Schedule:
    """ZB-V via the Sec.-3.1 heuristic on the V placement (paper Sec. 6).

    Defaults to 1F1B-parity memory (``p * M_B``).  Falls back to the explicit
    handcrafted ordering if the heuristic cannot find a feasible schedule.
    """
    from ..simulator import TimeModel
    from .auto import search

    times = times or TimeModel.unit()
    limit = float(p) * m_b if m_limit is None else m_limit
    try:
        res = search(
            p,
            m,
            times,
            m_limit=limit,
            m_b=m_b,
            m_w=m_w,
            placement=Placement.vshape(p),
            name="zb-v",
        )
        res.schedule.name = "zb-v"
        return res.schedule
    except RuntimeError:
        return zb_v_handcrafted(p, m)


def zb_v_handcrafted(p: int, m: int) -> Schedule:
    placement = Placement.vshape(p)
    stage_ops: List[List[Op]] = []
    for s in range(p):
        w0 = min(2 * p - 1 - s, m)
        w1 = min(s, m)
        ops: List[Op] = _warmup_interleave(p, s, w0, w1)
        nf = [w0, w1]  # next F index per chunk
        nb = [0, 0]
        nw = [0, 0]

        def emit_group(c: int) -> None:
            if nf[c] < m:
                ops.append(Op(OpKind.F, nf[c], c))
                nf[c] += 1
            if nb[c] < m:
                ops.append(Op(OpKind.B, nb[c], c))
                nb[c] += 1
            if nw[c] < m:
                ops.append(Op(OpKind.W, nw[c], c))
                nw[c] += 1

        # steady-state init: p-1-s groups of the second chunk
        for _ in range(p - 1 - s):
            if nb[1] >= m:
                break
            emit_group(1)
        # alternate chunk-1 / chunk-0 groups while any forward remains
        turn = 1
        while nf[0] < m or nf[1] < m:
            c = turn if nf[turn] < m or nb[turn] < m else 1 - turn
            emit_group(c)
            turn = 1 - turn
        # drain: B prioritized over W, chunk order by stream progress
        while nb[0] < m or nb[1] < m:
            # pick the chunk whose pending B is "oldest" (smallest index);
            # chunk 1's B becomes available before chunk 0's at every worker.
            if nb[1] < m and (nb[0] >= m or nb[1] <= nb[0]):
                c = 1
            else:
                c = 0
            ops.append(Op(OpKind.B, nb[c], c))
            nb[c] += 1
            if nw[c] < m:
                ops.append(Op(OpKind.W, nw[c], c))
                nw[c] += 1
        for c in (1, 0):
            while nw[c] < m:
                ops.append(Op(OpKind.W, nw[c], c))
                nw[c] += 1
        stage_ops.append(ops)
    return Schedule(p, m, stage_ops, placement=placement, name="zb-v")
