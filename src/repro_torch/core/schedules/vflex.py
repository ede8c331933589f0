"""Controllable-memory V schedules: V-Min / V-Half (arXiv 2405.15362).

Copied from ``src/repro/core/schedules/vflex.py`` (portfolio order and
float cost keys unchanged, so the op lists are the JAX package's);
``v_flex``'s memo is in-process only, with no on-disk layer.

The follow-up to the zero-bubble paper shows the activation-memory /
throughput trade-off of pipeline schedules is a continuum governed by the
*lifespan* of each microbatch's activations: on the two-chunk V placement
(chunk 0 runs stages 0..p-1, chunk 1 runs p-1..0, like ZB-V) the steady state
is a repeating 6-slot pattern per microbatch -- F, f, b, B plus two W slots --
and shrinking the F->B lifespans shrinks the per-stage activation peak:

  * V-Min  : ~p/3 of 1F1B's activation memory (minimal: the pattern's
             lifespans are as short as the dependency chain allows),
  * V-Half : ~p/2, with near-zero bubbles.

Two constructions are provided:

1. :func:`stable_v_schedule` -- the paper's construction verbatim: per-stage
   *stable pattern* offsets repeated with period 6, W passes greedily placed
   into the free slots (the ``put_w`` idea of the reference implementation).
   This realizes the steady state exactly but ramps in/out at the pattern
   rate, so its bubble is larger than necessary.

2. :func:`v_flex` -- an event-driven greedy on the V placement with the
   pattern's memory bound enforced as an *activation cap* (in-flight F-minus-B
   chunk passes per stage) plus two structural rules learned from the
   pattern:

     * dual admission gate for chunk-0 forwards: a warm-up count before the
       first B0 retires (clipped ZB-V counts, so deep stages never fill
       themselves and stall the returning chunk-1 wave), then a steady
       *lead* over the stage's own B0 retirements (the pattern's lifespan
       control);
     * B passes always first (they free activations and drive both waves),
       chunk-1 F before chunk-0 F (the returning wave carries the loss),
       W passes fill memory stalls and gaps, with a bounded drain-time bank.

   A small deterministic portfolio of gate shapes is simulated and the
   fastest schedule whose *activation* peak fits the limit is returned,
   followed by a cost-neutral W-compaction that pulls W passes earlier to
   shrink the B->W context backlog.

Peak accounting note: the limits bound the *activation* component (the
paper's M_B term, freed at B).  The B->W context (M_W, the ZB paper's kept
cotangents) is tracked separately; W-compaction keeps it small but it is
not part of the V-Min/V-Half contract.

``v_min``/``v_half`` meet, simulator-verified under T_F = T_B = T_W and
t_comm = 0 (``tests/test_memory.py`` holds the JAX package's copy to them):

  peak_act(v_min)  <= ceil(p * M_B / 3) + 2 * M_B
  peak_act(v_half) <= ceil(p * M_B / 2) + 2 * M_B
  bubble_rate(v_*) <= bubble_rate(zb_h1)        for p in {4, 6, 8}, m >= 2p.
"""

from __future__ import annotations

import functools
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .ir import Op, OpKind, Placement, Schedule

__all__ = [
    "v_min",
    "v_half",
    "v_flex",
    "v_min_limit",
    "v_half_limit",
    "stable_v_schedule",
    "stable_pattern",
    "activation_peak",
]

_INF = float("inf")
_CYCLE = 6  # slots per microbatch per stage in the steady pattern


# --------------------------------------------------------------------- #
# activation peak (the controllable quantity)
# --------------------------------------------------------------------- #
def activation_peak(schedule: Schedule, m_b: float = 1.0) -> float:
    """Peak of the M_B component per stage: F allocates, B frees.

    ``m_b`` is the *full-stage* activation; each chunk pass moves
    ``m_b / n_chunks``.  This is the quantity V-Min/V-Half bound; the B->W
    context is accounted separately.
    """
    mb_c = m_b / schedule.n_chunks
    peak = 0.0
    for ops in schedule.stage_ops:
        cur = 0.0
        for op in ops:
            if op.kind == OpKind.F:
                cur += mb_c
            elif op.kind == OpKind.B:
                cur -= mb_c
            peak = max(peak, cur)
    return peak


# --------------------------------------------------------------------- #
# 1. the paper's stable-pattern construction
# --------------------------------------------------------------------- #
def stable_pattern(p: int, kind: str) -> List[Tuple[int, int, int, int]]:
    """Per-stage steady-state offsets (F0, F1, B1, B0) within one cycle.

    The offsets are the reference implementation's ``stable_pattern_v_min`` /
    ``v_half`` tables: consecutive microbatches repeat them with period 6,
    and the ``interval`` term keeps the four compute slots of one stage on
    distinct residues mod 6 (otherwise two passes of different microbatches
    would collide in the same slot).
    """
    if kind == "v-min":
        iv = 2 if p % 3 == 0 else 0
        rows = [
            (i, 2 * p - 1 - i, 2 * p + iv + i, 4 * p + iv - 1 - i)
            for i in range(p)
        ]
    elif kind == "v-half":
        iv = 3 if p % 2 == 0 else 0
        rows = [
            (2 * i, 3 * p - i - 2, 3 * p + iv + 2 * i - 1, 6 * p + iv - i - 2)
            for i in range(p)
        ]
    else:
        raise ValueError(f"unknown stable pattern kind {kind!r}")
    for i, row in enumerate(rows):
        if len({t % _CYCLE for t in row}) != 4:
            raise ValueError(
                f"{kind} pattern collides mod {_CYCLE} at stage {i}: {row}"
            )
    return rows


def stable_v_schedule(p: int, m: int, kind: str = "v-min") -> Schedule:
    """Repeat the stable pattern for m microbatches; W fills free slots.

    W placement is the greedy ``put_w``: walk the integer slots in time
    order; every slot not taken by a compute pass pops the oldest pending
    (B done, W not) microbatch.
    """
    offsets = stable_pattern(p, kind)
    stage_ops: List[List[Op]] = []
    for s in range(p):
        t_f0, t_f1, t_b1, t_b0 = offsets[s]
        events: Dict[int, Op] = {}
        for j in range(m):
            base = _CYCLE * j
            for t, op in (
                (t_f0 + base, Op(OpKind.F, j, 0)),
                (t_f1 + base, Op(OpKind.F, j, 1)),
                (t_b1 + base, Op(OpKind.B, j, 1)),
                (t_b0 + base, Op(OpKind.B, j, 0)),
            ):
                events[t] = op
        pending: deque = deque()
        ops: List[Op] = []
        t = 0
        horizon = max(events) + 1
        while t < horizon or pending:
            op = events.get(t)
            if op is not None:
                ops.append(op)
                if op.kind == OpKind.B:
                    pending.append(op)
            elif pending:
                b = pending.popleft()
                ops.append(Op(OpKind.W, b.mb, b.chunk))
            t += 1
        stage_ops.append(ops)
    return Schedule(p, m, stage_ops, placement=Placement.vshape(p), name=kind)


# --------------------------------------------------------------------- #
# 2. memory-capped event-driven greedy on the V placement
# --------------------------------------------------------------------- #
def _v_greedy(
    p: int,
    m: int,
    act_cap: int,  # activation cap per stage, in chunk passes
    warm_lead: Sequence[int],  # per-stage warm-up count == steady F0 lead
    reserve: int = 1,  # chunk-pass headroom chunk-0 F must leave for the wave
    bank_w: bool = False,  # bank W passes for the drain's B0 arrival gaps
    bank_cap: int = 4,  # max banked (B done, W pending) chunk passes
    name: str = "v-flex",
) -> Schedule:
    pl = Placement.vshape(p)
    arr_f: Dict[Tuple[int, int, int], float] = {}
    arr_b: Dict[Tuple[int, int, int], float] = {}
    for j in range(m):
        arr_f[(0, 0, j)] = 0.0
    clock = [0.0] * p
    act = [0] * p  # in-flight chunk passes (F issued, B not done)
    nf = [[0, 0] for _ in range(p)]
    nb = [[0, 0] for _ in range(p)]
    nw = [[0, 0] for _ in range(p)]
    ops_out: List[List[Op]] = [[] for _ in range(p)]
    done = [0] * p
    total = 6 * m

    def commit(s: int, kind: OpKind, c: int, t: float) -> None:
        j = {OpKind.F: nf, OpKind.B: nb, OpKind.W: nw}[kind][s][c]
        te = t + 1.0
        ops_out[s].append(Op(kind, j, c))
        clock[s] = te
        done[s] += 1
        if kind == OpKind.F:
            nf[s][c] += 1
            act[s] += 1
            nxt = pl.fwd_next(c, pl.pos_of(c, s))
            if nxt is None:
                arr_b[(s, c, j)] = te  # loss: B seeds immediately
            else:
                arr_f[(pl.stage_of(*nxt), nxt[0], j)] = te
        elif kind == OpKind.B:
            nb[s][c] += 1
            act[s] -= 1
            prev = pl.fwd_prev(c, pl.pos_of(c, s))
            if prev is not None:
                arr_b[(pl.stage_of(*prev), prev[0], j)] = te
        else:
            nw[s][c] += 1

    def decide(s: int) -> Tuple[float, Optional[Tuple[OpKind, int]]]:
        t = clock[s]
        # returning chunk-1 wave first: it carries the loss round trip
        if nf[s][1] < m:
            a = arr_f.get((s, 1, nf[s][1]))
            if a is not None and a <= t and act[s] + 1 <= act_cap:
                return (t, (OpKind.F, 1))
        # B passes: free activations and drive both waves; earliest arrival
        bs = []
        for c in (1, 0):
            if nb[s][c] < nf[s][c]:
                a = arr_b.get((s, c, nb[s][c]))
                if a is not None:
                    bs.append((a, c))
        b_now = sorted((a, -c) for a, c in bs if a <= t)
        if b_now:
            return (t, (OpKind.B, -b_now[0][1]))
        # chunk-0 F: memory headroom + dual admission gate
        f_cands = []
        for c in (1, 0):
            if nf[s][c] < m:
                a = arr_f.get((s, c, nf[s][c]))
                if a is not None:
                    f_cands.append((a, c))
        for a, c in f_cands:
            if a > t:
                continue
            need = 1 + (reserve if c == 0 else 0)
            if act[s] + need > act_cap:
                continue
            if c == 0:
                lead = warm_lead[s]
                wcount = max(1, min(lead, 2 * p - 1 - s))
                if not (
                    nf[s][0] < lead + nb[s][0]
                    or (nb[s][0] == 0 and nf[s][0] < wcount)
                ):
                    continue
            return (t, (OpKind.F, c))
        # W: fill memory stalls and gaps
        w_c = None
        for c in (1, 0):
            if nw[s][c] < nb[s][c]:
                w_c = c
                break
        waits = [a for a, _ in bs if a > t] + [a for a, c in f_cands if a > t]
        backlog = (nb[s][0] - nw[s][0]) + (nb[s][1] - nw[s][1])
        in_drain = nf[s][0] >= m and nf[s][1] >= m
        if (
            bank_w
            and in_drain
            and (nb[s][0] < m or nb[s][1] < m)
            and backlog < bank_cap
        ):
            # bank W passes for the final B0 arrival gaps ("shift W right")
            if waits:
                return (min(waits), None)
            if w_c is not None and backlog > 2 * m - nb[s][0] - nb[s][1]:
                return (t, (OpKind.W, w_c))
            return (t + 1.0, None)
        # neither B nor F can issue right now: a pending W always fills the
        # slot (memory stall or gap alike) unless the drain bank held it back
        if w_c is not None:
            return (t, (OpKind.W, w_c))
        if waits:
            return (min(waits), None)
        return (_INF, None)

    remaining = p * total
    guard = 0
    while remaining:
        guard += 1
        if guard > 100 * p * m + 10000:
            raise RuntimeError("v_flex greedy failed to converge")
        best_s, best_t, best_a = -1, _INF, None
        for s in range(p):
            if done[s] >= total:
                continue
            t, a = decide(s)
            if t < best_t or (t == best_t and a is not None and best_a is None):
                best_s, best_t, best_a = s, t, a
        if best_a is None:
            if best_t == _INF:
                stuck = {s: (nf[s], nb[s], nw[s]) for s in range(p)}
                raise RuntimeError(f"v_flex greedy deadlocked: {stuck}")
            clock[best_s] = best_t
            continue
        commit(best_s, best_a[0], best_a[1], max(best_t, clock[best_s]))
        remaining -= 1

    return Schedule(p, m, ops_out, placement=pl, name=name)


# --------------------------------------------------------------------- #
# W compaction: pull W passes earlier at equal simulated cost
# --------------------------------------------------------------------- #
def _wctx_backlog_peak(schedule: Schedule) -> int:
    worst = 0
    for ops in schedule.stage_ops:
        cur = 0
        for op in ops:
            if op.kind == OpKind.B:
                cur += 1
            elif op.kind == OpKind.W:
                cur -= 1
            worst = max(worst, cur)
    return worst


def _compact_w(
    schedule: Schedule,
    times,
    max_moves: int = 200,
    sim_budget: Optional[int] = None,
) -> Schedule:
    """Move W passes earlier while the simulated cost does not increase.

    Purely reduces the B->W context backlog (the W-context bytes a banked
    drain accumulates); activation peaks are untouched by W moves.

    Every attempted swap re-simulates the whole schedule, so the search is
    bounded: ``sim_budget`` caps the number of simulations (scaled down as
    schedules grow), and very large schedules skip compaction entirely --
    it is a cost-neutral backlog nicety, not worth minutes of build time
    at runtime-replanning scale (the first build must be interactive).
    """
    from ..simulator import simulate

    total_ops = sum(len(ops) for ops in schedule.stage_ops)
    if total_ops > 3000:
        return schedule
    if sim_budget is None:
        sim_budget = max(300, 120000 // max(1, total_ops))
    sims = 0

    best = schedule
    best_cost = simulate(best, times).cost
    moves = 0
    improved = True
    while improved and moves < max_moves:
        improved = False
        for s in range(best.p):
            ops = best.stage_ops[s]
            for i in range(1, len(ops)):
                if ops[i].kind != OpKind.W or ops[i - 1].kind == OpKind.W:
                    continue
                if sims >= sim_budget:
                    return best
                new_ops = [list(o) for o in best.stage_ops]
                new_ops[s][i - 1], new_ops[s][i] = new_ops[s][i], new_ops[s][i - 1]
                try:
                    cand = Schedule(
                        best.p, best.m, new_ops,
                        placement=best.placement, name=best.name,
                    )
                    sims += 1
                    cost = simulate(cand, times).cost
                except (ValueError, RuntimeError):
                    continue
                if cost <= best_cost + 1e-9 and (
                    _wctx_backlog_peak(cand) < _wctx_backlog_peak(best)
                    or cost < best_cost - 1e-9
                ):
                    best, best_cost = cand, min(best_cost, cost)
                    improved = True
                    moves += 1
                    break
            if improved:
                break
    return best


# --------------------------------------------------------------------- #
# public constructors
# --------------------------------------------------------------------- #
def v_flex(
    p: int,
    m: int,
    act_limit: float,
    times=None,
    name: str = "v-flex",
    compact: bool = True,
) -> Schedule:
    """Fastest V-placement schedule with peak activation <= act_limit (M_B).

    Simulates a deterministic portfolio: the stable-pattern construction
    plus greedy variants over {tapered, flat} warm-up/lead shapes,
    chunk-0 reserve {1, 2} and drain W-banking {on, off}; returns the
    feasible schedule with the lowest simulated cost (ties: smallest
    W-context backlog).

    Portfolio construction + simulation is memoized per
    ``(p, m, act_limit, times, compact)`` in an in-process LRU (searches
    and test grids rebuild the same few schedules dozens of times); each
    call returns a fresh :class:`Schedule` built from the cached op lists,
    so callers may mutate ``name`` freely.
    """
    from ..simulator import TimeModel

    times = times or TimeModel.unit()
    ops, placement = _v_flex_build(p, m, float(act_limit), times, bool(compact))
    sched = Schedule(p, m, [list(o) for o in ops], placement=placement, name=name)
    return sched


@functools.lru_cache(maxsize=256)
def _v_flex_build(
    p: int, m: int, act_limit: float, times, compact: bool
) -> Tuple[Tuple[Tuple[Op, ...], ...], Placement]:
    """Memoized portfolio search; returns immutable (stage_ops, placement)."""
    best = _v_flex_portfolio(p, m, act_limit, times, compact)
    return (
        tuple(tuple(ops) for ops in best.stage_ops),
        best.placement,
    )


def _v_flex_portfolio(
    p: int, m: int, act_limit: float, times, compact: bool
) -> Schedule:
    """Build + simulate the deterministic portfolio; returns the winner."""
    from ..simulator import simulate
    cap = int(2 * act_limit)  # chunk passes (2 per full-stage M_B)
    if cap < 2:
        raise ValueError(f"act_limit {act_limit} < 1 M_B cannot run a V chunk pair")

    candidates: List[Schedule] = []
    for kind in ("v-min", "v-half"):
        try:
            candidates.append(stable_v_schedule(p, m, kind))
        except ValueError:
            pass
    for taper in (True, False):
        for reserve in (1, 2):
            for bank in (True, False):
                vec = [
                    max(2, min(cap - reserve, 2 * p - 1 - 2 * s)) if taper
                    else cap - reserve
                    for s in range(p)
                ]
                try:
                    candidates.append(
                        _v_greedy(p, m, cap, vec, reserve=reserve, bank_w=bank)
                    )
                except RuntimeError:
                    continue

    best = None
    best_key = None
    for sched in candidates:
        if activation_peak(sched) > act_limit + 1e-9:
            continue
        try:
            cost = simulate(sched, times).cost
        except (ValueError, RuntimeError):
            continue
        key = (cost, _wctx_backlog_peak(sched))
        if best is None or key < best_key:
            best, best_key = sched, key
    if best is None:
        raise RuntimeError(
            f"no feasible V schedule (p={p}, m={m}, act_limit={act_limit})"
        )
    if compact:
        best = _compact_w(best, times)
    return best


def v_min_limit(p: int, m_b: float = 1.0) -> float:
    """V-Min activation budget: ceil(p*M_B/3) + 2*M_B."""
    return math.ceil(p * m_b / 3.0) + 2.0 * m_b


def v_half_limit(p: int, m_b: float = 1.0) -> float:
    """V-Half activation budget: ceil(p*M_B/2) + 2*M_B."""
    return math.ceil(p * m_b / 2.0) + 2.0 * m_b


def v_min(p: int, m: int, times=None) -> Schedule:
    """V-Min: ~1/3 of 1F1B activation memory (paper Sec. 4)."""
    return v_flex(p, m, v_min_limit(p), times, name="v-min")


def v_half(p: int, m: int, times=None) -> Schedule:
    """V-Half: ~1/2 of 1F1B activation memory, near-zero bubble."""
    return v_flex(p, m, v_half_limit(p), times, name="v-half")
