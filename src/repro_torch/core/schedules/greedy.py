"""Event-driven greedy schedule construction (paper Sec. 3.1 + Sec. 6).

Copied from ``src/repro/core/schedules/greedy.py`` with its tie-breaking
keys unchanged, so the op lists are the JAX package's.

One engine serves both the linear-placement automatic scheduler (ZB-1p /
ZB-2p style, given a memory limit and profiled T_F/T_B/T_W/T_comm) and the
V-placement ZB-V scheduler.  The engine simulates the pipeline in continuous
time; whenever a stage becomes free it applies the paper's decision rules:

  * warm-up: run as many F as the memory limit allows before the first B;
    a binary hyperparameter (``warmup_extra_f``) controls whether to add an
    F that may delay the incoming first B;
  * steady state: alternate one F and one B; insert W into any gap larger
    than T_W; a hyperparameter (``fill_small_gaps``) also fills sub-T_W gaps;
    insert W when the memory limit blocks the next F;
  * drain: B prioritized, W fills the tail.

The constructed op *ordering* is returned as a Schedule; exact timing is then
re-derived by the simulator/executor.  A grid search over the binary
hyperparameters (paper Sec. 3.1 last bullet) is provided by
:func:`auto.search`.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from .ir import Op, OpKind, Placement, Schedule

if TYPE_CHECKING:  # a runtime import would be circular
    from ..simulator import TimeModel

__all__ = ["GreedyConfig", "greedy_schedule"]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class GreedyConfig:
    m_limit: float  # activation memory limit, units of full-stage M_B
    m_b: float = 1.0  # full-stage M_B
    m_w: float = 0.5  # full-stage M_W
    warmup_extra_f: bool = True  # paper hyperparam 1
    fill_small_gaps: bool = True  # paper hyperparam 2
    prefer_f_on_tie: bool = False  # tie-break when both F and B runnable
    eager_w: bool = False  # run W instead of idling even outside gaps rule
    drain_strict_w: bool = False  # in the drain, only insert W into >=T_W gaps
    #   ("shift W right", paper Sec. 6 -- a sub-T_W W delays the whole B wave)


def greedy_schedule(
    p: int,
    m: int,
    times: "TimeModel",
    cfg: GreedyConfig,
    placement: Optional[Placement] = None,
    name: str = "greedy",
) -> Schedule:
    pl = placement or Placement.linear(p)
    C = pl.n_chunks
    mb_c = cfg.m_b / C  # per-chunk-pass memory
    mw_c = cfg.m_w / C

    dur = {
        OpKind.F: times.t_f / C,
        OpKind.B: times.t_b / C,
        OpKind.W: times.t_w / C,
    }
    tc = times.t_comm

    # availability times of inputs
    arr_f: Dict[Tuple[int, int, int], float] = {}  # (stage, chunk, mb) -> t
    arr_b: Dict[Tuple[int, int, int], float] = {}
    for j in range(m):
        arr_f[(pl.stage_of(0, 0), 0, j)] = 0.0

    clock = [0.0] * p
    mem = [0.0] * p
    nf = [[0] * C for _ in range(p)]  # next F index per (stage, chunk)
    nb = [[0] * C for _ in range(p)]
    nw = [[0] * C for _ in range(p)]
    seen_b = [False] * p  # has this stage run any B yet (warm-up tracking)
    last_kind = [OpKind.B] * p  # alternation state; start wanting F
    ops_out: List[List[Op]] = [[] for _ in range(p)]
    done = [0] * p
    total_per_stage = 3 * m * C

    def scale(s: int) -> float:
        return times.stage_scale[s] if times.stage_scale is not None else 1.0

    def commit(s: int, kind: OpKind, c: int, t_start: float) -> None:
        j = {OpKind.F: nf, OpKind.B: nb, OpKind.W: nw}[kind][s][c]
        t_end = t_start + dur[kind] * scale(s)
        ops_out[s].append(Op(kind, j, c))
        clock[s] = t_end
        done[s] += 1
        if kind == OpKind.F:
            nf[s][c] += 1
            mem[s] += mb_c
            nxt = pl.fwd_next(c, pl.pos_of(c, s))
            if nxt is None:
                arr_b[(s, c, j)] = t_end  # loss: B can start immediately
            else:
                ns = pl.stage_of(*nxt)
                arr_f[(ns, nxt[0], j)] = t_end + (0.0 if ns == s else tc)
        elif kind == OpKind.B:
            nb[s][c] += 1
            mem[s] += mw_c - mb_c
            seen_b[s] = True
            prev = pl.fwd_prev(c, pl.pos_of(c, s))
            if prev is not None:
                ps = pl.stage_of(*prev)
                arr_b[(ps, prev[0], j)] = t_end + (0.0 if ps == s else tc)
        else:
            nw[s][c] += 1
            mem[s] -= mw_c
        if kind != OpKind.W:
            last_kind[s] = kind

    def hops_to_loss(s: int, c: int) -> int:
        """F-chain distance from (chunk c at stage s) to the loss pass."""
        k = pl.pos_of(c, s)
        return (pl.p - 1 - k) + (C - 1 - c) * pl.p

    # Warm-up F cap per (stage, chunk): running more forwards of a shallow
    # chunk than its loss distance would push back the deeper chunk's F wave
    # (and with it the first B) by T_F per extra pass.  For the V placement
    # this reproduces the paper's 2p-1-s / s warm-up split exactly.
    extra = 1 if cfg.warmup_extra_f else 0
    warm_cap = [
        [hops_to_loss(s, c) + extra for c in range(C)] for s in range(p)
    ]

    def f_fits(s: int, c: int) -> bool:
        """Memory check with reservation: chunk c may not squeeze out deeper
        chunks' forwards -- one slot stays reserved per deeper chunk, else the
        loss-producing F (and with it the whole B chain) can deadlock."""
        reserve = (C - 1 - c) * mb_c
        return mem[s] + mb_c <= cfg.m_limit - reserve + 1e-9

    def f_candidates(s: int) -> List[Tuple[float, int]]:
        out = []
        for c in range(C):
            if nf[s][c] < m:
                t = arr_f.get((s, c, nf[s][c]))
                if t is not None:
                    out.append((t, c))
        return out

    def b_candidates(s: int) -> List[Tuple[float, int]]:
        out = []
        for c in range(C):
            if nb[s][c] < m and nb[s][c] < nf[s][c]:
                t = arr_b.get((s, c, nb[s][c]))
                if t is not None:
                    out.append((t, c))
        return out

    def w_candidate(s: int) -> Optional[int]:
        for c in reversed(range(C)):
            if nw[s][c] < nb[s][c]:
                return c
        return None

    def decide(s: int) -> Tuple[float, Optional[Tuple[OpKind, int]]]:
        """Return (time, action); action None means 're-decide at time'."""
        t = clock[s]
        fs = f_candidates(s)
        bs = b_candidates(s)
        wc = w_candidate(s)
        # runnable F passes: arrived and fitting memory; deepest chunk first.
        # Before the first B, shallow chunks respect their warm-up cap so the
        # deeper chunk's wave (which carries the loss) is never displaced.
        f_run = [
            c
            for (a, c) in fs
            if a <= t
            and f_fits(s, c)
            and (seen_b[s] or c == C - 1 or nf[s][c] < warm_cap[s][c])
        ]
        f_pick = max(f_run) if f_run else None
        f_blocked = any(a <= t and not f_fits(s, c) for (a, c) in fs)
        f_waits = [a for (a, c) in fs if a > t]
        # runnable B passes: earliest arrival, deeper chunk on ties
        b_run = sorted(((a, -c) for (a, c) in bs if a <= t))
        b_pick = -b_run[0][1] if b_run else None
        b_waits = [a for (a, c) in bs if a > t]
        w_now = wc is not None

        if not seen_b[s]:
            # warm-up: pack F passes under the memory limit (paper rule 1)
            if f_pick is not None and b_pick is None:
                first_b = min(b_waits) if b_waits else None
                delay_first_b = (
                    first_b is not None
                    and t + dur[OpKind.F] * scale(s) > first_b
                )
                if not delay_first_b or cfg.warmup_extra_f:
                    return (t, (OpKind.F, f_pick))
            if b_pick is not None:
                return (t, (OpKind.B, b_pick))
            waits = f_waits + b_waits
            if w_now and cfg.eager_w:
                return (t, (OpKind.W, wc))
            if waits:
                return (min(waits), None)
            if w_now:
                return (t, (OpKind.W, wc))
            return (_INF, None)

        # steady state: one F, one B iteratively
        want = OpKind.F if last_kind[s] == OpKind.B else OpKind.B
        if want == OpKind.F and f_pick is not None:
            return (t, (OpKind.F, f_pick))
        if want == OpKind.B and b_pick is not None:
            return (t, (OpKind.B, b_pick))
        # desired kind not runnable: fall back to the other
        if b_pick is not None and f_pick is not None:
            k = (OpKind.F, f_pick) if cfg.prefer_f_on_tie else (OpKind.B, b_pick)
            return (t, k)
        if b_pick is not None:
            return (t, (OpKind.B, b_pick))
        if f_pick is not None:
            return (t, (OpKind.F, f_pick))
        # memory-blocked F with nothing else: recycle memory with W
        if f_blocked and w_now:
            return (t, (OpKind.W, wc))
        # gap: decide W vs wait (paper rule 2)
        waits = f_waits + b_waits
        if not waits:
            if w_now:
                return (t, (OpKind.W, wc))
            return (_INF, None)  # wait for an unseen arrival
        gap = min(waits) - t
        # During the drain (no forwards left on this stage) a W that overruns
        # the gap delays the B wave for every downstream stage; with
        # drain_strict_w, insert W only when it fits ("shift W right", Sec. 6).
        drain = cfg.drain_strict_w and all(nf[s][c] >= m for c in range(C))
        if w_now and (
            gap >= dur[OpKind.W] * scale(s) - 1e-9
            or (not drain and (cfg.fill_small_gaps or cfg.eager_w))
        ):
            return (t, (OpKind.W, wc))
        return (min(waits), None)

    # global event loop
    remaining = sum(total_per_stage - d for d in done)
    guard = 0
    while remaining > 0:
        guard += 1
        if guard > 40 * p * m * C + 10000:
            raise RuntimeError("greedy scheduler failed to converge")
        best_s, best_t, best_a = -1, _INF, None
        for s in range(p):
            if done[s] >= total_per_stage:
                continue
            t, a = decide(s)
            ts = max(t, clock[s]) if a is not None else t
            if ts < best_t or (ts == best_t and a is not None and best_a is None):
                best_s, best_t, best_a = s, ts, a
        if best_a is None:
            if best_t is _INF or best_s < 0:
                state = {
                    s: dict(
                        done=done[s],
                        mem=round(mem[s], 2),
                        nf=list(nf[s]),
                        nb=list(nb[s]),
                        nw=list(nw[s]),
                        clock=round(clock[s], 2),
                        decide=decide(s),
                        cand=(f_candidates(s), b_candidates(s), w_candidate(s)),
                    )
                    for s in range(p)
                    if done[s] < total_per_stage
                }
                raise RuntimeError(f"greedy scheduler deadlocked: {state}")
            clock[best_s] = max(clock[best_s], best_t)
            continue
        kind, c = best_a
        commit(best_s, kind, c, max(best_t, clock[best_s]))
        remaining -= 1

    return Schedule(p, m, ops_out, placement=pl, name=name)
