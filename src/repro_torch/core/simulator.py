"""Discrete-event simulator for pipeline schedules.

Host-only numpy, copied from ``src/repro/core/simulator.py`` so that the
port's costs equal the JAX package's (``tests/test_torch_schedules.py``).

Continuous-time counterpart of :meth:`Schedule.to_ticks`: ops run in each
stage's program order; an op starts when the stage is free AND all cross-op
dependencies have completed (+ ``t_comm`` when the producer is a different
stage).  ``cost`` is the global makespan, and the paper's bubble rate
(Sec. 5.3) is ``(cost - m * (T_F + T_B + T_W)) / cost``.

Supports per-stage/per-chunk durations (straggler studies, embed/head
compensation) and the ``grouped_w`` convention used to model the 1F1B /
1F1B-interleaved baselines where B and W are a single fused backward (the
activation-gradient send happens only after the fused op finishes).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .schedules.ir import Op, OpKind, Schedule

__all__ = ["TimeModel", "SimResult", "simulate", "bubble_rate"]


@dataclasses.dataclass(frozen=True)
class TimeModel:
    """Durations for one *full-stage* F/B/W pass plus the p2p latency.

    For multi-chunk schedules each chunk pass costs ``1/n_chunks`` of the
    full-stage value (chunks evenly split the per-stage layer group).
    ``stage_scale`` optionally multiplies every duration of a stage
    (straggler modelling).  ``grouped_w`` folds W into B (classic 1F1B).
    """

    t_f: float = 1.0
    t_b: float = 1.0
    t_w: float = 1.0
    t_comm: float = 0.0
    grouped_w: bool = False
    stage_scale: Optional[Tuple[float, ...]] = None

    def duration(self, stage: int, op: Op, n_chunks: int) -> float:
        if self.grouped_w:
            base = {
                OpKind.F: self.t_f,
                OpKind.B: self.t_b + self.t_w,
                OpKind.W: 0.0,
            }[op.kind]
        else:
            base = {OpKind.F: self.t_f, OpKind.B: self.t_b, OpKind.W: self.t_w}[
                op.kind
            ]
        base /= n_chunks
        if self.stage_scale is not None:
            base *= self.stage_scale[stage]
        return base

    @staticmethod
    def unit() -> "TimeModel":
        return TimeModel(1.0, 1.0, 1.0, 0.0)


@dataclasses.dataclass
class SimResult:
    cost: float  # max per-stage execution span (paper Sec. 5.3)
    makespan: float  # global wall-clock end
    stage_busy: np.ndarray  # (p,) total busy time
    stage_span: np.ndarray  # (p,) last_end - first_start
    start: Dict[Tuple[int, Op], float]
    end: Dict[Tuple[int, Op], float]
    m: int
    ideal: float  # m * (T_F + T_B + T_W), the bubble-free cost

    @property
    def bubble_rate(self) -> float:
        return (self.cost - self.ideal) / self.cost

    @property
    def bubble_size(self) -> float:
        return self.cost - self.ideal


def simulate(schedule: Schedule, times: TimeModel) -> SimResult:
    p, C = schedule.p, schedule.n_chunks
    start: Dict[Tuple[int, Op], float] = {}
    end: Dict[Tuple[int, Op], float] = {}
    ptr = [0] * p
    clock = [0.0] * p
    busy = np.zeros(p)
    first = np.full(p, np.inf)
    total = sum(len(ops) for ops in schedule.stage_ops)
    done = 0
    while done < total:
        progress = False
        for s in range(p):
            while ptr[s] < len(schedule.stage_ops[s]):
                op = schedule.stage_ops[s][ptr[s]]
                deps = schedule.dependencies(s, op)
                ready = 0.0
                ok = True
                for ds, dop in deps:
                    key = (ds, dop)
                    if key not in end:
                        ok = False
                        break
                    lat = times.t_comm if ds != s else 0.0
                    ready = max(ready, end[key] + lat)
                if not ok:
                    break
                t0 = max(clock[s], ready)
                dur = times.duration(s, op, C)
                start[(s, op)] = t0
                end[(s, op)] = t0 + dur
                clock[s] = t0 + dur
                busy[s] += dur
                first[s] = min(first[s], t0)
                ptr[s] += 1
                done += 1
                progress = True
        if not progress:
            stuck = {
                s: schedule.stage_ops[s][ptr[s]]
                for s in range(p)
                if ptr[s] < len(schedule.stage_ops[s])
            }
            raise ValueError(f"simulation deadlock; next-ops: {stuck}")
    makespan = max(end.values())
    spans = np.array(
        [
            max(
                (end[(s, op)] for op in schedule.stage_ops[s]),
                default=0.0,
            )
            - (first[s] if np.isfinite(first[s]) else 0.0)
            for s in range(p)
        ]
    )
    ideal = schedule.m * (times.t_f + times.t_b + times.t_w)
    return SimResult(
        cost=float(spans.max()),
        makespan=makespan,
        stage_busy=busy,
        stage_span=spans,
        start=start,
        end=end,
        m=schedule.m,
        ideal=ideal,
    )


def bubble_rate(schedule: Schedule, times: TimeModel) -> float:
    return simulate(schedule, times).bubble_rate
