"""Schedule IR of the port: the F/B/W op lists, their dependency rules and
the compilation of a schedule into static per-(stage, tick) tables.

Host-only Python, translated from ``src/repro/core/schedules/ir.py``: the
same :class:`Op`/:class:`Schedule` rules, the same greedy unit-time tick
assignment and the same interval-graph slot allocation, so the tables are
equal array for array (``tests/test_torch_train_plan.py``).  A schedule is,
for each stage, an ordered list of passes:

  * ``F`` -- forward of one microbatch through this stage's layer group,
  * ``B`` -- backward w.r.t. the input (carries the inter-stage chain),
  * ``W`` -- backward w.r.t. the parameters (free to run any time after the
    matching ``B`` on the same stage).

:class:`ExecutionPlan` is what ``core/executor.py`` walks tick by tick.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "OpKind",
    "Op",
    "Placement",
    "Schedule",
    "ExecutionPlan",
    "MemoryProfile",
    "compile_plan",
    "CHANNEL_FWD_UP",
    "CHANNEL_FWD_DOWN",
    "CHANNEL_BWD_DOWN",
    "CHANNEL_BWD_UP",
    "N_CHANNELS",
]


class OpKind(enum.IntEnum):
    IDLE = 0
    F = 1
    B = 2
    W = 3


@dataclasses.dataclass(frozen=True, order=True)
class Op:
    """One pass in the pipeline: (kind, microbatch, chunk)."""

    kind: OpKind
    mb: int
    chunk: int = 0

    def __repr__(self) -> str:  # compact: F3.0 == forward mb 3 chunk 0
        return f"{self.kind.name}{self.mb}.{self.chunk}"


# Communication channels used by the tick executor. Each is a cyclic
# collective-permute over the pipe axis in the given direction carrying either
# activations (F) or activation gradients (B).
CHANNEL_FWD_UP = 0  # F output, stage s -> s+1
CHANNEL_FWD_DOWN = 1  # F output, stage s -> s-1   (ZB-V second chunk)
CHANNEL_BWD_DOWN = 2  # B output, stage s -> s-1
CHANNEL_BWD_UP = 3  # B output, stage s -> s+1   (ZB-V second chunk)
N_CHANNELS = 4


@dataclasses.dataclass(frozen=True)
class Placement:
    """Maps (chunk, position) -> stage.

    ``stage_seq[c][k]`` is the stage executing forward position ``k`` of chunk
    ``c``.  Every chunk visits every stage exactly once.  Examples for p=4:

      * single chunk:            ``[[0, 1, 2, 3]]``
      * interleaved, 2 chunks:   ``[[0, 1, 2, 3], [0, 1, 2, 3]]``
      * ZB-V:                    ``[[0, 1, 2, 3], [3, 2, 1, 0]]``
    """

    stage_seq: Tuple[Tuple[int, ...], ...]

    @property
    def p(self) -> int:
        return len(self.stage_seq[0])

    @property
    def n_chunks(self) -> int:
        return len(self.stage_seq)

    def __post_init__(self):
        p = self.p
        for c, seq in enumerate(self.stage_seq):
            if sorted(seq) != list(range(p)):
                raise ValueError(
                    f"chunk {c} placement {seq} must be a permutation of 0..{p-1}"
                )

    @staticmethod
    def linear(p: int, n_chunks: int = 1) -> "Placement":
        return Placement(tuple(tuple(range(p)) for _ in range(n_chunks)))

    @staticmethod
    def vshape(p: int) -> "Placement":
        return Placement((tuple(range(p)), tuple(reversed(range(p)))))

    def stage_of(self, chunk: int, pos: int) -> int:
        return self.stage_seq[chunk][pos]

    def pos_of(self, chunk: int, stage: int) -> int:
        return self.stage_seq[chunk].index(stage)

    def fwd_prev(self, chunk: int, pos: int) -> Optional[Tuple[int, int]]:
        """(chunk, pos) producing the input activation, or None for the source."""
        if pos > 0:
            return (chunk, pos - 1)
        if chunk > 0:
            return (chunk - 1, self.p - 1)
        return None

    def fwd_next(self, chunk: int, pos: int) -> Optional[Tuple[int, int]]:
        if pos < self.p - 1:
            return (chunk, pos + 1)
        if chunk < self.n_chunks - 1:
            return (chunk + 1, 0)
        return None


@dataclasses.dataclass
class MemoryProfile:
    """Peak activation memory per stage in units of (M_B, M_W).

    Deltas per the paper's Appendix G: F:+M_B, B:+M_W-M_B, W:-M_W.
    """

    peak: np.ndarray  # (p,) floats, in units given by m_b/m_w
    m_b: float
    m_w: float

    @property
    def max_peak(self) -> float:
        return float(self.peak.max())


class Schedule:
    """An ordered per-stage program of F/B/W passes."""

    def __init__(
        self,
        p: int,
        m: int,
        stage_ops: Sequence[Sequence[Op]],
        placement: Optional[Placement] = None,
        name: str = "custom",
    ):
        self.p = p
        self.m = m
        self.placement = placement or Placement.linear(p)
        self.stage_ops: List[List[Op]] = [list(ops) for ops in stage_ops]
        self.name = name
        if len(self.stage_ops) != p:
            raise ValueError(f"need {p} stage programs, got {len(self.stage_ops)}")
        if self.placement.p != p:
            raise ValueError("placement p mismatch")
        self._validate_completeness()

    # ------------------------------------------------------------------ #
    # validation
    # ------------------------------------------------------------------ #
    @property
    def n_chunks(self) -> int:
        return self.placement.n_chunks

    def _validate_completeness(self) -> None:
        """Each stage runs each (kind, mb, chunk) exactly once, W after B."""
        for s, ops in enumerate(self.stage_ops):
            seen = set()
            for op in ops:
                if op in seen:
                    raise ValueError(f"stage {s}: duplicate op {op}")
                seen.add(op)
            expected = {
                Op(kind, j, c)
                for kind in (OpKind.F, OpKind.B, OpKind.W)
                for j in range(self.m)
                for c in range(self.n_chunks)
            }
            if seen != expected:
                missing = sorted(expected - seen)[:4]
                extra = sorted(seen - expected)[:4]
                raise ValueError(
                    f"stage {s}: op set mismatch (missing {missing}..., extra {extra}...)"
                )
            # W strictly after matching B; B strictly after matching F.
            idx = {op: i for i, op in enumerate(ops)}
            for j in range(self.m):
                for c in range(self.n_chunks):
                    if not (
                        idx[Op(OpKind.F, j, c)]
                        < idx[Op(OpKind.B, j, c)]
                        < idx[Op(OpKind.W, j, c)]
                    ):
                        raise ValueError(
                            f"stage {s}: F<B<W order violated for mb={j} chunk={c}"
                        )

    def dependencies(self, stage: int, op: Op) -> List[Tuple[int, Op]]:
        """Cross-op dependencies (producer stage, producer op) of ``op``.

        Same-stage program order is an additional implicit dependency.
        """
        pl = self.placement
        deps: List[Tuple[int, Op]] = []
        pos = pl.pos_of(op.chunk, stage)
        if op.kind == OpKind.F:
            prev = pl.fwd_prev(op.chunk, pos)
            if prev is not None:
                pc, pp = prev
                deps.append((pl.stage_of(pc, pp), Op(OpKind.F, op.mb, pc)))
        elif op.kind == OpKind.B:
            nxt = pl.fwd_next(op.chunk, pos)
            if nxt is None:
                # loss position: B starts from the loss, right after local F.
                deps.append((stage, Op(OpKind.F, op.mb, op.chunk)))
            else:
                nc, np_ = nxt
                deps.append((pl.stage_of(nc, np_), Op(OpKind.B, op.mb, nc)))
                # B also needs this stage's own residuals:
                deps.append((stage, Op(OpKind.F, op.mb, op.chunk)))
        elif op.kind == OpKind.W:
            deps.append((stage, Op(OpKind.B, op.mb, op.chunk)))
        return deps

    def validate(self) -> None:
        """Raise if the schedule deadlocks (unsatisfiable dependency order)."""
        self.to_ticks()  # raises on deadlock

    # ------------------------------------------------------------------ #
    # memory profile (paper Sec 2.3)
    # ------------------------------------------------------------------ #
    def memory_profile(self, m_b: float = 1.0, m_w: float = 0.5) -> MemoryProfile:
        delta = {OpKind.F: m_b, OpKind.B: m_w - m_b, OpKind.W: -m_w}
        peak = np.zeros(self.p)
        for s, ops in enumerate(self.stage_ops):
            cur = 0.0
            for op in ops:
                cur += delta[op.kind]
                peak[s] = max(peak[s], cur)
        return MemoryProfile(peak=peak, m_b=m_b, m_w=m_w)

    # ------------------------------------------------------------------ #
    # tick compilation
    # ------------------------------------------------------------------ #
    def to_ticks(self) -> Dict[Tuple[int, Op], int]:
        """Greedy list-scheduling under unit op durations.

        Each op occupies one tick on its stage; outputs cross stages at tick
        boundaries, so a dependent op runs no earlier than dep_tick + 1.
        Returns {(stage, op): tick}.  Raises ValueError on deadlock.
        """
        tick: Dict[Tuple[int, Op], int] = {}
        ptr = [0] * self.p  # next op index per stage
        clock = [0] * self.p  # next free tick per stage
        total = sum(len(ops) for ops in self.stage_ops)
        scheduled = 0
        while scheduled < total:
            progress = False
            for s in range(self.p):
                while ptr[s] < len(self.stage_ops[s]):
                    op = self.stage_ops[s][ptr[s]]
                    deps = self.dependencies(s, op)
                    ready = 0
                    ok = True
                    for ds, dop in deps:
                        key = (ds, dop)
                        if key not in tick:
                            ok = False
                            break
                        ready = max(ready, tick[key] + 1)
                    if not ok:
                        break
                    t = max(clock[s], ready)
                    tick[(s, op)] = t
                    clock[s] = t + 1
                    ptr[s] += 1
                    scheduled += 1
                    progress = True
            if not progress:
                stuck = {
                    s: self.stage_ops[s][ptr[s]]
                    for s in range(self.p)
                    if ptr[s] < len(self.stage_ops[s])
                }
                raise ValueError(f"schedule deadlock; next-ops: {stuck}")
        return tick

    def n_ticks(self) -> int:
        return max(self.to_ticks().values()) + 1

    # ------------------------------------------------------------------ #
    # pretty printing
    # ------------------------------------------------------------------ #
    def render(self, max_width: int = 240) -> str:
        ticks = self.to_ticks()
        T = max(ticks.values()) + 1
        grid = [["." for _ in range(T)] for _ in range(self.p)]
        for (s, op), t in ticks.items():
            ch = {OpKind.F: "F", OpKind.B: "B", OpKind.W: "W"}[op.kind]
            if self.n_chunks > 1 and op.chunk > 0:
                ch = ch.lower()
            grid[s][t] = ch
        lines = [f"# {self.name} p={self.p} m={self.m} T={T}"]
        for s in range(self.p):
            lines.append("".join(grid[s])[:max_width])
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (
            f"Schedule({self.name!r}, p={self.p}, m={self.m}, "
            f"chunks={self.n_chunks}, ops={sum(len(o) for o in self.stage_ops)})"
        )


# ---------------------------------------------------------------------- #
# slot allocation
# ---------------------------------------------------------------------- #
def _allocate_slots(
    intervals: Dict[Tuple, Tuple[int, int]],
) -> Tuple[Dict[Tuple, int], int]:
    """Greedy interval-graph slot assignment.

    intervals: key -> (alloc_tick, free_tick); the resource is live on
    [alloc_tick, free_tick] inclusive.  Returns (key -> slot, n_slots).
    """
    events = sorted(intervals.items(), key=lambda kv: (kv[1][0], kv[1][1]))
    free: List[int] = []
    n_slots = 0
    by_end: List[Tuple[int, int]] = []  # (free_tick, slot) of live entries
    out: Dict[Tuple, int] = {}
    for key, (start, end) in events:
        # release every slot freed strictly before this start
        still = []
        for ft, slot in by_end:
            if ft < start:
                free.append(slot)
            else:
                still.append((ft, slot))
        by_end = still
        if free:
            slot = min(free)
            free.remove(slot)
        else:
            slot = n_slots
            n_slots += 1
        out[key] = slot
        by_end.append((end, slot))
    return out, n_slots


@dataclasses.dataclass
class ExecutionPlan:
    """Static per-(stage, tick) tables driving the tick executor.

    All arrays are numpy; the port's executor reads them on the host.
    Semantics of one tick, for stage ``s`` at tick ``t``:

      1. compute ``op_kind[s, t]`` on chunk ``op_chunk`` / microbatch ``op_mb``
         reading input from inbox slot ``op_in_slot`` (or batch tokens when
         ``op_is_src``, or the loss seed when ``op_is_loss``), residuals from /
         to slot ``op_res_slot``;
      2. write the op output into channel ``send_channel[s, t]`` (or deposit
         locally into chunk ``local_chunk``/slot ``local_slot`` when
         ``send_local``);
      3. the four channels hand their messages to the neighbour stage;
      4. deposit arrivals: for each channel d with ``recv_valid[s, t, d]``,
         store into inbox of ``recv_chunk``/``recv_slot``.

    Receives indexed at tick t are arrivals of messages *sent* at tick t
    (available to ops at tick t+1).
    """

    p: int
    m: int
    n_chunks: int
    n_ticks: int
    placement: Placement
    name: str

    op_kind: np.ndarray  # (p, T) int32: OpKind
    op_chunk: np.ndarray  # (p, T)
    op_mb: np.ndarray  # (p, T)
    op_in_slot: np.ndarray  # (p, T) inbox slot consumed by F (act) / B (grad)
    op_res_slot: np.ndarray  # (p, T) residual slot (written by F, freed by B)
    op_wctx_slot: np.ndarray  # (p, T) weight-grad context slot (B -> W)
    op_res_slot_joint: np.ndarray  # (p, T) slot in the cross-chunk shared pool
    op_wctx_slot_joint: np.ndarray  # (p, T) slot in the cross-chunk shared pool
    op_is_src: np.ndarray  # (p, T) bool: F reads batch tokens / B or W at pos0 chunk0
    op_is_loss: np.ndarray  # (p, T) bool: F/B/W at the loss position
    op_is_last_b: np.ndarray  # (p, T) bool: B at pos0 of chunk0 (no dx send)
    op_sink_slot: np.ndarray  # (p, T) sink (head+loss) residual slot, [F..B]
    op_sink_wctx_slot: np.ndarray  # (p, T) sink W-context slot, [B..W]

    send_channel: np.ndarray  # (p, T) int32 in {-1, 0..3}
    send_local: np.ndarray  # (p, T) bool
    local_chunk: np.ndarray  # (p, T)
    local_slot: np.ndarray  # (p, T)
    local_is_grad: np.ndarray  # (p, T) bool

    recv_valid: np.ndarray  # (p, T, 4) bool
    recv_chunk: np.ndarray  # (p, T, 4)
    recv_slot: np.ndarray  # (p, T, 4)

    n_act_slots: Tuple[int, ...]  # per chunk
    n_grad_slots: Tuple[int, ...]
    n_res_slots: Tuple[int, ...]  # per chunk (heterogeneous-chunk fallback)
    n_wctx_slots: Tuple[int, ...]
    n_res_slots_joint: int  # cross-chunk shared pool (uniform chunks)
    n_wctx_slots_joint: int
    n_sink_slots: int
    n_sink_wctx_slots: int

    # per-tick live-slot counts, replayed from the interval analysis
    res_live: np.ndarray  # (C, p, T)
    wctx_live: np.ndarray  # (C, p, T)
    inbox_act_live: np.ndarray  # (C, p, T)
    inbox_grad_live: np.ndarray  # (C, p, T)
    sink_live: np.ndarray  # (p, T)
    sink_wctx_live: np.ndarray  # (p, T)

    @property
    def total_ops(self) -> int:
        return int((self.op_kind != int(OpKind.IDLE)).sum())

    @property
    def bubble_fraction(self) -> float:
        return 1.0 - self.total_ops / (self.p * self.n_ticks)

    def inbox_slot_total(self) -> int:
        """Inbox slots of one stage (act + grad families), as the JAX
        executor allocates them: flat (C, max-slots) buffers, so C * max(per
        chunk slots) per family.  The planner's inbox term and
        ``PipelineExecutor.buffer_bytes`` both read it."""
        return self.n_chunks * (max(self.n_act_slots) + max(self.n_grad_slots))


def compile_plan(schedule: Schedule) -> ExecutionPlan:
    """Compile a validated Schedule into an ExecutionPlan table grid."""
    pl = schedule.placement
    p, m, C = schedule.p, schedule.m, schedule.n_chunks
    ticks = schedule.to_ticks()
    T = max(ticks.values()) + 1

    def tick_of(stage: int, op: Op) -> int:
        return ticks[(stage, op)]

    shape = (p, T)
    op_kind = np.zeros(shape, np.int32)
    op_chunk = np.zeros(shape, np.int32)
    op_mb = np.zeros(shape, np.int32)
    op_in_slot = np.full(shape, -1, np.int32)
    op_res_slot = np.full(shape, -1, np.int32)
    op_wctx_slot = np.full(shape, -1, np.int32)
    op_res_slot_joint = np.full(shape, -1, np.int32)
    op_wctx_slot_joint = np.full(shape, -1, np.int32)
    op_sink_wctx_slot = np.zeros(shape, np.int32)
    op_is_src = np.zeros(shape, bool)
    op_is_loss = np.zeros(shape, bool)
    op_is_last_b = np.zeros(shape, bool)
    op_sink_slot = np.zeros(shape, np.int32)
    send_channel = np.full(shape, -1, np.int32)
    send_local = np.zeros(shape, bool)
    local_chunk = np.zeros(shape, np.int32)
    local_slot = np.zeros(shape, np.int32)
    local_is_grad = np.zeros(shape, bool)
    recv_valid = np.zeros((p, T, N_CHANNELS), bool)
    recv_chunk = np.zeros((p, T, N_CHANNELS), np.int32)
    recv_slot = np.zeros((p, T, N_CHANNELS), np.int32)

    # --- residual slots: per (stage, chunk), live [F tick, B tick] -- the
    # paper's accounting: B's true input-gradient VJP emits the compact M_W
    # context and the F->B residual is dead; wctx slots live [B tick, W tick]
    # and carry what W needs (wgrad matmul operands and folded cheap grads;
    # DESIGN.md Sec. 7).  Slot *counts* here are structure-agnostic interval
    # colorings.  Slots are also allocated *jointly* across chunks per
    # stage: a stage holding chunk-0 and chunk-1 residuals at different
    # times then does not pay for both peaks. ---- #
    res_slots: Dict[Tuple[int, int, int], int] = {}  # (stage, chunk, mb) -> slot
    wctx_slots: Dict[Tuple[int, int, int], int] = {}  # live [B tick, W tick]
    res_slots_joint: Dict[Tuple[int, int, int], int] = {}
    wctx_slots_joint: Dict[Tuple[int, int, int], int] = {}
    n_res_slots = [0] * C
    n_wctx_slots = [0] * C

    def _res_iv(s, c, j):
        return (
            tick_of(s, Op(OpKind.F, j, c)),
            tick_of(s, Op(OpKind.B, j, c)),
        )

    def _wctx_iv(s, c, j):
        return (
            tick_of(s, Op(OpKind.B, j, c)),
            tick_of(s, Op(OpKind.W, j, c)),
        )

    for c in range(C):
        worst_r = worst_w = 0
        for s in range(p):
            iv_r = {(s, c, j): _res_iv(s, c, j) for j in range(m)}
            iv_w = {(s, c, j): _wctx_iv(s, c, j) for j in range(m)}
            alloc_r, nr = _allocate_slots(iv_r)
            alloc_w, nw = _allocate_slots(iv_w)
            res_slots.update(alloc_r)
            wctx_slots.update(alloc_w)
            worst_r = max(worst_r, nr)
            worst_w = max(worst_w, nw)
        n_res_slots[c] = worst_r
        n_wctx_slots[c] = worst_w

    n_res_slots_joint = n_wctx_slots_joint = 0
    for s in range(p):
        iv_r = {(s, c, j): _res_iv(s, c, j) for c in range(C) for j in range(m)}
        iv_w = {(s, c, j): _wctx_iv(s, c, j) for c in range(C) for j in range(m)}
        alloc_r, nr = _allocate_slots(iv_r)
        alloc_w, nw = _allocate_slots(iv_w)
        res_slots_joint.update(alloc_r)
        wctx_slots_joint.update(alloc_w)
        n_res_slots_joint = max(n_res_slots_joint, nr)
        n_wctx_slots_joint = max(n_wctx_slots_joint, nw)

    # --- sink (head+loss) slots at the loss position of the last chunk:
    # residuals live [F tick, B tick], the sink W-context [B tick, W tick] -- #
    sink_slots: Dict[Tuple[int, int], int] = {}  # (stage, mb) -> slot
    sink_wctx_slots: Dict[Tuple[int, int], int] = {}
    c_last = C - 1
    loss_stage = pl.stage_of(c_last, p - 1)
    iv_sink = {
        (loss_stage, j): (
            tick_of(loss_stage, Op(OpKind.F, j, c_last)),
            tick_of(loss_stage, Op(OpKind.B, j, c_last)),
        )
        for j in range(m)
    }
    iv_sink_w = {
        (loss_stage, j): (
            tick_of(loss_stage, Op(OpKind.B, j, c_last)),
            tick_of(loss_stage, Op(OpKind.W, j, c_last)),
        )
        for j in range(m)
    }
    alloc_s, n_sink = _allocate_slots(iv_sink)
    sink_slots.update(alloc_s)
    n_sink_slots = max(1, n_sink)
    alloc_sw, n_sink_w = _allocate_slots(iv_sink_w)
    sink_wctx_slots.update(alloc_sw)
    n_sink_wctx_slots = max(1, n_sink_w)

    # --- inbox slots ------------------------------------------------------ #
    # activation inbox entry for F(c, pos k>0 or chunk>0): live from the tick
    # the producer runs (send happens end of that tick) until consumed.
    act_slots: Dict[Tuple[int, int, int], int] = {}
    grad_slots: Dict[Tuple[int, int, int], int] = {}
    n_act_slots = [0] * C
    n_grad_slots = [0] * C
    inbox_act_live = np.zeros((C, p, T), np.int32)
    inbox_grad_live = np.zeros((C, p, T), np.int32)
    for c in range(C):
        a_worst = g_worst = 0
        for s in range(p):
            pos = pl.pos_of(c, s)
            a_iv: Dict[Tuple, Tuple[int, int]] = {}
            g_iv: Dict[Tuple, Tuple[int, int]] = {}
            prev = pl.fwd_prev(c, pos)
            nxt = pl.fwd_next(c, pos)
            for j in range(m):
                if prev is not None:
                    ps = pl.stage_of(*prev)
                    a_iv[(s, c, j)] = (
                        tick_of(ps, Op(OpKind.F, j, prev[0])),
                        tick_of(s, Op(OpKind.F, j, c)),
                    )
                if nxt is not None:
                    ns = pl.stage_of(*nxt)
                    g_iv[(s, c, j)] = (
                        tick_of(ns, Op(OpKind.B, j, nxt[0])),
                        tick_of(s, Op(OpKind.B, j, c)),
                    )
            alloc_a, na = _allocate_slots(a_iv)
            alloc_g, ng = _allocate_slots(g_iv)
            act_slots.update(alloc_a)
            grad_slots.update(alloc_g)
            a_worst = max(a_worst, na)
            g_worst = max(g_worst, ng)
            for (s_, c_, _j), (a, b) in a_iv.items():
                inbox_act_live[c_, s_, a : b + 1] += 1
            for (s_, c_, _j), (a, b) in g_iv.items():
                inbox_grad_live[c_, s_, a : b + 1] += 1
        n_act_slots[c] = a_worst
        n_grad_slots[c] = g_worst

    # --- per-tick live-slot counts (the executor's alloc/free semantics,
    # replayed) ------------------------------------------------------------- #
    res_live = np.zeros((C, p, T), np.int32)
    wctx_live = np.zeros((C, p, T), np.int32)
    sink_live = np.zeros((p, T), np.int32)
    sink_wctx_live = np.zeros((p, T), np.int32)
    for c in range(C):
        for s in range(p):
            for j in range(m):
                a, b = _res_iv(s, c, j)
                res_live[c, s, a : b + 1] += 1
                a, b = _wctx_iv(s, c, j)
                wctx_live[c, s, a : b + 1] += 1
    for (s_, j), (a, b) in iv_sink.items():
        sink_live[s_, a : b + 1] += 1
    for (s_, j), (a, b) in iv_sink_w.items():
        sink_wctx_live[s_, a : b + 1] += 1

    # --- fill per-op tables ------------------------------------------------ #
    for s in range(p):
        for op in schedule.stage_ops[s]:
            t = tick_of(s, op)
            c, j = op.chunk, op.mb
            pos = pl.pos_of(c, s)
            op_kind[s, t] = int(op.kind)
            op_chunk[s, t] = c
            op_mb[s, t] = j
            op_res_slot[s, t] = res_slots[(s, c, j)]
            op_res_slot_joint[s, t] = res_slots_joint[(s, c, j)]
            if op.kind in (OpKind.B, OpKind.W):
                op_wctx_slot[s, t] = wctx_slots[(s, c, j)]
                op_wctx_slot_joint[s, t] = wctx_slots_joint[(s, c, j)]
            if pl.fwd_next(c, pos) is None:
                op_is_loss[s, t] = True
                op_sink_slot[s, t] = sink_slots[(s, j)]
                op_sink_wctx_slot[s, t] = sink_wctx_slots[(s, j)]
            if pl.fwd_prev(c, pos) is None:
                op_is_src[s, t] = True
            if op.kind == OpKind.F:
                prev = pl.fwd_prev(c, pos)
                nxt = pl.fwd_next(c, pos)
                if prev is None:
                    op_is_src[s, t] = True
                else:
                    op_in_slot[s, t] = act_slots[(s, c, j)]
                if nxt is None:
                    op_is_loss[s, t] = True
                else:
                    nc, npos = nxt
                    ns = pl.stage_of(nc, npos)
                    dst_slot = act_slots[(ns, nc, j)]
                    if ns == s:
                        send_local[s, t] = True
                        local_chunk[s, t] = nc
                        local_slot[s, t] = dst_slot
                        local_is_grad[s, t] = False
                    else:
                        if ns == (s + 1) % p:
                            ch = CHANNEL_FWD_UP
                        elif ns == (s - 1) % p:
                            ch = CHANNEL_FWD_DOWN
                        else:
                            raise ValueError(
                                f"F send {s}->{ns} is not an adjacent permute"
                            )
                        send_channel[s, t] = ch
                        recv_valid[ns, t, ch] = True
                        recv_chunk[ns, t, ch] = nc
                        recv_slot[ns, t, ch] = dst_slot
            elif op.kind == OpKind.B:
                nxt = pl.fwd_next(c, pos)
                prev = pl.fwd_prev(c, pos)
                if nxt is None:
                    op_is_loss[s, t] = True  # seed dy from loss
                else:
                    op_in_slot[s, t] = grad_slots[(s, c, j)]
                if prev is None:
                    op_is_last_b[s, t] = True  # nothing upstream of embedding
                else:
                    pc, ppos = prev
                    ps = pl.stage_of(pc, ppos)
                    dst_slot = grad_slots[(ps, pc, j)]
                    if ps == s:
                        send_local[s, t] = True
                        local_chunk[s, t] = pc
                        local_slot[s, t] = dst_slot
                        local_is_grad[s, t] = True
                    else:
                        if ps == (s - 1) % p:
                            ch = CHANNEL_BWD_DOWN
                        elif ps == (s + 1) % p:
                            ch = CHANNEL_BWD_UP
                        else:
                            raise ValueError(
                                f"B send {s}->{ps} is not an adjacent permute"
                            )
                        send_channel[s, t] = ch
                        recv_valid[ps, t, ch] = True
                        recv_chunk[ps, t, ch] = pc
                        recv_slot[ps, t, ch] = dst_slot

    return ExecutionPlan(
        p=p,
        m=m,
        n_chunks=C,
        n_ticks=T,
        placement=pl,
        name=schedule.name,
        op_kind=op_kind,
        op_chunk=op_chunk,
        op_mb=op_mb,
        op_in_slot=op_in_slot,
        op_res_slot=op_res_slot,
        op_wctx_slot=op_wctx_slot,
        op_res_slot_joint=op_res_slot_joint,
        op_wctx_slot_joint=op_wctx_slot_joint,
        op_is_src=op_is_src,
        op_is_loss=op_is_loss,
        op_is_last_b=op_is_last_b,
        op_sink_slot=op_sink_slot,
        op_sink_wctx_slot=op_sink_wctx_slot,
        send_channel=send_channel,
        send_local=send_local,
        local_chunk=local_chunk,
        local_slot=local_slot,
        local_is_grad=local_is_grad,
        recv_valid=recv_valid,
        recv_chunk=recv_chunk,
        recv_slot=recv_slot,
        n_act_slots=tuple(max(1, n) for n in n_act_slots),
        n_grad_slots=tuple(max(1, n) for n in n_grad_slots),
        n_res_slots=tuple(max(1, n) for n in n_res_slots),
        n_wctx_slots=tuple(max(1, n) for n in n_wctx_slots),
        n_res_slots_joint=max(1, n_res_slots_joint),
        n_wctx_slots_joint=max(1, n_wctx_slots_joint),
        n_sink_slots=n_sink_slots,
        n_sink_wctx_slots=n_sink_wctx_slots,
        res_live=res_live,
        wctx_live=wctx_live,
        inbox_act_live=inbox_act_live,
        inbox_grad_live=inbox_grad_live,
        sink_live=sink_live,
        sink_wctx_live=sink_wctx_live,
    )
