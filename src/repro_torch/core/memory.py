"""Time-resolved pipeline memory model and the byte-level budget planner.

Counterpart of ``src/repro/core/memory.py``, host-only Python with the same
arithmetic, so the timelines and byte models equal the JAX package's
(``tests/test_torch_memory.py``):

1. :func:`memory_timeline` -- live activations (M_B: allocated when F starts,
   freed when the matching B ends) and W-contexts (M_W: allocated when B
   starts, freed when W ends) per stage over simulated time or ticks.
2. :class:`ActivationByteModel` -- bytes behind one (M_B, M_W) unit for a
   config and run shape, from the block kinds.
3. :func:`measured_timeline` -- the same interval analysis weighted by the
   per-slot bytes the port's executor really holds
   (``PipelineExecutor.buffer_bytes``, measured on the run's own device).

4. The CUDA scratch calibration, the counterpart of the JAX package's XLA
   one (``_xla_temp_table``, ``default_xla_temp_bytes``,
   ``calibrate_from_dryrun``): :func:`_cuda_temp_table` reads
   ``configs/cuda_temp_calibration.json`` (written on the card by
   ``launch/calibrate.py``), :func:`default_cuda_temp_bytes` scales its
   remainder to a planned run, and :func:`cuda_optimizer_shares` gives the
   shares of the optimizer's transient that the card holds on top of the
   walk and of the walk that the transient reuses (the JAX
   ``calibrate_from_dryrun`` fold is ``launch/calibrate.py::
   calibration_record``, from ``torch.cuda.max_memory_reserved``).  The
   remainder is what the card reserves at the walk's end beyond what the
   planner prices (weights, moments, the fp32 gradient accumulators, the
   walk's slots): the allocator's rounding and fragmentation and the
   walk's in-op scratch.

Left out, as nothing in
the port calls them: ``ActivationByteModel.from_measured``,
``measured_unit_bytes`` and the ``MemoryBudgetPlanner`` adapter (with
``CandidatePlan`` and ``PlannerDecision``); the planner is
:class:`repro_torch.core.planner.HBMPlanner`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..configs import all_configs
from .schedules.ir import OpKind, Schedule
from .simulator import TimeModel, simulate

__all__ = [
    "MemoryTimeline",
    "memory_timeline",
    "ActivationByteModel",
    "MeasuredTimeline",
    "measured_timeline",
    "CUDA_TEMP_TABLE",
    "cuda_temp_record",
    "cuda_temp_records",
    "record_key",
    "cuda_optimizer_shares",
    "default_cuda_temp_bytes",
]


# --------------------------------------------------------------------- #
# 1. time-resolved memory
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class MemoryTimeline:
    """Per-stage piecewise-constant memory over simulated time.

    ``events[s]`` is a sorted list of (time, act, wctx) samples taken after
    every change; ``peak_*`` are per-stage maxima in M_B units.
    """

    p: int
    m_b: float
    m_w: float
    events: List[List[Tuple[float, float, float]]]
    peak_act: np.ndarray  # (p,)
    peak_wctx: np.ndarray  # (p,)
    peak_total: np.ndarray  # (p,)

    @property
    def max_peak_act(self) -> float:
        return float(self.peak_act.max())

    @property
    def max_peak_total(self) -> float:
        return float(self.peak_total.max())

    def global_footprint(self, t: float) -> float:
        """Sum of all stages' live memory at time t (bytes == units * m_b)."""
        total = 0.0
        for stage_events in self.events:
            live = 0.0
            for ts, act, wctx in stage_events:
                if ts > t:
                    break
                live = act + wctx
            total += live
        return total


def memory_timeline(schedule: Schedule, times: Optional[TimeModel] = None, m_b: float = 1.0,
                    m_w: float = 0.5, tick_times: bool = False) -> MemoryTimeline:
    """Track live activation / W-context buffers over simulated time.

    Allocations happen at op start, frees at op end.  ``tick_times=True``
    uses the executor's tick grid instead of the simulator's clock (every
    pass one tick; a slot freed at tick t is free for tick t + 1's op).
    """
    times = times or TimeModel.unit()
    if tick_times:
        ticks = schedule.to_ticks()
        start_of = {k: float(t) for k, t in ticks.items()}
        end_of = {k: float(t) + 1.0 for k, t in ticks.items()}
    else:
        res = simulate(schedule, times)
        start_of, end_of = res.start, res.end
    C = schedule.n_chunks
    mb_c, mw_c = m_b / C, m_w / C
    # equal times: continuous time allocates before it frees (overlapping
    # ops), the tick grid frees first (the executor's semantics)
    ao, fo = (1, 0) if tick_times else (0, 1)

    p = schedule.p
    events: List[List[Tuple[float, float, float]]] = []
    peak_act = np.zeros(p)
    peak_wctx = np.zeros(p)
    peak_total = np.zeros(p)
    for s in range(p):
        deltas: List[Tuple[float, int, float, float]] = []  # (t, order, d_act, d_wctx)
        for op in schedule.stage_ops[s]:
            t0, t1 = start_of[(s, op)], end_of[(s, op)]
            if op.kind == OpKind.F:
                deltas.append((t0, ao, mb_c, 0.0))
            elif op.kind == OpKind.B:
                deltas.append((t0, ao, 0.0, mw_c))
                deltas.append((t1, fo, -mb_c, 0.0))
            else:
                deltas.append((t1, fo, 0.0, -mw_c))
        deltas.sort(key=lambda d: (d[0], d[1]))
        act = wctx = 0.0
        series: List[Tuple[float, float, float]] = []
        for t, _, da, dw in deltas:
            act += da
            wctx += dw
            series.append((t, act, wctx))
            peak_act[s] = max(peak_act[s], act)
            peak_wctx[s] = max(peak_wctx[s], wctx)
            peak_total[s] = max(peak_total[s], act + wctx)
        events.append(series)
    return MemoryTimeline(p=p, m_b=m_b, m_w=m_w, events=events, peak_act=peak_act,
                          peak_wctx=peak_wctx, peak_total=peak_total)


# --------------------------------------------------------------------- #
# 2. activation byte model
# --------------------------------------------------------------------- #
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}

# query-block size of the attention in both packages: sequences up to
# 2 * block take the dense path and store the per-head (s, s) probabilities;
# longer ones recompute each query block's in B (``models/modules.py::remat``)
# and store none
_ATTN_CHUNK_BLOCK = 1024

# W-context / stored-activation ratios per kind bucket, the JAX package's
# calibration ("compact": its byte-minimal cut; "frontier": the legacy cut)
_WCTX_RATIO = {
    True: {"attn": 0.35, "mlp": 0.50, "rec": 0.30},
    False: {"attn": 0.65, "mlp": 0.75, "rec": 0.55},
}


CUDA_TEMP_TABLE = pathlib.Path(__file__).resolve().parent.parent / "configs" / "cuda_temp_calibration.json"
_CUDA_TEMP_CACHE: Dict[str, dict] = {}


def _cuda_temp_table(path=None) -> dict:
    """``{arch name: {executor mode: record}}`` from the calibration table
    (:data:`CUDA_TEMP_TABLE` unless ``path`` names another, which is read
    anew each call); ``{}`` when the file is missing or unreadable.  The
    checked-in table is read once a process."""
    if path is not None:
        return _read_table(path)
    key = str(CUDA_TEMP_TABLE)
    if key not in _CUDA_TEMP_CACHE:
        _CUDA_TEMP_CACHE[key] = _read_table(key)
    return _CUDA_TEMP_CACHE[key]


def _read_table(path) -> dict:
    try:
        return json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError):
        return {}


def cuda_temp_records(arch_name: str, executor_mode: str, path=None) -> List[dict]:
    """Every record of an arch under an executor mode: one for each depth
    and stage count it was measured at (a table entry is one record or a
    list of them)."""
    got = _cuda_temp_table(path).get(arch_name, {}).get(executor_mode)
    return [] if got is None else list(got) if isinstance(got, list) else [got]


# the tokens a microbatch of the calibration cell (``launch/calibrate.py::
# CELL``): a record whose cut names no seq_len was measured at it
CALIBRATION_SEQ = 1024


def record_key(rec: dict) -> Tuple[Optional[int], int, int]:
    """What tells two records of an arch and executor mode apart: the
    ``(layers, p, seq_len)`` it was measured at, from its ``cut``; layers is
    None for a record of the config's full depth (no cut), and seq_len the
    cell's where the cut does not name one."""
    cut = rec.get("cut") or {}
    return cut.get("layers"), cut.get("p", rec["p"]), cut.get("seq_len", CALIBRATION_SEQ)


@functools.lru_cache(maxsize=None)
def _full_depth(arch_name: str) -> Optional[int]:
    """The published depth of the config named ``arch_name``, or None."""
    return {c.name: c.n_layers for c in all_configs().values()}.get(arch_name)


def cuda_temp_record(arch_name: str, executor_mode: str, path=None,
                     layers: Optional[int] = None, p: Optional[int] = None,
                     seq_len: Optional[int] = None) -> Optional[dict]:
    """The record that prices a run of ``layers`` layers on ``p`` stages at
    ``seq_len`` tokens a microbatch: of the records measured at that depth
    and p (a record with no ``cut`` is at the config's published depth),
    the one measured at that seq_len (None: the cell's), else the one
    measured at the cell's, or at any when the run names none; else the
    one of the config's full depth; else the first.  None when the arch has
    none under the mode."""
    full = _full_depth(arch_name)
    seq = seq_len or CALIBRATION_SEQ

    def rank(rec):
        at_layers, at_p, at_seq = record_key(rec)
        if layers is not None and layers == (at_layers or full) and p in (None, at_p):
            if at_seq == seq:
                return 0
            if at_seq == CALIBRATION_SEQ or seq_len is None:
                return 1
        return 2 if "cut" not in rec else 3

    return min(cuda_temp_records(arch_name, executor_mode, path), key=rank, default=None)


def cuda_optimizer_shares(arch_name: str, executor_mode: str, path=None,
                          layers: Optional[int] = None, p: Optional[int] = None,
                          seq_len: Optional[int] = None) -> Tuple[float, float]:
    """(overhang, reuse) of the optimizer's transient on the card, from a
    record: ``optimizer_overhang``, the largest share of the transient a run
    held above its walk's reserved peak, and ``optimizer_reuse``, the
    smallest share of the walk's bytes its transient reused (what it held
    less than the transient, over the walk).  The planner charges
    ``max(overhang * transient, transient - reuse * walk)``.  With no
    record, the structural shares: (1, 0) under the graph executor (the
    walk's memory stays in the graph's pool, so nothing of it is reused),
    (0, 1) under the eager one (the larger of walk and transient)."""
    rec = cuda_temp_record(arch_name, executor_mode, path, layers, p, seq_len)
    if rec is None or "optimizer_overhang" not in rec:
        return (1.0, 0.0) if executor_mode == "graph" else (0.0, 1.0)
    return float(rec["optimizer_overhang"]), float(rec["optimizer_reuse"])


def default_cuda_temp_bytes(arch_name: str, executor_mode: str,
                            m_b_bytes: Optional[float] = None,
                            weights_bytes: Optional[float] = None, path=None,
                            layers: Optional[int] = None, p: Optional[int] = None,
                            seq_len: Optional[int] = None) -> float:
    """Per-device share of the calibrated CUDA remainder for a planned run.

    A record (``launch/calibrate.py``) holds ``cuda_temp_bytes``: the most
    that ``torch.cuda.max_memory_reserved`` at the end of a run's first walk
    exceeded the priced weights, moments, accumulators and walk by, over
    the launcher's eight schedules, all ``p`` stages on one card, at the
    calibration cell; what the optimizer adds after the walk is priced
    apart (:func:`cuda_optimizer_shares`).  It is a ceiling, as the JAX
    table's value is, in two parts with their own scale:

      * ``cuda_temp_scaled_bytes``, the live bytes the walk's slots do not
        price (in-op scratch), scales with the ratio of the planned M_B unit
        to the cell's (``m_b_bytes``), as the JAX rule does, but up as well
        as down: the JAX rule never scales up because a CPU compile
        overstates liveness, and the card has no such inflation;
      * ``cuda_temp_fixed_bytes``, what the allocator reserves beyond the
        live bytes, scales with the ratio of the planned weights and
        moments to the cell's (``weights_bytes``), not with M_B: its blocks
        are the leaves' as much as the activations', and at seq 512 the
        whole remainder scaled by M_B fell short of the card's (H100,
        700 W; PERF.md), while a reduced config keeps a share its size.

    One card holds all p stages, so a device's share is the remainder
    divided by the record's ``p`` (a calibration across cards would
    measure it per device).  The record is :func:`cuda_temp_record`'s for
    the run's ``layers``, ``p`` and ``seq_len``.  An arch or executor mode with no record
    prices 0, as the JAX package prices an uncalibrated arch.
    """
    rec = cuda_temp_record(arch_name, executor_mode, path, layers, p, seq_len)
    if rec is None:
        return 0.0

    def ratio(planned, key):
        return float(planned) / float(rec[key]) if planned and rec.get(key) else 1.0

    fixed = float(rec["cuda_temp_fixed_bytes"]) * ratio(weights_bytes, "weights_bytes")
    scaled = float(rec["cuda_temp_scaled_bytes"]) * ratio(m_b_bytes, "m_b_bytes")
    return (fixed + scaled) / int(rec["p"])


@dataclasses.dataclass(frozen=True)
class ActivationByteModel:
    """Bytes behind one (M_B, M_W) unit for a concrete config + run shape.

    ``m_b_bytes`` is the stored-activation footprint of one microbatch
    through one full stage (all its layers, all chunks); ``m_w_bytes`` the
    matching B->W context.  Per token each block kind stores: attention
    ``4*d_model + 2*kv`` plus ``n_heads * s`` scores on the dense path
    (s <= 2048); MLP ``d_model + 2*d_ff'`` (d_ff' the activated width); a
    recurrent kind ``6*d_model``.  The W-context is a per-kind fraction of
    that (``_WCTX_RATIO``).  The JAX model's ``xla_temp_bytes`` has no
    field here: the planner reads the calibrated CUDA remainder itself
    (:func:`default_cuda_temp_bytes`), since its allocator part scales with
    the weights, which this model does not see.
    """

    m_b_bytes: float
    m_w_bytes: float
    per_layer_act: float
    per_layer_wctx: float
    layers_per_stage: int
    tokens: int
    dtype_bytes: int

    @staticmethod
    def from_config(cfg, microbatch: int, seq_len: int, p: int, n_chunks: int = 1,
                    tp_size: int = 1, compact: bool = True) -> "ActivationByteModel":
        dtype_bytes = _DTYPE_BYTES.get(cfg.dtype, 4)
        ex = cfg.extras_dict()
        head_dim = cfg.head_dim or (cfg.d_model // cfg.n_heads)
        kv = cfg.n_kv_heads * head_dim
        d_ff_act = cfg.d_ff
        if "n_active_experts" in ex and "n_experts" in ex:
            d_ff_act = cfg.d_ff * ex["n_active_experts"]

        ratio = _WCTX_RATIO[bool(compact)]
        dense_attn = seq_len <= 2 * _ATTN_CHUNK_BLOCK
        attn_scores = cfg.n_heads * seq_len if dense_attn else 0.0
        act_per_kind = {}
        wctx_per_kind = {}
        for kinds in cfg.block_pattern:
            for kind in kinds:
                if kind.startswith("attn") or kind == "mla":
                    act_per_kind[kind] = 4 * cfg.d_model + 2 * kv + attn_scores
                    wctx_per_kind[kind] = ratio["attn"] * (4 * cfg.d_model + 2 * kv)
                elif kind in ("mlp", "moe"):
                    act_per_kind[kind] = cfg.d_model + 2 * d_ff_act
                    wctx_per_kind[kind] = ratio["mlp"] * act_per_kind[kind]
                else:  # recurrent / state-space / frontier kinds
                    act_per_kind[kind] = 6 * cfg.d_model
                    wctx_per_kind[kind] = ratio["rec"] * act_per_kind[kind]

        period = len(cfg.block_pattern)
        per_block_act = sum(act_per_kind[k] for kinds in cfg.block_pattern for k in kinds) / period
        per_block_wctx = sum(wctx_per_kind[k] for kinds in cfg.block_pattern for k in kinds) / period

        g = max(1, math.ceil(cfg.n_layers / (p * n_chunks))) * n_chunks
        tokens = microbatch * seq_len
        per_layer_act = per_block_act * tokens * dtype_bytes / max(1, tp_size)
        per_layer_wctx = per_block_wctx * tokens * dtype_bytes / max(1, tp_size)
        return ActivationByteModel(
            m_b_bytes=per_layer_act * g,
            m_w_bytes=per_layer_wctx * g,
            per_layer_act=per_layer_act,
            per_layer_wctx=per_layer_wctx,
            layers_per_stage=g,
            tokens=tokens,
            dtype_bytes=dtype_bytes,
        )

    def timeline_bytes(self, tl: MemoryTimeline) -> Tuple[float, float, float]:
        """(act_bytes, wctx_bytes, total_bytes) peaks of a unit timeline."""
        act = float(tl.peak_act.max()) * self.m_b_bytes
        wctx = float(tl.peak_wctx.max()) * self.m_w_bytes
        total = float(max(a * self.m_b_bytes + w * self.m_w_bytes
                          for series in tl.events for _, a, w in series))
        return act, wctx, total

    def schedule_bytes(self, schedule: Schedule, times: Optional[TimeModel] = None,
                       tick_times: bool = False) -> Tuple[float, float, float]:
        """(act_bytes, wctx_bytes, total_bytes) peak per device."""
        return self.timeline_bytes(
            memory_timeline(schedule, times, m_b=1.0, m_w=1.0, tick_times=tick_times))


# --------------------------------------------------------------------- #
# 3. measured executor memory
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class MeasuredTimeline:
    """Per-stage live executor bytes over ticks, from measured slot bytes.

    ``act_bytes`` counts the F->B residuals, ``wctx_bytes`` the B->W
    contexts, ``inbox_bytes`` the inboxes, ``sink_bytes`` the head+loss
    residuals and contexts at the loss stage.  ``alloc_*`` are
    ``buffer_bytes``' pool sizes: slot counts times slot bytes.
    """

    p: int
    n_ticks: int
    act_bytes: np.ndarray  # (p, T)
    wctx_bytes: np.ndarray  # (p, T)
    inbox_bytes: np.ndarray  # (p, T)
    sink_bytes: np.ndarray  # (p, T)
    alloc_act: float
    alloc_wctx: float
    alloc_inbox: float
    alloc_sink: float
    alloc_total: float
    res_slot_bytes: Tuple[float, ...]  # per chunk
    wctx_slot_bytes: Tuple[float, ...]

    @property
    def peak_act(self) -> np.ndarray:
        return self.act_bytes.max(axis=1)

    @property
    def peak_wctx(self) -> np.ndarray:
        return self.wctx_bytes.max(axis=1)

    @property
    def peak_total(self) -> np.ndarray:
        return (self.act_bytes + self.wctx_bytes + self.inbox_bytes + self.sink_bytes).max(axis=1)

    @property
    def max_peak_act(self) -> float:
        return float(self.peak_act.max())

    @property
    def max_peak_wctx(self) -> float:
        return float(self.peak_wctx.max())

    def unit_bytes(self) -> Tuple[float, float]:
        """(m_b_bytes, m_w_bytes): one microbatch through one full stage."""
        return float(sum(self.res_slot_bytes)), float(sum(self.wctx_slot_bytes))


def measured_timeline(executor, stage_params=None, shared=None, side_all=None, *,
                      slots=None) -> MeasuredTimeline:
    """Replay the plan's interval analysis weighted by measured slot bytes.

    ``executor`` is a :class:`~repro_torch.core.executor.PipelineExecutor`;
    the per-tick live counts come from the compiled plan (a residual slot is
    live [F, B], a W-context slot [B, W]) and are weighted by the bytes of
    one slot of each pool, measured by one microbatch's F and B on the
    parameters' device.  One difference from the JAX package: in B's tick
    the residual and the new W-context share the deferred linears' inputs
    (and the sink's), which that tick counts once.  ``slots`` reuses a
    :func:`~repro_torch.core.executor.slot_bytes` measurement.
    """
    plan = executor.plan
    bb = executor.buffer_bytes(stage_params, shared, side_all, slots=slots)
    p, T, C = plan.p, plan.n_ticks, plan.n_chunks

    b_tick = plan.op_kind == int(OpKind.B)
    act = np.zeros((p, T))
    wctx = np.zeros((p, T))
    for c in range(C):
        act += plan.res_live[c] * bb["res_slot_bytes"][c]
        wctx += (plan.wctx_live[c] * bb["wctx_slot_bytes"][c]
                 - (b_tick & (plan.op_chunk == c)) * bb["res_wctx_shared"][c])
    chan_bytes = executor.channel_message_bytes()
    inbox = (plan.inbox_act_live.sum(axis=0) + plan.inbox_grad_live.sum(axis=0)) * chan_bytes
    sink_slot = bb["sink"] / max(1, plan.n_sink_slots)
    sink_wctx_slot = bb["sink_wctx"] / max(1, plan.n_sink_wctx_slots)
    sink = (plan.sink_live * sink_slot + plan.sink_wctx_live * sink_wctx_slot
            - (b_tick & plan.op_is_loss) * bb["sink_shared"])
    return MeasuredTimeline(
        p=p,
        n_ticks=T,
        act_bytes=act,
        wctx_bytes=wctx,
        inbox_bytes=inbox.astype(float),
        sink_bytes=sink.astype(float),
        alloc_act=bb["res"],
        alloc_wctx=bb["wctx"],
        alloc_inbox=bb["inbox"],
        alloc_sink=bb["sink"] + bb["sink_wctx"],
        alloc_total=bb["total"],
        res_slot_bytes=bb["res_slot_bytes"],
        wctx_slot_bytes=bb["wctx_slot_bytes"],
    )
