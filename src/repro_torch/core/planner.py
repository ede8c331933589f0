"""Unified HBM-aware planning layer of the port.

Counterpart of ``src/repro/core/planner.py``: one ``plan()`` across every
schedule family under a per-device memory budget, itemized per device as

  * **params** -- one stage's chunk parameters plus the shared ones
                  (embedding, head, final norm);
  * **optim**  -- AdamW moments (fp32 m + v), ZeRO-1 sharded over dp
                  (``optim/sharding.py``'s rule);
  * **act**    -- peak live F->B residual bytes (the paper's M_B term);
  * **wctx**   -- peak live B->W contexts (M_W);
  * **inbox**  -- the inter-stage message slots;
  * **sink**   -- head+loss residuals and contexts at the loss stage;
  * **temp**   -- what the card holds beyond those slots, in three parts
                  (the JAX package charges an XLA calibration here):
                  the fp32 gradient accumulators (exact, from the leaf
                  shapes: ``PipelineExecutor.accumulator_bytes``), the
                  optimizer's transient (``launch/steps.py::
                  optimizer_transient_bytes``) and a device's share of the
                  CUDA remainder calibrated on the card
                  (``core/memory.py::default_cuda_temp_bytes``).  The
                  optimizer runs after the walk: under
                  ``executor_mode="graph"`` the walk's memory stays in the
                  CUDA graph's pool, so all of the transient adds to the
                  slots; under ``"eager"`` the walk has freed its slots, and
                  the transient may reuse some of them.  The charge is
                  ``optimizer_charge``: the calibrated share of the
                  transient that the card held on top of the walk, and at
                  least what the transient exceeds the calibrated reusable
                  share of the walk's slots by (``cuda_optimizer_shares``;
                  on the H100 about 1.07 and 0 under graph, 0.57 and 0.2
                  under eager).  ``temp_bytes=X`` replaces the whole term,
                  as the JAX package's ``xla_temp_bytes`` does.

Two fidelities share one code path: the *model* fidelity prices act/wctx
with :class:`~repro_torch.core.memory.ActivationByteModel` and the
inbox/sink from the plan's slot counts; the *measured* fidelity multiplies
the plan's slot counts by the bytes one slot really holds
(``core/executor.py::slot_bytes``, measured once per chunk count on the
device of the program that a ``program_factory`` builds, such as
:func:`stage_program_factory`).

The pool spans 1F1B, interleaved 1F1B, ZB-H1, ZB-H2, ZB-V, V-Min, V-Half,
the Sec.-3.1 greedy grid at the budget-implied limit and the ``v_flex``
portfolio.  Budget-implied searches accumulate in the planner, so an
ascending budget sweep keeps every cheaper plan and the cost-vs-budget
frontier is monotone.  Unlike the JAX package there is no on-disk plan
cache: ``v_flex`` builds are memoized in process only.

:meth:`HBMPlanner.one_card_bytes` prices what one card holding all p
stages needs for a plan (every stage's weights, moments and accumulators
once, the shared leaves once, the walk's measured bytes at its worst tick
over all stages, the optimizer's transient over the stage-by-stage loop,
and the calibrated remainder): the number a card run's
``torch.cuda.max_memory_reserved`` is held to.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..launch.steps import optimizer_transient_bytes
from ..models.lm import RunSpec, build_program, front_len, init_params, side_inputs
from ..optim.sharding import zero1_state_bytes
from ..tree import tree_leaves, tree_map
from .executor import PipelineExecutor, slot_bytes
from .memory import (ActivationByteModel, cuda_optimizer_shares, default_cuda_temp_bytes,
                     measured_timeline, memory_timeline)
from .schedules import interleaved_1f1b, one_f_one_b, search, v_half, v_min, zb_h1, zb_h2, zb_v
from .schedules.ir import Placement, Schedule, compile_plan
from .simulator import TimeModel, simulate

__all__ = [
    "HBMBreakdown",
    "OneCardBytes",
    "StateBytes",
    "PipelinePlan",
    "PlanReport",
    "HBMPlanner",
    "fixed_state_bytes",
    "optimizer_charge",
    "state_bytes",
    "stage_program_factory",
    "plan",
    "fastest_under_profile",
]

_INF = float("inf")

EXECUTOR_MODES = ("eager", "graph")

# beyond ~2p*M_B extra schedule memory buys no bubble (paper Sec. 5: ZB-2p
# is already ~zero bubble), so budget-implied search limits clamp there.
_LIMIT_CAP_FACTOR = 2.0


# --------------------------------------------------------------------- #
# itemized per-device HBM breakdown
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class HBMBreakdown:
    """Per-device bytes, itemized; ``total`` is the budget-facing sum."""

    params: float = 0.0
    optim: float = 0.0
    act: float = 0.0
    wctx: float = 0.0
    inbox: float = 0.0
    sink: float = 0.0
    temp: float = 0.0
    # temp's parts (TEMP_PARTS), empty when temp was given as one number
    temp_parts: Tuple[float, ...] = ()

    TEMP_PARTS = ("accumulators", "optimizer", "remainder")

    def items(self) -> Dict[str, float]:
        return {
            "params": self.params,
            "optim": self.optim,
            "act": self.act,
            "wctx": self.wctx,
            "inbox": self.inbox,
            "sink": self.sink,
            "temp": self.temp,
        }

    @property
    def schedule_bytes(self) -> float:
        """The schedule-dependent share (everything but params/optim/temp)."""
        return self.act + self.wctx + self.inbox + self.sink

    @property
    def total(self) -> float:
        return sum(self.items().values())

    def binding_term(self) -> str:
        """Name of the largest term -- what a bigger budget must pay for."""
        return max(self.items().items(), key=lambda kv: kv[1])[0]

    def report(self, indent: str = "  ") -> str:
        lines = [f"{indent}{k:<8s} {v / 2**20:10.1f} MiB"
                 for k, v in self.items().items() if v > 0]
        if self.temp > 0 and self.temp_parts:
            lines.append(f"{indent}  (temp = " + " + ".join(
                f"{k} {v / 2**20:.1f}" for k, v in zip(self.TEMP_PARTS, self.temp_parts)) + " MiB)")
        lines.append(f"{indent}{'total':<8s} {self.total / 2**20:10.1f} MiB")
        return "\n".join(lines)


@dataclasses.dataclass
class PipelinePlan:
    """One evaluated candidate: schedule + byte model + cost + breakdown."""

    name: str
    schedule: Optional[Schedule]
    placement: Optional[Placement]
    byte_model: Optional[ActivationByteModel]
    cost: float
    bubble_rate: float
    breakdown: Optional[HBMBreakdown]
    fits: bool
    note: str = ""

    @property
    def total_bytes(self) -> float:
        return self.breakdown.total if self.breakdown is not None else _INF


@dataclasses.dataclass
class PlanReport:
    """``plan()``'s answer: the chosen plan or an itemized infeasibility."""

    budget_bytes: float
    feasible: bool
    chosen: Optional[PipelinePlan]
    plans: List[PipelinePlan]
    min_required_bytes: float
    # the planner that answered (its one_card_bytes prices the chosen plan on one card)
    planner: Optional["HBMPlanner"] = dataclasses.field(default=None, repr=False, compare=False)

    def summary(self) -> str:
        if self.feasible:
            c = self.chosen
            return (f"budget {self.budget_bytes / 2**20:.0f} MiB -> {c.name} "
                    f"(cost {c.cost:.1f}, bubble {c.bubble_rate:.3f}, "
                    f"{c.total_bytes / 2**20:.0f} MiB HBM)")
        return (f"budget {self.budget_bytes / 2**20:.0f} MiB infeasible; "
                f"cheapest plan needs {self.min_required_bytes / 2**20:.0f} MiB")

    def infeasibility_report(self) -> str:
        """Itemized report for the smallest-footprint plan, naming the
        binding term -- what the budget must grow (or the model shrink) by."""
        finite = [p for p in self.plans if p.schedule is not None]
        if not finite:
            return "no candidate schedule could be built"
        cheapest = min(finite, key=lambda p: p.total_bytes)
        bd = cheapest.breakdown
        short = cheapest.total_bytes - self.budget_bytes
        return (f"budget {self.budget_bytes / 2**20:.1f} MiB infeasible: "
                f"cheapest plan {cheapest.name} needs {cheapest.total_bytes / 2**20:.1f} MiB "
                f"({short / 2**20:.1f} MiB short); binding term: "
                f"{bd.binding_term()}\n{bd.report()}")


# --------------------------------------------------------------------- #
# parameter + optimizer byte accounting
# --------------------------------------------------------------------- #
def _strip_stage_axis(stacked):
    """One stage's parameters of the (p, ...)-stacked trees."""
    return tuple(tree_map(lambda a: a[0], chunk) for chunk in stacked)


def fixed_state_bytes(cfg, p: int, n_chunks: int, tp_size: int = 1,
                      dp_size: int = 1) -> Tuple[float, float]:
    """(param_bytes, optimizer_bytes) per device.

    The port's own ``init_params`` is shape-evaluated (fake tensors: no
    memory, no arithmetic), so padded groups and masks are priced exactly,
    then one stage's share is taken (one stage per device).  Optimizer
    moments mirror each leaf and are ZeRO-1 sharded over dp.  Tensor
    parallelism is not ported: ``tp_size`` must be 1.
    """
    if tp_size != 1:
        raise NotImplementedError("tensor parallelism is not ported to repro_torch yet")
    st = state_bytes(cfg, p, n_chunks, dp_size)
    return st.params, st.optim


@dataclasses.dataclass(frozen=True)
class StateBytes:
    """Schedule-independent bytes of a run shape: per device (one stage's
    share plus the shared leaves, as :func:`fixed_state_bytes`) and on one
    card holding all p stages (shared leaves once)."""

    params: float
    optim: float
    acc: float  # fp32 gradient accumulators
    transient: float  # the optimizer's transient, the largest stage stepped alone
    params_card: float
    optim_card: float
    acc_card: float
    transient_card: float  # the optimizer's transient over the stage-by-stage loop


@functools.lru_cache(maxsize=32)
def state_bytes(cfg, p: int, n_chunks: int, dp_size: int = 1) -> StateBytes:
    """The parameter and moment bytes of :func:`fixed_state_bytes`, with the
    accumulators and the optimizer's transient beside them, from one shape
    evaluation of ``init_params`` (memoized: a config's shapes do not
    change)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    spec = RunSpec(p=p, n_chunks=n_chunks, microbatch=1, seq_len=8, m=1)
    # leaf shapes depend on (cfg, p, n_chunks) alone; placement only moves
    # mask values between stages
    placement = Placement.vshape(p) if n_chunks == 2 else Placement.linear(p, n_chunks)
    with FakeTensorMode():
        stacked, shared = init_params(cfg, spec, placement, device="cpu")
        per_stage = _strip_stage_axis(stacked)
        # one leaf-byte rule for the planner and the executor's accounting
        params = float(PipelineExecutor._tree_bytes(per_stage) + PipelineExecutor._tree_bytes(shared))
        optim = zero1_state_bytes(per_stage, dp_size) + zero1_state_bytes(shared, dp_size)
        params_card = float(PipelineExecutor._tree_bytes((stacked, shared)))
        optim_card = float(8 * sum(t.numel() for t in tree_leaves((stacked, shared))))
        acc_card, acc = PipelineExecutor.accumulator_bytes(stacked, shared)
    tr = optimizer_transient_bytes(stacked, shared)
    return StateBytes(params=params, optim=optim, acc=float(acc), transient=float(max(tr.per_stage)),
                      params_card=params_card, optim_card=optim_card, acc_card=float(acc_card),
                      transient_card=float(tr.one_card))


def optimizer_charge(transient: float, walk: float, overhang: float, reuse: float) -> float:
    """What the optimizer's transient adds on top of a walk of ``walk``
    bytes: the ``overhang`` share of the transient, and at least what the
    transient exceeds the ``reuse`` share of the walk by (the blocks the
    walk freed that the transient's requests fit; none under the graph
    executor, whose pool the walk keeps)."""
    return max(overhang * transient, transient - (reuse * walk if reuse else 0.0))


@dataclasses.dataclass(frozen=True)
class OneCardBytes:
    """What one card holding all p stages needs for a plan, by part."""

    weights: float  # every stage's parameters and AdamW moments, shared leaves once
    accumulators: float
    walk: float  # act + wctx + inbox + sink of all stages at the worst tick
    remainder: float  # the calibrated remainder, all p devices' shares
    transient: float  # the stage-by-stage optimizer loop's transient
    overhang: float  # the share of it the card holds on top of the walk, at least
    reuse: float  # the share of the walk it may reuse, at most
    executor_mode: str

    @property
    def optimizer(self) -> float:
        return optimizer_charge(self.transient, self.walk, self.overhang, self.reuse)

    @property
    def total(self) -> float:
        return self.weights + self.accumulators + self.walk + self.remainder + self.optimizer

    def report(self) -> str:
        g = 2**30
        return (f"{self.total / g:.2f} GiB = weights and moments {self.weights / g:.2f} + "
                f"accumulators {self.accumulators / g:.2f} + walk {self.walk / g:.2f} + "
                f"remainder {self.remainder / g:.2f} + optimizer {self.optimizer / g:.2f} "
                f"(its {self.transient / g:.2f} transient: overhang {self.overhang:.3f}, reuse "
                f"{self.reuse:.3f} of the walk; {self.executor_mode})")


def stage_program_factory(cfg, p: int, m: int, microbatch: int, seq_len: int, device,
                          seed: int = 0) -> Callable:
    """``program_factory`` of the measured fidelity on ``device``: for
    ``n_chunks`` chunks a stage, the port's program, one stage's parameters
    (stage 0 of ``init_params(seed)``) and synthetic side inputs.  The
    full stacked parameters exist on ``device`` only while stage 0 is
    copied out."""

    def factory(n_chunks: int):
        placement = Placement.vshape(p) if n_chunks == 2 else Placement.linear(p, n_chunks)
        spec = RunSpec(p=p, n_chunks=n_chunks, microbatch=microbatch, seq_len=seq_len, m=m)
        stacked, shared = init_params(cfg, spec, placement, seed=seed, device=device)
        stage0 = tuple(tree_map(lambda a: a[0].clone(), c) for c in stacked)
        del stacked
        side = tree_map(lambda a: torch.as_tensor(a, device=device), side_inputs(cfg, spec))
        return build_program(cfg, spec, placement), stage0, shared, side

    return factory


# --------------------------------------------------------------------- #
# the planner
# --------------------------------------------------------------------- #
class HBMPlanner:
    """Search all schedule families under a per-device HBM byte budget.

    Stateful on purpose: the static family is evaluated once, and
    budget-implied searches (greedy grid, v_flex portfolio) accumulate across
    ``plan()`` calls so an ascending budget sweep never loses a cheaper plan.

    A ``program_factory(n_chunks) -> (program, stage_params, shared,
    side_all)`` selects the measured fidelity: it supplies the program on
    the device to measure on (``stage_params``: one stage's parameters per
    chunk; :func:`stage_program_factory` builds it).  Without one the
    planner prices with the byte model.

    ``temp_bytes=None`` charges the accumulators, the optimizer's transient
    and the calibrated remainder of ``executor_mode`` (the module's
    ``temp``); a number replaces that whole term.
    """

    def __init__(self, cfg, p: int, m: int, microbatch: int, seq_len: int,
                 times: Optional[TimeModel] = None, tp_size: int = 1, dp_size: int = 1,
                 program_factory: Optional[Callable] = None, temp_bytes: Optional[float] = None,
                 executor_mode: str = "eager"):
        if executor_mode not in EXECUTOR_MODES:
            raise ValueError(f"unknown executor_mode {executor_mode!r}")
        self.executor_mode = executor_mode
        self.temp_bytes = None if temp_bytes is None else float(temp_bytes)
        self.cfg = cfg
        self.p = p
        self.m = m
        self.microbatch = microbatch
        self.seq_len = seq_len
        self.times = times or TimeModel.unit()
        self.tp_size = tp_size
        self.dp_size = dp_size
        self.measured = program_factory is not None
        self.program_factory = program_factory
        self.bytes_1c = ActivationByteModel.from_config(cfg, microbatch, seq_len, p, n_chunks=1,
                                                        tp_size=tp_size)
        self.bytes_2c = ActivationByteModel.from_config(cfg, microbatch, seq_len, p, n_chunks=2,
                                                        tp_size=tp_size)
        self._static: Optional[List[PipelinePlan]] = None
        self._dynamic: Dict[str, PipelinePlan] = {}
        self._slots: Dict[int, Tuple] = {}
        # which calibration record prices the run: the one of its depth
        self._depth = dict(layers=cfg.n_layers, p=p)

    # -- fixed (schedule-independent) state ---------------------------- #
    def state(self, n_chunks: int) -> StateBytes:
        if self.tp_size != 1:
            raise NotImplementedError("tensor parallelism is not ported to repro_torch yet")
        return state_bytes(self.cfg, self.p, n_chunks, self.dp_size)

    def fixed_bytes(self, n_chunks: int) -> Tuple[float, float]:
        st = self.state(n_chunks)
        return st.params, st.optim

    # -- the temp term --------------------------------------------------- #
    def temp(self, n_chunks: int, schedule_bytes: float) -> Tuple[float, Tuple[float, ...]]:
        """(temp, its parts) per device for a candidate whose slots hold
        ``schedule_bytes``: accumulators + the optimizer's charge
        (:func:`optimizer_charge` of a device's transient) + the calibrated
        remainder; or ``temp_bytes`` alone."""
        if self.temp_bytes is not None:
            return self.temp_bytes, ()
        st = self.state(n_chunks)
        optim = optimizer_charge(st.transient, schedule_bytes,
                                 *cuda_optimizer_shares(self.cfg.name, self.executor_mode,
                                                        **self._depth))
        parts = (st.acc, optim, self.remainder())
        return sum(parts), parts

    def remainder(self, executor_mode: Optional[str] = None) -> float:
        """A device's share of the calibrated CUDA remainder under
        ``executor_mode`` (default: the planner's), scaled to this run's
        M_B unit and weights (``core/memory.py::default_cuda_temp_bytes``)."""
        st = self.state(1)
        return default_cuda_temp_bytes(self.cfg.name, executor_mode or self.executor_mode,
                                       m_b_bytes=self.bytes_1c.m_b_bytes,
                                       weights_bytes=st.params_card + st.optim_card,
                                       **self._depth)

    def _temp_floor(self, n_chunks: int) -> float:
        """The temp that no candidate escapes, whatever its slots hold."""
        return self.temp(n_chunks, _INF)[0] if self.temp_bytes is None else self.temp_bytes

    # -- measured fidelity: one measurement per chunk count -------------- #
    # Keyed on n_chunks alone: the chunk modules, the sink and every slot's
    # bytes depend on (cfg, p, n_chunks), not on the placement or the plan.
    def slot_bytes(self, n_chunks: int):
        """(program, measured per-slot bytes) for ``n_chunks`` chunks a stage."""
        if self.program_factory is None:
            raise ValueError("the measured fidelity needs a program_factory on the run's device")
        if n_chunks not in self._slots:
            prog, sp, shared, side = self.program_factory(n_chunks)
            self._slots[n_chunks] = (prog, slot_bytes(prog, sp, shared, side))
        return self._slots[n_chunks]

    # -- analytic inbox/sink estimates (model fidelity) ------------------ #
    def _act_msg_bytes(self) -> float:
        """A channel message: the front's positions (vlm patches, encdec
        frames) ride ahead of the tokens, as the JAX planner counts them."""
        dtype_bytes = self.bytes_1c.dtype_bytes or 4
        s_total = front_len(self.cfg) + self.seq_len
        return float(self.microbatch * s_total * self.cfg.d_model * dtype_bytes)

    def _sink_slot_bytes(self) -> Tuple[float, float]:
        """(sink residual, sink W-context) rough per-slot estimate: the
        normed activations plus tp-sharded logits at the loss position."""
        cfg = self.cfg
        tokens = self.microbatch * self.seq_len
        dtype_bytes = self.bytes_1c.dtype_bytes or 4
        res = tokens * (2 * cfg.d_model * dtype_bytes + cfg.vocab / max(1, self.tp_size) * dtype_bytes)
        wctx = tokens * 2 * cfg.d_model * dtype_bytes
        return float(res), float(wctx)

    # -- candidate evaluation -------------------------------------------- #
    def _evaluate(self, name: str, build: Callable[[], Schedule], n_chunks: int,
                  grouped_w: bool = False, note: str = "") -> PipelinePlan:
        byte_model = self.bytes_1c if n_chunks == 1 else self.bytes_2c
        try:
            sched = build()
        except (ValueError, RuntimeError) as e:
            return PipelinePlan(name, None, None, byte_model, _INF, 1.0, None, False,
                                note=f"build failed: {e}")
        sched.name = name  # the plan's unique name (e.g. "zb-auto@8.0Mb")
        times = dataclasses.replace(self.times, grouped_w=True) if grouped_w else self.times
        res = simulate(sched, times)
        params, optim = self.fixed_bytes(sched.n_chunks)
        ep = compile_plan(sched)
        if self.measured:
            prog, slots = self.slot_bytes(sched.n_chunks)
            bb = PipelineExecutor(prog, ep).buffer_bytes(slots=slots)
            act_b, wctx_b = bb["res"], bb["wctx"]
            inbox_b = bb["inbox"]
            sink_b = bb["sink"] + bb["sink_wctx"]
        else:
            tl = memory_timeline(sched, times, m_b=1.0, m_w=1.0)
            act_b = float(tl.peak_act.max()) * byte_model.m_b_bytes
            wctx_b = float(tl.peak_wctx.max()) * byte_model.m_w_bytes
            inbox_b = ep.inbox_slot_total() * self._act_msg_bytes()
            sink_res, sink_wctx = self._sink_slot_bytes()
            sink_b = ep.n_sink_slots * sink_res + ep.n_sink_wctx_slots * sink_wctx
        temp, parts = self.temp(sched.n_chunks, act_b + wctx_b + inbox_b + sink_b)
        breakdown = HBMBreakdown(params=params, optim=optim, act=float(act_b),
                                 wctx=float(wctx_b), inbox=float(inbox_b), sink=float(sink_b),
                                 temp=float(temp), temp_parts=parts)
        return PipelinePlan(name=name, schedule=sched, placement=sched.placement,
                            byte_model=byte_model, cost=res.cost, bubble_rate=res.bubble_rate,
                            breakdown=breakdown, fits=True, note=note)

    # -- family enumeration ---------------------------------------------- #
    def _static_plans(self) -> List[PipelinePlan]:
        p, m = self.p, self.m
        if self._static is None:
            cands = [
                self._evaluate("1f1b", lambda: one_f_one_b(p, m), 1, grouped_w=True,
                               note="fused backward"),
                self._evaluate("zb-h1", lambda: zb_h1(p, m), 1),
                self._evaluate("zb-h2", lambda: zb_h2(p, m), 1),
                self._evaluate("zb-v", lambda: zb_v(p, m, times=self.times), 2),
                self._evaluate("v-half", lambda: v_half(p, m, times=self.times), 2),
                self._evaluate("v-min", lambda: v_min(p, m, times=self.times), 2),
            ]
            if m % p == 0:
                cands.append(self._evaluate("1f1b-interleaved", lambda: interleaved_1f1b(p, m, v=2),
                                            2, grouped_w=True, note="fused backward"))
            self._static = cands
        return self._static

    def _budget_limit_units(self, budget_bytes: float, n_chunks: int) -> float:
        """Budget-implied schedule-memory limit in full-stage M_B units."""
        byte_model = self.bytes_1c if n_chunks == 1 else self.bytes_2c
        if byte_model.m_b_bytes <= 0:
            return 0.0
        params, optim = self.fixed_bytes(n_chunks)
        avail = budget_bytes - params - optim - self._temp_floor(n_chunks)
        if not math.isfinite(avail):
            return _LIMIT_CAP_FACTOR * self.p
        limit = round(avail / byte_model.m_b_bytes, 1)
        return min(limit, _LIMIT_CAP_FACTOR * self.p)

    def _seed_one_search(self, budget_bytes: float, n_chunks: int, prefix: str, placement,
                         note: str) -> None:
        """Seed a budget-implied search, tightening the limit when the seeded
        candidate's inbox + sink overshoot the budget (bounded retries), so a
        plan just inside the boundary is not missed."""
        p, m = self.p, self.m
        byte_model = self.bytes_1c if n_chunks == 1 else self.bytes_2c
        lim = self._budget_limit_units(budget_bytes, n_chunks)
        for _ in range(3):
            if lim < 1.0:
                return
            name = f"{prefix}@{lim:.1f}Mb"
            if name not in self._dynamic:
                lim_now = lim
                self._dynamic[name] = self._evaluate(
                    name,
                    lambda: search(p, m, self.times, m_limit=lim_now, placement=placement).schedule,
                    n_chunks,
                    note=note,
                )
            cand = self._dynamic[name]
            if cand.schedule is None or cand.total_bytes <= budget_bytes:
                return
            if byte_model.m_b_bytes <= 0 or not math.isfinite(budget_bytes):
                return
            overhead = cand.total_bytes - cand.breakdown.act
            retry = round((budget_bytes - overhead) / byte_model.m_b_bytes - 0.05, 1)
            if retry >= lim:  # no progress possible
                return
            lim = retry

    def _seed_budget_searches(self, budget_bytes: float) -> None:
        self._seed_one_search(budget_bytes, 1, "zb-auto", None,
                              note="Sec.-3.1 heuristic at the budget-implied limit")
        self._seed_one_search(budget_bytes, 2, "v-flex", "v_flex",
                              note="v_flex portfolio at the budget-implied limit")

    def candidates(self, budget_bytes: Optional[float] = None) -> List[PipelinePlan]:
        """The full family (cached) plus cumulative budget-tuned searches."""
        if budget_bytes is not None:
            self._seed_budget_searches(budget_bytes)
        return list(self._static_plans()) + list(self._dynamic.values())

    # -- one card holding all p stages ---------------------------------- #
    def one_card_bytes(self, schedule: Schedule,
                       executor_mode: Optional[str] = None) -> OneCardBytes:
        """What one card holding all p stages needs to train ``schedule``
        under ``executor_mode`` (default: the planner's): every stage's
        weights, moments and accumulators once (the shared leaves once), the
        walk's act + wctx + inbox + sink summed over the stages at its worst
        tick (the measured slots, or the byte model's without a
        ``program_factory``), the optimizer's charge
        (:func:`optimizer_charge`) for its transient over the
        stage-by-stage loop, and p devices' shares of that mode's remainder
        (p times ``temp_bytes`` when that is given)."""
        mode = executor_mode or self.executor_mode
        if mode not in EXECUTOR_MODES:
            raise ValueError(f"unknown executor_mode {mode!r}")
        C = schedule.n_chunks
        if self.measured:
            prog, slots = self.slot_bytes(C)
        else:
            bm = self.bytes_1c if C == 1 else self.bytes_2c
            sink_res, sink_wctx = self._sink_slot_bytes()
            spec = RunSpec(p=self.p, n_chunks=C, microbatch=self.microbatch,
                           seq_len=self.seq_len, m=self.m)
            prog = build_program(self.cfg, spec, schedule.placement)
            slots = dict(res=(bm.m_b_bytes / C,) * C, wctx=(bm.m_w_bytes / C,) * C,
                         sink=sink_res, sink_wctx=sink_wctx, res_wctx_shared=(0.0,) * C,
                         sink_shared=0.0)
        mt = measured_timeline(PipelineExecutor(prog, compile_plan(schedule)), slots=slots)
        walk = float((mt.act_bytes + mt.wctx_bytes + mt.inbox_bytes + mt.sink_bytes)
                     .sum(axis=0).max())
        st = self.state(C)
        if self.temp_bytes is not None:
            return OneCardBytes(st.params_card + st.optim_card, 0.0, walk,
                                self.p * self.temp_bytes, 0.0, 0.0, 0.0, mode)
        return OneCardBytes(st.params_card + st.optim_card, st.acc_card, walk,
                            self.p * self.remainder(mode),
                            st.transient_card,
                            *cuda_optimizer_shares(self.cfg.name, mode, **self._depth), mode)

    # -- the decision ----------------------------------------------------- #
    def plan(self, budget_bytes: float) -> PlanReport:
        plans = []
        for c in self.candidates(budget_bytes):
            if c.schedule is None:
                plans.append(c)
                continue
            plans.append(dataclasses.replace(c, fits=c.total_bytes <= budget_bytes))
        feasible = [c for c in plans if c.fits and c.schedule is not None]
        finite = [c for c in plans if c.schedule is not None]
        min_required = min((c.total_bytes for c in finite), default=_INF)
        if not feasible:
            return PlanReport(budget_bytes=budget_bytes, feasible=False, chosen=None, plans=plans,
                              min_required_bytes=min_required, planner=self)
        best = min(feasible, key=lambda c: (c.cost, c.total_bytes))
        return PlanReport(budget_bytes=budget_bytes, feasible=True, chosen=best, plans=plans,
                          min_required_bytes=min_required, planner=self)


# --------------------------------------------------------------------- #
# the single entry point
# --------------------------------------------------------------------- #
def plan(config, p: int, m: int, times: Optional[TimeModel] = None,
         hbm_budget_bytes: float = _INF, *, microbatch: int = 1, seq_len: int = 2048,
         tp_size: int = 1, dp_size: int = 1, temp_bytes: Optional[float] = None,
         executor_mode: str = "eager") -> PlanReport:
    """Pick the fastest schedule (across every family) that fits the budget.

    Returns a :class:`PlanReport`; on infeasibility ``report.feasible`` is
    False and ``report.infeasibility_report()`` itemizes the cheapest plan's
    breakdown, naming the binding term.  The model fidelity prices
    act/wctx/inbox/sink; ``temp_bytes`` and ``executor_mode`` set the temp
    term as :class:`HBMPlanner`'s do.  For the measured fidelity, and for
    budget sweeps, use one :class:`HBMPlanner` and call its ``.plan`` per
    point: its cumulative search pool keeps the cost-vs-budget frontier
    monotone.
    """
    planner = HBMPlanner(config, p=p, m=m, microbatch=microbatch, seq_len=seq_len,
                         times=times or TimeModel.unit(), tp_size=tp_size, dp_size=dp_size,
                         temp_bytes=temp_bytes, executor_mode=executor_mode)
    return planner.plan(hbm_budget_bytes)


# --------------------------------------------------------------------- #
# unit-space family search (straggler replanning)
# --------------------------------------------------------------------- #
def fastest_under_profile(p: int, m: int, times: TimeModel, m_limit: float, m_b: float = 1.0,
                          m_w: float = 0.5) -> Tuple[Schedule, float]:
    """Cheapest schedule across all families under a unit memory limit.

    The byte-free counterpart of :meth:`HBMPlanner.plan` for straggler
    replanning: candidates are filtered by the op-count memory profile in
    (M_B, M_W) units.  Two searches cover every family: the linear grid
    (with the ZB-H1/H2 portfolio) and the V grid with the ``v_flex``
    portfolio (with ZB-V and the stable V-Min/V-Half patterns).  Returns
    (schedule, simulated cost).
    """
    best: Optional[Tuple[float, Schedule]] = None

    def consider(sched: Schedule) -> None:
        nonlocal best
        C = sched.n_chunks
        peak = sched.memory_profile(m_b / C, m_w / C).max_peak
        if peak > m_limit + 1e-9:
            return
        try:
            cost = simulate(sched, times).cost
        except (ValueError, RuntimeError):
            return
        if best is None or cost < best[0]:
            best = (cost, sched)

    for placement in (None, "v_flex"):
        try:
            consider(search(p, m, times, m_limit=m_limit, m_b=m_b, m_w=m_w,
                            placement=placement).schedule)
        except RuntimeError:
            pass
    if best is None:
        raise RuntimeError(f"no schedule fits the unit memory limit {m_limit} (p={p}, m={m})")
    return best[1], best[0]
