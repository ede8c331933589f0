"""The port's HBM planner (``repro_torch.core.planner``) against the JAX
package's.

* ``HBMPlanner.plan`` over an ascending budget sweep on the reduced
  internlm2 at p=4, m=8, model fidelity, both sides with no temp term
  (``temp_bytes=0.0`` in the port, ``xla_temp_bytes=0.0`` in the JAX
  package; ``tests/test_torch_temp_term.py`` holds them with the same
  non-zero temp): the same candidates, the same feasible set and chosen
  names, costs and breakdown items equal to 1e-9 relative; infeasible
  points name the same binding term.  ``plan()`` answers as
  ``HBMPlanner.plan`` does, the default temp term included.
* ``fixed_state_bytes`` (the port's ``init_params`` shape-evaluated) equals
  the JAX package's for one and two chunks and several dp sizes; tensor
  parallelism raises.
* ``fastest_under_profile`` picks the JAX package's schedule at the same
  cost.
* Measured fidelity on the reduced model: every candidate's act, wctx,
  inbox and sink are the plan's slot counts times the bytes ``slot_bytes``
  measures, and the cost-vs-budget frontier stays monotone; without a
  ``program_factory`` there is no measured fidelity.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

import numpy as np  # noqa: E402

from repro.configs import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.planner import HBMPlanner as JaxHBMPlanner  # noqa: E402
from repro.core.planner import fastest_under_profile as jax_fastest  # noqa: E402
from repro.core.planner import fixed_state_bytes as jax_fixed_state_bytes  # noqa: E402
from repro.core.simulator import TimeModel as JaxTimeModel  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.executor import PipelineExecutor  # noqa: E402
from repro_torch.core.planner import (HBMPlanner, fastest_under_profile, fixed_state_bytes,  # noqa: E402
                                      plan, stage_program_factory)
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.simulator import TimeModel  # noqa: E402
from test_torch_train_plan import _no_stored_plans  # noqa: E402,F401

ARCH = "internlm2_1_8b"
P, M = 4, 8
RUN = dict(microbatch=2, seq_len=32)
ITEMS = ("params", "optim", "act", "wctx", "inbox", "sink")


def _planners(temp=0.0):
    return (HBMPlanner(get_reduced(ARCH), p=P, m=M, temp_bytes=temp, **RUN),
            JaxHBMPlanner(jax_get_reduced(ARCH), p=P, m=M, xla_temp_bytes=temp, **RUN))


def _same_plans(mine, ref, temp=0.0):
    by_name = {pp.name: pp for pp in ref}
    assert [pp.name for pp in mine] == [pp.name for pp in ref]
    for a in mine:
        b = by_name[a.name]
        assert a.fits == b.fits, a.name
        if b.schedule is None:
            assert a.schedule is None
            continue
        assert (a.cost, a.bubble_rate) == (b.cost, b.bubble_rate), a.name
        ia, ib = a.breakdown.items(), b.breakdown.items()
        for k in ITEMS:
            assert ia[k] == pytest.approx(ib[k], rel=1e-9, abs=0.0), (a.name, k)
        assert ia["temp"] == ib["xla_temp"] == temp


def budget_sweep_matches_jax(temp):
    """The sweep of the module docstring, both planners charging ``temp``."""
    mine, ref = _planners(temp)
    totals = sorted(c.total_bytes for c in ref.candidates() if c.schedule is not None)
    lo, hi = 0.5 * totals[0], 1.1 * totals[-1]
    budgets = [lo + (hi - lo) * i / 4 for i in range(5)]
    seen, prev_cost = set(), None
    for b in budgets:
        rm, rj = mine.plan(b), ref.plan(b)
        assert rm.feasible == rj.feasible
        assert rm.min_required_bytes == pytest.approx(rj.min_required_bytes, rel=1e-9)
        _same_plans(rm.plans, rj.plans, temp)
        seen.add(rm.feasible)
        if rm.feasible:
            assert rm.chosen.name == rj.chosen.name and rm.chosen.cost == rj.chosen.cost
            assert rm.chosen.total_bytes <= b
            assert prev_cost is None or rm.chosen.cost <= prev_cost
            prev_cost = rm.chosen.cost
            assert rm.summary().split(" -> ")[1].split(" (")[0] == rj.chosen.name
        else:
            binding = min((pp for pp in rm.plans if pp.schedule is not None),
                          key=lambda pp: pp.total_bytes).breakdown.binding_term()
            assert f"binding term: {binding}" in rm.infeasibility_report()
            assert f"binding term: {binding}" in rj.infeasibility_report()
    assert seen == {True, False}
    # every family was priced, as in the JAX planner
    names = {pp.name for pp in mine.plan(math.inf).plans}
    assert {"1f1b", "zb-h1", "zb-h2", "zb-v", "v-half", "v-min", "1f1b-interleaved"} <= names


def test_budget_sweep_matches_jax():
    budget_sweep_matches_jax(0.0)


def test_plan_entry_point_and_adapter_agree():
    b = 3 * 2**20
    got = plan(get_reduced(ARCH), P, M, hbm_budget_bytes=b, **RUN)
    ref = HBMPlanner(get_reduced(ARCH), p=P, m=M, **RUN).plan(b)
    assert got.feasible and ref.feasible
    assert got.chosen.breakdown.temp == ref.chosen.breakdown.temp > 0
    assert (ref.chosen.name, ref.chosen.total_bytes) == (got.chosen.name, got.chosen.total_bytes)
    assert got.chosen.breakdown.items() == ref.chosen.breakdown.items()
    tiny = plan(get_reduced(ARCH), P, M, hbm_budget_bytes=1.0, **RUN)
    assert not tiny.feasible and "binding term:" in tiny.infeasibility_report()


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_fixed_state_bytes_matches_jax(n_chunks):
    for p, dp in ((4, 1), (4, 3), (3, 8)):
        assert fixed_state_bytes(get_reduced(ARCH), p, n_chunks, dp_size=dp) == \
            jax_fixed_state_bytes(jax_get_reduced(ARCH), p, n_chunks, dp_size=dp)
    with pytest.raises(NotImplementedError):
        fixed_state_bytes(get_reduced(ARCH), 4, n_chunks, tp_size=2)


@pytest.mark.parametrize("limit", [4.0, 8.0])
def test_fastest_under_profile_matches_jax(limit):
    times = (1.0, 1.0, 1.0, 0.0)
    for scale in (None, (1.0, 1.4, 1.0, 1.0)):
        sched, cost = fastest_under_profile(P, M, TimeModel(*times, stage_scale=scale), limit)
        ref, ref_cost = jax_fastest(P, M, JaxTimeModel(*times, stage_scale=scale), limit)
        assert (sched.name, cost) == (ref.name, ref_cost)
        assert [[(int(o.kind), o.mb, o.chunk) for o in ops] for ops in sched.stage_ops] == \
            [[(int(o.kind), o.mb, o.chunk) for o in ops] for ops in ref.stage_ops]


def test_measured_fidelity_prices_measured_slots():
    cfg = dataclasses.replace(get_reduced(ARCH), n_layers=2 * P)
    model = HBMPlanner(cfg, p=P, m=M, **RUN)
    assert not model.measured
    with pytest.raises(ValueError, match="program_factory"):
        model.slot_bytes(1)
    planner = HBMPlanner(cfg, p=P, m=M, **RUN, program_factory=stage_program_factory(
        cfg, P, M, RUN["microbatch"], RUN["seq_len"], "cpu"))
    assert planner.measured
    report = planner.plan(math.inf)
    assert report.feasible
    checked = 0
    for pp in report.plans:
        if pp.schedule is None:
            continue
        prog, slots = planner.slot_bytes(pp.schedule.n_chunks)
        bb = PipelineExecutor(prog, compile_plan(pp.schedule)).buffer_bytes(slots=slots)
        bd = pp.breakdown
        assert (bd.act, bd.wctx, bd.inbox, bd.sink) == \
            (bb["res"], bb["wctx"], bb["inbox"], bb["sink"] + bb["sink_wctx"])
        assert bd.params + bd.optim == sum(planner.fixed_bytes(pp.schedule.n_chunks))
        checked += 1
    assert checked >= 7
    # a per-slot measurement is made once per chunk count
    assert sorted(planner._slots) == [1, 2]
    # the measured frontier is monotone too
    totals = sorted(pp.total_bytes for pp in report.plans if pp.schedule is not None)
    prev = None
    for b in np.linspace(0.6 * totals[0], 1.1 * totals[-1], 6):
        r = planner.plan(float(b))
        if r.feasible:
            assert prev is None or r.chosen.cost <= prev
            prev = r.chosen.cost
