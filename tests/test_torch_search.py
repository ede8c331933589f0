"""The port's automatic schedule search is the JAX package's.

The paper's Table-5 rows with p <= 16 (profiled T_F, T_B, T_W, T_comm;
copied from ``tests/test_schedules.py``): ``search`` at the ZB-1p and ZB-2p
memory limits gives the same schedule, cost, bubble rate and winning
heuristic configuration as the reference's.  The search's other modes --
the V placement and the ``v_flex`` portfolio mode -- agree too, and their
results honour the memory limit.  Host-only Python on both sides, so the
comparisons are exact; the ``(32, 96)`` row stays out (a minute per search).
The JAX package's plan cache is off and both ``v_flex`` memos cleared
(``test_torch_train_plan._no_stored_plans``).
"""

import pytest

pytest.importorskip("torch")

import repro.core.schedules as J  # noqa: E402
from repro.core.simulator import TimeModel as JaxTimeModel  # noqa: E402
from repro.core.simulator import simulate as jax_simulate  # noqa: E402

import repro_torch.core.schedules as T  # noqa: E402
from repro_torch.core.simulator import TimeModel, simulate  # noqa: E402
from test_torch_train_plan import _no_stored_plans, _ops  # noqa: E402,F401

TABLE5 = [
    # p, m, TF, TB, TW, Tc, rates: (1f1b, zb-h1, zb-h2, zb-1p, zb-2p)
    (8, 24, 18.522, 18.086, 9.337, 0.601, (0.2431, 0.1585, 0.1083, 0.1585, 0.0433)),
    (8, 32, 18.513, 18.086, 9.331, 0.626, (0.1985, 0.1242, 0.0837, 0.1242, 0.0039)),
    (8, 64, 18.546, 18.097, 9.321, 0.762, (0.1240, 0.0674, 0.0444, 0.0674, 0.0026)),
    (8, 24, 29.718, 29.444, 19.927, 0.527, (0.2347, 0.1323, 0.0698, 0.1323, 0.0029)),
    (16, 48, 11.347, 11.248, 8.132, 0.377, (0.2552, 0.1397, 0.0672, 0.1397, 0.0066)),
]


def assert_same_result(mine, ref):
    assert _ops(mine.schedule) == _ops(ref.schedule)
    assert mine.schedule.name == ref.schedule.name
    assert mine.schedule.placement.stage_seq == ref.schedule.placement.stage_seq
    assert (mine.cost, mine.bubble_rate) == (ref.cost, ref.bubble_rate)
    assert vars(mine.config) == vars(ref.config)


@pytest.mark.parametrize("limit", ["1p", "2p"])
@pytest.mark.parametrize("p,m,tf,tb,tw,tc,rates", TABLE5)
def test_table5_search_matches_jax(p, m, tf, tb, tw, tc, rates, limit):
    m_limit = float(p) * (1 if limit == "1p" else 2)
    mine = T.search(p, m, TimeModel(tf, tb, tw, tc), m_limit=m_limit)
    ref = J.search(p, m, JaxTimeModel(tf, tb, tw, tc), m_limit=m_limit)
    assert_same_result(mine, ref)
    # and the paper's rate, within the tolerances tests/test_schedules.py holds
    want = rates[3] if limit == "1p" else rates[4]
    assert mine.bubble_rate == pytest.approx(want, abs=2e-4 if limit == "1p" else 2e-3)


@pytest.mark.parametrize("p,m,tf,tb,tw,tc,rates", TABLE5[:1] + TABLE5[4:])
def test_table5_baselines_match_jax(p, m, tf, tb, tw, tc, rates):
    """1F1B under the fused-backward model and ZB-H1/ZB-H2: the rows' rates."""
    for builder, grouped, rate in (("one_f_one_b", True, rates[0]), ("zb_h1", False, rates[1]),
                                   ("zb_h2", False, rates[2])):
        a = simulate(getattr(T, builder)(p, m), TimeModel(tf, tb, tw, tc, grouped_w=grouped))
        b = jax_simulate(getattr(J, builder)(p, m),
                         JaxTimeModel(tf, tb, tw, tc, grouped_w=grouped))
        assert (a.cost, a.bubble_rate) == (b.cost, b.bubble_rate)
        assert a.bubble_rate == pytest.approx(rate, abs=2e-4)


MODES = {
    "vshape": lambda mod, p: dict(placement=mod.Placement.vshape(p)),
    "v_flex": lambda mod, p: dict(placement="v_flex"),
}


MODE_CASES = [(mode, p, m, limit) for mode in MODES
              for p, m, limit in ((4, 8, 4.0), (4, 8, 6.0), (3, 4, 3.0))]
MODE_CASES += [("vshape", 6, 12, 6.0), ("v_flex", 6, 12, 6.0)]


@pytest.mark.parametrize("mode,p,m,limit", MODE_CASES)
def test_search_modes_match_jax(mode, p, m, limit):
    times = (1.0, 1.2, 0.9, 0.1)
    mine = T.search(p, m, TimeModel(*times), m_limit=limit, name="auto", **MODES[mode](T, p))
    ref = J.search(p, m, JaxTimeModel(*times), m_limit=limit, name="auto", **MODES[mode](J, p))
    assert_same_result(mine, ref)
    sched = mine.schedule
    peak = sched.memory_profile(1.0 / sched.n_chunks, 0.5 / sched.n_chunks).max_peak
    assert peak <= limit + 1e-9


def test_zb_1p_2p_and_zb_v_pass_times_and_limits_through():
    times_t, times_j = TimeModel(1.0, 1.5, 0.5, 0.05), JaxTimeModel(1.0, 1.5, 0.5, 0.05)
    assert _ops(T.zb_1p(4, 8, times_t)) == _ops(J.zb_1p(4, 8, times_j))
    assert _ops(T.zb_2p(4, 8, times_t)) == _ops(J.zb_2p(4, 8, times_j))
    assert _ops(T.zb_v(4, 8, times_t, m_limit=6.0)) == _ops(J.zb_v(4, 8, times_j, m_limit=6.0))
    # a limit no greedy candidate meets: ZB-V falls back to the handcrafted order
    low_t, low_j = T.zb_v(4, 8, m_limit=0.5), J.zb_v(4, 8, m_limit=0.5)
    assert _ops(low_t) == _ops(low_j) == _ops(T.zb_v_handcrafted(4, 8))
