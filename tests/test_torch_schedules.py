"""The port's schedule layer is the JAX package's, exactly.

Every builder of ``repro_torch.core.schedules`` -- ZB-V (searched and
handcrafted), V-Min, V-Half, the stable-pattern V schedules, ``v_flex`` at
two limits, interleaved 1F1B, ZB-1p, ZB-2p and one greedy configuration on
each placement -- gives the JAX package's op list on every stage, the same tick assignment and
every ``compile_plan`` table equal array for array, over a (p, m) grid with
p in {2, 3, 4, 6}, a few m < 2p and one p=8 case.  Where the JAX builder
raises, the port raises the same exception type.  The simulator's costs
(under the unit model and under a non-unit model with ``t_comm > 0``) and
``memory_profile`` are equal too, and a memoized ``v_flex`` equals a fresh
search.  Host-only Python on both sides, so every comparison is exact.

The JAX package's on-disk plan cache is off here and both packages'
in-process ``v_flex`` memos cleared (``test_torch_train_plan._no_stored_plans``),
so no stored plan can stand in for a search.
"""

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.schedules as J  # noqa: E402
import repro.core.schedules.vflex as jax_vflex  # noqa: E402
from repro.core.simulator import TimeModel as JaxTimeModel  # noqa: E402
from repro.core.simulator import simulate as jax_simulate  # noqa: E402

import repro_torch.core.schedules as T  # noqa: E402
import repro_torch.core.schedules.vflex as vflex  # noqa: E402
from repro_torch.core.simulator import TimeModel, bubble_rate, simulate  # noqa: E402
from test_torch_train_plan import _no_stored_plans, _ops, assert_same_plan  # noqa: E402,F401

GRID = [(2, 2), (2, 3), (2, 4), (3, 2), (3, 4), (3, 6), (4, 4), (4, 6), (4, 8), (6, 5),
        (6, 12), (8, 16)]
# (t_f, t_b, t_w, t_comm): the unit model and one with unequal passes and a p2p latency
TIMES = {"unit": (1.0, 1.0, 1.0, 0.0), "skewed": (1.0, 1.3, 0.7, 0.15)}


def _greedy(mod, p, m, vshape):
    times = (TimeModel if mod is T else JaxTimeModel)(1.0, 1.2, 0.8, 0.1)
    cfg = mod.GreedyConfig(m_limit=float(p), warmup_extra_f=False, drain_strict_w=True)
    placement = mod.Placement.vshape(p) if vshape else None
    return mod.greedy_schedule(p, m, times, cfg, placement)


# name -> builder(module, p, m): the same call on either package
BUILDERS = {
    "zb-v": lambda mod, p, m: mod.zb_v(p, m),
    "zb-v-handcrafted": lambda mod, p, m: mod.zb_v_handcrafted(p, m),
    "v-min": lambda mod, p, m: mod.v_min(p, m),
    "v-half": lambda mod, p, m: mod.v_half(p, m),
    "stable-v-min": lambda mod, p, m: mod.stable_v_schedule(p, m, "v-min"),
    "stable-v-half": lambda mod, p, m: mod.stable_v_schedule(p, m, "v-half"),
    "v-flex-2": lambda mod, p, m: mod.v_flex(p, m, 2.0),
    "v-flex-p": lambda mod, p, m: mod.v_flex(p, m, float(p)),
    "interleaved": lambda mod, p, m: mod.interleaved_1f1b(p, m),
    "zb-1p": lambda mod, p, m: mod.zb_1p(p, m),
    "zb-2p": lambda mod, p, m: mod.zb_2p(p, m),
    "greedy-linear": lambda mod, p, m: _greedy(mod, p, m, vshape=False),
    "greedy-v": lambda mod, p, m: _greedy(mod, p, m, vshape=True),
}


def _keyed(d):
    """{(stage, Op): v} -> {(stage, (kind, mb, chunk)): v}, comparable across packages."""
    return {(s, (int(o.kind), o.mb, o.chunk)): v for (s, o), v in d.items()}


def _build_both(name, p, m):
    """(port, JAX) schedules, or (None, None) once both raised the same type."""
    try:
        ref = BUILDERS[name](J, p, m)
    except Exception as e:  # noqa: BLE001 -- the port must raise the same type
        with pytest.raises(type(e)):
            BUILDERS[name](T, p, m)
        return None, None
    return BUILDERS[name](T, p, m), ref


def assert_same_schedule(mine, ref):
    assert (mine.name, mine.p, mine.m, mine.n_chunks) == (ref.name, ref.p, ref.m, ref.n_chunks)
    assert mine.placement.stage_seq == ref.placement.stage_seq
    assert _ops(mine) == _ops(ref)
    assert _keyed(mine.to_ticks()) == _keyed(ref.to_ticks())
    for m_b, m_w in ((1.0, 0.5), (1.0 / mine.n_chunks, 0.5 / mine.n_chunks)):
        a, b = mine.memory_profile(m_b, m_w), ref.memory_profile(m_b, m_w)
        np.testing.assert_array_equal(a.peak, b.peak)
        assert (a.m_b, a.m_w, a.max_peak) == (b.m_b, b.m_w, b.max_peak)


def assert_same_simulation(mine, ref):
    for times in TIMES.values():
        for grouped in (False, True):
            a = simulate(mine, TimeModel(*times, grouped_w=grouped))
            b = jax_simulate(ref, JaxTimeModel(*times, grouped_w=grouped))
            assert (a.cost, a.makespan, a.ideal, a.m) == (b.cost, b.makespan, b.ideal, b.m)
            assert a.bubble_rate == b.bubble_rate and a.bubble_size == b.bubble_size
            np.testing.assert_array_equal(a.stage_busy, b.stage_busy)
            np.testing.assert_array_equal(a.stage_span, b.stage_span)
            assert _keyed(a.start) == _keyed(b.start) and _keyed(a.end) == _keyed(b.end)
        assert bubble_rate(mine, TimeModel(*times)) == simulate(mine, TimeModel(*times)).bubble_rate


@pytest.mark.parametrize("p,m", GRID)
@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_matches_jax(name, p, m):
    mine, ref = _build_both(name, p, m)
    if ref is None:
        return
    assert_same_schedule(mine, ref)
    assert_same_plan(T.compile_plan(mine), J.compile_plan(ref))
    assert_same_simulation(mine, ref)


def test_builders_raise_where_jax_raises():
    """Refusals with the reference's messages."""
    for mod in (T, J):
        with pytest.raises(ValueError, match="unknown stable pattern"):
            mod.stable_v_schedule(4, 4, "v-third")
        with pytest.raises(ValueError, match="act_limit"):
            mod.v_flex(4, 8, 0.5)
        with pytest.raises(RuntimeError, match="no feasible"):
            mod.search(4, 8, (TimeModel if mod is T else JaxTimeModel).unit(), m_limit=0.5)


def test_v_limits_and_activation_peaks_match_jax():
    for p in (2, 3, 4, 6, 8, 16):
        assert T.v_min_limit(p) == J.v_min_limit(p)
        assert T.v_half_limit(p) == J.v_half_limit(p)
        assert T.v_min_limit(p, 0.5) == J.v_min_limit(p, 0.5)
    for p, m in ((4, 8), (6, 12)):
        for name in ("zb-v", "v-min", "v-half"):
            mine, ref = BUILDERS[name](T, p, m), BUILDERS[name](J, p, m)
            for m_b in (1.0, 2.0):
                assert T.activation_peak(mine, m_b) == J.activation_peak(ref, m_b)
        for kind in ("v-min", "v-half"):
            assert vflex.stable_pattern(p, kind) == jax_vflex.stable_pattern(p, kind)


def test_time_model_matches_jax():
    scale = (1.0, 1.5, 0.5, 2.0)
    for kw in ({}, {"grouped_w": True}, {"stage_scale": scale}):
        a, b = TimeModel(1.1, 1.7, 0.6, 0.2, **kw), JaxTimeModel(1.1, 1.7, 0.6, 0.2, **kw)
        for s in range(4):
            for op in (T.Op(T.OpKind.F, 0), T.Op(T.OpKind.B, 1, 1), T.Op(T.OpKind.W, 2)):
                jop = J.Op(J.OpKind(int(op.kind)), op.mb, op.chunk)
                for C in (1, 2):
                    assert a.duration(s, op, C) == b.duration(s, jop, C)
    assert TimeModel.unit() == TimeModel(1.0, 1.0, 1.0, 0.0)
    # a straggler stage: simulate with a per-stage scale, equal to the reference
    sched, ref = T.zb_h1(4, 8), J.zb_h1(4, 8)
    a = simulate(sched, TimeModel(1.0, 1.0, 1.0, 0.1, stage_scale=scale))
    b = jax_simulate(ref, JaxTimeModel(1.0, 1.0, 1.0, 0.1, stage_scale=scale))
    assert (a.cost, a.bubble_rate) == (b.cost, b.bubble_rate)


def test_simulator_raises_on_a_deadlock():
    # stage 0 waits for its B while stage 1 waits for the next F
    F, B, W = T.OpKind.F, T.OpKind.B, T.OpKind.W
    bad = T.Schedule(2, 2, [
        [T.Op(F, 0), T.Op(B, 0), T.Op(F, 1), T.Op(B, 1), T.Op(W, 0), T.Op(W, 1)],
        [T.Op(F, 1), T.Op(F, 0), T.Op(B, 0), T.Op(B, 1), T.Op(W, 0), T.Op(W, 1)],
    ])
    with pytest.raises(ValueError, match="simulation deadlock"):
        simulate(bad, TimeModel.unit())


def test_memoized_v_flex_equals_a_fresh_search():
    first = T.v_flex(4, 8, 3.0)
    assert vflex._v_flex_build.cache_info().misses == 1
    again = T.v_flex(4, 8, 3.0, name="again")  # served by the in-process memo
    assert vflex._v_flex_build.cache_info().hits == 1
    assert (again.name, first.name) == ("again", "v-flex")
    vflex._v_flex_build.cache_clear()
    fresh = T.v_flex(4, 8, 3.0)
    for s in (again, fresh):
        assert _ops(s) == _ops(first)
        assert s.placement.stage_seq == first.placement.stage_seq
    assert _ops(first) == _ops(J.v_flex(4, 8, 3.0))
