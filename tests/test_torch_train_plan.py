"""The port's training schedules and tick tables are the JAX package's.

``one_f_one_b``, ``gpipe``, ``zb_h1``, ``zb_h2`` and the V-shaped ``zb_v``,
``v_min`` and ``v_half`` (two chunks: the local sends at the V's turn, the
per-chunk inbox and joint slot tables) give the same op list on every stage,
the same tick assignment, and ``compile_plan`` gives every ``ExecutionPlan``
table and slot count exactly equal to the JAX package's, over a (p, m) grid.
Host-only Python on both sides, so equality is exact; the JAX package's
on-disk plan cache is off and both ``v_flex`` memos are cleared, so that no
stored plan stands in for a search.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.schedules import compile_plan as jax_compile_plan  # noqa: E402
from repro.core.schedules import gpipe as jax_gpipe  # noqa: E402
from repro.core.schedules import one_f_one_b as jax_1f1b  # noqa: E402
from repro.core.schedules import v_half as jax_v_half  # noqa: E402
from repro.core.schedules import v_min as jax_v_min  # noqa: E402
from repro.core.schedules import zb_h1 as jax_zb_h1  # noqa: E402
from repro.core.schedules import zb_h2 as jax_zb_h2  # noqa: E402
from repro.core.schedules import zb_v as jax_zb_v  # noqa: E402
from repro.core.schedules import vflex as jax_vflex  # noqa: E402

from repro_torch.core.schedules import Op, OpKind, Schedule, compile_plan  # noqa: E402
from repro_torch.core.schedules import gpipe, one_f_one_b, zb_h1, zb_h2  # noqa: E402
from repro_torch.core.schedules import v_half, v_min, vflex, zb_v  # noqa: E402

BUILDERS = {
    "gpipe": (gpipe, jax_gpipe),
    "1f1b": (one_f_one_b, jax_1f1b),
    "zb-h1": (zb_h1, jax_zb_h1),
    "zb-h2": (zb_h2, jax_zb_h2),
    "zb-v": (zb_v, jax_zb_v),
    "v-min": (v_min, jax_v_min),
    "v-half": (v_half, jax_v_half),
}


GRID = [(p, m) for p in (1, 2, 3, 4) for m in (1, 2, 4, 5, 8)] + [(6, 12), (8, 16)]


@pytest.fixture(autouse=True)
def _no_stored_plans(monkeypatch):
    """Both packages search afresh: the JAX package's on-disk plan cache off
    (the port has none) and the in-process ``v_flex`` memos cleared, so no
    stored plan stands in for a search (the schedule and search tests import
    this fixture too)."""
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", "off")
    for mod in (vflex, jax_vflex):
        mod._v_flex_build.cache_clear()
    yield
    for mod in (vflex, jax_vflex):
        mod._v_flex_build.cache_clear()


def _ops(sched):
    return [[(int(o.kind), o.mb, o.chunk) for o in ops] for ops in sched.stage_ops]


def assert_same_plan(mine, ref):
    """Every ``ExecutionPlan`` table and slot count equal, array for array."""
    mine_fields = {f.name for f in dataclasses.fields(mine)}
    for f in dataclasses.fields(ref):
        if f.name not in mine_fields:
            continue
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if f.name == "placement":
            assert a.stage_seq == b.stage_seq
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    # the port keeps every table the JAX executor reads
    assert mine_fields == {f.name for f in dataclasses.fields(ref)}
    assert mine.inbox_slot_total() == ref.inbox_slot_total()
    assert mine.total_ops == ref.total_ops
    assert mine.bubble_fraction == ref.bubble_fraction


@pytest.mark.parametrize("p,m", GRID)
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_schedule_ops_and_ticks_match_jax(name, p, m):
    mine, ref = BUILDERS[name][0](p, m), BUILDERS[name][1](p, m)
    assert mine.name == ref.name
    assert _ops(mine) == _ops(ref)
    tm, tr = mine.to_ticks(), ref.to_ticks()
    assert {(s, (int(o.kind), o.mb, o.chunk)): t for (s, o), t in tm.items()} == {
        (s, (int(o.kind), o.mb, o.chunk)): t for (s, o), t in tr.items()
    }
    assert mine.n_ticks() == ref.n_ticks()
    assert mine.render() == ref.render()


@pytest.mark.parametrize("p,m", GRID)
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_compile_plan_matches_jax(name, p, m):
    assert_same_plan(compile_plan(BUILDERS[name][0](p, m)),
                     jax_compile_plan(BUILDERS[name][1](p, m)))


def test_schedule_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="op set mismatch"):
        Schedule(1, 2, [[Op(OpKind.F, 0), Op(OpKind.B, 0), Op(OpKind.W, 0)]])
    with pytest.raises(ValueError, match="F<B<W"):
        Schedule(1, 1, [[Op(OpKind.B, 0), Op(OpKind.F, 0), Op(OpKind.W, 0)]])
    # stage 0 waits for its B while stage 1 waits for the next F: deadlock
    bad = Schedule(2, 2, [
        [Op(OpKind.F, 0), Op(OpKind.B, 0), Op(OpKind.F, 1), Op(OpKind.B, 1),
         Op(OpKind.W, 0), Op(OpKind.W, 1)],
        [Op(OpKind.F, 1), Op(OpKind.F, 0), Op(OpKind.B, 0), Op(OpKind.B, 1),
         Op(OpKind.W, 0), Op(OpKind.W, 1)],
    ])
    with pytest.raises(ValueError, match="deadlock"):
        bad.validate()
