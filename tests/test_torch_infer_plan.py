"""The port's serving plan (``repro_torch.core.infer_executor``) is the JAX
package's, array for array: exact equality of every ``InferPlan`` field."""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.infer_executor import compile_infer_plan as jax_compile  # noqa: E402
from repro.core.schedules.ir import Placement as JaxPlacement  # noqa: E402

from repro_torch.core.infer_executor import compile_infer_plan  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402

PLACEMENTS = [("linear", p, C) for p in (1, 2, 3, 4) for C in (1, 2)] + [
    ("vshape", p, 2) for p in (2, 3, 4)
]


def _make(cls, kind, p, C):
    return cls.linear(p, C) if kind == "linear" else cls.vshape(p)


@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("kind,p,C", PLACEMENTS)
def test_infer_plan_matches_jax(kind, p, C, m):
    mine = compile_infer_plan(_make(Placement, kind, p, C), m)
    ref = jax_compile(_make(JaxPlacement, kind, p, C), m)
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind,p,C", PLACEMENTS)
def test_placement_matches_jax(kind, p, C):
    mine, ref = _make(Placement, kind, p, C), _make(JaxPlacement, kind, p, C)
    assert mine.stage_seq == ref.stage_seq
    for c in range(C):
        for k in range(p):
            assert mine.stage_of(c, k) == ref.stage_of(c, k)
            assert mine.fwd_prev(c, k) == ref.fwd_prev(c, k)
            assert mine.fwd_next(c, k) == ref.fwd_next(c, k)
