"""Schedules of the port: the IR, 1F1B/GPipe and the handcrafted ZB-H1/H2."""

from .baselines import gpipe, one_f_one_b
from .handcrafted import zb_h1, zb_h2
from .ir import ExecutionPlan, Op, OpKind, Placement, Schedule, compile_plan

__all__ = [
    "ExecutionPlan",
    "Op",
    "OpKind",
    "Placement",
    "Schedule",
    "compile_plan",
    "gpipe",
    "one_f_one_b",
    "zb_h1",
    "zb_h2",
]
