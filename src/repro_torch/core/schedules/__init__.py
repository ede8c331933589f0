"""Schedules of the port: the IR, the baselines, the handcrafted ZB-H1/H2,
the V-shaped ZB-V / V-Min / V-Half and the automatic ZB-1p / ZB-2p search.

The same names as ``src/repro/core/schedules/__init__.py`` apart from the
channel constants and ``local_search``, which no caller of the port needs
yet.
"""

from .ir import (
    ExecutionPlan,
    MemoryProfile,
    Op,
    OpKind,
    Placement,
    Schedule,
    compile_plan,
)
from .baselines import gpipe, interleaved_1f1b, one_f_one_b
from .handcrafted import zb_h1, zb_h2
from .zbv import zb_v, zb_v_handcrafted
from .vflex import (
    activation_peak,
    stable_v_schedule,
    v_flex,
    v_half,
    v_half_limit,
    v_min,
    v_min_limit,
)
from .auto import AutoResult, search, zb_1p, zb_2p
from .greedy import GreedyConfig, greedy_schedule

__all__ = [
    "ExecutionPlan",
    "MemoryProfile",
    "Op",
    "OpKind",
    "Placement",
    "Schedule",
    "compile_plan",
    "gpipe",
    "interleaved_1f1b",
    "one_f_one_b",
    "zb_h1",
    "zb_h2",
    "zb_v",
    "zb_v_handcrafted",
    "activation_peak",
    "stable_v_schedule",
    "v_flex",
    "v_half",
    "v_half_limit",
    "v_min",
    "v_min_limit",
    "AutoResult",
    "search",
    "zb_1p",
    "zb_2p",
    "GreedyConfig",
    "greedy_schedule",
]
