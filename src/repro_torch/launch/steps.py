"""Step builders of the port.  This slice has the serving step only.

Counterpart of ``src/repro/launch/steps.py::build_serve_step``: no
``shard_map`` and no ``jit`` -- the step is the host-driven executor of
``core/infer_executor.py`` over one device holding all pipeline stages.
"""

from __future__ import annotations

from ..core.infer_executor import InferExecutor, compile_infer_plan
from ..core.schedules.ir import Placement
from ..models.lm import ArchConfig, RunSpec
from ..models.serve import build_serve_program

__all__ = ["build_serve_step"]


def build_serve_step(cfg: ArchConfig, spec: RunSpec, placement: Placement, mode: str):
    """Returns (step, program, cache_init).

    ``step(stacked, shared, side, caches, pos) -> (logits, caches)``:
    ``logits`` is (m, b, V); ``caches`` (per chunk, leaves (p, m, b, S, ...))
    are updated in place.  ``pos`` is 0 for prefill and, for decode, the
    scalar index of the token being decoded, ``cache_len - 1`` as in the JAX
    step (``side["positions"]`` is not read by decode).
    """
    program, cache_init = build_serve_program(cfg, spec, placement, mode)
    plan = compile_infer_plan(placement, spec.m)
    step = InferExecutor(program, plan).build_step_fn()
    return step, program, cache_init
