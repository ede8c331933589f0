"""Optimizer post-validation (paper Sec. 4, Fig. 4, Appendix C).

Counterpart of ``src/repro/optim/postval.py``.  Instead of blocking on a
global all-reduce before every optimizer step, each stage steps
optimistically on the *partially* reduced statistics of the stages before it
(a prefix along the pipe), and once the fully reduced statistics are known,
validates its decision and -- on mis-speculation -- rolls the step back
exactly (Alg. 1) and redoes it with the true global clip scale.

All p stages sit on one device here, so ``pipe_prefix_stats`` is a prefix sum
over the list of per-stage statistics with no collectives.  The decisions
are host booleans: each is read once per stage and step (one device sync).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..tree import tree_leaves
from . import adamw

PyTree = Any

__all__ = [
    "GradStats",
    "Decision",
    "local_stats",
    "combine_stats",
    "pipe_prefix_stats",
    "decide_partial",
    "decide_global",
    "optimistic_step",
    "validate_and_fix",
    "sync_step",
]


class GradStats(NamedTuple):
    sumsq: torch.Tensor  # sum of squared gradient entries (fp32 scalar)
    nonfinite: torch.Tensor  # bool scalar: any NaN/Inf seen


class Decision(NamedTuple):
    applied: bool  # did we apply an (unscaled) optimistic step
    scale: torch.Tensor  # f32: the scale used (1.0 for optimistic steps)


def local_stats(grads: PyTree) -> GradStats:
    leaves = tree_leaves(grads)
    dev = leaves[0].device if leaves else "cpu"
    sumsq = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for g in leaves:
        g32 = g.float()
        sumsq = sumsq + torch.sum(g32 * g32)
        bad = bad | ~torch.all(torch.isfinite(g32))
    return GradStats(sumsq, bad)


def combine_stats(a: GradStats, b: GradStats) -> GradStats:
    return GradStats(a.sumsq + b.sumsq, a.nonfinite | b.nonfinite)


def pipe_prefix_stats(stats: Sequence[GradStats]) -> Tuple[List[GradStats], GradStats]:
    """(inclusive prefix per stage, full) over the stages' statistics."""
    prefix, run = [], None
    for st in stats:
        run = st if run is None else combine_stats(run, st)
        prefix.append(run)
    return prefix, run


def decide_partial(partial: GradStats, cfg: adamw.AdamWConfig) -> Decision:
    """Optimistic decision from a partially reduced state (paper Sec. 4)."""
    ok = ~partial.nonfinite
    if cfg.grad_clip is not None:
        ok = ok & (torch.sqrt(partial.sumsq) <= cfg.grad_clip)
    return Decision(applied=bool(ok), scale=torch.ones((), device=partial.sumsq.device))


def decide_global(full: GradStats, cfg: adamw.AdamWConfig) -> Decision:
    """The synchronous-semantics decision from the fully reduced state."""
    norm = torch.sqrt(full.sumsq)
    if cfg.grad_clip is None:
        scale = torch.ones((), device=norm.device)
    else:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(norm, min=1e-20), max=1.0)
    return Decision(applied=not bool(full.nonfinite), scale=scale.float())


def optimistic_step(params: PyTree, state: adamw.AdamWState, grads: PyTree, partial: GradStats,
                    cfg: adamw.AdamWConfig) -> Tuple[PyTree, adamw.AdamWState, Decision]:
    dec = decide_partial(partial, cfg)
    if dec.applied:
        params, state = adamw.step(params, state, grads, cfg, scale=1.0)
    return params, state, dec


def validate_and_fix(params: PyTree, state: adamw.AdamWState, grads: PyTree,
                     speculative: Decision, full: GradStats, cfg: adamw.AdamWConfig
                     ) -> Tuple[PyTree, adamw.AdamWState, bool]:
    """Rollback + redo when the optimistic decision was wrong.  Returns
    (params, state, amended)."""
    want = decide_global(full, cfg)
    applied_ok = speculative.applied and want.applied and bool(want.scale >= 1.0 - 1e-12)
    skipped_ok = (not speculative.applied) and (not want.applied)
    if applied_ok or skipped_ok:
        return params, state, False
    if speculative.applied:  # undo, then redo the true decision
        params, state = adamw.rollback(params, state, grads, cfg, scale=1.0)
    if want.applied:
        params, state = adamw.step(params, state, grads, cfg, scale=want.scale)
    return params, state, True


def sync_step(params: PyTree, state: adamw.AdamWState, grads: PyTree, cfg: adamw.AdamWConfig,
              stats: Optional[GradStats] = None) -> Tuple[PyTree, adamw.AdamWState]:
    """Reference synchronous semantics: blocking global decision, then step."""
    stats = stats if stats is not None else local_stats(grads)
    want = decide_global(stats, cfg)
    if want.applied:
        return adamw.step(params, state, grads, cfg, scale=want.scale)
    return params, state
