"""Optimizer post-validation (paper Sec. 4, Fig. 4, Appendix C).

Counterpart of ``src/repro/optim/postval.py``.  Instead of blocking on a
global all-reduce before every optimizer step, each stage steps
optimistically on the *partially* reduced statistics of the stages before it
(a prefix along the pipe), and once the fully reduced statistics are known,
validates its decision and -- on mis-speculation -- rolls the step back
exactly (Alg. 1) and redoes it with the true global clip scale.

With all p stages in one process, ``pipe_prefix_stats`` is a prefix sum over
the list of per-stage statistics.  With one process a stage,
``relay_prefix_stats`` is the paper's relay itself: stage s receives stage
s-1's inclusive prefix, adds its own and sends it on to stage s+1, and the
full statistics come back from the last stage, stage to stage; it adds in
``pipe_prefix_stats``' order, so it gives its bits.  (The JAX package's
log-depth scan of ppermutes adds in another order.)  The decisions are host
booleans: each is read once per stage and step (one device sync).

``optimistic_step``, ``validate_and_fix`` and ``sync_step`` step through the
functional ``adamw.step`` / ``adamw.rollback``; ``optimistic_step_``,
``validate_and_fix_`` and ``sync_step_`` take the same decisions and step
through ``adamw.step_`` / ``adamw.rollback_``, in place (the training
step's path).
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.p2p import exchange
from ..tree import tree_leaves
from . import adamw

PyTree = Any

__all__ = [
    "GradStats",
    "Decision",
    "local_stats",
    "combine_stats",
    "pipe_prefix_stats",
    "relay_prefix_stats",
    "decide_partial",
    "decide_global",
    "optimistic_step",
    "validate_and_fix",
    "sync_step",
    "optimistic_step_",
    "validate_and_fix_",
    "sync_step_",
]


class GradStats(NamedTuple):
    sumsq: torch.Tensor  # sum of squared gradient entries (fp32 scalar)
    nonfinite: torch.Tensor  # bool scalar: any NaN/Inf seen


class Decision(NamedTuple):
    applied: bool  # did we apply an (unscaled) optimistic step
    scale: torch.Tensor  # f32: the scale used (1.0 for optimistic steps)


def local_stats(grads: PyTree) -> GradStats:
    """The sum of squares, each leaf's summed whole (the JAX package's
    order, so the norm keeps its bits), and whether any entry is not
    finite: NaN, +inf or -inf, each tested by a one-byte mask
    (``torch.isfinite`` builds an fp32 ``abs`` and three masks of the
    leaf's size at once, more than the square)."""
    leaves = tree_leaves(grads)
    dev = leaves[0].device if leaves else "cpu"
    sumsq = torch.zeros((), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.bool, device=dev)
    for g in leaves:
        g32 = g.float()
        sumsq = sumsq + torch.sum(g32 * g32)
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            bad = bad | torch.any(test(g32))
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


def _stats_msg(*stats: GradStats) -> torch.Tensor:
    """Statistics as a host fp32 message: (sumsq, nonfinite) each."""
    return torch.tensor([v for st in stats for v in (float(st.sumsq), float(bool(st.nonfinite)))],
                        dtype=torch.float32)


def _msg_stats(msg: torch.Tensor, k: int, device) -> GradStats:
    return GradStats(msg[2 * k].to(device), (msg[2 * k + 1] > 0.5).to(device))


def relay_prefix_stats(group, stats: GradStats) -> Tuple[GradStats, GradStats, GradStats]:
    """(partial, full, first) on rank ``group.rank`` of a pipe group
    (``launch/mesh.py::PipeGroup``): ``partial`` is the inclusive prefix of
    the stages up to this one, relayed stage to stage; ``full`` the last
    stage's, relayed back; ``first`` stage 0's own (it travels beside the
    prefix), whose decision every rank's replica of the shared parameters
    follows.  Each message is a few host floats (the fp32 sums carry their
    bits), each wait bounded by the group's timeout."""
    r, w, dev = group.rank, group.world, stats.sumsq.device
    if r == 0:
        first = partial = stats
    else:
        msg = torch.empty(4, dtype=torch.float32)
        exchange(group, [], [(r - 1, msg, 0)], lambda: f"rank {r}: the relay's prefix from rank "
                                                        f"{r - 1}")
        first = _msg_stats(msg, 0, dev)
        partial = combine_stats(_msg_stats(msg, 1, dev), stats)
    if r < w - 1:
        exchange(group, [(r + 1, _stats_msg(first, partial), 0)], [],
                 lambda: f"rank {r}: the relay's prefix to rank {r + 1}")
        msg = torch.empty(2, dtype=torch.float32)
        exchange(group, [], [(r + 1, msg, 1)], lambda: f"rank {r}: the full statistics from "
                                                        f"rank {r + 1}")
        full = _msg_stats(msg, 0, dev)
    else:
        full = partial
    if r > 0:
        exchange(group, [(r - 1, _stats_msg(full), 1)], [],
                 lambda: f"rank {r}: the full statistics to rank {r - 1}")
    return partial, full, first


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


# the names in ``adamw`` of (step, rollback) on the functional and on the
# in-place path, looked up at each call
_FUNCTIONAL = ("step", "rollback")
_IN_PLACE = ("step_", "rollback_")


def _op(ops, k):
    return getattr(adamw, ops[k])


def _optimistic(ops, params, state, grads, partial, cfg):
    dec = decide_partial(partial, cfg)
    if dec.applied:
        params, state = _op(ops, 0)(params, state, grads, cfg, scale=1.0)
    return params, state, dec


def _validate(ops, params, state, grads, speculative, full, cfg):
    want = decide_global(full, cfg)
    applied_ok = speculative.applied and want.applied and bool(want.scale >= 1.0 - 1e-12)
    skipped_ok = (not speculative.applied) and (not want.applied)
    if applied_ok or skipped_ok:
        return params, state, False
    if speculative.applied:  # undo, then redo the true decision
        params, state = _op(ops, 1)(params, state, grads, cfg, scale=1.0)
    if want.applied:
        params, state = _op(ops, 0)(params, state, grads, cfg, scale=want.scale)
    return params, state, True


def _sync(ops, params, state, grads, cfg, stats):
    stats = stats if stats is not None else local_stats(grads)
    want = decide_global(stats, cfg)
    if want.applied:
        return _op(ops, 0)(params, state, grads, cfg, scale=want.scale)
    return params, state


def optimistic_step(params: PyTree, state: adamw.AdamWState, grads: PyTree, partial: GradStats,
                    cfg: adamw.AdamWConfig) -> Tuple[PyTree, adamw.AdamWState, Decision]:
    return _optimistic(_FUNCTIONAL, params, state, grads, partial, cfg)


def validate_and_fix(params: PyTree, state: adamw.AdamWState, grads: PyTree,
                     speculative: Decision, full: GradStats, cfg: adamw.AdamWConfig
                     ) -> Tuple[PyTree, adamw.AdamWState, bool]:
    """Rollback + redo when the optimistic decision was wrong.  Returns
    (params, state, amended)."""
    return _validate(_FUNCTIONAL, params, state, grads, speculative, full, cfg)


def sync_step(params: PyTree, state: adamw.AdamWState, grads: PyTree, cfg: adamw.AdamWConfig,
              stats: Optional[GradStats] = None) -> Tuple[PyTree, adamw.AdamWState]:
    """Reference synchronous semantics: blocking global decision, then step."""
    return _sync(_FUNCTIONAL, params, state, grads, cfg, stats)


def optimistic_step_(params: PyTree, state: adamw.AdamWState, grads: PyTree, partial: GradStats,
                     cfg: adamw.AdamWConfig) -> Tuple[PyTree, adamw.AdamWState, Decision]:
    """:func:`optimistic_step` in place: ``params`` and the moments of
    ``state`` are overwritten; the returned state holds the new count."""
    return _optimistic(_IN_PLACE, params, state, grads, partial, cfg)


def validate_and_fix_(params: PyTree, state: adamw.AdamWState, grads: PyTree,
                      speculative: Decision, full: GradStats, cfg: adamw.AdamWConfig
                      ) -> Tuple[PyTree, adamw.AdamWState, bool]:
    """:func:`validate_and_fix` in place: the rollback and the redo run
    slice by slice into the stored parameters and moments."""
    return _validate(_IN_PLACE, params, state, grads, speculative, full, cfg)


def sync_step_(params: PyTree, state: adamw.AdamWState, grads: PyTree, cfg: adamw.AdamWConfig,
               stats: Optional[GradStats] = None) -> Tuple[PyTree, adamw.AdamWState]:
    """:func:`sync_step` in place."""
    return _sync(_IN_PLACE, params, state, grads, cfg, stats)
