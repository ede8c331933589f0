"""Straggler mitigation: op re-planning + layer rebalancing.

A uniformly slow stage bounds the iteration from below (no op order can
shrink its busy time); the fix is moving layers off it and re-searching the
ZB schedule for the new profile -- then the elastic checkpoint reshard
moves the weights.

  python -m repro_torch.examples.straggler_replan

Counterpart of ``examples/straggler_replan.py``, through the port's
``runtime.replan_for_stragglers`` and ``rebalance_layers``; host only (no
device work).  :func:`run` takes (p, m, g), with the JAX example's values
as defaults.
"""

from __future__ import annotations

from typing import Dict

from ..core.simulator import TimeModel
from ..runtime import rebalance_layers, replan_for_stragglers

__all__ = ["BASE", "SLOW", "run", "main"]

BASE = TimeModel(11.3, 11.25, 8.1, 0.38)  # paper 14.6B profile
SLOW = ((3, 1.2), (7, 1.5), (0, 2.0))  # (slow stage, factor) of the rebalancing runs


def run(p: int = 16, m: int = 64, g: int = 4, log=print) -> Dict:
    """The example's two parts at p stages, m microbatches and g layers a
    stage; a slow stage past p is left out.  Returns the comm replan's
    (new, old) cost and each rebalancing's (layers, new cost, old cost)."""
    log("-- comm-jitter straggler (recoverable by op re-planning alone) --")
    slow_comm = TimeModel(11.3, 11.25, 8.1, 0.38 * 6)
    _, new_cost, old_cost = replan_for_stragglers(p, m, slow_comm, (1.0,) * p,
                                                  m_limit=2.0 * p)
    log(f"6x comm latency: balanced plan {old_cost:.0f} -> re-planned {new_cost:.0f}")
    out = {"comm": (new_cost, old_cost), "rebalance": {}}

    log("-- uniformly slow stages (need layer rebalancing) --")
    for slow_stage, factor in SLOW:
        if slow_stage >= p:
            continue
        scale = tuple(factor if s == slow_stage else 1.0 for s in range(p))
        layers, _, new_cost, old_cost = rebalance_layers(p, m, BASE, scale, layers_per_stage=g,
                                                         m_limit=2.0 * p)
        log(f"stage {slow_stage} {factor:.1f}x slow: cost {old_cost:.0f} -> "
            f"{new_cost:.0f} ({100 * (old_cost - new_cost) / old_cost:.1f}% recovered), "
            f"layers={layers}")
        out["rebalance"][(slow_stage, factor)] = (list(layers), new_cost, old_cost)
    return out


def main() -> Dict:
    out = run()
    print("OK")
    return out


if __name__ == "__main__":
    main()
