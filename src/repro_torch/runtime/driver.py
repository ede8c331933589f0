"""Fault-tolerant training driver of the port.

Counterpart of ``src/repro/runtime/driver.py``:
  * checkpoint every N steps and at the last step (atomic), restart from
    the newest checkpoint;
  * retry a failed step: restore the newest checkpoint (or start afresh
    without one) and replay -- the data stream is a function of the step,
    so the replay repeats the same batches;
  * straggler replanning: re-search the schedule under an observed per-stage
    time profile (``replan_for_stragglers``, ``rebalance_layers``);
  * memory replanning: re-run the HBM planner under a new per-device budget
    (``replan_under_budget``).

The port's training step updates parameters and optimizer state in place,
where the JAX driver relies on immutable arrays.  So ``init_state()`` must
build fresh tensors every call (from the seed, never the live stepped
ones), a restore overwrites every leaf of that fresh state, and the failed
step's state is dropped before the new one is built.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import store
from ..core.planner import HBMPlanner, fastest_under_profile
from ..core.schedules import search, zb_h2
from ..core.simulator import TimeModel, simulate

log = logging.getLogger("repro_torch.driver")

__all__ = [
    "DriverConfig",
    "TrainDriver",
    "replan_for_stragglers",
    "replan_under_budget",
    "rebalance_layers",
]


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: Optional[str]  # None: no checkpoints; a retry starts from step 0
    ckpt_every: int = 50
    max_retries: int = 3
    keep_last: int = 3


def replan_for_stragglers(p: int, m: int, base_times: TimeModel, stage_scale, m_limit: float):
    """Re-plan the schedule for an observed per-stage slowdown profile.

    Every family is re-simulated under the observed profile
    (:func:`repro_torch.core.planner.fastest_under_profile`) and the
    cheapest one under the unit memory limit wins.  Returns (schedule,
    predicted_cost, baseline_cost): the baseline is the balanced-profile
    choice under the observed profile, and it stays a candidate, so the
    replanned cost never exceeds it.
    """
    observed = dataclasses.replace(base_times, stage_scale=tuple(stage_scale))
    balanced, _ = fastest_under_profile(p, m, base_times, m_limit)
    base_cost = simulate(balanced, observed).cost
    replanned, cost = fastest_under_profile(p, m, observed, m_limit)
    if base_cost < cost:  # the balanced pick is itself a valid candidate
        replanned, cost = balanced, base_cost
    return replanned, cost, base_cost


def replan_under_budget(cfg, p: int, m: int, microbatch: int, seq_len: int, budget_bytes: float,
                        base_times: Optional[TimeModel] = None, stage_scale=None,
                        tp_size: int = 1, dp_size: int = 1, program_factory=None,
                        temp_bytes: Optional[float] = None, executor_mode: str = "eager"):
    """Re-plan the schedule under a per-device HBM budget.

    Runs the unified planner (:mod:`repro_torch.core.planner`), optionally
    under an observed straggler profile, and returns (schedule,
    :class:`~repro_torch.core.planner.PlanReport`).  The budget covers
    parameters, AdamW moments, inbox/sink and activation/W-context bytes,
    and the ``temp`` term of ``executor_mode`` (the fp32 gradient
    accumulators, the optimizer's transient and the calibrated CUDA
    remainder; ``temp_bytes`` replaces it).  Raises ``RuntimeError`` with the
    itemized report, naming the binding term, when nothing fits.  With
    ``program_factory(n_chunks) -> (program, stage_params, shared, side)``
    (:func:`~repro_torch.core.planner.stage_program_factory`) the planner
    prices act/wctx/inbox/sink from slot bytes measured on its device.
    """
    times = base_times or TimeModel.unit()
    if stage_scale is not None:
        times = dataclasses.replace(times, stage_scale=tuple(stage_scale))
    planner = HBMPlanner(cfg, p=p, m=m, microbatch=microbatch, seq_len=seq_len, times=times,
                         tp_size=tp_size, dp_size=dp_size, program_factory=program_factory,
                         temp_bytes=temp_bytes, executor_mode=executor_mode)
    report = planner.plan(budget_bytes)
    if not report.feasible:
        fidelity = "measured executor buffers" if planner.measured else "the byte model"
        raise RuntimeError(f"no schedule fits the per-device HBM budget (on {fidelity}): "
                           f"{report.infeasibility_report()}")
    log.info("replanned under budget: %s", report.summary())
    return report.chosen.schedule, report


def rebalance_layers(p: int, m: int, base_times: TimeModel, stage_scale, layers_per_stage: int,
                     m_limit: float):
    """Straggler mitigation for a uniformly slow stage: move layers off it.

    Greedy: move one layer from the most loaded stage (observed scale x
    layer count) to the least loaded while the simulated ZB-H2 cost
    improves.  Returns (layer_counts, schedule, new_cost, old_cost).
    """
    g0 = layers_per_stage
    layers = [g0] * p

    def cost(lay):
        scale = tuple(stage_scale[s] * lay[s] / g0 for s in range(p))
        return simulate(zb_h2(p, m), dataclasses.replace(base_times, stage_scale=scale)).cost

    old_cost = cost(layers)
    best = old_cost
    for _ in range(p * g0):
        load = [stage_scale[s] * layers[s] for s in range(p)]
        src = int(np.argmax(load))
        dst = int(np.argmin(load))
        if layers[src] <= 1 or src == dst:
            break
        cand = list(layers)
        cand[src] -= 1
        cand[dst] += 1
        c = cost(cand)
        if c >= best - 1e-9:
            break
        layers, best = cand, c
    scale = tuple(stage_scale[s] * layers[s] / g0 for s in range(p))
    final = search(p, m, dataclasses.replace(base_times, stage_scale=scale), m_limit=m_limit)
    return layers, final.schedule, min(final.cost, best), old_cost


def _to_host(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Tensor metrics as Python floats (a device sync); the rest as given."""
    return {k: float(v) if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}


class TrainDriver:
    """``step_fn(state, batch) -> (state, metrics)``; state is a dict of trees.

    ``init_state()`` must return fresh tensors on every call: the step
    updates the state in place, so handing back the live state would resume
    from stepped weights after a failure.
    """

    def __init__(self, cfg: DriverConfig, step_fn: Callable, init_state: Callable[[], Dict[str, Any]],
                 data_at: Callable[[int], Any]):
        self.cfg = cfg
        self.step_fn = step_fn
        self.init_state = init_state
        self.data_at = data_at
        # host seconds of each step of the last run(), the metrics' device
        # sync included, and of each checkpoint save
        self.step_times: List[float] = []
        self.save_times: List[float] = []

    def throughput(self, skip: int = 1) -> Optional[float]:
        """Steady-state steps/s of the last run, skipping warm-up steps."""
        times = self.step_times[skip:]
        if not times:
            return None
        return len(times) / sum(times)

    def _restore_or_init(self):
        last = store.latest_step(self.cfg.ckpt_dir)
        state = self.init_state()
        if last is None:
            return state, 0
        state, _ = store.restore(self.cfg.ckpt_dir, last, state)
        log.info("restored checkpoint step %d", last)
        return state, last

    def run(self, n_steps: int, fail_hook: Optional[Callable[[int], None]] = None):
        """``fail_hook(step)`` may raise to simulate a node failure (tests)."""
        state, start = self._restore_or_init()
        metrics_log = []
        self.step_times, self.save_times = [], []
        step = start
        retries = 0
        while step < n_steps:
            try:
                if fail_hook is not None:
                    fail_hook(step)
                batch = self.data_at(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                metrics = _to_host(metrics)
                self.step_times.append(time.perf_counter() - t0)
                metrics_log.append((step, metrics))
                step += 1
                retries = 0
                if self.cfg.ckpt_dir is not None and (step % self.cfg.ckpt_every == 0
                                                      or step == n_steps):
                    t0 = time.perf_counter()
                    store.save(self.cfg.ckpt_dir, step, state)
                    self.save_times.append(time.perf_counter() - t0)
                    self._gc()
                continue
            except Exception:
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                log.exception("step %d failed; retry %d", step, retries)
            # outside the handler, so the traceback no longer holds the
            # failed step's tensors while the new state is built
            state = None
            state, step = self._restore_or_init()
        return state, metrics_log

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.cfg.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
