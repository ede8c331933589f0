"""Quickstart: build zero-bubble schedules, inspect them, run a pipelined loss.

  python -m repro_torch.examples.quickstart [--device cuda|cpu]

Counterpart of ``examples/quickstart.py``: the same schedules, times and
model, through the port's schedules, simulator and executor.  Parts 1-2
run on the host; part 3 runs the pipelined loss of reduced internlm2 under
ZB-H2 on ``--device`` (the CUDA card by default; it raises when there is
none).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs import get_reduced
from ..core.executor import PipelineExecutor
from ..core.schedules import compile_plan, one_f_one_b, search, zb_h1, zb_h2, zb_v
from ..core.simulator import TimeModel, simulate
from ..launch.serve import resolve_device
from ..models.lm import RunSpec, build_program, init_params, side_inputs

__all__ = ["P", "M", "PROFILED", "schedule_rows", "auto_bubble_rate", "pipelined_loss", "main"]

P, M = 4, 8
TIMES = TimeModel(t_f=1.0, t_b=1.0, t_w=1.0, t_comm=0.0)
PROFILED = TimeModel(t_f=18.5, t_b=18.1, t_w=9.3, t_comm=0.6)  # paper Sec. 3
# part 3: reduced internlm2, one stage, four microbatches of 2 x 16 tokens
ARCH, SPEC = "internlm2_1_8b", RunSpec(p=1, n_chunks=1, microbatch=2, seq_len=16, m=4)


def schedule_rows(p: int = P, m: int = M) -> List[Tuple[str, float, float]]:
    """(name, simulated bubble rate, peak memory in M_B) of 1F1B (its W
    grouped with B), ZB-H1, ZB-H2 and ZB-V at (p, m)."""
    rows = []
    for sched, tm in [(one_f_one_b(p, m), TimeModel(1, 1, 1, 0, grouped_w=True)),
                      (zb_h1(p, m), TIMES), (zb_h2(p, m), TIMES), (zb_v(p, m), TIMES)]:
        r = simulate(sched, tm)
        mem = sched.memory_profile(1.0 / sched.n_chunks, 0.5 / sched.n_chunks)
        rows.append((sched.name, r.bubble_rate, mem.max_peak))
    return rows


def auto_bubble_rate(p: int = P, m: int = M) -> float:
    """The bubble rate of the automatic search on the profiled times under
    a memory limit of 2p M_B (paper Sec. 3)."""
    return search(p, m, PROFILED, m_limit=2.0 * p).bubble_rate


def pipelined_loss(device, params=None, side: Optional[Dict] = None) -> torch.Tensor:
    """The pipelined loss of reduced internlm2 under ``zb_h2(1, 4)`` on
    ``device``: ``params`` (stacked, shared) and ``side`` default to the
    port's seed-0 weights and its seeded side inputs."""
    cfg = get_reduced(ARCH)
    sched = zb_h2(SPEC.p, SPEC.m)
    grad_fn = PipelineExecutor(build_program(cfg, SPEC, sched.placement),
                               compile_plan(sched)).build_grad_fn()
    stacked, shared = params if params is not None else init_params(
        cfg, SPEC, sched.placement, device=device)
    side = side if side is not None else side_inputs(cfg, SPEC)
    side = {k: torch.as_tensor(np.array(v), device=device) for k, v in side.items()}
    return grad_fn(stacked, shared, side)[2]


def main(argv: Optional[Sequence[str]] = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. schedules and bubbles (the paper's core object) ------------- #
    print("== 1F1B ==")
    print(one_f_one_b(P, M).render())
    print("== ZB-H2 (zero bubble, 2x memory) ==")
    print(zb_h2(P, M).render())
    print("== ZB-V (zero bubble, 1F1B memory) ==")
    print(zb_v(P, M).render())
    for name, rate, peak in schedule_rows():
        print(f"{name:8s} bubble_rate={rate:.4f} peak_mem={peak:.1f} M_B")

    # --- 2. automatic scheduling with profiled times (paper Sec. 3) ----- #
    print(f"\nauto ZB-2p schedule: bubble_rate={auto_bubble_rate():.4f}")

    # --- 3. a real pipelined loss on the device ------------------------- #
    loss = float(pipelined_loss(device))
    print("\npipelined loss:", loss)
    print("OK")
    return loss


if __name__ == "__main__":
    main()
