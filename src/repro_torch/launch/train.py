"""Pipelined zero-bubble training launcher of the port.

  python -m repro_torch.launch.train --arch internlm2_1_8b \\
      --pipe-size 4 --schedule zb-h1 --microbatch 1 --seq-len 1024 --m 8 --steps 3

All p stages sit on one device.  Runs on the CUDA card by default and raises
when there is none; it never carries on on the CPU unless ``--device cpu``
asks for it.  Weights are random, drawn from ``--seed``; batches come from the
seeded synthetic stream (``data.SyntheticLM``).  Schedules: every one the JAX
launcher accepts -- 1f1b, zb-h1, zb-h2, zb-v, v-min, v-half, zb-1p, zb-2p; the
V-shaped ones (zb-v, v-min, v-half) run two chunks a stage.  Checkpointing,
the fault-tolerant driver, the executor modes and the memory-budget planner
of the JAX launcher are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..core.schedules import (
    compile_plan,
    one_f_one_b,
    v_half,
    v_min,
    zb_1p,
    zb_2p,
    zb_h1,
    zb_h2,
    zb_v,
)
from ..data import DataConfig, SyntheticLM
from ..models.lm import ArchConfig, RunSpec, init_params
from ..optim import adamw
from .serve import resolve_device
from .steps import TrainStepConfig, build_train_step

__all__ = ["SCHEDULES", "TrainResult", "build_everything", "side_from_batch", "train", "main"]

SCHEDULES = {
    "1f1b": one_f_one_b,
    "zb-h1": zb_h1,
    "zb-h2": zb_h2,
    "zb-v": zb_v,
    "v-min": v_min,
    "v-half": v_half,
    "zb-1p": zb_1p,
    "zb-2p": zb_2p,
}


def make_schedule(name: str, p: int, m: int):
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}")
    return SCHEDULES[name](p, m)


def build_everything(arch: str, reduced: bool, pipe_size: int, schedule: str, microbatch: int,
                     seq_len: int, m: int, tcfg: TrainStepConfig):
    """-> (cfg, spec, schedule, step) for the given run."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    sched = make_schedule(schedule, pipe_size, m)
    spec = RunSpec(p=pipe_size, n_chunks=sched.n_chunks, microbatch=microbatch,
                   seq_len=seq_len, m=m)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, tcfg)
    return cfg, spec, sched, step


def side_from_batch(batch: Dict[str, np.ndarray], spec: RunSpec, device) -> Dict[str, torch.Tensor]:
    """(m*b, s) numpy batch -> per-microbatch side inputs on ``device``."""
    m, b, s = spec.m, spec.microbatch, spec.seq_len
    return {
        "tokens": torch.as_tensor(batch["tokens"].reshape(m, b, s), dtype=torch.long, device=device),
        "labels": torch.as_tensor(batch["labels"].reshape(m, b, s), dtype=torch.long, device=device),
        "positions": torch.arange(s, device=device).expand(m, s),
    }


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    grad_norms: List[float]
    amended: List[bool]
    step_s: List[float]  # host seconds per step, each ending in a device synchronise


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg: ArchConfig, spec: RunSpec, step: Callable, stacked, shared, data: SyntheticLM,
          steps: int, *, log: Optional[Callable[[str], None]] = None) -> TrainResult:
    """Run ``steps`` training steps on batches 0, 1, ...; parameters and a
    fresh AdamW state live on the device of ``shared`` and are updated in
    place."""
    device = shared["embed"].device
    opt, shared_opt = adamw.init(stacked), adamw.init(shared)
    res = TrainResult([], [], [], [])
    for k in range(steps):
        side = side_from_batch(data.batch_at(k), spec, device)
        _sync(device)
        t0 = time.perf_counter()
        stacked, shared, opt, shared_opt, met = step(stacked, shared, opt, shared_opt, side)
        _sync(device)
        res.step_s.append(time.perf_counter() - t0)
        res.losses.append(float(met["loss"]))
        res.grad_norms.append(float(met["grad_norm"]))
        res.amended.append(bool(met["amended"]))
        if log:
            log(f"step {k}: loss={res.losses[-1]:.6f} grad_norm={res.grad_norms[-1]:.6f} "
                f"amended={res.amended[-1]} {res.step_s[-1]:.3f}s")
    return res


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pipe-size", type=int, default=4)
    ap.add_argument("--schedule", default="zb-h2", choices=sorted(SCHEDULES))
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--postval", default="within_step", choices=["within_step", "sync"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=args.lr), postval_mode=args.postval)
    cfg, spec, sched, step = build_everything(args.arch, args.reduced, args.pipe_size,
                                              args.schedule, args.microbatch, args.seq_len,
                                              args.m, tcfg)
    data = SyntheticLM(DataConfig(global_batch=spec.m * spec.microbatch, seq_len=spec.seq_len,
                                  vocab=cfg.vocab, seed=args.seed))
    stacked, shared = init_params(cfg, spec, sched.placement, seed=args.seed, device=device)
    t0 = time.perf_counter()
    res = train(cfg, spec, step, stacked, shared, data, args.steps, log=print)
    dt = time.perf_counter() - t0
    print(f"steps={len(res.losses)} wall={dt:.1f}s steps/s={len(res.losses) / dt:.3f} "
          f"loss[0]={res.losses[0]:.4f} loss[-1]={res.losses[-1]:.4f} schedule={sched.name}")
    assert res.losses[-1] < res.losses[0], "loss must decrease on the synthetic stream"
    return res


if __name__ == "__main__":
    main()
