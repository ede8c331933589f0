"""Pipelined zero-bubble training launcher of the port.

  python -m repro_torch.launch.train --arch gpt3_1_5b \\
      --pipe-size 4 --schedule zb-h1 --microbatch 1 --seq-len 1024 --m 8 --steps 3 \\
      [--memory-budget-mb 10240] [--ckpt-dir DIR]
  python -m repro_torch.launch.train --procs 4 --pipe-size 4 [--share-card] ...
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --procs 4 --pipe-size 4 ...

Without ``--procs`` all p stages sit in one process on one device.  With
``--procs P`` (P = ``--pipe-size``) each stage is a process of its own
(``launch/mesh.py::PipeGroup``, ``core/p2p.py``): the launcher starts P
ranks that meet through a file store in a temporary directory, or, under
torchrun, this process is one rank.  Rank s takes ``cuda:s`` when the
machine has a card for every rank, ``cuda:0`` for every rank with
``--share-card``, the CPU with ``--device cpu``; fewer cards than ranks and
no ``--share-card`` raises.  The transport is ``host`` (gloo through pinned
host buffers; the first line printed names it), the walk eager (the last
line says ``executor=eager procs=P transport=host``), every rank prints its
device, its stage's parameter bytes and its reserved peak, and rank 0 the
usual summary.  ``--ckpt-dir`` with ``--procs`` raises: per-rank
checkpoints are not ported (ROADMAP Queue 1, item 13).

Runs on the CUDA card by default and raises when there is none; it never
carries on on the CPU unless ``--device cpu``
asks for it.  Weights are random, drawn from ``--seed``; batches come from the
seeded synthetic stream (``data.SyntheticLM``).  Schedules: every one the JAX
launcher accepts -- 1f1b, zb-h1, zb-h2, zb-v, v-min, v-half, zb-1p, zb-2p; the
V-shaped ones (zb-v, v-min, v-half) run two chunks a stage.
``--memory-budget-mb`` replaces ``--schedule`` by the HBM planner's choice:
the fastest schedule of any family whose per-device bytes (one stage's
parameters and AdamW moments, activations, W-contexts, inboxes, sink, and
temp: the fp32 gradient accumulators, the optimizer's transient and the
CUDA remainder calibrated on the card for the executor mode it will run)
fit the budget, with the activation, W-context, inbox and sink slots
measured on the run's device (the planner's measured fidelity).  It prints
the itemized breakdown, temp with its three parts, and the chosen plan's
priced total on one card holding all p stages; on the card, after the
first step, ``torch.cuda.max_memory_reserved`` beside that total.  An arch
with no calibration record is priced with no remainder, and the launcher
says so.  The steps run under the fault-tolerant driver
(``runtime/driver.py``): with ``--ckpt-dir`` it checkpoints every
max(steps // 2, 10) steps and at the last, resumes from the newest
checkpoint there and retries a failed step from it; without, nothing is
saved.  The device picks the pipeline's executor mode (the JAX
launcher's ``--executor``): on the card the step's pipeline walk is
captured once into a CUDA graph and replayed every step (``graph``, as the
JAX launcher defaults to its compiled ``specialized`` mode); on the CPU the
host walks the ticks every step (``eager``).  The optimizer runs eagerly
under both.  The JAX launcher's persistent compile cache has no
counterpart: a CUDA graph cannot outlive its process.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..core.memory import CUDA_TEMP_TABLE, cuda_temp_record, record_key
from ..core.executor import stage_slice
from ..core.planner import stage_program_factory
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
from ..models.lm import ArchConfig, RunSpec, front_spec, init_params
from ..optim import adamw
from ..tree import tree_leaves
from ..runtime import DriverConfig, TrainDriver, replan_under_budget
from .mesh import PIPE_TIMEOUT_S, init_pipe_group, pipe_device, spawn_ranks
from .serve import _sync, resolve_device
from .steps import TrainStepConfig, build_stage_train_step, build_train_step

__all__ = ["SCHEDULES", "TrainResult", "build_everything", "side_from_batch", "init_state",
           "make_step_fn", "make_data_at", "train", "main"]

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


def run_config(arch: str, reduced: bool, layers: Optional[int] = None) -> ArchConfig:
    """The run's config: ``arch`` (reduced or not), its depth cut to
    ``layers`` when given (as ``launch/calibrate.py --layers``)."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def build_everything(arch: str, reduced: bool, pipe_size: int, schedule: str, microbatch: int,
                     seq_len: int, m: int, tcfg: TrainStepConfig,
                     memory_budget_bytes: Optional[float] = None, *, device,
                     seed: int = 0, layers: Optional[int] = None):
    """-> (cfg, spec, schedule, step, one_card) for the given run.  With a
    budget, the schedule is the HBM planner's choice and ``schedule`` is not
    read: the planner prices the slots it measures on ``device`` (one
    microbatch's F and B of each chunk count, with stage 0 of the ``seed``
    weights) and the temp term of ``tcfg.executor_mode``, and ``one_card``
    is the chosen plan's priced total on one card
    (:class:`~repro_torch.core.planner.OneCardBytes`); without, it is None.
    ``layers`` cuts the config's depth (as ``launch/calibrate.py --layers``)."""
    cfg, sched, one_card = plan_schedule(arch, reduced, pipe_size, schedule, microbatch, seq_len,
                                         m, tcfg, memory_budget_bytes, device=device, seed=seed,
                                         layers=layers)
    spec = RunSpec(p=pipe_size, n_chunks=sched.n_chunks, microbatch=microbatch,
                   seq_len=seq_len, m=m)
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, tcfg)
    return cfg, spec, sched, step, one_card


def plan_schedule(arch: str, reduced: bool, pipe_size: int, schedule: str, microbatch: int,
                  seq_len: int, m: int, tcfg: TrainStepConfig,
                  memory_budget_bytes: Optional[float] = None, *, device, seed: int = 0,
                  layers: Optional[int] = None):
    """-> (cfg, schedule, one_card): :func:`build_everything`'s choice of
    schedule, the step not built."""
    cfg = run_config(arch, reduced, layers)
    depth = get_config(arch).n_layers  # what a record with no cut was measured at
    one_card = None
    if memory_budget_bytes is not None:
        factory = stage_program_factory(cfg, pipe_size, m, microbatch, seq_len, device, seed)
        sched, report = replan_under_budget(cfg, pipe_size, m, microbatch, seq_len,
                                            memory_budget_bytes, program_factory=factory,
                                            executor_mode=tcfg.executor_mode)
        print(f"HBM planner: {report.summary()}")
        print(f"per-device HBM breakdown (slots measured on the run's device, temp of the "
              f"{tcfg.executor_mode} executor):")
        print(report.chosen.breakdown.report())
        rec = cuda_temp_record(cfg.name, tcfg.executor_mode, layers=cfg.n_layers, p=pipe_size,
                               seq_len=seq_len)
        if rec is None:
            print(f"temp remainder 0: no calibration record for {cfg.name} under the "
                  f"{tcfg.executor_mode} executor in {CUDA_TEMP_TABLE.name} (accumulators and "
                  f"optimizer transient priced; run launch/calibrate.py on the card)")
        else:
            cut = rec.get("cut")
            at = (f"{cut['layers']} layers at p={cut['p']}, {' '.join(cut['schedules'])}"
                  + "".join(f", {k} {cut[k]}" for k in ("experts", "vocab", "seq_len")
                            if k in cut)
                  if cut else f"the full depth at p={rec['p']}, every schedule")
            layers_at, p_at, seq_at = record_key(rec)
            at_depth = (layers_at or depth, p_at)
            print(f"temp remainder from the calibration record of {cfg.name} under the "
                  f"{tcfg.executor_mode} executor, measured at {at} ({rec.get('card')}), "
                  f"scaled to this run"
                  + (f" at seq {seq_len}: no record was measured at that sequence length"
                     if at_depth == (cfg.n_layers, pipe_size) and seq_at != seq_len else
                     "" if at_depth == (cfg.n_layers, pipe_size) else
                     f" of {cfg.n_layers} layers at p={pipe_size}: no record was measured at "
                     f"that depth, so the price is an extrapolation no card run has checked"))
        one_card = report.planner.one_card_bytes(sched)
        print(f"priced on one card holding all {pipe_size} stages: {one_card.report()}")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()  # the slot measurement's cached blocks
    else:
        sched = make_schedule(schedule, pipe_size, m)
    return cfg, sched, one_card


def side_from_batch(batch: Dict[str, np.ndarray], spec: RunSpec, device,
                    cfg: Optional[ArchConfig] = None) -> Dict[str, torch.Tensor]:
    """(m*b, s) numpy batch -> per-microbatch side inputs on ``device``.
    With a vlm or encdec ``cfg`` its front's embeddings are zeros (m, b, n,
    frontend_dim) in the model dtype, as the JAX launcher feeds them, and
    the positions run over the front and the tokens."""
    m, b, s = spec.m, spec.microbatch, spec.seq_len
    side = {
        "tokens": torch.as_tensor(batch["tokens"].reshape(m, b, s), dtype=torch.long, device=device),
        "labels": torch.as_tensor(batch["labels"].reshape(m, b, s), dtype=torch.long, device=device),
    }
    front = None if cfg is None else front_spec(cfg)
    if front is not None:
        key, n, width = front
        side[key] = torch.zeros((m, b, n, width), dtype=cfg.torch_dtype(), device=device)
        s += n
    side["positions"] = torch.arange(s, device=device).expand(m, s)
    return side


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    grad_norms: List[float]
    amended: List[bool]
    step_s: List[float]  # host seconds per step, from an idle card to the metrics on the host
    state: Optional[Dict[str, Any]] = None  # the driver's final state (main only)
    schedule: Any = None  # the schedule that ran (main only)
    save_s: List[float] = dataclasses.field(default_factory=list)  # checkpoint saves (main only)


def init_state(stacked, shared) -> Dict[str, Any]:
    """The driver's state: the parameters and a fresh AdamW state beside
    them, on the parameters' device."""
    return dict(params=stacked, shared=shared, opt=adamw.init(stacked),
                shared_opt=adamw.init(shared))


def make_step_fn(step: Callable) -> Callable:
    """The driver's ``step_fn(state, side) -> (state, metrics)`` over the
    training step; it updates the state's tensors in place."""

    def step_fn(state, side):
        stacked, shared, opt, shared_opt, metrics = step(
            state["params"], state["shared"], state["opt"], state["shared_opt"], side)
        return dict(params=stacked, shared=shared, opt=opt, shared_opt=shared_opt), metrics

    return step_fn


def _print_reserved_after_first_step(step_fn: Callable, device, one_card) -> Callable:
    """``step_fn`` that prints the card's reserved bytes after its first
    step (the CUDA graph's pool is in them), beside the plan's priced
    one-card total when the planner chose the schedule."""
    done = []

    def fn(state, side):
        out = step_fn(state, side)
        if not done:
            done.append(True)
            priced = ("" if one_card is None else
                      f"; priced one-card total {one_card.total / 2**20:.1f} MiB")
            print(f"max_memory_reserved after the first step "
                  f"{torch.cuda.max_memory_reserved(device) / 2**20:.1f} MiB{priced}")
        return out

    return fn


def make_data_at(data: SyntheticLM, spec: RunSpec, device,
                 cfg: Optional[ArchConfig] = None) -> Callable[[int], Dict]:
    """The driver's ``data_at(step)``: that step's side inputs on ``device``
    (``side_from_batch`` of ``cfg``), the copy finished, so the driver's
    step time starts on an idle card."""
    device = torch.device(device)

    def data_at(k: int):
        side = side_from_batch(data.batch_at(k), spec, device, cfg)
        _sync(device)
        return side

    return data_at


def _result(driver: TrainDriver, metrics_log, log: Optional[Callable[[str], None]]) -> TrainResult:
    res = TrainResult([], [], [], list(driver.step_times))
    for (k, met), dt in zip(metrics_log, driver.step_times):
        res.losses.append(met["loss"])
        res.grad_norms.append(met["grad_norm"])
        res.amended.append(bool(met["amended"]))
        if log:
            log(f"step {k}: loss={met['loss']:.6f} grad_norm={met['grad_norm']:.6f} "
                f"amended={bool(met['amended'])} {dt:.3f}s")
    return res


def train(cfg: ArchConfig, spec: RunSpec, step: Callable, stacked, shared, data: SyntheticLM,
          steps: int, *, log: Optional[Callable[[str], None]] = None,
          state: Optional[Dict[str, Any]] = None) -> TrainResult:
    """Run ``steps`` training steps on batches 0, 1, ... through the driver,
    without checkpoints or retries; ``stacked`` and ``shared`` and the AdamW
    state beside them are updated in place: ``state`` (an
    :func:`init_state` of them made earlier, e.g. before a capture, as the
    launcher's driver makes it) or a fresh one."""
    device = shared["embed"].device
    driver = TrainDriver(DriverConfig(ckpt_dir=None, max_retries=0), make_step_fn(step),
                         (lambda: state) if state is not None else
                         (lambda: init_state(stacked, shared)),
                         make_data_at(data, spec, device, cfg))
    _, metrics_log = driver.run(steps)
    return _result(driver, metrics_log, log)


def main(argv: Optional[Sequence[str]] = None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt3_1_5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the config's)")
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: save every max(steps // 2, 10) steps and at "
                    "the last, resume from the newest checkpoint in it (default: none)")
    ap.add_argument("--memory-budget-mb", type=float, default=None,
                    help="per-device HBM budget: params + AdamW moments + inbox/sink + "
                    "schedule memory, its slots measured on --device, + temp (the fp32 "
                    "gradient accumulators, the optimizer's transient and the CUDA remainder "
                    "calibrated on the card); runs the fastest schedule of any family that "
                    "fits (overrides --schedule)")
    ap.add_argument("--procs", type=int, default=None,
                    help="one process a pipeline stage: start this many ranks (= --pipe-size); "
                    "under torchrun this process is one of them")
    ap.add_argument("--share-card", action="store_true",
                    help="with --procs: every rank on cuda:0 (else rank s on cuda:s)")
    ap.add_argument("--transport", default="host", choices=["host", "nccl"],
                    help="with --procs: how the ranks' messages travel (nccl is not ported)")
    args = ap.parse_args(argv)
    if args.procs is not None:
        return _main_procs(args)

    device = resolve_device(args.device)
    executor = "graph" if device.type == "cuda" else "eager"
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=args.lr), postval_mode=args.postval,
                           executor_mode=executor)
    budget = None if args.memory_budget_mb is None else args.memory_budget_mb * 2**20
    cfg, spec, sched, step, one_card = build_everything(
        args.arch, args.reduced, args.pipe_size, args.schedule, args.microbatch, args.seq_len,
        args.m, tcfg, memory_budget_bytes=budget, device=device, seed=args.seed,
        layers=args.layers)
    data = SyntheticLM(DataConfig(global_batch=spec.m * spec.microbatch, seq_len=spec.seq_len,
                                  vocab=cfg.vocab, seed=args.seed))

    def fresh_state():
        stacked, shared = init_params(cfg, spec, sched.placement, seed=args.seed, device=device)
        return init_state(stacked, shared)

    step_fn = make_step_fn(step)
    if device.type == "cuda":
        step_fn = _print_reserved_after_first_step(step_fn, device, one_card)
    driver = TrainDriver(DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 2, 10)),
                         step_fn, fresh_state, make_data_at(data, spec, device, cfg))
    t0 = time.perf_counter()
    state, metrics_log = driver.run(args.steps)
    dt = time.perf_counter() - t0
    res = _result(driver, metrics_log, print)
    res.state, res.schedule, res.save_s = state, sched, list(driver.save_times)
    if not res.losses:
        print(f"steps=0: the checkpoint in {args.ckpt_dir} is at step {args.steps} already")
        return res
    tput = driver.throughput()
    tput_s = f" steps/s={tput:.3f}" if tput else ""
    print(f"steps={len(res.losses)} wall={dt:.1f}s{tput_s} "
          f"loss[0]={res.losses[0]:.4f} loss[-1]={res.losses[-1]:.4f} schedule={sched.name} "
          f"executor={executor}")
    if len(res.losses) > 1 and not res.losses[-1] < res.losses[0]:
        raise RuntimeError("loss must decrease on the synthetic stream")
    return res


def _check_procs(args) -> None:
    """What a run of one process a stage refuses, before any rank starts."""
    if args.procs != args.pipe_size:
        raise ValueError(f"--procs {args.procs} must equal --pipe-size {args.pipe_size}: one "
                         f"process a pipeline stage")
    if args.ckpt_dir is not None:
        raise NotImplementedError(
            "--ckpt-dir with --procs: per-rank checkpoints and the recovery from a failed step "
            "across ranks are not ported (ROADMAP Queue 1, item 13); run without --ckpt-dir")
    if args.transport != "host":
        raise NotImplementedError(
            f"--transport {args.transport}: only the host transport is ported; NCCL between "
            f"cards waits for a machine with four cards (ROADMAP Queue 1, item 1)")
    pipe_device(args.device, 0, args.procs, args.share_card)


def _main_procs(args) -> Optional[TrainResult]:
    """``--procs P``: P ranks, one a stage, spawned here, or this process
    one of them under torchrun.  Returns rank 0's result (None on the
    other ranks under torchrun)."""
    _check_procs(args)
    torchrun = "WORLD_SIZE" in os.environ and "RANK" in os.environ
    if torchrun and int(os.environ["WORLD_SIZE"]) != args.procs:
        raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} processes, --procs is "
                         f"{args.procs}")
    if not torchrun or int(os.environ["RANK"]) == 0:
        where = ("every rank on cuda:0" if args.share_card else
                 "rank s on cuda:s" if torch.device(args.device).type == "cuda" else
                 "every rank on the cpu")
        print(f"pipe group: procs={args.procs} transport={args.transport} (gloo point-to-point "
              f"through {'pinned ' if torch.device(args.device).type == 'cuda' else ''}host "
              f"buffers), one process a stage, {where}", flush=True)
    opts = vars(args)
    if torchrun:
        return _rank_main(int(os.environ["RANK"]), args.procs, None, opts, None)
    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        spawn_ranks(_rank_main, args.procs, (opts, out),
                    timeout_s=PIPE_TIMEOUT_S * (args.steps + 10))
        with open(out, "rb") as f:
            return pickle.load(f)


def _rank_main(rank: int, world: int, init_method: Optional[str], opts: Dict[str, Any],
               out: Optional[str]) -> Optional[TrainResult]:
    """One rank of ``--procs``: stage ``rank`` of the run ``opts`` (the
    launcher's arguments) describes; rank 0 prints the summary and writes
    its result to ``out``."""
    args = argparse.Namespace(**opts)
    if torch.device(args.device).type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(1)
    local = int(os.environ.get("LOCAL_RANK", rank))
    group = init_pipe_group(rank=rank, world=world, init_method=init_method or "env://",
                            local_rank=local, device=args.device, share_card=args.share_card,
                            transport=args.transport)
    try:
        return _train_rank(group, args, out)
    finally:
        group.close()


def _train_rank(group, args, out: Optional[str]) -> Optional[TrainResult]:
    device, rank = group.device, group.rank
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(lr=args.lr), postval_mode=args.postval,
                           executor_mode="eager")
    budget = None if args.memory_budget_mb is None else args.memory_budget_mb * 2**20
    # rank 0 picks the schedule (under a budget the planner measures on its
    # device) and hands it to the others
    pick = [None]
    if rank == 0:
        pick[0] = plan_schedule(args.arch, args.reduced, args.pipe_size, args.schedule,
                                args.microbatch, args.seq_len, args.m, tcfg, budget,
                                device=device, seed=args.seed, layers=args.layers)[1]
    torch.distributed.broadcast_object_list(pick, src=0)
    sched = pick[0]
    cfg = run_config(args.arch, args.reduced, args.layers)
    spec = RunSpec(p=args.pipe_size, n_chunks=sched.n_chunks, microbatch=args.microbatch,
                   seq_len=args.seq_len, m=args.m)
    step, _ = build_stage_train_step(cfg, spec, compile_plan(sched), sched.placement, group,
                                     tcfg)
    data = SyntheticLM(DataConfig(global_batch=spec.m * spec.microbatch, seq_len=spec.seq_len,
                                  vocab=cfg.vocab, seed=args.seed))

    def fresh_state():
        # every stage's weights drawn as the one-process launcher draws them,
        # this rank's kept
        stacked, shared = init_params(cfg, spec, sched.placement, seed=args.seed, device=device)
        params = stage_slice(stacked, rank)
        del stacked
        return init_state(params, shared)

    driver = TrainDriver(DriverConfig(ckpt_dir=None, max_retries=0), make_step_fn(step),
                         fresh_state, make_data_at(data, spec, device, cfg))
    t0 = time.perf_counter()
    state, metrics_log = driver.run(args.steps)
    dt = time.perf_counter() - t0
    res = _result(driver, metrics_log, print if rank == 0 else None)
    res.schedule = sched
    stage_b = sum(t.numel() * t.element_size() for t in tree_leaves(state["params"]))
    shared_b = sum(t.numel() * t.element_size() for t in tree_leaves(state["shared"]))
    reserved = (f"{torch.cuda.max_memory_reserved(device) / 2**20:.1f} MiB"
                if device.type == "cuda" else "n/a on the cpu")
    lines = [None] * group.world if rank == 0 else None
    torch.distributed.gather_object(
        f"rank {rank}: device {device}, stage {rank}'s parameters {stage_b + shared_b} bytes "
        f"({stage_b} of its blocks + {shared_b} of the shared replica), max_memory_reserved "
        f"{reserved}", lines, dst=0)
    if rank != 0:
        return None
    print("\n".join(lines), flush=True)
    tput = driver.throughput()
    tput_s = f" steps/s={tput:.3f}" if tput else ""
    print(f"steps={len(res.losses)} wall={dt:.1f}s{tput_s} loss[0]={res.losses[0]:.4f} "
          f"loss[-1]={res.losses[-1]:.4f} schedule={sched.name} executor=eager "
          f"procs={group.world} transport={group.transport}", flush=True)
    if out is not None:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    if len(res.losses) > 1 and not res.losses[-1] < res.losses[0]:
        raise RuntimeError("loss must decrease on the synthetic stream")
    return res


if __name__ == "__main__":
    main()
