"""Calibrate the planner's CUDA remainder on the card.

  python -m repro_torch.launch.calibrate [--arch internlm2_1_8b gpt3_1_5b] \\
      [--executor eager graph] [--out PATH] \\
      [--layers N] [--p P] [--schedules zb-h1 zb-v] [--experts E] [--vocab V] \\
      [--seq-len S]

Counterpart of the ``--calibration-out`` path of the JAX package's
``launch/dryrun.py`` (``write_calibration_table``), but not a dry run: for
each arch and executor mode it trains every schedule of the launcher
(``launch/train.py::SCHEDULES``) for 3 steps at the calibration cell
(:data:`CELL`: p=4 stages on the one card, m=8 microbatches of 1 x 1024
tokens, bf16 weights from seed 0), as the launcher runs them (the
weights and AdamW state on the card, the first walk, in graph mode the
capture, before the driver's steps), and reads
``torch.cuda.max_memory_reserved`` over each run's own window
(``empty_cache`` and ``reset_peak_memory_stats`` before it): at the end of
the first walk and at the end of the run.  Against the planner's priced
one-card parts (``HBMPlanner.one_card_bytes``, measured fidelity, slots
measured on the card) each run gives a remainder (the walk's end peak less
weights, moments, accumulators and walk: the allocator's share beyond the
live bytes, and the live bytes the slots do not price), an overhang (what
the optimizer added after it, as a share of its priced transient) and a
reuse (what the transient held less than itself, as a share of the walk);
the record keeps the largest remainder parts and overhang and the
smallest reuse over the schedules, a ceiling.

A config too large for the card at the cell is measured at a cut:
``--layers`` (the depth), ``--p`` (the stages on the card), ``--experts``
(the routed experts of a moe config), ``--vocab`` and ``--seq-len`` (the
tokens a microbatch, after a vlm or encdec front) replace the config's and
the cell's; ``--schedules`` trains only those of the launcher's.  Every
other width and the cell's m and microbatch stay.  A record
measured at a cut stores it under ``cut`` (the layers, p and schedules it
ran, and the experts, vocab and seq_len when cut), and ``weights_bytes`` /
``m_b_bytes`` are the cut's, so the planner scales the remainder from the
cut to the run it prices.  Records are
merged into the table (``configs/cuda_temp_calibration.json`` unless
``--out`` names another), keyed by arch name and executor mode, keeping
every other record.  Without a CUDA card it raises: it never measures on
the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from typing import Dict, Optional, Sequence

import torch

from ..configs import get_config
from ..core.memory import CUDA_TEMP_TABLE, ActivationByteModel, record_key
from ..core.planner import EXECUTOR_MODES, HBMPlanner, stage_program_factory
from ..core.schedules import compile_plan
from ..data import DataConfig, SyntheticLM
from ..models.lm import RunSpec, init_params
from .steps import TrainStepConfig, build_train_step
from .train import SCHEDULES, init_state, make_schedule, side_from_batch, train

__all__ = ["card_name", "measure_run", "calibration_record", "write_calibration_table", "calibrate",
           "cut_config", "main"]


def card_name() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def calibration_record(cfg, executor_mode: str, runs: Dict[str, Dict[str, float]], *, p: int,
                       m: int, microbatch: int, seq_len: int, weights_bytes: float, card: str,
                       steps: int, seed: int, cut: Optional[dict] = None) -> dict:
    """The table record of one arch and executor mode from its runs:
    ``runs[schedule]`` holds the run's ``reserved`` and ``allocated``
    peaks, the same at the end of its first walk (``walk_reserved``,
    ``walk_allocated``), and the priced one-card parts: weights, moments,
    accumulators and walk (``priced``), the walk alone (``walk``) and the
    optimizer's ``transient``.  The remainder at the walk's end
    (``walk_reserved - priced``) is split in two parts with their own
    scale: what the allocator reserved beyond the live bytes
    (``walk_reserved - walk_allocated``: segments and their free tails,
    which do not shrink with the tensors; ``cuda_temp_fixed_bytes``) and
    the live bytes the walk's slots do not price (``walk_allocated -
    priced``: in-op scratch such as the fp32 scores and logits, which
    scale with the M_B unit; ``cuda_temp_scaled_bytes``), each the largest
    over the runs and at least 0; ``cuda_temp_bytes`` is their sum, all p
    stages on one card.  ``optimizer_overhang`` is the largest share of the
    transient a run added after its walk (``(reserved - walk_reserved) /
    transient``), ``optimizer_reuse`` the smallest share of its walk's
    bytes it reused (``(transient - (reserved - walk_reserved)) / walk``,
    at least 0).  ``m_b_bytes`` (the cell's modeled M_B unit) and
    ``weights_bytes`` (its weights and moments on one card) are the scale
    references of ``core/memory.py::default_cuda_temp_bytes``.  ``cut``
    (see :func:`cut_config`), when given, is stored as measured."""
    bm = ActivationByteModel.from_config(cfg, microbatch, seq_len, p, n_chunks=1)
    rem = {name: r["walk_reserved"] - r["priced"] for name, r in runs.items()}
    fixed = max(0.0, max(r["walk_reserved"] - r["walk_allocated"] for r in runs.values()))
    scaled = max(0.0, max(r["walk_allocated"] - r["priced"] for r in runs.values()))
    over = {name: (r["reserved"] - r["walk_reserved"]) / r["transient"] for name, r in runs.items()}
    reuse = {name: (r["transient"] - (r["reserved"] - r["walk_reserved"])) / r["walk"]
             for name, r in runs.items()}
    worst = max(rem, key=rem.get)
    return {
        **({} if cut is None else {"cut": dict(cut)}),
        "arch_id": cfg.name,
        "cuda_temp_bytes": fixed + scaled,
        "cuda_temp_fixed_bytes": fixed,
        "cuda_temp_scaled_bytes": scaled,
        "optimizer_overhang": max(0.0, max(over.values())),
        "optimizer_reuse": max(0.0, min(reuse.values())),
        "m_b_bytes": bm.m_b_bytes,
        "weights_bytes": float(weights_bytes),
        "modeled_schedule_bytes": runs[worst]["walk"],
        "p": p,
        "schedule": worst,
        "shape": f"p{p}_m{m}_b{microbatch}_s{seq_len}",
        "tokens": microbatch * seq_len,
        "tp": 1,
        "executor_mode": executor_mode,
        "devices": 1,
        "card": card,
        "dtype": cfg.dtype,
        "steps": steps,
        "seed": seed,
        "runs": {name: {**{k: float(v) for k, v in r.items()}, "remainder": float(rem[name]),
                        "overhang": float(over[name]), "reuse": float(reuse[name])}
                 for name, r in runs.items()},
    }


def write_calibration_table(records: Sequence[dict], path=None) -> dict:
    """Merge ``records`` into the table at ``path``, keyed by arch name,
    executor mode and depth (``core/memory.py::record_key``: a record
    replaces the one of its own cut, and one of another depth stays beside
    it, so an entry with more than one is a list); every other record
    stays, as the JAX writer keeps the other archs'.  Returns the table
    written."""
    path = path or CUDA_TEMP_TABLE
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    for rec in records:
        by_mode = table.setdefault(rec["arch_id"], {})
        have = by_mode.get(rec["executor_mode"], [])
        kept = [r for r in (have if isinstance(have, list) else [have])
                if record_key(r) != record_key(rec)]
        by_mode[rec["executor_mode"]] = kept + [rec] if kept else rec
    with open(path, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    return table


def measure_run(cfg, step, stacked, shared, spec, data, steps: int):
    """One run as the launcher trains, in the caller's memory window: the
    AdamW state on the card, the first walk (in graph mode the capture and a
    replay; its results dropped), then ``steps`` driver steps.  Returns
    ({reserved, allocated, walk_reserved, walk_allocated} peaks, the last
    two at the first walk's end; losses)."""
    state = init_state(stacked, shared)
    step.grad_fn(stacked, shared,
                 side_from_batch(data.batch_at(0), spec, shared["embed"].device, cfg))
    torch.cuda.synchronize()
    walk = dict(walk_reserved=torch.cuda.max_memory_reserved(),
                walk_allocated=torch.cuda.max_memory_allocated())
    res = train(cfg, spec, step, stacked, shared, data, steps, state=state)
    torch.cuda.synchronize()
    return (dict(reserved=torch.cuda.max_memory_reserved(),
                 allocated=torch.cuda.max_memory_allocated(), **walk), res.losses)


# the calibration cell: the train cell of ``chip_smoke.py`` (p stages on the
# one card, m microbatches of microbatch x seq_len tokens), its steps and seed
CELL = dict(p=4, m=8, microbatch=1, seq_len=1024)
STEPS, SEED = 3, 0
DEVICE = "cuda"  # the card it measures on


def cut_config(cfg, layers: Optional[int] = None, experts: Optional[int] = None,
               vocab: Optional[int] = None):
    """``cfg`` at a cut: ``layers`` for its depth, ``experts`` routed experts
    (a moe config; top-k and the shared experts stay), ``vocab``; None
    keeps the config's."""
    if experts is not None:
        ex = dict(cfg.extras)
        if "n_experts" not in ex:
            raise ValueError(f"{cfg.name} has no routed experts to cut")
        ex["n_experts"] = experts
        cfg = dataclasses.replace(cfg, extras=tuple(ex.items()))
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, vocab=vocab or cfg.vocab)


def calibrate(archs: Sequence[str], modes: Sequence[str], log=print, *,
              layers: Optional[int] = None, p: Optional[int] = None,
              schedules: Optional[Sequence[str]] = None, experts: Optional[int] = None,
              vocab: Optional[int] = None, seq_len: Optional[int] = None) -> list:
    """Train the launcher's schedules (``schedules``, default all) of each
    arch under each executor mode on the card at :data:`CELL` (its ``p`` and
    ``seq_len`` replaced by ``p`` and ``seq_len``, the config cut by
    :func:`cut_config`) and return one
    :func:`calibration_record` for each pair; a record of a cut stores
    it."""
    if not torch.cuda.is_available():
        raise RuntimeError("launch/calibrate.py measures on a CUDA card and none is visible")
    for mode in modes:
        if mode not in EXECUTOR_MODES:
            raise ValueError(f"unknown executor mode {mode!r}")
    names = list(schedules or SCHEDULES)
    unknown = [n for n in names if n not in SCHEDULES]
    if unknown:
        raise ValueError(f"unknown schedules {unknown} (the launcher's: {sorted(SCHEDULES)})")
    given = dict(experts=experts, vocab=vocab, seq_len=seq_len)  # the cut's optional parts
    cell = dict(CELL, p=p or CELL["p"], seq_len=seq_len or CELL["seq_len"])
    cutting = (layers, p, schedules, experts, vocab, seq_len) != (None,) * 6
    device = torch.device(DEVICE)
    card = card_name()
    p, m, microbatch, seq_len = (cell[k] for k in ("p", "m", "microbatch", "seq_len"))
    records = []
    for arch in archs:
        cfg = cut_config(get_config(arch), layers, experts, vocab)
        cut = None
        if cutting:
            cut = {"layers": cfg.n_layers, "p": p, "schedules": names}
            cut.update({k: v for k, v in given.items() if v is not None})
        planner = HBMPlanner(cfg, **cell, program_factory=stage_program_factory(
            cfg, p, m, microbatch, seq_len, device, SEED))
        for c in sorted({make_schedule(n, p, m).n_chunks for n in names}):
            planner.slot_bytes(c)  # the slots, measured on the card once
        for mode in modes:
            runs = {}
            for name in names:
                sched = make_schedule(name, p, m)
                spec = RunSpec(p=p, n_chunks=sched.n_chunks, microbatch=microbatch,
                               seq_len=seq_len, m=m)
                stacked, shared = init_params(cfg, spec, sched.placement, seed=SEED, device=device)
                step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement,
                                           TrainStepConfig(executor_mode=mode))
                data = SyntheticLM(DataConfig(global_batch=m * microbatch, seq_len=seq_len,
                                              vocab=cfg.vocab, seed=SEED))
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                runs[name], losses = measure_run(cfg, step, stacked, shared, spec, data, STEPS)
                one = planner.one_card_bytes(sched, mode)
                r = runs[name]
                r.update(priced=one.weights + one.accumulators + one.walk, walk=one.walk,
                         transient=one.transient)
                log(f"[calibrate] {cfg.name} {mode} {name}: reserved {r['reserved'] / 2**30:.3f} "
                    f"GiB ({r['walk_reserved'] / 2**30:.3f} at the first walk's end), allocated "
                    f"{r['allocated'] / 2**30:.3f} GiB ({r['walk_allocated'] / 2**30:.3f}); priced "
                    f"weights and moments "
                    f"{one.weights / 2**30:.3f} + accumulators {one.accumulators / 2**30:.3f} + walk "
                    f"{one.walk / 2**30:.3f} GiB, transient {one.transient / 2**30:.3f} GiB; "
                    f"remainder {(r['walk_reserved'] - r['priced']) / 2**30:.3f} GiB, the "
                    f"optimizer held {(r['reserved'] - r['walk_reserved']) / 2**30:.3f} GiB on top "
                    f"of the walk; losses {losses}")
                del stacked, shared, step
                torch.cuda.empty_cache()
            st = planner.state(1)
            rec = calibration_record(cfg, mode, runs, **cell,
                                     weights_bytes=st.params_card + st.optim_card, card=card,
                                     steps=STEPS, seed=SEED, cut=cut)
            log(f"[calibrate] {cfg.name} {mode}: remainder {rec['cuda_temp_bytes'] / 2**30:.3f} "
                f"GiB (one card: allocator {rec['cuda_temp_fixed_bytes'] / 2**30:.3f} + unpriced "
                f"live {rec['cuda_temp_scaled_bytes'] / 2**30:.3f}), optimizer overhang "
                f"{rec['optimizer_overhang']:.4f} and reuse {rec['optimizer_reuse']:.4f}, on {card}")
            records.append(rec)
    return records


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["internlm2_1_8b", "gpt3_1_5b"])
    ap.add_argument("--executor", nargs="+", default=list(EXECUTOR_MODES),
                    choices=list(EXECUTOR_MODES))
    ap.add_argument("--out", default=None,
                    help=f"the table to merge the records into (default {CUDA_TEMP_TABLE})")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to this many layers")
    ap.add_argument("--p", type=int, default=None, help=f"stages on the card (default {CELL['p']})")
    ap.add_argument("--schedules", nargs="+", default=None, choices=sorted(SCHEDULES),
                    help="train only these schedules (default: all of the launcher's)")
    ap.add_argument("--experts", type=int, default=None, help="cut the routed experts to this many")
    ap.add_argument("--vocab", type=int, default=None, help="cut the vocabulary to this size")
    ap.add_argument("--seq-len", type=int, default=None,
                    help=f"tokens a microbatch (default {CELL['seq_len']})")
    args = ap.parse_args(argv)
    records = calibrate(args.arch, args.executor, layers=args.layers, p=args.p,
                        schedules=args.schedules, experts=args.experts, vocab=args.vocab,
                        seq_len=args.seq_len)
    write_calibration_table(records, args.out)
    print(f"[calibrate] wrote {len(records)} record(s) to {args.out or CUDA_TEMP_TABLE}")
    return records


if __name__ == "__main__":
    main()
