#!/usr/bin/env python3
"""Where training on the V placement parts from training on the linear one.

    PYTHONPATH=src python3 tools/placement_gap.py                 # on the card
    PYTHONPATH=src python3 tools/placement_gap.py --device cpu --reduced

Trains internlm2-1.8b at full width (bf16, the seed-0 weights of the linear
placement; zb-v gets them relaid by layer with ``chip_smoke.py``'s helper,
so both placements hold one model) with p=4 stages, m=8 microbatches of
1 x 1024 tokens from the synthetic stream, AdamW (lr 1e-3) under
synchronous post-validation, for 3 steps in each of five runs:

  clip       zb-h1 and zb-v, clip 1.0 (the launcher's default)
  no-clip    zb-h1 and zb-v, no clip
  nudge      zb-h1, clip 1.0, its clip scale times (1 + 2^-23) each step

and prints one JSON line: per step, the relative gaps in loss and grad norm
of zb-v against zb-h1 (clip and no-clip) and of the nudged zb-h1 against
zb-h1, beside each run's sums of squares (the clip scale is
``1 / sqrt(sumsq)``; each stage sums its own leaves, so the placements add
the same squares in other orders).  ``--reduced`` runs the reduced config
with ``n_layers = 2p`` (32 tokens, microbatch 2) as a quick check of the
script itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.schedules import compile_plan  # noqa: E402
from repro_torch.core.schedules.ir import Placement  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, build_train_step  # noqa: E402
from repro_torch.launch.train import make_schedule, train  # noqa: E402
from repro_torch.models.lm import RunSpec, init_params  # noqa: E402
from repro_torch.optim import adamw, postval  # noqa: E402

P, M, STEPS = 4, 8, 3
NUDGE = 1.0 + 2.0 ** -23


def run(cfg, name, device, b, seq, clip, nudge=False):
    """(losses, grad_norms, sumsq per step) of one 3-step run."""
    sched = make_schedule(name, P, M)
    spec = RunSpec(p=P, n_chunks=sched.n_chunks, microbatch=b, seq_len=seq, m=M)
    lin_spec = RunSpec(p=P, n_chunks=1, microbatch=b, seq_len=seq, m=M)
    stacked, shared = init_params(cfg, lin_spec, Placement.linear(P), seed=0, device=device)
    if sched.n_chunks != 1:
        stacked = chip_smoke.relay_to_placement(cfg, stacked, sched.placement)
    tcfg = TrainStepConfig(adamw=adamw.AdamWConfig(grad_clip=clip), postval_mode="sync")
    step, _ = build_train_step(cfg, spec, compile_plan(sched), sched.placement, tcfg)
    data = SyntheticLM(DataConfig(global_batch=M * b, seq_len=seq, vocab=cfg.vocab))
    sumsq = []
    decide = postval.decide_global

    def recording(full, acfg):
        sumsq.append(float(full.sumsq))
        dec = decide(full, acfg)
        return dec._replace(scale=dec.scale * NUDGE) if nudge else dec

    postval.decide_global = recording
    try:
        res = train(cfg, spec, step, stacked, shared, data, STEPS)
    finally:
        postval.decide_global = decide
    del stacked, shared, step
    if device == "cuda":
        torch.cuda.empty_cache()
    return res.losses, res.grad_norms, sumsq[::P]  # decided once a stage, on one sum


def gaps(a, b):
    rel = lambda x, y: abs(x - y) / abs(y)  # noqa: E731
    return {"loss": [rel(x, y) for x, y in zip(a[0], b[0])],
            "grad_norm": [rel(x, y) for x, y in zip(a[1], b[1])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("placement_gap.py: no CUDA card")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.reduced:
        cfg, b, seq = dataclasses.replace(get_reduced("internlm2_1_8b"), n_layers=2 * P), 2, 32
    else:
        cfg, b, seq = get_config("internlm2_1_8b"), 1, 1024
    runs = {
        "zb-h1 clip": run(cfg, "zb-h1", args.device, b, seq, 1.0),
        "zb-v clip": run(cfg, "zb-v", args.device, b, seq, 1.0),
        "zb-h1 no-clip": run(cfg, "zb-h1", args.device, b, seq, None),
        "zb-v no-clip": run(cfg, "zb-v", args.device, b, seq, None),
        "zb-h1 nudge": run(cfg, "zb-h1", args.device, b, seq, 1.0, nudge=True),
    }
    card = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({
        "card": card, "p": P, "m": M, "microbatch": b, "seq_len": seq, "steps": STEPS,
        "gaps": {"clip: zb-v vs zb-h1": gaps(runs["zb-v clip"], runs["zb-h1 clip"]),
                 "no-clip: zb-v vs zb-h1": gaps(runs["zb-v no-clip"], runs["zb-h1 no-clip"]),
                 "nudge: zb-h1 scale x (1 + 2^-23) vs zb-h1":
                     gaps(runs["zb-h1 nudge"], runs["zb-h1 clip"])},
        "runs": {k: {"losses": v[0], "grad_norms": v[1], "sumsq": v[2]}
                 for k, v in runs.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
