"""Dry run of the grid: every (architecture x shape x mesh) on fake tensors.

Counterpart of ``src/repro/launch/dryrun.py``, which lowers and compiles
each cell on 512 placeholder CPU devices and reads the compiled program's
``memory_analysis()`` (fits-per-device evidence) and ``cost_analysis()``
(FLOPs).  The port has no SPMD program to compile.  What it runs instead
is its own step, on fake tensors (``torch._subclasses.fake_tensor``): no
memory, no arithmetic, no card, and the code path of the card: the
kernels' entries take their fake branch (``kernels/ops.py``: the kernel's
outputs and saved tensors, no launch), the executor's slots are measured
by the function that measures them on the card
(``core/executor.py::slot_bytes``, storages told apart by identity), and
the rest of the byte accounting is the planner's own (``core/planner.py``:
``HBMPlanner.state``, ``one_card_bytes``; ``core/memory.py::
measured_timeline`` over ``compile_plan``).  Each row holds the bytes one
device of the mesh's pipeline holds, by part, and the FLOPs it computes.

  * A train cell runs microbatch 0 through F, B and W of each chunk of one
    stage and the sink and the source, counting each op's FLOPs with
    ``FlopCounterMode`` (the W kernel's product is counted by its fake
    branch), and multiplies them by the plan's op counts, as the JAX
    package's roofline multiplies its per-tick costs by the schedule's
    static counts: the pipe holds m = 256 microbatches at ``train_4k``, and
    the dry run does not walk all m x p ops.  Its bytes: weights, AdamW
    moments, fp32 accumulators, the walk at its worst tick, the
    optimizer's transient charged as the planner charges it; its total
    leaves out the calibrated remainder, which is the allocator's and
    which no dry run sees.
  * A serve cell runs one group's prefill (or one decode step, at a cache
    of the cell's length) through one stage, the source and the sink: its
    bytes are the weights, the caches of the m groups, the outputs and the
    peak of what that F allocates (``launch/steps.py::_LiveBytes``).

The fake tensors lie on the CPU unless ``dryrun_cell(device="cuda")``
asks for the card's device type: the kernels' fake branch is keyed on
fakeness, not on the device, so both walk the same code and give the same
bytes and FLOPs (``chip_smoke.py`` holds the two to each other and the
fake cuda slots to the card's).  The CPU is the default because fake cuda
tensors need the card's runtime: PyTorch's fake mode makes one real
one-element tensor on a card it sees before it makes a fake cuda one, and
runs no autograd on them without a card or in a build for the CPU alone
(the autograd engine asks CUDA's device guard).  So by default the dry run
needs no card and never touches one.

Not ported: ``--calibration-out``.  The JAX package folds the compiled
program's temp bytes into its planner's calibration; the port's remainder
is measured on the card by ``launch/calibrate.py``.  Tensor parallelism is
not ported, so the dry run binds tp to no axis (tp = 1) and the mesh's
"model" axis is idle (``launch/mesh.py``).

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2_1_8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --multi-pod --out rows.json
  python -m repro_torch.launch.dryrun --arch internlm2_1_8b --shape train_4k \\
      --p 4 --m 8 --layers 24 --schedule zb-h1 --device-bytes 85520809984
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCH_IDS, get_config, get_reduced
from ..configs.shapes import SHAPES, cells_for
from ..core.executor import PipelineExecutor, acc_dt, slot_bytes
from ..core.infer_executor import compile_infer_plan
from ..core.memory import ActivationByteModel, measured_timeline
from ..core.passes import loss_seed
from ..core.planner import HBMPlanner, optimizer_charge
from ..core.schedules import compile_plan
from ..core.schedules.ir import OpKind, Placement
from ..models.lm import RunSpec, build_program, front_len, front_spec, init_params, side_inputs
from ..models.serve import build_serve_program
from ..tree import tree_leaves, tree_map
from .mesh import AxisBinding, make_production_mesh
from .steps import _LiveBytes as LiveBytes
from .train import SCHEDULES as LAUNCHER_SCHEDULES
from .train import make_schedule  # re-exported: the tests read the grid's schedules here

__all__ = ["make_run_spec", "make_schedule", "dryrun_cell", "train_pieces", "plan_flops",
           "main"]


def make_run_spec(cfg, cell, mesh, binding, schedule_name) -> RunSpec:
    """The JAX ``make_run_spec``'s arithmetic: microbatches and their size
    from the cell's global batch over the dp replicas."""
    p, tp, dp = binding.sizes(mesh)
    gb = cell.global_batch
    per_pipe = max(1, gb // dp)
    if cell.kind == "train":
        b = 1
        m = max(per_pipe // b, 1)
    elif cell.kind == "prefill":
        b = 1
        m = max(per_pipe, 1)
    else:  # decode
        m = min(per_pipe, max(p, 16))
        b = max(1, per_pipe // m)
        m = max(1, per_pipe // b)
    n_chunks = 2 if schedule_name == "zb-v" else 1
    return RunSpec(p=p, n_chunks=n_chunks, microbatch=b, seq_len=cell.seq_len, m=m,
                   tp_axis=binding.tp, tp_size=tp)


def _bytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def _fake_params(cfg, spec: RunSpec, placement, device: str):
    """Under an active ``FakeTensorMode``: one stage's parameters per chunk
    (stage 0 of the port's ``init_params``, no stage axis) and the shared
    leaves, fake, on ``device``; and the stacked trees of all p stages."""
    stacked, shared = init_params(cfg, spec, placement, device="cpu")
    on = lambda a: torch.empty(a.shape, dtype=a.dtype, device=device)  # noqa: E731
    stage = tuple(tree_map(lambda a: on(a[0]), c) for c in stacked)
    return stage, tree_map(on, shared), stacked


def _fake_side(cfg, spec: RunSpec, device: str):
    """Under an active ``FakeTensorMode``: ``models/lm.py::side_inputs`` of
    one microbatch (a leading axis of 1), fake, on ``device``."""
    real = side_inputs(cfg, dataclasses.replace(spec, m=1))
    return {k: torch.empty(v.shape, dtype=torch.long if v.dtype.kind in "iu" else torch.float32,
                           device=device) for k, v in real.items()}


def _counted(fn, *args, **kwargs):
    """(fn's result, the FLOPs ``FlopCounterMode`` counts while it runs)."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args, **kwargs)
    return out, int(fc.get_total_flops())


@torch.no_grad()  # as the executor's walk: each F builds its own graph
def train_pieces(prog, stage, shared, side) -> Dict[str, Any]:
    """The FLOPs of each op of one microbatch (the first of ``side``) on one
    stage, as the executor runs them: per chunk F, B and W; the source's F
    and its W (the embedding's and the front's gradient, at the last B);
    the sink's F, B and W.  Any tensors will do: fake ones count the same."""
    C = prog.n_chunks()
    side_mb = tree_map(lambda a: a[0], side)
    x, src_f = _counted(prog.src_fwd, shared, side_mb)
    x = x.to(prog.act_dtype)
    F, B, W = [0] * C, [0] * C, [0] * C
    res = []
    for c in range(C):
        (y, r), F[c] = _counted(prog.chunks[c].fwd, stage[c], x, side_mb)
        res.append(r)
        x = y.to(prog.act_dtype)
    (lj, sr), sink_f = _counted(prog.sink.fwd, shared, y, side_mb)
    (dy, sw), sink_b = _counted(prog.sink.bwd_x, shared, sr, loss_seed(lj), side_mb)
    dy = dy.to(prog.act_dtype)
    wctx = [None] * C
    for c in reversed(range(C)):
        (dy, wctx[c]), B[c] = _counted(prog.chunks[c].bwd_x, stage[c], res.pop(), dy, side_mb)
        dy = dy.to(prog.act_dtype)
    zeros = lambda a: torch.zeros(a.shape, dtype=acc_dt(a.dtype), device=a.device)  # noqa: E731
    shared_acc = tree_map(zeros, shared)
    for c in range(C):
        _, W[c] = _counted(prog.chunks[c].bwd_w, stage[c], wctx[c], side_mb,
                           acc=tree_map(zeros, stage[c]))
    _, sink_w = _counted(prog.sink.bwd_w, shared, sw, side_mb, acc=shared_acc)
    _, src_w = _counted(prog.src_bwd_w, shared, side_mb, dy, shared_acc)
    return dict(F=F, B=B, W=W, src_f=src_f, src_w=src_w, sink_f=sink_f, sink_b=sink_b,
                sink_w=sink_w)


def plan_flops(plan, pieces) -> Tuple[int, ...]:
    """Each stage's FLOPs over a step: every op of the plan priced by
    :func:`train_pieces`, with the source and the sink where the executor
    runs them (the source's F at ``op_is_src``, its W at ``op_is_last_b``,
    the sink's F, B and W beside the chunk's at ``op_is_loss``)."""
    per_stage = []
    for s in range(plan.p):
        total = 0
        for t in range(plan.n_ticks):
            kind = int(plan.op_kind[s, t])
            if kind == OpKind.IDLE:
                continue
            c, loss = int(plan.op_chunk[s, t]), bool(plan.op_is_loss[s, t])
            if kind == OpKind.F:
                total += pieces["F"][c] + pieces["src_f"] * bool(plan.op_is_src[s, t])
                total += pieces["sink_f"] * loss
            elif kind == OpKind.B:
                total += pieces["B"][c] + pieces["sink_b"] * loss
                total += pieces["src_w"] * bool(plan.op_is_last_b[s, t])
            else:
                total += pieces["W"][c] + pieces["sink_w"] * loss
        per_stage.append(total)
    return tuple(per_stage)


def _train_cell(cfg, spec: RunSpec, sched, device: str, executor_mode: str):
    plan = compile_plan(sched)
    C = sched.n_chunks
    placement = sched.placement
    built = {}
    with FakeTensorMode():
        stage, shared, _ = _fake_params(cfg, spec, placement, device)
        side = _fake_side(cfg, spec, device)
        prog = build_program(cfg, spec, placement)
        built[C] = (prog, stage, shared, side)
        planner = HBMPlanner(cfg, p=spec.p, m=spec.m, microbatch=spec.microbatch,
                             seq_len=spec.seq_len, executor_mode=executor_mode,
                             program_factory=built.__getitem__)
        _, slots = planner.slot_bytes(C)
        pieces = train_pieces(prog, stage, shared, side)
    del stage, shared, side, built
    st = planner.state(C)
    one = planner.one_card_bytes(sched)
    mt = measured_timeline(PipelineExecutor(prog, plan), slots=slots)
    walk = float(mt.peak_total.max())
    optimizer = optimizer_charge(st.transient, walk, one.overhang, one.reuse)
    parts = dict(weights=st.params, moments=st.optim, accumulators=st.acc, walk=walk,
                 optimizer=optimizer)
    card = dict(weights=st.params_card, moments=st.optim_card, accumulators=one.accumulators,
                walk=one.walk, optimizer=one.optimizer)
    flops = plan_flops(plan, pieces)
    model = ActivationByteModel.from_config(cfg, spec.microbatch, spec.seq_len, spec.p,
                                            n_chunks=C, tp_size=spec.tp_size)
    return dict(
        n_ticks=int(plan.n_ticks),
        modeled_schedule_bytes=model.schedule_bytes(sched)[2],
        flops=max(flops),
        step_flops=sum(flops),
        bytes=parts,
        total_bytes=sum(parts.values()),
        one_card=dict(card, total=sum(card.values())),
        remainder_bytes=planner.remainder(),  # priced apart: a device's share
        slots={k: (list(v) if isinstance(v, tuple) else v) for k, v in slots.items()},
        pieces=pieces,
    )


# grad off, not inference mode: serving's composite ops (einsum, matmul)
# then reach the byte count as the ops they run (their operands' copies, the
# products), which is what the card allocates under inference mode
@torch.no_grad()
def _serve_cell(cfg, spec: RunSpec, kind: str, device: str, cache_len: int):
    placement = Placement.linear(spec.p, spec.n_chunks)
    mode = "prefill" if kind == "prefill" else "decode"
    prog, cache_init = build_serve_program(cfg, spec, placement, mode)
    b, m, p, C = spec.microbatch, spec.m, spec.p, spec.n_chunks
    with FakeTensorMode():
        stage, shared, stacked = _fake_params(cfg, spec, placement, device)
        caches = [cache_init(b, cache_len, device=device, lead=(m,)) for _ in range(C)]
        if mode == "decode":
            side_mb = {"tokens": torch.empty((b, 1), dtype=torch.long, device=device),
                       "positions": torch.empty((1,), dtype=torch.long, device=device)}
        else:
            side_mb = {k: v[0] for k, v in _fake_side(cfg, spec, device).items()}
            front = front_spec(cfg)
            if front is not None:  # the launcher casts the front to the model dtype
                side_mb[front[0]] = side_mb[front[0]].to(cfg.torch_dtype())
        pos = 0 if mode == "prefill" else cache_len - 1
        chunk_f = [0] * C
        with LiveBytes() as live:
            x, src_f = _counted(prog.src, shared, side_mb)
            x = x.to(prog.act_dtype)
            for c in range(C):
                view = tree_map(lambda a: a[0], caches[c])
                (x, _), chunk_f[c] = _counted(prog.chunk_fns[c], stage[c], x, side_mb, view, pos)
                x = x.to(prog.act_dtype)
            _, sink_f = _counted(prog.sink, shared, x, side_mb)
        weights, weights_card = _bytes((stage, shared)), _bytes((stacked, shared))
        cache_bytes = _bytes(caches)
    act = b * prog.act_shape[1] * prog.act_shape[2] * torch.empty((), dtype=prog.act_dtype).element_size()
    outputs = m * b * prog.out_shape[1] * torch.empty((), dtype=prog.out_dtype).element_size()
    parts = dict(weights=weights, caches=cache_bytes, outputs=outputs, transient=live.peak)
    # one card holding all p stages: every stage's weights and caches, and the
    # messages of the other stages that run in the same tick (at most
    # min(p, m): a group is at one stage a tick), handed on or still to be read
    card = dict(weights=weights_card, caches=p * cache_bytes, outputs=outputs,
                transient=live.peak, inbox=(min(p, m) - 1) * act)
    per_group = sum(chunk_f)
    return dict(
        n_ticks=int(compile_infer_plan(placement, m).n_ticks),
        modeled_schedule_bytes=None,
        flops=m * (per_group + max(src_f, sink_f)) if p > 1 else m * (per_group + src_f + sink_f),
        step_flops=m * (p * per_group + src_f + sink_f),
        bytes=parts,
        total_bytes=sum(parts.values()),
        one_card=dict(card, total=sum(card.values())),
        cache_len=cache_len,
        pieces=dict(F=chunk_f, src_f=src_f, sink_f=sink_f),
    )


def dryrun_cell(arch_id: str, shape_id: str, multi_pod: bool = False, schedule: str = "zb-h2",
                *, p: Optional[int] = None, m: Optional[int] = None,
                microbatch: Optional[int] = None, layers: Optional[int] = None,
                seq_len: Optional[int] = None, new_tokens: int = 0, reduced: bool = False,
                device: str = "cpu", executor_mode: str = "graph",
                device_bytes: Optional[float] = None, verbose: bool = True) -> Dict[str, Any]:
    """One cell's row.  ``p``, ``m``, ``microbatch``, ``layers`` and
    ``seq_len`` replace the cell's values (so a row can price an exact run;
    dp stays the mesh's); ``new_tokens`` lengthens a serve cell's cache, as
    the serving launcher sizes it; ``reduced`` takes the arch's reduced
    config (the CPU tests'); ``device`` is the fake tensors' (the module's
    note).  ``executor_mode`` picks the calibrated
    optimizer shares a train cell's transient is charged by (the launcher
    runs the graph executor on the card).  ``fits`` holds the per-device
    total to ``device_bytes`` where given."""
    cfg = get_reduced(arch_id) if reduced else get_config(arch_id)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cell = SHAPES[shape_id]
    if seq_len is not None:
        cell = dataclasses.replace(cell, seq_len=seq_len)
    mesh = make_production_mesh(multi_pod=multi_pod)
    binding = AxisBinding(pipe="data", tp=None, dp="pod" if multi_pod else None)
    spec = make_run_spec(cfg, cell, mesh, binding, schedule)
    _, tp, dp = binding.sizes(mesh)
    spec = dataclasses.replace(spec, **{k: v for k, v in dict(p=p, m=m, microbatch=microbatch)
                                        .items() if v is not None})
    t0 = time.time()
    if cell.kind == "train":
        sched = make_schedule(schedule, spec.p, spec.m)
        spec = dataclasses.replace(spec, n_chunks=sched.n_chunks)
        body = _train_cell(cfg, spec, sched, device, executor_mode)
    else:
        cached = front_len(cfg) if cfg.family == "vlm" else 0
        body = _serve_cell(cfg, spec, cell.kind, device, cached + cell.seq_len + new_tokens)
    row = {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": mesh.label,
        "schedule": schedule if cell.kind == "train" else f"fill-drain-{cell.kind}",
        "p": spec.p,
        "tp": tp,
        "dp": dp,
        "m": spec.m,
        "microbatch": spec.microbatch,
        "n_chunks": spec.n_chunks,
        "seq_len": cell.seq_len,
        "layers": cfg.n_layers,
        "device": f"fake {device}",
        "executor_mode": executor_mode if cell.kind == "train" else None,
        **body,
        "build_s": round(time.time() - t0, 2),
    }
    if device_bytes is not None:
        row["device_bytes"] = int(device_bytes)
        row["fits"] = bool(row["total_bytes"] <= device_bytes)
    if verbose:
        print(json.dumps(row))
        sys.stdout.flush()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--schedule", default="zb-h2", choices=sorted(LAUNCHER_SCHEDULES),
                    help="the JAX dry run's zb-h1, zb-h2 or zb-v, or another of the launcher's")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device-bytes", type=float, default=None,
                    help="a device's memory: each row says whether its total fits")
    ap.add_argument("--new-tokens", type=int, default=0,
                    help="decode steps a serve cell's cache also holds")
    for k in ("p", "m", "microbatch", "layers", "seq-len"):
        ap.add_argument(f"--{k}", type=int, default=None, help="replaces the cell's value")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    over = dict(p=args.p, m=args.m, microbatch=args.microbatch, layers=args.layers,
                seq_len=args.seq_len)
    results = []
    for arch in archs:
        for sid, cell, skip in cells_for(arch):
            if args.shape != "all" and sid != args.shape:
                continue
            if skip:
                rec = {"arch": arch, "shape": sid, "skipped": skip}
                print(json.dumps(rec))
                results.append(rec)
                continue
            try:
                results.append(dryrun_cell(arch, sid, multi_pod=args.multi_pod,
                                           schedule=args.schedule, new_tokens=args.new_tokens,
                                           device_bytes=args.device_bytes, **over))
            except Exception as e:
                traceback.print_exc()
                results.append({"arch": arch, "shape": sid, "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if "error" in r]
    print(f"\n{len(results) - len(bad)}/{len(results)} cells OK")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
