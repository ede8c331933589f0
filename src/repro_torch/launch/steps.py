"""Step builders of the port: the pipelined training step and the serving step.

Counterpart of ``src/repro/launch/steps.py``.  No ``shard_map`` and no
``jit``: the host drives the executors (``core/executor.py`` for training,
``core/infer_executor.py`` for serving).  :func:`build_train_step` holds
all p pipeline stages in one process; under ``executor_mode="graph"`` the
training walk is captured once into a CUDA graph and replayed.
:func:`build_stage_train_step` is one rank's share of it with one process a
stage (``launch/mesh.py::PipeGroup``): the per-rank walk, the paper's
statistics relay stage to stage, each rank's own AdamW step.  The training
step mirrors the JAX one: grads of the pipelined step, the frozen ``mask``
leaves zeroed, per-stage gradient statistics with the shared parameters
counted on stage 0, then AdamW under optimizer post-validation
(``within_step``) or the blocking baseline (``sync``), written into the
parameters and moments in place, slice by slice, as the JAX step writes
into its donated buffers.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.executor import GraphedGradFn, PipelineExecutor, acc_dt
from ..core.p2p import gather_in_stage_order
from ..core.infer_executor import InferExecutor, compile_infer_plan
from ..core.schedules.ir import ExecutionPlan, Placement
from ..models.lm import ArchConfig, RunSpec, build_program
from ..models.serve import build_serve_program
from ..optim import adamw, postval
from ..tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["TrainStepConfig", "OptimizerTransient", "build_train_step", "build_stage_train_step",
           "optimizer_transient_bytes", "build_serve_step"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    adamw: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    postval_mode: str = "within_step"  # "within_step" | "sync" (baseline)
    # the pipeline's executor mode: "eager" walks the ticks from the host
    # every step, "graph" replays a CUDA graph of that walk
    # (core/executor.py::GraphedGradFn); the optimizer runs eagerly under
    # both (its rollback and redo decisions read the card)
    executor_mode: str = "eager"


def _freeze_filter(tree, frozen: bool = False):
    """Bool tree: True = frozen (the structural ``mask`` leaves are not
    trainable)."""
    if isinstance(tree, dict):
        return {k: _freeze_filter(v, frozen or k == "mask") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_freeze_filter(v, frozen) for v in tree)
    return frozen


def _at(tree, s):
    """Stage s's views of per-chunk trees with a leading (p,) axis."""
    return tuple(tree_map(lambda a: a[s], x) for x in tree)


def _stage_stats(grads, stats_shared, s):
    """Stage s's gradient statistics, the shared parameters' counted on
    stage 0 only (the arithmetic of every stage is the same, so a non-finite
    shared gradient reaches every stage's sum, as in the JAX step)."""
    st = postval.local_stats(grads)
    on0 = 1.0 if s == 0 else 0.0
    return postval.GradStats(st.sumsq + on0 * stats_shared.sumsq,
                             st.nonfinite | (s == 0 and stats_shared.nonfinite))


def _post_validate(params, state, g, partial, full, tcfg: TrainStepConfig):
    """One stage's in-place AdamW under ``tcfg.postval_mode``: (new state,
    amended)."""
    if tcfg.postval_mode == "sync":
        _, new_s = postval.sync_step_(params, state, g, tcfg.adamw, full)
        return new_s, False
    _, s1, dec = postval.optimistic_step_(params, state, g, partial, tcfg.adamw)
    _, new_s, am = postval.validate_and_fix_(params, s1, g, dec, full, tcfg.adamw)
    return new_s, am


def _update(stacked, shared, opt, shared_opt, grads, shared_grads, loss, tcfg: TrainStepConfig):
    """The optimizer half of the training step: the frozen leaves' gradients
    zeroed, the statistics, then AdamW stage by stage, in place: each
    stage's decisions are read once, and its leaves are stepped (rolled
    back and stepped again when amended) slice by slice into the stored
    parameters and moments (``adamw.step_``), as the JAX step writes its
    update into the donated buffers.  Parameters and moments keep their
    addresses."""
    p = len(tree_leaves(grads)[0])
    grads = tree_map(lambda g, f: torch.zeros_like(g) if f else g, grads,
                     _freeze_filter(stacked))

    # gradient statistics per stage; shared params counted on stage 0 only
    stats_shared = postval.local_stats(shared_grads)
    prefix, full = postval.pipe_prefix_stats(
        [_stage_stats(_at(grads, s), stats_shared, s) for s in range(p)])

    amended, new_t = False, opt.t
    for s in range(p):
        # stage 0 steps (local, shared) together, as every stage of the
        # JAX step does; the shared result of the other stages is unused
        params, g, state = _stage(stacked, shared, grads, shared_grads, opt, shared_opt, s)
        new_s, am = _post_validate(params, state, g, prefix[s], full, tcfg)
        amended = amended or am
        if s == 0:
            new_t = new_s.t
    metrics = {"loss": loss, "grad_norm": torch.sqrt(full.sumsq), "amended": amended}
    return (stacked, shared, adamw.AdamWState(new_t, opt.m, opt.v),
            adamw.AdamWState(new_t, shared_opt.m, shared_opt.v), metrics)


def _stage(stacked, shared, grads, shared_grads, opt, shared_opt, s):
    """(params, grads, AdamW state) that stage s steps: its views of the
    stacked trees, and on stage 0 the shared ones beside them."""
    both = (lambda x, y: (x, y)) if s == 0 else (lambda x, y: (x,))
    return (both(_at(stacked, s), shared), both(_at(grads, s), shared_grads),
            adamw.AdamWState(opt.t, both(_at(opt.m, s), shared_opt.m),
                             both(_at(opt.v, s), shared_opt.v)))


class _LiveBytes(TorchDispatchMode):
    """Bytes of the tensors that the ops run under it allocate and that are
    still alive, and their peak: each fresh output (not a view, not an
    in-place result) counts from its op until Python frees it.  On meta
    tensors it counts without memory."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, t in zip(func._schema.returns, outs):
            if isinstance(t, torch.Tensor) and ret.alias_info is None:
                n = t.numel() * t.element_size()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


@dataclasses.dataclass(frozen=True)
class OptimizerTransient:
    """Peak bytes that the optimizer half of a step allocates beyond the
    parameters, moments and gradients it is given (it writes its update
    into them)."""

    one_card: int  # _update over all p stages, one after another on one card
    per_stage: Tuple[int, ...]  # stage s stepped alone, as one device of a pipeline steps
    stage_elements: Tuple[int, ...]  # parameter elements that stage s's AdamW step touches


def optimizer_transient_bytes(stacked, shared,
                              acfg: Optional[adamw.AdamWConfig] = None) -> OptimizerTransient:
    """The optimizer's transient, counted from the code without memory.

    The optimizer's own functions run here in :func:`_update`'s order, on
    meta tensors of the leaves' shapes and dtypes (parameters as given,
    gradients in the accumulators' ``acc_dt``, fp32 moments) under
    :class:`_LiveBytes`: the frozen leaves' ``zeros_like``,
    ``postval.local_stats`` per stage (each leaf's fp32 square whole, so
    the norm keeps its bits), then each stage's in-place AdamW on the
    path of an amended step, the longest: ``adamw.step_`` and ``adamw.
    rollback_`` (the redo's ``step_`` holds what the first one held), each
    holding one slice's new parameter, ``m`` and ``v`` and its fp32
    temporaries (``adamw.SLICE`` elements) until they are written back.
    Every other path (kept, skipped, skipped then scaled, ``sync``) runs a
    prefix of it, so its peak is the larger of the optimistic and the
    amended path's.  The
    AdamW passes see each leaf's first slice alone (a flat view of at most
    ``adamw.SLICE`` elements): every slice holds what the first one holds,
    the ragged last one less, so the peak is the same, and a model of
    billions of parameters is priced without walking its thousands of
    slices.
    """
    acfg = acfg or adamw.AdamWConfig()

    def meta(tree, dtype=None):
        return tree_map(lambda a: torch.empty(a.shape, dtype=dtype or a.dtype, device="meta"), tree)

    def meta_acc(tree):
        return tree_map(lambda a: torch.empty(a.shape, dtype=acc_dt(a.dtype), device="meta"), tree)

    stacked, shared = meta(stacked), meta(shared)
    grads, shared_grads = meta_acc(stacked), meta_acc(shared)
    opt = adamw.AdamWState(torch.zeros((), dtype=torch.int32, device="meta"),
                           meta(stacked, torch.float32), meta(stacked, torch.float32))
    shared_opt = adamw.AdamWState(opt.t, meta(shared, torch.float32), meta(shared, torch.float32))
    scale = torch.ones((), device="meta")
    p = len(tree_leaves(stacked)[0])

    def stage(s):
        return _stage(stacked, shared, grads, shared_grads, opt, shared_opt, s)

    def first_slice(tree):
        return tree_map(lambda a: a.view(-1)[:adamw.SLICE], tree)

    def run(stages):
        with torch.no_grad(), _LiveBytes() as live:
            frozen = tree_map(lambda g, f: torch.zeros_like(g) if f else None,
                              tuple(_at(grads, s) for s in stages),
                              tuple(_freeze_filter(_at(stacked, s)) for s in stages))
            for s in stages:
                postval.local_stats(stage(s)[1])
            for s in stages:
                params, g, state = first_slice(stage(s))
                _, state = adamw.step_(params, state, g, acfg, scale=scale)
                adamw.rollback_(params, state, g, acfg, scale=1.0)
            del frozen
        return live.peak

    return OptimizerTransient(
        one_card=run(range(p)),
        per_stage=tuple(run([s]) for s in range(p)),
        stage_elements=tuple(sum(t.numel() for t in tree_leaves(stage(s)[0])) for s in range(p)))


def build_train_step(cfg: ArchConfig, spec: RunSpec, plan: ExecutionPlan, placement: Placement,
                     tcfg: Optional[TrainStepConfig] = None):
    """Returns (step, program).

    ``step(stacked, shared, opt, shared_opt, side) -> (stacked, shared, opt,
    shared_opt, metrics)``.  ``opt`` holds the stacked params' moments,
    ``shared_opt`` the shared ones'; ``side`` holds tokens/labels (m, b, s)
    and positions (m, s) on the parameters' device.  Parameters and moments
    are updated in place, as the JAX step donates them, and returned;
    ``metrics`` has ``loss``, ``grad_norm`` (0-d tensors) and ``amended``
    (bool: some stage's optimistic step was rolled back or redone).
    ``step.grad_fn`` is the pipeline's ``grad_fn`` (in graph mode a
    :class:`~repro_torch.core.executor.GraphedGradFn`, which counts its
    captures).
    """
    tcfg = tcfg or TrainStepConfig()
    if tcfg.postval_mode not in ("within_step", "sync"):
        raise ValueError(f"unknown postval_mode {tcfg.postval_mode!r}")
    if tcfg.executor_mode not in ("eager", "graph"):
        raise ValueError(f"unknown executor_mode {tcfg.executor_mode!r}")
    program = build_program(cfg, spec, placement)
    grad_fn = PipelineExecutor(program, plan).build_grad_fn()
    if tcfg.executor_mode == "graph":
        grad_fn = GraphedGradFn(grad_fn)

    @torch.no_grad()
    def step(stacked, shared, opt, shared_opt, side):
        with torch.profiler.record_function("train_step.pipeline"):
            grads, shared_grads, loss = grad_fn(stacked, shared, side)
        with torch.profiler.record_function("train_step.optimizer"):
            return _update(stacked, shared, opt, shared_opt, grads, shared_grads, loss, tcfg)

    step.grad_fn = grad_fn
    return step, program


def _stage_update(group, params, shared, opt, shared_opt, grads, shared_grads, loss,
                  tcfg: TrainStepConfig):
    """One rank's share of :func:`_update` on stage s = ``group.rank``:
    its statistics (``shared_grads`` are the group's sum, so stage 0 counts
    them as the one-process step does), the relay
    (``postval.relay_prefix_stats``), then its AdamW in place.  Rank 0 steps
    (its stage, shared) together on its prefix, as stage 0 of
    :func:`_update`; rank s > 0 steps its stage on its prefix and its
    replica of the shared parameters on stage 0's (the relay carries it):
    a replica stepped on its own prefix would, where that prefix's decision
    was amended and stage 0's was not, hold a rolled-back-and-redone update
    that is not stage 0's bits.  So every replica and the step count equal
    stage 0's, as the one-process step keeps stage 0's.  ``amended`` is
    OR-ed over the group; ``grad_norm`` is the full statistics' on every
    rank."""
    s = group.rank
    grads = tree_map(lambda g, f: torch.zeros_like(g) if f else g, grads, _freeze_filter(params))
    stats_shared = postval.local_stats(shared_grads)
    partial, full, first = postval.relay_prefix_stats(group, _stage_stats(grads, stats_shared, s))
    if s == 0:
        new_s, amended = _post_validate(
            (params, shared), adamw.AdamWState(opt.t, (opt.m, shared_opt.m), (opt.v, shared_opt.v)),
            (grads, shared_grads), partial, full, tcfg)
    else:
        _, amended = _post_validate((params,), adamw.AdamWState(opt.t, (opt.m,), (opt.v,)),
                                    (grads,), partial, full, tcfg)
        new_s, _ = _post_validate(
            (shared,), adamw.AdamWState(shared_opt.t, (shared_opt.m,), (shared_opt.v,)),
            (shared_grads,), first, full, tcfg)
    amended = any(bool(a) for a in gather_in_stage_order(
        group, torch.tensor(float(amended), dtype=torch.float32)))
    metrics = {"loss": loss, "grad_norm": torch.sqrt(full.sumsq), "amended": amended}
    return (params, shared, adamw.AdamWState(new_s.t, opt.m, opt.v),
            adamw.AdamWState(new_s.t, shared_opt.m, shared_opt.v), metrics)


def build_stage_train_step(cfg: ArchConfig, spec: RunSpec, plan: ExecutionPlan,
                           placement: Placement, group, tcfg: Optional[TrainStepConfig] = None):
    """Returns (step, program): rank ``group.rank``'s share of
    :func:`build_train_step`, one process a stage.

    ``step(params, shared, opt, shared_opt, side) -> (params, shared, opt,
    shared_opt, metrics)``: ``params`` holds, per chunk, this stage's
    parameter trees with no stage axis (``core/executor.py::stage_slice``),
    ``opt`` their moments, ``shared`` and ``shared_opt`` this rank's
    replica of the shared parameters and their moments; ``side`` the whole
    step's side inputs.  Updated in place and returned; ``metrics`` (loss,
    grad norm, amended) are the same on every rank.  ``step.grad_fn`` is
    the per-rank walk (``PipelineExecutor.build_stage_grad_fn``).  The
    walk runs eagerly: ``executor_mode="graph"`` raises.
    """
    tcfg = tcfg or TrainStepConfig()
    if tcfg.postval_mode not in ("within_step", "sync"):
        raise ValueError(f"unknown postval_mode {tcfg.postval_mode!r}")
    if tcfg.executor_mode != "eager":
        raise ValueError(f"executor_mode {tcfg.executor_mode!r}: a rank's walk sends between its "
                         f"ticks, which a CUDA graph cannot hold; one process a stage runs "
                         f"'eager' (capturing a rank's compute between its sends: ROADMAP Queue 1, "
                         f"item 12)")
    program = build_program(cfg, spec, placement)
    grad_fn = PipelineExecutor(program, plan).build_stage_grad_fn(group)

    @torch.no_grad()
    def step(params, shared, opt, shared_opt, side):
        with torch.profiler.record_function("train_step.pipeline"):
            grads, shared_grads, loss = grad_fn(params, shared, side)
        with torch.profiler.record_function("train_step.optimizer"):
            return _stage_update(group, params, shared, opt, shared_opt, grads, shared_grads,
                                 loss, tcfg)

    step.grad_fn = grad_fn
    return step, program


def build_serve_step(cfg: ArchConfig, spec: RunSpec, placement: Placement, mode: str):
    """Returns (step, program, cache_init).

    ``step(stacked, shared, side, caches, pos) -> (logits, caches)``:
    ``logits`` is (m, b, V); ``caches`` (per chunk, leaves (p, m, b, S, ...))
    are updated in place.  ``pos`` is 0 for prefill and, for decode, the
    scalar index of the token being decoded, ``cache_len - 1`` as in the JAX
    step (``side["positions"]`` is not read by decode).
    """
    program, cache_init = build_serve_program(cfg, spec, placement, mode)
    plan = compile_infer_plan(placement, spec.m)
    step = InferExecutor(program, plan).build_step_fn()
    return step, program, cache_init
