"""Step builders of the port: the pipelined training step and the serving step.

Counterpart of ``src/repro/launch/steps.py``.  No ``shard_map`` and no
``jit``: one device holds all p pipeline stages and the host drives the
executors (``core/executor.py`` for training, ``core/infer_executor.py`` for
serving); under ``executor_mode="graph"`` the training walk is captured
once into a CUDA graph and replayed.  The training step mirrors the JAX
one: grads of the pipelined step, the frozen ``mask`` leaves zeroed,
per-stage gradient statistics with the shared parameters counted on stage
0, then AdamW under optimizer post-validation (``within_step``) or the
blocking baseline (``sync``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.executor import GraphedGradFn, PipelineExecutor, acc_dt
from ..core.infer_executor import InferExecutor, compile_infer_plan
from ..core.schedules.ir import ExecutionPlan, Placement
from ..models.lm import ArchConfig, RunSpec, build_program
from ..models.serve import build_serve_program
from ..optim import adamw, postval
from ..tree import tree_flatten, tree_leaves, tree_map

PyTree = Any

__all__ = ["TrainStepConfig", "OptimizerTransient", "build_train_step",
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


def _copy_into(dst: PyTree, src: PyTree) -> None:
    for d, s in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        d.copy_(s)


def _at(tree, s):
    """Stage s's views of per-chunk trees with a leading (p,) axis."""
    return tuple(tree_map(lambda a: a[s], x) for x in tree)


def _update(stacked, shared, opt, shared_opt, grads, shared_grads, loss, tcfg: TrainStepConfig):
    """The optimizer half of the training step: the frozen leaves' gradients
    zeroed, the statistics, then AdamW stage by stage; parameters and
    moments are updated in place."""
    acfg, p = tcfg.adamw, len(tree_leaves(grads)[0])
    grads = tree_map(lambda g, f: torch.zeros_like(g) if f else g, grads,
                     _freeze_filter(stacked))

    # gradient statistics per stage; shared params counted on stage 0 only
    stats_shared = postval.local_stats(shared_grads)
    stats = []
    for s in range(p):
        st = postval.local_stats(_at(grads, s))
        on0 = 1.0 if s == 0 else 0.0
        stats.append(postval.GradStats(st.sumsq + on0 * stats_shared.sumsq,
                                       st.nonfinite | (s == 0 and stats_shared.nonfinite)))
    prefix, full = postval.pipe_prefix_stats(stats)

    amended, new_t = False, opt.t
    for s in range(p):
        # stage 0 steps (local, shared) together, as every stage of the
        # JAX step does; the shared result of the other stages is unused
        params = (_at(stacked, s), shared) if s == 0 else (_at(stacked, s),)
        g = (_at(grads, s), shared_grads) if s == 0 else (_at(grads, s),)
        state = adamw.AdamWState(
            t=opt.t,
            m=(_at(opt.m, s), shared_opt.m) if s == 0 else (_at(opt.m, s),),
            v=(_at(opt.v, s), shared_opt.v) if s == 0 else (_at(opt.v, s),),
        )
        if tcfg.postval_mode == "sync":
            new_p, new_s = postval.sync_step(params, state, g, acfg, full)
        else:
            p1, s1, dec = postval.optimistic_step(params, state, g, prefix[s], acfg)
            new_p, new_s, am = postval.validate_and_fix(p1, s1, g, dec, full, acfg)
            amended = amended or am
        _copy_into(params, new_p)
        _copy_into(state.m, new_s.m)
        _copy_into(state.v, new_s.v)
        if s == 0:
            new_t = new_s.t
        # copied back: free this stage's results before the next stage steps
        del new_p, new_s
        if tcfg.postval_mode != "sync":
            del p1, s1
    metrics = {"loss": loss, "grad_norm": torch.sqrt(full.sumsq), "amended": amended}
    return (stacked, shared, adamw.AdamWState(new_t, opt.m, opt.v),
            adamw.AdamWState(new_t, shared_opt.m, shared_opt.v), metrics)


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
    parameters, moments and gradients it is given."""

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
    ``postval.local_stats`` per stage, then one ``adamw.step`` a stage
    (stage 0 with the shared leaves), each holding a
    new parameter, ``m`` and ``v`` a leaf (10 bytes an element for bf16
    weights) plus the step's fp32 temporaries until ``_copy_into`` copies
    them back; the loop frees a stage's results before the next stage
    steps.  The decisions read the card,
    so the path is fixed to the one every step takes unless it is amended:
    one AdamW step a stage, optimistic or scaled after a skipped optimistic
    step.  An amended step (a partial norm under the clip, the full one
    over it) also holds the rolled-back state while it steps again, up to
    two more parameter, ``m`` and ``v`` copies of that stage: not priced.
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
        with_shared = (lambda x, y: (x, y)) if s == 0 else (lambda x, y: (x,))
        return (with_shared(_at(stacked, s), shared), with_shared(_at(grads, s), shared_grads),
                adamw.AdamWState(opt.t, with_shared(_at(opt.m, s), shared_opt.m),
                                 with_shared(_at(opt.v, s), shared_opt.v)))

    def run(stages):
        with torch.no_grad(), _LiveBytes() as live:
            frozen = tree_map(lambda g, f: torch.zeros_like(g) if f else None,
                              tuple(_at(grads, s) for s in stages),
                              tuple(_freeze_filter(_at(stacked, s)) for s in stages))
            for s in stages:
                postval.local_stats(stage(s)[1])
            for s in stages:
                params, g, state = stage(s)
                new = adamw.step(params, state, g, acfg, scale=scale)
                del new
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
