"""Ticked pipeline executor of the port: one device holds all p stages.

Counterpart of ``src/repro/core/executor.py``.  It runs any
:class:`~repro_torch.core.schedules.ir.ExecutionPlan` -- one chunk a stage
(1F1B, ZB-H1/H2, ZB-1p/2p) or two on the V placement (ZB-V, V-Min,
V-Half: the last stage hands chunk 0's output to its own chunk 1 and the
gradient back by a local send) -- since it follows the tables generically
(chunk ids, per-chunk inboxes, local sends, all four channels).  The JAX
version is one SPMD program under ``shard_map`` with collective permutes;
this one is re-designed for one device:

  * the host walks the plan tick by tick; in each tick every stage runs its
    F, B or W, in stage order (``op_kind``/``op_chunk``/``op_mb``);
  * per-stage state lives in pools keyed by the plan's slot ids: activation
    and gradient inboxes (per chunk), residuals (written by F, taken by B),
    W-contexts (written by B, taken by W), and the sink's residuals and
    W-context at the loss position.  Residual and W-context slots are the
    plan's joint cross-chunk ids.  Writing a slot that is still live raises,
    so the plan's slot allocation is checked as a side effect;
  * outputs are handed on only after every stage of the tick ran, as
    ``send_local``/``send_channel``/``recv_*`` say -- the JAX version's
    end-of-tick ``ppermute`` (the serving executor follows the same rule);
  * gradients accumulate in fp32 (``acc_dt``) in one (p, ...) tensor per
    leaf and chunk, allocated once a step, stage s in its view [s]: W adds
    each block's products through the wgrad-accumulation kernel (the JAX
    default ``fuse_wgrad``, the only mode here); the embedding
    gradient is added at ``op_is_last_b`` and the sink's at ``op_is_loss``
    W.  The loss is the sum of the sink's per-microbatch ``loss / m``.

The JAX executor's modes (``scan`` / ``unroll`` / ``specialized``): the
host walk above already dispatches each tick on host constants and hands
on only what the plan sends (the JAX ``specialized`` trace's per-tick
column, run op by op).  :class:`GraphedGradFn` wraps that walk as the JAX
``specialized`` program's counterpart, compiled once and run once a step:
the walk recorded into a CUDA graph and replayed (``launch/steps.py``
wraps it under ``executor_mode="graph"``).  The generic ``lax.scan`` tick
body has no counterpart: the port has no traced tick body.

Byte accounting (the JAX executor's ``_tree_bytes``, ``state_shapes``,
``channel_message_bytes``, ``buffer_bytes``): the port holds no explicit
buffers, so :func:`slot_bytes` measures what one slot of
each pool holds by running one microbatch through F and B on the
parameters' device, and :meth:`PipelineExecutor.buffer_bytes` multiplies
those by the plan's slot counts, as the JAX executor sizes its pools.
:meth:`PipelineExecutor.accumulator_bytes` prices the fp32 gradient
accumulators from the leaf shapes (the planner's ``temp`` term).

One process per stage with NCCL point-to-point sends is a later slice.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..tree import tree_flatten, tree_leaves, tree_map
from .passes import FBWModule, loss_seed
from .schedules.ir import (
    CHANNEL_BWD_DOWN,
    CHANNEL_BWD_UP,
    CHANNEL_FWD_DOWN,
    CHANNEL_FWD_UP,
    ExecutionPlan,
    N_CHANNELS,
    OpKind,
)

__all__ = ["PipelineProgram", "PipelineExecutor", "GraphedGradFn", "slot_bytes"]

PyTree = Any

_CHANNEL_SHIFT = {CHANNEL_FWD_UP: +1, CHANNEL_FWD_DOWN: -1, CHANNEL_BWD_DOWN: -1, CHANNEL_BWD_UP: +1}
_ACT_CHANNELS = (CHANNEL_FWD_UP, CHANNEL_FWD_DOWN)


@dataclasses.dataclass
class PipelineProgram:
    """What the model hands the executor.

    ``chunks[c]`` computes chunk ``c``'s layer group on any stage (parameters
    differ by stage).  ``src_fwd(shared, side_mb) -> x`` is the embedding;
    ``src_bwd_w(shared, side_mb, dx, acc)`` adds its gradient into ``acc``;
    ``sink`` maps the last chunk's output to the scalar ``loss / m``.
    """

    chunks: Sequence[FBWModule]
    src_fwd: Callable[[PyTree, PyTree], torch.Tensor]
    src_bwd_w: Callable[..., PyTree]
    sink: FBWModule
    act_shape: Tuple[int, ...]  # (b_mb, s, h) carried between stages
    act_dtype: Any = torch.float32

    def n_chunks(self) -> int:
        return len(self.chunks)


def acc_dt(dtype: torch.dtype) -> torch.dtype:
    """Gradient accumulator dtype: at least fp32."""
    return torch.promote_types(dtype, torch.float32)


def _put(pool: Dict, key, value, what: str) -> None:
    if key in pool:
        raise RuntimeError(f"{what} slot {key} written while still live")
    pool[key] = value


def _take(pool: Dict, key, what: str):
    if key not in pool:
        raise RuntimeError(f"{what} slot {key} read before it was written")
    return pool.pop(key)


def _storage_bytes(tensors: Iterable[Any], skip: set) -> Dict[int, int]:
    """{storage address: bytes} of the tensors among ``tensors``, each
    storage once, leaving out the storages in ``skip``."""
    out: Dict[int, int] = {}
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st.data_ptr() not in skip and st.nbytes():
            out[st.data_ptr()] = st.nbytes()
    return out


@torch.no_grad()
def slot_bytes(prog: PipelineProgram, stage_params, shared, side_all) -> Dict[str, Any]:
    """Bytes that one slot of each pool holds, measured.

    The JAX executor's ``state_shapes`` evaluates the slots' shapes; the
    port cannot (the RMSNorm function and the CUDA kernels do not run on
    ``meta``), so this runs microbatch 0 through F and B of every chunk
    and the sink with ``stage_params`` (per chunk, one stage's
    parameters, no stage axis) on their device: 1/(p*m) of a step's F
    and B work, no W.  Each slot counts the storages it keeps alive,
    each once, and none of the parameters or side inputs:

      * residual (per chunk): the chunk's input, its output and every
        tensor its F graph saved (``saved_tensors_hooks``).  The output
        is the next chunk's input, or the sink's: per device each holds
        its own copy, but the sink shares its input with the last
        chunk's residual on one stage, so that residual owns it;
      * W-context (per chunk): the deferred linears' ``(a, g)`` pairs
        and the cheap grads.  ``a`` is also saved by the F graph until B
        frees it: the residual owns it from F to B, the W-context from
        B to W, and the two slots never hold it at one tick's end;
      * sink and sink W-context: the same at the loss position.

    ``res_wctx_shared`` (per chunk) and ``sink_shared`` are the bytes a
    W-context shares with its residual: in B's tick both slots are live
    and hold them once (``core/memory.py::measured_timeline`` counts them
    once there; the pool sizes of :meth:`PipelineExecutor.buffer_bytes`,
    like the JAX executor's separate buffers, count them in both).
    """
    C = prog.n_chunks()
    side_mb = tree_map(lambda a: a[0], side_all)
    skip = {t.untyped_storage().data_ptr() for t in tree_leaves((stage_params, shared, side_all))}

    def fwd_saving(fn, *args):
        saved = []

        def pack(t):
            saved.append(t)
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, r = fn(*args)
        return y, r, saved

    x = prog.src_fwd(shared, side_mb).to(prog.act_dtype)
    res, res_b = [], []
    for c in range(C):
        y, r, saved = fwd_saving(prog.chunks[c].fwd, stage_params[c], x, side_mb)
        res.append(r)
        res_b.append(_storage_bytes([x, y] + saved, skip))
        x = y.to(prog.act_dtype)
    lj, sr, saved = fwd_saving(prog.sink.fwd, shared, y, side_mb)
    sink_b = _storage_bytes([lj] + saved, skip | set(res_b[-1]))
    del saved
    dy, sw = prog.sink.bwd_x(shared, sr, loss_seed(lj), side_mb)
    sink_wctx_b = _storage_bytes(tree_leaves(sw), skip)
    del sr, sw
    wctx_b = [None] * C
    for c in reversed(range(C)):
        dy, w = prog.chunks[c].bwd_x(stage_params[c], res.pop(), dy.to(prog.act_dtype),
                                     side_mb)
        wctx_b[c] = _storage_bytes(tree_leaves(w), skip)
    total = lambda d: float(sum(d.values()))  # noqa: E731
    shared_b = lambda a, b: float(sum(n for k, n in a.items() if k in b))  # noqa: E731
    return dict(
        res=tuple(total(d) for d in res_b),
        wctx=tuple(total(d) for d in wctx_b),
        sink=total(sink_b),
        sink_wctx=total(sink_wctx_b),
        res_wctx_shared=tuple(shared_b(w, r) for w, r in zip(wctx_b, res_b)),
        sink_shared=shared_b(sink_wctx_b, sink_b),
    )


class PipelineExecutor:
    """Turns (program, plan) into a pipelined grads-and-loss function."""

    def __init__(self, program: PipelineProgram, plan: ExecutionPlan):
        if program.n_chunks() != plan.n_chunks:
            raise ValueError(f"program has {program.n_chunks()} chunks, plan {plan.n_chunks}")
        self.program = program
        self.plan = plan

    # ------------------------------------------------------------------ #
    # measured buffer accounting
    # ------------------------------------------------------------------ #
    @staticmethod
    def _tree_bytes(tree) -> int:
        """Bytes of a tree's leaves (tensors, fake or meta tensors alike)."""
        return int(sum(math.prod(t.shape) * t.element_size() for t in tree_leaves(tree)))

    @staticmethod
    def accumulator_bytes(stacked, shared) -> Tuple[int, int]:
        """(one card, one device) bytes of the gradient accumulators that
        ``grad_fn`` allocates at step start, allocating nothing (fake or
        meta leaves do): one (p, ...) tensor in ``acc_dt`` per leaf and
        chunk of ``stacked`` and one per leaf of ``shared``, by
        :meth:`_tree_bytes`' rule on the accumulators' dtype.  One card
        holds all p stages; one device of a pipeline holds one stage's
        slice of each stacked tensor plus the shared leaves."""
        def acc(tree) -> int:
            return sum(math.prod(t.shape) * torch.empty((), dtype=acc_dt(t.dtype)).element_size()
                       for t in tree_leaves(tree))

        blocks = acc(stacked)
        p = tree_leaves(stacked)[0].shape[0]
        return blocks + acc(shared), blocks // p + acc(shared)

    def channel_message_bytes(self) -> float:
        """Bytes of one inbox slot (one inter-stage message)."""
        prog = self.program
        return float(math.prod(prog.act_shape) * torch.empty((), dtype=prog.act_dtype).element_size())

    def buffer_bytes(self, stage_params=None, shared=None, side_all=None, *,
                     slots: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Bytes one stage's pools hold at their fullest, by family, as the
        JAX executor allocates them: the plan's slot counts (from the
        interval analysis; residuals and W-contexts in the joint cross-chunk
        pools the executor keys them by) times the measured bytes of one
        slot.  Pass the result of :func:`slot_bytes` as ``slots`` to reuse a
        measurement (the slots depend on the program alone, not on the
        plan)."""
        plan = self.plan
        if slots is None:
            slots = slot_bytes(self.program, stage_params, shared, side_all)
        res_slot, wctx_slot = slots["res"], slots["wctx"]
        res_total = plan.n_res_slots_joint * max(res_slot)
        wctx_total = plan.n_wctx_slots_joint * max(wctx_slot)
        inbox_total = plan.inbox_slot_total() * self.channel_message_bytes()
        sink_total = plan.n_sink_slots * slots["sink"]
        sink_wctx_total = plan.n_sink_wctx_slots * slots["sink_wctx"]
        return dict(
            res=float(res_total),
            wctx=float(wctx_total),
            inbox=float(inbox_total),
            sink=float(sink_total),
            sink_wctx=float(sink_wctx_total),
            total=float(res_total + wctx_total + inbox_total + sink_total + sink_wctx_total),
            res_slot_bytes=tuple(res_slot),
            wctx_slot_bytes=tuple(wctx_slot),
            res_wctx_shared=slots["res_wctx_shared"],
            sink_shared=slots["sink_shared"],
        )

    # ------------------------------------------------------------------ #
    def build_grad_fn(self, on_tick: Optional[Callable[[int, Dict[str, list]], None]] = None):
        """``grad_fn(stacked, shared, side_all) -> (grads, shared_grads, loss)``.

        ``stacked``: per chunk, parameter trees whose leaves carry a leading
        (p,) stage axis; ``side_all``: leaves with a leading (m,) microbatch
        axis.  ``grads`` are stacked like ``stacked``, ``shared_grads`` like
        ``shared``, both in ``acc_dt``; ``loss`` is an fp32 scalar.
        ``on_tick(t, pools)``, if given, sees the pools after each tick's
        hand-offs: ``pools[name][s]`` is stage s's slot dict for ``name`` in
        act_in, grad_in, res, wctx, sink_res, sink_wctx (a byte tally reads
        them; it must not change them).
        """
        prog, plan = self.program, self.plan
        p, C = plan.p, plan.n_chunks

        @torch.no_grad()  # each F builds its own graph (passes.autograd_fbw)
        def grad_fn(stacked, shared, side_all):
            local = [[tree_map(lambda a: a[s], stacked[c]) for s in range(p)] for c in range(C)]
            # one (p, ...) fp32 accumulator per leaf and chunk, allocated once;
            # stage s adds into its contiguous view [s], and the stacked
            # tensors are the step's gradients
            grads = tuple(tree_map(lambda a: torch.zeros(a.shape, dtype=acc_dt(a.dtype),
                                                         device=a.device), stacked[c])
                          for c in range(C))
            acc = [[tree_map(lambda a: a[s], grads[c]) for s in range(p)] for c in range(C)]
            shared_acc = tree_map(lambda a: torch.zeros(a.shape, dtype=acc_dt(a.dtype),
                                                        device=a.device), shared)
            loss = torch.zeros((), dtype=torch.float32, device=shared["embed"].device)
            act_in = [{} for _ in range(p)]  # (chunk, slot) -> activation
            grad_in = [{} for _ in range(p)]  # (chunk, slot) -> activation gradient
            res = [{} for _ in range(p)]  # joint slot -> chunk residuals
            wctx = [{} for _ in range(p)]  # joint slot -> chunk W-context
            sink_res = [{} for _ in range(p)]
            sink_wctx = [{} for _ in range(p)]

            for t in range(plan.n_ticks):
                sends = [None] * p
                for s in range(p):
                    kind = int(plan.op_kind[s, t])
                    if kind == OpKind.IDLE:
                        continue
                    c, j = int(plan.op_chunk[s, t]), int(plan.op_mb[s, t])
                    side_mb = tree_map(lambda a: a[j], side_all)
                    params = local[c][s]
                    is_loss = bool(plan.op_is_loss[s, t])
                    if kind == OpKind.F:
                        if plan.op_is_src[s, t]:
                            x = prog.src_fwd(shared, side_mb).to(prog.act_dtype)
                        else:
                            x = _take(act_in[s], (c, int(plan.op_in_slot[s, t])), "act inbox")
                        y, r = prog.chunks[c].fwd(params, x, side_mb)
                        _put(res[s], int(plan.op_res_slot_joint[s, t]), r, "residual")
                        if is_loss:
                            lj, sr = prog.sink.fwd(shared, y, side_mb)
                            _put(sink_res[s], int(plan.op_sink_slot[s, t]), (sr, lj), "sink residual")
                            loss = loss + lj.float()
                        sends[s] = y.to(prog.act_dtype)
                    elif kind == OpKind.B:
                        r = _take(res[s], int(plan.op_res_slot_joint[s, t]), "residual")
                        if is_loss:
                            sr, lj = _take(sink_res[s], int(plan.op_sink_slot[s, t]), "sink residual")
                            dy, sw = prog.sink.bwd_x(shared, sr, loss_seed(lj), side_mb)
                            _put(sink_wctx[s], int(plan.op_sink_wctx_slot[s, t]), sw, "sink wctx")
                            dy = dy.to(prog.act_dtype)
                        else:
                            dy = _take(grad_in[s], (c, int(plan.op_in_slot[s, t])), "grad inbox")
                        dx, w = prog.chunks[c].bwd_x(params, r, dy, side_mb)
                        del r
                        _put(wctx[s], int(plan.op_wctx_slot_joint[s, t]), w, "wctx")
                        if plan.op_is_last_b[s, t]:
                            shared_acc = prog.src_bwd_w(shared, side_mb, dx, shared_acc)
                        else:
                            sends[s] = dx.to(prog.act_dtype)
                    else:  # W: the W-context alone, no residuals
                        w = _take(wctx[s], int(plan.op_wctx_slot_joint[s, t]), "wctx")
                        out = prog.chunks[c].bwd_w(params, w, side_mb, acc=acc[c][s])
                        del w
                        # the block linears come back in place; the rest (norm
                        # gains, masks) is added out of place: into the view
                        for dst, src in zip(tree_leaves(acc[c][s]), tree_leaves(out)):
                            if src is not dst:
                                dst.copy_(src)
                        del out
                        if is_loss:
                            sw = _take(sink_wctx[s], int(plan.op_sink_wctx_slot[s, t]), "sink wctx")
                            shared_acc = prog.sink.bwd_w(shared, sw, side_mb, acc=shared_acc)

                # end of tick: local deposits, then the channel hand-offs
                for s in range(p):
                    if plan.send_local[s, t]:
                        box = grad_in if plan.local_is_grad[s, t] else act_in
                        key = (int(plan.local_chunk[s, t]), int(plan.local_slot[s, t]))
                        _put(box[s], key, sends[s], "local inbox")
                for s in range(p):
                    for d in range(N_CHANNELS):
                        if not plan.recv_valid[s, t, d]:
                            continue
                        src = (s - _CHANNEL_SHIFT[d]) % p
                        if plan.send_channel[src, t] != d or sends[src] is None:
                            raise RuntimeError(f"tick {t}: stage {s} expects channel {d} "
                                               f"from stage {src}, which sent nothing")
                        box = act_in if d in _ACT_CHANNELS else grad_in
                        key = (int(plan.recv_chunk[s, t, d]), int(plan.recv_slot[s, t, d]))
                        _put(box[s], key, sends[src], "inbox")
                if on_tick is not None:
                    on_tick(t, dict(act_in=act_in, grad_in=grad_in, res=res, wctx=wctx,
                                    sink_res=sink_res, sink_wctx=sink_wctx))

            for pools, what in ((act_in, "act inbox"), (grad_in, "grad inbox"), (res, "residual"),
                                (wctx, "wctx"), (sink_res, "sink residual"),
                                (sink_wctx, "sink wctx")):
                left = [s for s in range(p) if pools[s]]
                if left:
                    raise RuntimeError(f"{what} slots still live after the last tick on stages {left}")
            return grads, shared_acc, loss

        return grad_fn


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    """The side stream every graph of this process captures on, one per
    device: cuBLAS keeps a workspace for each stream it has run on until
    the process ends, so a stream of its own for each graph would leave one
    workspace behind for every graph captured."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


class GraphedGradFn:
    """A pipeline walk (:meth:`PipelineExecutor.build_grad_fn`) recorded
    once into a ``torch.cuda.CUDAGraph`` and replayed on every later call:
    the ``grad_fn`` of ``executor_mode="graph"``, with the same signature.

    The graph reads the parameters at the addresses it saw at capture, so
    the graph is keyed on the ``(data_ptr, shape, stride, dtype)`` of every
    parameter leaf and the shape and dtype of every side input.  The
    training step updates the parameters in place, so their addresses stay;
    fresh tensors (the driver's ``init_state`` after a failure) change the
    key, and the call drops the old graph and its memory pool before it
    captures again.  It never runs the walk eagerly in place of a replay,
    and raises on tensors that are not on a CUDA device.

    A capture copies the side inputs into static buffers it owns, runs one
    eager walk on the process's capture stream (:func:`_capture_stream`)
    as warm-up (the walk writes no parameter;
    it loads the kernels, makes their first-call settings and sets up
    cuBLAS for that stream), then records one walk on that stream into a
    private memory pool: every tensor the walk allocates, the accumulators
    and the returned gradients included, stays there at a fixed address.
    Each call copies the side inputs into the static buffers and replays.
    ``grads`` and ``shared_grads`` are the graph's static outputs, which
    the next call overwrites; ``loss`` is a clone.  ``captures`` counts the
    captures and ``capture_s`` holds the host seconds of each, warm-up
    included; ``walk`` is the eager walk the captures run.
    """

    def __init__(self, walk: Callable):
        self.walk = walk
        self.captures = 0
        self.capture_s: List[float] = []
        self._key = None
        self._graph = None
        self._side = None
        self._out = None
        self._stream = None

    def __call__(self, stacked, shared, side_all):
        leaves, struct = tree_flatten((stacked, shared))
        side, side_struct = tree_flatten(side_all)
        off = sorted({str(t.device) for t in leaves + side if t.device.type != "cuda"})
        if off:
            raise ValueError(f"a CUDA graph of the walk needs CUDA tensors; got tensors on {off}")
        key = (struct, side_struct,
               tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in leaves),
               tuple((tuple(t.shape), t.dtype) for t in side))
        if key != self._key:
            self._capture(stacked, shared, side_all, key)
        else:
            for dst, src in zip(tree_leaves(self._side), side):
                dst.copy_(src)
        self._graph.replay()
        grads, shared_grads, loss = self._out
        return grads, shared_grads, loss.clone()

    def _capture(self, stacked, shared, side_all, key) -> None:
        if self._graph is not None:  # two pools of a full-width step do not fit one card
            self._graph = self._out = self._side = self._key = None
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dev = tree_leaves(shared)[0].device
        if self._stream is None:
            self._stream = _capture_stream(dev)
        side = tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device=a.device).copy_(a),
                        side_all)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            self.walk(stacked, shared, side)  # warm-up; its results are dropped
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph synchronizes and empties the allocator's cache first
        with torch.cuda.graph(graph, stream=self._stream):
            out = self.walk(stacked, shared, side)
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        self._graph, self._out, self._side, self._key = graph, out, side, key
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
