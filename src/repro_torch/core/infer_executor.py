"""F-only pipelined serving executor (prefill + decode) on one device.

Counterpart of ``src/repro/core/infer_executor.py``.  ``compile_infer_plan``
and the plan/program records are the JAX package's, verbatim (numpy).  The
executor is re-designed for one device that holds all p stages: the host
walks the plan's tick table; in each tick every stage runs its valid F, in
stage order, reading its input from its own per-chunk inbox (or the source);
after all stages ran, the outputs are handed on exactly as ``send_up`` /
``recv_up`` / ``send_down`` / ``recv_down`` / ``send_local`` say (the JAX
version's end-of-tick ``ppermute``).  Each group's cache slice is a view of
the stacked cache buffers, updated in place by the chunk functions; the JAX
version is pure and re-emits the caches instead.  One process per stage
with NCCL point-to-point sends is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..tree import tree_map
from .schedules.ir import Placement

__all__ = ["InferPlan", "InferProgram", "InferExecutor", "compile_infer_plan"]


@dataclasses.dataclass
class InferPlan:
    p: int
    m: int
    n_chunks: int
    n_ticks: int
    valid: np.ndarray  # (p, T) bool: run an F this tick
    chunk: np.ndarray  # (p, T)
    mb: np.ndarray  # (p, T)
    is_src: np.ndarray  # (p, T)
    is_sink: np.ndarray  # (p, T)
    send_up: np.ndarray  # (p, T) send output to stage+1
    send_down: np.ndarray  # (p, T)
    send_local: np.ndarray  # (p, T) deposit locally (chunk turn)
    local_chunk: np.ndarray
    recv_up: np.ndarray  # (p, T, 2): [valid, chunk] arriving from stage-1
    recv_down: np.ndarray


def compile_infer_plan(placement: Placement, m: int) -> InferPlan:
    """Fill-drain forward pipeline via greedy list scheduling.

    F(c, k, j) runs at the earliest tick after its producer F finished
    (cross-stage arrivals land at tick+1) with its stage free; steady-state
    cadence is C ticks per microbatch (each stage owns C chunk passes).
    """
    p, C = placement.p, placement.n_chunks
    ticks = {}
    stage_free = [0] * p
    for j in range(m):
        for c in range(C):
            for k in range(p):
                s = placement.stage_of(c, k)
                prev = placement.fwd_prev(c, k)
                ready = 0
                if prev is not None:
                    ready = ticks[(prev[0], prev[1], j)] + 1
                t = max(ready, stage_free[s])
                ticks[(c, k, j)] = t
                stage_free[s] = t + 1
    T = max(ticks.values()) + 1
    shape = (p, T)
    valid = np.zeros(shape, bool)
    chunk = np.zeros(shape, np.int32)
    mb = np.zeros(shape, np.int32)
    is_src = np.zeros(shape, bool)
    is_sink = np.zeros(shape, bool)
    send_up = np.zeros(shape, bool)
    send_down = np.zeros(shape, bool)
    send_local = np.zeros(shape, bool)
    local_chunk = np.zeros(shape, np.int32)
    recv_up = np.zeros((p, T, 2), np.int32)
    recv_down = np.zeros((p, T, 2), np.int32)
    for j in range(m):
        for c in range(C):
            for k in range(p):
                s = placement.stage_of(c, k)
                t = ticks[(c, k, j)]
                assert not valid[s, t], "fill-drain collision"
                valid[s, t] = True
                chunk[s, t] = c
                mb[s, t] = j
                nxt = placement.fwd_next(c, k)
                if placement.fwd_prev(c, k) is None:
                    is_src[s, t] = True
                if nxt is None:
                    is_sink[s, t] = True
                else:
                    ns = placement.stage_of(*nxt)
                    if ns == s:
                        send_local[s, t] = True
                        local_chunk[s, t] = nxt[0]
                    elif ns == (s + 1) % p:
                        send_up[s, t] = True
                        recv_up[ns, t] = (1, nxt[0])
                    elif ns == (s - 1) % p:
                        send_down[s, t] = True
                        recv_down[ns, t] = (1, nxt[0])
                    else:
                        raise ValueError("non-adjacent send")
    return InferPlan(
        p=p,
        m=m,
        n_chunks=C,
        n_ticks=T,
        valid=valid,
        chunk=chunk,
        mb=mb,
        is_src=is_src,
        is_sink=is_sink,
        send_up=send_up,
        send_down=send_down,
        send_local=send_local,
        local_chunk=local_chunk,
        recv_up=recv_up,
        recv_down=recv_down,
    )


@dataclasses.dataclass
class InferProgram:
    """chunk_fns[c](params_c, x, side_mb, cache_c_mb, pos) -> (y, cache);
    src(shared, side_mb) -> x; sink(shared, y, side_mb) -> logits."""

    chunk_fns: Sequence[Callable]
    src: Callable
    sink: Callable
    act_shape: Tuple[int, ...]
    act_dtype: Any
    out_shape: Tuple[int, ...]
    out_dtype: Any


class InferExecutor:
    def __init__(self, program: InferProgram, plan: InferPlan):
        self.program = program
        self.plan = plan

    def build_step_fn(self):
        """(stacked_params, shared, side_all, caches, pos) ->
        (outputs (m, *out_shape), caches).

        ``stacked_params``: per chunk, leaves with a leading (p,) stage axis.
        ``side_all``: leaves with a leading (m,) group axis.
        ``caches``: per chunk, leaves with leading (p, m) axes; updated in
        place and returned.
        """
        prog, plan = self.program, self.plan
        p, C = plan.p, plan.n_chunks

        def step_fn(stacked_params, shared, side_all, caches, pos):
            device = shared["embed"].device
            local = [[tree_map(lambda a: a[s], stacked_params[c]) for s in range(p)]
                     for c in range(C)]
            outputs = torch.zeros((plan.m,) + tuple(prog.out_shape),
                                  dtype=prog.out_dtype, device=device)
            inbox = [[None] * C for _ in range(p)]
            for t in range(plan.n_ticks):
                ys = [None] * p
                for s in range(p):
                    if not plan.valid[s, t]:
                        continue
                    c, j = int(plan.chunk[s, t]), int(plan.mb[s, t])
                    side_mb = tree_map(lambda a: a[j], side_all)
                    if plan.is_src[s, t]:
                        x = prog.src(shared, side_mb).to(prog.act_dtype)
                    else:
                        x = inbox[s][c]
                        inbox[s][c] = None
                    cache_view = tree_map(lambda a: a[s, j], caches[c])  # aliases caches
                    y, _ = prog.chunk_fns[c](local[c][s], x, side_mb, cache_view, pos)
                    if plan.is_sink[s, t]:
                        outputs[j] = prog.sink(shared, y, side_mb).to(prog.out_dtype)
                    ys[s] = y.to(prog.act_dtype)
                # end of tick: local deposits, then the two channel hand-offs
                for s in range(p):
                    if plan.send_local[s, t]:
                        inbox[s][int(plan.local_chunk[s, t])] = ys[s]
                for s in range(p):
                    for rv, src_stage, flag in (
                        (plan.recv_up[s, t], (s - 1) % p, plan.send_up),
                        (plan.recv_down[s, t], (s + 1) % p, plan.send_down),
                    ):
                        if rv[0]:
                            assert flag[src_stage, t] and ys[src_stage] is not None
                            inbox[s][int(rv[1])] = ys[src_stage]
            return outputs, caches

        return step_fn
