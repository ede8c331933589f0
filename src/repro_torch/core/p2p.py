"""Point-to-point traffic between the pipeline's ranks, one process a stage.

Counterpart of the collectives inside the JAX executor's ``shard_map``: the
end-of-tick ``jax.lax.ppermute`` of each live channel
(``src/repro/core/executor.py:701``) and the ``psum`` of the shared
gradients and the loss after the last tick (``:751-752``).  One transport,
``host``: gloo point-to-point between the ranks' processes, every message
through a host buffer.  On the card each (peer, channel) this rank sends to
or receives from has one pinned host buffer, allocated once at the plan's
channel shape; a send is copied device -> pinned buffer before it is
posted, an arrival pinned buffer -> device after its wait.  On the CPU the
tensors are host tensors already: a send goes out as it is and an arrival
lands in a fresh tensor.  NCCL between cards is not ported (ROADMAP Queue 1,
item 1): asking for it raises (``launch/mesh.py::init_pipe_group``).

Every wait has the group's timeout; a message that does not come fails
with the tick, the rank and the channel in its text instead of hanging.
The reductions add in stage order -- rank 0's value, then rank 1's, and so
on -- on every rank, so every rank holds the same bits (gloo's
``all_reduce`` sums in an order of its own).
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves
from .schedules.ir import CHANNEL_SHIFT, N_CHANNELS, ExecutionPlan

__all__ = ["HostTransport", "check_channels", "exchange", "gather_in_stage_order",
           "sum_in_stage_order", "REDUCE_CHUNK"]

# elements of one host transfer of the stage-order sum: a 92544 x 2048 fp32
# leaf goes through its pinned buffer in 23 pieces of 32 MiB
REDUCE_CHUNK = 1 << 23


def _timeout(group) -> datetime.timedelta:
    return datetime.timedelta(seconds=group.timeout_s)


def exchange(group, sends: Sequence[Tuple[int, torch.Tensor, int]],
             recvs: Sequence[Tuple[int, torch.Tensor, int]], what: Callable[[], str]) -> None:
    """Posts every ``(peer, host tensor, tag)`` of ``sends`` and ``recvs``
    at once (``batch_isend_irecv``) and waits for all of them, each wait
    bounded by the group's timeout; a failed or timed-out wait raises with
    ``what()`` in the message."""
    ops = [dist.P2POp(dist.isend, t, peer, tag=tag) for peer, t, tag in sends]
    ops += [dist.P2POp(dist.irecv, t, peer, tag=tag) for peer, t, tag in recvs]
    if not ops:
        return
    try:
        for req in dist.batch_isend_irecv(ops):
            req.wait(_timeout(group))
    except Exception as e:  # gloo's timeout and a peer's closed connection alike
        raise RuntimeError(f"{what()}: no message within {group.timeout_s:g} s or a peer "
                           f"failed ({type(e).__name__}: {e})") from e


def check_channels(plan: ExecutionPlan, rank: int) -> None:
    """Before any traffic: each receive of ``rank``'s row of the tables has
    a sender in the sender's row at that tick and channel, and each message
    the plan sends to ``rank`` is one it files (``recv_valid``), so both
    sides, derived from :meth:`ExecutionPlan.channel_edges`, post matching
    operations."""
    p = plan.p
    for t in range(plan.n_ticks):
        for d in range(N_CHANNELS):
            src = (rank - CHANNEL_SHIFT[d]) % p
            sent = int(plan.send_channel[src, t]) == d
            if plan.recv_valid[rank, t, d] and not sent:
                raise RuntimeError(f"tick {t}: rank {rank} expects channel {d} from rank {src}, "
                                   f"whose row of the tables sends nothing on it")
            if sent and not plan.recv_valid[rank, t, d]:
                raise RuntimeError(f"tick {t}: rank {src} sends channel {d} to rank {rank}, "
                                   f"whose row of the tables files no such message")


class HostTransport:
    """One rank's end-of-tick hand-offs of a plan over the ``host`` transport.

    ``exchange(t, send)`` posts this rank's send of tick ``t`` (its op's
    output, or None) and its receives, exactly on ``plan.channel_edges(t,
    d)``, and returns the arrivals ``[(channel, tensor on the rank's
    device)]``.  Messages are ``shape`` and ``dtype`` (the program's
    ``act_shape``, ``act_dtype``), tagged with their channel."""

    name = "host"

    def __init__(self, group, plan: ExecutionPlan, shape: Tuple[int, ...], dtype: torch.dtype):
        self.group, self.plan = group, plan
        self.rank, self.device = group.rank, group.device
        self.shape, self.dtype = tuple(shape), dtype
        self.staged = self.device.type == "cuda"
        peers = {(src if dst == self.rank else dst, d, src == self.rank)
                 for t in range(plan.n_ticks) for d in range(N_CHANNELS)
                 for src, dst in plan.channel_edges(t, d) if self.rank in (src, dst)}
        # one pinned buffer a (peer, channel, direction), made once
        self._buf: Dict[Tuple[int, int, bool], torch.Tensor] = {
            key: torch.empty(self.shape, dtype=dtype, pin_memory=True)
            for key in sorted(peers)} if self.staged else {}
        self.messages = 0  # sent and received, counted over the transport's life

    def buffer_bytes(self) -> int:
        """Pinned host bytes this rank's buffers hold."""
        return sum(b.numel() * b.element_size() for b in self._buf.values())

    def exchange(self, t: int, send: Optional[torch.Tensor]) -> List[Tuple[int, torch.Tensor]]:
        sends, recvs = [], []
        for d in range(N_CHANNELS):
            for src, dst in self.plan.channel_edges(t, d):
                if src == self.rank:
                    if send is None:
                        raise RuntimeError(f"tick {t}: rank {self.rank} sends channel {d} to rank "
                                           f"{dst} and its op made no output")
                    if tuple(send.shape) != self.shape or send.dtype != self.dtype:
                        raise RuntimeError(
                            f"tick {t}: rank {self.rank}'s message on channel {d} is "
                            f"{tuple(send.shape)} {send.dtype}, the channel's {self.shape} "
                            f"{self.dtype}")
                    if self.staged:
                        out = self._buf[(dst, d, True)]
                        out.copy_(send)  # device -> pinned; waits for the producing kernels
                    else:
                        out = send.contiguous()
                    sends.append((dst, out, d))
                if dst == self.rank:
                    buf = (self._buf[(src, d, False)] if self.staged else
                           torch.empty(self.shape, dtype=self.dtype))
                    recvs.append((src, buf, d))
        exchange(self.group, sends, recvs, lambda: (
            f"tick {t}: rank {self.rank}, sending on channel(s) "
            f"{[(tag, peer) for peer, _, tag in sends]}, receiving on channel(s) "
            f"{[(tag, peer) for peer, _, tag in recvs]} as (channel, peer)"))
        self.messages += len(sends) + len(recvs)
        return [(d, buf.to(self.device) if self.staged else buf) for _, buf, d in recvs]


def _host(x: torch.Tensor, pinned: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` (flat, contiguous) as a host tensor: itself on the CPU, else
    copied into the front of ``pinned``."""
    if pinned is None:
        return x
    out = pinned[:x.numel()]
    out.copy_(x)
    return out


def gather_in_stage_order(group, x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's value of the small tensor ``x``, in rank order, on
    ``x``'s device (an ``all_gather`` of host copies)."""
    host = x.detach().reshape(-1).cpu().contiguous()
    outs = [torch.empty_like(host) for _ in range(group.world)]
    try:
        work = dist.all_gather(outs, host, async_op=True)
        work.wait(_timeout(group))
    except Exception as e:
        raise RuntimeError(f"rank {group.rank}: the stage-order gather timed out or a peer "
                           f"failed ({type(e).__name__}: {e})") from e
    return [o.reshape(x.shape).to(x.device) for o in outs]


def _broadcast(group, x: torch.Tensor, src: int, what: str) -> None:
    try:
        dist.broadcast(x, src, async_op=True).wait(_timeout(group))
    except Exception as e:
        raise RuntimeError(f"rank {group.rank}: {what} ({type(e).__name__}: {e})") from e


def sum_in_stage_order(group, tree: Any, chunk: int = REDUCE_CHUNK) -> Any:
    """Each leaf of ``tree`` replaced, in place, on every rank, by its sum
    over the ranks, added in stage order: the first rank's value, then the
    next one's, and so on (the JAX executor's ``psum`` of the shared
    gradients).  A rank whose leaf is all zeros adds nothing (a sum with
    zeros is exact), so a leaf that one stage alone writes -- internlm2's
    embedding on the source stage, its head and final norm on the loss
    stage -- travels once, from that rank to the others; a leaf written on
    several ranks goes down the chain of those ranks, each adding its
    own, and the last one's sum goes to every rank.  Every transfer runs
    through a host buffer of ``chunk`` elements (pinned on the card).
    Returns ``tree``."""
    leaves = tree_leaves(tree)
    if group.world == 1 or not leaves:
        return tree
    rank = group.rank
    flags = torch.tensor([bool(torch.count_nonzero(x)) for x in leaves], dtype=torch.uint8)
    written = torch.stack(gather_in_stage_order(group, flags))  # (world, n_leaves)
    staged = group.device.type == "cuda"
    width = max(x.numel() for x in leaves)
    by_dtype: Dict[torch.dtype, torch.Tensor] = {}
    for i, x in enumerate(leaves):
        who = [r for r in range(group.world) if written[r, i]]
        if not who:
            continue
        if not x.is_contiguous():
            raise ValueError(f"leaf {i}: the stage-order sum needs contiguous leaves")
        pinned = None
        if staged:
            if x.dtype not in by_dtype:
                by_dtype[x.dtype] = torch.empty(min(chunk, width), dtype=x.dtype, pin_memory=True)
            pinned = by_dtype[x.dtype]
        flat = x.view(-1)
        for a, b in zip(who, who[1:]):  # the running sum goes down the chain
            if rank not in (a, b):
                continue
            for lo in range(0, flat.numel(), chunk):
                part = flat[lo:lo + chunk]
                if rank == a:
                    exchange(group, [(b, _host(part, pinned), 0)], [], lambda: (
                        f"rank {rank}: stage-order sum of leaf {i}, sending to rank {b}"))
                else:
                    buf = (pinned[:part.numel()] if staged else
                           torch.empty(part.numel(), dtype=x.dtype))
                    exchange(group, [], [(a, buf, 0)], lambda: (
                        f"rank {rank}: stage-order sum of leaf {i}, receiving from rank {a}"))
                    part.add_(buf.to(x.device) if staged else buf)
        last = who[-1]
        for lo in range(0, flat.numel(), chunk):
            part = flat[lo:lo + chunk]
            buf = (_host(part, pinned) if rank == last else
                   pinned[:part.numel()] if staged else part)
            _broadcast(group, buf, last, f"stage-order sum of leaf {i}, broadcast from rank "
                                         f"{last}")
            if rank != last and staged:
                part.copy_(buf)
    return tree
