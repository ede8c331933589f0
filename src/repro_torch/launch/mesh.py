"""Production mesh descriptions and the logical axis binding, shape side only.

Counterpart of ``src/repro/launch/mesh.py``.  The physical meshes are the
deployment target's: (16, 16) = ("data", "model") per pod; (2, 16, 16) =
("pod", "data", "model") for two pods.  The JAX package binds logical
roles onto physical axes: pp="data" (16 pipeline stages), tp="model"
(16-way tensor parallelism), dp="pod" (data parallelism across pods).

The port has no SPMD program, so a mesh here is a description, axis names
and sizes, with no devices: the dry run (``launch/dryrun.py``) reads the
per-device sizes from it.  Tensor parallelism is not ported (ROADMAP Queue
1, item 7), so a binding with a bound tp axis raises, as
``models/modules.py::ShardCtx`` does, and the dry run binds tp to no axis:
its "model" axis is left idle.

The device side of the pipe axis is :class:`PipeGroup`: one process a
stage, rank = stage, world = p, joined by a ``torch.distributed`` gloo
group (``core/p2p.py`` carries the traffic).  :func:`init_pipe_group` makes
it from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``)
or from an explicit rank, world and ``init_method`` (a ``file://`` store);
:func:`spawn_ranks` starts the ranks of one machine as processes of their
own.  A rank's device: ``cuda:{local_rank}`` when the machine has a card
for every rank; ``cuda:0`` for every rank only when the caller asks
(``share_card``); the CPU only when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["MeshSpec", "AxisBinding", "make_production_mesh", "PipeGroup", "pipe_device",
           "init_pipe_group", "spawn_ranks", "PIPE_TIMEOUT_S"]

# the longest a rank waits for a peer: a rendezvous, a tick's messages, a
# reduction; a tick of four ranks sharing one card at full width takes
# seconds, so minutes mean a deadlock or a dead peer
PIPE_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and sizes (the JAX ``Mesh``'s ``axis_names`` and
    ``devices.shape``), no devices."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} and shape {self.shape} differ in rank")

    @property
    def label(self) -> str:
        return "x".join(str(k) for k in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


@dataclasses.dataclass(frozen=True)
class AxisBinding:
    pipe: str = "data"
    tp: Optional[str] = None
    dp: Optional[str] = None  # "pod" on the multi-pod mesh

    def __post_init__(self):
        if self.tp is not None:
            raise NotImplementedError(
                f"tensor parallelism (tp bound to mesh axis {self.tp!r}) is not ported to "
                "repro_torch yet; bind tp=None"
            )

    def sizes(self, mesh: MeshSpec) -> Tuple[int, int, int]:
        """(p, tp, dp): the sizes of the axes bound to each role, 1 where
        none is bound."""
        ax = dict(zip(mesh.axis_names, mesh.shape))
        return (
            ax[self.pipe],
            ax[self.tp] if self.tp else 1,
            ax[self.dp] if self.dp else 1,
        )



@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """One rank of the pipe axis: stage ``rank`` of ``world``, on ``device``,
    in the default ``torch.distributed`` group (gloo), every wait bounded
    by ``timeout_s``."""

    rank: int
    world: int
    device: torch.device
    timeout_s: float = PIPE_TIMEOUT_S
    transport: str = "host"

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def pipe_device(device: str, local_rank: int, world: int, share_card: bool) -> torch.device:
    """A rank's device (see the module's docstring); raises rather than
    pick another."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a pipeline rank runs on cuda or cpu, not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA card and none is available; pass --device "
                           "cpu to run the ranks on the CPU on purpose")
    cards = torch.cuda.device_count()
    if share_card:
        return torch.device("cuda", 0)
    if cards < world:
        raise RuntimeError(f"{world} ranks, one a stage, need {world} CUDA cards and this machine "
                           f"has {cards}; pass --share-card to put every rank on cuda:0")
    return torch.device("cuda", local_rank)


def init_pipe_group(*, rank: Optional[int] = None, world: Optional[int] = None,
                    init_method: Optional[str] = None, local_rank: Optional[int] = None,
                    device: str = "cuda", share_card: bool = False, transport: str = "host",
                    timeout_s: float = PIPE_TIMEOUT_S) -> PipeGroup:
    """Joins this process to the pipe group and returns its rank's
    :class:`PipeGroup`.  Without ``rank`` it reads torchrun's environment.
    Only the ``host`` transport exists: ``nccl`` raises."""
    if transport == "nccl":
        raise NotImplementedError(
            "the nccl transport is not ported: NCCL refuses two ranks on one card, and the "
            "card-to-card transport waits for a machine with four cards (ROADMAP Queue 1, item 1); "
            "use transport 'host'")
    if transport != "host":
        raise ValueError(f"unknown transport {transport!r}; the port has 'host'")
    if rank is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    if world is None or init_method is None:
        raise ValueError("an explicit rank needs its world and init_method")
    dev = pipe_device(device, rank if local_rank is None else local_rank, world, share_card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return PipeGroup(rank, world, dev, timeout_s, transport)


# seconds the other ranks get, once one failed, to fail on their own
_GRACE_S = 2.0


def _rank_entry(rank: int, fn: Callable, world: int, init_method: str, args: Sequence[Any]):
    fn(rank, world, init_method, *args)


def spawn_ranks(fn: Callable, world: int, args: Sequence[Any] = (), *, timeout_s: float) -> None:
    """Runs ``fn(rank, world, init_method, *args)`` in ``world`` fresh
    processes (``spawn``), joined through a ``file://`` store in a
    temporary directory, and waits for all of them at most ``timeout_s``.
    When a rank fails, the others get ``_GRACE_S`` to fail on their own
    (a peer's failure often says more than its own), then every rank still
    running is ended and this raises with each failed rank's traceback, in
    rank order; past the deadline every rank is ended and this raises."""
    with tempfile.TemporaryDirectory(prefix="repro_pipe_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(_rank_entry, args=(fn, world, init, tuple(args)), nprocs=world,
                                 join=False, start_method="spawn")
        procs, deadline, failed_at = ctx.processes, time.monotonic() + timeout_s, None
        try:
            while any(proc.is_alive() for proc in procs):
                now = time.monotonic()
                if failed_at is None and any(proc.exitcode not in (None, 0) for proc in procs):
                    failed_at = now
                if failed_at is not None and now > failed_at + _GRACE_S:
                    break
                if now > deadline:
                    raise TimeoutError(f"the {world} pipeline ranks did not end within "
                                       f"{timeout_s:g} s")
                time.sleep(0.05)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        failed = [r for r, proc in enumerate(procs) if proc.exitcode != 0]
        if failed:
            raise RuntimeError("".join(_rank_error(r, procs[r], ctx.error_files[r])
                                       for r in failed))


def _rank_error(rank: int, proc, error_file: str) -> str:
    if os.access(error_file, os.R_OK):
        with open(error_file, "rb") as f:
            return f"\n-- rank {rank} failed:\n{pickle.load(f)}"
    return f"\n-- rank {rank} ended with exit code {proc.exitcode}\n"
