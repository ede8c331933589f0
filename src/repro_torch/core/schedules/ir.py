"""Schedule IR of the port.  This slice needs only :class:`Placement`, a
copy of ``src/repro/core/schedules/ir.py::Placement`` (the serving plan is
fill-drain; schedules and tick tables for training come with that slice)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["Placement"]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Maps (chunk, position) -> stage.

    ``stage_seq[c][k]`` is the stage executing forward position ``k`` of chunk
    ``c``.  Every chunk visits every stage exactly once.  Examples for p=4:

      * single chunk:            ``[[0, 1, 2, 3]]``
      * interleaved, 2 chunks:   ``[[0, 1, 2, 3], [0, 1, 2, 3]]``
      * ZB-V:                    ``[[0, 1, 2, 3], [3, 2, 1, 0]]``
    """

    stage_seq: Tuple[Tuple[int, ...], ...]

    @property
    def p(self) -> int:
        return len(self.stage_seq[0])

    @property
    def n_chunks(self) -> int:
        return len(self.stage_seq)

    def __post_init__(self):
        p = self.p
        for c, seq in enumerate(self.stage_seq):
            if sorted(seq) != list(range(p)):
                raise ValueError(
                    f"chunk {c} placement {seq} must be a permutation of 0..{p-1}"
                )

    @staticmethod
    def linear(p: int, n_chunks: int = 1) -> "Placement":
        return Placement(tuple(tuple(range(p)) for _ in range(n_chunks)))

    @staticmethod
    def vshape(p: int) -> "Placement":
        return Placement((tuple(range(p)), tuple(reversed(range(p)))))

    def stage_of(self, chunk: int, pos: int) -> int:
        return self.stage_seq[chunk][pos]

    def pos_of(self, chunk: int, stage: int) -> int:
        return self.stage_seq[chunk].index(stage)

    def fwd_prev(self, chunk: int, pos: int) -> Optional[Tuple[int, int]]:
        """(chunk, pos) producing the input activation, or None for the source."""
        if pos > 0:
            return (chunk, pos - 1)
        if chunk > 0:
            return (chunk - 1, self.p - 1)
        return None

    def fwd_next(self, chunk: int, pos: int) -> Optional[Tuple[int, int]]:
        if pos < self.p - 1:
            return (chunk, pos + 1)
        if chunk < self.n_chunks - 1:
            return (chunk + 1, 0)
        return None
