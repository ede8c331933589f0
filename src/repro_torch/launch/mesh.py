"""Production mesh descriptions and the logical axis binding, shape side only.

Counterpart of ``src/repro/launch/mesh.py``.  The physical meshes are the
deployment target's: (16, 16) = ("data", "model") per pod; (2, 16, 16) =
("pod", "data", "model") for two pods.  The JAX package binds logical
roles onto physical axes: pp="data" (16 pipeline stages), tp="model"
(16-way tensor parallelism), dp="pod" (data parallelism across pods).

The port has no SPMD program, so a mesh here is a description, axis names
and sizes, with no devices and no process group: the dry run
(``launch/dryrun.py``) reads the per-device sizes from it.  Tensor
parallelism is not ported (ROADMAP Queue 1, item 7), so a binding with a
bound tp axis raises, as ``models/modules.py::ShardCtx`` does, and the
dry run binds tp to no axis: its "model" axis is left idle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MeshSpec", "AxisBinding", "make_production_mesh"]


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

