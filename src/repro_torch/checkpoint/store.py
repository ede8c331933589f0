"""Checkpoint store of the port, in the JAX package's on-disk layout.

Counterpart of ``src/repro/checkpoint/store.py``::

  <dir>/step_<n>/
    manifest.json      -- step, the leaf keys of every entry, meta, dtypes
    <name>.npz         -- one per state entry (params, shared, opt, ...)

Arrays are keyed by their tree path formatted as ``jax.tree_util.keystr``
formats it (``tree.keyed_leaves``), at their global (stage-stacked)
shapes, so a float32/int32 checkpoint written by either package restores
in the other.  numpy has no bfloat16 (and the card's host has no
``ml_dtypes``): the port stores a bf16 leaf by its uint16 bit pattern and
records ``bfloat16`` under ``dtypes`` in the manifest.  It reads the JAX
store's bf16 leaves (numpy's 2-byte void) bit for bit too.  The JAX store
itself cannot restore bf16 leaves (numpy has no cast from its void dtype),
so bf16 checkpoints cross from the JAX package to the port only.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import keyed_leaves, tree_flatten, tree_unflatten

PyTree = Any

__all__ = ["save", "restore", "latest_step", "reshard_stages"]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _to_torch(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The stored array as a tensor of ``like``'s dtype: bf16 from its bits
    (the port's uint16 or the JAX store's 2-byte void), else by value."""
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind in "uV":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a)).to(like.dtype)


def save(directory: str, step: int, state: Dict[str, PyTree], meta: Optional[dict] = None) -> str:
    """Atomic checkpoint write (tmp dir + rename)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    index, dtypes = {}, {}
    for name, tree in state.items():
        data = {key: _to_numpy(leaf) for key, leaf in keyed_leaves(tree)}
        np.savez(os.path.join(tmp, f"{name}.npz"), **data)
        index[name] = sorted(data)
        dtypes[name] = {key: "bfloat16" for key, leaf in keyed_leaves(tree)
                        if leaf.dtype == torch.bfloat16}
        del data
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "index": index, "meta": meta or {}, "dtypes": dtypes}, f,
                  indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: Optional[str]) -> Optional[int]:
    if directory is None or not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(directory: str, step: int, proto: Dict[str, PyTree]) -> Tuple[Dict[str, PyTree], dict]:
    """Read step ``step`` into ``proto``: every leaf of every entry is
    overwritten in place (on the proto's device, in its dtype) and the
    proto is returned with the manifest.  A key missing from the file
    raises ``KeyError``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for name, tree in proto.items():
        with np.load(os.path.join(path, f"{name}.npz")) as z:
            for key, leaf in keyed_leaves(tree):
                leaf.copy_(_to_torch(z[key], leaf))
    return proto, manifest


def reshard_stages(stacked_old, p_old: int, p_new: int):
    """Elastic re-shard: regroup stage-stacked block params for a new p.

    Works when blocks-per-stage changes by an integer factor.  Block leaves
    have shape (p_old, g_old, ...); masks are recomputed by the caller via
    ``init_params``.
    """
    if p_old == p_new:
        return stacked_old

    def regroup(leaf):
        if leaf.ndim < 2 or leaf.shape[0] != p_old:
            return leaf
        total = p_old * leaf.shape[1]
        if total % p_new:
            raise ValueError(f"cannot reshard {tuple(leaf.shape)} to p={p_new}")
        return leaf.reshape((p_new, total // p_new) + tuple(leaf.shape[2:]))

    leaves, struct = tree_flatten(stacked_old)
    return tree_unflatten(struct, [regroup(x) for x in leaves])
