"""Minimal pytree helpers over the nested dict/tuple/list parameter and
cache structures the JAX package keeps (the port keeps them too).

Leaves are flattened with dict keys in sorted order, as ``jax.tree_util``
does, so a sum over leaves runs in the JAX package's order."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_flatten", "tree_unflatten", "keyed_leaves"]


def _rebuild(cls, kids):
    if hasattr(cls, "_fields"):  # NamedTuple
        return cls(*kids)
    return cls(kids)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure (dicts, tuples,
    lists; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return _rebuild(type(tree), [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    return fn(tree, *rest)


def _flatten(t, leaves: List[Any]):
    if isinstance(t, dict):
        return (dict, tuple((k, _flatten(t[k], leaves)) for k in sorted(t)))
    if isinstance(t, (tuple, list)):
        return (type(t), tuple(_flatten(x, leaves) for x in t))
    leaves.append(t)
    return None


def _unflatten(sp, it):
    if sp is None:
        return next(it)
    kind, kids = sp
    if kind is dict:
        return {k: _unflatten(s, it) for k, s in kids}
    return _rebuild(kind, [_unflatten(s, it) for s in kids])


# Module-level recursion on purpose: a nested recursive closure would form
# a reference cycle holding the leaves (tensors) until the next gc pass.
def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure); :func:`tree_unflatten` inverts it."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(structure: Any, leaves) -> Any:
    return _unflatten(structure, iter(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def _keyed(t, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _keyed(t[k], f"{prefix}[{k!r}]", out)
    elif isinstance(t, tuple) and hasattr(t, "_fields"):  # NamedTuple
        for name, x in zip(t._fields, t):
            _keyed(x, f"{prefix}.{name}", out)
    elif isinstance(t, (tuple, list)):
        for i, x in enumerate(t):
            _keyed(x, f"{prefix}[{i}]", out)
    else:
        out.append((prefix, t))


def keyed_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in :func:`tree_leaves` order, each key formatted as
    ``jax.tree_util.keystr`` formats the leaf's path: ``['k']`` for a dict
    key, ``[i]`` for a sequence index, ``.name`` for a NamedTuple field (so
    ``AdamWState.m``'s leaves read ``.m[0]['blocks']...``).  The checkpoint
    store keys its arrays by it, as the JAX store does."""
    out: List[Tuple[str, Any]] = []
    _keyed(tree, "", out)
    return out
