"""Minimal pytree helper over the nested dict/tuple/list parameter and
cache structures the JAX package keeps (the port keeps them too)."""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of one structure (dicts, tuples,
    lists; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)
