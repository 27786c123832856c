"""Nested-container helpers for handler state trees.

A state tree is a tensor, or a dict / list / tuple (NamedTuples
included) of state trees — the port's counterpart of a JAX pytree.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every leaf, keeping the container structure;
    with ``rest``, ``fn`` takes the matching leaves of every tree (each
    of the same structure as ``tree``)."""
    if isinstance(tree, dict):
        return type(tree)(
            (k, tree_map(fn, v, *(r[k] for r in rest)))
            for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)
