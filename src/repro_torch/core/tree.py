"""Nested-container helpers for handler state trees.

A state tree is a tensor, or a dict / list / tuple (NamedTuples
included) of state trees — the port's counterpart of a JAX pytree.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


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


def key_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in JAX's flatten order and spelling:
    dict keys sorted (``['stages'][0]['l0']['mixer']['wq']``),
    NamedTuple fields by name (``.f_times``), sequence items by index;
    ``None`` and empty containers hold no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_leaves(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from key_leaves(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from key_leaves(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [leaf for _, leaf in key_leaves(tree)]


def tree_unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in JAX's flatten
    order, by the items of the iterable ``leaves``."""
    return _unflatten(tree, iter(leaves))


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _unflatten(tree[k], leaves)
        return type(tree)((k, out[k]) for k in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    if tree is None:
        return None
    return next(leaves)
