"""Pytrees of tensors in JAX's order (the port's stand-in for
``jax.tree_util``).

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
any other objects) at the leaves; ``None`` and empty containers are
nodes without leaves.  Leaves come out in ``jax.tree_util``'s order:
dict keys sorted, sequence and NamedTuple fields in order.  The order
matters where the reference numbers leaves (``launch.train_bcd``'s block
partition) and where a checkpoint names them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map"]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; ``tree_unflatten(spec, leaves)`` rebuilds it."""
    leaves: List[Any] = []

    def rec(t):
        if t is None:
            return ("none",)
        if _is_namedtuple(t):
            return ("namedtuple", type(t), [rec(v) for v in t])
        if isinstance(t, (list, tuple)):
            return ("seq", type(t), [rec(v) for v in t])
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [rec(t[k]) for k in keys])
        leaves.append(t)
        return ("leaf",)

    return leaves, rec(tree)


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def rec(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "namedtuple":
            return s[1](*(rec(c) for c in s[2]))
        if kind == "seq":
            return s[1](rec(c) for c in s[2])
        return {k: rec(c) for k, c in zip(s[1], s[2])}

    out = rec(spec)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has places for")
    return out


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, spec = tree_flatten(tree)
    others = []
    for r in rest:
        lr, sr = tree_flatten(r)
        if sr != spec:
            raise ValueError("tree_map over trees of different structure")
        others.append(lr)
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
