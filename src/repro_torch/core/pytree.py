"""Pytrees of tensors in JAX's order (the port's stand-in for
``jax.tree_util``).

A tree is nested dicts, lists, tuples and NamedTuples with tensors (or
any other objects) at the leaves; ``None`` and empty containers are
nodes without leaves.  Leaves come out in ``jax.tree_util``'s order:
dict keys sorted, sequence and NamedTuple fields in order.  The order
matters where the reference numbers leaves (``launch.train_bcd``'s block
partition) and where a checkpoint names them.  ``tree_flatten_with_path``
gives each leaf its path as ``jax.tree_util`` does: a ``DictKey`` for a
dict key, a ``GetAttrKey`` for a NamedTuple field, a ``SequenceKey`` for
a list or tuple index (the sharding planner reads names from them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "DictKey", "GetAttrKey", "SequenceKey", "tree_flatten_with_path",
           "tree_map_with_path"]


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


# The recursions below are module functions that take their accumulator:
# a nested function that calls itself is a reference cycle, which would
# keep every leaf it saw (a whole parameter tree) alive until the cycle
# collector runs.

def _flatten(t, leaves: List[Any]):
    if t is None:
        return ("none",)
    if _is_namedtuple(t):
        return ("namedtuple", type(t), [_flatten(v, leaves) for v in t])
    if isinstance(t, (list, tuple)):
        return ("seq", type(t), [_flatten(v, leaves) for v in t])
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_flatten(t[k], leaves) for k in keys])
    leaves.append(t)
    return ("leaf",)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; ``tree_unflatten(spec, leaves)`` rebuilds it."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _unflatten(s, it):
    kind = s[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    if kind == "namedtuple":
        return s[1](*(_unflatten(c, it) for c in s[2]))
    if kind == "seq":
        return s[1](_unflatten(c, it) for c in s[2])
    return {k: _unflatten(c, it) for k, c in zip(s[1], s[2])}


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)
    out = _unflatten(spec, it)
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


def _paths(s, path: tuple, out: List[tuple]) -> None:
    kind = s[0]
    if kind == "leaf":
        out.append(path)
    elif kind == "namedtuple":
        for name, c in zip(s[1]._fields, s[2]):
            _paths(c, path + (GetAttrKey(name),), out)
    elif kind == "seq":
        for i, c in enumerate(s[2]):
            _paths(c, path + (SequenceKey(i),), out)
    elif kind == "dict":
        for k, c in zip(s[1], s[2]):
            _paths(c, path + (DictKey(k),), out)


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``([(path, leaf), ...], spec)`` in ``tree_flatten``'s order; a path
    is a tuple of ``DictKey`` / ``GetAttrKey`` / ``SequenceKey``."""
    leaves, spec = tree_flatten(tree)
    paths: List[tuple] = []
    _paths(spec, (), paths)
    return list(zip(paths, leaves)), spec


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    flat, spec = tree_flatten_with_path(tree)
    return tree_unflatten(spec, [fn(path, leaf) for path, leaf in flat])
