"""Bounded cache of built sweep programs (counterpart of
``repro.sweep.cache``).

``cached_program(key, build)`` keeps the built bucket callable of a sweep
under its static configuration -- ``(solver tag, bucket width, masked?,
horizon, record_every, telemetry, engine, faults, ..., captured
objects)``; a ``faults.FaultSpec`` is hashable by value -- in an LRU, so
repeated runs of a spec reuse it.  Captured objects (loss
closures, data tensors, prox ops) are keyed by IDENTITY through ``IdKey``,
which holds a strong reference, so an id cannot be recycled while its
entry lives.  Captured tensors are therefore FROZEN by contract: after
mutating one in place, call ``clear_program_cache()``.

Misses are instrumented for the run ledger: the build's wall time is a
``program_build`` timing event, and the program's first call a
``program_first_call`` event, so a run's ``compile_ms`` includes the
first dispatch and any first-use kernel build in it.

Not ported yet (ROADMAP queue A item 6): the ``REPRO_CACHE_CHECK``
fingerprints of captured arrays, and CUDA graphs as cached programs.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

from ..telemetry.timing import record_timing

__all__ = ["IdKey", "LRU", "tree_key", "cached_program",
           "clear_program_cache", "program_cache_stats",
           "PROGRAM_CACHE_MAXSIZE"]

PROGRAM_CACHE_MAXSIZE = 128


class IdKey:
    """Identity-keyed cache handle: hashes and compares by ``id(obj)``
    while holding a strong reference to ``obj``."""

    __slots__ = ("obj",)

    def __init__(self, obj: Any):
        self.obj = obj

    def __hash__(self) -> int:
        return id(self.obj)

    def __eq__(self, other) -> bool:
        return isinstance(other, IdKey) and self.obj is other.obj

    def __repr__(self) -> str:
        return f"IdKey({type(self.obj).__name__}@{id(self.obj):#x})"


def tree_key(tree: Any) -> Tuple:
    """Identity key of a tensor or a (nested) tuple/list of tensors: one
    ``IdKey`` per leaf."""
    if isinstance(tree, (tuple, list)):
        return tuple(k for leaf in tree for k in tree_key(leaf))
    return (IdKey(tree),)


class LRU:
    """Tiny LRU keyed on hashable tuples, with hit/miss/evict counters;
    ``api.run`` also memoizes its resolve-time pieces in one."""

    def __init__(self, maxsize: int,
                 on_evict: Optional[Callable[[Any], None]] = None):
        self.maxsize = maxsize
        self.data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.on_evict = on_evict

    def get(self, key, build: Callable[[], Any]):
        try:
            val = self.data[key]
        except KeyError:
            self.misses += 1
            val = build()
            self.data[key] = val
            while len(self.data) > self.maxsize:
                evicted, _ = self.data.popitem(last=False)
                self.evictions += 1
                if self.on_evict is not None:
                    self.on_evict(evicted)
            return val
        self.hits += 1
        self.data.move_to_end(key)
        return val


_PROGRAMS = LRU(PROGRAM_CACHE_MAXSIZE)

# bumped by clear_program_cache(); api.run compares generations to see
# that the absolute counters restarted between its two snapshots
_GENERATION = 0


class _TimedFirstCall:
    """A freshly built program whose first call is recorded as a
    ``program_first_call`` timing event; later calls go straight through."""

    __slots__ = ("fn", "tag", "pending")

    def __init__(self, fn: Callable, tag: str):
        self.fn = fn
        self.tag = tag
        self.pending = True

    def __call__(self, *args, **kwargs):
        if not self.pending:
            return self.fn(*args, **kwargs)
        self.pending = False
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        record_timing("program_first_call",
                      (time.perf_counter() - t0) * 1e3, key=self.tag)
        return out


def cached_program(key: Tuple, build: Callable[[], Any]):
    """The cached program for ``key``, built (and cached) on first use.
    ``key`` is a tuple of hashables; wrap captured objects in ``IdKey`` /
    ``tree_key``."""

    def timed_build():
        tag = str(key[0]) if key else "?"
        t0 = time.perf_counter()
        val = build()
        record_timing("program_build", (time.perf_counter() - t0) * 1e3,
                      key=tag)
        return _TimedFirstCall(val, tag) if callable(val) else val

    return _PROGRAMS.get(key, timed_build)


def clear_program_cache() -> None:
    """Drop every cached program (tests; memory pressure) and bump the
    stats generation."""
    global _GENERATION
    _PROGRAMS.data.clear()
    _PROGRAMS.hits = _PROGRAMS.misses = _PROGRAMS.evictions = 0
    _GENERATION += 1


def program_cache_stats() -> dict:
    return {"size": len(_PROGRAMS.data), "hits": _PROGRAMS.hits,
            "misses": _PROGRAMS.misses, "evictions": _PROGRAMS.evictions,
            "maxsize": _PROGRAMS.maxsize, "generation": _GENERATION}
