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

Meshes ride keys as ``repro_torch.mesh.mesh_topology`` tuples --
topology, not identity -- so a rebuilt mesh of the same axes, shape,
device kind and process count reuses a program while a reshape from 1-D
to 2-D keys fresh; the sharded runners add the devices of each row's
program to its key.

Misses are instrumented for the run ledger: the build's wall time is a
``program_build`` timing event, and the program's first call a
``program_first_call`` event, so a run's ``compile_ms`` includes the
first dispatch and any first-use kernel build in it.

``REPRO_CACHE_CHECK=1`` turns the frozen-capture contract into a check:
the captured arrays of a key (numpy arrays and tensors; a tensor on the
card is copied to the host for it) are fingerprinted (shape, dtype and a
hash of the contents, strided past 65 536 elements) when the program is
stored and checked on every hit, so an in-place mutation raises instead
of serving the stale program.  Off (the default) it costs nothing.
"""
from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from ..telemetry.timing import record_timing

__all__ = ["IdKey", "LRU", "tree_key", "cached_program",
           "clear_program_cache", "mesh_fingerprint", "program_cache_stats",
           "set_capture_hook", "PROGRAM_CACHE_MAXSIZE"]

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


_PROGRAMS = LRU(PROGRAM_CACHE_MAXSIZE,
                on_evict=lambda key: _FINGERPRINTS.pop(key, None))

# bumped by clear_program_cache(); api.run compares generations to see
# that the absolute counters restarted between its two snapshots
_GENERATION = 0

# REPRO_CACHE_CHECK fingerprints, keyed like _PROGRAMS (pruned on eviction)
_FINGERPRINTS: dict = {}

# staticcheck's dispatch interceptor; None in normal operation
_CAPTURE_HOOK: Optional[Callable[[Tuple, Callable[[], Any]], Any]] = None


def set_capture_hook(hook):
    """Install ``hook(key, build)`` to intercept every ``cached_program``
    dispatch (pass ``None`` to uninstall); returns the previous hook.
    While installed, the cache is bypassed entirely: the hook's return
    value is handed back to the runner in place of the cached program.
    This is the seam ``repro_torch.staticcheck.cachekey`` uses to observe
    cache keys and record op traces."""
    global _CAPTURE_HOOK
    prev = _CAPTURE_HOOK
    _CAPTURE_HOOK = hook
    return prev


def _cache_check_enabled() -> bool:
    return (os.environ.get("REPRO_CACHE_CHECK", "").strip().lower()
            in ("1", "true", "yes", "on"))


def _captured_arrays(key: Any, path: str = "key"):
    """``(path, IdKey)`` of every identity-keyed array (numpy array or
    tensor) inside a (nested) key tuple; other captures (closures, prox
    ops) have no numeric payload to hash."""
    if isinstance(key, tuple):
        for i, el in enumerate(key):
            yield from _captured_arrays(el, f"{path}[{i}]")
    elif isinstance(key, IdKey) and isinstance(key.obj,
                                               (np.ndarray, torch.Tensor)):
        yield path, key


def _captured_meshes(key: Any, path: str = "key"):
    """``(path, Mesh)`` of every ``repro_torch.mesh.Mesh`` inside a key,
    raw or ``IdKey``-wrapped; fingerprinted by topology."""
    from ..mesh import Mesh
    if isinstance(key, tuple):
        for i, el in enumerate(key):
            yield from _captured_meshes(el, f"{path}[{i}]")
    elif isinstance(key, Mesh):
        yield path, key
    elif isinstance(key, IdKey) and isinstance(key.obj, Mesh):
        yield path, key.obj


def mesh_fingerprint(mesh) -> str:
    """Topology fingerprint of a mesh: stringified
    ``repro_torch.mesh.mesh_topology``."""
    from ..mesh import mesh_topology
    return str(mesh_topology(mesh))


def _array_fingerprint(obj: Any) -> str:
    h = hashlib.sha1()
    h.update(str(tuple(obj.shape)).encode())
    h.update(str(obj.dtype).encode())
    if isinstance(obj, torch.Tensor):
        flat = obj.detach().reshape(-1)
        if flat.numel() > 65536:  # a strided sample of big buffers
            flat = flat[:: flat.numel() // 65536 + 1]
        flat = flat.contiguous().cpu()
        if flat.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        h.update(flat.numpy().tobytes())
        return h.hexdigest()
    flat = np.ascontiguousarray(obj).reshape(-1)
    if flat.size > 65536:
        flat = np.ascontiguousarray(flat[:: flat.size // 65536 + 1])
    h.update(flat.tobytes())
    return h.hexdigest()


def _key_fingerprints(key: Tuple) -> Tuple:
    return (tuple((path, _array_fingerprint(ik.obj))
                  for path, ik in _captured_arrays(key)) +
            tuple((path, mesh_fingerprint(m))
                  for path, m in _captured_meshes(key)))


def _verify_fingerprints(key: Tuple) -> None:
    fresh = _key_fingerprints(key)
    prior = _FINGERPRINTS.get(key)
    if prior is None:
        _FINGERPRINTS[key] = fresh
        return
    if prior == fresh:
        return
    changed = [p for (p, a), (_, b) in zip(prior, fresh) if a != b]
    raise RuntimeError(
        "REPRO_CACHE_CHECK: captured array(s) mutated in place after "
        f"capture by cached_program (key tag {key[0]!r}, changed: "
        f"{', '.join(changed)}).  Identity-keyed captures are FROZEN by "
        "contract -- the cache would have kept serving the program built "
        "on the old contents.  Build new tensors instead of mutating, or "
        "call clear_program_cache() after an intentional mutation.")


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
    ``tree_key``.  Under ``REPRO_CACHE_CHECK=1`` the key's captured
    arrays are fingerprinted on the first call and checked on every
    later one.  A hook installed by ``set_capture_hook`` takes the
    dispatch instead."""
    if _CAPTURE_HOOK is not None:
        return _CAPTURE_HOOK(key, build)
    if _cache_check_enabled():
        _verify_fingerprints(key)

    def timed_build():
        tag = str(key[0]) if key else "?"
        t0 = time.perf_counter()
        val = build()
        record_timing("program_build", (time.perf_counter() - t0) * 1e3,
                      key=tag)
        return _TimedFirstCall(val, tag) if callable(val) else val

    return _PROGRAMS.get(key, timed_build)


def clear_program_cache() -> None:
    """Drop every cached program and its fingerprints (tests; memory
    pressure; after an intentional mutation of a capture) and bump the
    stats generation."""
    global _GENERATION
    _PROGRAMS.data.clear()
    _PROGRAMS.hits = _PROGRAMS.misses = _PROGRAMS.evictions = 0
    _FINGERPRINTS.clear()
    _GENERATION += 1


def program_cache_stats() -> dict:
    return {"size": len(_PROGRAMS.data), "hits": _PROGRAMS.hits,
            "misses": _PROGRAMS.misses, "evictions": _PROGRAMS.evictions,
            "maxsize": _PROGRAMS.maxsize, "generation": _GENERATION}
