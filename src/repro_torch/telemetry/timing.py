"""Host-side timing sink (counterpart of ``repro.telemetry.timing``).

An append-only event buffer the instrumented paths write into:
``sweep.cache`` records program build and first-call times, and
``sweep.runners.run_bucketed`` records each bucket's dispatch time.
``api.run`` drains the buffer around its dispatch and folds the events
into the run's ``RunRecord`` (``.ledger``), which splits the run's time
into compile-side and warm milliseconds.

Stdlib only and a leaf module: an event is one small dict appended to a
list under a lock, so every layer can use it without import cycles.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

__all__ = ["record_timing", "drain_timings", "peek_timings", "timed"]

_LOCK = threading.Lock()
_EVENTS: List[Dict[str, Any]] = []

# the events api.run counts as compile-side: a program's construction and
# the first dispatch of a freshly built one (which includes, on the card,
# the first-use build and load of its kernels)
COMPILE_EVENT_NAMES = ("program_build", "program_first_call")


def record_timing(name: str, ms: float, **meta: Any) -> None:
    """Append one timing event: ``{"name", "ms", **meta}``."""
    ev = {"name": str(name), "ms": float(ms)}
    ev.update(meta)
    with _LOCK:
        _EVENTS.append(ev)


def drain_timings() -> List[Dict[str, Any]]:
    """Return all buffered events and clear the buffer."""
    with _LOCK:
        out, _EVENTS[:] = list(_EVENTS), []
    return out


def peek_timings() -> List[Dict[str, Any]]:
    """A copy of the buffered events without clearing them."""
    with _LOCK:
        return list(_EVENTS)


class timed:
    """``with timed("name", key=...):`` records the block's wall-clock ms."""

    def __init__(self, name: str, **meta: Any):
        self.name, self.meta = name, meta

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record_timing(self.name, (time.perf_counter() - self._t0) * 1e3,
                      **self.meta)
        return False
