"""Delay models, traces and the write-event delay tracker (paper §2);
counterpart of ``repro.core.delay``, numpy, bitwise the reference's.

Delays in asynchronous optimization are measured in *write events* -- the
number of master updates between the iterate snapshot a gradient was computed
on and the update that consumes it (paper §2, [Leblond et al. '18]).  This
module provides

* the three delay models used in the paper's Figure 1 (constant / uniform
  random / burst), plus a Markov-modulated model and a heterogeneous-worker
  service-time model for richer experiments;
* ``DelayTracker`` -- the timestamping bookkeeping from Algorithms 1-2: the
  master stamps the outgoing iterate with its version ``k``; returning
  gradients carry the stamp; delay = current ``k`` minus stamp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = [
    "constant_delays",
    "random_delays",
    "burst_delays",
    "markov_delays",
    "DelayTracker",
    "DELAY_MODELS",
    "make_delays",
]


def constant_delays(n_steps: int, tau: int, seed: int = 0) -> np.ndarray:
    """Model 1 (Fig. 1): tau_k = tau, except the ramp-in (tau_k <= k)."""
    t = np.full((n_steps,), tau, dtype=np.int32)
    ramp = np.minimum(np.arange(n_steps), tau)
    return np.minimum(t, ramp).astype(np.int32)


def random_delays(n_steps: int, tau: int, seed: int = 0) -> np.ndarray:
    """Model 2 (Fig. 1): tau_k ~ Uniform{0..tau}."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, tau + 1, size=n_steps).astype(np.int32)
    return np.minimum(t, np.arange(n_steps)).astype(np.int32)


def burst_delays(n_steps: int, tau: int, period: int = 100, seed: int = 0) -> np.ndarray:
    """Model 3 (Fig. 1): tau_k = tau once per epoch (period), else 0."""
    t = np.zeros((n_steps,), dtype=np.int32)
    t[period::period] = tau
    return np.minimum(t, np.arange(n_steps)).astype(np.int32)


def markov_delays(n_steps: int, tau: int, p_slow: float = 0.05,
                  p_recover: float = 0.3, seed: int = 0) -> np.ndarray:
    """Two-state Markov-modulated delays: a 'congested' state emits delays
    near tau, the 'fast' state emits near-zero delays.  Models stragglers with
    temporal correlation (beyond the paper's three models)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_steps,), dtype=np.int32)
    slow = False
    for k in range(n_steps):
        if slow:
            out[k] = rng.integers(max(tau // 2, 1), tau + 1)
            slow = rng.random() >= p_recover
        else:
            out[k] = rng.integers(0, max(tau // 8, 1) + 1)
            slow = rng.random() < p_slow
    return np.minimum(out, np.arange(n_steps)).astype(np.int32)


DELAY_MODELS = {
    "constant": constant_delays,
    "random": random_delays,
    "burst": burst_delays,
    "markov": markov_delays,
}


def make_delays(model: str, n_steps: int, tau: int, seed: int = 0, **kw) -> np.ndarray:
    return DELAY_MODELS[model](n_steps, tau, seed=seed, **kw)


@dataclasses.dataclass
class DelayTracker:
    """Write-event timestamping (Algorithm 1 lines 12/15; Algorithm 2 lines 5/10).

    The master (or shared memory) holds a monotone iterate-version counter
    ``k``.  ``stamp()`` records the version a worker read; ``delay()`` returns
    the current staleness of that worker's data.  Thread-safety is the
    caller's concern (core.runtime wraps access in the master loop / the
    shared-memory critical section, exactly as the paper's algorithms do).
    """

    k: int = 0
    stamps: Dict[int, int] = dataclasses.field(default_factory=dict)
    max_seen: int = 0

    def stamp(self, worker: int, version: Optional[int] = None) -> int:
        v = self.k if version is None else version
        self.stamps[worker] = v
        return v

    def delay(self, worker: int) -> int:
        """Current staleness of ``worker``'s data.

        Raises ``KeyError`` for a worker that was never stamped: silently
        assuming stamp 0 would report staleness ``k`` -- an arbitrarily large
        delay that crushes any delay-adaptive step-size to zero and is
        indistinguishable from a real straggler.  Callers must ``stamp()``
        each worker when handing it the initial iterate (Algorithm 1 line 3).
        """
        if worker not in self.stamps:
            raise KeyError(
                f"worker {worker} has no stamp; call stamp({worker}, version) "
                "when it first reads the iterate (Algorithm 1 line 3)")
        tau = self.k - self.stamps[worker]
        self.max_seen = max(self.max_seen, tau)
        return tau

    def delays(self) -> Dict[int, int]:
        return {w: self.k - s for w, s in self.stamps.items()}

    def max_delay(self) -> int:
        return max(self.delays().values(), default=0)

    def advance(self) -> int:
        self.k += 1
        return self.k
