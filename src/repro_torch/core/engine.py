"""Event-driven asynchrony simulator (counterpart of ``repro.core.engine``).

The event structure of an asynchronous system -- which worker's gradient
arrives at each master write event, and how stale it is -- comes from
per-worker service-time models.  Two interchangeable paths, as in the
reference:

* the reference path, ``simulate_parameter_server``: a Python ``heapq``
  discrete-event loop (the shared-memory twin comes with Async-BCD);
* the device path, ``trace_scan`` / ``generate_trace``: the same event
  structure computed from a pre-sampled service-time matrix, written as a
  loop over events batched over cells on the device.

Both agree bitwise with the reference's paths when driven by the same
service-time matrix: float32 completion times, ties broken by push order.
The numpy parts (worker models, substream sampling, the heapq loop) are
the reference's code.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..kernels.dispatch import resolve_device

__all__ = ["WorkerModel", "EventTrace", "EventHeap", "TraceArrays",
           "simulate_parameter_server",
           "sample_service_times", "trace_scan", "generate_trace",
           "strided_scan", "heterogeneous_workers"]


def strided_scan(make_step, carry, xs, record_every: int = 1):
    """A loop over events with decimated recording: keep every s-th output.

    ``xs`` is a tuple of tensors with a leading event axis K.
    ``make_step(emit)`` returns ``step(carry, x) -> (carry, out)``; with
    ``emit=False`` it returns ``(carry, None)`` and may skip output-only
    work.  Recorded rows are events ``s-1, 2s-1, ..., K-1``; each output
    leaf is stacked on a new leading axis of length ``K // s``.
    """
    every = int(record_every)
    if every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    K = int(xs[0].shape[0])
    if K % every:
        raise ValueError(
            f"record_every={every} must divide the trace length {K}")
    silent, loud = make_step(False), make_step(True)
    outs = []
    for k in range(K):
        event = tuple(x[k] for x in xs)
        if (k + 1) % every:
            carry, _ = silent(carry, event)
        else:
            carry, out = loud(carry, event)
            outs.append(out)
    if not outs:
        return carry, None
    return carry, tuple(torch.stack(col) for col in zip(*outs))


@dataclasses.dataclass(frozen=True)
class WorkerModel:
    """Lognormal service time with occasional straggler events."""

    mean: float = 1.0
    sigma: float = 0.25
    p_straggle: float = 0.0
    straggle_x: float = 10.0

    def sample(self, rng: np.random.Generator) -> float:
        mu = np.log(self.mean) - 0.5 * self.sigma**2
        t = float(rng.lognormal(mu, self.sigma))
        if self.p_straggle > 0 and rng.random() < self.p_straggle:
            t *= self.straggle_x
        return t

    def sample_n(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Vectorized draw of ``n`` task durations (own stream, task order)."""
        mu = np.log(self.mean) - 0.5 * self.sigma**2
        t = rng.lognormal(mu, self.sigma, size=n)
        if self.p_straggle > 0:
            t = np.where(rng.random(n) < self.p_straggle,
                         t * self.straggle_x, t)
        return t


def heterogeneous_workers(n: int, spread: float = 2.0, seed: int = 0,
                          p_straggle: float = 0.02, straggle_x: float = 8.0) -> list:
    """n workers with mean speeds log-spaced over [1, spread]."""
    rng = np.random.default_rng(seed)
    means = np.geomspace(1.0, spread, n)
    rng.shuffle(means)
    return [WorkerModel(mean=float(m), p_straggle=p_straggle, straggle_x=straggle_x)
            for m in means]


def sample_service_times(workers: Sequence[WorkerModel], n_tasks: int,
                         seed: int = 0) -> np.ndarray:
    """The service-time matrix ``T[i, j]`` (float32): worker ``i``'s
    ``j``-th task, drawn from substream ``default_rng([seed, i])``."""
    out = np.empty((len(workers), n_tasks), np.float32)
    for i, w in enumerate(workers):
        rng = np.random.default_rng([seed, i])
        out[i] = w.sample_n(rng, n_tasks).astype(np.float32)
    return out


class EventHeap:
    """Deterministic discrete-event queue of in-flight tasks (insertion
    order breaks ties in completion time)."""

    def __init__(self):
        self._heap: list = []
        self._tie = 0

    def push(self, t: float, *payload) -> None:
        heapq.heappush(self._heap, (t, self._tie) + payload)
        self._tie += 1

    def pop(self):
        """Return ``(t, *payload)`` of the earliest task."""
        item = heapq.heappop(self._heap)
        return (item[0],) + item[2:]

    def __len__(self) -> int:
        return len(self._heap)


class EventTrace(NamedTuple):
    """One master write event per row (host numpy arrays).

    worker:   (K,) int32 -- whose gradient is consumed at event k.
    read_at:  (K,) int32 -- iterate version that worker had read.
    tau:      (K,) int32 -- its staleness, k - read_at.
    tau_max:  (K,) int32 -- max staleness across the gradient table at k.
    t_wall:   (K,) float64 -- simulated wall-clock time of the event.
    """

    worker: np.ndarray
    read_at: np.ndarray
    tau: np.ndarray
    tau_max: np.ndarray
    t_wall: np.ndarray

    @property
    def n_events(self) -> int:
        return int(self.worker.shape[0])

    def max_delay(self) -> int:
        return int(self.tau_max.max(initial=0))


def _next_time(t: float, workers, i: int, rng, service_times, next_task):
    if service_times is None:
        return t + workers[i].sample(rng)
    j = next_task[i]
    next_task[i] += 1
    return np.float32(t) + service_times[i, j]


def simulate_parameter_server(
    n_workers: int,
    n_events: int,
    workers: Optional[Sequence[WorkerModel]] = None,
    seed: int = 0,
    service_times: Optional[np.ndarray] = None,
) -> EventTrace:
    """Algorithm 1's event structure with |R| = 1 (heapq reference)."""
    if workers is None:
        workers = heterogeneous_workers(n_workers, seed=seed)
    if len(workers) != n_workers:
        raise ValueError(f"{len(workers)} worker models for {n_workers} workers")
    rng = np.random.default_rng(seed + 1)
    next_task = np.zeros((n_workers,), np.int64)

    heap = EventHeap()  # payload: (worker, version_read)
    for i, w in enumerate(workers):
        heap.push(_next_time(0.0, workers, i, rng, service_times, next_task), i, 0)
    s = np.zeros((n_workers,), np.int64)

    worker = np.zeros((n_events,), np.int32)
    read_at = np.zeros((n_events,), np.int32)
    tau = np.zeros((n_events,), np.int32)
    tau_max = np.zeros((n_events,), np.int32)
    t_wall = np.zeros((n_events,), np.float64)

    for k in range(n_events):
        t, i, v = heap.pop()
        s[i] = v
        worker[k] = i
        read_at[k] = v
        tau[k] = k - v
        tau_max[k] = k - int(s.min())
        t_wall[k] = t
        heap.push(_next_time(t, workers, i, rng, service_times, next_task), i, k + 1)
    return EventTrace(worker, read_at, tau, tau_max, t_wall)


class TraceArrays(NamedTuple):
    """``EventTrace`` columns as device tensors with a leading cell axis:
    each (B, K); ``t_wall`` is float32."""

    worker: torch.Tensor
    read_at: torch.Tensor
    tau: torch.Tensor
    tau_max: torch.Tensor
    t_wall: torch.Tensor


_I32_MAX = torch.iinfo(torch.int32).max


def trace_scan(service_times: torch.Tensor,
               active: Optional[torch.Tensor] = None) -> TraceArrays:
    """The event race for B cells at once, on the tensors' device.

    ``service_times`` is (B, n, K+1) float32 (or (n, K+1) for one cell,
    which returns (K,) columns).  Per event, each cell's in-flight task with
    the smallest (completion time, push seq) key completes -- the pop order
    of the ``EventHeap`` reference (initial tasks carry seq 0..n-1; the task
    pushed at event k carries n + k).  ``active`` (B, n) bool masks padded
    workers of ragged buckets out of the race and out of ``tau_max``'s
    minimum.
    """
    T = service_times
    single = T.ndim == 2
    if single:
        T = T.unsqueeze(0)
        active = None if active is None else active.unsqueeze(0)
    T = T.to(torch.float32)
    B, n, n_tasks = T.shape
    K = n_tasks - 1
    dev = T.device
    i32 = torch.int32
    cells = torch.arange(B, device=dev)
    t = T[:, :, 0].clone()                               # completion times
    seq = torch.arange(n, dtype=i32, device=dev).repeat(B, 1)
    task = torch.ones((B, n), dtype=torch.int64, device=dev)
    ver = torch.zeros((B, n), dtype=i32, device=dev)     # version each task read
    s = torch.zeros((B, n), dtype=i32, device=dev)       # version of table entry
    inf = torch.full((), float("inf"), device=dev)
    big = torch.full((), _I32_MAX, dtype=i32, device=dev)
    worker = torch.empty((K, B), dtype=i32, device=dev)
    read_at = torch.empty((K, B), dtype=i32, device=dev)
    tau_max = torch.empty((K, B), dtype=i32, device=dev)
    t_wall = torch.empty((K, B), dtype=torch.float32, device=dev)
    for k in range(K):
        t_race = t if active is None else torch.where(active, t, inf)
        at_min = t_race == t_race.min(dim=1, keepdim=True).values
        i = torch.argmin(torch.where(at_min, seq, big), dim=1)
        v = ver[cells, i]
        s[cells, i] = v
        s_race = s if active is None else torch.where(active, s, big)
        worker[k] = i.to(i32)
        read_at[k] = v
        tau_max[k] = k - s_race.min(dim=1).values
        t_wall[k] = t[cells, i]
        # worker i starts its next task at the write it just triggered
        t[cells, i] += T[cells, i, task[cells, i]]
        task[cells, i] += 1
        ver[cells, i] = k + 1
        seq[cells, i] = n + k
    k_col = torch.arange(K, dtype=i32, device=dev).unsqueeze(1)
    cols = (worker, read_at, k_col - read_at, tau_max, t_wall)
    cols = tuple(c.T.contiguous() for c in cols)
    if single:
        cols = tuple(c[0] for c in cols)
    return TraceArrays(*cols)


def generate_trace(service_times: np.ndarray,
                   kind: str = "parameter_server", device=None) -> EventTrace:
    """Host-side wrapper: ``trace_scan`` on the device, returned as an
    ``EventTrace`` (bitwise the heapq reference's trace for the same
    matrix).  ``kind='shared_memory'`` sets ``tau_max = tau``."""
    if kind not in ("parameter_server", "shared_memory"):
        raise ValueError(f"unknown trace kind {kind!r}")
    T = torch.from_numpy(np.asarray(service_times, np.float32)).to(
        resolve_device(device))
    out = [c.cpu().numpy() for c in trace_scan(T)]
    worker, read_at, tau, tau_max, t_wall = out
    if kind != "parameter_server":
        tau_max = tau.copy()
    return EventTrace(worker, read_at, tau, tau_max, t_wall.astype(np.float64))
