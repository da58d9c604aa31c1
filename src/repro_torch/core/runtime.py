"""Genuinely-asynchronous runtimes (threads), mirroring the paper's §4 setup
(counterpart of ``repro.core.runtime``).

Two runtimes:

* ``PIAGServer``       -- Algorithm 1 verbatim: a master thread owns the
  iterate and the gradient table; n worker threads receive (x_k, k) over
  per-worker queues, compute their shard gradient, and send (grad, k)
  back.  The master processes one return at a time (|R| = 1, as in §4.1),
  tracks write-event delays with ``DelayTracker``, picks the
  delay-adaptive step-size, and applies the prox update.
* ``SharedMemoryBCD``  -- Algorithm 2: workers share one iterate tensor.
  Reads are deliberately NOT locked (inconsistent reads, Eq. 6); steps 5-9
  (delay, step-size, block prox update, write, counter bump) run inside
  one lock, exactly the critical section the paper assumes.

Determinism is not guaranteed (that is the point); the event-driven
engine (core.engine) is the deterministic twin.

On the CUDA card the iterate, the data and the gradients live on the
card, and the worker threads only launch and synchronize:

* each worker runs its gradient on its own ``torch.cuda.Stream`` and
  synchronizes that stream before it hands the gradient on (the
  reference's ``block_until_ready``);
* an iterate the master made on its stream is read on a worker's stream
  only after the master's event for it (``wait_event``), and is marked
  used there (``record_stream``); a gradient made on a worker's stream is
  marked used on the master's stream when the master takes it, so the
  caching allocator never hands its memory out again under a running
  kernel;
* in ``SharedMemoryBCD`` the block write is synchronized inside the lock,
  before the write counter moves: a reader that stamps version k+1 then
  finds that write in the iterate, so the measured delays are the true
  ones.  The unlocked ``clone()`` read may race a block write, which is
  Eq. (6)'s inconsistent read;
* the step-size state is a handful of scalars and stays on the host (CPU
  tensors), as in the reference's master; it decides gamma without a
  device round trip.

``RunLog.in_flight_max`` counts the most worker gradients that were
between their launch and their synchronization at once: above 1 the
workers' gradients really overlapped.

Resilience contract (the chaos-tested layer), as the reference's:

* the PIAG master never blocks forever on ``out_q.get``: it polls with a
  short timeout, re-raises a crashed worker's exception (chained) within
  ``heartbeat`` seconds, and raises ``RuntimeError`` when every worker is
  dead or ``TimeoutError`` when live workers produce nothing for a full
  heartbeat;
* worker crashes are counted (``RunLog.crashes``) and -- with
  ``respawn=True`` -- the master respawns the worker, RE-STAMPS its
  ``DelayTracker`` entry at the current write count (a rejoining worker
  must not carry its pre-crash staleness), re-sends the current iterate,
  and counts the respawn (``RunLog.respawns``);
* queues are bounded (no unbounded buildup when one side stalls) and
  shutdown drains ``out_q`` so no worker is left blocked on a full queue;
* ``join(timeout)`` failures are not silent: each leaked thread emits a
  warning and bumps ``RunLog.join_failures``;
* ``SharedMemoryBCD`` propagates worker exceptions to the master (which
  otherwise spins forever on the write counter) and applies the same
  join accounting.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from ..kernels.dispatch import resolve_device
from .delay import DelayTracker
from .prox import ProxOp
from .stepsize import StepsizePolicy

__all__ = ["PIAGServer", "SharedMemoryBCD", "RunLog", "WorkerCrash"]


class WorkerCrash(RuntimeError):
    """A worker thread died and the runtime surfaced it (original exception
    chained as ``__cause__``)."""


@dataclasses.dataclass
class RunLog:
    objective: List[float] = dataclasses.field(default_factory=list)
    gammas: List[float] = dataclasses.field(default_factory=list)
    taus: List[int] = dataclasses.field(default_factory=list)
    taus_per_worker: List[np.ndarray] = dataclasses.field(default_factory=list)
    wall: List[float] = dataclasses.field(default_factory=list)
    # resilience accounting (see module docstring)
    crashes: int = 0          # worker threads that died mid-run
    respawns: int = 0         # crashed workers revived (respawn=True)
    join_failures: int = 0    # threads still alive after join(timeout)
    # the most worker gradients in flight at once (port only)
    in_flight_max: int = 0

    def as_arrays(self):
        return (np.array(self.objective), np.array(self.gammas),
                np.array(self.taus), np.array(self.wall))


class _InFlight:
    """Counts the worker gradients between launch and synchronization."""

    def __init__(self):
        self._lock = threading.Lock()
        self.now = 0
        self.most = 0

    def __enter__(self):
        with self._lock:
            self.now += 1
            self.most = max(self.most, self.now)

    def __exit__(self, *exc):
        with self._lock:
            self.now -= 1


def _worker_stream(dev: torch.device):
    """A new stream for a worker thread on the card (None on the CPU)."""
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def _on(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _sync(stream) -> None:
    if stream is not None:
        stream.synchronize()


def _gamma_tensor(gamma_f: float, dev: torch.device) -> torch.Tensor:
    """gamma as a 0-d float32 tensor on ``dev``, filled on the device (a
    tensor copied from a host number would wait for the stream)."""
    return torch.full((), gamma_f, dtype=torch.float32, device=dev)


def _worker_grad_fn(problem) -> Callable:
    """``grad(x, *shard)`` of one worker: the problem's closed form where
    it has one, else autograd of ``worker_loss``."""
    fn = getattr(problem, "worker_grad", None)
    if fn is not None:
        return fn
    from torch.func import grad
    return grad(problem.worker_loss)


class PIAGServer:
    """Threaded parameter server running PIAG with delay-adaptive step-sizes.

    ``device`` (the CUDA card unless ``"cpu"``) holds the iterate, the
    worker shards and the gradients; the problem's data move there."""

    def __init__(self, problem, policy: StepsizePolicy, prox: ProxOp,
                 n_workers: Optional[int] = None, record_every: int = 1,
                 worker_sleep: Optional[Callable[[int], float]] = None,
                 heartbeat: float = 5.0, respawn: bool = False,
                 max_respawns: int = 2, device=None):
        self.problem = problem
        self.policy = policy
        self.prox = prox
        self.device = resolve_device(device)
        self.n = n_workers or problem.n_workers
        self.record_every = record_every
        self.worker_sleep = worker_sleep  # optional artificial heterogeneity
        # resilience knobs: heartbeat bounds how long the master waits for
        # ANY worker result before declaring the run wedged; respawn revives
        # crashed workers (up to max_respawns each) instead of aborting
        self.heartbeat = float(heartbeat)
        self.respawn = bool(respawn)
        self.max_respawns = int(max_respawns)
        Aw, bw = problem.worker_slices()
        self._Aw = [Aw[i].to(self.device) for i in range(self.n)]
        self._bw = [bw[i].to(self.device) for i in range(self.n)]
        self._grad_i = _worker_grad_fn(problem)
        self._P = problem.P
        # step-size state lives on the host: tiny scalars, master-only
        self._ss = policy.init(device="cpu")

    def run(self, n_events: int, x0: Optional[np.ndarray] = None) -> RunLog:
        dev = self.device
        d = self.problem.dim
        x = (torch.zeros((d,), dtype=torch.float32, device=dev) if x0 is None
             else torch.as_tensor(np.asarray(x0, np.float32)).to(dev))
        n_t = torch.full((), float(self.n), dtype=torch.float32, device=dev)
        master = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        # bounded queues: a master-sent iterate per worker plus slack on the
        # return path -- a stalled peer can never grow a queue without bound
        in_q = [queue.Queue(maxsize=2) for _ in range(self.n)]
        out_q = queue.Queue(maxsize=2 * self.n + 1)
        stop = threading.Event()
        tracker = DelayTracker()
        errors: dict = {}        # worker index -> boxed exception
        flight = _InFlight()
        log = RunLog()

        def ready_event():
            """The master's event after its last write of the iterate."""
            if master is None:
                return None
            ev = torch.cuda.Event()
            ev.record(master)
            return ev

        def worker(i: int):
            try:
                stream = _worker_stream(dev)
                with _on(stream):
                    while not stop.is_set():
                        try:
                            xk, k, ready = in_q[i].get(timeout=0.1)
                        except queue.Empty:
                            continue
                        if self.worker_sleep is not None:
                            time.sleep(self.worker_sleep(i))
                        with flight:
                            if stream is not None:
                                stream.wait_event(ready)
                                xk.record_stream(stream)
                            g = self._grad_i(xk, self._Aw[i], self._bw[i])
                            _sync(stream)  # compute outside the master loop
                        out_q.put((i, g, k))
            except BaseException as exc:    # box it; master re-raises
                errors[i] = exc
                try:
                    out_q.put_nowait(("__crash__", i, exc))  # wake the master
                except queue.Full:
                    pass

        def spawn(i: int) -> threading.Thread:
            t = threading.Thread(target=worker, args=(i,), daemon=True)
            t.start()
            return t

        threads = [spawn(i) for i in range(self.n)]

        def get_result(k: int):
            """out_q.get with a heartbeat: surfaces crashed workers instead
            of blocking forever."""
            waited = 0.0
            poll = min(0.25, self.heartbeat)
            while True:
                try:
                    msg = out_q.get(timeout=poll)
                except queue.Empty:
                    waited += poll
                    live = [t.is_alive() for t in threads]
                    if errors and not self.respawn:
                        i = next(iter(errors))
                        raise WorkerCrash(
                            f"worker {i} died at write event {k}"
                        ) from errors[i]
                    if not any(live):
                        raise WorkerCrash(
                            f"all {self.n} workers dead at write event {k}")
                    if waited >= self.heartbeat:
                        raise TimeoutError(
                            f"no worker result within heartbeat="
                            f"{self.heartbeat}s at write event {k} "
                            f"({sum(live)}/{self.n} workers alive)")
                    continue
                if msg[0] == "__crash__":
                    _, i, exc = msg
                    log.crashes += 1
                    if self.respawn and self._respawn_budget[i] > 0:
                        self._respawn_budget[i] -= 1
                        log.respawns += 1
                        # rejoin semantics: the revived worker restarts from
                        # the CURRENT iterate/version -- re-stamp its tracker
                        # entry so it does not carry pre-crash staleness
                        tracker.stamp(i, k)
                        threads[i] = spawn(i)
                        errors.pop(i, None)
                        in_q[i].put(self._x_live)
                        continue
                    raise WorkerCrash(
                        f"worker {i} died at write event {k}") from exc
                return msg

        self._respawn_budget = {i: self.max_respawns for i in range(self.n)}

        # Algorithm 1 init: g^(i) = grad f_i(x_0)
        g_table = [self._grad_i(x, self._Aw[i], self._bw[i])
                   for i in range(self.n)]
        g_sum = sum(g_table[1:], g_table[0])
        ready = ready_event()
        for i in range(self.n):
            tracker.stamp(i, 0)
            in_q[i].put((x, 0, ready))

        t0 = time.perf_counter()
        ss = self._ss
        self._x_live = (x, 0, ready)
        try:
            for k in range(n_events):
                i, g_new, s_read = get_result(k)
                if master is not None:
                    g_new.record_stream(master)
                # lines 11-13: replace worker i's table entry, stamp s^(i)
                g_sum = g_sum - g_table[i] + g_new
                g_table[i] = g_new
                tracker.k = k
                tracker.stamp(i, s_read)
                # line 15: tau_k^(i) = k - s^(i); policy consumes max tau_k^(i)
                delays = tracker.delays()
                tau = max(delays.values())
                gamma, ss = self.policy.step(ss, tau)
                gamma_f = float(gamma)
                gamma_t = _gamma_tensor(gamma_f, dev)
                # line 17: x_{k+1} = prox_{gamma R}(x_k - gamma g_k)
                x = self.prox.prox(x - gamma_t * (g_sum / n_t), gamma_t)
                ready = ready_event()
                self._x_live = (x, k + 1, ready)
                # line 20: send x_{k+1} (version k+1) back to the idle worker
                tracker.stamp(i, k + 1)
                in_q[i].put((x, k + 1, ready))
                if k % self.record_every == 0:
                    log.objective.append(float(self._P(x)))
                    log.gammas.append(gamma_f)
                    log.taus.append(int(tau))
                    log.taus_per_worker.append(np.array(sorted(delays.values())))
                    log.wall.append(time.perf_counter() - t0)
        finally:
            stop.set()
            # drain the bounded return queue so no worker stays blocked on a
            # full out_q.put while we try to join it
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            for i, t in enumerate(threads):
                t.join(timeout=1.0)
                if t.is_alive():
                    log.join_failures += 1
                    warnings.warn(
                        f"PIAGServer worker {i} did not exit within 1s of "
                        "stop; thread leaked (daemon -- it dies with the "
                        "process)", RuntimeWarning, stacklevel=2)
            log.in_flight_max = flight.most
        self.x_final = x.detach().cpu().numpy()
        return log


class SharedMemoryBCD:
    """Threaded shared-memory Async-BCD with inconsistent reads.

    The shared iterate is one tensor on ``device`` (the CUDA card unless
    ``"cpu"``); the problem's data move there."""

    def __init__(self, problem, policy: StepsizePolicy, prox: ProxOp,
                 n_workers: int = 8, m_blocks: int = 20, record_every: int = 1,
                 seed: int = 0, device=None):
        self.problem = problem
        self.policy = policy
        self.prox = prox
        self.device = resolve_device(device)
        self.n = n_workers
        self.m = m_blocks
        self.record_every = record_every
        self.seed = seed
        d = problem.dim
        self.db = -(-d // m_blocks)
        data = {f: getattr(problem, f) for f in ("A", "b", "y")
                if isinstance(getattr(problem, f, None), torch.Tensor)}
        if any(t.device.type != self.device.type for t in data.values()):
            problem = dataclasses.replace(
                problem, **{f: t.to(self.device) for f, t in data.items()})
        self._grad = problem.grad_f
        self._P = problem.P

    def run(self, n_events: int, x0: Optional[np.ndarray] = None) -> RunLog:
        dev = self.device
        d = self.problem.dim
        # one shared tensor => unlocked reads are inconsistent (Eq. 6)
        x = (torch.zeros((d,), dtype=torch.float32, device=dev) if x0 is None
             else torch.as_tensor(np.array(x0, np.float32)).to(dev))
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        lock = threading.Lock()
        counter = {"k": 0}
        ss_box = {"ss": self.policy.init(device="cpu")}
        log = RunLog()
        objectives: dict = {}   # write event k -> P(x) (filled outside the lock)
        t0 = time.perf_counter()
        stop = threading.Event()
        flight = _InFlight()

        errors: dict = {}        # worker index -> boxed exception

        def worker(i: int):
            try:
                self._bcd_loop(i, n_events, x, lock, counter, ss_box, log,
                               objectives, stop, t0, d, flight)
            except BaseException as exc:
                errors[i] = exc

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.n)]
        for t in threads:
            t.start()
        # the master owns no events here (Algorithm 2 is fully decentralized)
        # -- it only waits for the write counter; dead or excepted workers
        # surface
        while counter["k"] < n_events:
            time.sleep(0.01)
            if errors:
                stop.set()
                i = next(iter(errors))
                raise WorkerCrash(
                    f"SharedMemoryBCD worker {i} died at write event "
                    f"{counter['k']}/{n_events}") from errors[i]
            if not any(t.is_alive() for t in threads):
                if counter["k"] >= n_events:
                    break   # workers finished between the two checks
                raise WorkerCrash(
                    f"all {self.n} BCD workers exited at write event "
                    f"{counter['k']}/{n_events} without finishing")
        stop.set()
        for i, t in enumerate(threads):
            t.join(timeout=5.0)
            if t.is_alive():
                log.join_failures += 1
                warnings.warn(
                    f"SharedMemoryBCD worker {i} did not exit within 5s of "
                    "stop; thread leaked (daemon -- it dies with the "
                    "process)", RuntimeWarning, stacklevel=2)
        log.crashes = len(errors)
        log.in_flight_max = flight.most
        # scalar rows were appended in write-event order under the lock;
        # reassemble the objective column in the same order.  If a straggler
        # thread outlived the join with its deferred P(x) still pending, trim
        # the scalar columns so all four stay aligned.
        obj_sorted = [objectives[k] for k in sorted(objectives)]
        n_rows = len(obj_sorted)
        if n_rows < len(log.gammas):
            del log.gammas[n_rows:], log.taus[n_rows:], log.wall[n_rows:]
        log.objective.extend(obj_sorted)
        self.x_final = x.detach().cpu().numpy()
        return log

    def _bcd_loop(self, i: int, n_events: int, x, lock, counter, ss_box,
                  log, objectives, stop, t0, d, flight):
        rng = np.random.default_rng(self.seed + i)
        dev = self.device
        stream = _worker_stream(dev)
        with _on(stream):
            while not stop.is_set():
                s_read = counter["k"]            # Algorithm 2 line 10 (stamp)
                with flight:
                    xhat = x.clone()             # unlocked read -> inconsistent
                    j = int(rng.integers(0, self.m))  # line 3
                    g = self._grad(xhat)         # line 4
                    _sync(stream)
                lo, hi = j * self.db, min((j + 1) * self.db, d)
                gj = g[lo:hi]
                x_snap = None
                with lock:                        # lines 5-9 critical section
                    k = counter["k"]
                    if k >= n_events:
                        return
                    tau = k - s_read              # line 5
                    gamma, ss_box["ss"] = self.policy.step(ss_box["ss"], tau)
                    gamma_f = float(gamma)        # line 6
                    gamma_t = _gamma_tensor(gamma_f, dev)
                    xj = x[lo:hi] - gamma_t * gj
                    x[lo:hi] = self.prox.prox(xj, gamma_t)
                    record = k % self.record_every == 0
                    if record:
                        # an iterate snapshot inside the lock; the O(Nd)
                        # objective runs OUTSIDE it
                        x_snap = (k, x.clone())
                    _sync(stream)   # the write has landed before the bump
                    counter["k"] = k + 1          # line 9 (write event)
                    if record:
                        log.gammas.append(gamma_f)
                        log.taus.append(int(tau))
                        log.wall.append(time.perf_counter() - t0)
                if x_snap is not None:
                    k_rec, xs = x_snap
                    objectives[k_rec] = float(self._P(xs))
